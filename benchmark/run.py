"""Run one cell of the port's benchmark once; the last line of standard
output is its result (`benchmark/README.md`).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Without an NVIDIA GPU it exits with 2 and
prints no result.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a run may write stays at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

from benchmark.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.run(sys.argv[1:], t_start=T_START))
