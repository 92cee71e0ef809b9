"""Readings for the limits of `correct`: the port's numbers and the
control's, seed by seed, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 4 \
        [--fault <name>] [--out file.jsonl]

For each seed one run of the cell (set-up, a window of `--seconds`, the
check) prints a JSON line with the port's numbers (`port`, read against the
reference) and the control's (`control`: the reference computed in
bfloat16 in the port's place, judged the same way). With `--fault` the
port runs with that fault of `benchmark/harness/faults.py` planted before
set-up, and `port` is what the broken program reads. The lower reading of
a limit is the largest `port` value over a dozen seeds or more; the upper,
the smallest `control` value, or a fault's (PERF.md says which). The
benchmark's own runs never run this.
"""

import contextlib

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness import core, faults  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fault", choices=faults.NAMES)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = core.Bench(ROOT)
    cell = bench.cell(args.workload)
    dev, why = core._device(int(cell["chips"]), None)
    if dev is None:
        print(f"control: {why}", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            got = core.run_cell(bench, cell, seed, args.seconds, False, dev, t0, control=True)
        res = got["result"]
        line = {"cell": cell["name"], "seed": seed, "fault": args.fault, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "port": {k: c["value"] for k, c in res["checks"].items()},
                "control": got["controls"], "shown": got["info"].get("shown"),
                "setup_s": got["info"]["setup_s"], "keyframes": got["info"]["keyframes"],
                "window_points": got["info"]["window_points"],
                "metrics": {k: m["value"] for k, m in res["metrics"].items()}}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
