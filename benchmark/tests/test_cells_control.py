"""The control of `correct` on the card, at each cell's own size: the
reference computed in bfloat16, put in the port's place, fails a limit
the port meets. Marked `cuda`; on the card:

    python3 -m pytest benchmark/tests/test_cells_control.py -q -n 0
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.harness import core
from benchmark.tests._small import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    bench = core.Bench(REPO)
    entry = bench.cell(cell)
    got = core.run_cell(bench, entry, 2147483777, bench.manifest["run_seconds"], False, card,
                        time.perf_counter(), control=True)
    checks = got["result"]["checks"]
    assert got["result"]["correct"], checks
    failed = [k for k, v in got["controls"].items() if k in checks and v > checks[k]["limit"]]
    assert failed, (got["controls"], checks)
