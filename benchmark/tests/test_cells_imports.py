"""What a run may import, and a run without a card or without the port."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import core
from benchmark.tests._small import REPO, small_copy

CMD = [sys.executable, "benchmark/run.py", "--workload", "kitti05.corridor", "--seed",
       "2147483999", "--seconds", "1", "--trace", "0"]


@pytest.mark.parametrize("name,bad", [
    ("stereo_dso_g2o_tpu", True), ("stereo_dso_g2o_tpu.ops.trace", True),
    ("stereo_dso_g2o_tpu_torch", False), ("stereo_dso_g2o_tpu_torch.ops.trace_cuda", False),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("jaxtyping", False), ("flaxen", False), ("benchmark.harness.core", False),
])
def test_top_level_names_compared_whole(name, bad):
    assert core.forbidden_modules({name: None, "torch": None}) == ([name] if bad else [])


def test_refuses_without_a_card(tmp_path):
    """This machine has no CUDA device: exit 2, no result, the reason said."""
    env_root = small_copy(tmp_path)
    p = subprocess.run(CMD, cwd=env_root, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in p.stderr


def test_refuses_without_the_port(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ only: no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy; import torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; sys.argv = sys.argv[1:]; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code] + CMD[1:], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{\"correct\"") for line in p.stdout.splitlines())


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole run of a cell (on the CPU, the look for a card skipped)
    leaves neither JAX nor the JAX package in sys.modules."""
    root = small_copy(tmp_path, frames=20, warm=0)
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "from benchmark.harness import core; "
            f"rc = core.run(['--workload', 'kitti05.corridor', '--seed', '5', "
            f"'--seconds', '0.5', '--trace', '0'], root={str(root)!r}, device='cpu'); "
            "print('FORBIDDEN', core.forbidden_modules(), rc)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "FORBIDDEN [] 0"
    result = json.loads(p.stdout.strip().splitlines()[-2])
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
