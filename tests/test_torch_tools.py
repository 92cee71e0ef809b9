"""The port's tools (`stereo_dso_g2o_tpu_torch/tools/`) on the CPU at a
tiny size: bench.py's smoke corridor (256x128), a few frames past the
12-frame bootstrap, the BA windows of F = 4, 8 and 16 (the profilers are in
test_torch_tools_profile.py). Each `main` returns the JSON
line it prints, with the JAX tool's keys; `analyze_kf_decisions` reads the
JAX bench's own `bench_obs_small.jsonl` to the JAX tool's summary, and the
enlarged window is built as the JAX test helper builds it."""

import contextlib
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_parity import fields

from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.tools import (
    accuracy_probe, analyze_kf_decisions, bench_enlarged_window, bench_trace_kernel, bench_tunnel,
    kernel_gap_probe, profile_frame, roofline,
)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(small=1, device="cpu")


def test_accuracy_probe_keys_and_route():
    out = accuracy_probe.main(frames=14, route="resident", **SMALL)
    for k in ("backend", "seq", "trace_backend", "ladder_fine_levels", "n_frames", "ate_rmse_m",
              "kitti_rel_trans_pct", "kitti_rel_rot_degpm", "n_keyframes", "lost", "wall_s",
              "fps", "kf_frames", "rot_orth_max", "kitti_rel_rot_degpm_orthonormal"):
        assert k in out, k
    assert out["n_frames"] == 14 and not out["lost"] and out["trace_backend"] == "resident"
    assert np.isfinite(out["ate_rmse_m"]) and out["n_keyframes"] == len(out["kf_frames"]) >= 2
    assert 0.0 <= out["rot_orth_max"] < 1e-2
    from stereo_dso_g2o_tpu_torch.ops import trace

    assert trace.DEFAULT_ROUTE is None  # restored after the run
    with pytest.raises(ValueError):
        accuracy_probe.main(frames=14, route="pallas", **SMALL)


def test_rot_orth_max_and_orthonormalized():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    Q *= np.sign(np.linalg.det(Q))
    T = np.eye(4)
    T[:3, :3] = Q * (1.0 + 1e-4)  # a rotation scaled off the group
    T[:3, 3] = [1.0, 2.0, 3.0]
    assert abs(accuracy_probe.rot_orth_max([T]) - (2e-4 + 1e-8)) < 1e-9
    (U,) = accuracy_probe.orthonormalized([T])
    np.testing.assert_allclose(U[:3, :3], Q, atol=1e-12)
    np.testing.assert_array_equal(U[:3, 3], T[:3, 3])


def _jax_tool_json(script, *argv):
    """Run a repository tool's main() and return its last JSON line."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        mod = __import__(script)
    finally:
        sys.path.pop(0)
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [script, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = old
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["bench_obs_small.jsonl", "bench_obs.jsonl"])
def test_analyze_kf_decisions_equals_the_jax_tool(name):
    path = str(ROOT / name)
    want = _jax_tool_json("analyze_kf_decisions", path)
    assert analyze_kf_decisions.main(path=path) == want
    assert want["n_kf"] > 0


def test_analyze_kf_decisions_without_records(tmp_path):
    p = tmp_path / "obs.jsonl"
    p.write_text(json.dumps({"final_window": True}) + "\n")
    assert "error" in analyze_kf_decisions.main(path=str(p))


def test_enlarged_window_is_built_as_the_jax_helper_builds_it():
    """F = 4, 256 points: the port's builder against
    tests/test_dist_ba.py::_build_enlarged_window, x64 off."""
    from test_dist_ba import _build_enlarged_window

    with jax.enable_x64(False):
        jwin, jdI = _build_enlarged_window(F=4, n_pts=256)
        want = fields(jwin)
    twin, tdI = bench_enlarged_window.build_enlarged_window(F=4, n_pts=256, device="cpu")
    np.testing.assert_allclose(tdI.numpy(), np.array(jdI), atol=1e-4)
    got = {f: getattr(twin, f) for f in want}
    for f, w in want.items():
        g = got[f].detach().cpu().numpy()
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5, err_msg=f)
    assert bridge.window_from_numpy(want, device="cpu").F == 4


def test_bench_enlarged_window_keys():
    out = bench_enlarged_window.main(reps=1, device="cpu")
    for label, F, n in (("production_F8_2048", 8, 2048), ("enlarged_F16_8192", 16, 8192)):
        assert out[f"{label}_iter_ms"] > 0
        assert 0 < out[f"{label}_nres"] <= n * (F - 1)
        assert np.isfinite(out[f"{label}_energy"])
    assert out["cost_ratio"] > 0


@pytest.mark.parametrize("tool", ["accuracy_probe", "profile_frame", "bench_enlarged_window",
                                  "bench_tunnel", "bench_trace_kernel", "kernel_gap_probe",
                                  "roofline"])
def test_tools_raise_without_a_card_unless_asked_for_the_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"accuracy_probe": accuracy_probe, "profile_frame": profile_frame,
           "bench_enlarged_window": bench_enlarged_window, "bench_tunnel": bench_tunnel,
           "bench_trace_kernel": bench_trace_kernel, "kernel_gap_probe": kernel_gap_probe,
           "roofline": roofline}[tool]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.main()
