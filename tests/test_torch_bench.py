"""The port's bench entry (`stereo_dso_g2o_tpu_torch/bench.py`) in its
small mode on the CPU (2 sequences x 40 frames at 256x128), against the
repository's `bench.py`.

One run of `main(small=True, device="cpu")` in a module fixture, fed what
the JAX bench is fed: its renderer is the JAX package's (run with jax's
default float32, as `bench.py` runs), so the frames are the JAX bench's
own, and the selector's and the keyframe branch's thinning draws are the
JAX package's (float32 too: under the tests' x64 they draw other numbers).
Held to:

- the three result lines, with bench.py's metric names and keys in its
  order, at tests/test_bench_smoke.py's bounds (finite, not lost, ATE
  < 0.5 m, >= 5 keyframes);
- sequence 0's trajectory, bit for bit, against the port's GraphSystem
  driven frame by frame here on the same frames;
- the frame records against `bench_obs_small.jsonl`, the JAX bench's small
  run: the same frames and keys, the same `need_kf` frames, `kf_delta`
  within 0.05 and `kf_rmse`, `kf_first_rmse` within 0.5 (measured 0.0253
  and 0.245: the two chains drift apart by up to 2e-2 in the window's
  poses, the reference's sub-pixel start jitter amplifying f32 noise,
  while every single frame from a JAX snapshot agrees to 2e-6).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from _torch_parity import jax_graph_uniform, jax_uniform

from stereo_dso_g2o_tpu.io import synthetic as jsyn
from stereo_dso_g2o_tpu_torch import bench as tbench
from stereo_dso_g2o_tpu_torch.config import Settings
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.frontend.graph_system import GraphSystem
from stereo_dso_g2o_tpu_torch.io import synthetic as tsyn
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops import selector as tselector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("full_slam_single_seq_fps_kitti_res_hostile_synthetic",
           "full_slam_agg_fps_kitti_res_hostile_synthetic",
           "full_slam_fps_per_chip_kitti_res_hostile_synthetic")
COMMON = ("unit", "single_seq_fps", "single_seq_fps_p50", "ate_rmse_m", "n_finite_frames", "lost",
          "kitti_rel_trans_pct", "kitti_rel_rot_degpm", "n_keyframes", "n_frames")
DELTA_TOL, RMSE_TOL = 0.05, 0.5


def _float32(fn):
    def call(*a, **kw):
        with jax.enable_x64(False):
            return fn(*a, **kw)
    return call


def _jax_render(scene, K, w, h, baseline, poses_cw, exposures=None, supersample=2, device=None):
    lefts, rights = _float32(jsyn.render_stereo_sequence_fast)(scene, K, w, h, baseline, poses_cw,
                                                               exposures, supersample)
    return (torch.as_tensor(np.asarray(lefts), device=device),
            torch.as_tensor(np.asarray(rights), device=device))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    obs = tmp_path_factory.mktemp("bench") / "obs.jsonl"
    real = GraphSystem.from_full_system.__func__
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsyn, "render_stereo_sequence_fast", _jax_render)
        mp.setattr(tselector, "torch_uniform", _float32(jax_uniform))
        mp.setattr(GraphSystem, "from_full_system", classmethod(
            lambda cls, fs, uniform=None: real(cls, fs, uniform=_float32(jax_graph_uniform))))
        out = tbench.main(small=True, device="cpu", obs=str(obs))
        # the port's GraphSystem frame by frame on the same frames
        lefts, rights = out["frames"]
        cfg = tbench.bench_config(True)
        K = tsyn.default_K(cfg["w"], cfg["h"], fov_deg=80.0)
        settings = Settings(desired_point_density=cfg["density"],
                            desired_immature_density=cfg["imm_density"],
                            immature_cap=cfg["imm_cap"], active_cap=cfg["act_cap"],
                            affine_opt_mode_a=0.0, affine_opt_mode_b=0.0)
        calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                           n_levels=6, device="cpu")
        fs = FullSystem(calib, settings, device="cpu")
        for i in range(tbench.BOOT):
            fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        gs = GraphSystem.from_full_system(fs)
        for i in range(tbench.BOOT, cfg["n_frames"]):
            gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        out["solo_traj"] = gs.trajectory()
    out["obs_file"] = obs
    return out


def test_result_lines(run):
    lines = run["lines"]
    assert [d["metric"] for d in lines] == list(METRICS)
    for d in lines:
        assert {"metric", "value", "vs_baseline", *COMMON} <= set(d)
        assert d["unit"] == "frames/sec/chip" and d["value"] > 0
    assert lines[1]["n_seq_batched"] == 2
    assert lines[2]["best_config_n_seq"] in (1, 2) and lines[2]["agg_fps_batched"] == lines[1]["value"]
    agg = lines[-1]
    assert agg["n_finite_frames"] == agg["n_frames"] == 40
    assert not agg["lost"]
    assert agg["ate_rmse_m"] is not None and agg["ate_rmse_m"] < 0.5, agg
    assert agg["n_keyframes"] >= 5, agg
    assert all(np.isfinite(T).all() for traj in run["batched_trajs"] for T in traj)


def test_frames_are_the_jax_benchs(run):
    """The renderer was called as bench.py calls it (scene, trajectory,
    exposures of sequence 0): the frames are the JAX renderer's on bench.py's
    arguments, and the staging keeps them on the device asked for."""
    K = jsyn.default_K(256, 128, fov_deg=80.0)
    scene = jsyn.corridor_scene(seed=100, length=0.12 * 40 + 40.0, box_spacing=5.0, lateral=6.0)
    poses = jsyn.forward_trajectory(40, step=0.12, yaw_amp=0.10, yaw_period=80.0, seed=0)
    expos = 1.0 + 0.12 * np.sin(0.25 * np.arange(40))
    want = _float32(jsyn.render_stereo_sequence_fast)(scene, K, 256, 128, 0.2, poses, expos)
    for got, w in zip(run["frames"], want):
        assert got.device.type == "cpu" and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_single_sequence_equals_graph_system_frame_by_frame(run):
    assert len(run["traj"]) == len(run["solo_traj"]) == 40
    np.testing.assert_array_equal(np.stack(run["traj"]), np.stack(run["solo_traj"]))


def test_frame_records_hold_to_the_jax_archive(run):
    with open(os.path.join(ROOT, "bench_obs_small.jsonl")) as f:
        want = [json.loads(ln) for ln in f]
    with open(run["obs_file"]) as f:
        got = [json.loads(ln) for ln in f]
    assert got[-1]["final_window"] and got[-1]["type"] == want[-1]["type"] == "eig"
    assert set(got[-1]) == set(want[-1])
    got, want = got[:-1], want[:-1]
    assert got == run["obs"]
    assert [r["frame"] for r in got] == [r["frame"] for r in want] == list(range(20, 40))
    assert [r["frame"] for r in got if r["need_kf"]] == [r["frame"] for r in want if r["need_kf"]]
    for a, b in zip(got, want):
        assert list(a) == list(b), a["frame"]
        assert abs(a["kf_delta"] - b["kf_delta"]) <= DELTA_TOL, (a, b)
        for k in ("kf_rmse", "kf_first_rmse"):
            assert abs(a[k] - b[k]) <= RMSE_TOL, (k, a, b)


def test_cli_arguments(capsys):
    assert tbench.cli(["frames=40", "bogus=1"]) == 2
    assert "usage" in capsys.readouterr().err
    with pytest.raises(ValueError, match="frames=12"):
        tbench.main(frames=12, device="cpu")
