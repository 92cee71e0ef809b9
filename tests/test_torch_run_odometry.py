"""The port's CLI (`stereo_dso_g2o_tpu_torch/run_odometry.py`) against the
repository's JAX `run_odometry.py` on the same PNG files: trajectory file,
viewer feed, stereo-match counts, the frame of the GraphSystem switch. The
JAX side runs once, in one module fixture. The port draws its selector
thinning from the JAX package's generators here (`jax_uniform`,
`jax_graph_uniform`), as every parity test of the whole slice does."""

import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch
from _torch_parity import jax_graph_uniform, jax_uniform

from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem as JGraphSystem
from stereo_dso_g2o_tpu_torch import run_odometry as tcli
from stereo_dso_g2o_tpu_torch.frontend.graph_system import GraphSystem as TGraphSystem
from stereo_dso_g2o_tpu_torch.io import dataset as tds
from stereo_dso_g2o_tpu_torch.io import synthetic as tsyn
from stereo_dso_g2o_tpu_torch.io import trajectory as ttraj
from stereo_dso_g2o_tpu_torch.io import viewer as tviewer
from stereo_dso_g2o_tpu_torch.ops import selector as tselector
from stereo_dso_g2o_tpu_torch.runtime import native_loader as tNL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL_M = 1e-3
W, H, BASE = 128, 64, 0.1


def _write_sequence(base, n, step):
    """tests/test_dataset.py's layout: default_scene(0) at 128x64, the
    camera translated by `step` (x, z) a frame, id/stamp/exposure times and
    a Pinhole calib without rectification."""
    scene = tsyn.default_scene(0)
    K = tsyn.default_K(W, H)
    lefts, rights = [], []
    for i in range(n):
        T = np.eye(4)
        T[:3, 3] = [step[0] * i, 0.0, step[1] * i]
        left, right, _ = tsyn.render_stereo_pair(scene, K, W, H, BASE, T)
        lefts.append(left.astype(np.uint8))
        rights.append(right.astype(np.uint8))
    return tds.write_sequence(base, lefts, rights, K, BASE, np.full(n, 0.9), out_mode="none")


def _switch_recorder(cls, calls, uniform=None):
    """`from_full_system` that notes the frame each freeze happens at."""
    real = cls.from_full_system.__func__

    def rec(klass, fs, *a, **kw):
        calls.append(len(fs.history))
        if uniform is not None:
            kw["uniform"] = uniform
        return real(klass, fs, *a, **kw)

    return classmethod(rec)


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI over the 4-frame `kitti_dir` sequence (trajectory and
    feed), in stereo-match mode, and over a 9-frame sequence of faster
    motion that reaches the GraphSystem switch."""
    tmp = tmp_path_factory.mktemp("cli")
    seq, calib = _write_sequence(tmp / "seq", 4, (0.02, 0.03))
    long_seq, long_calib = _write_sequence(tmp / "long", 9, (0.05, 0.10))
    spec = importlib.util.spec_from_file_location("jax_run_odometry", os.path.join(ROOT, "run_odometry.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    out = dict(seq=seq, calib=calib, long_seq=long_seq, long_calib=long_calib, tmp=tmp)
    common = ["preset=2", "quiet=1", "levels=4"]
    assert cli.main([f"files={seq}", f"calib={calib}", *common, f"output={tmp / 'jax.txt'}",
                     f"feed={tmp / 'jax.jsonl'}"]) == 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert cli.main([f"files={seq}", f"calib={calib}", "stereomatch=1", "maxframes=2",
                         "levels=4"]) == 0
    out["good"] = [int(m) for m in re.findall(r"got good matches (\d+)", text.getvalue())]
    switches = []
    text = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(text):
        mp.setattr(JGraphSystem, "from_full_system", _switch_recorder(JGraphSystem, switches))
        assert cli.main([f"files={long_seq}", f"calib={long_calib}", *common,
                         f"output={tmp / 'jax_long.txt'}"]) == 0
    out["switches"] = switches
    out["long_kfs"] = int(re.search(r"\((\d+) keyframes\)", text.getvalue()).group(1))
    return out


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's selector and the frame program's keyframe branch draw what
    the JAX package draws."""
    monkeypatch.setattr(tselector, "torch_uniform", jax_uniform)
    switches = []
    monkeypatch.setattr(TGraphSystem, "from_full_system",
                        _switch_recorder(TGraphSystem, switches, uniform=jax_graph_uniform))
    return switches


def _feed(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_matches_jax(jax_cli, jax_draws, tmp_path):
    out, feed, viz = tmp_path / "port.txt", tmp_path / "port.jsonl", tmp_path / "viz.png"
    rc = tcli.main([f"files={jax_cli['seq']}", f"calib={jax_cli['calib']}", "preset=2", "quiet=1",
                    "levels=4", f"output={out}", f"feed={feed}", f"viz={viz}", "device=cpu"])
    assert rc == 0
    got = ttraj.read_kitti(str(out))
    want = ttraj.read_kitti(str(jax_cli["tmp"] / "jax.txt"))
    assert len(got) == len(want) == 4
    dt = [float(np.linalg.norm(a[:3, 3] - b[:3, 3])) for a, b in zip(got, want)]
    assert max(dt) <= POSE_TOL_M, dt
    tf, jf = _feed(feed), _feed(jax_cli["tmp"] / "jax.jsonl")
    assert [d["type"] for d in tf] == [d["type"] for d in jf]
    poses = [d for d in tf if d["type"] == "pose"]
    kfs = [d for d in tf if d["type"] == "keyframes"]
    assert [d["id"] for d in poses] == list(range(4)) and kfs
    assert kfs[-1]["n_points"] > 0 and len(kfs[-1]["points"][0]["xyz"]) % 3 == 0
    for a, b in zip(kfs, (d for d in jf if d["type"] == "keyframes")):
        assert [p["id"] for p in a["poses"]] == [p["id"] for p in b["poses"]]
        assert abs(a["n_points"] - b["n_points"]) <= 0.01 * b["n_points"] + 1
    assert viz.stat().st_size > 0
    png = tmp_path / "feed.png"
    tviewer.render_feed(str(feed), str(png))
    assert png.stat().st_size > 0


def test_cli_prefetch_off_equals_native_stream(jax_cli, jax_draws, tmp_path, capsys):
    """With a Pinhole `none` calib both streams hand over the decoded pixels
    as they are, so the run is the same bit for bit."""
    if not tNL.available():
        pytest.skip(f"the port's native loader did not build (g++ or zlib missing): {tNL.build_error()}")
    runs = {}
    for flag in ("1", "0"):
        out = tmp_path / f"p{flag}.txt"
        summary = tcli.run([f"files={jax_cli['seq']}", f"calib={jax_cli['calib']}", "preset=2",
                            "quiet=1", "levels=4", f"output={out}", f"prefetch={flag}",
                            "device=cpu"])
        runs[flag] = (summary, out.read_text(), capsys.readouterr().out)
    assert runs["1"][0]["source"] == "native" and "frames: native loader" in runs["1"][2]
    assert runs["0"][0]["source"] == "get" and "frames: StereoDataset.get" in runs["0"][2]
    assert runs["1"][1] == runs["0"][1]
    assert runs["1"][0]["frames"] == 4 and len(runs["1"][0]["frame_ms"]) == 4


def test_cli_stereomatch_matches_jax(jax_cli):
    summary = tcli.run([f"files={jax_cli['seq']}", f"calib={jax_cli['calib']}", "stereomatch=1",
                        "maxframes=2", "levels=4", "device=cpu"])
    assert summary["rc"] == 0 and len(summary["good"]) == len(jax_cli["good"]) == 2
    for got, want in zip(summary["good"], jax_cli["good"]):
        assert want > 100 and abs(got - want) <= 0.01 * want, (got, want)


def test_cli_graph_switch_matches_jax(jax_cli, jax_draws, tmp_path):
    """On a sequence long enough to reach it, the port freezes into its
    GraphSystem on the frame the JAX CLI does, with as many keyframes. The
    poses are held to the ground truth, not to the JAX run's: on this fast
    motion a keyframe amplifies the reference's sub-pixel start jitter
    (ROADMAP.md section 3), and the two runs part by centimetres from the
    third keyframe on while their errors stay alike."""
    out = tmp_path / "long.txt"
    summary = tcli.run([f"files={jax_cli['long_seq']}", f"calib={jax_cli['long_calib']}",
                        "preset=2", "quiet=1", "levels=4", f"output={out}", "device=cpu"])
    assert len(jax_cli["switches"]) == 1, jax_cli["switches"]
    assert jax_draws == jax_cli["switches"]
    assert summary["switch_frame"] == jax_cli["switches"][0] < 9
    assert summary["keyframes"] == jax_cli["long_kfs"]
    assert not summary["lost"] and summary["frames"] == 9
    got = ttraj.read_kitti(str(out))
    want = ttraj.read_kitti(str(jax_cli["tmp"] / "jax_long.txt"))
    assert len(got) == len(want) == 9 and all(np.isfinite(T).all() for T in got)
    gt = []
    for i in range(9):
        T = np.eye(4)
        T[:3, 3] = [-0.05 * i, 0.0, -0.10 * i]  # camToWorld of _write_sequence's poses
        gt.append(T)
    ate_t, ate_j = ttraj.ate_rmse(got, gt), ttraj.ate_rmse(want, gt)
    assert ate_t <= 2 * ate_j + 0.01, (ate_t, ate_j)


def test_cli_synthetic_runs(capsys):
    summary = tcli.run(["synthetic=4", "quiet=1", "device=cpu"])
    assert summary["rc"] == 0 and summary["frames"] == 4 and np.isfinite(summary["ate"])
    m = re.search(r"ATE=([0-9.]+)mm", capsys.readouterr().out)
    assert m and np.isfinite(float(m.group(1)))


SYN_FRAMES = 24  # the sixth keyframe (frame 21) pushes the first out of the 5-frame window


def _twist(i):
    """`run_odometry.py`'s `synthetic=N` twist of frame i."""
    return np.array([0.025 * i, -0.008 * i, 0.04 * i, 0.002 * i, 0.004 * i, -0.001 * i])


@pytest.mark.parametrize("frame", [3, 10, 19])
def test_synthetic_pose_and_render_match_jax(frame):
    """`synthetic=N` takes its poses as the JAX CLI does, the exp of a
    float32 twist (jax's default precision; the tests turn x64 on, so it is
    turned off around the JAX side): every entry within one float32 rounding
    of the JAX pose (frames 3 and 10 agree bit for bit; on frame 19 one
    translation entry differs by one rounding, the two exps summing it in
    another order), and the rendered pair within 5e-5 (a float64 pose put
    2.9e-4 between them)."""
    import jax
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.io import synthetic as jsyn
    from stereo_dso_g2o_tpu.utils import se3 as jse3

    with jax.enable_x64(False):
        want = np.asarray(jse3.se3_exp(jnp.asarray(_twist(frame))), dtype=np.float64)
    got = tcli.synthetic_pose(frame)
    assert got.dtype == np.float64
    rounding = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= rounding).all(), np.abs(got - want).max()
    w, h, b = 256, 128, 0.12
    K = jsyn.default_K(w, h)
    for a, c in zip(tsyn.render_stereo_pair(tsyn.default_scene(0), K, w, h, b, got)[:2],
                    jsyn.render_stereo_pair(jsyn.default_scene(0), K, w, h, b, want)[:2]):
        np.testing.assert_allclose(a, c, atol=5e-5, rtol=0)


def test_synthetic_frame_lines_match_jax(jax_draws, capsys):
    """`synthetic=N quiet=0` prints the JAX CLI's per-frame lines, the
    keyframes in the window (`kf_slots`), over a run that marginalizes a
    keyframe, so that the window holds fewer than were made."""
    import jax

    spec = importlib.util.spec_from_file_location("jax_run_odometry", os.path.join(ROOT, "run_odometry.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    with jax.enable_x64(False):
        assert jcli.run_synthetic(SYN_FRAMES, False) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("frame ")]
    summary = tcli.run([f"synthetic={SYN_FRAMES}", "quiet=0", "device=cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("frame ")]
    assert len(want) == SYN_FRAMES and got == want
    in_window = [int(re.search(r"kfs=(\d+)", ln).group(1)) for ln in got]
    assert summary["keyframes"] > in_window[-1], (summary["keyframes"], in_window)


def test_cli_needs_a_device_or_files(jax_cli, monkeypatch, capsys):
    assert tcli.main(["quiet=1", "device=cpu"]) == 1
    assert "Usage" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([f"files={jax_cli['seq']}", f"calib={jax_cli['calib']}", "quiet=1"])
