"""Leaf modules of the PyTorch port held against the JAX package:
Settings, se3, smalls, interp, pyramid, camera, fixed-shape helpers,
trajectory metrics, and the package's freedom from jax."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, t

from stereo_dso_g2o_tpu import config as jconfig
from stereo_dso_g2o_tpu.io import trajectory as jtraj
from stereo_dso_g2o_tpu.models import camera as jcam
from stereo_dso_g2o_tpu.ops import interp as jinterp
from stereo_dso_g2o_tpu.ops import pyramid as jpyr
from stereo_dso_g2o_tpu.utils import se3 as jse3
from stereo_dso_g2o_tpu.utils import smalls as jsmalls
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch import config as tconfig
from stereo_dso_g2o_tpu_torch.io import trajectory as ttraj
from stereo_dso_g2o_tpu_torch.models import camera as tcam
from stereo_dso_g2o_tpu_torch.ops import interp as tinterp
from stereo_dso_g2o_tpu_torch.ops import pyramid as tpyr
from stereo_dso_g2o_tpu_torch.utils import se3 as tse3
from stereo_dso_g2o_tpu_torch.utils import smalls as tsmalls
from stereo_dso_g2o_tpu_torch.utils.fixed import nonzero_fixed, scatter_drop

ROOT = Path(__file__).resolve().parent.parent
# Tolerances: both sides compute in float32; a unit-scale result differs by
# a few ulps of float32 (~1e-7) per operation, so 1e-5 absolute leaves room
# for the longest chains here (se3 log/exp); 0-255 images get 1e-4 relative.
ATOL_UNIT = 1e-5
RTOL_IMG = 1e-4


def test_settings_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Settings)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Settings)}
    assert jf == tf
    assert jconfig.Settings().energy_th() == tconfig.Settings().energy_th()
    np.testing.assert_array_equal(jconfig.PATTERN, tconfig.PATTERN)
    for a, b in zip(jconfig.pyramid_intrinsics(700.0, 700.0, 600.0, 170.0, 6),
                    tconfig.pyramid_intrinsics(700.0, 700.0, 600.0, 170.0, 6)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["so3_exp", "se3_exp", "se3_log", "so3_log", "inverse", "adjoint"])
def test_se3_matches(fn):
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(64, 6)) * np.r_[[0.5] * 3, [0.6] * 3]).astype(np.float32)
    xi[:4, 3:] = 0.0  # theta == 0 Taylor branch
    xi[4:8, 3:] *= 1e-5  # tiny rotations
    T = np.array(jse3.se3_exp(jnp.asarray(xi, jnp.float32)), np.float32)
    arg = {
        "so3_exp": xi[:, 3:], "se3_exp": xi, "se3_log": T,
        "so3_log": T[:, :3, :3], "inverse": T, "adjoint": T,
    }[fn]
    want = np.array(getattr(jse3, fn)(jnp.asarray(arg, jnp.float32)))
    got = n(getattr(tse3, fn)(torch.from_numpy(arg)))
    np.testing.assert_allclose(got, want, atol=ATOL_UNIT, rtol=0)


def test_se3_apply_and_identity():
    rng = np.random.default_rng(1)
    T = np.array(jse3.se3_exp(jnp.asarray(rng.normal(size=(5, 6)) * 0.3, jnp.float32)))
    p = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tse3.apply(t(T), t(p))), np.array(jse3.apply(T, p)), atol=ATOL_UNIT
    )
    np.testing.assert_array_equal(n(tse3.identity(batch=(2,))), np.broadcast_to(np.eye(4), (2, 4, 4)))
    np.testing.assert_allclose(
        n(tse3.compose(t(T), t(T[::-1].copy()))), np.array(jse3.compose(T, T[::-1])), atol=ATOL_UNIT
    )


@pytest.mark.parametrize("k", [6, 7, 8])
def test_cholesky_solve_small_matches(k):
    rng = np.random.default_rng(k)
    A = rng.normal(size=(16, k, k)).astype(np.float32)
    A = A @ np.swapaxes(A, -1, -2) + k * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(16, k)).astype(np.float32)
    want = np.array(jsmalls.cholesky_solve_small(jnp.asarray(A), jnp.asarray(b)))
    got = n(tsmalls.cholesky_solve_small(t(A), t(b)))
    np.testing.assert_allclose(got, want, atol=ATOL_UNIT, rtol=1e-5)
    zero = n(tsmalls.cholesky_solve_small(torch.zeros(1, k, k), torch.zeros(1, k)))
    assert np.all(zero == 0)


def _image(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (h, w))).astype(np.float32)


def test_bilinear_matches():
    rng = np.random.default_rng(2)
    img = _image(2)
    stack = np.stack([img, img * 0.5, -img], -1)
    x = rng.uniform(-3, 67, (7, 9)).astype(np.float32)
    y = rng.uniform(-3, 51, (7, 9)).astype(np.float32)
    for im in (img, stack):
        want = np.array(jinterp.bilinear(jnp.asarray(im), jnp.asarray(x), jnp.asarray(y)))
        got = n(tinterp.bilinear(t(im), t(x), t(y)))
        np.testing.assert_allclose(got, want, rtol=RTOL_IMG, atol=RTOL_IMG)
    xi = rng.uniform(0, 62, 50).astype(np.float32)
    yi = rng.uniform(0, 46, 50).astype(np.float32)
    want = np.array(jinterp.bilinear_flat(jnp.asarray(img.ravel()), 64, jnp.asarray(xi), jnp.asarray(yi)))
    got = n(tinterp.bilinear_flat(t(img.ravel()), 64, t(xi), t(yi)))
    np.testing.assert_allclose(got, want, rtol=RTOL_IMG)


def test_pyramid_matches():
    img = _image(3, 64, 128)
    jd, ja = jpyr.build_pyramid(jnp.asarray(img), 4)
    td, ta = tpyr.build_pyramid(t(img), 4)
    for a, b in zip(jd + ja, td + ta):
        np.testing.assert_allclose(n(b), np.array(a), rtol=RTOL_IMG, atol=RTOL_IMG)
    lut = np.linspace(0.5, 2.0, 256).astype(np.float32)
    jd, ja = jpyr.build_pyramid_gamma(jnp.asarray(img), jnp.asarray(lut), 3)
    td, ta = tpyr.build_pyramid_gamma(t(img), t(lut), 3)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(n(b), np.array(a), rtol=RTOL_IMG, atol=RTOL_IMG)


def test_camera_matches():
    jc = jcam.make_calib(700.0, 710.0, 607.5, 175.5, 0.54, 1216, 352, 6)
    tc = tcam.make_calib(700.0, 710.0, 607.5, 175.5, 0.54, 1216, 352, 6, device="cpu")
    assert jc.w == tc.w and jc.h == tc.h
    for lvl in range(6):
        np.testing.assert_allclose(n(tc.K(lvl)), np.array(jc.K(lvl)), atol=ATOL_UNIT, rtol=1e-6)
        np.testing.assert_allclose(n(tc.Ki(lvl)), np.array(jc.Ki(lvl)), atol=ATOL_UNIT, rtol=1e-6)
    assert float(tc.bf()) == pytest.approx(float(jc.bf()), rel=1e-6)
    # the state bridge builds the same calibration from the JAX one's arrays
    bc = bridge.calib_from_numpy(np.array(jc.c), float(jc.baseline), jc.w[0], jc.h[0], 6,
                                 device="cpu")
    assert bc.w == tc.w and bc.h == tc.h
    for lvl in range(6):
        np.testing.assert_array_equal(n(bc.K(lvl)), n(tc.K(lvl)))
    with pytest.raises(ValueError):
        tcam.make_calib(700.0, 700.0, 600.0, 170.0, 0.5, 1000, 350, 6, device="cpu")


@pytest.mark.parametrize("density", [0.0, 0.2, 0.9])
def test_nonzero_fixed_matches_jnp_nonzero(density):
    rng = np.random.default_rng(int(density * 10))
    mask = rng.uniform(size=300) < density
    for size in (50, 300, 400):
        want = np.array(jnp.nonzero(jnp.asarray(mask), size=size, fill_value=-1)[0])
        np.testing.assert_array_equal(n(nonzero_fixed(torch.from_numpy(mask), size)), want)


def test_scatter_drop_matches_mode_drop():
    dst = np.arange(10, dtype=np.float32)
    idx = np.array([3, 10, -1, 7, 12])
    vals = np.array([30.0, 1.0, 2.0, 70.0, 5.0], np.float32)
    want = np.array(jnp.asarray(dst).at[jnp.asarray(np.where(idx < 0, 10, idx))].set(vals, mode="drop"))
    np.testing.assert_array_equal(n(scatter_drop(t(dst), torch.from_numpy(idx), t(vals))), want)


def test_trajectory_metrics_match(tmp_path):
    rng = np.random.default_rng(4)
    gt, est = [], []
    T = np.eye(4)
    for _ in range(60):
        T = T.copy()
        T[:3, 3] += [0.3, 0.0, 1.0]
        gt.append(T)
        E = T.copy()
        E[:3, 3] += rng.normal(scale=0.05, size=3)
        est.append(E)
    assert ttraj.ate_rmse(est, gt) == jtraj.ate_rmse(est, gt)
    assert ttraj.kitti_rel_errors(est, gt, lengths=(10, 20)) == jtraj.kitti_rel_errors(
        est, gt, lengths=(10, 20)
    )
    ttraj.write_kitti(str(tmp_path / "t.txt"), est)
    jtraj.write_kitti(str(tmp_path / "j.txt"), est)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for a, b in zip(ttraj.read_kitti(str(tmp_path / "t.txt")), jtraj.read_kitti(str(tmp_path / "j.txt"))):
        np.testing.assert_array_equal(a, b)


def test_port_imports_without_jax():
    """The port must import with jax unavailable (the GPU machine has none)."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import stereo_dso_g2o_tpu_torch\n"
        "from stereo_dso_g2o_tpu_torch.frontend import full_system\n"
        "from stereo_dso_g2o_tpu_torch import bridge\n"
        "from stereo_dso_g2o_tpu_torch.ops import trace_cuda\n"
        "from stereo_dso_g2o_tpu_torch.io import synthetic\n"
        "from stereo_dso_g2o_tpu_torch import run_odometry\n"
        "from stereo_dso_g2o_tpu_torch.io import dataset, output_wrapper, viewer, debug_viz\n"
        "from stereo_dso_g2o_tpu_torch.models import undistort\n"
        "from stereo_dso_g2o_tpu_torch.runtime import native_loader\n"
        "from stereo_dso_g2o_tpu_torch import bench, graft_entry\n"
        "from stereo_dso_g2o_tpu_torch.frontend import initializer\n"
        "from stereo_dso_g2o_tpu_torch.utils import knn\n"
        "from stereo_dso_g2o_tpu_torch.tools import (accuracy_probe, analyze_kf_decisions,\n"
        "    bench_enlarged_window, profile_frame, profile_kf_stages, profile_refine_stages,\n"
        "    profile_track_stages)\n"
        "assert sys.modules['jax'] is None\n"
        "import torch\n"
        "from stereo_dso_g2o_tpu_torch.models.camera import make_calib\n"
        "cal = make_calib(100.0, 100.0, 63.5, 31.5, 0.1, 128, 64, n_levels=3, device='cpu')\n"
        "torch.cuda.is_available = lambda: False\n"
        "tools = (accuracy_probe, bench_enlarged_window, profile_frame, profile_kf_stages,\n"
        "         profile_refine_stages, profile_track_stages)\n"
        "for call in (bench.main, graft_entry.entry, lambda: graft_entry.dryrun_multichip(1),\n"
        "             lambda: initializer.MonoInitializer(cal), *(t.main for t in tools)):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(f'{call} ran without a device')\n"
        "fn, args = graft_entry.entry(device='cpu')\n"
        "assert int(fn(*args)[3]) > 0 and sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    for path in (ROOT / "stereo_dso_g2o_tpu_torch").rglob("*.py"):
        src = path.read_text()
        assert "import jax" not in src and "from jax" not in src, path
        assert "stereo_dso_g2o_tpu." not in src.replace("stereo_dso_g2o_tpu_torch.", ""), path


def test_tf32_pinned_off():
    import stereo_dso_g2o_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
