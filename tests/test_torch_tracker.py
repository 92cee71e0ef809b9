"""Coarse tracking of the PyTorch port against the JAX package: the
tracking reference (build_ref_maps + compact_ref_level), the residual and
normal-equation pass (calc_res, calc_gs), one LM level (lm_level), the
whole pyramid cascade (CoarseTracker), and the pose hypotheses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, t

from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu.frontend import coarse_tracker as jct
from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu.models.camera import make_calib as jmake_calib
from stereo_dso_g2o_tpu.ops import tracker_ops as jops
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid as jbuild_pyramid
from stereo_dso_g2o_tpu.utils import se3 as jse3
from stereo_dso_g2o_tpu_torch.config import default_settings as tdefault_settings
from stereo_dso_g2o_tpu_torch.frontend import coarse_tracker as tct
from stereo_dso_g2o_tpu_torch.models.camera import make_calib as tmake_calib
from stereo_dso_g2o_tpu_torch.ops import tracker_ops as tops
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid as tbuild_pyramid

W_, H_, N_LVL = 256, 128, 5
JSET, TSET = jdefault_settings(), tdefault_settings()
# Pose: both sides run the same f32 LM; 1e-5 on the 4x4 entries is ~100
# float32 ulps of a unit rotation, room for the solve's rounding on a
# well-posed level. Residuals are sqrt(E/n) over ~1e3 Huber terms summed in
# another order: 1e-4 relative.
POSE_ATOL = 1e-5
RES_RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """Reference frame with ground-truth inverse depths at seeded pixels, and
    a frame rendered under a known motion; trackers of both packages set on
    the same reference."""
    scene = synthetic.default_scene(2)
    K = synthetic.default_K(W_, H_)
    ref_img, idepth = synthetic.render(scene, K, W_, H_, np.eye(4))
    xi = np.array([0.04, -0.02, 0.06, 0.004, 0.008, -0.003])
    T_gt = np.asarray(jse3.se3_exp(jnp.asarray(xi)), np.float64)
    new_img, _ = synthetic.render(scene, K, W_, H_, T_gt)
    rng = np.random.default_rng(2)
    us = rng.integers(6, W_ - 6, 1200).astype(np.float32)
    vs = rng.integers(6, H_ - 6, 1200).astype(np.float32)
    ids = idepth[vs.astype(int), us.astype(int)].astype(np.float32)
    weights = rng.uniform(0.5, 1.0, 1200).astype(np.float32)
    valid = rng.uniform(size=1200) < 0.9

    jdref, _ = jbuild_pyramid(jnp.asarray(ref_img, jnp.float32), N_LVL)
    jdnew, _ = jbuild_pyramid(jnp.asarray(new_img, jnp.float32), N_LVL)
    jcal = jmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.15, W_, H_, n_levels=N_LVL)
    jtr = jct.CoarseTracker(jcal, JSET)
    jtr.set_reference(jdref, jnp.asarray(us), jnp.asarray(vs), jnp.asarray(ids),
                      jnp.asarray(weights), jnp.asarray(valid))

    tdref, _ = tbuild_pyramid(t(ref_img), N_LVL)
    tdnew, _ = tbuild_pyramid(t(new_img), N_LVL)
    tcal = tmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.15, W_, H_, n_levels=N_LVL,
                       device="cpu")
    ttr = tct.CoarseTracker(tcal, TSET)
    ttr.set_reference(tdref, t(us), t(vs), t(ids), t(weights), torch.from_numpy(valid))
    return dict(T_gt=T_gt, jcal=jcal, jtr=jtr, jdnew=jdnew, ttr=ttr, tdnew=tdnew)


def _klvl(cal, lvl):
    return jnp.stack([cal.fx(lvl), cal.fy(lvl), cal.cx(lvl), cal.cy(lvl)]).astype(jnp.float32)


def test_reference_maps_match(pair):
    for lvl, (jl, tl) in enumerate(zip(pair["jtr"].ref, pair["ttr"].ref)):
        ju, jv, jid, jcol, jok = (np.array(x) for x in jl)
        tu, tv, tid, tcol, tok = (n(x) for x in tl)
        np.testing.assert_array_equal(tok, jok, err_msg=f"level {lvl}")
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tv, jv)
        # splatted weighted means of idepth: sums of a few f32 terms
        np.testing.assert_allclose(tid, jid, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tcol, jcol, rtol=RES_RTOL)


@pytest.mark.parametrize("lvl", [0, 2, 4])
def test_calc_res_and_calc_gs_match(pair, lvl):
    """Residuals and the 8x8 normal equations at a pose 1 % off the truth."""
    T = (pair["T_gt"] @ np.asarray(jse3.se3_exp(jnp.asarray([0.01, 0, -0.01, 0.002, 0, 0])))).astype(
        np.float32
    )
    ref = pair["jtr"].ref[lvl]
    Kl = _klvl(pair["jcal"], lvl)
    ab = np.array([1.0, 0.0], np.float32)
    js = jops.calc_res(*ref, pair["jdnew"][lvl], Kl, jnp.asarray(T), jnp.asarray(ab),
                       jnp.float32(1e30), settings=JSET, compute_flow=True)
    ts = tops.calc_res(*pair["ttr"].ref[lvl], pair["tdnew"][lvl], t(Kl), t(T)[None], t(ab)[None],
                       torch.tensor([1e30]), settings=TSET, compute_flow=True)
    assert int(ts.num_terms[0]) == int(js.num_terms)
    np.testing.assert_array_equal(n(ts.buf_inb[0]), np.array(js.buf_inb))
    np.testing.assert_allclose(float(ts.energy[0]), float(js.energy), rtol=RES_RTOL)
    np.testing.assert_allclose(float(ts.flow_t[0]), float(js.flow_t), rtol=RES_RTOL)
    np.testing.assert_allclose(n(ts.buf_residual[0]), np.array(js.buf_residual), rtol=RES_RTOL, atol=1e-3)
    jH, jb = jops.calc_gs(js, Kl, jnp.float32(1.0), jnp.float32(0.0))
    tH, tb = tops.calc_gs(ts, t(Kl), torch.tensor([1.0]), torch.tensor(0.0))
    scale = np.abs(np.array(jH)).max()
    np.testing.assert_allclose(n(tH[0]), np.array(jH), atol=RES_RTOL * scale)
    np.testing.assert_allclose(n(tb[0]), np.array(jb), atol=RES_RTOL * np.abs(np.array(jb)).max())


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_lm_level_matches(pair, lvl):
    """One level of LM from the same start (a pose 1 % off the truth).
    The coarsest level (36 points here, 8 unknowns) is left to the cascade
    test: its LM stops on a flat valley where the two sides' last iterates
    legitimately differ by ~1e-4."""
    T0 = (pair["T_gt"] @ np.asarray(jse3.se3_exp(jnp.asarray([0.01, 0, -0.01, 0.002, 0, 0])))).astype(
        np.float32
    )
    aff0 = np.zeros(2, np.float32)
    mi = jct.MAX_ITERATIONS[min(lvl, len(jct.MAX_ITERATIONS) - 1)]
    jo = jops.lm_level(*pair["jtr"].ref[lvl], pair["jdnew"][lvl], _klvl(pair["jcal"], lvl),
                       jnp.asarray(T0), jnp.asarray(aff0), pair["jtr"].ref_aff, jnp.float32(1),
                       jnp.float32(1), jnp.asarray(False), settings=JSET, max_iterations=mi)
    to = tops.lm_level(*pair["ttr"].ref[lvl], pair["tdnew"][lvl], t(_klvl(pair["jcal"], lvl)),
                       t(T0)[None], t(aff0)[None], pair["ttr"].ref_aff, torch.tensor(1.0),
                       torch.tensor(1.0), torch.tensor([False]), settings=TSET, max_iterations=mi)
    np.testing.assert_allclose(n(to.T[0]), np.array(jo.T), atol=POSE_ATOL, rtol=0)
    # the affine offset b is in gray levels (~1): relative, as residuals
    np.testing.assert_allclose(n(to.aff[0]), np.array(jo.aff), rtol=RES_RTOL, atol=POSE_ATOL)
    np.testing.assert_allclose(float(to.res_per_point[0]), float(jo.res_per_point), rtol=RES_RTOL)
    assert int(to.num_terms[0]) == int(jo.num_terms)
    assert bool(to.repeated[0]) == bool(jo.repeated)


def test_coarse_tracker_cascade_matches(pair):
    inf = np.full(N_LVL, np.inf)
    jr = pair["jtr"].track_newest_coarse(pair["jdnew"], np.eye(4), np.zeros(2), N_LVL - 1, inf)
    tr = pair["ttr"].track_newest_coarse(pair["tdnew"], np.eye(4), np.zeros(2), N_LVL - 1, inf)
    assert tr.ok == jr.ok and tr.ok
    np.testing.assert_allclose(tr.T_ref_new, jr.T_ref_new, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(tr.residuals, jr.residuals, rtol=RES_RTOL)
    np.testing.assert_allclose(tr.flow, jr.flow, rtol=RES_RTOL)
    # and it tracked: the translation is within 5 mm of the truth (scene ~5 m)
    assert np.linalg.norm(tr.T_ref_new[:3, 3] - pair["T_gt"][:3, 3]) < 5e-3


def test_pose_hypotheses_match():
    for a, b in zip(tct.rotation_ladder(), jct.rotation_ladder()):
        np.testing.assert_allclose(a, b, atol=1e-12)
    rng = np.random.default_rng(5)
    Ts = [np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.1, 6))), np.float64) for _ in range(3)]
    for a, b in zip(tct.motion_model_tries(*Ts), jct.motion_model_tries(*Ts)):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_cascade_step_matches(pair):
    """`frame_step.cascade_step` (one hypothesis on pyramids already built)
    against the JAX `cascade_step` on the same pyramid and reference at the
    tracker tolerances above (affine 1e-4), and against the port's own host
    cascade at tests/test_frame_step.py's (pose 2e-5, affine 1e-4,
    residuals 1e-3 where both ran)."""
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.frontend import frame_step as jfs
    from stereo_dso_g2o_tpu_torch.frontend import frame_step as tfs

    jtr, ttr = pair["jtr"], pair["ttr"]
    want = jfs.cascade_step(
        pair["jdnew"], tuple(jtr.ref), jtr.calib.c, jtr.calib.baseline,
        jnp.eye(4, dtype=jnp.float32), jnp.zeros(2, jnp.float32), jtr.ref_aff,
        jnp.float32(1.0), jnp.float32(1.0), jnp.full(N_LVL, jnp.inf, jnp.float32),
        settings=JSET, n_levels=N_LVL)
    got = tfs.cascade_step(
        pair["tdnew"], tuple(ttr.ref), ttr.calib.c, ttr.calib.baseline, torch.eye(4),
        torch.zeros(2), ttr.ref_aff, torch.tensor(1.0), torch.tensor(1.0),
        torch.full((N_LVL,), float("inf")), settings=TSET, n_levels=N_LVL)
    assert bool(got.ok) and bool(want.ok) and got.T.shape == (4, 4)
    np.testing.assert_allclose(n(got.T), np.array(want.T), atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(n(got.aff), np.array(want.aff), atol=1e-4, rtol=0)
    np.testing.assert_allclose(n(got.residuals), np.array(want.residuals), rtol=RES_RTOL)
    np.testing.assert_allclose(n(got.flow), np.array(want.flow), rtol=RES_RTOL)
    host = ttr.track_newest_coarse(pair["tdnew"], np.eye(4), np.zeros(2), N_LVL - 1,
                                   np.full(N_LVL, np.inf))
    assert host.ok
    np.testing.assert_allclose(n(got.T), host.T_ref_new, atol=2e-5, rtol=0)
    np.testing.assert_allclose(n(got.aff), host.aff, atol=1e-4, rtol=0)
    fr = n(got.residuals)
    m = np.isfinite(fr) & np.isfinite(host.residuals)
    assert m.any()
    np.testing.assert_allclose(fr[m], host.residuals[m], rtol=1e-3)
