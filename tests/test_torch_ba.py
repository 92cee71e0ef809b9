"""The windowed BA of the PyTorch port against the JAX package, on the
3-frame rendered window of test_ba.py (perturbed poses and depths, with
depth priors) handed
over through `stereo_dso_g2o_tpu_torch.bridge`: residual linearization,
the GN loop, point flagging, and point and frame marginalization. (BA from
the real warmed windows of a FullSystem run is in test_torch_full_system.)

Tolerances: the Jacobians and residuals are per-term f32 products, 1e-4
relative to the largest entry; the energy is a sum of ~1e3 Huber terms in
another order, 1e-4 relative; poses 1e-5 on the 4x4 entries; the
marginalization prior HM/bM is a sum of outer products, 1e-4 of its
largest entry."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import fields, n, t
from test_ba import _build_window

from stereo_dso_g2o_tpu.backend import ba as jba
from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu.ops import residuals as jres
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.backend import ba as tba
from stereo_dso_g2o_tpu_torch.ops import residuals as tres

JSET = jdefault_settings()
TSET = bridge.settings_from_fields(dataclasses.asdict(JSET))
RTOL = 1e-4


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=rtol * scale, rtol=0,
                               err_msg=what)


@pytest.fixture(scope="module")
def window():
    jwin, jdI, poses, idepths, K = _build_window(seed=1, n_pts=250, pose_noise=0.005,
                                                 idepth_noise=0.03)
    # depth priors on every point, as FullSystem's stereo initialization
    # gives them: without them the window's scale is free, and the first
    # (not yet orthogonalized) GN steps wander along it differently on each
    # side by ~3e-4
    jwin = jwin.replace(pt_has_prior=jwin.pt_status == 1)
    jdI = jdI.astype(jnp.float32)  # its zero padding is float64 under x64
    return jwin, jdI, bridge.window_from_numpy(fields(jwin), device="cpu"), t(jdI)


def test_bridge_round_trip(window):
    jwin, _, twin, _ = window
    for name, arr in fields(jwin).items():
        got = n(getattr(twin, name))
        np.testing.assert_array_equal(got, arr.astype(got.dtype), err_msg=name)


def test_linearize_matches(window):
    jwin, jdI, twin, tdI = window
    jl = jres.linearize(jwin, jdI, settings=JSET)
    tl = tres.linearize(twin, tdI, settings=TSET)
    np.testing.assert_array_equal(n(tl.new_state), np.array(jl.new_state))
    for f in jl._fields:
        if f != "new_state":
            _close(n(getattr(tl, f)), np.array(getattr(jl, f)), what=f)


def test_optimize_fused_matches(window):
    jwin, jdI, twin, tdI = window
    jw, je, jn = jba.optimize_fused(jwin, jdI, settings=JSET, max_its=6)
    tw, te, tn = tba.optimize_fused(twin, tdI, settings=TSET, max_its=6)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(te), float(je), rtol=RTOL)
    want = bridge.window_from_numpy(fields(jw), device="cpu")
    np.testing.assert_allclose(n(tw.w2c()), n(want.w2c()), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tw.pt_idepth), n(want.pt_idepth), rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(n(tw.res_state), n(want.res_state))


def test_flag_and_marginalize_points_match(window):
    jwin, jdI, twin, tdI = window
    jw, _, _ = jba.optimize_fused(jwin, jdI, settings=JSET, max_its=4)
    tw = bridge.window_from_numpy(fields(jw), device="cpu")
    marg = np.array([True, False, False, False])
    jf = jba.flag_points_for_removal(jw, jdI, jnp.asarray(marg), 2, 1, settings=JSET)
    tf = tba.flag_points_for_removal(tw, tdI, torch.from_numpy(marg), 2, 1, settings=TSET)
    np.testing.assert_array_equal(n(tf.pt_status), np.array(jf.pt_status))
    assert (np.array(jf.pt_status) != np.array(jw.pt_status)).any()
    jm = jba.marginalize_points(jf, settings=JSET)
    tm = tba.marginalize_points(tf, settings=TSET)
    np.testing.assert_array_equal(n(tm.pt_status), np.array(jm.pt_status))
    _close(n(tm.HM), np.array(jm.HM), what="HM")
    _close(n(tm.bM), np.array(jm.bM), what="bM")


def test_marginalize_frame_matches(window):
    jwin, jdI, twin, tdI = window
    jw, _, _ = jba.optimize_fused(jwin, jdI, settings=JSET, max_its=4)
    tw = bridge.window_from_numpy(fields(jw), device="cpu")
    jd = jba.marginalize_frame(jba.drop_frame_refs(jw, 1), 1, settings=JSET)
    td = tba.marginalize_frame(tba.drop_frame_refs(tw, 1), 1, settings=TSET)
    np.testing.assert_array_equal(n(td.frame_valid), np.array(jd.frame_valid))
    np.testing.assert_array_equal(n(td.pt_status), np.array(jd.pt_status))
    np.testing.assert_array_equal(n(td.res_exists), np.array(jd.res_exists))
    _close(n(td.HM), np.array(jd.HM), what="HM")
    _close(n(td.bM), np.array(jd.bM), what="bM")
    flagged = np.array([False, False, True, False])
    jmm = jba.marginalize_frames_masked(jw, jnp.asarray(flagged), settings=JSET)
    tmm = tba.marginalize_frames_masked(tw, flagged, settings=TSET)
    np.testing.assert_array_equal(n(tmm.frame_valid), np.array(jmm.frame_valid))
    _close(n(tmm.HM), np.array(jmm.HM), what="HM masked")


@pytest.fixture(scope="module")
def worked_window(window):
    """The window after one JAX BA iteration (residual energies and states
    set), with frame slot 2 made invalid besides the empty slot 3 and a few
    points marginalized or dropped: what the builder functions must leave
    or reset."""
    jwin, jdI, _, _ = window
    jw, *_ = jba.ba_iteration(jwin, jdI, jnp.asarray(0), settings=JSET)
    status = np.array(jw.pt_status)
    status[[4, 9, 30]] = 2
    status[[7, 250]] = 3
    return jw.replace(frame_valid=jw.frame_valid.at[2].set(False),
                      pt_status=jnp.asarray(status))


RES_FIELDS = ("res_exists", "res_state", "res_linearized", "res_energy")


@pytest.mark.parametrize("idx", [np.arange(40), np.array([200, 3, 77, 5, 11, 199]), np.array([], int)],
                         ids=["range", "noncontiguous", "empty"])
@pytest.mark.parametrize("target", [1, 3])
def test_add_residuals_matches(worked_window, idx, target):
    """Bit for bit, on a target frame that holds residuals and on an empty
    slot."""
    from stereo_dso_g2o_tpu.backend import builder as jbuilder
    from stereo_dso_g2o_tpu_torch.backend import builder as tbuilder

    want = jbuilder.add_residuals(worked_window, jnp.asarray(idx), target)
    got = tbuilder.add_residuals(bridge.window_from_numpy(fields(worked_window), device="cpu"),
                                 torch.from_numpy(idx), target)
    for f in RES_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)), np.array(getattr(want, f)), err_msg=f)


def test_add_residuals_all_pairs_and_free_slots_match(worked_window):
    """All-pairs residuals skip the host frame, invalid frames and points
    that are not active; the free slots are the inactive ones, in order."""
    from stereo_dso_g2o_tpu.backend import builder as jbuilder
    from stereo_dso_g2o_tpu_torch.backend import builder as tbuilder

    twin = bridge.window_from_numpy(fields(worked_window), device="cpu")
    want = jbuilder.add_residuals_all_pairs(worked_window)
    got = tbuilder.add_residuals_all_pairs(twin)
    for f in RES_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)), np.array(getattr(want, f)), err_msg=f)
    assert not n(got.res_exists)[:, 2:].any() and n(got.res_exists)[:, 1].sum() > 0
    for k in (0, 7, 10_000):
        np.testing.assert_array_equal(tbuilder.free_point_slots(twin, k),
                                      jbuilder.free_point_slots(worked_window, k))
    assert len(tbuilder.free_point_slots(twin, 10_000)) == int((n(twin.pt_status) == 0).sum())


@pytest.mark.parametrize("case", ["perturbed", "seed5", "converged"])
def test_optimize_matches(window, case, monkeypatch):
    """The legacy GN loop (`ba.optimize`, stop once `it >= min_opt_iterations`
    and converged) against the JAX `optimize`, on the module's perturbed
    window (6 iterations) and on tests/test_ba.py:239's (seed 5, 4
    iterations), both with depth priors (without them the two sides part
    along the free scale, see `window`). Same nres, energy and state at the
    tolerances of `optimize_fused` above. (tests/test_ba.py:134's perturbed
    window of 120 points parts by 2.6e-5 in its first GN step already, one
    `ba_iteration`: the module's 250 points stand in for it.) Both loops run
    as many iterations; "converged" starts from the JAX loop's result, where
    the stop rule ends the loop early."""
    if case in ("perturbed", "converged"):
        jwin, jdI, _, _ = window
        max_its = 6
        if case == "converged":
            jwin = jba.optimize(jwin, jdI, settings=JSET, max_its=6)[0]
    else:
        jwin, jdI, *_ = _build_window(seed=5)
        jwin = jwin.replace(pt_has_prior=jwin.pt_status == 1)
        jdI = jdI.astype(jnp.float32)
        max_its = 4
    its = {"jax": 0, "port": 0}

    def counted(side, fn):
        def call(*a, **kw):
            its[side] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(jba, "ba_iteration", counted("jax", jba.ba_iteration))
    monkeypatch.setattr(tba, "ba_iteration", counted("port", tba.ba_iteration))
    jw, je, jn = jba.optimize(jwin, jdI, settings=JSET, max_its=max_its)
    tw, te, tn = tba.optimize(bridge.window_from_numpy(fields(jwin), device="cpu"), t(jdI),
                              settings=TSET, max_its=max_its)
    assert its["port"] == its["jax"] and int(tn) == int(jn) > 0
    if case == "converged":
        assert its["jax"] < max_its  # the stop rule ended both loops, not max_its
    np.testing.assert_allclose(float(te), float(je), rtol=RTOL)
    want = bridge.window_from_numpy(fields(jw), device="cpu")
    np.testing.assert_allclose(n(tw.w2c()), n(want.w2c()), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tw.pt_idepth), n(want.pt_idepth), rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(n(tw.res_state), n(want.res_state))
