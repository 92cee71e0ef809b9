"""The frame program: the port's graph_system against the JAX package's, on
test_graph_system.py's sequence (256x128, 8 frames of FullSystem bootstrap
+ 8 frames of GraphSystem). One JAX run per module hands over, as numpy,
the state before every graph frame and the bundle after it; the port steps
from those snapshots (`bridge.graph_state_from_numpy`) and runs the whole
slice on its own. The policies are held against the JAX functions on the
run's windows and on seeded inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import ReadCounter, fields, gs_snapshot, jax_graph_uniform, jax_uniform, n, t
from test_graph_system import BASE, H_, SET, W_, _frames

from stereo_dso_g2o_tpu.backend import window as jW
from stereo_dso_g2o_tpu.frontend import frame_step as jfstep
from stereo_dso_g2o_tpu.frontend import graph_system as jgs
from stereo_dso_g2o_tpu.frontend.full_system import FullSystem as JFullSystem
from stereo_dso_g2o_tpu.io import trajectory as jtraj
from stereo_dso_g2o_tpu.models.camera import make_calib as jmake_calib
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.frontend import frame_step as tfstep
from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem as TFullSystem
from stereo_dso_g2o_tpu_torch.models.camera import make_calib as tmake_calib

N_BOOT, N_FRAMES, N_LVL = 8, 16, 5


def _tset(s=SET):
    return bridge.settings_from_fields(dataclasses.asdict(s))


def _tcalib(K):
    return tmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=N_LVL,
                       device="cpu")


@pytest.fixture(scope="module")
def jax_run():
    """One JAX run: FullSystem over frames 0..7, GraphSystem over 8..15. Per
    graph frame: the snapshot before it and the fetched bundle after it."""
    K, poses, frames = _frames(N_FRAMES)
    fs = JFullSystem(jmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_,
                                 n_levels=N_LVL), SET)
    for i in range(N_BOOT):
        fs.add_frame(frames[i][0], frames[i][1], i, timestamp=0.1 * i)
    gs = jgs.GraphSystem.from_full_system(fs)
    snaps, bundles, aux = {N_BOOT: gs_snapshot(gs)}, {}, {}
    for i in range(N_BOOT, N_FRAMES):
        state_pre = gs.state
        gs.add_frame(frames[i][0], frames[i][1], i, timestamp=0.1 * i)
        bundles[i] = jax.device_get(gs._pending_q[-1][0])
        snaps[i + 1] = gs_snapshot(gs)
        if bool(bundles[i].need_kf) and not aux:
            # the JAX tracking result of the first graph keyframe, as numpy
            _, _, a = jgs.frame_track(
                state_pre, jnp.asarray(frames[i][0]), jnp.asarray(frames[i][1]), gs.calib.c,
                gs.calib.baseline, jnp.float32(1.0), settings=SET, n_levels=N_LVL, n_tries=5,
                w0=W_, h0=H_)
            aux[i] = jax.device_get(a)
    traj = gs.trajectory()
    return dict(K=K, poses=poses, frames=frames, gs=gs, snaps=snaps, bundles=bundles, aux=aux,
                traj=traj, kf_ids=[s.id for s in gs.kf_shells])


def _frame_of(jax_run, want_kf):
    return next(i for i, b in sorted(jax_run["bundles"].items()) if bool(b.need_kf) == want_kf)


def _step(jax_run, i):
    """The port's frame_auto on frame i from the JAX state before it."""
    snap = jax_run["snaps"][i]
    calib = _tcalib(jax_run["K"])
    state = bridge.graph_state_from_numpy(snap, device="cpu")
    left, right = jax_run["frames"][i]
    return tgs.frame_auto(
        state, t(left), t(right), calib.c, calib.baseline, torch.tensor(1.0),
        settings=_tset(), n_levels=N_LVL, n_tries=5, pot=snap["pot"],
        caps=tuple(tgs.level_caps(calib)), w0=W_, h0=H_, imm_cap=SET.immature_cap,
        uniform=jax_graph_uniform,
    )


def _check_step(jax_run, i, st, b, own_tracking=False):
    """own_tracking: the keyframe branch ran from the port's own tracking
    result, which differs from the JAX one in the last bits (pose ~1e-6,
    affine ~4e-5). The reference's sub-pixel start jitter (frac(u_min*1000))
    turns that into ~1e-2 px in the traced positions, one or two borderline
    activations flip, and BA answers with ~2e-5 in the poses and ~4e-3 in
    the energy. From the JAX tracking result everything below is strict."""
    want_b = jax_run["bundles"][i]
    after = jax_run["snaps"][i + 1]
    want_win = bridge.window_from_numpy(after["win"], device="cpu")
    pose_tol, n_tol, e_tol, a_tol = (5e-5, 3, 1e-2, 5e-3) if own_tracking else (1e-5, 0, 1e-4, 1e-5)
    # pose and window poses: the optimize_fused / frame_step_full targets
    np.testing.assert_allclose(n(b.T), np.array(want_b.T), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(st.win.w2c()), n(want_win.w2c()), atol=pose_tol, rtol=0)
    np.testing.assert_allclose(n(b.w2c), np.array(want_b.w2c), atol=pose_tol, rtol=0)
    # threshold decisions on f32 values: the trace module's 99.9 % target
    assert (n(st.win.pt_status) == after["win"]["pt_status"]).mean() >= 0.999
    assert (n(st.imm.valid) == after["imm"]["valid"]).mean() >= 0.999
    assert (n(st.imm.status) == after["imm"]["status"]).mean() >= 0.999
    # FrameBundle scalars: flags, indices and counts equal
    for k in ("ok", "need_kf", "slot", "sel_num", "n_active"):
        assert int(getattr(b, k)) == int(getattr(want_b, k)), k
    for k in ("nres", "n_activated", "n_imm", "n_marg", "n_dropped"):
        assert abs(int(getattr(b, k)) - int(getattr(want_b, k))) <= (4 if k == "nres" else 1) * n_tol, k
    for k in ("flagged", "frame_valid", "frame_id"):
        np.testing.assert_array_equal(n(getattr(b, k)), np.array(getattr(want_b, k)), k)
    # energy: a sum of ~1e4 f32 Huber terms in another order
    if np.isfinite(float(want_b.energy)):
        assert abs(float(b.energy) - float(want_b.energy)) <= e_tol * abs(float(want_b.energy))
    else:
        assert not np.isfinite(float(b.energy))
    np.testing.assert_allclose(n(b.kf_delta), float(want_b.kf_delta), rtol=1e-4, atol=1e-6)
    # the state's scalars
    for k, v in after["scalars"].items():
        got = n(getattr(st, k))
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(got, v, k)
        else:
            np.testing.assert_allclose(got, v, atol=a_tol, rtol=1e-4, err_msg=k)
    for lvl, (got, want) in enumerate(zip(st.ref, after["ref"])):
        assert (n(got[4]) == want[4]).mean() >= 0.999, lvl


def test_non_keyframe_step_matches_jax(jax_run):
    i = _frame_of(jax_run, False)
    st, b = _step(jax_run, i)
    assert not bool(b.need_kf)
    _check_step(jax_run, i, st, b)


def test_keyframe_step_matches_jax(jax_run):
    """frame_auto on the first graph keyframe, tracking included."""
    i = _frame_of(jax_run, True)
    st, b = _step(jax_run, i)
    assert bool(b.need_kf) and int(b.slot) >= 0
    _check_step(jax_run, i, st, b, own_tracking=True)


def _kf_kwargs(jax_run, i):
    calib = _tcalib(jax_run["K"])
    return calib, dict(settings=_tset(), n_levels=N_LVL, w0=W_, h0=H_, pot=jax_run["snaps"][i]["pot"],
                       caps=tuple(tgs.level_caps(calib)), imm_cap=SET.immature_cap,
                       uniform=jax_graph_uniform)


def test_keyframe_branch_from_jax_tracking_matches_jax(jax_run):
    """frame_kf from the JAX state before the keyframe and the JAX tracking
    result of that frame (its TrackAux, as numpy): the keyframe branch
    alone, at the strict tolerances."""
    (i, jaux), = jax_run["aux"].items()
    calib, kw = _kf_kwargs(jax_run, i)
    aux = tgs.TrackAux(
        dIpL=tuple(t(x) for x in jaux.dIpL), dIpR0=t(jaux.dIpR0),
        track=tfstep.TrackOut(*[t(x) for x in jaux.track]),
        **{k: t(getattr(jaux, k)) for k in tgs.TrackAux._fields[3:]},
    )
    state = bridge.graph_state_from_numpy(jax_run["snaps"][i], device="cpu")
    st, b = tgs.frame_kf(state, aux, calib.c, calib.baseline, torch.tensor(1.0), **kw)
    _check_step(jax_run, i, st, b)


def test_frame_track_then_frame_kf_is_frame_auto(jax_run):
    """The split pair (frame_track + frame_kf from the pre-state) is
    frame_auto's keyframe branch: the same numbers, bit for bit."""
    i = _frame_of(jax_run, True)
    calib, kw = _kf_kwargs(jax_run, i)
    left, right = jax_run["frames"][i]
    exp = torch.tensor(1.0)
    state = bridge.graph_state_from_numpy(jax_run["snaps"][i], device="cpu")
    st_nk, b_nk, aux = tgs.frame_track(state, t(left), t(right), calib.c, calib.baseline, exp,
                                       settings=kw["settings"], n_levels=N_LVL, n_tries=5,
                                       w0=W_, h0=H_)
    assert bool(b_nk.need_kf) and int(b_nk.slot) == -1
    assert st_nk.win is state.win  # the non-KF update leaves the window alone
    st, b = tgs.frame_kf(state, aux, calib.c, calib.baseline, exp, **kw)
    st2, b2 = _step(jax_run, i)
    for k in b._fields:
        np.testing.assert_array_equal(n(getattr(b, k)), n(getattr(b2, k)), k)
    np.testing.assert_array_equal(n(st.win.HM), n(st2.win.HM))
    np.testing.assert_array_equal(n(st.imm.idepth_min), n(st2.imm.idepth_min))


def test_graph_system_slice_matches_jax(jax_run):
    """The slice as a whole: the port's own bootstrap, freeze and 8 graph
    frames against the JAX run."""
    K, poses, frames = jax_run["K"], jax_run["poses"], jax_run["frames"]
    fs = TFullSystem(_tcalib(K), _tset(), device="cpu", uniform=jax_uniform)
    for i in range(N_BOOT):
        fs.add_frame(frames[i][0], frames[i][1], i, timestamp=0.1 * i)
    gs = tgs.GraphSystem.from_full_system(fs, uniform=jax_graph_uniform)
    kfs_before = len(gs.kf_shells)
    for i in range(N_BOOT, N_FRAMES):
        drained = gs.add_frame(frames[i][0], frames[i][1], i, timestamp=0.1 * i)
        assert (drained is None) == (i < N_BOOT + gs.fetch_lag)
        assert not gs.is_lost
    tt = gs.trajectory()
    assert len(tt) == N_FRAMES and len(gs.kf_shells) > kfs_before
    assert [s.id for s in gs.kf_shells] == jax_run["kf_ids"]
    dt = [np.linalg.norm(a[:3, 3] - b[:3, 3]) for a, b in zip(jax_run["traj"], tt)]
    # The port's own 8-frame bootstrap ends 1.4e-4 from the JAX one (window
    # poses; the FullSystem slice's tolerance). The tail of this sequence
    # amplifies a difference ~5x per frame after the graph keyframe (every
    # single step from a JAX snapshot agrees to 2e-6, see above), so 16
    # chained frames end ~1e-2 m apart, the size of either run's own error
    # against ground truth (ATE 5.8e-3 and 5.0e-3 m). Observed: 9.0e-3 m,
    # ATE difference 8.3e-4 m. The chain from the JAX freeze point, below,
    # holds the 1e-3 m / 5e-4 m targets.
    assert max(dt) <= 2e-2, dt
    assert max(dt[:N_BOOT]) <= 1e-3, dt
    ate_j, ate_t = jtraj.ate_rmse(jax_run["traj"], poses), jtraj.ate_rmse(tt, poses)
    assert abs(ate_j - ate_t) <= 2e-3, (ate_j, ate_t)
    assert ate_t < 0.03  # test_graph_system's own bound
    cloud = gs.point_cloud()
    assert cloud["xyz"].shape[0] > 100 and np.isfinite(cloud["xyz"]).all()


def test_graph_chain_from_jax_freeze_matches_jax(jax_run, monkeypatch):
    """Eight chained graph frames (add_frame, lagged drain, potential
    adaptation) from the JAX system's freeze point: same keyframes,
    per-frame translation <= 1e-3 m, ATE within 5e-4 m."""
    K, poses, frames = jax_run["K"], jax_run["poses"], jax_run["frames"]
    gs = bridge.graph_system_from_snapshot(jax_run["snaps"][N_BOOT], _tcalib(K), _tset(),
                                           device="cpu", uniform=jax_graph_uniform)
    counter = ReadCounter(monkeypatch)
    drain = gs._drain_one

    def drain_apart():
        counter.on = False
        try:
            return drain()
        finally:
            counter.on = True

    gs._drain_one = drain_apart
    tgs.reset_host_reads()
    for i in range(N_BOOT, N_FRAMES):
        gs.add_frame(frames[i][0], frames[i][1], i, timestamp=0.1 * i)
    tt = gs.trajectory()
    monkeypatch.undo()
    n_kf = len(gs.kf_shells) - len(jax_run["snaps"][N_BOOT]["kf_shells"])
    # every read the frame program makes (each LM iteration, need_kf, a
    # keyframe's packed read, its activation counts and BA flags) and the
    # drain's one wait per frame
    assert n_kf >= 1 and counter.n > 2 * (N_FRAMES - N_BOOT)
    assert tgs.HOST_READS == counter.n + (N_FRAMES - N_BOOT), counter.by
    assert [s.id for s in gs.kf_shells] == jax_run["kf_ids"] and gs.pot == jax_run["gs"].pot
    dt = [np.linalg.norm(a[:3, 3] - b[:3, 3]) for a, b in zip(jax_run["traj"], tt)]
    assert max(dt) <= 1e-3, dt
    ate_j, ate_t = jtraj.ate_rmse(jax_run["traj"], poses), jtraj.ate_rmse(tt, poses)
    assert abs(ate_j - ate_t) <= 5e-4, (ate_j, ate_t)


def test_from_full_system_state_matches_jax(jax_run):
    """bridge.graph_system_from_snapshot rebuilds the JAX system; its
    trajectory is the JAX one at that point."""
    snap = jax_run["snaps"][N_BOOT]
    gs = bridge.graph_system_from_snapshot(snap, _tcalib(jax_run["K"]), _tset(), device="cpu")
    assert int(gs.state.salt) == 1000 * (1 + len(gs.kf_shells)) and gs.pot == snap["pot"]
    assert len(gs.trajectory()) == N_BOOT


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


def _jwin(arrays):
    return jW.Window(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("case", ["as_run", "few_points_left", "window_full", "affine_gap"])
def test_flag_frames_matches_jax(jax_run, case):
    snap = jax_run["snaps"][N_FRAMES]
    win = {k: v.copy() for k, v in snap["win"].items()}
    imm_valid = snap["imm"]["valid"].copy()
    kf_out = snap["scalars"]["kf_out_count"].copy()
    # the run ends with 4 keyframes in the window: lower the floors so
    # that the rules can fire
    s = dataclasses.replace(SET, min_frames=2)
    rng = np.random.default_rng(3)
    if case == "few_points_left":
        kf_out = rng.integers(20000, 90000, kf_out.shape).astype(np.int32)
    elif case == "window_full":
        s = dataclasses.replace(SET, max_frames=int(win["frame_valid"].sum()))
    elif case == "affine_gap":
        oldest = np.argmin(np.where(win["frame_valid"], win["frame_id"], 10**6))
        win["state"][oldest, 6] += 1.2 / 10.0  # SCALE_A = 10
    want = np.array(jgs.flag_frames(_jwin(win), jnp.asarray(imm_valid), jnp.asarray(kf_out), s))
    got = tgs.flag_frames(bridge.window_from_numpy(win, device="cpu"),
                          torch.from_numpy(imm_valid), torch.from_numpy(kf_out), _tset(s))
    np.testing.assert_array_equal(n(got), want)
    if case != "as_run":
        assert want.any()
    assert int(tgs._free_slot(bridge.window_from_numpy(win, device="cpu"))) == int(
        jgs._free_slot(_jwin(win)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kf_decision_matches_jax(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    aff = rng.normal(0, 0.2, 2).astype(f32)
    flow = (rng.uniform(0, 3.0e3, 3) * (seed % 2 + 0.02)).astype(f32)
    res = rng.uniform(1, 12, N_LVL).astype(f32)
    ref_aff = rng.normal(0, 0.2, 2).astype(f32)
    ref_exp, new_exp, first = f32(rng.uniform(0.8, 1.2)), f32(rng.uniform(0.8, 1.2)), f32(
        rng.uniform(2, 8))
    jt = jfstep.TrackOut(T=jnp.eye(4, dtype=jnp.float32), aff=jnp.asarray(aff),
                         residuals=jnp.asarray(res), flow=jnp.asarray(flow),
                         ok=jnp.asarray(True), sat_frac0=jnp.float32(0))
    tt = tfstep.TrackOut(T=torch.eye(4), aff=t(aff), residuals=t(res), flow=t(flow),
                         ok=torch.tensor(True), sat_frac0=torch.tensor(0.0))
    jneed, jdelta = jgs.kf_decision(jt, jnp.asarray(ref_aff), jnp.float32(ref_exp),
                                    jnp.float32(new_exp), jnp.float32(first), float(W_ + H_), SET)
    tneed, tdelta = tgs.kf_decision(tt, t(ref_aff), torch.tensor(ref_exp), torch.tensor(new_exp),
                                    torch.tensor(first), float(W_ + H_), _tset())
    assert bool(tneed) == bool(jneed)
    np.testing.assert_allclose(float(tdelta), float(jdelta), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_motion_tries_matches_jax(seed):
    from stereo_dso_g2o_tpu.utils import se3 as jse3

    rng = np.random.default_rng(seed)

    def pose(scale):
        xi = (rng.normal(0, scale, 6)).astype(np.float32)
        return np.array(jse3.se3_exp(jnp.asarray(xi)), np.float32)

    ref, prev = pose(0.3), pose(0.3)
    last = prev @ pose(0.03)
    if seed == 2:
        prev = np.full((4, 4), np.nan, np.float32)  # uninitialized history
    want = np.array(jgs.motion_tries(jnp.asarray(last), jnp.asarray(prev), jnp.asarray(ref)))
    got = n(tgs.motion_tries(t(last), t(prev), t(ref)))
    # three chained 4x4 f32 products and an exp(log()) of entries up to ~1:
    # a few ulps of 1.0 each
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    np.testing.assert_allclose(n(tgs._rigid_inv(t(ref))), np.array(jgs._rigid_inv(jnp.asarray(ref))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_active", [100, 420, 500, 560, 599, 600, 601, 700, 800, 950])
def test_update_min_act_dist_matches_jax(n_active):
    for mad in (0.0, 0.3, 2.0, 3.9):
        want = float(jgs._update_min_act_dist(jnp.float32(mad), jnp.asarray(n_active, jnp.int32),
                                              SET.desired_point_density))
        got = float(tgs._update_min_act_dist(torch.tensor(mad), torch.tensor(n_active,
                                             dtype=torch.int32), SET.desired_point_density))
        assert abs(got - want) <= 1e-6, (mad, n_active, got, want)


def test_window_fields_round_trip(jax_run):
    """gs_snapshot -> graph_state_from_numpy keeps every field's values."""
    snap = jax_run["snaps"][N_BOOT]
    st = bridge.graph_state_from_numpy(snap, device="cpu")
    for k, v in snap["win"].items():
        np.testing.assert_array_equal(n(getattr(st.win, k)), v.astype(n(getattr(st.win, k)).dtype))
    for k, v in fields(jax_run["gs"].state.imm).items():
        assert n(getattr(st.imm, k)).shape == v.shape
    assert st.dI0_slots.shape == (SET.window_cap, H_, W_, 3)
