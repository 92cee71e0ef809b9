"""The whole slice: the port's FullSystem against the JAX package's
FullSystem on the 12-frame sequence of test_full_system.py, plus the two
heaviest per-frame programs (windowed BA, the non-keyframe step) held
against the JAX functions on the real warmed state that the JAX run hands
them (captured at the call, handed over through
`stereo_dso_g2o_tpu_torch.bridge`)."""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import fields, fs_snapshot, jax_uniform, n, t
from test_full_system import BASE, H_, SET, W_, _sequence

from stereo_dso_g2o_tpu.backend import ba as jba
from stereo_dso_g2o_tpu.frontend import frame_step as jfstep
from stereo_dso_g2o_tpu.frontend.full_system import FullSystem as JFullSystem
from stereo_dso_g2o_tpu.io import trajectory as jtraj
from stereo_dso_g2o_tpu.models.camera import make_calib as jmake_calib
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.backend import ba as tba
from stereo_dso_g2o_tpu_torch.frontend import frame_step as tfstep
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem as TFullSystem
from stereo_dso_g2o_tpu_torch.models.camera import make_calib as tmake_calib

N_FRAMES = 12
SNAP_AT = 6  # a keyframe of the JAX run: its KF branch is replayed from a snapshot


def _tset():
    return bridge.settings_from_fields(dataclasses.asdict(SET))


def _tcalib(K):
    return tmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=5,
                       device="cpu")


@pytest.fixture(scope="module")
def jax_run():
    """One JAX FullSystem run over the sequence, recording the inputs and
    outputs of every optimize_fused and frame_step_full call, and a snapshot
    of the whole system before frame SNAP_AT."""
    K, poses, frames = _sequence(N_FRAMES, seed=2)
    calls = {"ba": [], "step": []}
    real_ba, real_step = jba.optimize_fused, jfstep.frame_step_full

    def ba_rec(win, dI_stack, settings, max_its):
        out = real_ba(win, dI_stack, settings=settings, max_its=max_its)
        calls["ba"].append(dict(win=fields(win), dI=np.array(dI_stack), max_its=max_its,
                                out_win=fields(out[0]), energy=float(out[1]), nres=int(out[2])))
        return out

    def step_rec(*args, **kw):
        out = real_step(*args, **kw)
        (left, right, ref, win, imm, c, b, ref_slot, tries, aff0, ref_aff, ref_exp,
         new_exp, last0) = args
        track = out[2]
        calls["step"].append(dict(
            left=np.array(left), right=np.array(right),
            ref=[tuple(np.array(x) for x in lvl) for lvl in ref], win=fields(win),
            imm=fields(imm), c=np.array(c), b=float(b), ref_slot=int(ref_slot),
            tries=np.array(tries), aff0=np.array(aff0), ref_aff=np.array(ref_aff),
            ref_exp=float(ref_exp), new_exp=float(new_exp), last0=float(last0),
            kw=dict(n_levels=kw["n_levels"], n_tries=kw["n_tries"]),
            T=np.array(track.T), aff=np.array(track.aff), res=np.array(track.residuals),
            ok=bool(track.ok), used_ladder=bool(out[3]), imm_out=fields(out[1]),
        ))
        return out

    fs = JFullSystem(jmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=5), SET)
    snaps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jba, "optimize_fused", ba_rec)
        mp.setattr(jfstep, "frame_step_full", step_rec)
        for i, (left, right) in enumerate(frames):
            if i in (SNAP_AT, SNAP_AT + 1):
                snaps[i] = fs_snapshot(fs)
            fs.add_frame(left, right, i)
    return dict(K=K, poses=poses, frames=frames, fs=fs, snaps=snaps, calls=calls)


def test_full_system_matches_jax(jax_run):
    K, poses, frames = jax_run["K"], jax_run["poses"], jax_run["frames"]
    jfs = jax_run["fs"]
    tfs = TFullSystem(_tcalib(K), _tset(), device="cpu", uniform=jax_uniform)
    for i, (left, right) in enumerate(frames):
        tfs.add_frame(left, right, i)
    assert not tfs.is_lost and not jfs.is_lost
    assert [s.id for s in tfs.kf_shells] == [s.id for s in jfs.kf_shells]
    jt, tt = jfs.trajectory(), tfs.trajectory()
    dt = [np.linalg.norm(a[:3, 3] - b[:3, 3]) for a, b in zip(jt, tt)]
    # f32 on both sides, but the frames chain: each frame's tracking and
    # BA start from the last, so ~1e-7 op-level differences grow to ~1e-4 m
    # over 12 frames (the scene is ~5 m away); 1e-3 m is 1% of a frame step.
    assert max(dt) <= 1e-3, dt
    ate_j, ate_t = jtraj.ate_rmse(jt, poses), jtraj.ate_rmse(tt, poses)
    assert abs(ate_j - ate_t) <= 5e-4, (ate_j, ate_t)
    assert ate_t < 0.03  # test_full_system's own bound on this scene


def test_optimize_fused_matches_jax(jax_run):
    calls = jax_run["calls"]["ba"]
    assert len(calls) >= 2
    for c in calls:
        win = bridge.window_from_numpy(c["win"], device="cpu")
        out, energy, nres = tba.optimize_fused(win, t(c["dI"]), settings=_tset(), max_its=c["max_its"])
        assert int(nres) == c["nres"]
        # energy: a sum of ~1e4 f32 Huber terms in another order
        assert abs(float(energy) - c["energy"]) <= 1e-4 * abs(c["energy"])
        want = bridge.window_from_numpy(c["out_win"], device="cpu")
        np.testing.assert_allclose(n(out.w2c()), n(want.w2c()), atol=1e-5, rtol=0)
        np.testing.assert_allclose(n(out.pt_idepth), n(want.pt_idepth), rtol=1e-4, atol=1e-6)


def test_frame_step_full_matches_jax(jax_run):
    calls = jax_run["calls"]["step"]
    assert len(calls) >= 4
    for c in calls:
        win = bridge.window_from_numpy(c["win"], device="cpu")
        imm = bridge.immature_from_numpy(c["imm"], device="cpu")
        ref = tuple(tuple(t(x) for x in lvl) for lvl in c["ref"])
        pyrs, imm_out, track, used = tfstep.frame_step_full(
            t(c["left"]), t(c["right"]), ref, win, imm, t(c["c"]), torch.tensor(c["b"]),
            c["ref_slot"], t(c["tries"]), t(c["aff0"]), t(c["ref_aff"]),
            torch.tensor(c["ref_exp"]), torch.tensor(c["new_exp"]), torch.tensor(c["last0"]),
            settings=_tset(), **c["kw"],
        )
        dT = np.abs(n(track.T) - c["T"]).max()
        rel = np.abs(n(track.residuals) - c["res"]) / np.abs(c["res"])
        st_eq = (n(imm_out.status) == c["imm_out"]["status"]).mean()
        assert used == c["used_ladder"] and bool(track.ok) == c["ok"]
        assert dT <= 1e-5, dT
        # The split ladder runs all hypotheses over the coarse levels and
        # picks the best level-kf residual; the hypotheses land in one basin
        # within ~1e-6 of each other, so f32 noise can pick another winner.
        # Its residual at the selection level and below (the levels only the
        # winner descends) still agrees to 1e-4; above, each level's residual
        # is that of whichever hypothesis won (they differ by up to 5e-4).
        kf_ = SET.ladder_fine_levels
        assert rel[: kf_ + 1].max() <= 1e-4, rel
        assert rel.max() <= 1e-3, rel
        # the speculative depth refinement at the selected pose (the trace
        # module's status target)
        assert st_eq >= 0.999, st_eq


def test_keyframe_branch_from_snapshot_matches_jax(jax_run):
    """Frame SNAP_AT is a keyframe: starting from the JAX system's state just
    before it, the port's whole KF branch (temporal trace, flagging,
    activation, BA, final linearization, tracking reference, new traces)
    lands where the JAX system did."""
    K, frames = jax_run["K"], jax_run["frames"]
    before, after = jax_run["snaps"][SNAP_AT], jax_run["snaps"][SNAP_AT + 1]
    tfs = bridge.full_system_from_snapshot(before, _tcalib(K), _tset(), device="cpu",
                                           uniform=jax_uniform)
    tfs.add_frame(*frames[SNAP_AT], SNAP_AT)
    assert tfs.kf_slots == after["kf_slots"]
    assert [s.id for s in tfs.kf_shells] == [h["id"] for h in after["history"] if h["is_kf"]]
    want = bridge.window_from_numpy(after["win"], device="cpu")
    # point activation and outlier removal are threshold decisions on f32
    # values: the trace module's 99.9 % status target
    assert (n(tfs.win.pt_status) == n(want.pt_status)).mean() >= 0.999
    assert (n(tfs.imm.valid) == after["imm"]["valid"]).mean() >= 0.999
    assert (n(tfs.imm.status) == after["imm"]["status"]).mean() >= 0.999
    # keyframe poses after BA: the optimize_fused target
    np.testing.assert_allclose(n(tfs.win.w2c()), n(want.w2c()), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tfs.history[-1].T_cam_to_ref, after["history"][-1]["T_cam_to_ref"],
                               atol=1e-5, rtol=0)


def test_point_cloud_matches_jax(jax_run):
    """`FullSystem.point_cloud` (what the CLI's feed and viewer read at each
    new keyframe) on the JAX run's final window, handed over through the
    bridge, against the JAX FullSystem's own."""
    K, jfs = jax_run["K"], jax_run["fs"]
    tfs = bridge.full_system_from_snapshot(fs_snapshot(jfs), _tcalib(K), _tset(), device="cpu")
    got, want = tfs.point_cloud(), jfs.point_cloud()
    assert len(want["xyz"]) > 100
    np.testing.assert_array_equal(got["host_kf_id"], want["host_kf_id"])
    # the same f64 arithmetic on f32 window values: far below 1e-4 m
    np.testing.assert_allclose(got["xyz"], want["xyz"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["idepth"], want["idepth"], rtol=1e-6, atol=0)
