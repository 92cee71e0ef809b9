"""The port's `runtime/checkpoint.py` and `runtime/diagnostics.py`, and the
`log_stream` records of its FullSystem, on the 256x128 sequence of
test_checkpoint.py (seed 4, save at frame 6 of 10).

Port against port, tolerance 0: `load(save(fs))` holds the same window,
immature set, pyramids, tracking reference and host fields, and goes on to
the same trajectory and window bit for bit, also when the checkpoint is taken
before the first keyframe exists. Against the JAX package: the npz its `save`
writes for a system carrying the port's state (no JAX frame is run for it)
has the array names of the port's `save` and reads back into the same
leaves; its `eigenvalue_record` on the port's final window gives the same
keys and lengths, each list of eigenvalues within 4e-6 of its own largest,
`H_diag` within rtol 1e-5, and H itself entry by entry within f32 rounding
(test_eigenvalue_record_matches_jax states each tolerance)."""

import dataclasses
import io
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n
from test_full_system import BASE, H_, SET, W_, _sequence

from stereo_dso_g2o_tpu.backend import ba as jba
from stereo_dso_g2o_tpu.backend import window as JW
from stereo_dso_g2o_tpu.frontend import immature as JIMM
from stereo_dso_g2o_tpu.frontend.full_system import FullSystem as JFullSystem
from stereo_dso_g2o_tpu.models.camera import make_calib as jmake_calib
from stereo_dso_g2o_tpu.runtime import checkpoint as jcheckpoint
from stereo_dso_g2o_tpu.runtime import diagnostics as jdiag
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.backend import ba as tba
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.runtime import checkpoint, diagnostics

N_FRAMES, SAVE_AT, N_LVL = 10, 6, 5
TSET = dataclasses.replace(bridge.settings_from_fields(dataclasses.asdict(SET)),
                           log_eigenvalues=True)


def _calib(K):
    return make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=N_LVL,
                      device="cpu")


def _drive(fs, frames, lo, hi):
    for i in range(lo, hi):
        fs.add_frame(frames[i][0], frames[i][1], i, timestamp=0.1 * i)
    return fs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Run A uninterrupted with a log stream, saved at SAVE_AT; `at_save` is
    the system `load` gives back; run B goes on from another `load`."""
    K, _, frames = _sequence(N_FRAMES, seed=4)
    path = str(tmp_path_factory.mktemp("ckpt") / "state")
    fs_a = FullSystem(_calib(K), TSET, device="cpu")
    fs_a.log_stream = io.StringIO()
    _drive(fs_a, frames, 0, SAVE_AT)
    checkpoint.save(fs_a, path)
    saved = dict(win=fs_a.win, imm=fs_a.imm, n_history=len(fs_a.history),
                 kf_ids=[s.id for s in fs_a.kf_shells], kf_slots=list(fs_a.kf_slots),
                 next_kf_id=fs_a.next_kf_id, calls=fs_a.selector._calls,
                 pot=fs_a.selector.current_potential, dI_slots=list(fs_a.dI_slots),
                 right_slots=list(fs_a.right_slots), ref=list(fs_a.tracker.ref),
                 kf_out_count=fs_a.kf_out_count.copy(), traj=fs_a.trajectory())
    at_save = checkpoint.load(path, _calib(K), device="cpu")
    _drive(fs_a, frames, SAVE_AT, N_FRAMES)
    fs_b = _drive(checkpoint.load(path, _calib(K), device="cpu"), frames, SAVE_AT, N_FRAMES)
    return dict(K=K, frames=frames, path=path, fs_a=fs_a, fs_b=fs_b, saved=saved, at_save=at_save)


def _assert_fields_equal(got, want, what):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}.{f.name}"
        same = (a == b) | ((a != a) & (b != b))
        assert bool(same.all()), f"{what}.{f.name}"


def test_save_load_state_exact(run):
    """The counterpart of test_checkpoint_save_load_state_exact, over every
    tensor and host field a resumed run reads."""
    fs, want = run["at_save"], run["saved"]
    _assert_fields_equal(fs.win, want["win"], "win")
    _assert_fields_equal(fs.imm, want["imm"], "imm")
    assert len(fs.history) == want["n_history"] == SAVE_AT
    assert [s.id for s in fs.kf_shells] == want["kf_ids"] and len(want["kf_ids"]) >= 2
    # keyframe shells are the history's own objects, as in the running system
    assert all(any(k is h for h in fs.history) for k in fs.kf_shells)
    assert fs.kf_slots == want["kf_slots"] and fs.next_kf_id == want["next_kf_id"]
    assert fs.selector._calls == want["calls"] > 0
    assert fs.selector.current_potential == want["pot"]
    np.testing.assert_array_equal(fs.kf_out_count, want["kf_out_count"])
    for slot, (pyr, right) in enumerate(zip(want["dI_slots"], want["right_slots"])):
        assert (fs.dI_slots[slot] is None) == (pyr is None)
        if pyr is not None:
            assert all(torch.equal(a, b) for a, b in zip(fs.dI_slots[slot], pyr))
            assert torch.equal(fs.right_slots[slot], right)
    assert len(fs.tracker.ref) == len(want["ref"]) == N_LVL
    for got, ref in zip(fs.tracker.ref, want["ref"]):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    np.testing.assert_array_equal(np.stack(fs.trajectory()), np.stack(want["traj"]))
    assert fs.device == torch.device("cpu") and fs.win.device == torch.device("cpu")


def test_resume_is_exact(run):
    """The counterpart of test_checkpoint_resume_exact, bit for bit."""
    fs_a, fs_b = run["fs_a"], run["fs_b"]
    ta, tb = fs_a.trajectory(), fs_b.trajectory()
    assert len(ta) == len(tb) == N_FRAMES and not fs_a.is_lost
    np.testing.assert_array_equal(np.stack(ta), np.stack(tb))
    _assert_fields_equal(fs_b.win, fs_a.win, "win")
    _assert_fields_equal(fs_b.imm, fs_a.imm, "imm")
    assert [s.id for s in fs_b.kf_shells] == [s.id for s in fs_a.kf_shells]
    assert len(fs_a.kf_shells) > len(run["saved"]["kf_ids"])  # a keyframe after the resume
    assert fs_b.selector._calls == fs_a.selector._calls


def test_resume_before_the_first_keyframe(run, tmp_path):
    """Frame 0 waits in `first_pair` until frame 1 makes the first keyframe
    from it: a checkpoint taken in between carries its pyramids."""
    K, frames = run["K"], run["frames"]
    fs = _drive(FullSystem(_calib(K), TSET, device="cpu"), frames, 0, 1)
    assert fs.first_pair is not None and not fs.kf_slots
    checkpoint.save(fs, str(tmp_path / "first"))
    got = _drive(checkpoint.load(str(tmp_path / "first"), _calib(K), device="cpu"), frames, 1, 3)
    want = _drive(FullSystem(_calib(K), TSET, device="cpu"), frames, 0, 3)
    np.testing.assert_array_equal(np.stack(got.trajectory()), np.stack(want.trajectory()))
    _assert_fields_equal(got.win, want.win, "win")
    assert len(got.kf_shells) == len(want.kf_shells) >= 1


def test_reads_the_arrays_the_jax_save_writes(run, tmp_path):
    """A JAX FullSystem is given the port's state at the save point (arrays
    only; it runs no frame) and saved by the JAX module: same array names as
    the port's npz, the port's meta holds every key of the JAX meta, and
    `read_arrays` puts the JAX file back into the same leaves."""
    K, want = run["K"], run["saved"]
    jfs = JFullSystem(jmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_,
                                  n_levels=N_LVL), SET)

    def jfields(cls, obj):
        return cls(**{f.name: jnp.asarray(n(getattr(obj, f.name))) for f in dataclasses.fields(cls)})

    jfs.win = jfields(JW.Window, want["win"])
    jfs.imm = jfields(JIMM.ImmatureSet, want["imm"])
    jfs.dI_slots = [None if p is None else tuple(jnp.asarray(n(x)) for x in p)
                    for p in want["dI_slots"]]
    jfs.right_slots = [None if r is None else jnp.asarray(n(r)) for r in want["right_slots"]]
    jfs.tracker.ref = [tuple(jnp.asarray(n(x)) for x in lvl) for lvl in want["ref"]]
    jfs.tracker.ref_aff = jnp.zeros(2, jnp.float32)
    jcheckpoint.save(jfs, str(tmp_path / "jax"))

    jdata, tdata = np.load(str(tmp_path / "jax.npz")), np.load(run["path"] + ".npz")
    assert set(jdata.files) == set(tdata.files)
    with open(str(tmp_path / "jax.meta"), "rb") as f:
        jmeta = pickle.load(f)
    with open(run["path"] + ".meta", "rb") as f:
        tmeta = pickle.load(f)
    assert set(jmeta) <= set(tmeta) and set(jmeta["tracker"]) == set(tmeta["tracker"])

    fs = FullSystem(_calib(K), TSET, device="cpu")
    checkpoint.read_arrays(fs, jdata, jmeta["tracker"]["n_ref_levels"],
                           lambda a: torch.as_tensor(np.array(a)))
    _assert_fields_equal(fs.win, want["win"], "win")
    _assert_fields_equal(fs.imm, want["imm"], "imm")
    for slot, pyr in enumerate(want["dI_slots"]):
        if pyr is not None:
            assert all(torch.equal(a, b) for a, b in zip(fs.dI_slots[slot], pyr))
            assert torch.equal(fs.right_slots[slot], want["right_slots"][slot])
    for got, ref in zip(fs.tracker.ref, want["ref"]):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


EPS32 = 2.0 ** -23


def _jax_hessian_terms(jwin):
    """The three terms of the JAX `_hessian_parts`' H, built from the JAX
    `ba` in float64, and the sum of their magnitudes (the scale of an f32
    rounding error in each entry)."""
    AH, AT = jba.adjoints(jwin)
    active = jwin.res_exists & (jwin.res_state == JW.RES_IN)
    accA = jba.accumulate_top(jwin, AH, AT, active & ~jwin.res_linearized, 0, SET, use_prior=True)
    sc = jba.accumulate_sc(jwin, AH, AT, active, accA, jba.point_prior(jwin, SET), True)
    top, hm, schur = (np.asarray(x, np.float64) for x in (accA.H, jwin.HM, sc.H))
    return top + hm - schur, np.abs(top) + np.abs(hm) + np.abs(schur)


@pytest.mark.parametrize("marginal_prior", [False, True], ids=["as_run", "with_marginal_prior"])
def test_eigenvalue_record_matches_jax(run, marginal_prior):
    """Every entry is held at the scale of its own block, since the blocks
    lie decades apart (a/b priors 1e12-1e14, first-frame pose priors
    1e10-1e11, the data's pose block 1e4-1e10):
    - H itself, entry by entry, within 256 f32 roundings of the magnitudes
      summed into that entry (measured: 39), so a dropped Schur complement or
      marginal prior (at least 1e-2 of an entry) cannot pass;
    - each eigenvalue list within 4e-6 of its own largest (measured: 6e-7;
      f32 `eigvalsh` is backward stable to a few roundings of the norm);
    - `H_diag` rtol 1e-5, plus 8 roundings of the magnitudes summed into the
      entry where the Schur complement cancels most of it;
    - nullspace responses within 16 f32 roundings of |H| |n| / |n| per
      column (measured: 2.7).
    The window of the run has no marginal prior yet (HM = 0), so the second
    case gives both sides a random positive semidefinite HM of the size a
    marginalized frame leaves (1e7-1e8 on the diagonal)."""
    win = run["fs_a"].win
    D = 4 + 8 * win.F
    if marginal_prior:
        assert not bool(win.HM.any())
        valid = np.concatenate([np.ones(4), np.repeat(n(win.frame_valid).astype(np.float64), 8)])
        A = np.random.default_rng(0).normal(size=(D, D)) * valid[None] * 1e3
        win = win.replace(HM=torch.from_numpy((A.T @ A).astype(np.float32)))
    got = diagnostics.eigenvalue_record(win, settings=TSET)
    jwin = JW.Window(**{f.name: jnp.asarray(n(getattr(win, f.name)))
                        for f in dataclasses.fields(JW.Window)})
    want = jdiag.eigenvalue_record(jwin, settings=SET)
    assert list(got) == list(want) and got["type"] == want["type"] == "eig"

    JH, mag = _jax_hessian_terms(jwin)
    TH = diagnostics.hessian(win, TSET).double().numpy()
    assert (np.abs(TH - JH) <= 256 * EPS32 * mag).all(), float((np.abs(TH - JH) - 256 * EPS32 * mag).max())

    for key, length in (("ev_H", D), ("ev_H_pose", 6 * win.F), ("ev_H_ab", 2 * win.F)):
        assert len(got[key]) == len(want[key]) == length
        assert want[key][0] > 0 and np.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=4e-6 * want[key][0], err_msg=key)
        assert got[key] == sorted(got[key], reverse=True)
    # the blocks really lie apart, so each tolerance above holds its own
    assert want["ev_H_pose"][0] < 1e-2 * want["ev_H_ab"][0]

    assert len(got["H_diag"]) == len(want["H_diag"]) == D
    tol = 1e-5 * np.abs(want["H_diag"]) + 8 * EPS32 * np.diag(mag)
    assert (np.abs(np.subtract(got["H_diag"], want["H_diag"])) <= tol).all()

    assert len(got["nullspace_response"]) == len(want["nullspace_response"]) == 7
    N = np.asarray(jba.nullspaces(jwin), np.float64)
    tol = 16 * EPS32 * np.linalg.norm(mag @ np.abs(N), axis=0) / np.linalg.norm(N, axis=0)
    assert (np.abs(np.subtract(got["nullspace_response"], want["nullspace_response"])) <= tol).all()

    if not marginal_prior:
        # The gauge: what the record shows in the six pose directions is the
        # first frame's pose prior alone. Without the priors the data's H
        # answers them 1e-5 weaker than the largest eigenvalue of its own
        # pose block (measured: 2e-7).
        data = TH - tba.accumulate_priors(win, TSET).H.double().numpy()
        TN = tba.nullspaces(win).double().numpy()
        resp = np.linalg.norm(data @ TN, axis=0) / np.linalg.norm(TN, axis=0)
        pose_idx = 4 + np.arange(8 * win.F).reshape(win.F, 8)[:, :6].reshape(-1)
        pose_top = np.linalg.eigvalsh(data[np.ix_(pose_idx, pose_idx)])[-1]
        assert pose_top > 0 and resp[:6].max() < 1e-5 * pose_top, (resp, pose_top)
        assert max(got["nullspace_response"]) < got["ev_H_pose"][0]
    json.dumps(got)


def test_log_stream_one_record_per_keyframe(run):
    """With `log_eigenvalues` every keyframe the pipeline makes (all but the
    first, which frame 0 becomes without BA) writes one "eig" and one "kf"
    record; without a stream nothing is written and nothing changes (run B
    had none and equals run A)."""
    fs = run["fs_a"]
    recs = [json.loads(line) for line in fs.log_stream.getvalue().splitlines()]
    eigs = [r for r in recs if r["type"] == "eig"]
    kfs = [r for r in recs if r["type"] == "kf"]
    made = list(range(1, len(fs.kf_shells)))
    assert len(made) >= 2
    assert [r["kf_id"] for r in eigs] == made == [r["kf_id"] for r in kfs]
    assert [r["frame_id"] for r in kfs] == [s.id for s in fs.kf_shells[1:]]
    D = 4 + 8 * fs.win.F
    for r in eigs:
        assert len(r["ev_H"]) == len(r["H_diag"]) == D and len(r["nullspace_response"]) == 7
        # the gauge directions are held by the first frame's pose prior (or
        # by the marginal prior that absorbed it), never stronger than the
        # pose block's largest eigenvalue, decades under the a/b priors
        assert 0 < r["ev_H_pose"][0] < 1e-2 * r["ev_H"][0]
        assert max(r["nullspace_response"]) < r["ev_H_pose"][0]
    for r in kfs:
        assert r["n_res"] > 0 and np.isfinite(r["energy"]) and r["n_points"] > 0
    assert run["fs_b"].log_stream is None
