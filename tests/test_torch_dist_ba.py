"""The port's sharded windowed BA (`parallel/dist_ba.py`, the `reduce=` hooks
of `backend/ba.py`, `FullSystem._dist_ba`) over 2 and 4 `gloo` ranks on the
CPU, against the port's single-process BA and the JAX package's
`sharded_ba_step` over a virtual device mesh.

The window is test_ba.py's (`_build_window`, seeds 6 and 8), built once by
the JAX package, handed to every rank as numpy through a file; results come
back through files (`tests/_torch_dist_workers.py`). Tolerances are those of
tests/test_dist_ba.py: `nres` equal; energy rtol 1e-4 at iteration 0, 5e-3
after (the all-reduce sums in another order and the difference compounds
through the GN steps); state atol 5e-4, idepth atol 2e-3, `c_value` rtol
1e-4. Every spawn has a time limit, so a hung collective fails."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_workers import ba_fused, ba_steps, full_system_dist, run_ranks
from _torch_parity import fields, n, t
from test_ba import _build_window

from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu.parallel import dist_ba as jdist
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.backend import ba as tba
from stereo_dso_g2o_tpu_torch.parallel import dist_ba as tdist

JSET = jdefault_settings()
TSET = bridge.settings_from_fields(dataclasses.asdict(JSET))
N_ITS = 3
CASES = {2: dict(seed=8, n_pts=64), 4: dict(seed=6, n_pts=128, pose_noise=2e-3,
                                            idepth_noise=0.04)}


@pytest.fixture(scope="module", params=[2, 4])
def sharded_run(request, tmp_path_factory):
    """One window, three ways: `world` gloo ranks of the port, the port in
    one process, the JAX package over a `world`-device mesh."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"dist_ba_{world}")
    jwin, jdI, *_ = _build_window(**CASES[world])
    jdI = jdI.astype(jnp.float32)
    arrays = fields(jwin)
    np.savez(tmp / "window.npz", dI_stack=np.array(jdI),
             **{f"win.{k}": v for k, v in arrays.items()})
    run_ranks(ba_steps, world, tmp, TSET, N_ITS)

    twin, tdI = bridge.window_from_numpy(arrays, device="cpu"), t(jdI)
    single = []
    for it in range(N_ITS):
        twin, e, conv, nres = tba.ba_iteration(twin, tdI, it, settings=TSET)
        single.append((float(e), float(conv), float(nres)))

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), (jdist.AXIS,))
    jstep = jdist.sharded_ba_step(mesh, jwin, JSET)
    jsh = jdist.shard_window(mesh, jwin)
    jscal = []
    for it in range(N_ITS):
        jsh, e, conv, nres = jstep(jsh, jdI, jnp.asarray(it))
        jscal.append((float(e), float(conv), float(nres)))
    return dict(world=world, tmp=tmp, single_win=twin, single=np.asarray(single),
                jax_win=jsh, jax=np.asarray(jscal), np_cap=arrays["pt_u"].shape[0])


def _result_window(tmp):
    data = np.load(tmp / "result.npz")
    return bridge.window_from_numpy({k[4:]: data[k] for k in data.files if k.startswith("win.")},
                                    device="cpu")


def test_shard_gather_round_trip_and_ranks_agree(sharded_run):
    world, tmp = sharded_run["world"], sharded_run["tmp"]
    ranks = [np.load(tmp / f"scalars_rank{r}.npz") for r in range(world)]
    for r in ranks:
        assert bool(r["round_trip"])
        assert int(r["shard_np"]) * world == sharded_run["np_cap"]
        # energy, convergence flag and nres are the whole window's on every rank
        np.testing.assert_array_equal(r["scal"], ranks[0]["scal"])


@pytest.mark.parametrize("against", ["single_process", "jax_sharded"])
def test_sharded_ba_matches(sharded_run, against):
    tmp = sharded_run["tmp"]
    got = np.load(tmp / "scalars_rank0.npz")["scal"]
    want = sharded_run["single" if against == "single_process" else "jax"]
    gwin = _result_window(tmp)
    if against == "single_process":
        wwin = sharded_run["single_win"]
    else:
        wwin = bridge.window_from_numpy(fields(sharded_run["jax_win"]), device="cpu")
    for it in range(N_ITS):
        assert int(got[it, 2]) == int(want[it, 2]) and int(got[it, 2]) > 0
        np.testing.assert_allclose(got[it, 0], want[it, 0], rtol=1e-4 if it == 0 else 5e-3)
    np.testing.assert_allclose(n(gwin.state), n(wwin.state), atol=5e-4)
    np.testing.assert_allclose(n(gwin.pt_idepth), n(wwin.pt_idepth), atol=2e-3)
    np.testing.assert_allclose(n(gwin.c_value), n(wwin.c_value), rtol=1e-4)
    np.testing.assert_array_equal(n(gwin.res_state), n(wwin.res_state))


def test_sharded_optimize_fused_matches_single_process(tmp_path):
    """The whole GN loop over 2 ranks stops at the same iteration as
    `ba.optimize_fused` (same nres, energy and state within the step
    tolerances)."""
    jwin, jdI, *_ = _build_window(seed=8, n_pts=64, pose_noise=2e-3, idepth_noise=0.03)
    jdI = jdI.astype(jnp.float32)
    arrays = fields(jwin)
    np.savez(tmp_path / "window.npz", dI_stack=np.array(jdI),
             **{f"win.{k}": v for k, v in arrays.items()})
    run_ranks(ba_fused, 2, tmp_path, TSET, 6)
    data = np.load(tmp_path / "result.npz")
    win, energy, nres = tba.optimize_fused(bridge.window_from_numpy(arrays, device="cpu"), t(jdI),
                                           settings=TSET, max_its=6)
    gwin = _result_window(tmp_path)
    assert int(data["nres"]) == int(nres)
    np.testing.assert_allclose(float(data["energy"]), float(energy), rtol=5e-3)
    np.testing.assert_allclose(n(gwin.state), n(win.state), atol=5e-4)
    np.testing.assert_allclose(n(gwin.pt_idepth), n(win.pt_idepth), atol=2e-3)


def test_shard_window_blocks():
    """shard_window takes contiguous blocks of the point fields and leaves
    the rest whole; the blocks of all ranks tile the window."""
    jwin, *_ = _build_window(seed=8, n_pts=64)
    win = bridge.window_from_numpy(fields(jwin), device="cpu")
    shards = [tdist.shard_window(win, r, 4) for r in range(4)]
    for f in dataclasses.fields(win):
        whole = getattr(win, f.name)
        if f.name in tdist._POINT_FIELDS:
            assert torch.equal(torch.cat([getattr(s, f.name) for s in shards]), whole), f.name
        else:
            assert all(getattr(s, f.name) is whole for s in shards), f.name
    assert tdist._POINT_FIELDS == jdist._POINT_FIELDS
    with pytest.raises(ValueError):
        tdist.shard_window(win, 0, 3)


def test_reduce_none_and_identity_leave_ba_unchanged():
    """`reduce=None` is the path every other BA test runs; a `reduce` that
    returns its argument (one shard holding everything) gives the same bits."""
    jwin, jdI, *_ = _build_window(seed=6, n_pts=128, pose_noise=2e-3, idepth_noise=0.04)
    win, dI = bridge.window_from_numpy(fields(jwin), device="cpu"), t(jdI.astype(jnp.float32))
    calls = []

    def identity(x):
        calls.append(tuple(x.shape))
        return x

    a = tba.ba_iteration(win, dI, 0, settings=TSET)
    b = tba.ba_iteration(win, dI, 0, settings=TSET, reduce=identity)
    for f in dataclasses.fields(win):
        assert torch.equal(getattr(a[0], f.name), getattr(b[0], f.name)), f.name
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    D = 4 + 8 * win.F
    # H, b of the top part; nres; H, b of the Schur part; energy; n_pt, sum_id
    assert calls == [(D, D), (D,), (), (D, D), (D,), (), (), ()]


def test_full_system_dist_ba_needs_a_group():
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib

    s = dataclasses.replace(TSET, dist_ba_shards=2, immature_cap=256, active_cap=512)
    fs = FullSystem(make_calib(100.0, 100.0, 64.0, 32.0, 0.1, 128, 64, n_levels=3, device="cpu"),
                    s, device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        fs._dist_ba(None, 6)


def test_full_system_runs_with_dist_ba_two_ranks(tmp_path):
    """`Settings.dist_ba_shards = 2`: two ranks run the same FullSystem over
    five frames with the keyframe BA split between them. Both ranks end with
    the same trajectory bit for bit (every rank steps the replicated state
    from the same reduced system), and it stays within 1e-3 m of the
    single-process run."""
    from test_full_system import BASE, H_, W_, _sequence

    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib

    n_frames = 5
    K, _, frames = _sequence(n_frames, seed=4)
    calib_args = (K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, 5)
    s = dataclasses.replace(TSET, desired_point_density=600.0, desired_immature_density=450.0,
                            immature_cap=512, active_cap=1024)
    np.savez(tmp_path / "frames.npz", lefts=np.stack([f[0] for f in frames]),
             rights=np.stack([f[1] for f in frames]))
    run_ranks(full_system_dist, 2, tmp_path, dataclasses.replace(s, dist_ba_shards=2),
              calib_args, n_frames)
    r0, r1 = (np.load(tmp_path / f"fs_rank{r}.npz") for r in range(2))
    np.testing.assert_array_equal(r0["traj"], r1["traj"])
    np.testing.assert_array_equal(r0["pt_idepth"], r1["pt_idepth"])
    fs = FullSystem(make_calib(*calib_args, device="cpu"), s, device="cpu")
    for i in range(n_frames):
        fs.add_frame(frames[i][0], frames[i][1], i, timestamp=0.1 * i)
    assert int(r0["n_kf"]) == len(fs.kf_shells) >= 2 and not bool(r0["lost"])
    want = np.stack(fs.trajectory())
    assert np.abs(r0["traj"][:, :3, 3] - want[:, :3, 3]).max() <= 1e-3


ENLARGED = dict(F=16, n_pts=1024)  # tests/test_dist_ba.py's window, 64 points a frame instead of 512


def test_enlarged_window_two_ranks(tmp_path):
    """The enlarged window of tests/test_dist_ba.py:109-127 (F = 16
    keyframes, points hosted in every frame, all-pairs residuals), cut from
    8192 points to 1024: the port's `add_residuals_all_pairs` rebuilds the
    JAX window's residual cube bit for bit, and 2 gloo ranks step it as the
    single-process BA and the JAX `ba_iteration` do, at this file's
    tolerances."""
    from test_dist_ba import _build_enlarged_window

    from stereo_dso_g2o_tpu.backend import ba as jba
    from stereo_dso_g2o_tpu_torch.backend import builder as tbuilder

    jwin, jdI = _build_enlarged_window(**ENLARGED)
    jdI = jdI.astype(jnp.float32)
    arrays = fields(jwin)
    twin = bridge.window_from_numpy(arrays, device="cpu")
    rebuilt = tbuilder.add_residuals_all_pairs(twin.replace(
        res_exists=torch.zeros_like(twin.res_exists), res_linearized=torch.ones_like(twin.res_linearized)))
    for f in ("res_exists", "res_state", "res_linearized"):
        assert torch.equal(getattr(rebuilt, f), getattr(twin, f)), f
    assert int(n(twin.res_exists).sum()) == ENLARGED["n_pts"] * (ENLARGED["F"] - 1)
    np.savez(tmp_path / "window.npz", dI_stack=np.array(jdI),
             **{f"win.{k}": v for k, v in arrays.items()})
    run_ranks(ba_steps, 2, tmp_path, TSET, N_ITS)
    got = np.load(tmp_path / "scalars_rank0.npz")["scal"]
    gwin = _result_window(tmp_path)
    jw = jwin
    for it in range(N_ITS):
        twin, e, _, nres = tba.ba_iteration(twin, t(jdI), it, settings=TSET)
        jw, je, _, jn = jba.ba_iteration(jw, jdI, jnp.asarray(it), settings=JSET)
        assert int(got[it, 2]) == int(nres) == int(jn) > 0
        for want in (float(e), float(je)):
            np.testing.assert_allclose(got[it, 0], want, rtol=1e-4 if it == 0 else 5e-3)
    for wwin in (twin, bridge.window_from_numpy(fields(jw), device="cpu")):
        np.testing.assert_allclose(n(gwin.state), n(wwin.state), atol=5e-4)
        np.testing.assert_allclose(n(gwin.pt_idepth), n(wwin.pt_idepth), atol=2e-3)
        np.testing.assert_allclose(n(gwin.c_value), n(wwin.c_value), rtol=1e-4)
