"""The keyframe pipeline over a leading sequence axis (`_kf_branch` under
`frame_kf_subset_batched` and "fused" `frame_auto_batched`), its modules
over that axis, and the slab route of the batched path.

Three sequences at test_graph_system.py's 256x128 (seeds 0, 5 and 3, 7
frames of JAX FullSystem bootstrap, `kf_global_weight=3.0`, as
test_torch_batched_track.py), frozen by the JAX package and bridged to the
port. Port against port, tolerance 0 (NaN equal to NaN): the keyframe
subset over [0], [1], [0, 2] and [0, 1, 2] equals `frame_kf` on each
sequence alone in every leaf of states and bundles; BA over three windows
that stop at different iterations equals each window alone, the early one
frozen, one host read an iteration; flagged-frame marginalization with
other flags per sequence, and pixel selection with another potential and
salt per sequence, each equal the sequence alone; "fused" equals
`frame_auto` per sequence, its non-keyframe sequences `frame_track`, with
no host read of `need_kf`; with the slab route forced, the batched track
equals the one-sequence track and the batched plain K2 one call per
sequence. Port against the JAX package's `frame_kf_subset_batched` (vmap,
CPU, jax x64 on as in test_torch_batched.py) over the sequences that decide
a keyframe, padded as its runner pads them: every window pose within 5e-5
(test_torch_batched.py's bound after a keyframe), the inserted slot, frame
ids, valid frames and flagged frames equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import graph_state_snapshot, jax_graph_uniform, n
from _torch_trace_lanes import edge_lanes
from test_graph_system import BASE, H_, SET, W_, _frames

from stereo_dso_g2o_tpu.frontend.full_system import FullSystem as JFullSystem
from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem as JGraphSystem
from stereo_dso_g2o_tpu.models.camera import make_calib as jmake_calib
from stereo_dso_g2o_tpu.parallel import batched as jbatched
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.backend import ba
from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
from stereo_dso_g2o_tpu_torch.frontend.coarse_tracker import level_caps
from stereo_dso_g2o_tpu_torch.models.camera import make_calib as tmake_calib
from stereo_dso_g2o_tpu_torch.ops import selector as SEL
from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.parallel import batched as tb
from stereo_dso_g2o_tpu_torch.utils import host

N_BOOT, N_LVL = 7, 5
SEEDS = (0, 5, 3)
SET_KF = dataclasses.replace(SET, kf_global_weight=3.0)
W2C_TOL = 5e-5


def _settings():
    return bridge.settings_from_fields(dataclasses.asdict(SET_KF))


def _common():
    return dict(settings=_settings(), n_levels=N_LVL, w0=W_, h0=H_)


@pytest.fixture(scope="module")
def jax_run():
    """The three sequences bootstrapped and frozen by the JAX package, its
    batched track program over frame N_BOOT and its keyframe subset over
    the sequences that take a keyframe there, x64 on as in
    test_torch_batched.py, whose bound this is (x64 off, the JAX package's
    float32 keyframe of sequence 0 lies 2.4e-4 off the port's in `w2c`)."""
    with jax.enable_x64(True):
        seqs = [_frames(N_BOOT + 1, seed=s) for s in SEEDS]
        K = seqs[0][0]
        frames = [s[2] for s in seqs]
        calib = jmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=N_LVL)
        systems = []
        for fr in frames:
            fs = JFullSystem(calib, SET_KF)
            for i in range(N_BOOT):
                fs.add_frame(fr[i][0], fr[i][1], i, timestamp=0.1 * i)
            systems.append(JGraphSystem.from_full_system(fs))
        runner = jbatched.BatchedRunner(systems, kf_mode="gated")
        snaps = [graph_state_snapshot(jax.tree.map(lambda x: x[k], runner.states))
                 for k in range(len(SEEDS))]
        lefts = jnp.stack([jnp.asarray(fr[N_BOOT][0], jnp.float32) for fr in frames])
        rights = jnp.stack([jnp.asarray(fr[N_BOOT][1], jnp.float32) for fr in frames])
        expos = jnp.ones(len(SEEDS), jnp.float32)
        kw = dict(settings=SET_KF, n_levels=N_LVL, w0=W_, h0=H_)
        _, bundles, aux = jbatched.frame_track_batched(
            runner.states, lefts, rights, runner.calib_cs, runner.baselines, expos, n_tries=5,
            **kw)
        # the sequences that take a keyframe, padded as
        # `BatchedRunner._dispatch_kf_subset` pads them
        need = np.nonzero(np.array(bundles.need_kf))[0]
        nb = next(b for b in (1, 2, len(SEEDS)) if b >= need.size)
        idx = np.full((nb,), need[0], np.int32)
        idx[: need.size] = need
        pots = [gs.pot for gs in systems]
        _, kf = jbatched.frame_kf_subset_batched(
            runner.states, aux, runner.calib_cs, runner.baselines, expos,
            jnp.asarray(pots, jnp.int32), jnp.asarray(idx), caps=systems[0].caps,
            imm_cap=SET_KF.immature_cap, nb=nb, **kw)
        kf = jax.device_get(kf)
    return dict(K=K, frames=frames, snaps=snaps, pots=pots, idx=idx,
                need_kf=np.array(bundles.need_kf),
                kf={f: np.array(getattr(kf, f))
                    for f in ("w2c", "slot", "frame_id", "frame_valid", "flagged")},
                calib_c=np.array(runner.calib_cs), baselines=np.array(runner.baselines))


def _states(jax_run):
    """Fresh port states (the keyframe pipeline writes its pyramid stack in
    place)."""
    return [bridge.graph_state_from_numpy(s, device="cpu") for s in jax_run["snaps"]]


def _inputs(jax_run, i=N_BOOT):
    frames = jax_run["frames"]
    lefts = torch.stack([torch.as_tensor(np.asarray(fr[i][0], np.float32)) for fr in frames])
    rights = torch.stack([torch.as_tensor(np.asarray(fr[i][1], np.float32)) for fr in frames])
    calib_cs = torch.as_tensor(jax_run["calib_c"], dtype=torch.float32)
    baselines = torch.as_tensor(jax_run["baselines"], dtype=torch.float32)
    return lefts, rights, calib_cs, baselines, torch.ones(len(SEEDS))


def _kf_kw(jax_run):
    K = jax_run["K"]
    calib = tmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=N_LVL,
                        device="cpu")
    return dict(caps=tuple(level_caps(calib)), imm_cap=SET_KF.immature_cap, **_common())


def _leaves(tree):
    out = []
    tb.tree_map(lambda x: out.append(x) or x, tree)
    return out


def _assert_trees_equal(got, want, what):
    """Bit for bit, NaN equal to NaN."""
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for j, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, j)
        same = (a == b) | ((a != a) & (b != b))
        assert bool(same.all()), f"{what}: leaf {j} differs in {int((~same).sum())} entries"


@pytest.fixture(scope="module")
def tracked(jax_run):
    """The port's batched track of frame N_BOOT from the JAX freeze: (aux,
    inputs)."""
    lefts, rights, calib_cs, baselines, expos = _inputs(jax_run)
    _, _, aux = tb.frame_track_batched(tb._tree_stack(_states(jax_run)), lefts, rights,
                                       calib_cs, baselines, expos, n_tries=5, **_common())
    return aux, (calib_cs, baselines, expos)


@pytest.fixture(scope="module")
def alone(jax_run, tracked):
    """`frame_kf` on each sequence alone."""
    aux, (calib_cs, baselines, expos) = tracked
    out = []
    for k, st in enumerate(_states(jax_run)):
        out.append(tgs.frame_kf(st, tb._tree_slice(aux, k), calib_cs[k], baselines[k], expos[k],
                                pot=jax_run["pots"][k], uniform=jax_graph_uniform,
                                **_kf_kw(jax_run)))
    return out


@pytest.mark.parametrize("idx", [[0], [1], [0, 2], [0, 1, 2]])
def test_kf_subset_is_frame_kf_per_sequence(jax_run, tracked, alone, idx):
    aux, (calib_cs, baselines, expos) = tracked
    st_b, b_b = tb.frame_kf_subset_batched(
        tb._tree_stack(_states(jax_run)), aux, calib_cs, baselines, expos, jax_run["pots"], idx,
        uniforms=[jax_graph_uniform] * len(SEEDS), **_kf_kw(jax_run))
    assert st_b.salt.shape[0] == len(idx)
    for j, k in enumerate(idx):
        _assert_trees_equal(tb._tree_slice(st_b, j), alone[k][0], f"{idx}: state of {k}")
        _assert_trees_equal(tb._tree_slice(b_b, j), alone[k][1], f"{idx}: bundle of {k}")


def test_kf_subset_matches_jax_vmap(jax_run, alone):
    """The port's keyframes (each sequence's, from its own tracking of the
    same pre-frame state) against the JAX package's vmapped subset of the
    sequences whose tracking decided a keyframe."""
    want = jax_run["kf"]
    assert jax_run["idx"].size >= 1
    worst = 0.0
    for j, k in enumerate(jax_run["idx"]):
        b = alone[k][1]
        for f in ("slot", "frame_id", "frame_valid", "flagged"):
            np.testing.assert_array_equal(n(getattr(b, f)), want[f][j], err_msg=f"seq {k} {f}")
        err = float(np.abs(n(b.w2c) - want["w2c"][j]).max())
        assert err <= W2C_TOL, (k, err)
        worst = max(worst, err)
    print(f"max |d w2c| against the JAX vmap over {len(SEEDS)} keyframes: {worst:.3g}")


def _windows(jax_run):
    states = _states(jax_run)
    return [st.win for st in states], [st.dI0_slots for st in states]


def test_optimize_fused_rows_stop_on_their_own(jax_run, monkeypatch):
    """BA over three windows perturbed by different amounts, so that they
    converge at different iterations: each row equals its window alone
    (energy and residual count too), a row that stopped is never stepped
    again, the loop runs as long as its slowest row, and it reads the
    flags on the host once an iteration for all rows."""
    s = _settings()
    wins, stacks = _windows(jax_run)
    rng = np.random.default_rng(0)
    for k, scale in enumerate((0.0, 3e-3, 3e-2)):
        noise = torch.as_tensor(rng.normal(0.0, scale, wins[k].state.shape), dtype=torch.float32)
        wins[k] = wins[k].replace(state=wins[k].state + noise * wins[k].frame_valid[:, None])
    iterations = [0]
    inner = ba.ba_iteration

    def spy(*a, **kw):
        iterations[0] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(ba, "ba_iteration", spy)
    its, singles = [], []
    for w, st in zip(wins, stacks):
        iterations[0] = 0
        singles.append(ba.optimize_fused(w, st, settings=s, max_its=s.max_opt_iterations))
        its.append(iterations[0])
    assert its[0] < max(its), its  # a row stops before the slowest
    iterations[0] = 0
    host.reset()
    out = ba.optimize_fused(tb._tree_stack(wins), torch.stack(stacks), settings=s,
                            max_its=s.max_opt_iterations)
    assert iterations[0] == max(its) and host.READS == max(its), (iterations[0], host.READS, its)
    for k, one in enumerate(singles):
        _assert_trees_equal(tb._tree_slice(out, k), one, f"window {k} ({its[k]} iterations)")


def test_marginalize_frames_masked_per_row_flags(jax_run):
    s = _settings()
    wins, _ = _windows(jax_run)
    F = wins[0].F
    flags = np.zeros((len(wins), F), bool)
    valid = [np.nonzero(n(w.frame_valid))[0] for w in wins]
    flags[0, valid[0][1]] = True
    flags[1, valid[1][[1, -2]]] = True  # two slots, in slot order
    # sequence 2 marginalizes nothing
    out = ba.marginalize_frames_masked(tb._tree_stack(wins), flags, settings=s)
    for k, w in enumerate(wins):
        want = ba.marginalize_frames_masked(w, flags[k], settings=s)
        _assert_trees_equal(tb._tree_slice(out, k), want, f"window {k}")
    _assert_trees_equal(tb._tree_slice(out, 2), wins[2], "unflagged window")


def test_select_per_row_potential_and_salt(jax_run):
    s = _settings()
    lefts = _inputs(jax_run)[0]
    dIp = build_pyramid(lefts, 1)[0][0]
    asg = build_pyramid(dIp[..., 0], 3)[1]
    ths = SEL.block_thresholds(asg[0], s)
    pots, salts = [2, 4, 2], [1001, 2002, 3003]
    sel = SEL.select(dIp, asg[0], asg[1], asg[2], ths, pots, 1.0, salts, s)
    pts = SEL.map_to_points(sel.status_map, SET_KF.immature_cap)
    for k in range(len(SEEDS)):
        ths_k = SEL.block_thresholds(asg[0][k], s)
        _assert_trees_equal(ths[k], ths_k, f"thresholds {k}")
        one = SEL.select(dIp[k], asg[0][k], asg[1][k], asg[2][k], ths_k, pots[k], 1.0, salts[k], s)
        _assert_trees_equal(tb._tree_slice(sel, k), one, f"selection {k}")
        _assert_trees_equal(tb._tree_slice(pts, k), SEL.map_to_points(one.status_map,
                                                                      SET_KF.immature_cap),
                            f"points {k}")


def test_fused_is_frame_auto_per_sequence(jax_run):
    """"fused" over the three sequences, the camera of sequence 1 not moved
    (its last bootstrap frame again, so that it takes no keyframe while the
    others do): each equals `frame_auto` alone; the one without a keyframe
    equals `frame_track`'s state, leaf for leaf (the pyramid row the
    keyframe pipeline wrote is given back). `need_kf` is never read: the
    reads are those of the track program and of one keyframe pipeline over
    all three sequences."""
    lefts, rights, calib_cs, baselines, expos = _inputs(jax_run)
    still = _inputs(jax_run, N_BOOT - 1)
    lefts[1], rights[1] = still[0][1], still[1][1]
    kw = _kf_kw(jax_run)
    common = dict(kw)
    del common["caps"], common["imm_cap"]
    pots = jax_run["pots"]
    host.reset()
    st, b = tb.frame_auto_batched(tb._tree_stack(_states(jax_run)), lefts, rights, calib_cs,
                                  baselines, expos, pots, uniforms=[jax_graph_uniform] * 3, **kw)
    fused_reads = host.READS
    need = n(b.need_kf)
    assert need.any() and not need.all(), need  # both branches are taken
    host.reset()
    _, _, aux = tb.frame_track_batched(tb._tree_stack(_states(jax_run)), lefts, rights, calib_cs,
                                       baselines, expos, n_tries=5, **common)
    track_reads = host.READS
    host.reset()
    tgs._kf_branch(tb._tree_stack(_states(jax_run)), aux, calib_cs, baselines, expos,
                   common["settings"], N_LVL, pots, kw["caps"], W_, H_, kw["imm_cap"],
                   [jax_graph_uniform] * 3)
    assert fused_reads == track_reads + host.READS
    for k, state in enumerate(_states(jax_run)):
        want = tgs.frame_auto(state, lefts[k], rights[k], calib_cs[k], baselines[k], expos[k],
                              pot=pots[k], uniform=jax_graph_uniform, **kw)
        _assert_trees_equal(tb._tree_slice(st, k), want[0], f"state {k}")
        _assert_trees_equal(tb._tree_slice(b, k), want[1], f"bundle {k}")
        if not need[k]:
            track = tgs.frame_track(_states(jax_run)[k], lefts[k], rights[k], calib_cs[k],
                                    baselines[k], expos[k], **common)
            _assert_trees_equal(tb._tree_slice(st, k), track[0], f"non-keyframe {k}")


def test_slab_route_batched_track_is_one_slab_run_per_sequence(jax_run, monkeypatch):
    """With every trace forced onto the slab route (as an image over the
    6 MB gate takes it), the batched track program runs and equals the
    one-sequence program on each sequence."""
    monkeypatch.setattr(trace_ops, "DEFAULT_ROUTE", "slab")
    lefts, rights, calib_cs, baselines, expos = _inputs(jax_run)
    common = _common()
    out = tb.frame_track_batched(tb._tree_stack(_states(jax_run)), lefts, rights, calib_cs,
                                 baselines, expos, n_tries=5, **common)
    for k, state in enumerate(_states(jax_run)):
        one = tgs.frame_track(state, lefts[k], rights[k], calib_cs[k], baselines[k], expos[k],
                              n_tries=5, **common)
        for part, name in enumerate(("state", "bundle", "aux")):
            _assert_trees_equal(tb._tree_slice(out[part], k), one[part], f"seq {k} {name}")


@pytest.mark.parametrize("stereo", [False, True])
def test_batched_plain_k2_is_one_call_per_sequence(jax_run, stereo):
    """The plain K2 over a batch (B, H, W, 3) with (B, L, 8) lanes is B
    single calls, bit for bit, on every edge lane of every sequence."""
    imgs = [build_pyramid(torch.as_tensor(np.asarray(fr[N_BOOT][0], np.float32)), 1)[0][0]
            for fr in jax_run["frames"]]
    S = 40
    lanes = [edge_lanes(img, S, stereo, seed=k)[0] for k, img in enumerate(imgs)]
    kw = dict(S=S, huber_th=9.0, gn_iters=3, gn_threshold=0.1, radius=2,
              edge=tk.EDGE_ZERO if stereo else tk.EDGE_CLAMP)
    keys = ("scal", "color", "weights", "patx", "paty")
    batch = tk.epipolar_search_slab(torch.stack(imgs), *[torch.stack([ln[k] for ln in lanes])
                                                          for k in keys], **kw)
    assert batch.shape == (len(imgs),) + lanes[0]["scal"].shape
    for b, (img, ln) in enumerate(zip(imgs, lanes)):
        one = tk.epipolar_search_slab(img, *[ln[k] for k in keys], **kw)
        _assert_trees_equal(batch[b], one, f"K2 sequence {b}")


@pytest.mark.cuda
def test_batched_k2_kernel_is_one_launch_per_sequence(jax_run):
    """On the card: one K2 launch over a batch equals a launch per
    sequence, bit for bit, and its plain version within the kernel's
    tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    imgs = [build_pyramid(torch.as_tensor(np.asarray(fr[N_BOOT][0], np.float32)), 1)[0][0]
            for fr in jax_run["frames"]]
    S = 40
    lanes = [edge_lanes(img, S, False, seed=k)[0] for k, img in enumerate(imgs)]
    kw = dict(S=S, huber_th=9.0, gn_iters=3, gn_threshold=0.1, radius=2, edge=tk.EDGE_CLAMP)
    keys = ("scal", "color", "weights", "patx", "paty")
    ops = [torch.stack(imgs).to(dev)] + [torch.stack([ln[k] for ln in lanes]).to(dev) for k in keys]
    batch = tk.epipolar_search_slab(*ops, **kw)
    for b in range(len(imgs)):
        one = tk.epipolar_search_slab(*[x[b] for x in ops], **kw)
        _assert_trees_equal(batch[b], one, f"K2 launch, sequence {b}")
    plain = tk.epipolar_search_slab_ref(*ops, **kw)
    same_idx = batch[..., tk.OUT_BEST_IDX] == plain[..., tk.OUT_BEST_IDX]
    assert float(same_idx.float().mean()) >= 0.999
    assert float((batch[..., :2] - plain[..., :2])[same_idx].abs().max()) <= 1e-3
