"""The track program over a leading sequence axis (`frame_track_batched`)
against the one-sequence program and against the JAX package's vmap of it.

Three sequences at test_graph_system.py's 256x128 (seeds 0, 5 and 3, 7
frames of JAX FullSystem bootstrap, `kf_global_weight=3.0` as in
test_torch_batched.py), frozen by the JAX package and bridged to the port.
Port against port, tolerance 0 (NaN equal to NaN): the batched plain K1
equals one call per sequence, `lm_level` over 3 x 5 hypothesis rows equals
three calls of 5 rows, and `frame_track_batched` over the three sequences
equals `frame_track` on each alone in every leaf of states, bundles and
aux, over two chained frames. Port against the JAX package's
`frame_track_batched` (vmap, CPU, jax x64 off): every pose within 5e-6, the
bound of test_torch_batched.py; a sequence whose pose hypotheses tie is
held to the JAX pose through the tied hypothesis, as there (`KNOWN_TIES`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import graph_state_snapshot, n
from _torch_trace_lanes import edge_lanes
from test_graph_system import BASE, H_, SET, W_, _frames

from stereo_dso_g2o_tpu.frontend.full_system import FullSystem as JFullSystem
from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem as JGraphSystem
from stereo_dso_g2o_tpu.models.camera import make_calib as jmake_calib
from stereo_dso_g2o_tpu.parallel import batched as jbatched
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.frontend import frame_step as tfs
from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
from stereo_dso_g2o_tpu_torch.frontend.coarse_tracker import k_levels
from stereo_dso_g2o_tpu_torch.models.camera import calib_from_c
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
from stereo_dso_g2o_tpu_torch.ops import tracker_ops
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.parallel import batched as tb
from stereo_dso_g2o_tpu_torch.utils import se3

N_BOOT, N_LVL, N_TAIL = 7, 5, 2
SEEDS = (0, 5, 3)
SET_KF = dataclasses.replace(SET, kf_global_weight=3.0)
POSE_TOL = 5e-6
TIE_REL = 5e-6
# (frame, sequence) where the port and the JAX program took different tied
# hypotheses; any other sequence must agree outright
KNOWN_TIES = []


def _common():
    return dict(settings=bridge.settings_from_fields(dataclasses.asdict(SET_KF)),
                n_levels=N_LVL, w0=W_, h0=H_, n_tries=5)


@pytest.fixture(scope="module")
def jax_run():
    """The three sequences bootstrapped and frozen by the JAX package, and
    its batched track program (vmap) over frame N_BOOT, x64 off."""
    with jax.enable_x64(False):
        seqs = [_frames(N_BOOT + N_TAIL, seed=s) for s in SEEDS]
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
        _, bundles, _ = jbatched.frame_track_batched(
            runner.states, lefts, rights, runner.calib_cs, runner.baselines,
            jnp.ones(len(SEEDS), jnp.float32), settings=SET_KF, n_levels=N_LVL, n_tries=5,
            w0=W_, h0=H_)
        T = np.array(bundles.T)
    return dict(K=K, frames=frames, snaps=snaps, T=T, calib_c=np.array(runner.calib_cs),
                baselines=np.array(runner.baselines))


def _states(jax_run):
    return [bridge.graph_state_from_numpy(s, device="cpu") for s in jax_run["snaps"]]


def _inputs(jax_run, i):
    frames = jax_run["frames"]
    lefts = torch.stack([torch.as_tensor(np.asarray(fr[i][0], np.float32)) for fr in frames])
    rights = torch.stack([torch.as_tensor(np.asarray(fr[i][1], np.float32)) for fr in frames])
    calib_cs = torch.as_tensor(jax_run["calib_c"], dtype=torch.float32)
    baselines = torch.as_tensor(jax_run["baselines"], dtype=torch.float32)
    return lefts, rights, calib_cs, baselines, torch.ones(len(SEEDS))


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


@pytest.mark.parametrize("stereo", [False, True])
def test_batched_plain_k1_is_one_call_per_sequence(jax_run, stereo):
    """The plain K1 over a batch (B, H, W, 3) with (B, L, 8) lanes is B
    single calls, bit for bit, on every edge lane of every sequence."""
    imgs = [build_pyramid(torch.as_tensor(np.asarray(fr[N_BOOT][0], np.float32)), 1)[0][0]
            for fr in jax_run["frames"]]
    S = 40
    lanes = [edge_lanes(img, S, stereo, seed=k)[0] for k, img in enumerate(imgs)]
    kw = dict(S=S, huber_th=9.0, gn_iters=3, gn_threshold=0.1, radius=2,
              edge=tk.EDGE_ZERO if stereo else tk.EDGE_CLAMP)
    keys = ("scal", "color", "weights", "patx", "paty")
    batch = tk.epipolar_search(torch.stack(imgs), *[torch.stack([ln[k] for ln in lanes])
                                                     for k in keys], **kw)
    assert batch.shape == (len(imgs),) + lanes[0]["scal"].shape
    for b, (img, ln) in enumerate(zip(imgs, lanes)):
        one = tk.epipolar_search(img, *[ln[k] for k in keys], **kw)
        _assert_trees_equal(batch[b], one, f"K1 sequence {b}")
        _assert_trees_equal(tk.epipolar_search_ref(img[None], *[ln[k][None] for k in keys],
                                                   **kw)[0], one, f"K1 batch of one {b}")


@pytest.mark.parametrize("lvl", [3, 0])
def test_lm_level_over_sequences_is_one_call_per_sequence(jax_run, lvl):
    """`lm_level` over 3 sequences x 5 hypotheses equals one call of 5 rows
    per sequence, bit for bit (a coarse level and the finest)."""
    states = _states(jax_run)
    lefts, _, calib_cs, baselines, expos = _inputs(jax_run, N_BOOT)
    dI = build_pyramid(lefts, N_LVL)[0][lvl]
    K_lvl = k_levels(calib_from_c(calib_cs, baselines, W_, H_, N_LVL))[lvl]
    rng = np.random.default_rng(lvl)
    xi = torch.as_tensor(rng.normal(0.0, 0.01, (len(SEEDS), 5, 6)), dtype=torch.float32)
    T = se3.se3_exp(xi)
    aff = torch.as_tensor(rng.normal(0.0, 0.01, (len(SEEDS), 5, 2)), dtype=torch.float32)
    ref = [st.ref[lvl] for st in states]
    ref_aff = torch.stack([st.ref_aff for st in states])
    ref_exp = torch.stack([st.ref_exposure for st in states])
    rep = torch.zeros((len(SEEDS), 5), dtype=torch.bool)
    kw = dict(settings=_common()["settings"], max_iterations=8)
    batch = tracker_ops.lm_level(*[torch.stack(x) for x in zip(*ref)], dI, K_lvl, T, aff,
                                 ref_aff, ref_exp, expos, rep, **kw)
    for k in range(len(SEEDS)):
        one = tracker_ops.lm_level(*[x[None] for x in ref[k]], dI[k:k + 1], K_lvl[k:k + 1],
                                   T[k:k + 1], aff[k:k + 1], ref_aff[k:k + 1], ref_exp[k:k + 1],
                                   expos[k:k + 1], rep[k:k + 1], **kw)
        _assert_trees_equal(tb._tree_slice(batch, k), tb._tree_slice(one, 0), f"seq {k}")
        alone = tracker_ops.lm_level(*ref[k], dI[k], K_lvl[k], T[k], aff[k], ref_aff[k],
                                     ref_exp[k], expos[k], rep[k], **kw)
        assert bool(torch.isfinite(alone.res_per_point).all())


def test_frame_track_batched_is_frame_track_per_sequence(jax_run):
    """Two chained frames: the batched program over 3 sequences equals the
    one-sequence program on each, in every leaf of states, bundles and
    aux."""
    common = _common()
    states = _states(jax_run)
    stacked = tb._tree_stack(states)
    for i in range(N_BOOT, N_BOOT + N_TAIL):
        lefts, rights, calib_cs, baselines, expos = _inputs(jax_run, i)
        out = tb.frame_track_batched(stacked, lefts, rights, calib_cs, baselines, expos,
                                     **common)
        singles = []
        for k in range(len(SEEDS)):
            one = tgs.frame_track(states[k], lefts[k], rights[k], calib_cs[k], baselines[k],
                                  expos[k], **common)
            for part, name in enumerate(("state", "bundle", "aux")):
                _assert_trees_equal(tb._tree_slice(out[part], k), one[part],
                                    f"frame {i} seq {k} {name}")
            singles.append(one[0])
        stacked, states = out[0], singles


def test_frame_track_batched_matches_jax_vmap(jax_run, monkeypatch):
    """Frame N_BOOT of the three sequences through the port's batched
    program against the JAX package's vmapped one: every pose within 5e-6,
    a tie (level-2 residuals within 5e-6 relative) aside as in
    test_torch_batched.py."""
    best_of, cands, force = tfs._best_of, [], [None]

    def spy(res_all, ok_all, good0):
        j = best_of(res_all, ok_all, good0)
        cands.append((res_all.clone(), ok_all.clone(), j))
        return j if force[0] is None else force[0]

    monkeypatch.setattr(tfs, "_best_of", spy)
    common = _common()
    states = _states(jax_run)
    lefts, rights, calib_cs, baselines, expos = _inputs(jax_run, N_BOOT)
    _, bundles, _ = tb.frame_track_batched(tb._tree_stack(states), lefts, rights, calib_cs,
                                           baselines, expos, **common)
    assert len(cands) == len(SEEDS)  # one selection per sequence, in order
    frame_cands, ties, worst = list(cands), [], 0.0
    for k in range(len(SEEDS)):
        want = jax_run["T"][k]
        err = float(np.abs(n(bundles.T[k]) - want).max())
        if err <= POSE_TOL:
            worst = max(worst, err)
            continue
        res, ok, j = frame_cands[k]
        tied = [a for a in range(len(res))
                if a != j and bool(ok[a]) and abs(float(res[a] - res[j])) <= TIE_REL * float(res[j])]
        assert tied, f"seq {k}: pose off by {err} with no tied hypothesis ({res})"
        errs = {}
        for a in tied:
            force[0] = a
            _, b, _ = tgs.frame_track(states[k], lefts[k], rights[k], calib_cs[k], baselines[k],
                                      expos[k], **common)
            force[0] = None
            errs[a] = float(np.abs(n(b.T) - want).max())
        assert min(errs.values()) <= POSE_TOL, (k, err, errs)
        ties.append((N_BOOT, k))
    assert ties == KNOWN_TIES, ties
    print(f"max |dT| against the JAX vmap over {len(SEEDS)} sequences: {worst:.3g}")
