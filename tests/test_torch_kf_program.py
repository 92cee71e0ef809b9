"""The keyframe branch as the JAX package runs it, held on the CPU.

On the card `graph_system.frame_auto` is one program per shape: the track
half, then an IF node on the device's `need_kf` whose body is the keyframe
pipeline, with BA's loop a WHILE node and the selector's potentials and
the flagged frames' marginalization IF nodes inside it; `frame_kf`, the
keyframe subset and "fused" are programs too. Here the same functions run
eagerly with every loop at its bound (`utils/loop.bounded`: every
loop runs to its bound, every branch its body), which is what the nodes
compute, on the small corridor of tests/test_torch_program.py (256x128,
one sequence bootstrapped by the port's FullSystem). For `frame_kf` on
one sequence and on three stacked, `frame_auto` on a frame that takes a
keyframe and on one that does not, and "fused" over three sequences:

- the bounded loops equal the host loop bit for bit, NaN equal to NaN,
  in every leaf of the state and the bundle;
- it makes zero Python-level reads of a tensor (`ReadCounter`) and
  dispatches none of `ForbiddenOps`' ops (test_torch_program.py);
- no leaf of its input state changes, `dI0_slots` included.

Also: `selector.graph_uniform` equals the JAX package's keyframe draw bit
for bit; the fixed-shape `insert_activated` equals the JAX function on
seeded inputs, its slot-0 quirk included; `marginalize_frames_masked` with
a device mask equals it with numpy flags; on the card (marked `cuda`,
skipped here) the replayed `frame_auto` equals `program.disabled()`.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import ReadCounter, fields
from test_torch_program import ForbiddenOps, _differing, _same

from stereo_dso_g2o_tpu.backend import window as jW
from stereo_dso_g2o_tpu.frontend import immature as jimm
from stereo_dso_g2o_tpu_torch import bench as tbench
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.backend import ba
from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
from stereo_dso_g2o_tpu_torch.frontend import immature as timm
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops import selector
from stereo_dso_g2o_tpu_torch.parallel import batched as tb
from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.utils import loop
from stereo_dso_g2o_tpu_torch.utils.tree import tree_map

CASES = ("kf_single", "kf_stacked", "auto_kf", "auto_nonkf", "fused")
B = tbench.BOOT


def _setup(dev, n_frames):
    cfg = tbench.bench_config(True)
    K, (lefts, rights, _) = tbench.render_sequence(cfg, 0, n_frames, dev)
    settings = tbench.bench_settings(cfg)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                       n_levels=6, device=dev)
    fs = FullSystem(calib, settings, device=dev)
    for i in range(B):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    return tgs.GraphSystem.from_full_system(fs), torch.as_tensor(lefts), torch.as_tensor(rights)


@pytest.fixture(scope="module")
def runs():
    """Per case: the host loop's (state, bundle), the bounded loops', their
    reads and forbidden ops, and the input state before and after."""
    gs, lefts, rights = _setup(torch.device("cpu"), B + 3)
    cal, s = gs.calib, gs.settings
    one = torch.tensor(1.0)
    track_kw = dict(settings=s, n_levels=cal.n_levels, n_tries=5, w0=cal.w[0], h0=cal.h[0])
    kf_kw = dict(settings=s, n_levels=cal.n_levels, caps=gs.caps, w0=cal.w[0], h0=cal.h[0],
                 imm_cap=s.immature_cap)
    auto_kw = dict(track_kw, caps=gs.caps, imm_cap=s.immature_cap)
    pot = torch.tensor(gs.pot, dtype=torch.int32)
    st0 = gs.state
    # frame B from the freeze takes no keyframe; frame B + 1 after it does
    st1, b1 = tgs.frame_auto(st0, lefts[B], rights[B], cal.c, cal.baseline, one, pot=pot,
                             **auto_kw)
    assert not bool(b1.need_kf)
    _, _, aux = tgs.frame_track(st1, lefts[B + 1], rights[B + 1], cal.c, cal.baseline, one,
                                **track_kw)
    assert bool(aux.need_kf)
    # three sequences from the freeze, frames B, B + 1, B + 2, potentials apart
    n = 3
    states = tree_map(lambda x: torch.stack([x] * n), st0)
    L = torch.stack([lefts[B + k] for k in range(n)])
    R = torch.stack([rights[B + k] for k in range(n)])
    cs, bs, es = torch.stack([cal.c] * n), torch.stack([cal.baseline] * n), torch.ones(n)
    pots = torch.tensor([gs.pot, 1, 6], dtype=torch.int32)
    _, _, aux_n = tb.frame_track_batched(states, L, R, cs, bs, es, **track_kw)
    cases = {
        "kf_single": (st1, lambda: tgs.frame_kf(st1, aux, cal.c, cal.baseline, one, pot=pot,
                                                **kf_kw)),
        "kf_stacked": (states, lambda: tb.frame_kf_subset_batched(
            states, aux_n, cs, bs, es, pots, [0, 1, 2], **kf_kw)),
        "auto_kf": (st1, lambda: tgs.frame_auto(st1, lefts[B + 1], rights[B + 1], cal.c,
                                                cal.baseline, one, pot=pot, **auto_kw)),
        "auto_nonkf": (st0, lambda: tgs.frame_auto(st0, lefts[B], rights[B], cal.c,
                                                   cal.baseline, one, pot=pot, **auto_kw)),
        "fused": (states, lambda: tb.frame_auto_batched(states, L, R, cs, bs, es, pots,
                                                         **auto_kw)),
    }
    out = {"need_n": aux_n.need_kf.clone(), "settings": s}
    mp = pytest.MonkeyPatch()
    try:
        for name, (inputs, call) in cases.items():
            before = [x.clone() for x in program.leaves(inputs)]
            ref = call()
            counter = ReadCounter(mp)
            ops = ForbiddenOps()
            with loop.bounded(), ops:
                got = call()
            reads, by = counter.n, dict(counter.by)
            mp.undo()
            out[name] = dict(ref=ref, got=got, reads=(reads, by), forbidden=ops.found,
                             before=before, after=program.leaves(inputs))
    finally:
        mp.undo()
    return out


def test_cases_take_both_branches(runs):
    need = runs["need_n"].numpy()
    assert need.any() and not need.all(), need  # "fused" keeps rows of both branches
    assert bool(runs["auto_kf"]["ref"][1].need_kf) and not bool(runs["auto_nonkf"]["ref"][1].need_kf)
    assert int(runs["auto_kf"]["ref"][1].slot) >= 0


@pytest.mark.parametrize("case", CASES)
def test_loops_at_their_bound_equal_the_host_loop(runs, case):
    r = runs[case]
    assert _differing(r["ref"], r["got"]) == []
    assert bool(torch.isfinite(r["got"][1].w2c).all())


@pytest.mark.parametrize("case", CASES)
def test_keyframe_program_makes_no_read(runs, case):
    assert runs[case]["reads"] == (0, {})


@pytest.mark.parametrize("case", CASES)
def test_keyframe_program_dispatches_no_syncing_op(runs, case):
    assert runs[case]["forbidden"] == []


@pytest.mark.parametrize("case", CASES)
def test_keyframe_program_writes_none_of_its_inputs(runs, case):
    r = runs[case]
    assert len(r["before"]) == len(r["after"])
    assert all(_same(x, y) for x, y in zip(r["before"], r["after"]))


@pytest.mark.parametrize("shape", [(352, 1216), (128, 256)])
def test_graph_uniform_is_the_jax_draw(shape):
    salts = [0, 1, 12000, 13007, 2**31 - 1]
    with jax.enable_x64(False):
        want = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(17), np.uint32(s)), shape)) for s in salts])
    got = selector.graph_uniform(torch.tensor(salts, dtype=torch.int32), shape).numpy()
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    one = selector.graph_uniform(torch.tensor(salts[2], dtype=torch.int32), shape).numpy()
    np.testing.assert_array_equal(one.view(np.uint32), want[2].view(np.uint32))


F_, C_, NP_ = 4, 16, 24


def _insert_inputs(seed, free_slot0, n_free):
    """Seeded window, immature set and activation result (numpy), with
    `n_free` inactive point slots, slot 0 among them or not."""
    rng = np.random.default_rng(seed)
    win = fields(jW.empty_window(F_, NP_, np.array([200.0, 200.0, 128.0, 64.0], np.float32)))
    imm = fields(jimm.empty(F_, C_))
    free = rng.permutation(np.arange(1, NP_))[:n_free - int(free_slot0)]
    if free_slot0:
        free = np.concatenate([[0], free])
    status = np.full(NP_, W.PT_ACTIVE, np.int32)
    status[free] = W.PT_INACTIVE
    win["pt_status"] = status
    for k in ("pt_u", "pt_v", "pt_idepth", "pt_energy_th"):
        win[k] = rng.uniform(0.5, 9.0, NP_).astype(np.float32)
    win["pt_color"] = rng.uniform(0, 255, (NP_, 8)).astype(np.float32)
    win["res_exists"] = rng.uniform(size=(NP_, F_)) < 0.5
    imm["valid"] = rng.uniform(size=(F_, C_)) < 0.8
    for k in ("u", "v", "energy_th"):
        imm[k] = rng.uniform(1.0, 90.0, (F_, C_)).astype(np.float32)
    imm["color"] = rng.uniform(0, 255, (F_, C_, 8)).astype(np.float32)
    imm["weights"] = rng.uniform(0, 1, (F_, C_, 8)).astype(np.float32)
    act = jimm.ActivationResult(
        idepth=rng.uniform(0.1, 2.0, (F_, C_)).astype(np.float32),
        accepted=rng.uniform(size=(F_, C_)) < 0.4,
        dropped=rng.uniform(size=(F_, C_)) < 0.1,
        res_good=rng.uniform(size=(F_, C_, F_)) < 0.6,
    )
    return win, imm, act


def _jax_insert(win, imm, act, max_insert):
    jw = jW.Window(**{k: jnp.asarray(v) for k, v in win.items()})
    ji = jimm.ImmatureSet(**{k: jnp.asarray(v) for k, v in imm.items()})
    ja = jimm.ActivationResult(*[jnp.asarray(x) for x in act])
    w, i, n = jimm.insert_activated(jw, ji, ja, max_insert=max_insert)
    return fields(w), fields(i), int(n)


def _torch_insert(cases, max_insert):
    """The port's `insert_activated` on one case, or on several stacked."""
    wins = [bridge.window_from_numpy(w, device="cpu") for w, _, _ in cases]
    imms = [bridge.immature_from_numpy(i, device="cpu") for _, i, _ in cases]
    acts = [timm.ActivationResult(*[torch.as_tensor(np.asarray(x)) for x in a])
            for _, _, a in cases]
    if len(cases) == 1:
        return timm.insert_activated(wins[0], imms[0], acts[0], max_insert=max_insert)
    return timm.insert_activated(tb._tree_stack(wins), tb._tree_stack(imms),
                                 tb._tree_stack(acts), max_insert=max_insert)


# (free slot 0, free slots, max_insert): lanes parked with slot 0 free (the
# insertion there is lost); more accepted than lanes, fewer free slots than
# lanes, so a lane with a source is parked; no lane parked
INSERT_CASES = [(True, 12, 1024), (False, 12, 1024), (True, 5, 8), (True, 6, 6)]


@pytest.mark.parametrize("free_slot0,n_free,max_insert", INSERT_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_insert_activated_equals_jax(seed, free_slot0, n_free, max_insert):
    case = _insert_inputs(seed, free_slot0, n_free)
    win_j, imm_j, n_j = _jax_insert(*case, max_insert)
    win_t, imm_t, n_t = _torch_insert([case], max_insert)
    assert int(n_t) == n_j
    if free_slot0 and n_j < max_insert:
        assert win_j["pt_status"][0] == W.PT_INACTIVE  # the quirk: slot 0's insertion lost
    for name, want in win_j.items():
        np.testing.assert_array_equal(getattr(win_t, name).numpy(), want, err_msg=name)
    np.testing.assert_array_equal(imm_t.valid.numpy(), imm_j["valid"])


def test_insert_activated_stacked_equals_jax_per_row():
    cases = [_insert_inputs(k, *INSERT_CASES[k][:2]) for k in range(3)]
    win_t, imm_t, n_t = _torch_insert(cases, 8)
    for k, case in enumerate(cases):
        win_j, imm_j, n_j = _jax_insert(*case, 8)
        assert int(n_t[k]) == n_j
        for name, want in win_j.items():
            np.testing.assert_array_equal(getattr(win_t, name)[k].numpy(), want,
                                          err_msg=f"{name} row {k}")
        np.testing.assert_array_equal(imm_t.valid[k].numpy(), imm_j["valid"])


@pytest.mark.parametrize("mode", ["host", "bounded"])
def test_marginalize_with_a_device_mask_equals_numpy_flags(runs, mode):
    """Slots flagged in some rows (one, all, none), on the three stacked
    windows of the "fused" case's output."""
    win = runs["fused"]["ref"][0].win
    flags = np.zeros(win.frame_valid.shape, dtype=bool)
    valid = win.frame_valid.numpy()
    s0, s1 = [s for s in range(valid.shape[1]) if valid[:, s].all()][:2]
    flags[1, s0] = True
    flags[:, s1] = True
    s = runs["settings"]
    want = ba.marginalize_frames_masked(win, flags, settings=s)
    with loop.bounded() if mode == "bounded" else contextlib.nullcontext():
        got = ba.marginalize_frames_masked(win, torch.from_numpy(flags), settings=s)
    assert _differing(got, want) == []
    assert not got.frame_valid.numpy()[1, s0] and got.frame_valid.numpy()[0, s0]


@pytest.mark.cuda
def test_replayed_keyframe_program_equals_eager_on_the_card():
    """`frame_auto` replayed on the card against `program.disabled()`, bit
    for bit, over four frames with a keyframe among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program is a CUDA graph")
    dev = torch.device("cuda", 0)
    gs, lefts, rights = _setup(dev, B + 4)
    cal, s = gs.calib, gs.settings
    kw = dict(settings=s, n_levels=cal.n_levels, n_tries=5, caps=gs.caps, w0=cal.w[0],
              h0=cal.h[0], imm_cap=s.immature_cap, pot=gs.pot)
    state, kfs = gs.state, []
    for i in range(B, B + 4):
        got = tgs.frame_auto(state, lefts[i], rights[i], cal.c, cal.baseline, 1.0, **kw)
        with program.disabled():
            want = tgs.frame_auto(state, lefts[i], rights[i], cal.c, cal.baseline, 1.0, **kw)
        assert _differing(got, want) == []
        kfs.append(bool(got[1].need_kf))
        state = got[0]
    assert any(kfs)
