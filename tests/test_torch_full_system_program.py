"""FullSystem, stereo_match and the mono initializer as programs, held on
the CPU.

On the card every stage the JAX package jits runs as one program
(`runtime/program.run`: captured once per key, replayed, its loops WHILE
nodes and its branches IF nodes): `FullSystem`'s tracked frame, its
non-keyframe refinement and each stage of its keyframe, the tracking
reference, the selector's passes, `stereo_match_points` and the sharded
match's rank block, the Hessian of the eigenvalue record, and the
initializer's level LM, propagations, coarse selection and NN graphs.
Here every such call is recorded as `FullSystem` (and the others) make it,
on the bench entry's small corridor (256x128, from frame 0 through a
keyframe that marginalizes a frame), and each recorded unit is run again
eagerly and with every loop at its bound (`utils/loop.bounded`, what the
nodes compute):

- the bounded run equals the host loop bit for bit, NaN equal to NaN;
- it makes zero Python-level reads of a tensor (`ReadCounter`);
- it dispatches none of `ForbiddenOps`' ops (test_torch_program.py);
- it writes none of its inputs.

The run goes again, from the bench entry's bootstrap on under
`loop.bounded()` with every read counted:
`FullSystem.add_frame` reads the device exactly once on a tracked
non-keyframe frame (the packed track bundle), and on a keyframe frame at
the JAX package's read sites only: the track bundle, the flagging policy's
bundle (and the window poses when it is full), the free slot, the active
count, the finalization's bundle, and the selector's count after each pass
and after a thinning. On the card (marked `cuda`, skipped here) the
replayed programs equal `program.disabled()` frame by frame.
"""

import numpy as np
import pytest
import torch
from _torch_parity import ReadCounter
from test_torch_program import ForbiddenOps, _differing, _same

from stereo_dso_g2o_tpu_torch import bench as tbench
from stereo_dso_g2o_tpu_torch.frontend import full_system
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.frontend.initializer import MonoInitializer
from stereo_dso_g2o_tpu_torch.frontend.stereo_match import stereo_match
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.parallel import multiseq
from stereo_dso_g2o_tpu_torch.runtime import diagnostics, program
from stereo_dso_g2o_tpu_torch.utils import host, loop
from stereo_dso_g2o_tpu_torch.utils.tree import tree_map

N_FRAMES = 30

# every unit, by the name the recorder gives it (qualname, and the BA's
# iteration cap or the initializer level's when a unit has several keys)
UNITS = (
    "frame_step_full", "nonkey_refine_step", "kf_trace_step", "_activate",
    "optimize_fused[20]", "optimize_fused[15]", "optimize_fused[max]", "kf_finalize",
    "build_ref", "block_thresholds", "_select_pass", "_seed", "_marg_frames",
    "_hessian_blocks", "_match_points", "_match_block",
    "lm_level_init[top]", "lm_level_init[10]", "lm_level_init[5]", "propagate_up",
    "propagate_down",
    "_grid_max_select", "grid_knn", "grid_parent",
)


def _name(fn, static, settings):
    name = fn.__qualname__
    if name == "optimize_fused":
        its = static["max_its"]
        return f"optimize_fused[{'max' if its == settings.max_opt_iterations else its}]"
    if name == "lm_level_init":
        return f"lm_level_init[{'top' if static['top_level'] else static['max_iterations']}]"
    return name


class Recorder:
    """Wraps `program.run`: notes the first call of every unit (a copy of
    its inputs) and how often each unit ran."""

    def __init__(self, monkeypatch, settings):
        self.calls, self.count = {}, {}
        run = program.run

        def spy(fn, args, static, key=()):
            name = _name(fn, static, settings)
            self.count[name] = self.count.get(name, 0) + 1
            if name not in self.calls:
                self.calls[name] = (fn, tree_map(torch.clone, args), dict(static))
            return run(fn, args, static, key)

        monkeypatch.setattr(program, "run", spy)


class FetchLog:
    """Wraps `utils/host.Fetch` and `host.item`: the shapes of every packed
    read, and the count of single reads, in order."""

    def __init__(self, monkeypatch):
        self.log = []
        log = self.log
        fetch, item = host.Fetch, host.item

        class Spy(fetch):
            def get(self):
                log.append(("fetch", tuple(shape for shape, _ in self.meta)))
                return super().get()

        def spy_item(x):
            log.append(("item", tuple(x.shape)))
            return item(x)

        monkeypatch.setattr(host, "Fetch", Spy)
        monkeypatch.setattr(host, "item", spy_item)


def _setup():
    cfg = tbench.bench_config(True)
    K, (lefts, rights, _) = tbench.render_sequence(cfg, 0, N_FRAMES, torch.device("cpu"))
    settings = tbench.bench_settings(cfg)

    def calib(levels):
        return make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                          n_levels=levels, device="cpu")

    return torch.as_tensor(lefts), torch.as_tensor(rights), calib, settings




@pytest.fixture(scope="module")
def recorded():
    """Every unit's first call as its caller makes it, and the eager run's
    system (for the read count's comparison)."""
    lefts, rights, calib, settings = _setup()
    mp = pytest.MonkeyPatch()
    try:
        rec = Recorder(mp, settings)
        fs = FullSystem(calib(6), settings, device="cpu")
        for i in range(N_FRAMES):
            fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        # the non-keyframe refinement after a failed track, and the record
        dIpL, _ = build_pyramid(lefts[-1].float(), 6)
        dIpR, _ = build_pyramid(rights[-1].float(), 6)
        last = fs.history[-1]
        imm = fs.imm
        fs._make_non_keyframe(dIpL, dIpR, last, np.linalg.inv(last.T_cam_to_ref), last.aff, 1.0)
        fs.imm = imm
        diagnostics.eigenvalue_record(fs.win, settings)
        # stereo_match, the sharded match's block, the initializer at 4 levels
        stereo_match(lefts[0], rights[0], calib(6), settings=settings, device="cpu")
        fn, args, static = rec.calls["_match_points"]
        two = (tree_map(lambda x: torch.stack([x, x]), args[:5])) + tuple(args[5:])
        program.run(multiseq._match_block, two, static)
        mi = MonoInitializer(calib(4), settings, device="cpu")
        mi.set_first(*build_pyramid(lefts[0].float(), 4))
        mi.track_frame(build_pyramid(lefts[2].float(), 4)[0])
    finally:
        mp.undo()
    return dict(calls=rec.calls, count=rec.count, fs=fs, data=(lefts, rights, calib, settings))


@pytest.fixture(scope="module")
def contract(recorded):
    """Per unit: the host loop's result, the bounded loops', their reads and
    forbidden ops, and the inputs before and after."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, (fn, args, static) in recorded["calls"].items():
            before = [x.clone() for x in program.leaves(args)]
            ref = fn(*args, **static)
            counter = ReadCounter(mp)
            ops = ForbiddenOps()
            with loop.bounded(), ops:
                got = fn(*args, **static)
            reads = (counter.n, dict(counter.by))
            mp.undo()
            out[name] = dict(ref=ref, got=got, reads=reads, forbidden=ops.found,
                             before=before, after=program.leaves(args))
    finally:
        mp.undo()
    return out


def test_every_unit_was_recorded(recorded):
    assert sorted(recorded["calls"]) == sorted(UNITS)
    assert recorded["fs"].n_frame_marginalizations >= 1
    assert not recorded["fs"].is_lost


@pytest.mark.parametrize("unit", UNITS)
def test_unit_at_its_bound_equals_the_host_loop(contract, unit):
    r = contract[unit]
    assert _differing(r["ref"], r["got"]) == []


@pytest.mark.parametrize("unit", UNITS)
def test_unit_makes_no_read(contract, unit):
    assert contract[unit]["reads"] == (0, {})


@pytest.mark.parametrize("unit", UNITS)
def test_unit_dispatches_no_syncing_op(contract, unit):
    assert contract[unit]["forbidden"] == []


@pytest.mark.parametrize("unit", UNITS)
def test_unit_writes_none_of_its_inputs(contract, unit):
    r = contract[unit]
    assert all(_same(x, y) for x, y in zip(r["before"], r["after"]))


@pytest.fixture(scope="module")
def read_counts(recorded):
    """The slice again, from the bench entry's bootstrap on with every loop
    at its bound, each such frame's reads counted (Python-level reads, and
    the packed reads and single reads of `utils/host.py` in order), the
    selector's passes and thinnings, and whether the frame made a
    keyframe."""
    lefts, rights, calib, settings = recorded["data"]
    frames = {}
    mp = pytest.MonkeyPatch()
    try:
        fs = FullSystem(calib(6), settings, device="cpu")
        thins, draw = [0], fs.selector.uniform

        def counted(*a, **kw):
            thins[0] += 1
            return draw(*a, **kw)

        fs.selector.uniform = counted
        rec = Recorder(mp, settings)
        log = FetchLog(mp)
        counter = ReadCounter(mp)
        counter.on = False
        # the motion model's half step is host math on a tensor made from
        # numpy on the CPU whatever the system's device: no device read
        tries = full_system.motion_model_tries

        def host_math(*a, **kw):
            on, counter.on = counter.on, False
            try:
                return tries(*a, **kw)
            finally:
                counter.on = on

        mp.setattr(full_system, "motion_model_tries", host_math)
        for i in range(N_FRAMES):
            if i < tbench.BOOT:  # the bootstrap as the bench entry runs it
                fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
                continue
            kfs, at, t0 = len(fs.kf_shells), len(log.log), thins[0]
            passes = rec.count.get("_select_pass", 0)
            counter.n, counter.on = 0, True
            with loop.bounded():
                fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
            counter.on = False
            frames[i] = dict(reads=counter.n, log=log.log[at:],
                             passes=rec.count.get("_select_pass", 0) - passes,
                             thins=thins[0] - t0, kf=len(fs.kf_shells) > kfs)
    finally:
        mp.undo()
    return dict(frames=frames, fs=fs)


def test_bounded_slice_is_the_eager_slice(recorded, read_counts):
    a, b = recorded["fs"], read_counts["fs"]
    assert [s.id for s in a.kf_shells] == [s.id for s in b.kf_shells]
    assert all(np.array_equal(x, y) for x, y in zip(a.trajectory(), b.trajectory()))
    assert _differing((a.win, a.imm), (b.win, b.imm)) == []


def test_a_tracked_non_keyframe_frame_reads_once(read_counts):
    """One read: the track bundle (T, aff, residuals, flow, ok, saturation)."""
    frames = {i: f for i, f in read_counts["frames"].items() if not f["kf"]}
    assert len(frames) >= 10
    for i, f in frames.items():
        assert f["reads"] == 1, (i, f)
        assert f["log"] == [("fetch", ((4, 4), (2,), (6,), (3,), (), ()))], (i, f)


def test_a_keyframe_frame_reads_at_the_jax_read_sites(recorded, read_counts):
    """The JAX package's sites (full_system.py: the track's device_get, the
    flagging bundle and the window poses when it is full, the free slot,
    the active count, the finalization's device_get; selector.py: the count
    after each pass and after a thinning), each once, in that order."""
    fs = recorded["fs"]
    F, NP = fs.win.F, fs.win.NP
    cap = fs.imm.u.shape[-1]
    frames = {i: f for i, f in read_counts["frames"].items() if f["kf"]}
    assert len(frames) >= 3
    for i, f in frames.items():
        log = f["log"]
        full = ("fetch", ((F, 4, 4),)) in log
        want = [("fetch", ((4, 4), (2,), (6,), (3,), (), ())),
                ("fetch", ((NP,), (NP,), (F, cap), (F, 2), (F,)))]
        want += [("fetch", ((F, 4, 4),))] * full
        want += [("fetch", ((F,),)), ("item", ())]
        want += [("fetch", ((NP,), (F, 4, 4), (F, 2), (NP,), (), ()))]
        want += [("item", ())] * (f["passes"] + f["thins"])
        assert log == want, (i, log)
        # 5 reads, a 6th when the window is full, then the selector's
        assert f["reads"] == len(want) == 5 + full + f["passes"] + f["thins"]
        assert 1 <= f["passes"] <= 3 and f["thins"] <= 1


@pytest.mark.cuda
def test_replayed_programs_equal_eager_on_the_card():
    """FullSystem through its programs on the card against the same frames
    under `program.disabled()`, bit for bit, frame by frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the programs are CUDA graphs")
    dev = torch.device("cuda", 0)
    cfg = tbench.bench_config(True)
    K, (lefts, rights, _) = tbench.render_sequence(cfg, 0, N_FRAMES, dev)
    settings = tbench.bench_settings(cfg)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                       n_levels=6, device=dev)
    a = FullSystem(calib, settings, device=dev)
    b = FullSystem(calib, settings, device=dev)
    for i in range(N_FRAMES):
        a.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        with program.disabled():
            b.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        assert np.array_equal(a.trajectory()[-1], b.trajectory()[-1]), i
        assert _differing((a.win, a.imm), (b.win, b.imm)) == [], i
    assert [s.id for s in a.kf_shells] == [s.id for s in b.kf_shells]
