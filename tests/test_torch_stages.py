"""The stage accounting of the port's programs, held on the CPU.

On the card every captured program keeps its stages on the device
(`runtime/program.py`, `utils/loop.Capture`, `csrc/graph_while.cu`): a
`PROF.section` becomes a pair of `%globaltimer` stamps, a named loop or
branch counts its trips in the kernel that sets its condition. Here:

- eagerly, a named `while_loop` and `cond` and a `PROF.section` add their
  host trips, evaluations and counts to `PROF` when it is enabled, and
  nothing when it is not; an unnamed loop adds nothing;
- a capture's registry gives each stage its row, kind and parent;
- `Program.stages()` turns a buffer's rows into stages (self time, the
  host clock) — a buffer written by hand, as the stamp kernels would;
- the benchmark's seven readers compute their arithmetic from a
  fabricated `program.stages()`, and give None where a run has nothing to
  read (no traced calls, as on the CPU; no program holding the stage; a
  port without stage accounting).

- an LM trip on CPU tensors runs the plain version's ops and counts no
  kernel launch.

On the card (marked `cuda`, skipped here; this file imports no JAX, so
it runs there: `python3 -m pytest --noconftest -o addopts= -p
no:cacheprovider tests/test_torch_stages.py -q`): on a keyframe frame the
trips the replayed `frame_auto` counts on the device equal the host
loop's, and the LM trip kernel's device counter equals the device's
`track.lm` trips (every trip went through the kernel), program and eager
bit for bit.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from stereo_dso_g2o_tpu_torch import bench as tbench
from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops import tracker_ops
from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.utils import loop
from stereo_dso_g2o_tpu_torch.utils.tree import leaves
from stereo_dso_g2o_tpu_torch.utils.timing import PROF

REPO = Path(__file__).resolve().parents[1]
READERS = ("track.device_ms", "track.lm_trips", "track.lm_trip_us", "kf.device_ms",
           "kf.ba_device_ms", "kf.ba_iters", "program.copy_device_ms")


@pytest.fixture
def prof():
    was = PROF.enabled
    PROF.reset()
    yield PROF
    PROF.enabled = was
    PROF.reset()


def _run_named(trips_wanted: int, taken: bool):
    """A named loop of `trips_wanted` trips, a named branch, an unnamed
    loop, inside a section."""
    with PROF.section("outer"):
        n = torch.zeros((), dtype=torch.int64)
        done = torch.zeros(2, dtype=torch.bool)

        def trip():
            n.add_(1)
            done.fill_(bool(n >= trips_wanted))

        loop.while_loop(done, trip, 10, name="demo.loop")
        got = loop.cond(torch.tensor(taken), lambda: n + 1, n, name="demo.branch")
        done2 = torch.zeros((), dtype=torch.bool)
        loop.while_loop(done2, lambda: done2.fill_(True), 3)
    return int(n), int(got)


@pytest.mark.parametrize("enabled", [True, False])
def test_eager_named_loops_and_sections_count_with_the_profiler_on(prof, enabled):
    prof.enabled = enabled
    for trips, taken in ((3, True), (1, False)):
        assert _run_named(trips, taken) == (trips, trips + int(taken))
    if not enabled:
        assert not prof.totals and not prof.counts and not prof.trips
        return
    assert prof.counts["outer"] == 2 and prof.counts["demo.loop"] == 2
    assert prof.trips["demo.loop"] == 4
    assert prof.counts["demo.branch"] == 2 and prof.trips["demo.branch"] == 1
    assert set(prof.trips) == {"demo.loop", "demo.branch"}
    assert "demo.loop" in prof.report(min_ms=1e9)


def test_bounded_loops_count_their_bound(prof):
    prof.enabled = True
    with loop.bounded():
        _run_named(3, False)
    assert prof.trips["demo.loop"] == 10 and prof.trips["demo.branch"] == 1


def test_a_capture_registers_stages_under_their_parents():
    cap = loop.Capture(lib=None, body_pool=(), stamps=torch.zeros((3, 8), dtype=torch.int64))
    with cap.section("program.call", "call", stamp=False):
        a = cap.slot("track.lm", "while")
        assert cap.slot("track.lm", "while") == a
    assert {k: (v.slot, v.kind, v.parent) for k, v in cap.stages.items()} == {
        "program.call": (0, "call", None), "track.lm": (1, "while", "program.call")}
    with pytest.raises(RuntimeError, match="is a while"):
        cap.slot("track.lm", "if")
    cap.slot("kf.need", "if")
    with pytest.raises(RuntimeError, match="room for 3"):
        cap.slot("one.more", "section")


def test_program_stages_from_a_buffer():
    """Rows as the stamp kernels leave them: program.call around
    program.replay around track, track.lm and a branch inside track."""
    p = program.Program.__new__(program.Program)
    p.name, p.replays, p.clock = "_frame_auto", 2, (1_000_000_000, 3000)
    S = loop.Stage
    p.stages_kept = {"program.call": S(0, "call", None),
                     "program.replay": S(1, "section", "program.call"),
                     "track": S(2, "section", "program.replay"),
                     "track.lm": S(3, "while", "track"),
                     "track.ladder": S(4, "if", "track"),
                     "kf": S(5, "section", "program.replay")}
    rows = torch.zeros((8, 8), dtype=torch.int64)
    # begin, end, total ns, count, trips, entries
    rows[0, :6] = torch.tensor([3_000_000_000, 3_080_000_000, 160_000_000, 2, 0, 2])
    rows[1, :6] = torch.tensor([3_001_000_000, 3_079_000_000, 156_000_000, 2, 0, 2])
    rows[2, :6] = torch.tensor([3_002_000_000, 3_070_000_000, 140_000_000, 2, 0, 2])
    rows[3, :6] = torch.tensor([3_010_000_000, 3_011_000_000, 100_000_000, 12, 100, 12])
    rows[4, :6] = torch.tensor([3_020_000_000, 3_020_000_000, 0, 2, 1, 2])
    p.stamps = rows
    got = p.stages()
    assert got["name"] == "_frame_auto" and got["replays"] == 2
    st = got["stages"]
    assert st["program.call"]["device_ms"] == 160.0 and st["program.call"]["self_ms"] == 4.0
    assert st["program.replay"]["self_ms"] == 16.0
    assert st["track"]["self_ms"] == 40.0 and st["track"]["parent"] == "program.replay"
    assert st["track.lm"]["trips"] == 100 and st["track.lm"]["count"] == 12
    assert st["track.ladder"]["taken"] == 1 and "trips" not in st["track.ladder"]
    assert st["program.call"]["last"] == [2.0, 2.08]
    assert st["kf"]["count"] == 0 and st["kf"]["last"] is None


def _stage(count=0, device_ms=0.0, **kw):
    return dict(parent=None, kind="section", count=count, entries=count, device_ms=device_ms,
                self_ms=device_ms, last=None, **kw)


def _fabricated():
    """A fleet's programs: the batched track program, two keyframe subset
    sizes, a bootstrap program holding neither stage."""
    track = {"program.call": _stage(100, 8000.0), "program.replay": _stage(100, 7900.0),
             "track": _stage(100, 7000.0), "track.lm": _stage(1200, 6000.0, trips=5000)}
    kf1 = {"program.call": _stage(10, 310.0), "program.replay": _stage(10, 300.0),
           "kf": _stage(10, 280.0), "graph.kf.ba": _stage(10, 120.0),
           "ba": _stage(10, 110.0, trips=50)}
    kf2 = {"program.call": _stage(5, 205.0), "program.replay": _stage(5, 200.0),
           "kf": _stage(5, 190.0), "graph.kf.ba": _stage(5, 90.0),
           "ba": _stage(5, 85.0, trips=25)}
    boot = {"program.call": _stage(12, 600.0), "program.replay": _stage(12, 500.0),
            "track.lm": _stage(50, 400.0, trips=300), "ba": _stage(3, 30.0, trips=18)}
    return [dict(name=n, replays=st["program.call"]["count"], stages=st, clock=[0, 1000])
            for n, st in (("_frame_track", track), ("_kf_subset", kf1), ("_kf_subset", kf2),
                          ("frame_step_full", boot))]


def _reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"stages_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(calls):
    return {"cell": "x", "setup_s": 1.0, "window_s": 1.0, "submitted": {}, "completed": {},
            "host_reads": 0, "calls": calls, "device_window_ms": None, "kernels": {}}


CALLS = [{"layer": "batched", "kf": False, "device_ms": 80.0}]


def test_readers_compute_from_the_programs_stages(monkeypatch):
    monkeypatch.setattr(program, "stages", _fabricated)
    got = {n: _reader(n)(_ctx(CALLS)) for n in READERS}
    assert got == pytest.approx({
        "track.device_ms": 70.0, "track.lm_trips": 50.0, "track.lm_trip_us": 1200.0,
        "kf.device_ms": 470.0 / 15, "kf.ba_device_ms": 210.0 / 15, "kf.ba_iters": 75 / 15,
        # (8000 - 7900) + (310 - 300) + (205 - 200), the bootstrap's left out
        "program.copy_device_ms": 115.0 / 100})


@pytest.mark.parametrize("case", ["no_calls", "no_programs", "no_stage", "no_accounting"])
def test_readers_leave_out_what_they_cannot_read(monkeypatch, case):
    calls = [] if case == "no_calls" else CALLS
    if case == "no_calls":
        monkeypatch.setattr(program, "stages", _fabricated)
    elif case == "no_programs":
        monkeypatch.setattr(program, "stages", lambda: [])
    elif case == "no_stage":
        monkeypatch.setattr(program, "stages", lambda: _fabricated()[3:])
    else:
        monkeypatch.delattr(program, "stages")
    for n in READERS:
        assert _reader(n)(_ctx(calls)) is None, n


def test_a_cpu_lm_trip_runs_the_plain_ops_and_launches_no_kernel(monkeypatch):
    """On CPU tensors `tracker_ops.lm_trip` is the plain version: its
    hundreds of PyTorch ops run, the kernel's wrapper is not called and no
    launch is counted."""
    import _torch_lm_cases
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    def refuse(p, c):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(tracker_ops, "lm_trip_cuda", refuse)
    p, c = _torch_lm_cases.tiny(n_seq=2)
    tracker_ops.reset_trip_launches()
    want = _torch_lm_cases.clone(c)
    tracker_ops.lm_trip_ref(p, want)
    with Count():
        tracker_ops.lm_trip(p, c)
    assert Count.n > 300
    assert tracker_ops.trip_launches() == 0
    for name, a, b in zip(tracker_ops.LMCarry._fields, c, want):
        assert torch.equal(a.nan_to_num() if a.is_floating_point() else a,
                           b.nan_to_num() if b.is_floating_point() else b), name


@pytest.fixture(scope="module")
def corridor():
    """The bench entry's small corridor on the card: 12 frames through
    `FullSystem`, the freeze, and the keyword arguments of `frame_auto`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program is a CUDA graph")
    dev = torch.device("cuda", 0)
    B = tbench.BOOT
    cfg = tbench.bench_config(True)
    K, (lefts, rights, _) = tbench.render_sequence(cfg, 0, B + 2, dev)
    s = tbench.bench_settings(cfg)
    cal = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                     n_levels=6, device=dev)
    fs = FullSystem(cal, s, device=dev)
    for i in range(B):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = tgs.GraphSystem.from_full_system(fs)
    kw = dict(settings=s, n_levels=cal.n_levels, n_tries=5, caps=gs.caps, w0=cal.w[0],
              h0=cal.h[0], imm_cap=s.immature_cap, pot=gs.pot)
    return dict(B=B, lefts=lefts, rights=rights, cal=cal, gs=gs, kw=kw)


def _frame(cor, state, i):
    cal = cor["cal"]
    return tgs.frame_auto(state, cor["lefts"][i], cor["rights"][i], cal.c, cal.baseline, 1.0,
                          **cor["kw"])


@pytest.mark.cuda
def test_device_counted_trips_equal_the_host_loops_on_the_card(prof, corridor):
    """On a keyframe frame of the bench entry's small corridor, the trips
    the replayed `frame_auto` counts on the device (`track.lm`, `ba`,
    `kf.need` taken) equal those the same frame counts in the host loop
    under `program.disabled()` with `PROF` on; the replay runs `track` and
    `kf` once each, and the stamped children of each section sum to no
    more than it."""
    B = corridor["B"]
    st1, b1 = _frame(corridor, corridor["gs"].state, B)
    assert not bool(b1.need_kf)
    prog = next(p for p in program.PROGRAMS.values() if p.name == "_frame_auto")
    before = prog.stages()["stages"]
    _, b2 = _frame(corridor, st1, B + 1)
    after = prog.stages()["stages"]
    assert bool(b2.need_kf)
    prof.enabled = True
    with program.disabled():
        _frame(corridor, st1, B + 1)

    def delta(stage, key):
        return after[stage][key] - before[stage][key]

    assert delta("track.lm", "trips") == prof.trips["track.lm"] > 0
    assert delta("ba", "trips") == prof.trips["ba"] > 0
    assert delta("kf.need", "taken") == prof.trips["kf.need"] == 1
    assert delta("track", "count") == delta("kf", "count") == delta("program.call", "count") == 1
    for parent in ("track", "kf", "program.replay", "program.call"):
        assert after[parent]["self_ms"] >= 0, (parent, after)


def _bits(tree):
    return [x.view(torch.int32) if x.dtype == torch.float32 else x for x in leaves(tree)]


@pytest.mark.cuda
def test_every_lm_trip_of_a_replayed_frame_is_one_kernel_launch(prof, corridor):
    """Over a replay of the captured `frame_auto` (a keyframe frame), the
    LM trip kernel's device counter advances by the `track.lm` trips the
    device counts; the same frame under `program.disabled()` launches it
    once a host trip; program and eager leave the same state and bundle bit
    for bit."""
    B = corridor["B"]
    st1, _ = _frame(corridor, corridor["gs"].state, B)
    prog = next(p for p in program.PROGRAMS.values() if p.name == "_frame_auto")
    before = prog.stages()["stages"]["track.lm"]["trips"]
    tracker_ops.reset_trip_launches()
    replayed = _frame(corridor, st1, B + 1)
    launched = tracker_ops.trip_launches()
    trips = prog.stages()["stages"]["track.lm"]["trips"] - before
    assert launched == trips > 0
    prof.enabled = True
    tracker_ops.reset_trip_launches()
    with program.disabled():
        eager = _frame(corridor, st1, B + 1)
    assert tracker_ops.trip_launches() == prof.trips["track.lm"] == trips
    for a, b in zip(_bits(replayed), _bits(eager)):
        assert torch.equal(a, b)
