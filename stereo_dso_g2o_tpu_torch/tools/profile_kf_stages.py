"""Stage times of the keyframe pipeline.

Port of `tools/profile_kf_stages.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.profile_kf_stages
        [capture_after=40] [reps=5] [seq=0] [small=0] [device=cuda|cpu]

bench.py's sequence `seq` is stepped through `graph_system.frame_track` /
`frame_kf` up to frame `capture_after` (on the card replays of their
captured programs, `runtime/program.py`), keeping the pre-frame state and
the tracking result of the last keyframe on the way. `frame_kf` is then
run `reps` more times from that capture eagerly (`program.disabled()`: a
replay runs no section) with the profiler's sections on
(`utils/timing.PROF`, each section synchronizes the device): the stages of
`graph_system._kf_branch` in its order, the JAX tool's names. `flag_insert`
is what the branch spends outside its sections (flagging, insertion,
residual wiring, the state it assembles). Beside them: `frame_kf` replayed
through its program (`kf_program_ms`, host clock, synchronized),
`frame_track` on the next frame from the same pre-state (a replay of its
program), and over the eager `frame_kf` runs torch.profiler's device busy
share and kernels per call.
Reference: FullSystem::makeKeyFrame (FullSystem.cpp:1168-1221).
"""

from __future__ import annotations

import sys
import time

from stereo_dso_g2o_tpu_torch.tools._common import (
    bootstrap, cli, emit, flag, profile_summary, profiled, sequence, sync, timed_ms,
)

KEYS = ("capture_after", "reps", "seq", "small", "device")

# _kf_branch's sections, in its order, under the JAX tool's stage names
STAGES = (
    ("trace_on_kf", ("graph.kf.trace",)),
    ("activation", ("graph.kf.activate",)),
    ("ba", ("graph.kf.ba",)),
    ("finalize_refbuild", ("graph.kf.finalize", "graph.kf.ref")),
    ("select_seed", ("graph.kf.new_traces",)),
    ("marg_frames", ("graph.kf.marg_frames",)),
)


def main(capture_after=40, reps=5, seq=0, small=False, device=None) -> dict:
    import torch

    from stereo_dso_g2o_tpu_torch.bench import BOOT
    from stereo_dso_g2o_tpu_torch.frontend.graph_system import frame_kf, frame_track
    from stereo_dso_g2o_tpu_torch.runtime import program
    from stereo_dso_g2o_tpu_torch.utils.timing import PROF

    capture_after, reps = int(capture_after), int(reps)
    dev, cfg, s, calib, lefts, rights, _ = sequence(
        seq, capture_after + 1, flag(small), None, device)
    gs = bootstrap(calib, s, lefts, rights, dev)
    n_levels = calib.n_levels
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    common = dict(settings=s, n_levels=n_levels, w0=calib.w[0], h0=calib.h[0])
    kf_kw = dict(pot=gs.pot, caps=gs.caps, imm_cap=s.immature_cap, uniform=gs.uniform, **common)
    state, cap = gs.state, None
    for i in range(BOOT, capture_after):
        st_pre = state
        state, _, aux = frame_track(state, lefts[i], rights[i], calib.c, calib.baseline, one,
                                    n_tries=5, **common)
        if bool(aux.need_kf):
            cap = (st_pre, aux, i)
            # continue through the real keyframe so the window keeps churning
            state, _ = frame_kf(st_pre, aux, calib.c, calib.baseline, one, **kf_kw)
    if cap is None:
        raise RuntimeError(f"no keyframe fired before frame {capture_after}")
    state_pre, aux, kf_frame = cap
    emit({"progress": "captured_kf_state", "frame": kf_frame})

    def kf_program():
        return frame_kf(state_pre, aux, calib.c, calib.baseline, one, **kf_kw)

    def kf():
        with program.disabled():
            return kf_program()

    kf()  # warm
    sync(dev)
    enabled = PROF.enabled
    PROF.enabled = True
    PROF.reset()
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            kf()
        sync(dev)
        total_ms = 1000.0 * (time.perf_counter() - t0) / reps
        sections = {k: 1000.0 * v / reps for k, v in PROF.totals.items()}
    finally:
        PROF.enabled = enabled
        PROF.reset()
    t0 = time.perf_counter()
    with profiled(dev) as prof:  # apart: the sections' syncs would idle the device
        for _ in range(reps):
            kf()
        sync(dev)
    traced_ms = 1000.0 * (time.perf_counter() - t0)

    results = {"backend": str(dev), "kf_frame": kf_frame}
    stage = {name: sum(sections.get(k, 0.0) for k in keys) for name, keys in STAGES}
    stage["flag_insert"] = total_ms - sum(stage.values())
    order = ("trace_on_kf", "flag_insert", "activation", "ba", "finalize_refbuild",
             "select_seed", "marg_frames")
    cum = 0.0
    for name in order:
        cum += stage[name]
        results[f"prefix_{name}_ms"] = round(cum, 3)
        results[f"stage_{name}_ms"] = round(stage[name], 3)
    results["kf_branch_ms"] = round(total_ms, 3)
    results["kf_program_ms"] = round(timed_ms(kf_program, dev, reps)[0], 3)
    results["frame_track_ms"] = round(timed_ms(
        lambda: frame_track(state_pre, lefts[capture_after], rights[capture_after], calib.c,
                            calib.baseline, one, n_tries=5, **common), dev, reps)[0], 3)
    results.update(profile_summary(prof, traced_ms, reps))
    emit(results)
    return results


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "profile_kf_stages"))
