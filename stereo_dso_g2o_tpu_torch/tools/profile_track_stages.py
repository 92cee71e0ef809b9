"""Stage times of the non-keyframe frame step.

Port of `tools/profile_track_stages.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.profile_track_stages [at=30]
        [reps=5] [seq=0] [small=0] [device=cuda|cpu]

bench.py's sequence `seq` is run through the graph path up to frame `at`;
then, from that state and on frame `at`'s images, the stages of
`frame_step.frame_step_full` (what `graph_system._track_common` runs) are
timed alone, each the median of `reps` synchronized calls: the pyramids;
one hypothesis through the whole cascade; the whole step (5 hypotheses on
the coarse levels, the winner on the fine ones, then the speculative
depth refinement); the refinement alone at the tracked pose. The JAX
tool's cumulative prefixes follow: `cascade_5try_select` is the whole step
less the pyramids and the refinement. Over the whole step, torch.profiler
gives the device's busy share and kernels per call.
Reference: CoarseTracker::trackNewestCoarse (CoarseTracker.cpp:556-611) +
ImmaturePoint::traceOn (FullSystem.cpp:570-607).
"""

from __future__ import annotations

import sys
import time

import torch

from stereo_dso_g2o_tpu_torch.tools._common import (
    bootstrap, cli, emit, flag, profile_summary, profiled, sequence, sync, timed_ms,
)

KEYS = ("at", "reps", "seq", "small", "device")


def track_inputs(gs):
    """The hypotheses, affine start and last RMSE `_track_common` builds
    from the state."""
    from stereo_dso_g2o_tpu_torch.frontend.graph_system import _rigid_inv, motion_tries

    state = gs.state
    win = state.win
    w2c = win.w2c()
    ref_slot = int(state.ref_slot)

    def fresh_c2w(comp, rel, slot, fid):
        slot = slot.long()
        ok = win.frame_valid[slot] & (win.frame_id[slot] == fid)
        return torch.where(ok, _rigid_inv(w2c[slot]) @ rel, comp)

    last = fresh_c2w(state.last_c2w, state.last_rel, state.last_slot, state.last_fid)
    prev = fresh_c2w(state.prev_c2w, state.prev_rel, state.prev_slot, state.prev_fid)
    T_tries = motion_tries(last, prev, _rigid_inv(w2c[ref_slot]))[:5]
    last_rmse = torch.where(torch.isfinite(state.last_rmse0), state.last_rmse0,
                            torch.full_like(state.last_rmse0, 1e30))
    return ref_slot, T_tries, state.last_aff, last_rmse


def main(at=30, reps=5, seq=0, small=False, device=None) -> dict:
    from stereo_dso_g2o_tpu_torch.bench import BOOT
    from stereo_dso_g2o_tpu_torch.frontend import frame_step as FS
    from stereo_dso_g2o_tpu_torch.models.camera import calib_from_c

    at, reps = int(at), int(reps)
    dev, cfg, s, calib, lefts, rights, _ = sequence(seq, at + 1, flag(small), None, device)
    gs = bootstrap(calib, s, lefts, rights, dev)
    for i in range(BOOT, at):
        gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs.flush()
    state = gs.state
    left, right = lefts[at], rights[at]
    n_levels = calib.n_levels
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    ref_slot, T_tries, aff_init, last_rmse = track_inputs(gs)
    cal = calib_from_c(calib.c, calib.baseline, left.shape[1], left.shape[0], n_levels)
    abort_inf = torch.full((n_levels,), float("inf"), device=dev)

    def pyramids():
        return FS._pyramids(left, right, n_levels)

    dIpL, dIpR = pyramids()

    def cascade_1try():
        return FS.track_cascade(state.ref, dIpL, cal, T_tries[:1], aff_init, state.ref_aff,
                                state.ref_exposure, one, abort_inf, s)

    def full_step():
        return FS.frame_step_full(
            left, right, state.ref, state.win, state.imm, calib.c, calib.baseline, ref_slot,
            T_tries, aff_init, state.ref_aff, state.ref_exposure, one, last_rmse,
            settings=s, n_levels=n_levels, n_tries=5)

    track = full_step()[2]

    def nonkey_refine():
        return FS._nonkey_refine(state.win, state.imm, dIpL[0], dIpR[0], cal, track.T,
                                 track.aff, one, ref_slot, calib.baseline, s)

    ms = {name: timed_ms(fn, dev, reps)[0] for name, fn in (
        ("pyramids", pyramids), ("cascade_1try", cascade_1try), ("full_step", full_step),
        ("nonkey_refine", nonkey_refine))}
    sync(dev)
    t0 = time.perf_counter()
    with profiled(dev) as prof:
        for _ in range(reps):
            full_step()
        sync(dev)
    traced_ms = 1000.0 * (time.perf_counter() - t0)
    cums = {
        "pyramids": ms["pyramids"],
        "cascade_1try": ms["pyramids"] + ms["cascade_1try"],
        "cascade_5try_select": ms["full_step"] - ms["nonkey_refine"],
        "nonkey_refine": ms["full_step"],
    }
    out = {"backend": str(dev), "frame": at}
    out.update({f"prefix_{k}_ms": round(v, 3) for k, v in cums.items()})
    out["stage_pyramids_ms"] = round(ms["pyramids"], 3)
    out["stage_cascade_1try_ms"] = round(ms["cascade_1try"], 3)
    out["stage_cascade_5try_select_ms"] = round(
        ms["full_step"] - ms["nonkey_refine"] - ms["pyramids"], 3)
    out["stage_nonkey_refine_ms"] = round(ms["nonkey_refine"], 3)
    out.update(profile_summary(prof, traced_ms, reps))
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "profile_track_stages"))
