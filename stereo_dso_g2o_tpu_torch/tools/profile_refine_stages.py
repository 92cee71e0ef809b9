"""Stage times of the non-keyframe depth refinement
(`immature.trace_on_nonkey`), once through each epipolar kernel.

Port of `tools/profile_refine_stages.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.profile_refine_stages [at=30]
        [reps=5] [seq=0] [small=0] [device=cuda|cpu]

bench.py's sequence `seq` runs through the graph path up to frame `at`;
`trace_on_nonkey` is then run `reps` times on frame `at`'s images with the
per-host transforms `frame_step._nonkey_refine` builds (the new frame put
at the tracking reference's pose, as the JAX tool does), with the
profiler's sections on: its six steps, compact | temporal_trace |
project_extract_new | stereo_lr | extract_stereo_rl | reproject_scatter.
Each suite runs for `route=resident` and `route=slab` (the kernel every
trace of the call goes through), in place of the JAX tool's pallas/xla
A/B. Also the status mix of the live immature points (OOB lanes still
take kernel lanes), and torch.profiler's device busy share and kernels per
call over the resident suite.
"""

from __future__ import annotations

import sys
import time

from stereo_dso_g2o_tpu_torch.tools._common import (
    bootstrap, cli, emit, flag, profile_summary, profiled, sequence, sync,
)

KEYS = ("at", "reps", "seq", "small", "device")
STEPS = ("compact", "temporal_trace", "project_extract_new", "stereo_lr", "extract_stereo_rl",
         "reproject_scatter")


def main(at=30, reps=5, seq=0, small=False, device=None) -> dict:
    import torch

    from stereo_dso_g2o_tpu_torch.bench import BOOT
    from stereo_dso_g2o_tpu_torch.frontend import frame_step as FS
    from stereo_dso_g2o_tpu_torch.frontend import immature as IMM
    from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
    from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
    from stereo_dso_g2o_tpu_torch.utils.timing import PROF

    at, reps = int(at), int(reps)
    dev, cfg, s, calib, lefts, rights, _ = sequence(seq, at + 1, flag(small), None, device)
    gs = bootstrap(calib, s, lefts, rights, dev)
    for i in range(BOOT, at):
        gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs.flush()
    state = gs.state
    win, imm = state.win, state.imm
    host_valid = win.frame_valid
    n_live = int(torch.sum(imm.valid & host_valid[:, None]))

    dI_new = build_pyramid(lefts[at].to(torch.float32), 1)[0][0]
    dI_right = build_pyramid(rights[at].to(torch.float32), 1)[0][0]
    T_new = win.w2c()[int(state.ref_slot)]  # approx: new ~ ref
    K, KRKi, Kt, R_hn, t_hn = FS._host_transforms(win, T_new, calib)
    aff_ht = torch.zeros((win.F, 2), device=dev)
    aff_ht[:, 0] = 1.0

    def refine():
        return IMM.trace_on_nonkey(imm, KRKi, Kt, R_hn, t_hn, aff_ht, dI_new, dI_right, K,
                                   calib.baseline, host_valid, settings=s)

    st_live = imm.status[imm.valid & host_valid[:, None]]
    hist = {name: int((st_live == code).sum()) for name, code in (
        ("good", trace_ops.IPS_GOOD), ("oob", trace_ops.IPS_OOB),
        ("outlier", trace_ops.IPS_OUTLIER), ("skipped", trace_ops.IPS_SKIPPED),
        ("badcond", trace_ops.IPS_BADCONDITION), ("uninit", trace_ops.IPS_UNINITIALIZED))}
    out = {"backend": str(dev), "frame": at, "n_live_immature": n_live,
           "trace_cap": s.trace_cap, "status_hist": hist}
    route_before, prof_before = trace_ops.DEFAULT_ROUTE, PROF.enabled
    try:
        for route in ("resident", "slab"):
            trace_ops.DEFAULT_ROUTE = route
            refine()  # warm
            sync(dev)
            PROF.enabled = True
            PROF.reset()
            t0 = time.perf_counter()
            for _ in range(reps):
                refine()
            sync(dev)
            total = 1000.0 * (time.perf_counter() - t0) / reps
            PROF.enabled = False
            for step in STEPS:
                out[f"{route}_stage_{step}_ms"] = round(
                    1000.0 * PROF.totals.get(f"refine.{step}", 0.0) / reps, 3)
            out[f"{route}_full_refine_ms"] = round(total, 3)
            emit({"route": route, "progress": "full_refine", "ms": round(total, 3)})
            if route == "resident":
                t0 = time.perf_counter()
                with profiled(dev) as prof:
                    for _ in range(reps):
                        refine()
                    sync(dev)
                out.update(profile_summary(prof, 1000.0 * (time.perf_counter() - t0), reps))
    finally:
        trace_ops.DEFAULT_ROUTE, PROF.enabled = route_before, prof_before
        PROF.reset()
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "profile_refine_stages"))
