"""The repository's measurement tools (`tools/*.py`), ported.

Each is run as `python -m stereo_dso_g2o_tpu_torch.tools.<name> key=value
...`, prints progress lines and then one JSON line with the keys the JAX
tool prints, and has a `main(...)` that returns that line as a dict. They
run on the GPU unless given `device=cpu`. XLA's cost analysis and the
jitted prefix programs of the JAX tools become the profiler's sections
(`utils/timing.PROF`), synchronized stage times and torch.profiler's
device-busy share and kernels per frame.

- `accuracy_probe`: one bench sequence through the graph path; ATE, KITTI
  relative errors, keyframes, rotation orthonormality; `route=` sends every
  trace through one kernel.
- `analyze_kf_decisions`: which term drives each keyframe in an obs file.
- `bench_enlarged_window`: one BA iteration at F = 8 against F = 16.
- `profile_frame`, `profile_track_stages`, `profile_kf_stages`,
  `profile_refine_stages`: where a frame's time goes.
- `bench_tunnel`: what host<->device traffic and dispatch cost the host.
- `bench_trace_kernel`: both kernels and both routes of `trace_batch` on a
  fixed trace workload, Gauss-Newton off and on, beside the bound.
- `kernel_gap_probe`: the search on a real state's live pool, standalone
  and inside frames.
- `roofline`: a frame's device time by kernel, the share in launch-sized
  kernels, and the search's rate against the card's memory rate.
"""
