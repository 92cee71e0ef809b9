"""The epipolar search on a fixed trace workload: both routes of
`trace_batch`, its plain version, and both kernels with Gauss-Newton off
and on.

Port of `tools/bench_trace_kernel.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.bench_trace_kernel [n=2048]
        [small=0] [device=cuda|cpu]

The inputs are the JAX tool's: frames 30 (host) and 33 (target) of bench.py's
sequence 0, `KRKi` and `Kt` from the renderer's poses, `n` lanes drawn
with `np.random.default_rng(1)` 16 pixels inside the image, their pattern
data from `extract_point_data`, status UNINITIALIZED, inverse-depth
intervals 0.7 to 1.5 x the drawn one, default Settings. Keys:
  - `trace_batch_resident_ms`, `trace_batch_slab_ms`: `trace_batch` with
    `route=` each kernel (the JAX tool's `trace_batch_{pallas,xla}_ms`);
  - `plain_search_ms`: `epipolar_search_ref`, the plain version, on the
    device on the operands the kernels get. It is hundreds of small
    kernels, paced by the host, and no yardstick for a kernel
    (`plain_search_note` says so);
  - `kernel_gn{0,3}_ms` (K1) and `kernel_slab_gn{0,3}_ms` (K2): direct
    calls on the operands `ops/trace._search` builds for these lanes,
    Gauss-Newton off and 3 iterations. The Pallas-only
    `pad_image_for_search` and `slab_origins` have no counterpart.
Every `_ms` is the host-clock median of 10 calls each followed by a
synchronize, as the JAX tool's round-5 warning asks; beside each,
`_device_ms` is its device time (`_common.cuda_ms`, None on the CPU) and,
for a kernel, `_bound_share` the share of it `ops/trace_cuda.search_bound`
gives (`search_bound_gn{0,3}_ms`, `search_bound_by`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.tools._common import (
    cli, device_ms, emit, flag, recorded_searches, sequence, timed_ms,
)

KEYS = ("n", "small", "device")
HOST_FRAME, TARGET_FRAME = 30, 33
REPS = 10


def trace_inputs(left_h, left_t, K, pose_h, pose_t, n, settings):
    """The JAX tool's workload: the arguments of `trace_batch` (u, v,
    idepth_min, idepth_max, color, weights, gradH, energy_th, quality,
    status, KRKi, Kt, aff, dI_target) for `n` lanes seeded with 1 on the
    host image `left_h`, traced onto `left_t` (uint8 images on the device;
    poses camera-to-world)."""
    from stereo_dso_g2o_tpu_torch.ops import trace as T
    from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid

    dev = left_h.device
    dIh = build_pyramid(left_h.float(), 1)[0][0]
    dIt = build_pyramid(left_t.float(), 1)[0][0]
    H, W = dIh.shape[:2]
    K0 = np.asarray(K)
    T_ht = np.linalg.inv(np.asarray(pose_t)) @ np.asarray(pose_h)
    KRKi = K0 @ T_ht[:3, :3] @ np.linalg.inv(K0)
    Kt = K0 @ T_ht[:3, 3]

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    rng = np.random.default_rng(1)
    us = f32(rng.uniform(16, W - 16, n))
    vs = f32(rng.uniform(16, H - 16, n))
    id_true = rng.uniform(1 / 40.0, 1 / 5.0, n).astype(np.float32)
    color, weights, gradH, eth = T.extract_point_data(dIh, us, vs, settings)
    return (us, vs, f32(id_true * 0.7), f32(id_true * 1.5), color, weights, gradH, eth,
            torch.full((n,), 10000.0, device=dev),
            torch.full((n,), T.IPS_UNINITIALIZED, dtype=torch.int32, device=dev),
            f32(np.broadcast_to(KRKi, (n, 3, 3))), f32(np.broadcast_to(Kt, (n, 3))),
            f32(np.stack([np.ones(n), np.zeros(n)], 1)), dIt)


def main(n=2048, small=False, device=None) -> dict:
    from stereo_dso_g2o_tpu_torch.config import Settings
    from stereo_dso_g2o_tpu_torch.io import synthetic
    from stereo_dso_g2o_tpu_torch.ops import trace as T
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk

    n = int(n)
    dev, cfg, _, _, lefts, _, poses = sequence(0, TARGET_FRAME + 1, flag(small), None, device)
    settings = Settings()
    K = synthetic.default_K(cfg["w"], cfg["h"], fov_deg=80.0)
    args = trace_inputs(lefts[HOST_FRAME], lefts[TARGET_FRAME], K, poses[HOST_FRAME],
                        poses[TARGET_FRAME], n, settings)
    H, W = args[-1].shape[:2]
    out = {"backend": str(dev), "n_points": n}

    def timed(key, fn, bound=None):
        out[f"{key}_ms"] = timed_ms(fn, dev, REPS)[0]
        out[f"{key}_device_ms"] = device_ms(fn, dev)
        if bound is not None:
            d = out[f"{key}_device_ms"]
            out[f"{key}_bound_share"] = bound / d if d else None
        emit({"progress": key, "ms": out[f"{key}_ms"], "device_ms": out[f"{key}_device_ms"]})

    for route in ("resident", "slab"):
        timed(f"trace_batch_{route}", lambda r=route: T.trace_batch(*args, settings=settings, route=r))

    with recorded_searches() as calls:
        T.trace_batch(*args, settings=settings, route="resident")
    (_, ops, kw), = calls
    timed("plain_search", lambda: tk.epipolar_search_ref(*ops, **kw))
    out["plain_search_note"] = ("the plain version: hundreds of small kernels paced by the "
                                "host, no yardstick for a kernel")

    for gn in (0, 3):
        kw_gn = dict(kw, gn_iters=gn)
        bound = tk.search_bound(H, W, ops[1], kw["S"], gn)
        out[f"search_bound_gn{gn}_ms"] = bound.ms
        out["search_bound_by"] = bound.by
        timed(f"kernel_gn{gn}", lambda k=kw_gn: tk.epipolar_search(*ops, **k), bound.ms)
        timed(f"kernel_slab_gn{gn}", lambda k=kw_gn: tk.epipolar_search_slab(*ops, **k), bound.ms)
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "bench_trace_kernel"))
