"""What a frame pays for host<->device traffic, each cost in isolation.

Port of `tools/bench_tunnel.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.bench_tunnel [device=cuda|cpu]

The JAX tool's keys, each the host-clock mean of N = 20 calls after a warm
one (`_common.mean_ms`), every call ending where its result is on the host
or the device is synchronized:
  - `fetch_scalar_ms`: `.item()` of a 0-d tensor on the device;
  - `fetch_bundle_pytree_ms` against `fetch_bundle_packed_ms`: a real
    `graph_system.FrameBundle` (made by the non-keyframe branch of the
    frame program on an empty window of `Settings.window_cap` slots and 6
    levels) fetched leaf by leaf as `GraphSystem._drain_one` fetches it
    (`x.cpu().numpy()` per field), then the same count of float32 packed in
    one tensor (`bundle_n_leaves`, `bundle_n_floats`);
  - `upload_stereo_pair_ms` (two 352x1216 uint8 images from pageable numpy),
    `upload_8pair_batch_ms` (8 pairs in one array, 5 calls),
    `slice_resident_frame_ms` (one frame of a (200, 352, 1216) uint8 stack
    already on the device);
  - `dispatch_sync_trivial_ms`: one eager `a + 1.0` on (8, 128), then a
    synchronize; `dispatch_enqueue_ms`: N chained adds, no synchronize.
`backend` is the device type; `device` names the card, with its power
limit. One key is the port's own: `wrapper_enqueue_ms`, the host time to
enqueue one `ops/trace_cuda.epipolar_search` call on the operands
`ops/trace` builds for 5120 lanes (the main path's `trace_cap`) of
`bench_trace_kernel`'s workload on a seeded 1216x352 image, with the card
kept busy (`_common.busy_card_ms`) so that the kernel's own time is not in it. On the
CPU the wrapper runs its plain version, so that key is the whole call.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.tools._common import (
    busy_card_ms, cli, emit, mean_ms, recorded_searches, sync,
)

KEYS = ("device",)
N = 20
W_, H_, N_LANES = 1216, 352, 5120


def frame_bundle(F: int, n_levels: int, device):
    """The FrameBundle the frame program's non-keyframe branch returns for
    a window of F slots and a tracker of `n_levels` levels (zeros)."""
    from stereo_dso_g2o_tpu_torch.backend import window as W
    from stereo_dso_g2o_tpu_torch.frontend import graph_system as G
    from stereo_dso_g2o_tpu_torch.frontend import immature as IMM
    from stereo_dso_g2o_tpu_torch.frontend.frame_step import TrackOut

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    eye = torch.eye(4, device=device)
    i32 = torch.zeros((), dtype=torch.int32, device=device)
    state = G.GraphState(*[None] * len(G.GraphState._fields))._replace(
        win=W.empty_window(F, 1, [1.0, 1.0, 0.0, 0.0], device), ref_slot=i32,
        last_c2w=eye, last_rel=eye, last_slot=i32, last_fid=i32)
    ok = torch.ones((), dtype=torch.bool, device=device)
    track = TrackOut(T=eye, aff=f32(2), residuals=f32(n_levels), flow=f32(3), ok=ok,
                     sat_frac0=f32())
    aux = G.TrackAux(dIpL=None, dIpR0=None, track=track, T_best=eye, aff_best=f32(2),
                     flow=f32(3), ok_eff=ok, new_last=f32(), new_first=f32(),
                     need_kf=~ok, kf_inputs=f32(3))
    return G._nonkf_branch(state, IMM.empty(F, 1, device), aux)[1]


def search_call(device):
    """One K1 call on the operands `ops/trace` builds for `N_LANES` lanes of
    `bench_trace_kernel`'s workload, on a seeded W_ x H_ image at the main
    path's settings: a function of no argument."""
    from stereo_dso_g2o_tpu_torch import bench
    from stereo_dso_g2o_tpu_torch.io import synthetic
    from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
    from stereo_dso_g2o_tpu_torch.tools.bench_trace_kernel import trace_inputs

    settings = bench.bench_settings(bench.bench_config(False))
    img = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (H_, W_), np.uint8),
                          device=device)
    pose_t = np.eye(4)
    pose_t[:3, 3] = (0.3, 0.0, 0.3)
    args = trace_inputs(img, img, synthetic.default_K(W_, H_, fov_deg=80.0), np.eye(4), pose_t,
                        N_LANES, settings)
    with recorded_searches() as calls:
        trace_ops.trace_batch(*args, settings=settings, route="resident")
    (_, ops, kw), = calls
    return lambda: tk.epipolar_search(*ops, **kw)


def main(device=None) -> dict:
    from stereo_dso_g2o_tpu_torch import bench, default_device
    from stereo_dso_g2o_tpu_torch.config import default_settings
    from stereo_dso_g2o_tpu_torch.frontend.graph_system import FrameBundle

    dev = default_device(device)
    line = bench.device_line(dev)
    emit(line)
    out = {"backend": dev.type, "device": line.get("nvidia_smi", line.get("name", str(dev)))}

    # 1. tiny fetch round trip
    x = torch.zeros((), device=dev)
    out["fetch_scalar_ms"] = mean_ms(lambda: x.item(), dev, N)

    # 2. the frame bundle leaf by leaf, as _drain_one fetches it, vs packed
    bundle = frame_bundle(default_settings().window_cap, 6, dev)
    out["fetch_bundle_pytree_ms"] = mean_ms(
        lambda: FrameBundle(*[leaf.cpu().numpy() for leaf in bundle]), dev, N)
    n_flat = sum(leaf.numel() for leaf in bundle)
    packed = torch.zeros((n_flat,), dtype=torch.float32, device=dev)
    out["fetch_bundle_packed_ms"] = mean_ms(lambda: packed.cpu().numpy(), dev, N)
    out["bundle_n_leaves"] = len(bundle)
    out["bundle_n_floats"] = n_flat

    # 3. uploads from pageable host memory, and slicing a resident stack
    img = np.zeros((H_, W_), np.uint8)

    def upload():
        torch.as_tensor(img, device=dev)
        torch.as_tensor(img, device=dev)
        sync(dev)

    out["upload_stereo_pair_ms"] = mean_ms(upload, dev, N)
    imgs8 = np.zeros((8, 2, H_, W_), np.uint8)

    def upload8():
        torch.as_tensor(imgs8, device=dev)
        sync(dev)

    out["upload_8pair_batch_ms"] = mean_ms(upload8, dev, 5)
    big = torch.zeros((200, H_, W_), dtype=torch.uint8, device=dev)

    def slice17():
        big[17].clone()
        sync(dev)

    out["slice_resident_frame_ms"] = mean_ms(slice17, dev, N)

    # 4. trivial dispatch + sync, and the enqueue alone
    a = torch.zeros((8, 128), device=dev)

    def trivial():
        a + 1.0
        sync(dev)

    out["dispatch_sync_trivial_ms"] = mean_ms(trivial, dev, N)
    sync(dev)
    t0 = time.perf_counter()
    y = a
    for _ in range(N):
        y = y + 1.0
    out["dispatch_enqueue_ms"] = (time.perf_counter() - t0) / N * 1e3
    sync(dev)

    # 5. the host's cost of one search wrapper call
    search = search_call(dev)
    if dev.type == "cuda":
        search()
        sync(dev)
        host = sorted(busy_card_ms(search)[0] for _ in range(5))
        out["wrapper_enqueue_ms"] = host[len(host) // 2]
    else:
        out["wrapper_enqueue_ms"] = mean_ms(search, dev, 2)
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "bench_tunnel"))
