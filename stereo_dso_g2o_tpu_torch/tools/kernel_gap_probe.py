"""The epipolar search standalone on a real state's live pool, against
synthetic lanes of the same count, and against its own time inside a frame.

Port of `tools/kernel_gap_probe.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.kernel_gap_probe [frames=30]
        [small=0] [device=cuda|cpu]

bench.py's sequence 0 is bootstrapped and run through the graph path to
frame `frames`. The live immature rows of its state are gathered into the
compact pool as the non-keyframe trace gathers them
(`immature._compact_live`), with per-lane `KRKi`, `Kt` and `aff` built from
the window's poses and the tracking reference's slot as the JAX tool builds
them (`production_lanes`), traced onto frame `frames`. Keys, as the JAX
tool's: `n_lanes`, `n_status_oob`, `n_uninit_maxinf`;
`standalone_production_data_ms`, `standalone_synthetic_data_ms` (the same
count of lanes drawn with `np.random.default_rng(1)`, status
UNINITIALIZED), `standalone_inf_interval_ms` (those with idepth_max = inf):
`trace_batch` on each; `direct_kernel_resident1_ms` (K1) and
`direct_kernel_resident0_ms` (K2): the kernels called directly on the
operands `trace_batch` built for the production lanes (where the JAX tool
built microbench-style slab origins, which have no counterpart), and
`direct_kernel_100reps_ms_each`, K1 enqueued 100 times with one
synchronize. Each `_ms` is a host-clock mean (10 calls, one synchronize
at the end, as the JAX tool times: `_common.mean_ms`) and has a
`_device_ms` twin from `_common.cuda_ms` (`direct_kernel_100reps_device_ms_each`; None on the
CPU). The port's own keys answer the JAX tool's question, standalone
against in-program, on this device: `in_frame_k1_us_mean`, K1's mean
device time a launch inside frames `frames + 1` to `frames + 5` from
torch.profiler, over `in_frame_k1_launches` launches (None on the CPU).
On the card those frames replay the track program (`runtime/program.py`);
K1 is a node at its top level, never inside a WHILE or IF node
(`utils/loop` raises if it were), so the profiler records every launch.
`chip_smoke.py` also holds both kernels to the plain version on these
lanes (`probe` returns them).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.tools._common import (
    bootstrap, cli, device_launches, device_ms, emit, flag, mean_ms, profiled,
    recorded_searches, search_kernel, sequence, sync,
)

KEYS = ("frames", "small", "device")
IN_FRAME = 5  # frames traced for K1's time inside a frame


def production_lanes(imm, frame_valid, w2c, ref_slot: int, K, Ki, settings) -> dict:
    """The live compact pool of `imm` (fields of `immature._compact_live`)
    with per-lane `KRKi`, `Kt` and `aff` (1, 0): each host slot's transform
    to the pose of window slot `ref_slot`, as `tools/kernel_gap_probe.py`
    builds them."""
    from stereo_dso_g2o_tpu_torch.frontend import immature as IMM

    T_new = w2c[ref_slot]
    T_hn = torch.einsum("ij,fjk->fik", T_new, torch.linalg.inv(w2c))
    KRKi = torch.einsum("ij,fjk,kl->fil", K, T_hn[:, :3, :3], Ki)
    Kt = torch.einsum("ij,fj->fi", K, T_hn[:, :3, 3])
    aff = torch.zeros((w2c.shape[0], 2), dtype=w2c.dtype, device=w2c.device)
    aff[:, 0] = 1.0
    flat, _ = IMM._compact_live(imm, frame_valid, settings)
    host = flat["host"]
    return dict(flat, KRKi=KRKi[host], Kt=Kt[host], aff=aff[host])


def _trace_args(a, dI):
    return (a["u"], a["v"], a["idepth_min"], a["idepth_max"], a["color"], a["weights"],
            a["gradH"], a["energy_th"], a["quality"], a["status"], a["KRKi"], a["Kt"],
            a["aff"], dI)


def probe(frames=30, small=False, device=None):
    """(the JSON line, the operands and keywords of K1's call on the
    production lanes)."""
    from stereo_dso_g2o_tpu_torch.bench import BOOT
    from stereo_dso_g2o_tpu_torch.ops import trace as T
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
    from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid

    frames = int(frames)
    dev, cfg, settings, calib, lefts, rights, _ = sequence(
        0, frames + IN_FRAME + 1, flag(small), None, device)
    gs = bootstrap(calib, settings, lefts, rights, dev)
    for i in range(BOOT, frames):
        gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs.flush()
    state, win = gs.state, gs.state.win
    dI_new = build_pyramid(lefts[frames].float(), 1)[0][0]
    prod = production_lanes(state.imm, win.frame_valid, win.w2c(), int(state.ref_slot),
                            calib.K(0), calib.Ki(0), settings)
    N = prod["u"].shape[0]
    rep = {"backend": str(dev), "n_lanes": int(N),
           "n_status_oob": int((prod["status"] == T.IPS_OOB).sum()),
           "n_uninit_maxinf": int((~torch.isfinite(prod["idepth_max"])).sum())}

    def timeit(key, fn, reps=10, each=""):
        rep[f"{key}_ms{each}"] = mean_ms(fn, dev, reps)
        rep[f"{key}_device_ms{each}"] = device_ms(fn, dev)
        emit({"progress": key, "ms": rep[f"{key}_ms{each}"],
              "device_ms": rep[f"{key}_device_ms{each}"]})

    def run(a):
        return T.trace_batch(*_trace_args(a, dI_new), settings=settings)

    timeit("standalone_production_data", lambda: run(prod))
    rng = np.random.default_rng(1)
    H, W = dI_new.shape[:2]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    syn = dict(prod, u=f32(rng.uniform(16, W - 16, N)), v=f32(rng.uniform(16, H - 16, N)))
    idt = rng.uniform(1 / 40.0, 1 / 5.0, N).astype(np.float32)
    syn.update(idepth_min=f32(idt * 0.7), idepth_max=f32(idt * 1.5),
               status=torch.full((N,), T.IPS_UNINITIALIZED, dtype=torch.int32, device=dev))
    timeit("standalone_synthetic_data", lambda: run(syn))
    inf = dict(syn, idepth_max=torch.full((N,), float("inf"), device=dev))
    timeit("standalone_inf_interval", lambda: run(inf))

    with recorded_searches() as calls:
        run(prod)
    (_, ops, kw), = calls
    timeit("direct_kernel_resident1", lambda: tk.epipolar_search(*ops, **kw))
    timeit("direct_kernel_resident0", lambda: tk.epipolar_search_slab(*ops, **kw))
    timeit("direct_kernel_100reps", lambda: tk.epipolar_search(*ops, **kw), 100, "_each")

    # K1 inside the frame program: frame `frames` untraced, the next IN_FRAME traced
    gs.add_frame(lefts[frames], rights[frames], frames, timestamp=0.1 * frames)
    sync(dev)
    with profiled(dev, host=False) as prof:
        for i in range(frames + 1, frames + 1 + IN_FRAME):
            gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        gs.flush()
        sync(dev)
    k1 = [us for name, us in device_launches(prof) if search_kernel(name) == "epipolar_search"]
    rep["in_frame_k1_launches"] = len(k1) if dev.type == "cuda" else None
    rep["in_frame_k1_us_mean"] = float(np.mean(k1)) if k1 else None
    return rep, (ops, kw)


def main(frames=30, small=False, device=None) -> dict:
    out, _ = probe(frames, small, device)
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "kernel_gap_probe"))
