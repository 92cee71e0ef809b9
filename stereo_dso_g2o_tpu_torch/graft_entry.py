"""Driver entry points: one windowed-BA iteration on a small window, and a
dry run of the distributed paths over n ranks.

Port of the repository's `__graft_entry__.py`. `entry()` gives the one
Gauss-Newton iteration (FEJ linearization, adjoint Hessian stitch, Schur
over inverse depths, solve, back-substitution) with its example inputs.
`dryrun_multichip(n)` runs, on a `torch.distributed` group of n ranks (the
JAX device mesh): the point-sharded BA at production shape, asserted
against the single-process BA, then the sequence-sharded stereo match over
n rendered sequences, asserted against their known geometry. The ranks
are `nccl` processes, one per card, or `gloo` processes on the CPU.
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile
import time
import traceback

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch import default_device

DRYRUN_TIMEOUT_S = 600.0


def _rendered_window(settings, device, K, w, h, f_cap, n_cap, n_pts, shift, n_frames, n_pad):
    """`n_frames` keyframes of default_scene(0), frame i translated by
    i * shift; `n_pts` points hosted in frame 0 at seeded pixels with their
    rendered inverse depth, with residuals to every other frame. Returns
    (window, the frames' level-0 pyramids followed by `n_pad` zero images)."""
    from stereo_dso_g2o_tpu_torch.backend import builder
    from stereo_dso_g2o_tpu_torch.backend import window as Wb
    from stereo_dso_g2o_tpu_torch.io import synthetic
    from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
    from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid

    rng = np.random.default_rng(0)
    scene = synthetic.default_scene(0)
    win = Wb.empty_window(f_cap, n_cap, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=device)
    dIs = []
    for i in range(n_frames):
        T = np.eye(4)
        T[:3, 3] = np.asarray(shift) * i
        img, idep = synthetic.render(scene, K, w, h, T)
        dIs.append(build_pyramid(torch.as_tensor(img, device=device), 1)[0][0])
        win = builder.insert_frame(win, i, T, (0.0, 0.0), 1.0, i)
        if i == 0:
            idepth0 = idep
    dI_stack = torch.stack(dIs + [torch.zeros_like(dIs[0])] * n_pad)
    us = rng.integers(8, w - 8, n_pts).astype(np.float32)
    vs = rng.integers(8, h - 8, n_pts).astype(np.float32)
    ids = idepth0[vs.astype(int), us.astype(int)]
    ut, vt = torch.as_tensor(us, device=device), torch.as_tensor(vs, device=device)
    color, weights, _, eth = trace_ops.extract_point_data(dIs[0], ut, vt, settings)
    idx = torch.arange(n_pts, device=device)
    win = builder.insert_points(win, idx, 0, ut, vt, torch.as_tensor(ids, device=device),
                                color, weights, eth)
    for tgt in range(1, n_frames):
        win = builder.add_residuals(win, idx, tgt)
    return win, dI_stack


def entry(device=None):
    """(fn, example_args): fn(win, dI_stack, iteration) is one
    `ba.ba_iteration` on a 4-frame, 128-point window of 3 rendered 128x64
    frames. device=None: the GPU (`default_device`)."""
    from stereo_dso_g2o_tpu_torch.backend import ba
    from stereo_dso_g2o_tpu_torch.config import default_settings
    from stereo_dso_g2o_tpu_torch.io import synthetic

    dev = default_device(device)
    settings = default_settings()
    w, h = 128, 64
    win, dI_stack = _rendered_window(settings, dev, synthetic.default_K(w, h), w, h, f_cap=4,
                                     n_cap=128, n_pts=128, shift=(0.05, 0.0, 0.03), n_frames=3,
                                     n_pad=1)

    def fn(win, dI_stack, iteration):
        return ba.ba_iteration(win, dI_stack, iteration, settings=settings)

    return fn, (win, dI_stack, 0)


def production_window(settings, device):
    """Stage (a)'s window: F = 8 (the reference's 7 keyframes and the
    incoming frame), 7 rendered 1216x352 frames, a 2048-point capacity with
    1337 valid points (not a multiple of any rank count: masked points land
    unevenly across the shards)."""
    from stereo_dso_g2o_tpu_torch.io import synthetic

    w, h = 1216, 352
    return _rendered_window(settings, device, synthetic.default_K(w, h, fov_deg=80.0), w, h,
                            f_cap=8, n_cap=2048, n_pts=1337, shift=(0.05, -0.01, 0.08),
                            n_frames=7, n_pad=2)


def _stage_ba(rank, world, dev, settings):
    """(a) the point-sharded BA iteration against the single-process one."""
    from stereo_dso_g2o_tpu_torch.backend import ba
    from stereo_dso_g2o_tpu_torch.parallel import dist_ba

    win, dI_stack = production_window(settings, dev)
    step = dist_ba.sharded_ba_step(None, settings)
    win_d, energy_d, _, nres_d = step(dist_ba.shard_window(win, rank, world), dI_stack, 0)
    st_d = dist_ba.gather_window(win_d).state
    win_r, energy_r, _, nres_r = ba.ba_iteration(win, dI_stack, 0, settings=settings)
    e_d, e_r, n_d, n_r = float(energy_d), float(energy_r), int(nres_d), int(nres_r)
    assert n_d == n_r, f"distributed BA nres {n_d} != single-process {n_r}"
    assert abs(e_d - e_r) <= 1e-3 * max(abs(e_r), 1.0), (
        f"distributed BA energy {e_d} != single-process {e_r}")
    # the all-reduce sums in another order than the single-process sum and
    # the solve amplifies that; a dropped reduction fails by far more
    assert torch.allclose(st_d, win_r.state, atol=5e-3, rtol=0), (
        "distributed BA state step diverged from the single-process solver")
    return dict(energy=e_r, nres=n_r, max_state_diff=float((st_d - win_r.state).abs().max()))


def _stage_stereo_match(rank, world, dev, settings):
    """(b) the sequence-sharded stereo match: one rendered plane pair per
    sequence, sequence r on rank r."""
    import torch.distributed as dist

    from stereo_dso_g2o_tpu_torch.io import synthetic
    from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
    from stereo_dso_g2o_tpu_torch.parallel.multiseq import sharded_stereo_match

    S, w, h, n, bl = world, 96, 48, 64, 0.1
    rng = np.random.default_rng(0)
    K = synthetic.default_K(w, h)
    us = rng.uniform(8, w - 8, (S, n)).astype(np.float32)[rank:rank + 1]
    vs = rng.uniform(8, h - 8, (S, n)).astype(np.float32)[rank:rank + 1]
    scene = synthetic.PlaneScene(
        normal=np.array([0.1 * (rank % 3 - 1), -0.05, -1.0]), dist=-4.0 - 0.5 * rank,
        tex=synthetic.smooth_texture(np.random.default_rng(rank), 256),
    )
    left, right, idep = synthetic.render_stereo_pair(scene, K, w, h, bl)
    dI_l, dI_r = (build_pyramid(torch.as_tensor(im, device=dev), 1)[0][0][None]
                  for im in (left, right))
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    res, total = sharded_stereo_match(None, settings)(
        T(us), T(vs), torch.ones((1, n), dtype=torch.bool, device=dev), dI_l, dI_r,
        T(np.asarray(K, np.float32)), torch.tensor(bl, dtype=torch.float32, device=dev))
    good = res.good[0].cpu().numpy()
    est = res.idepth[0].cpu().numpy()
    gt = idep[vs[0].astype(int), us[0].astype(int)]
    errs = torch.zeros((S,), dtype=torch.float64, device=dev)
    if good.any():
        errs[rank] = float(np.median(np.abs(est[good] - gt[good]) / gt[good]))
    has = torch.zeros((S,), dtype=torch.float64, device=dev)
    has[rank] = float(good.any())
    dist.all_reduce(errs)
    dist.all_reduce(has)
    errs = errs[has > 0].cpu().numpy()
    assert int(total) > 0.3 * S * n, (
        f"data-parallel stereo match found too few matches: {int(total)}")
    assert errs.size and float(np.median(errs)) < 0.1, (
        f"stereo-matched idepth off by {np.median(errs):.3f} rel median")
    return dict(total_good=int(total), median_rel_err=float(np.median(errs)))


def _dryrun_rank(rank, world, tmp, device_type):
    """One rank of `dryrun_multichip`; rank 0 writes what the stages
    measured, a failing rank its traceback."""
    import torch.distributed as dist

    from stereo_dso_g2o_tpu_torch.config import default_settings
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda

    try:
        if device_type == "cuda":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
            kw = dict(backend="nccl", device_id=dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
            kw = dict(backend="gloo")
        dist.init_process_group(init_method=f"file://{tmp}/rendezvous", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=DRYRUN_TIMEOUT_S),
                                **kw)
        try:
            settings = default_settings()
            out = dict(ba=_stage_ba(rank, world, dev, settings),
                       stereo_match=_stage_stereo_match(rank, world, dev, settings))
            out["launches"] = [trace_cuda.LAUNCHES, trace_cuda.LAUNCHES_SLAB]
            dist.barrier()
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def dryrun_multichip(n_devices: int, device=None, timeout: float = DRYRUN_TIMEOUT_S) -> dict:
    """Run the distributed paths on `n_devices` ranks and assert them:

    1. the point-sharded windowed-BA step at production shape (F = 8,
       1216x352, 1337 of 2048 points) against single-process `ba_iteration`:
       nres equal, energy within 1e-3 relative, state within 5e-3;
    2. the sequence-sharded stereo match over n_devices rendered sequences:
       more than 0.3 of the points good, median relative inverse-depth
       error under 0.1.

    device=None: the GPU, one `nccl` rank per card (n_devices must not
    exceed the cards there are); "cpu": `gloo` ranks. The ranks are spawned
    processes, all ended by `timeout` seconds. Returns rank 0's numbers,
    with the epipolar kernels' launches in its process (`launches`: the
    resident and the slab kernel's)."""
    import torch.multiprocessing as mp

    dev = default_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}): one rank per card, and this machine "
                         f"has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_dryrun_rank, args=(n_devices, tmp, dev.type), nprocs=n_devices,
                       join=False)
        deadline = time.monotonic() + timeout
        try:
            while True:
                try:
                    if ctx.join(timeout=1.0):
                        break
                except (mp.ProcessRaisedException, mp.ProcessExitedException):
                    break  # its traceback is in its error file
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun_multichip: {n_devices} ranks did not finish in "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                if f.startswith("error_rank")]
        if errs:
            raise RuntimeError("dryrun_multichip failed:\n" + "\n".join(errs))
        result = os.path.join(tmp, "result.json")
        if not os.path.exists(result):  # a rank died before its own code ran
            raise RuntimeError(f"dryrun_multichip: the ranks ended with exit codes "
                               f"{[p.exitcode for p in ctx.processes]} and no result")
        with open(result) as f:
            return json.load(f)
