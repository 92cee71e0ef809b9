"""Worker processes of the tests that run the port over several
`torch.distributed` ranks on the CPU (`gloo`, rendezvous through a file).
This module imports torch and the port only, so a spawned rank starts
quickly; inputs and results travel as files in the test's temp directory.
"""

import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 240.0


def run_ranks(worker, world, tmp_path, *args, timeout=SPAWN_TIMEOUT_S):
    """Spawn `world` processes running `worker(rank, world, tmp, *args)` on a
    gloo group. A rank that fails writes its traceback to a file; a hung
    collective ends at `timeout` (every rank is then killed). Raises on
    either."""
    tmp = str(tmp_path)
    ctx = mp.spawn(_entry, args=(worker, world, tmp, args), nprocs=world, join=False)
    try:
        import time

        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{worker.__name__}: {world} ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
            if f.startswith("error_rank")]
    if errs:
        raise RuntimeError("\n".join(errs))


def _entry(rank, worker, world, tmp, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                                world_size=world, rank=rank)
        worker(rank, world, tmp, *args)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(tmp, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _load_window(tmp):
    from stereo_dso_g2o_tpu_torch import bridge

    data = np.load(os.path.join(tmp, "window.npz"))
    win = bridge.window_from_numpy({k[4:]: data[k] for k in data.files if k.startswith("win.")},
                                   device="cpu")
    return win, torch.from_numpy(data["dI_stack"])


def _window_arrays(win):
    return {f"win.{f.name}": getattr(win, f.name).numpy() for f in dataclasses.fields(win)}


def ba_steps(rank, world, tmp, settings, n_its):
    """`n_its` sharded BA iterations on the window of window.npz; rank 0
    writes the gathered window and the per-iteration scalars, every rank its
    own scalars (they must agree)."""
    from stereo_dso_g2o_tpu_torch.parallel import dist_ba

    win, dI = _load_window(tmp)
    sh = dist_ba.shard_window(win, rank, world)
    back = dist_ba.gather_window(sh)
    round_trip = all(
        torch.equal(getattr(back, f.name), getattr(win, f.name)) for f in dataclasses.fields(win)
    )
    step = dist_ba.sharded_ba_step(None, settings)
    scal = []
    for it in range(n_its):
        sh, e, conv, nres = step(sh, dI, it)
        scal.append((float(e), float(conv), float(nres)))
    full = dist_ba.gather_window(sh)
    np.savez(os.path.join(tmp, f"scalars_rank{rank}.npz"), scal=np.asarray(scal, np.float64),
             round_trip=round_trip, shard_np=sh.NP)
    if rank == 0:
        np.savez(os.path.join(tmp, "result.npz"), **_window_arrays(full))


def ba_fused(rank, world, tmp, settings, max_its):
    """The whole sharded GN loop; rank 0 writes the gathered window."""
    from stereo_dso_g2o_tpu_torch.parallel import dist_ba

    win, dI = _load_window(tmp)
    run = dist_ba.sharded_optimize_fused(None, settings, max_its)
    sh, energy, nres = run(dist_ba.shard_window(win, rank, world), dI)
    full = dist_ba.gather_window(sh)
    if rank == 0:
        np.savez(os.path.join(tmp, "result.npz"), energy=float(energy), nres=int(nres),
                 **_window_arrays(full))


def full_system_dist(rank, world, tmp, settings, calib_args, n_frames):
    """Every rank runs the same FullSystem (dist_ba_shards = world) over the
    frames of frames.npz; each writes its trajectory and window state."""
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib

    data = np.load(os.path.join(tmp, "frames.npz"))
    fs = FullSystem(make_calib(*calib_args, device="cpu"), settings, device="cpu")
    for i in range(n_frames):
        fs.add_frame(data["lefts"][i], data["rights"][i], i, timestamp=0.1 * i)
    np.savez(os.path.join(tmp, f"fs_rank{rank}.npz"), traj=np.stack(fs.trajectory()),
             state=fs.win.state.numpy(), pt_idepth=fs.win.pt_idepth.numpy(),
             n_kf=len(fs.kf_shells), lost=fs.is_lost)


def stereo_match_sharded(rank, world, tmp, settings):
    """Each rank matches its block of the sequence axis of match.npz."""
    from stereo_dso_g2o_tpu_torch.parallel.multiseq import sharded_stereo_match

    data = np.load(os.path.join(tmp, "match.npz"))
    S = data["us"].shape[0]
    per = S // world
    blk = slice(rank * per, (rank + 1) * per)
    T = torch.from_numpy
    step = sharded_stereo_match(None, settings)
    res, total = step(T(data["us"][blk]), T(data["vs"][blk]), T(data["valid"][blk]),
                      T(data["dI_l"][blk]), T(data["dI_r"][blk]), T(data["K"]),
                      T(data["baseline"]))
    np.savez(os.path.join(tmp, f"match_rank{rank}.npz"), total_good=int(total),
             **{k: getattr(res, k).numpy() for k in res._fields})
