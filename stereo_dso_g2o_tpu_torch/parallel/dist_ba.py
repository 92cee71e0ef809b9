"""Distributed windowed bundle adjustment (BASELINE config 5).

Port of `stereo_dso_g2o_tpu/parallel/dist_ba.py`. The reference's window
Hessian assembly is a sum over independent (host, target) pair blocks
(AccumulatedTopHessian::stitchDouble, AccumulatedTopHessian.cpp:201-229):
an all-reduce. The JAX module shards the point axis over a device mesh with
`shard_map` and `psum`s the reduced camera system; here every rank of a
`torch.distributed` process group holds one contiguous block of the point
axis (and with it of the residual cube and the Jacobians), linearizes its
own points, builds partial pair-block sums, and the (CPARS+8F)^2 camera
system is all-reduced over the group. The small dense solve is replicated,
the idepth back-substitution is local again. Keyframe state, images and the
marginal prior stay replicated: every rank runs the same program on the
same frames, and only the point work is split.

One rank drives one device: `nccl` for CUDA tensors, `gloo` for CPU
tensors. The caller initializes the process group (address, world size and
rank are its own to give) and passes the group in; `None` is the default
group. One iteration all-reduces H (68x68 at F = 8) and b (68) of the top
accumulation and of the Schur part, and five scalars; the GN loop adds one
more for its stop flag.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from stereo_dso_g2o_tpu_torch.backend import ba
from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import Settings, default_settings

# Window fields sharded along the point axis; everything else replicated.
_POINT_FIELDS = {
    "pt_status", "pt_host", "pt_u", "pt_v", "pt_idepth", "pt_idepth_zero",
    "pt_color", "pt_weights", "pt_has_prior", "pt_energy_th",
    "pt_num_good_res", "pt_max_rel_baseline", "pt_idepth_hessian",
    "res_exists", "res_state", "res_energy", "res_linearized", "res_to_zero",
    "res_new_state", "res_new_energy_wo", "res_center",
    "J_resF", "J_pdxi", "J_pdc", "J_pdd", "J_Idx", "J_abF",
}


def all_reduce_sum(group=None):
    """The `reduce=` callable of `ba.ba_iteration`: sums a tensor over the
    ranks of `group`. Integer counts are summed as integers."""

    def reduce(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    return reduce


def shard_window(win: W.Window, rank: int, world: int) -> W.Window:
    """The rank's contiguous block of every point field; the rest whole."""
    if win.NP % world:
        raise ValueError(f"point capacity {win.NP} is not divisible by {world} shards")
    per = win.NP // world
    lo = rank * per
    return win.replace(**{name: getattr(win, name)[lo:lo + per] for name in _POINT_FIELDS})


def gather_window(win_shard: W.Window, group=None) -> W.Window:
    """Inverse of `shard_window`: every rank gets the whole window back
    (`all_gather` on the point fields, in rank order)."""
    world = dist.get_world_size(group)
    out = {}
    for f in dataclasses.fields(win_shard):
        if f.name not in _POINT_FIELDS:
            continue
        v = getattr(win_shard, f.name)
        # bool travels as uint8: not every backend gathers bool
        send = (v.to(torch.uint8) if v.dtype == torch.bool else v).contiguous()
        parts = [torch.empty_like(send) for _ in range(world)]
        dist.all_gather(parts, send, group=group)
        out[f.name] = torch.cat(parts, dim=0).to(v.dtype)
    return win_shard.replace(**out)


def sharded_ba_step(group=None, settings: Settings = default_settings()):
    """A distributed BA iteration over `group`.

    Returns step(win_shard, dI_stack, iteration) -> (win_shard, energy,
    converged, nres), `win_shard` being this rank's `shard_window`; energy,
    converged and nres are the whole window's, equal on every rank."""
    reduce = all_reduce_sum(group)

    def step(win_shard: W.Window, dI_stack, iteration: int):
        return ba.ba_iteration(win_shard, dI_stack, iteration, settings=settings, reduce=reduce)

    return step


def sharded_optimize_fused(group=None, settings: Settings = default_settings(),
                           max_its: int = 6):
    """The whole GN loop over `group`: `ba.optimize_fused` with the group's
    sum as its `reduce`, so the loop and its stop rule exist once.

    Returns run(win_shard, dI_stack) -> (win_shard, energy, nres)."""
    reduce = all_reduce_sum(group)

    def run(win_shard: W.Window, dI_stack):
        return ba.optimize_fused(win_shard, dI_stack, settings=settings, max_its=max_its,
                                 reduce=reduce)

    return run
