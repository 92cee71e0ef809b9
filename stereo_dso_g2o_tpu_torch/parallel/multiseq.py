"""Data-parallel multi-sequence execution over several devices.

Port of `stereo_dso_g2o_tpu/parallel/multiseq.py`. The reference is a
single-process CPU program; its first scale-out axis (BASELINE config 4) is
plain data parallelism: many sequences tracked at once, one (or more) per
device. All engine state is fixed-capacity tensors that live where their
`FullSystem` was made, so there is no communication between devices in the
steady state; only diagnostics are summed over the ranks.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
from stereo_dso_g2o_tpu_torch.frontend.stereo_match import (
    StereoMatchResult,
    stereo_match_points,
)
from stereo_dso_g2o_tpu_torch.runtime import program


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The visible CUDA devices (the first `n_devices` of them): what the
    JAX module's device mesh becomes here, a list to place sequences on."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devs:
        raise RuntimeError("no CUDA device: give the devices by name to run on the CPU")
    return devs if n_devices is None else devs[:n_devices]


def sharded_stereo_match(group=None, settings: Settings = default_settings(), route=None):
    """A sequence-sharded stereo-match step over a `torch.distributed` group.

    Every rank calls step() with ITS block of the sequence axis:
      us, vs: (S, N); valid: (S, N); dI_left/right: (S, H, W, 3);
      K: (3, 3) and baseline: () are the same on every rank.
    Returns (StereoMatchResult with a leading axis S, this rank's block;
    total_good, the good points of all ranks, summed over the group).
    `group=None` is the default group; `route` as in `stereo_match_points`.
    On the card this rank's block is one program (`runtime/program.run`);
    the all-reduce runs after it, outside the graph."""

    def step(us, vs, valid, dI_l, dI_r, K, baseline):
        out, total_good = program.run(
            _match_block, (us, vs, valid, dI_l, dI_r, K, baseline),
            dict(settings=settings, route=route), key=(trace_ops.DEFAULT_ROUTE,))
        dist.all_reduce(total_good, op=dist.ReduceOp.SUM, group=group)
        return out, total_good

    return step


def _match_block(us, vs, valid, dI_l, dI_r, K, baseline, settings: Settings, route):
    """`stereo_match_points` over each sequence of a rank's block, stacked,
    and the block's count of good points."""
    res = [
        stereo_match_points(us[s], vs[s], valid[s], dI_l[s], dI_r[s], K, baseline,
                            settings=settings, route=route)
        for s in range(us.shape[0])
    ]
    out = StereoMatchResult(*[torch.stack(xs) for xs in zip(*res)])
    return out, torch.sum(out.good)


class MultiSequenceRunner:
    """BASELINE config 4: track many sequences in parallel, one per device.

    Each sequence owns a FullSystem whose tensors live on its own device
    (`devices[i % len(devices)]`; None: the visible CUDA devices). CUDA work
    is enqueued asynchronously, so the sequences pipeline against each
    other as far as their host code lets them; the host serializes the
    control flow. On a single device this still interleaves one sequence's
    device work with the host-side bookkeeping of the others.
    """

    def __init__(self, calibs, settings: Settings = default_settings(), devices=None):
        from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem

        if devices is None:
            devices = make_mesh()
        self.devices = [torch.device(devices[i % len(devices)]) for i in range(len(calibs))]
        self.systems = [
            FullSystem(calib, settings, device=dev) for calib, dev in zip(calibs, self.devices)
        ]

    def add_frames(self, frames, frame_id: int, timestamp: float = 0.0):
        """frames: list of (left, right) per sequence (None to skip one)."""
        for fs, pair in zip(self.systems, frames):
            if pair is None:
                continue
            fs.add_frame(pair[0], pair[1], frame_id, timestamp=timestamp)

    def trajectories(self):
        return [fs.trajectory() for fs in self.systems]
