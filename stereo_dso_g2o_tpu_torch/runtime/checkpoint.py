"""Mid-run checkpoint / resume.

Port of `stereo_dso_g2o_tpu/runtime/checkpoint.py`. The reference has no
state persistence: its only artifact is the final trajectory file. All
device state of a `FullSystem` is two fixed-capacity dataclasses of tensors
(Window + ImmatureSet), the keyframes' pyramids and the tracking reference,
plus small host metadata, so a checkpoint is one npz and one pickle, and
resume is exact: the restored system goes on to the same trajectory, bit
for bit.

The two files carry the JAX module's names: `<path>.npz` holds `win.*`,
`imm.*`, `dI.<slot>.<lvl>`, `right.<slot>`, `ref.<lvl>.<j>`; `<path>.meta`
is a pickled dict with the JAX module's keys. This module adds what only
this package's `FullSystem` holds (`init_failed`,
`n_frame_marginalizations`, and frame 0's pyramids `first.*` while the
first keyframe is not made yet). The pickle names this package's classes
(`FrameShell`, `Settings`), so each package reads its own `.meta`; the
arrays of either are read by `read_arrays`.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch import default_device

if TYPE_CHECKING:
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _fields_to_dict(obj, prefix):
    return {prefix + f.name: _host(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _dict_to_fields(cls, data, prefix, tensor):
    return cls(**{f.name: tensor(data[prefix + f.name]) for f in dataclasses.fields(cls)})


def save(fs: "FullSystem", path: str):
    """Write <path>.npz (device state) and <path>.meta (host state)."""
    arrays = {}
    arrays.update(_fields_to_dict(fs.win, "win."))
    arrays.update(_fields_to_dict(fs.imm, "imm."))
    for slot, pyr in enumerate(fs.dI_slots):
        if pyr is not None:
            for lvl, p in enumerate(pyr):
                arrays[f"dI.{slot}.{lvl}"] = _host(p)
    for slot, r in enumerate(fs.right_slots):
        if r is not None:
            arrays[f"right.{slot}"] = _host(r)
    if fs.tracker.ref is not None:
        for lvl, tup in enumerate(fs.tracker.ref):
            for j, a in enumerate(tup):
                arrays[f"ref.{lvl}.{j}"] = _host(a)
    # frame 0 waits in first_pair until the second frame makes the first
    # keyframe from it; afterwards nothing reads it
    first_exposure = None
    if fs.first_pair is not None and not fs.kf_slots:
        dIpL, dIpR, asgL, first_exposure = fs.first_pair
        for name, pyr in (("L", dIpL), ("R", dIpR), ("asg", asgL)):
            for lvl, p in enumerate(pyr):
                arrays[f"first.{name}.{lvl}"] = _host(p)
    np.savez_compressed(path + ".npz", **arrays)

    meta = dict(
        history=fs.history,
        kf_shells=fs.kf_shells,
        kf_slots=fs.kf_slots,
        slot_frame_id=fs.slot_frame_id,
        slot_meta=fs.slot_meta,
        kf_out_count=fs.kf_out_count,
        current_min_act_dist=fs.current_min_act_dist,
        last_coarse_rmse=fs.last_coarse_rmse,
        next_kf_id=fs.next_kf_id,
        stats_n_frames=fs.stats_n_frames,
        initialized=fs.initialized,
        is_lost=fs.is_lost,
        init_failed=fs.init_failed,
        n_frame_marginalizations=fs.n_frame_marginalizations,
        first_exposure=first_exposure,
        tracker=dict(
            ref_aff=_host(fs.tracker.ref_aff),
            ref_exposure=fs.tracker.ref_exposure,
            ref_frame_id=fs.tracker.ref_frame_id,
            first_coarse_rmse=fs.tracker.first_coarse_rmse,
            n_ref_levels=len(fs.tracker.ref) if fs.tracker.ref else 0,
        ),
        selector_pot=fs.selector.current_potential,
        selector_seed=fs.selector._seed,
        selector_calls=fs.selector._calls,
        settings=fs.settings,
    )
    with open(path + ".meta", "wb") as f:
        pickle.dump(meta, f)


def read_arrays(fs: "FullSystem", data, n_ref_levels: int, tensor: Callable):
    """Put the arrays of a checkpoint's npz (`data`: name -> numpy array, of
    this module's `save` or of the JAX module's) into `fs`: window, immature
    set, per-slot pyramids, the tracking reference. `tensor` turns one
    numpy array into a tensor on the system's device."""
    from stereo_dso_g2o_tpu_torch.backend import window as W
    from stereo_dso_g2o_tpu_torch.frontend import immature as IMM

    fs.win = _dict_to_fields(W.Window, data, "win.", tensor)
    fs.imm = _dict_to_fields(IMM.ImmatureSet, data, "imm.", tensor)
    n_lvl = fs.calib.n_levels
    for slot in range(fs.win.F):
        if f"dI.{slot}.0" in data:
            fs.dI_slots[slot] = tuple(tensor(data[f"dI.{slot}.{lvl}"]) for lvl in range(n_lvl))
        if f"right.{slot}" in data:
            fs.right_slots[slot] = tensor(data[f"right.{slot}"])
    if n_ref_levels:
        fs.tracker.ref = [
            tuple(tensor(data[f"ref.{lvl}.{j}"]) for j in range(5))
            for lvl in range(n_ref_levels)
        ]


def load(path: str, calib, device=None, uniform: Optional[Callable] = None) -> "FullSystem":
    """The system `save` wrote, on `device` (None: the GPU). `uniform` is
    the selector's thinning draw, which is code and not saved: give the one
    the saved system ran with."""
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem

    device = default_device(device)
    with open(path + ".meta", "rb") as f:
        meta = pickle.load(f)

    def tensor(a):
        return torch.as_tensor(np.array(a), device=device)  # np.array keeps 0-d arrays 0-d

    fs = FullSystem(calib, meta["settings"], device=device, uniform=uniform)
    tm = meta["tracker"]
    with np.load(path + ".npz") as data:
        read_arrays(fs, data, tm["n_ref_levels"], tensor)
        if meta["first_exposure"] is not None:
            n_lvl = calib.n_levels
            fs.first_pair = tuple(
                tuple(tensor(data[f"first.{name}.{lvl}"]) for lvl in range(n_lvl))
                for name in ("L", "R", "asg")
            ) + (meta["first_exposure"],)
    for key in ("history", "kf_shells", "kf_slots", "slot_frame_id", "slot_meta", "kf_out_count",
                "current_min_act_dist", "last_coarse_rmse", "next_kf_id", "stats_n_frames",
                "initialized", "is_lost", "init_failed", "n_frame_marginalizations"):
        setattr(fs, key, meta[key])

    fs.tracker.ref_aff = tensor(np.asarray(tm["ref_aff"], np.float32))
    fs.tracker.ref_exposure = tm["ref_exposure"]
    fs.tracker.ref_frame_id = tm["ref_frame_id"]
    fs.tracker.first_coarse_rmse = tm["first_coarse_rmse"]
    fs.selector.current_potential = meta["selector_pot"]
    # the selection salt counter must survive or the resumed run seeds other
    # immature points than the uninterrupted one
    fs.selector._seed = meta["selector_seed"]
    fs.selector._calls = meta["selector_calls"]
    return fs
