"""Build the port's state from the JAX package's state given as numpy.

The caller turns the JAX pytrees into plain numpy (`np.asarray` over the
leaves, e.g. `{f.name: np.asarray(getattr(win, f.name)) for f in
dataclasses.fields(win)}`); this module never sees jax. With it, parity
tests run BA and the keyframe branch on real warmed state. Every function
here takes `device=None`, the GPU; the CPU tests pass `device="cpu"`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch import default_device
from stereo_dso_g2o_tpu_torch.backend.window import Window
from stereo_dso_g2o_tpu_torch.config import Settings
from stereo_dso_g2o_tpu_torch.frontend.full_system import FrameShell, FullSystem
from stereo_dso_g2o_tpu_torch.frontend.graph_system import GraphShell, GraphState, GraphSystem
from stereo_dso_g2o_tpu_torch.frontend.immature import ImmatureSet
from stereo_dso_g2o_tpu_torch.models.camera import Calib


def _tensor(x, device):
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.as_tensor(np.array(a, order="C"), device=device)  # keeps 0-d arrays 0-d


def settings_from_fields(fields: Dict[str, Any]) -> Settings:
    """Settings from a {field name: value} dict (e.g. dataclasses.asdict of
    the JAX package's Settings)."""
    names = {f.name for f in dataclasses.fields(Settings)}
    return Settings(**{k: v for k, v in fields.items() if k in names})


def calib_from_numpy(c, baseline, w: int, h: int, n_levels: int, device=None) -> Calib:
    device = default_device(device)
    return Calib(
        c=_tensor(np.asarray(c, np.float32), device),
        baseline=_tensor(np.float32(baseline), device),
        w=tuple(w >> l for l in range(n_levels)),
        h=tuple(h >> l for l in range(n_levels)),
    )


def window_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> Window:
    device = default_device(device)
    return Window(**{f.name: _tensor(arrays[f.name], device) for f in dataclasses.fields(Window)})


def immature_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> ImmatureSet:
    device = default_device(device)
    return ImmatureSet(
        **{f.name: _tensor(arrays[f.name], device) for f in dataclasses.fields(ImmatureSet)}
    )


def full_system_from_snapshot(snap: Dict[str, Any], calib: Calib, settings: Settings,
                              device=None, uniform=None) -> FullSystem:
    """A port FullSystem carrying the JAX FullSystem's state.

    snap keys: `win`, `imm` (numpy field dicts), `tracker_ref` (per-level
    5-tuples of numpy arrays), `tracker_ref_aff`, `tracker_ref_exposure`,
    `tracker_first_coarse_rmse`, `tracker_ref_frame_id`, `dI_slots`
    (per-slot tuples of per-level (H,W,3) arrays or None), `right_slots`,
    `history` (list of FrameShell field dicts; KF shells are shared by
    frame id), and the host scalars `kf_slots`, `slot_frame_id`,
    `slot_meta`, `kf_out_count`, `current_min_act_dist`,
    `last_coarse_rmse`, `next_kf_id`, `initialized`, `is_lost`,
    `init_failed`, `selector_potential`, `selector_calls`."""
    device = default_device(device)
    fs = FullSystem(calib, settings, device=device, uniform=uniform)
    fs.win = window_from_numpy(snap["win"], device)
    fs.imm = immature_from_numpy(snap["imm"], device)
    fs.tracker.ref = [tuple(_tensor(x, device) for x in lvl) for lvl in snap["tracker_ref"]]
    fs.tracker.ref_aff = _tensor(np.asarray(snap["tracker_ref_aff"], np.float32), device)
    fs.tracker.ref_exposure = float(snap["tracker_ref_exposure"])
    fs.tracker.first_coarse_rmse = float(snap["tracker_first_coarse_rmse"])
    fs.tracker.ref_frame_id = int(snap["tracker_ref_frame_id"])
    fs.dI_slots = [
        None if p is None else tuple(_tensor(x, device) for x in p) for p in snap["dI_slots"]
    ]
    fs.right_slots = [None if r is None else _tensor(r, device) for r in snap["right_slots"]]
    shells = [FrameShell(**copy.deepcopy(h)) for h in snap["history"]]
    fs.history = shells
    fs.kf_shells = sorted([s for s in shells if s.is_kf], key=lambda s: s.id)
    fs.kf_slots = list(snap["kf_slots"])
    fs.slot_frame_id = dict(snap["slot_frame_id"])
    fs.slot_meta = {k: (v[0], np.asarray(v[1], np.float64)) for k, v in snap["slot_meta"].items()}
    fs.kf_out_count = np.asarray(snap["kf_out_count"], np.int64).copy()
    fs.current_min_act_dist = float(snap["current_min_act_dist"])
    fs.last_coarse_rmse = np.asarray(snap["last_coarse_rmse"], np.float64).copy()
    fs.next_kf_id = int(snap["next_kf_id"])
    fs.initialized = bool(snap["initialized"])
    fs.is_lost = bool(snap["is_lost"])
    fs.init_failed = bool(snap["init_failed"])
    fs.selector.current_potential = int(snap["selector_potential"])
    fs.selector._calls = int(snap["selector_calls"])
    return fs


def graph_state_from_numpy(snap: Dict[str, Any], device=None) -> GraphState:
    """A port GraphState from the JAX GraphState given as numpy: `win`,
    `imm` (field dicts), `ref` (per-level 5-tuples), `dI0_slots`
    (F, H, W, 3) and `scalars` (every other GraphState field by name)."""
    device = default_device(device)
    sc = {k: _tensor(v, device) for k, v in snap["scalars"].items()}
    return GraphState(
        win=window_from_numpy(snap["win"], device),
        imm=immature_from_numpy(snap["imm"], device),
        ref=tuple(tuple(_tensor(x, device) for x in lvl) for lvl in snap["ref"]),
        dI0_slots=_tensor(snap["dI0_slots"], device),
        **sc,
    )


def graph_system_from_snapshot(snap: Dict[str, Any], calib: Calib, settings: Settings,
                               device=None, uniform=None) -> GraphSystem:
    """A port GraphSystem carrying the JAX GraphSystem's state. snap keys:
    those of `graph_state_from_numpy`, plus `history` (GraphShell field
    dicts with `is_kf` and `T_cw`), `kf_shells` (the same, by keyframe id:
    the JAX system keeps them apart from `history`), `slot_frame_id`, `pot`,
    `is_lost`."""
    device = default_device(device)

    def shell(h):
        g = GraphShell(h["id"], h["timestamp"], np.array(h["T_cam_to_ref"]), h["ref_kf_id"],
                       np.array(h["aff"]))
        g.is_kf = bool(h["is_kf"])
        g.T_cw = None if h["T_cw"] is None else np.array(h["T_cw"])
        return g

    gs = GraphSystem(
        calib, settings, graph_state_from_numpy(snap, device),
        [shell(h) for h in snap["history"]], [shell(h) for h in snap["kf_shells"]],
        snap["slot_frame_id"], pot=int(snap["pot"]), uniform=uniform,
    )
    gs.is_lost = bool(snap["is_lost"])
    return gs
