"""Window construction/bookkeeping (the FullSystem's insert ops).

Port of `stereo_dso_g2o_tpu/backend/builder.py`: functional updates of the
Window for EnergyFunctional::insertFrame/insertPoint/insertResidual and
FrameHessian::setEvalPT_scaled.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import SCALE_A, SCALE_B
from stereo_dso_g2o_tpu_torch.utils.fixed import constant
from stereo_dso_g2o_tpu_torch.utils.tree import at_rows


def _value(val, like: torch.Tensor) -> torch.Tensor:
    """`val` as a tensor of `like`'s type on its device: a tensor as it is,
    a Python number once per device (`utils/fixed.constant`), host arrays
    (the host `FullSystem`'s) copied."""
    if isinstance(val, torch.Tensor):
        return val.to(dtype=like.dtype, device=like.device)
    if isinstance(val, (bool, int, float)):
        return constant(val, like.dtype, like.device)
    return torch.as_tensor(val, dtype=like.dtype, device=like.device)


def _set_row(x, idx, val):
    out = x.clone()
    out[idx] = _value(val, x)
    return out


def _set_at(x, slot, val):
    """x with row slot[n] of every sequence n set to val (val per sequence
    or one for all)."""
    out = x.clone()
    out[torch.arange(x.shape[0], device=x.device), slot] = _value(val, x)
    return out


def _many(slot) -> bool:
    return isinstance(slot, torch.Tensor) and slot.dim() == 1


def insert_frame(win: W.Window, slot, T_w2c, aff, exposure,
                 frame_id, energy_th: float = 8 * 12.0 * 12.0) -> W.Window:
    """Insert a keyframe at `slot` with FEJ pose T_w2c (setEvalPT_scaled:
    pose part of the state zero, ab part set, state_zero = state). T_w2c,
    aff and exposure are host values (numpy, floats) or tensors on the
    window's device; tensors are not read back.

    A window stacked over N sequences takes `slot` and `frame_id` as (N,)
    tensors, T_w2c (N, 4, 4), aff (N, 2) and exposure (N,): sequence n's
    frame goes into its slot slot[n]."""
    if _many(slot):
        s = slot.long()
        state = torch.zeros(aff.shape[:-1] + (8,), dtype=win.state.dtype, device=win.device)
        state[..., 6] = aff[..., 0] / SCALE_A
        state[..., 7] = aff[..., 1] / SCALE_B
        return win.replace(
            frame_valid=_set_at(win.frame_valid, s, True),
            evalPT=_set_at(win.evalPT, s, T_w2c),
            state=_set_at(win.state, s, state),
            state_zero=_set_at(win.state_zero, s, state),
            ab_exposure=_set_at(win.ab_exposure, s, exposure),
            frame_energy_th=_set_at(win.frame_energy_th, s, float(energy_th)),
            frame_id=_set_at(win.frame_id, s, frame_id),
        )
    state = torch.zeros(8, dtype=win.state.dtype, device=win.device)
    state[6] = aff[0] / SCALE_A
    state[7] = aff[1] / SCALE_B
    if not isinstance(T_w2c, torch.Tensor):
        T_w2c = np.asarray(T_w2c, np.float32)
    return win.replace(
        frame_valid=_set_row(win.frame_valid, slot, True),
        evalPT=_set_row(win.evalPT, slot, T_w2c),
        state=_set_row(win.state, slot, state),
        state_zero=_set_row(win.state_zero, slot, state),
        ab_exposure=_set_row(win.ab_exposure, slot, exposure),
        frame_energy_th=_set_row(win.frame_energy_th, slot, float(energy_th)),
        frame_id=_set_row(win.frame_id, slot, int(frame_id)),
    )


def set_frame_eval_pt(win: W.Window, slot) -> W.Window:
    """Re-linearize a frame at its current pose: evalPT <- current
    worldToCam; pose state zeroed; ab kept as both state and state_zero.
    For N stacked sequences `slot` is (N,)."""
    if _many(slot):
        s = slot.long()
        w2c = at_rows(win.w2c(), s)
        state = at_rows(win.state, s)
        set_ = _set_at
    else:
        s = slot
        w2c = win.w2c()[slot]
        state = win.state[slot]
        set_ = _set_row
    new_state = torch.zeros_like(state)
    new_state[..., 6] = state[..., 6]
    new_state[..., 7] = state[..., 7]
    return win.replace(
        evalPT=set_(win.evalPT, s, w2c),
        state=set_(win.state, s, new_state),
        state_zero=set_(win.state_zero, s, new_state),
    )


def insert_points(win: W.Window, idx, host_slot: int, u, v, idepth, color,
                  weights, energy_th, has_prior=False) -> W.Window:
    idx = torch.as_tensor(idx, device=win.device).long()
    return win.replace(
        pt_status=_set_row(win.pt_status, idx, W.PT_ACTIVE),
        pt_host=_set_row(win.pt_host, idx, host_slot),
        pt_u=_set_row(win.pt_u, idx, u),
        pt_v=_set_row(win.pt_v, idx, v),
        pt_idepth=_set_row(win.pt_idepth, idx, idepth),
        pt_idepth_zero=_set_row(win.pt_idepth_zero, idx, idepth),
        pt_color=_set_row(win.pt_color, idx, color),
        pt_weights=_set_row(win.pt_weights, idx, weights),
        pt_has_prior=_set_row(win.pt_has_prior, idx, has_prior),
        pt_energy_th=_set_row(win.pt_energy_th, idx, energy_th),
        pt_num_good_res=_set_row(win.pt_num_good_res, idx, 0),
        pt_max_rel_baseline=_set_row(win.pt_max_rel_baseline, idx, 0.0),
        pt_idepth_hessian=_set_row(win.pt_idepth_hessian, idx, 0.0),
        res_exists=_set_row(win.res_exists, idx, False),
        res_linearized=_set_row(win.res_linearized, idx, False),
        res_state=_set_row(win.res_state, idx, W.RES_IN),
        res_energy=_set_row(win.res_energy, idx, 0.0),
    )


def add_residuals(win: W.Window, pt_idx, target_slot) -> W.Window:
    """Create residuals point(s) -> target frame (state IN, not linearized)."""
    idx = (torch.as_tensor(pt_idx, device=win.device).long(), target_slot)
    return win.replace(
        res_exists=_set_row(win.res_exists, idx, True),
        res_state=_set_row(win.res_state, idx, W.RES_IN),
        res_linearized=_set_row(win.res_linearized, idx, False),
        res_energy=_set_row(win.res_energy, idx, 0.0),
    )


def add_residuals_all_pairs(win: W.Window) -> W.Window:
    """Create residuals from every active point to every other valid frame."""
    active = win.pt_status == W.PT_ACTIVE
    tgt_ok = win.frame_valid[None, :] & (
        win.pt_host[:, None] != torch.arange(win.F, device=win.device)[None, :]
    )
    new = active[:, None] & tgt_ok
    return win.replace(
        res_exists=new,
        res_state=torch.where(new, torch.full_like(win.res_state, W.RES_IN), win.res_state),
        res_linearized=torch.zeros_like(win.res_linearized),
    )


def free_point_slots(win: W.Window, k: int) -> np.ndarray:
    """Indices of up to k inactive point slots (read on the host)."""
    free = np.nonzero(win.pt_status.cpu().numpy() == W.PT_INACTIVE)[0]
    return free[:k]
