"""The sliding-window optimization state as one dataclass of tensors.

Port of `stereo_dso_g2o_tpu/backend/window.py`: F frame slots (FEJ pose
`evalPT`, preconditioned delta `state` = [xi(6), a, b] with
worldToCam = exp(SCALE*state[:6]) * evalPT), NP point slots with a host
slot index, a dense [NP, F] residual cube with the IN/OOB/OUTLIER machine,
and the dense marginalization prior HM/bM over the (CPARS + 8F) state.
Updates are functional (`replace` returns a new Window sharing the
unchanged tensors), as in the JAX package. A window stacked over N
sequences (every leaf with a leading axis N, the JAX package's vmap) runs
through `precalc`, `residuals`, `ba` and `builder` as one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.config import (
    CPARS,
    SCALE_A,
    SCALE_B,
    SCALE_XI_ROT,
    SCALE_XI_TRANS,
)
from stereo_dso_g2o_tpu_torch.utils import se3
from stereo_dso_g2o_tpu_torch.utils.fixed import constant
from stereo_dso_g2o_tpu_torch.utils.tree import per_row

# point status (PointHessian::PtStatus)
PT_INACTIVE = 0
PT_ACTIVE = 1
PT_MARGINALIZE = 2  # flagged: will be folded into HM/bM
PT_DROP = 3  # flagged: removed without marginalization

# residual states (Residuals.h:49)
RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2

STATE_SCALE = np.asarray(
    [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B],
    dtype=np.float32,
)


@dataclasses.dataclass
class Window:
    # -- frames --
    frame_valid: torch.Tensor  # (F,) bool
    evalPT: torch.Tensor  # (F, 4, 4) worldToCam at the FEJ point
    state: torch.Tensor  # (F, 8) preconditioned [xi(6), a, b]
    state_zero: torch.Tensor  # (F, 8)
    prior: torch.Tensor  # (F, 8)
    ab_exposure: torch.Tensor  # (F,)
    frame_energy_th: torch.Tensor  # (F,)
    frame_id: torch.Tensor  # (F,) int32 keyframe id (-1 = empty)
    # -- camera intrinsics --
    c_value: torch.Tensor  # (4,)
    c_zero: torch.Tensor  # (4,)
    # -- points --
    pt_status: torch.Tensor  # (NP,) int32
    pt_host: torch.Tensor  # (NP,) int32
    pt_u: torch.Tensor
    pt_v: torch.Tensor
    pt_idepth: torch.Tensor
    pt_idepth_zero: torch.Tensor
    pt_color: torch.Tensor  # (NP, 8)
    pt_weights: torch.Tensor  # (NP, 8)
    pt_has_prior: torch.Tensor  # (NP,) bool
    pt_energy_th: torch.Tensor
    pt_num_good_res: torch.Tensor  # (NP,) int32
    pt_max_rel_baseline: torch.Tensor
    pt_idepth_hessian: torch.Tensor
    # -- residual cube [NP, F] --
    res_exists: torch.Tensor  # bool
    res_state: torch.Tensor  # int32
    res_energy: torch.Tensor
    res_linearized: torch.Tensor  # bool
    res_to_zero: torch.Tensor  # (NP, F, 8)
    res_new_state: torch.Tensor  # int32
    res_new_energy_wo: torch.Tensor
    res_center: torch.Tensor  # (NP, F, 3)
    # -- accepted Jacobians --
    J_resF: torch.Tensor  # (NP, F, 8)
    J_pdxi: torch.Tensor  # (NP, F, 2, 6)
    J_pdc: torch.Tensor  # (NP, F, 2, 4)
    J_pdd: torch.Tensor  # (NP, F, 2)
    J_Idx: torch.Tensor  # (NP, F, 2, 8)
    J_abF: torch.Tensor  # (NP, F, 2, 8)
    # -- marginalization prior --
    HM: torch.Tensor  # (D, D)
    bM: torch.Tensor  # (D,)

    def replace(self, **kw) -> "Window":
        return dataclasses.replace(self, **kw)

    @property
    def F(self) -> int:
        return self.frame_valid.shape[-1]

    @property
    def NP(self) -> int:
        return self.pt_status.shape[-1]

    @property
    def device(self):
        return self.state.device

    def state_scale(self):
        return constant(STATE_SCALE, torch.float32, self.state.device)

    # The four below also read a window stacked over sequences (every
    # leaf with a leading axis N): (N, F, ...).
    def state_scaled(self):
        return self.state * self.state_scale()

    def w2c(self):
        """PRE_worldToCam = exp(state_scaled[:6]) * evalPT."""
        return se3.se3_exp(self.state_scaled()[..., :6]) @ self.evalPT

    def aff_g2l(self):
        return self.state_scaled()[..., 6:8]

    def aff_g2l_0(self):
        """FEJ affine params."""
        return self.state_zero[..., 6:8] * self.state_scale()[6:8]


def empty_window(F: int, NP: int, c_value, device, dtype=torch.float32) -> Window:
    D = CPARS + 8 * F

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    c = torch.as_tensor(np.asarray(c_value), dtype=dtype, device=device)
    return Window(
        frame_valid=z((F,), torch.bool),
        evalPT=torch.eye(4, dtype=dtype, device=device).expand(F, 4, 4).clone(),
        state=z((F, 8)),
        state_zero=z((F, 8)),
        prior=z((F, 8)),
        ab_exposure=torch.ones((F,), dtype=dtype, device=device),
        frame_energy_th=torch.full((F,), 8 * 12.0 * 12.0, dtype=dtype, device=device),
        frame_id=torch.full((F,), -1, dtype=torch.int32, device=device),
        c_value=c.clone(),
        c_zero=c.clone(),
        pt_status=z((NP,), torch.int32),
        pt_host=z((NP,), torch.int32),
        pt_u=z((NP,)),
        pt_v=z((NP,)),
        pt_idepth=z((NP,)),
        pt_idepth_zero=z((NP,)),
        pt_color=z((NP, 8)),
        pt_weights=z((NP, 8)),
        pt_has_prior=z((NP,), torch.bool),
        pt_energy_th=z((NP,)),
        pt_num_good_res=z((NP,), torch.int32),
        pt_max_rel_baseline=z((NP,)),
        pt_idepth_hessian=z((NP,)),
        res_exists=z((NP, F), torch.bool),
        res_state=z((NP, F), torch.int32),
        res_energy=z((NP, F)),
        res_linearized=z((NP, F), torch.bool),
        res_to_zero=z((NP, F, 8)),
        res_new_state=z((NP, F), torch.int32),
        res_new_energy_wo=z((NP, F)),
        res_center=z((NP, F, 3)),
        J_resF=z((NP, F, 8)),
        J_pdxi=z((NP, F, 2, 6)),
        J_pdc=z((NP, F, 2, 4)),
        J_pdd=z((NP, F, 2)),
        J_Idx=z((NP, F, 2, 8)),
        J_abF=z((NP, F, 2, 8)),
        HM=z((D, D)),
        bM=z((D,)),
    )


def aff_transfer(exp_h, exp_t, aff_h, aff_t):
    """AffLight::fromToVecExposure, batched."""
    a = torch.exp(aff_t[..., 0] - aff_h[..., 0]) * exp_t / exp_h
    b = aff_t[..., 1] - a * aff_h[..., 1]
    return torch.stack([a, b], dim=-1)


def precalc(win: Window):
    """FrameFramePrecalc::set for every (host, target) pair. Returns a dict
    of (F, F, ...) tensors indexed [host, target] ((N, F, F, ...) for a
    window stacked over N sequences)."""
    w2c = win.w2c()
    ev = win.evalPT
    c2w = se3.inverse(w2c)
    ev_inv = se3.inverse(ev)

    T0 = torch.einsum("...tij,...hjk->...thik", ev, ev_inv)  # FEJ (leftToLeft_0)
    T = torch.einsum("...tij,...hjk->...thik", w2c, c2w)  # current

    lead = tuple(win.c_value.shape[:-1])
    K = torch.eye(3, dtype=win.c_value.dtype, device=win.device).expand(lead + (3, 3)).clone()
    K[..., 0, 0] = win.c_value[..., 0]
    K[..., 1, 1] = win.c_value[..., 1]
    K[..., 0, 2] = win.c_value[..., 2]
    K[..., 1, 2] = win.c_value[..., 3]
    Ki = torch.linalg.inv_ex(K).inverse

    R = torch.swapaxes(T[..., :3, :3], -4, -3)
    t = torch.swapaxes(T[..., :3, 3], -3, -2)
    R0 = torch.swapaxes(T0[..., :3, :3], -4, -3)
    t0 = torch.swapaxes(T0[..., :3, 3], -3, -2)

    aff = win.aff_g2l()
    aff_ht = aff_transfer(
        win.ab_exposure[..., :, None],
        win.ab_exposure[..., None, :],
        aff[..., :, None, :],
        aff[..., None, :, :],
    )
    b0 = win.state_zero[..., 7] * SCALE_B

    return dict(
        RTll_0=R0,
        tTll_0=t0,
        # products of one matrix per sequence: one call per sequence
        # (utils/tree.per_row), as one sequence alone makes it
        KRKi=per_row(lambda k, r, ki: torch.einsum("ij,htjk,kl->htil", k, r, ki), bool(lead),
                     K, R, Ki),
        Kt=per_row(lambda k, tt: torch.einsum("ij,htj->hti", k, tt), bool(lead), K, t),
        RTll=R,
        tTll=t,
        aff=aff_ht,
        b0=b0,
        K=K,
        Ki=Ki,
    )
