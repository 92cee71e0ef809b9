"""Solver observability: eigenvalue / Hessian-diagonal / nullspace dumps.

Port of `stereo_dso_g2o_tpu/runtime/diagnostics.py`. The reference streams
these per keyframe when setting_logStuff is on
(FullSystem::printEigenValLine, FullSystem.cpp:1689-1768: eigenvalues of the
last H, its pose/a-b sub-blocks, the Hessian diagonal, and the nullspace
columns). This module gives the same dump as one JSONL record, so that
accuracy drift during performance work can be traced to a direction of the
state space.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.backend import ba
from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import CPARS, Settings, default_settings


def hessian(win: W.Window, settings: Settings) -> torch.Tensor:
    """Final-state H of the camera system: A-mode + priors + marginal prior
    - Schur complement of the points."""
    AH, AT = ba.adjoints(win)
    active = win.res_exists & (win.res_state == W.RES_IN)
    mode0 = active & ~win.res_linearized
    accA = ba.accumulate_top(win, AH, AT, mode0, 0, settings, use_prior=True)
    prior_pt = ba.point_prior(win, settings)
    sc = ba.accumulate_sc(win, AH, AT, active, accA, prior_pt, True)
    return accA.H + win.HM - sc.H


def _hessian_parts(win: W.Window, settings: Settings):
    """Eigendata, diagonal and nullspace responses of `hessian`."""
    H = hessian(win, settings)
    # the reference logs eigenvalues of the undamped system
    ev_all = torch.linalg.eigvalsh(0.5 * (H + H.T))
    # pose block (6 dof per frame) and a/b block, like ev_H_A / ev_H_ab
    F = win.F
    per_frame = torch.arange(F * 8, device=win.device).reshape(F, 8)
    pose_idx = CPARS + per_frame[:, :6].reshape(-1)
    ab_idx = CPARS + per_frame[:, 6:].reshape(-1)
    Hp = H[pose_idx][:, pose_idx]
    Hab = H[ab_idx][:, ab_idx]
    ev_pose = torch.linalg.eigvalsh(0.5 * (Hp + Hp.T))
    ev_ab = torch.linalg.eigvalsh(0.5 * (Hab + Hab.T))
    diag = torch.diagonal(H)
    N = ba.nullspaces(win)
    # nullspace response: ||H n|| / ||n|| per column (should be ~0 in the
    # gauge directions the orthogonalization removes)
    resp = torch.linalg.norm(H @ N, dim=0) / torch.clamp(torch.linalg.norm(N, dim=0), min=1e-12)
    return ev_all, ev_pose, ev_ab, diag, resp


def eigenvalue_record(win: W.Window, settings: Settings = default_settings()):
    """One JSON-ready dict mirroring printEigenValLine's content."""
    ev_all, ev_pose, ev_ab, diag, resp = (
        x.cpu().numpy() for x in _hessian_parts(win, settings)
    )
    return {
        "type": "eig",
        "ev_H": np.round(np.sort(ev_all)[::-1], 6).tolist(),
        "ev_H_pose": np.round(np.sort(ev_pose)[::-1], 6).tolist(),
        "ev_H_ab": np.round(np.sort(ev_ab)[::-1], 6).tolist(),
        "H_diag": np.round(diag, 6).tolist(),
        "nullspace_response": np.round(resp, 8).tolist(),
    }
