"""Solver observability: eigenvalue / Hessian-diagonal / nullspace dumps.

Port of `stereo_dso_g2o_tpu/runtime/diagnostics.py`. The reference streams
these per keyframe when setting_logStuff is on
(FullSystem::printEigenValLine, FullSystem.cpp:1689-1768: eigenvalues of the
last H, its pose/a-b sub-blocks, the Hessian diagonal, and the nullspace
columns). This module gives the same dump as one JSONL record, so that
accuracy drift during performance work can be traced to a direction of the
state space.

On the card the Hessian, its blocks, diagonal and nullspace responses are
one program (`runtime/program.run`, as the JAX package jits
`_hessian_parts`); the three symmetric eigenvalue solves run after it,
eagerly: `torch.linalg.eigvalsh` checks cuSOLVER's status on the host,
which a captured graph cannot hold. The record is one read.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.backend import ba
from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import CPARS, Settings, default_settings
from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.utils import host


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


def _hessian_blocks(win: W.Window, settings: Settings):
    """The symmetrized H, its pose and a/b blocks, its diagonal and the
    nullspace responses: `_hessian_parts` up to the eigenvalue solves."""
    H = hessian(win, settings)
    # pose block (6 dof per frame) and a/b block, like ev_H_A / ev_H_ab
    F = win.F
    per_frame = torch.arange(F * 8, device=win.device).reshape(F, 8)
    pose_idx = CPARS + per_frame[:, :6].reshape(-1)
    ab_idx = CPARS + per_frame[:, 6:].reshape(-1)
    Hp = H[pose_idx][:, pose_idx]
    Hab = H[ab_idx][:, ab_idx]
    diag = torch.diagonal(H)
    N = ba.nullspaces(win)
    # nullspace response: ||H n|| / ||n|| per column (should be ~0 in the
    # gauge directions the orthogonalization removes)
    resp = torch.linalg.norm(H @ N, dim=0) / torch.clamp(torch.linalg.norm(N, dim=0), min=1e-12)
    return 0.5 * (H + H.T), 0.5 * (Hp + Hp.T), 0.5 * (Hab + Hab.T), diag, resp


def _hessian_parts(win: W.Window, settings: Settings):
    """Eigendata, diagonal and nullspace responses of `hessian` (the
    reference logs eigenvalues of the undamped system)."""
    H, Hp, Hab, diag, resp = program.run(_hessian_blocks, (win,), dict(settings=settings))
    return (torch.linalg.eigvalsh(H), torch.linalg.eigvalsh(Hp), torch.linalg.eigvalsh(Hab),
            diag, resp)


def eigenvalue_record(win: W.Window, settings: Settings = default_settings()):
    """One JSON-ready dict mirroring printEigenValLine's content."""
    ev_all, ev_pose, ev_ab, diag, resp = host.Fetch(_hessian_parts(win, settings)).get()
    return {
        "type": "eig",
        "ev_H": np.round(np.sort(ev_all)[::-1], 6).tolist(),
        "ev_H_pose": np.round(np.sort(ev_pose)[::-1], 6).tolist(),
        "ev_H_ab": np.round(np.sort(ev_ab)[::-1], 6).tolist(),
        "H_diag": np.round(diag, 6).tolist(),
        "nullspace_response": np.round(resp, 8).tolist(),
    }
