"""SE(3) / SO(3) Lie-group operations on torch tensors.

Port of `stereo_dso_g2o_tpu/utils/se3.py`: twists are (trans[3], rot[3])
in Sophus order, poses are 4x4 homogeneous matrices, every function is
batched over leading dimensions, and Taylor fallbacks keep everything finite
near theta = 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w):
    """Rodrigues. w: (..., 3) -> R: (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    )
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R):
    """R: (..., 3, 3) -> w: (..., 3). Stable for theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = 0.5 * torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    scale = torch.where(
        small,
        1.0 + theta * theta / 6.0,
        theta / torch.where(small, torch.ones_like(sin_t), sin_t + _EPS),
    )
    return w * scale[..., None]


def se3_exp(xi, matmul=torch.matmul):
    """xi: (..., 6) with (trans[3], rot[3]) Sophus ordering -> T: (..., 4, 4).
    `matmul`: the product of the 3x3 blocks (utils/smalls.matmul_fma rounds
    it as a single 2-D product rounds)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = matmul(W, W)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    )
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / (theta2 + _EPS * _EPS))
    eye = _eye3(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return rt_to_mat(R, t)


def se3_log(T, matmul=torch.matmul):
    """T: (..., 4, 4) -> xi: (..., 6) = (trans, rot); `matmul` as in se3_exp."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = matmul(W, W)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    )
    D = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / (theta2 + _EPS * _EPS),
    )
    Vinv = _eye3(W) - 0.5 * W + D[..., None, None] * W2
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, w], dim=-1)


def rt_to_mat(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # a fill: no Python number made into a tensor
    return T


def identity(dtype=torch.float32, batch=(), device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch) + (4, 4)).clone()


def inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = torch.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def compose(A, B):
    return A @ B


def rotation(T):
    return T[..., :3, :3]


def translation(T):
    return T[..., :3, 3]


def adjoint(T):
    """Adjoint of SE(3) for (trans, rot)-ordered twists: (..., 6, 6).

    Ad(T) = [[R, t^ R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    batch = R.shape[:-2]
    Ad = torch.zeros(batch + (6, 6), dtype=T.dtype, device=T.device)
    Ad[..., :3, :3] = R
    Ad[..., :3, 3:] = tR
    Ad[..., 3:, 3:] = R
    return Ad


def apply(T, p):
    """Transform points. T: (..., 4, 4), p: (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]
