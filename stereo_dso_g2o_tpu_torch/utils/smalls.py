"""Small fixed-size linear algebra, unrolled.

Port of `stereo_dso_g2o_tpu/utils/smalls.py`: the n <= 8 normal-equation
solves of the tracker and the immature-point optimizer run as one unrolled
Cholesky chain over arbitrary leading batch dimensions. Also `fma`, for the
few products whose rounding decides a comparison, and `matmul_fma`, small
matrix products rounded as one product alone rounds on the BLAS.
"""

from __future__ import annotations

import torch


def cholesky_solve_small(A, b):
    """Solve A x = b for symmetric PSD A of small static size.

    A: (..., n, n), b: (..., n). Singular diagonals are clamped so an
    all-zero system returns x = 0 instead of NaN.
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def fma(a, b, c):
    """a*b + c in float32 with a single rounding, as XLA contracts it (a
    float64 product of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def matmul_fma(A, B):
    """A @ B of small matrices over any leading dimensions, every entry a
    chain of fused multiply-adds over k in order (a0*b0, then fma(ak, bk,
    acc)): how the BLAS rounds a single small 2-D product, and XLA its dot.
    A batched `@` on the CPU sums without fusing, so a sequence's pose
    products would round one way alone and another in a batch; this rounds
    them the same in both."""
    a, b = A.double(), B.double()
    acc = (a[..., :, 0, None] * b[..., None, 0, :]).float()
    for k in range(1, A.shape[-1]):
        acc = (a[..., :, k, None] * b[..., None, k, :] + acc.double()).float()
    return acc
