"""Tiny-matrix linear algebra over trailing [..., 3, 3] / [..., 4, 4] dims
(counterpart of handmvnet_tpu/ops/small_linalg.py).

The JAX package writes these products as broadcast-multiply-sum so that XLA
fuses chains of them; in eager PyTorch that would be two launches each, so
every product here is one batched matmul. fp32 callers keep TF32 off for
matmuls (PyTorch's default), so the products stay fp32.
"""

from __future__ import annotations

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., n, k] @ [..., k, m]."""
    return a @ b


def mtm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b over trailing dims: [..., k, n]^T @ [..., k, m]."""
    return a.transpose(-1, -2) @ b


def mmt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T over trailing dims: [..., n, k] @ [..., m, k]^T."""
    return a @ b.transpose(-1, -2)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matvec over trailing dims: [..., n, k] @ [..., k]."""
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def mtv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a^T @ v over trailing dims: [..., k, n]^T @ [..., k]."""
    return (v.unsqueeze(-2) @ a).squeeze(-2)


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] in closed form (``torch.linalg.det`` on
    CUDA runs a batched LU through a solver library for each call)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    return (
        a00 * (a11 * a22 - a12 * a21)
        - a01 * (a10 * a22 - a12 * a20)
        + a02 * (a10 * a21 - a11 * a20)
    )


def scale_last(x: torch.Tensor, factor: torch.Tensor, dim: int) -> torch.Tensor:
    """x with its last column (``dim=-1``) or last row (``dim=-2``) of each
    trailing 3x3 multiplied by ``factor`` [...]: the out-of-place form of the
    JAX package's ``x.at[..., :, 2].multiply(f)`` / ``x.at[..., 2, :]``."""
    keep, last = x.split((2, 1), dim=dim)
    return torch.cat([keep, last * factor[..., None, None]], dim=dim)
