"""Closed-form batched 3x3 SVD (counterpart of handmvnet_tpu/ops/svd3.py).

The mesh stage decomposes only 3x3 correlation matrices (Procrustes and the
IK's global orientation). This is the JAX package's algorithm, formula for
formula: the eigendecomposition of A^T A from the trigonometric cubic-root
formula and cross-product eigenvectors, an optional short Jacobi polish, and
U from H V. ``torch.linalg.svd`` is a different algorithm with its own sign
gauge, and the mesh stage's reflection rules depend on this gauge.

Every degenerate-case guard of the JAX package is kept: the scalar-matrix
case, the fallback eigenvector, the orthogonal completion of repeated
eigenvalues and the safe normalisation of (near-)zero columns, so no input
yields NaN. Updates are out of place: nothing writes into a view of an input.
"""

from __future__ import annotations

import math

import torch

from handmvnet_tpu_torch.ops.small_linalg import mm, mtm


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1, keepdim=True)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _axis(like: torch.Tensor, i: int) -> torch.Tensor:
    """The unit vector e_i broadcast to ``like``'s shape [..., 3]."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[i].expand_as(like)


def _eigvals_sym3x3(a: torch.Tensor) -> torch.Tensor:
    """Analytic eigenvalues of symmetric [..., 3, 3], descending (Smith's
    trigonometric method)."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    # det((A - qI) / p) / 2
    b00, b11, b22 = d0 / p, d1 / p, d2 / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    degenerate = p2 < 1e-20  # scalar matrix: all eigenvalues q
    return torch.where(
        degenerate[..., None],
        torch.stack([q, q, q], dim=-1),
        torch.stack([e1, e2, e3], dim=-1),
    )


def _eigvec_for(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric A for eigenvalue lam via row cross products
    of (A - lam I): the nullspace direction (the largest of the three
    candidate cross products wins for robustness)."""
    m = a - lam[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = _dot(c01, c01)
    n02 = _dot(c02, c02)
    n12 = _dot(c12, c12)
    best = torch.where(n01 >= n02, c01, c02)
    best_n = torch.maximum(n01, n02)
    best = torch.where(best_n >= n12, best, c12)
    norm = _norm(best)
    # fully degenerate: any unit vector is an eigenvector
    return torch.where(norm > 1e-20, best / torch.clamp(norm, min=1e-30), _axis(best, 0))


def _givens(c: torch.Tensor, s: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """[..., 3, 3] identity with [p, p] = [q, q] = c, [p, q] = -s, [q, p] = s."""
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    entries = [[one if i == j else zero for j in range(3)] for i in range(3)]
    entries[p][p] = entries[q][q] = c
    entries[p][q], entries[q][p] = -s, s
    return torch.stack([torch.stack(row, dim=-1) for row in entries], dim=-2)


def _jacobi_polish(a: torch.Tensor, v: torch.Tensor, sweeps: int = 2):
    """A few unrolled Jacobi sweeps to clean up fp32 cancellation from the
    analytic solve (quadratic convergence: 2 sweeps from a good init reach
    machine precision)."""
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            theta = 0.5 * torch.atan2(2.0 * a[..., p, q], a[..., p, p] - a[..., q, q])
            g = _givens(torch.cos(theta), torch.sin(theta), p, q)
            a = mtm(g, a) @ g
            v = v @ g
    return a, v


def symeig3x3(a: torch.Tensor, polish_sweeps: int = 2):
    """Eigendecomposition of symmetric [..., 3, 3]: returns (eigvals desc,
    eigvecs as columns). Analytic closed-form init + a short Jacobi polish
    in the eigenbasis (``polish_sweeps=0`` for the fast path)."""
    w = _eigvals_sym3x3(a)
    v0 = _eigvec_for(a, w[..., 0])
    v2 = _eigvec_for(a, w[..., 2])
    # middle eigenvector: orthogonal completion (exact for symmetric A)
    v2 = v2 - _dot(v2, v0) * v0
    n2 = _norm(v2)
    # repeated/degenerate eigenvalues (scalar A, H^T H = c*I, H ~ 0): both
    # analytic eigenvectors collapse onto the same direction and the
    # projection above is ~0, so complete an orthonormal basis from the
    # coordinate axis least aligned with v0 instead of emitting a rank-1 V
    alt = torch.where(v0[..., 0:1].abs() < 0.9, _axis(v0, 0), _axis(v0, 1))
    alt = alt - _dot(alt, v0) * v0
    alt = alt / torch.clamp(_norm(alt), min=1e-30)
    # sanitize the denominator before dividing, so the branch not taken
    # never holds an inf that a gradient through the where would pick up
    degenerate = n2 <= 1e-3
    safe_n2 = torch.where(degenerate, 1.0, n2)
    v2 = torch.where(degenerate, alt, v2 / safe_n2)
    v1 = _cross(v2, v0)
    v = torch.stack([v0, v1, v2], dim=-1)
    if polish_sweeps:
        a_rot, v = _jacobi_polish(mtm(v, a) @ v, v, polish_sweeps)
        ws = [a_rot[..., 0, 0], a_rot[..., 1, 1], a_rot[..., 2, 2]]
        vs = list(v.unbind(-1))
        # polish preserves the (descending) order from the analytic init up to
        # roundoff; enforce it pairwise without argsort/gather
        for i, j in ((0, 1), (1, 2), (0, 1)):
            swap = ws[i] < ws[j]
            ws[i], ws[j] = torch.where(swap, ws[j], ws[i]), torch.where(swap, ws[i], ws[j])
            sv = swap[..., None]
            vs[i], vs[j] = torch.where(sv, vs[j], vs[i]), torch.where(sv, vs[i], vs[j])
        w = torch.stack(ws, dim=-1)
        v = torch.stack(vs, dim=-1)
    return w, v


def svd3x3(h: torch.Tensor, polish_sweeps: int = 2):
    """SVD of [..., 3, 3]: returns (u, s, vt) with s descending,
    h = u @ diag(s) @ vt, in the JAX package's sign gauge."""
    w, v = symeig3x3(mtm(h, h), polish_sweeps=polish_sweeps)  # H^T H
    s = torch.sqrt(torch.clamp(w, min=0.0))
    u_raw = mm(h, v)  # H V = U S

    def unit(x, fallback):
        # safe normalisation: a (near-)zero column (H itself ~0, e.g. all
        # points collapsed to one location) must yield an arbitrary
        # orthonormal completion like numpy's SVD, not 0/0 = NaN
        n = _norm(x)
        ok = n > 1e-20
        return torch.where(ok, x / torch.where(ok, n, 1.0), fallback)

    # normalize columns; Gram-Schmidt, since close singular values leave
    # H V / s columns a few ulps off orthogonal in fp32
    u0 = u_raw[..., :, 0] / torch.clamp(s[..., 0:1], min=1e-12)
    u0 = unit(u0, _axis(u0, 0))
    u1 = u_raw[..., :, 1] / torch.clamp(s[..., 1:2], min=1e-12)
    u1 = u1 - _dot(u1, u0) * u0
    # fallback orthogonal to u0: cross with the axis least aligned with it
    alt = torch.where(u0[..., 2:3].abs() > 0.9, _axis(u0, 1), _axis(u0, 2))
    u1_fb = _cross(u0, alt)
    u1 = unit(u1, u1_fb / _norm(u1_fb))
    u2_cross = _cross(u0, u1)
    u2_raw = u_raw[..., :, 2] / torch.clamp(s[..., 2:3], min=1e-12)
    # keep the raw column's orientation; use the cross product's direction
    sign = torch.where(_dot(u2_cross, u2_raw) < 0, -1.0, 1.0)
    degenerate = (s[..., 2] < 1e-7 * torch.clamp(s[..., 0], min=1e-30))[..., None]
    u2 = torch.where(degenerate, u2_cross, u2_cross * sign)
    u = torch.stack([u0, u1, u2], dim=-1)
    return u, s, v.transpose(-1, -2)
