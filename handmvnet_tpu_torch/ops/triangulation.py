"""Multi-view DLT triangulation (counterpart of
handmvnet_tpu/ops/triangulation.py; the reference's POEM-derived
src/utils/triangulation.py), batched over samples and joints.

Conventions (the reference's): an extrinsic here is WORLD -> CAMERA, the
projection matrix is K @ Extr[:3, :], and each view gives the homogeneous
DLT rows x * M_2 - M_0 and y * M_2 - M_1, solved by SVD: the point is the
last right singular vector v, as v[:3] / (v[3] + 1e-7) (its sign cancels).

The RANSAC variant stacks every camera combination into one batched SVD
(the JAX package vmaps them; the reference loops on the host) and keeps, per
joint, the hypothesis with the most inliers.
"""

from __future__ import annotations

import itertools

import torch


def _projection_matrices(ks: torch.Tensor, extrs: torch.Tensor) -> torch.Tensor:
    """K [..., 3, 3] @ Extr[..., :3, :] -> [..., 3, 4]."""
    return torch.einsum("...ik,...kl->...il", ks, extrs[..., :3, :])


def _solve_dlt(a: torch.Tensor) -> torch.Tensor:
    """Rows [..., R, 4] -> the point [..., 3] of their null vector."""
    null = torch.linalg.svd(a).Vh[..., -1, :]
    return null[..., :3] / (null[..., 3:] + 1e-7)


def batch_triangulate_dlt(kp2ds: torch.Tensor, ks: torch.Tensor,
                          extrs: torch.Tensor) -> torch.Tensor:
    """kp2ds [B, N, J, 2] pixels in each of N views; ks [B, N, 3, 3];
    extrs [B, N, 4, 4] world -> camera. Returns world points [B, J, 3]."""
    b, n, j = kp2ds.shape[:3]
    m = _projection_matrices(ks, extrs)[:, None]  # [B, 1, N, 3, 4]
    pts = kp2ds.permute(0, 2, 1, 3)  # [B, J, N, 2]
    a = pts[..., None] * m[..., 2:3, :] - m[..., :2, :]  # [B, J, N, 2, 4]
    return _solve_dlt(a.reshape(b, j, 2 * n, 4))


def reprojection_errors(x: torch.Tensor, kp2ds: torch.Tensor, mmat: torch.Tensor) -> torch.Tensor:
    """x [B, J, 3]; kp2ds [B, N, J, 2]; mmat [B, N, 3, 4] -> pixel errors
    [B, N, J] (the reference's triangulation.py:61-95)."""
    x_hom = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    proj = torch.einsum("bnik,bjk->bnji", mmat, x_hom)
    return torch.linalg.norm(kp2ds - proj[..., :2] / proj[..., 2:3], dim=-1)


def batch_triangulate_dlt_ransac(kp2ds: torch.Tensor, ks: torch.Tensor, extrs: torch.Tensor,
                                 n_cams: int = 3, n_iterations: int = 100,
                                 reprojection_threshold: float = 10.0) -> torch.Tensor:
    """RANSAC over camera subsets: the first ``n_iterations`` combinations of
    ``n_cams`` views (itertools order), each triangulated, all in one batched
    SVD; per joint the hypothesis with the most views under
    ``reprojection_threshold`` px wins (the first on a tie), and a joint that
    no hypothesis gives an inlier is (0, 0, 0), as the reference's strict
    update from zeros leaves it. Returns [B, J, 3]."""
    b, total, j = kp2ds.shape[:3]
    combos = list(itertools.combinations(range(total), n_cams))[:n_iterations]
    idx = torch.as_tensor(combos, device=kp2ds.device)  # [C, n_cams]
    c = idx.shape[0]

    def per_combo(t: torch.Tensor) -> torch.Tensor:  # [B, N, ...] -> [B * C, n_cams, ...]
        return t[:, idx].reshape(b * c, n_cams, *t.shape[2:])

    xs = batch_triangulate_dlt(per_combo(kp2ds), per_combo(ks), per_combo(extrs))  # [B*C, J, 3]
    mmat = _projection_matrices(ks, extrs)  # [B, N, 3, 4]
    err = reprojection_errors(
        xs, kp2ds[:, None].expand(b, c, *kp2ds.shape[1:]).reshape(b * c, *kp2ds.shape[1:]),
        mmat[:, None].expand(b, c, *mmat.shape[1:]).reshape(b * c, *mmat.shape[1:]))
    counts = (err < reprojection_threshold).sum(dim=1).reshape(b, c, j)
    xs = xs.reshape(b, c, j, 3)
    best = counts.argmax(dim=1)  # [B, J], the first of equal counts
    chosen = torch.gather(xs, 1, best[:, None, :, None].expand(b, 1, j, 3))[:, 0]
    any_inlier = counts.amax(dim=1) > 0
    return torch.where(any_inlier[..., None], chosen, torch.zeros_like(chosen))


def triangulate_dlt_confident(pts: torch.Tensor, confis: torch.Tensor, ks: torch.Tensor,
                              extrs: torch.Tensor, confi_thres: float = 0.5) -> torch.Tensor:
    """DLT from the views whose confidence passes ``confi_thres`` (the rows
    of the others zeroed, the reference's per-joint selection,
    triangulation.py:205-242), or from every view where fewer than two pass.
    pts [N, J, 2]; confis [N, J]; ks [N, 3, 3]; extrs [N, 4, 4] -> [J, 3]."""
    n, j = pts.shape[:2]
    mask = confis > confi_thres  # [N, J]
    mask = torch.where((mask.sum(dim=0) >= 2)[None, :], mask, torch.ones_like(mask))
    m = _projection_matrices(ks, extrs)  # [N, 3, 4]
    a = pts.permute(1, 0, 2)[..., None] * m[None, :, 2:3, :] - m[None, :, :2, :]  # [J, N, 2, 4]
    a = a * mask.permute(1, 0)[..., None, None].to(a.dtype)
    return _solve_dlt(a.reshape(j, 2 * n, 4))
