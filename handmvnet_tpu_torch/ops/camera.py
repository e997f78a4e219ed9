"""Pinhole camera math (counterpart of handmvnet_tpu/ops/camera.py), batched
over samples and views: projection and unprojection, the frame changes
between cameras and the world, and the g2d/p2d losses' reprojection.

Conventions (the reference's):
  * intrinsics vector [fx, fy, cx, cy];
  * an extrinsic T is camera -> world, so world -> camera uses T^-1;
  * projection adds epsilon 1e-6 to z;
  * ``reproject_to_views`` projects points in millimetres (joints * 1000).
"""

from __future__ import annotations

import torch


def intrinsics_vec_to_matrix(intr: torch.Tensor) -> torch.Tensor:
    """[..., 4] (fx, fy, cx, cy) -> [..., 3, 3] K."""
    fx, fy, cx, cy = intr.unbind(-1)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, zeros, cx], dim=-1),
        torch.stack([zeros, fy, cy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)


def project_points(points: torch.Tensor, intr: torch.Tensor,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """Camera-space points [..., N, 3] -> (u, v, z) [..., N, 3]; intr [..., 4]."""
    z = points[..., 2] + epsilon
    u = points[..., 0] * intr[..., 0:1] / z + intr[..., 2:3]
    v = points[..., 1] * intr[..., 1:2] / z + intr[..., 3:4]
    return torch.stack([u, v, points[..., 2]], dim=-1)


def unproject_points(uvd: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Image (u, v, depth) [..., N, 3] -> camera-space (x, y, z); intr [..., 4]."""
    x = (uvd[..., 0] - intr[..., 2:3]) * uvd[..., 2] / intr[..., 0:1]
    y = (uvd[..., 1] - intr[..., 3:4]) * uvd[..., 2] / intr[..., 1:2]
    return torch.stack([x, y, uvd[..., 2]], dim=-1)


def _to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def rigid_inverse(t: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid [..., 4, 4] transforms:
    inv([[R, t], [0, 1]]) = [[R^T, -R^T t], [0, 1]]."""
    rt = t[..., :3, :3].transpose(-1, -2)
    new_t = -torch.einsum("...ij,...j->...i", rt, t[..., :3, 3])
    top = torch.cat([rt, new_t[..., None]], dim=-1)  # [..., 3, 4]
    bottom = torch.zeros_like(t[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def cam_to_world(points: torch.Tensor, t_cam2world: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., N, 3] -> world frame; t_cam2world [..., 4, 4]."""
    return torch.einsum("...ij,...nj->...ni", t_cam2world, _to_homogeneous(points))[..., :3]


def world_to_cam(points: torch.Tensor, t_cam2world: torch.Tensor) -> torch.Tensor:
    """World-frame points [..., N, 3] -> the camera's frame; t_cam2world [..., 4, 4]."""
    inv = rigid_inverse(t_cam2world)
    return torch.einsum("...ij,...nj->...ni", inv, _to_homogeneous(points))[..., :3]


def transform_between_cameras(points: torch.Tensor, src_extrinsic: torch.Tensor,
                              dst_extrinsic: torch.Tensor) -> torch.Tensor:
    """Points [..., N, 3] in the src camera's frame -> the dst camera's;
    extrinsics [..., 4, 4] camera -> world."""
    rel = torch.einsum("...ij,...jk->...ik", rigid_inverse(dst_extrinsic), src_extrinsic)
    return torch.einsum("...ij,...nj->...ni", rel, _to_homogeneous(points))[..., :3]


def reproject_to_views(joints_3d: torch.Tensor, root_idx: int, intrinsics: torch.Tensor,
                       extrinsics: torch.Tensor) -> torch.Tensor:
    """Absolute joints in the root camera's frame, in metres, [B, N, 3] ->
    pixel coordinates in every view [B, V, N, 2]. intrinsics [B, V, 4];
    extrinsics [B, V, 4, 4] camera -> world; root_idx: the root view."""
    src = extrinsics[:, root_idx]  # [B, 4, 4]
    rel = torch.einsum("bvij,bjk->bvik", rigid_inverse(extrinsics), src)
    in_view = torch.einsum("bvij,bnj->bvni", rel, _to_homogeneous(joints_3d))[..., :3]
    return project_points(in_view * 1000.0, intrinsics)[..., :2]
