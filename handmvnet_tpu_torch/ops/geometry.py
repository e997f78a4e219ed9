"""Crop geometry, the crop-FoV encoding and the joint mask of the metrics
and losses (counterpart of the functions of handmvnet_tpu/ops/geometry.py
that the inference, evaluation and training paths use)."""

from __future__ import annotations

import torch


def joints_img_to_crop(pts: torch.Tensor, boxes: torch.Tensor,
                       image_size: float = 256.0) -> torch.Tensor:
    """Full-image pixel coords -> crop-image pixel coords.
    pts: [..., N, 2]; boxes: [..., 4] xyxy."""
    x1y1 = boxes[..., None, 0:2]
    wh = boxes[..., None, 2:4] - x1y1
    return (pts - x1y1) * (image_size / wh)


def joints_crop_to_img(pts: torch.Tensor, boxes: torch.Tensor,
                       image_size: float = 256.0) -> torch.Tensor:
    """Crop-image pixel coords -> full-image pixel coords.
    pts: [..., N, 2]; boxes: [..., 4] xyxy."""
    x1y1 = boxes[..., None, 0:2]
    wh = boxes[..., None, 2:4] - x1y1
    return pts * (wh / image_size) + x1y1


def box_corner_points(boxes: torch.Tensor) -> torch.Tensor:
    """xyxy box -> its corners (x1,y1), (x1,y2), (x2,y1), (x2,y2) and its
    center, in the reference's order. boxes: [..., 4] -> [..., 5, 2]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    pts = torch.stack(
        [x1, y1, x1, y2, x2, y1, x2, y2, (x1 + x2) * 0.5, (y1 + y2) * 0.5], dim=-1
    )
    return pts.reshape(*boxes.shape[:-1], 5, 2)


def centered_coordinates(points: torch.Tensor, px: torch.Tensor,
                         py: torch.Tensor) -> torch.Tensor:
    """Points relative to the principal point. points: [..., N, 2];
    px, py: [...]."""
    return torch.stack(
        [points[..., 0] - px[..., None], points[..., 1] - py[..., None]], dim=-1
    )


def fov_angles(centered: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Per-point field-of-view angles atan(x/fx), atan(y/fy) in radians.
    centered: [..., N, 2]; fx, fy: [...]."""
    return torch.stack(
        [torch.atan(centered[..., 0] / fx[..., None]),
         torch.atan(centered[..., 1] / fy[..., None])],
        dim=-1,
    )


def mask_joints(joints: torch.Tensor, invisible_mask: torch.Tensor) -> torch.Tensor:
    """Zero out joints flagged invisible. invisible_mask: [..., J] bool
    (True = invisible); joints: [..., J, D]."""
    keep = torch.logical_not(invisible_mask).to(joints.dtype)
    return joints * keep[..., None]
