"""Loss primitives and the HandMvNet training loss (counterpart of
handmvnet_tpu/losses.py).

Every mean is over all elements (torch's reduction="mean"), and invisible
joints are zeroed on both sides before the 2D L1, so masked terms stay in
the denominator as the reference's mask_joints trick keeps them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from handmvnet_tpu_torch.config import LossWeights
from handmvnet_tpu_torch.ops.camera import reproject_to_views
from handmvnet_tpu_torch.ops.geometry import joints_img_to_crop, mask_joints


def _broadcast_stacked(preds: torch.Tensor, labels: torch.Tensor,
                       stacked_dim: int | None) -> torch.Tensor:
    """Labels broadcast over a stacked prediction axis (the reference's
    stacked_dim, e.g. one heatmap label for every hourglass stack)."""
    if stacked_dim is not None:
        labels = labels.unsqueeze(stacked_dim).expand(preds.shape)
    return labels


def mse_loss(preds: torch.Tensor, labels: torch.Tensor, weight: float = 1.0,
             stacked_dim: int | None = None) -> torch.Tensor:
    labels = _broadcast_stacked(preds, labels, stacked_dim)
    return torch.mean((preds - labels) ** 2) * weight


def l1_loss(preds: torch.Tensor, labels: torch.Tensor, weight: float = 1.0,
            stacked_dim: int | None = None) -> torch.Tensor:
    labels = _broadcast_stacked(preds, labels, stacked_dim)
    return torch.mean(torch.abs(preds - labels)) * weight


def smooth_l1_loss(preds: torch.Tensor, labels: torch.Tensor, weight: float = 1.0,
                   beta: float = 1.0, stacked_dim: int | None = None) -> torch.Tensor:
    labels = _broadcast_stacked(preds, labels, stacked_dim)
    diff = torch.abs(preds - labels)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return torch.mean(loss) * weight


def bce_loss(logits: torch.Tensor, labels: torch.Tensor, weight: float = 1.0,
             stacked_dim: int | None = None) -> torch.Tensor:
    """Sigmoid, then binary cross-entropy, on logits."""
    labels = _broadcast_stacked(logits, labels, stacked_dim)
    return -torch.mean(labels * F.logsigmoid(logits)
                       + (1.0 - labels) * F.logsigmoid(-logits)) * weight


def handmvnet_loss(
    out: Mapping[str, torch.Tensor],
    inputs: Mapping[str, torch.Tensor],
    weights: LossWeights,
    *,
    mask_invisible_joints: bool = True,
    root_relative: bool = True,
    intrinsics: torch.Tensor | None = None,
    extrinsics: torch.Tensor | None = None,
    root_idx: int = 0,
    image_size: float = 256.0,
) -> Dict[str, torch.Tensor]:
    """Each loss term and their sum ``loss``. ``inputs`` holds the labels,
    3D ones in metres (the caller divides the mm labels by 1000). With
    ``root_relative`` off the model's ``root_joint`` is held to the label's
    (``root_3d_loss``) and the reprojection adds it in place of the
    label's."""
    losses: Dict[str, torch.Tensor] = {}
    losses["heatmap_loss"] = mse_loss(out["heatmap"], inputs["heatmap"], weights.heatmap)

    pred2d, gt2d = out["joints_crop_img"], inputs["joints_crop_img"]
    if "joints_img_mask" in inputs and mask_invisible_joints:
        m = inputs["joints_img_mask"]
        pred2d = mask_joints(pred2d, m)
        gt2d = mask_joints(gt2d, m)
    losses["joints_2d_loss"] = l1_loss(pred2d, gt2d, weights.joints_2d)
    losses["joints_3d_loss"] = l1_loss(out["joints_cam"], inputs["joints_cam"],
                                       weights.joints_3d)
    if not root_relative:
        losses["root_3d_loss"] = l1_loss(out["root_joint"], inputs["root_joint"],
                                         weights.joints_3d)

    if weights.g2d is not None:
        # fail loudly, as the reference does: a silent zero-weight term would
        # log a p2d_loss of 0 while the user believes the term is on
        if weights.p2d is None:
            raise ValueError("loss_weights.g2d is set but p2d is missing (the "
                             "reference needs both)")
        if intrinsics is None or extrinsics is None:
            raise ValueError("the g2d/p2d reprojection losses need camera "
                             "intrinsics and extrinsics")
        root = inputs["root_joint"] if root_relative else out["root_joint"]
        projected = reproject_to_views(out["joints_cam"] + root, root_idx,
                                       intrinsics, extrinsics)  # [B, V, 21, 2]
        b, v = projected.shape[:2]
        proj_crop = joints_img_to_crop(
            projected.reshape(b * v, -1, 2), inputs["bboxes"].reshape(b * v, 4), image_size
        ).reshape(b, v, -1, 2)
        losses["g2d_loss"] = l1_loss(proj_crop, inputs["joints_crop_img"], weights.g2d)
        losses["p2d_loss"] = l1_loss(proj_crop, out["joints_crop_img"], weights.p2d)

    losses["loss"] = sum(losses.values())
    return losses
