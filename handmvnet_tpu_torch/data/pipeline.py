"""Preprocessing of decoded frames on the device (counterpart of
handmvnet_tpu/data/pipeline.py): the reference's per-sample CPU chain
crop_and_pad -> resize (antialias) -> normalize, plus the 21 x V Gaussian
heatmap labels (src/datasets/ho3d.py:131-166), as batched tensor ops over all
B x V views on the frames' device.

  * crop + resize + normalise: two products per view with weights built on
    the device (ops/resize.py), with the black-image rule: a view whose
    joints are all invisible becomes a zero image before normalisation
    (ho3d.py:138-141);
  * heatmaps: the Gaussian render and its downscale in rank-1 form
    (ops/heatmap.py), with no full-size map.

Augmentation (the train split's) is not ported yet.
"""

from __future__ import annotations

import torch

from handmvnet_tpu_torch.ops.heatmap import render_gaussian_heatmaps_resized
from handmvnet_tpu_torch.ops.resize import crop_resize_normalize

AUGMENT_TODO = ("augmentation is not ported yet: ROADMAP.md queue 1 item 1 "
                "(data/augment.py and the train split)")


def preprocess_views(full_rgb: torch.Tensor, bboxes: torch.Tensor, joints_crop: torch.Tensor,
                     any_visible: torch.Tensor, *, image_size: int = 256,
                     heatmap_size: int = 32, augment: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """full_rgb: [B, V, H, W, 3] uint8 frames; bboxes: [B, V, 4] integer-valued
    xyxy crop boxes (unclamped, as the reference crops); joints_crop:
    [B, V, J, 2] crop-space 2D joints; any_visible: [B, V] bool, False for the
    black-image rule. All on one device.

    Returns (rgb [B, V, S, S, 3] float32 normalised, heatmap
    [B, V, J, h, h] float32), the batch layout the model and the losses take.
    """
    if augment:
        raise NotImplementedError(AUGMENT_TODO)
    b, v = full_rgb.shape[:2]
    rgb = crop_resize_normalize(full_rgb.reshape(b * v, *full_rgb.shape[2:]),
                                bboxes.reshape(b * v, 4), image_size, any_visible.reshape(b * v))
    heatmaps = render_gaussian_heatmaps_resized(
        joints_crop.reshape(b * v, -1, 2), image_size, heatmap_size)
    return (rgb.reshape(b, v, image_size, image_size, 3),
            heatmaps.reshape(b, v, -1, heatmap_size, heatmap_size))
