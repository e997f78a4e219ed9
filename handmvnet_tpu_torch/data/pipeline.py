"""Preprocessing of decoded frames on the device (counterpart of
handmvnet_tpu/data/pipeline.py): the reference's per-sample CPU chain
crop_and_pad -> augment (train) -> resize (antialias) -> normalize, plus the
21 x V Gaussian heatmap labels (src/datasets/ho3d.py:131-166), as batched
tensor ops over all B x V views on the frames' device.

  * crop + resize: two products per view with weights built on the device
    (ops/resize.py), to [0, 1];
  * photometric augmentation of the train split (data/augment.py), with the
    blur and occlusion sizes in crop pixels;
  * the black-image rule (a view whose joints are all invisible becomes a
    zero image, ho3d.py:138-141) and the normalisation;
  * heatmaps: the Gaussian render and its downscale in rank-1 form
    (ops/heatmap.py), with no full-size map.
"""

from __future__ import annotations

import torch

from handmvnet_tpu_torch.data.augment import augment_batch
from handmvnet_tpu_torch.ops.heatmap import render_gaussian_heatmaps_resized
from handmvnet_tpu_torch.ops.resize import crop_resize, mask_normalize


def preprocess_views(full_rgb: torch.Tensor, bboxes: torch.Tensor, joints_crop: torch.Tensor,
                     any_visible: torch.Tensor, *, image_size: int = 256,
                     heatmap_size: int = 32, augment: bool = False,
                     generator: torch.Generator | None = None, box_scale_denom: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """full_rgb: [B, V, H, W, 3] uint8 frames; bboxes: [B, V, 4] xyxy crop
    boxes in the frames' pixels (unclamped, as the reference crops; integers,
    or the labels' integers / d on frames downscaled by d); joints_crop:
    [B, V, J, 2] crop-space 2D joints; any_visible: [B, V] bool, False for the
    black-image rule. All on one device. With ``augment``, each crop is
    augmented from ``generator`` (on that device) at its magnification
    image_size / box side, as the reference augments the crop before its
    resize; the side is the source frame's, the box's times
    ``box_scale_denom`` (the decode_scale_denom d of the frames), so that
    the augmentation does not change with d (handmvnet_tpu/data/pipeline.py:62-71).

    Returns (rgb [B, V, S, S, 3] float32 normalised, heatmap
    [B, V, J, h, h] float32), the batch layout the model and the losses take.
    """
    b, v = full_rgb.shape[:2]
    boxes = bboxes.reshape(b * v, 4)
    crops = crop_resize(full_rgb.reshape(b * v, *full_rgb.shape[2:]), boxes, image_size)
    if augment:
        if generator is None:
            raise ValueError("preprocess_views(augment=True) needs a generator")
        sides = torch.clamp((boxes[:, 2] - boxes[:, 0]).to(torch.float32)
                            * float(box_scale_denom), min=1.0)
        crops = augment_batch(crops, generator, image_size / sides)
    rgb = mask_normalize(crops, any_visible.reshape(b * v))
    heatmaps = render_gaussian_heatmaps_resized(
        joints_crop.reshape(b * v, -1, 2), image_size, heatmap_size)
    return (rgb.reshape(b, v, image_size, image_size, 3),
            heatmaps.reshape(b, v, -1, heatmap_size, heatmap_size))
