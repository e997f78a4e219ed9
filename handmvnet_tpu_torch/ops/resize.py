"""Antialiased bilinear resize as two small products (counterpart of
handmvnet_tpu/ops/resize.py): out = W_y img W_x^T with the weight matrices of
torchvision's Resize(antialias=True), the filter torch's
upsample_bilinear2d_aa uses:

  scale   = in / out
  support = max(scale, 1)
  center  = (i + 0.5) * scale
  taps j in [trunc(center - support + 0.5), trunc(center + support + 0.5))
  w_j     = max(0, 1 - |(j - center + 0.5) / support|), each row normalised.

``resize_bilinear_antialias`` resizes with static weights (the heatmap
labels). ``crop_resize`` and ``mask_normalize`` are the reference's
crop_and_pad_image + Resize, then Normalize, of the loader
(src/datasets/ho3d.py:136-153) for a batch of frames, with the train split's
augmentation between them: the integer crop of each view's box folds into
its own weight matrices, built on the device, and pixels outside the frame
act as zero padding.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The [out_size, in_size] float32 antialias triangle-filter matrix."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    i = np.arange(out_size, dtype=np.float64)[:, None]
    j = np.arange(in_size, dtype=np.float64)[None, :]
    center = (i + 0.5) * scale
    lo = np.maximum(np.trunc(center - support + 0.5), 0.0)
    hi = np.minimum(np.trunc(center + support + 0.5), float(in_size))
    w = np.maximum(0.0, 1.0 - np.abs((j - center + 0.5) * (1.0 / support)))
    w = np.where((j >= lo) & (j < hi), w, 0.0)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def resize_bilinear_antialias(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize [..., H, W] maps to ``out_hw`` (the JAX function's
    ``channels=False`` form; images wait for the data path)."""
    wy = torch.from_numpy(resize_weights(img.shape[-2], out_hw[0])).to(img.device, img.dtype)
    wx = torch.from_numpy(resize_weights(img.shape[-1], out_hw[1])).to(img.device, img.dtype)
    return torch.einsum("oh,...hw,pw->...op", wy, img, wx)


def crop_resize_weights(lo_px: torch.Tensor, hi_px: torch.Tensor, in_size: int,
                        out_size: int) -> torch.Tensor:
    """[N, out_size, in_size] float32 weights resampling the pixels [lo, hi) of
    each of N rows of ``in_size`` pixels to ``out_size``, with the filter of
    ``resize_weights`` placed in crop coordinates. Taps that land outside
    [0, in_size) are zero padding: they take no pixel but count in each
    output row's normalisation, which sums the window over [-in, 2 in) as the
    JAX function does (handmvnet_tpu/ops/resize.py:72-100). lo_px, hi_px: [N]
    integers (any dtype), on the device the weights are built on."""
    lo = lo_px.to(torch.float32)[:, None, None]
    crop = (hi_px - lo_px).to(torch.float32)[:, None, None]
    scale = crop / out_size
    support = torch.clamp(scale, min=1.0)
    inv = 1.0 / support
    dev = lo.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    center = (i + 0.5) * scale  # crop coordinates, [N, out, 1]
    tap_lo = torch.clamp(torch.trunc(center - support + 0.5), min=0.0)
    tap_hi = torch.minimum(torch.trunc(center + support + 0.5), crop)

    def window(j: torch.Tensor) -> torch.Tensor:  # j: crop coordinates
        w = torch.clamp(1.0 - torch.abs((j - center + 0.5) * inv), min=0.0)
        return torch.where((j >= tap_lo) & (j < tap_hi), w, 0.0)

    j = torch.arange(in_size, dtype=torch.float32, device=dev)[None, None, :]
    jall = torch.arange(-in_size, 2 * in_size, dtype=torch.float32, device=dev)[None, None, :]
    denom = torch.clamp(window(jall).sum(dim=-1, keepdim=True), min=1e-12)
    return window(j - lo) / denom


def crop_resize(images: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Crop (integer box, zero padding) and antialiased resize of N frames,
    each with its own box: the counterpart of
    handmvnet_tpu/ops/resize.py::crop_resize_normalize(normalize=False)
    under vmap.

    images: [N, H, W, 3] uint8 (or float in [0, 255]); boxes: [N, 4] integer
    xyxy, which may leave the frame. Returns [N, out_size, out_size, 3]
    float32 in [0, 1]."""
    n, h, w, _ = images.shape
    img = images.to(torch.float32) / 255.0
    wy = crop_resize_weights(boxes[:, 1], boxes[:, 3], h, out_size)  # [N, S, H]
    wx = crop_resize_weights(boxes[:, 0], boxes[:, 2], w, out_size)  # [N, S, W]
    rows = torch.bmm(wy, img.reshape(n, h, w * 3)).reshape(n, out_size, w, 3)
    return torch.einsum("nowc,npw->nopc", rows, wx)


def mask_normalize(crops: torch.Tensor, visible: torch.Tensor | None = None) -> torch.Tensor:
    """The black-image rule and ImageNet normalisation of [N, S, S, 3] crops
    in [0, 1]: with ``visible`` ([N] bool), a view whose joints are all
    invisible becomes zeros before normalisation (reference
    ho3d.py:138-141); then the reference's ToTensor + Normalize
    (src/datasets/ho3d.py:35-40), as handmvnet_tpu/data/pipeline.py's
    preprocess_views masks and normalises."""
    if visible is not None:
        crops = crops * visible.reshape(-1, 1, 1, 1).to(torch.float32)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=crops.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=crops.device)
    return (crops - mean) / std
