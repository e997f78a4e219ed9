"""Antialiased bilinear resize as two small products (counterpart of
handmvnet_tpu/ops/resize.py::resize_bilinear_antialias): out = W_y img W_x^T
with the static weight matrices of torchvision's Resize(antialias=True),
the filter torch's upsample_bilinear2d_aa uses:

  scale   = in / out
  support = max(scale, 1)
  center  = (i + 0.5) * scale
  taps j in [trunc(center - support + 0.5), trunc(center + support + 0.5))
  w_j     = max(0, 1 - |(j - center + 0.5) / support|), each row normalised.

The synthetic batch's heatmap labels take this path (rendered at image size,
resized to the heatmap size); the crop + resize + normalise of real frames
comes with the data path.
"""

from __future__ import annotations

import numpy as np
import torch


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
