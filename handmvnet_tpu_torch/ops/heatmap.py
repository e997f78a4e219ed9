"""Soft-argmax over heatmaps and Gaussian heatmap rendering (counterpart of
handmvnet_tpu/ops/heatmap.py)."""

from __future__ import annotations

import torch


def soft_argmax_2d(heatmap: torch.Tensor, temperature: float = 1000.0) -> torch.Tensor:
    """Expected (x, y) under softmax(temperature * heatmap).

    heatmap: [..., J, H, W] raw heatmaps -> [..., J, 2] in heatmap pixel
    units. Computed in the input dtype: callers promote low precisions first,
    since the x1000 softmax overflows bf16.
    """
    *lead, j, h, w = heatmap.shape
    probs = torch.softmax(heatmap.reshape(*lead, j, h * w) * temperature, dim=-1)
    probs = probs.reshape(*lead, j, h, w)
    xs = torch.arange(w, dtype=probs.dtype, device=probs.device)
    ys = torch.arange(h, dtype=probs.dtype, device=probs.device)
    expected_x = torch.einsum("...hw,w->...", probs, xs)
    expected_y = torch.einsum("...hw,h->...", probs, ys)
    return torch.stack([expected_x, expected_y], dim=-1)


def render_gaussian_heatmaps(points: torch.Tensor, height: int, width: int,
                             sigma: float = 2.0) -> torch.Tensor:
    """Gaussian heatmaps as the reference's rasteriser draws them.

    points: [..., 2] (x, y) in pixels of the map -> [..., height, width]
    float32. Each point is truncated to integers (x0, y0);
    exp(-((x-x0)^2 + (y-y0)^2) / (2 sigma^2)) is stamped on the window
    |x-x0|, |y-y0| <= 3 int(sigma), everything outside it is zero, and a
    point whose window misses the map leaves the map zero.
    """
    s = int(sigma)
    pts = points.to(torch.int32)  # truncation toward zero, as numpy's astype
    x0 = pts[..., 0][..., None, None]
    y0 = pts[..., 1][..., None, None]
    xs = torch.arange(width, dtype=torch.int32, device=points.device)[None, :]
    ys = torch.arange(height, dtype=torch.int32, device=points.device)[:, None]
    dx = (xs - x0).to(torch.float32)
    dy = (ys - y0).to(torch.float32)
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    in_window = ((xs - x0).abs() <= 3 * s) & ((ys - y0).abs() <= 3 * s)
    visible = (x0 - 3 * s < width) & (y0 - 3 * s < height) & (x0 + 3 * s + 1 >= 0) \
        & (y0 + 3 * s + 1 >= 0)
    return torch.where(in_window & visible, g, torch.zeros((), dtype=torch.float32))
