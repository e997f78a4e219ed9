"""Soft-argmax over heatmaps (2D and 3D), the reference's integer argmax, and
Gaussian heatmap rendering (counterpart of handmvnet_tpu/ops/heatmap.py)."""

from __future__ import annotations

import torch

from handmvnet_tpu_torch.ops.resize import resize_weights


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


def soft_argmax_3d(heatmap3d: torch.Tensor, temperature: float = 1000.0) -> torch.Tensor:
    """Expected (x, y, z) under softmax(temperature * heatmap3d).

    heatmap3d: [..., J, D, H, W] -> [..., J, 3] in voxel units, in the input
    dtype (the reference's src/models/utils.py:7-32)."""
    *lead, j, d, h, w = heatmap3d.shape
    probs = torch.softmax(heatmap3d.reshape(*lead, j, d * h * w) * temperature, dim=-1)
    probs = probs.reshape(*lead, j, d, h, w)
    axes = [torch.arange(n, dtype=probs.dtype, device=probs.device) for n in (w, h, d)]
    return torch.stack([torch.einsum("...dhw,w->...", probs, axes[0]),
                        torch.einsum("...dhw,h->...", probs, axes[1]),
                        torch.einsum("...dhw,d->...", probs, axes[2])], dim=-1)


def hard_argmax_2d(heatmap: torch.Tensor) -> torch.Tensor:
    """The reference's integer argmax (src/models/utils.py:65-82,
    heatmaps_to_coordinates): [..., J, H, W] -> [..., J, 2] (x, y) float32,
    1-indexed, at the first maximum, and (0, 0) where the maximum is <= 0."""
    *lead, j, h, w = heatmap.shape
    flat = heatmap.reshape(*lead, j, h * w)
    idx = flat.argmax(dim=-1).to(torch.float32)  # the first maximum
    coords = torch.stack([torch.remainder(idx, w) + 1.0, torch.floor(idx / w) + 1.0], dim=-1)
    return coords * (flat.amax(dim=-1) > 0).to(coords.dtype)[..., None]


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


def render_gaussian_heatmaps_resized(points: torch.Tensor, full_size: int, out_size: int,
                                     sigma: float = 2.0) -> torch.Tensor:
    """``render_gaussian_heatmaps`` at full_size^2 then antialiased resize to
    out_size^2, without the full-size maps (the reference's label chain,
    src/datasets/ho3d.py:156-166). The Gaussian, its window and the
    separable resize are all rank-1, so each map is

        visible * (W (g_y m_y)) (W (g_x m_x))^T

    with W the [out, full] resize matrix: two small products per point.

    points: [..., 2] (x, y) in full_size pixels, truncated to integers as
    the rasteriser does -> [..., out_size, out_size] float32."""
    s = int(sigma)
    w_mat = torch.from_numpy(resize_weights(full_size, out_size)).to(points.device)
    pts = points.to(torch.int32)
    x0 = pts[..., 0][..., None]
    y0 = pts[..., 1][..., None]
    grid = torch.arange(full_size, dtype=torch.int32, device=points.device)
    gx = torch.exp(-((grid - x0).to(torch.float32) ** 2) / (2.0 * sigma * sigma))
    gy = torch.exp(-((grid - y0).to(torch.float32) ** 2) / (2.0 * sigma * sigma))
    gx = torch.where((grid - x0).abs() <= 3 * s, gx, 0.0)
    gy = torch.where((grid - y0).abs() <= 3 * s, gy, 0.0)
    visible = ((x0 - 3 * s < full_size) & (y0 - 3 * s < full_size)
               & (x0 + 3 * s + 1 >= 0) & (y0 + 3 * s + 1 >= 0)).to(torch.float32)
    rx = torch.einsum("of,...f->...o", w_mat, gx)
    ry = torch.einsum("of,...f->...o", w_mat, gy)
    return (ry[..., :, None] * rx[..., None, :]) * visible[..., None]
