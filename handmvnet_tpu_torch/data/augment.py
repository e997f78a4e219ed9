"""Photometric augmentation of the train split on the device, and the
dormant square-box jitter (counterpart of handmvnet_tpu/data/augment.py).

The reference augments each sample on the CPU with PIL/cv2
(src/datasets/augment.py:132-152): ColorJitter(brightness .2, saturation
.1, hue .005) -> random blur (box/median/gaussian, k in {3, 5, 7}, p=.4) ->
RandomAdjustSharpness(2, p=.3) -> RandomPosterize(6 bits, p=.3) -> a random
square occlusion patch of 8-64 px (p=.3). The JAX package applies the same
perturbations to the cropped and resized float images, batched over B x V,
with the spatially sized ones (blur widths, occlusion patches) given in
crop pixels and scaled by each crop's raster/crop magnification
(``crop_scale``). Its one deviation, median blur done as box blur, is kept.

Here the work is split in two, both batched over N images [N, S, S, 3]
float32 in [0, 1] on their device:
  * ``draw_augmentation``: every factor of every image in one draw from a
    ``torch.Generator`` on that device, with no read to the host;
  * ``apply_augmentation``: the chain of ``augment_image``, deterministic
    given the draws, op for op as the JAX functions compute it.
The random streams differ from jax.random's; the distributions are the
same. ``augment_batch`` composes the two. ``jitter_square_boxes`` (which no
config turns on) is split the same way: ``draw_box_jitter`` and
``apply_box_jitter``.
"""

from __future__ import annotations

import numpy as np
import torch

_RGB_TO_GRAY = (0.299, 0.587, 0.114)
_GAUSS_RADIUS = 15  # static tap radius: covers k=7 at crop scales up to ~4x
# torchvision's adjust_sharpness kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13, rounded to
# float32 as the JAX package builds it
_SHARP_EDGE = float(np.float32(1.0) / np.float32(13.0))
_SHARP_CENTER = float(np.float32(5.0) / np.float32(13.0))


def draw_augmentation(n: int, generator: torch.Generator,
                      device: str | torch.device) -> dict[str, torch.Tensor]:
    """The factors of ``augment_image`` (handmvnet_tpu/data/augment.py:146-197)
    for n images, [n] tensors on ``device`` (the generator's). A draw in
    {0, 1, 2} is floor(3 u); the occlusion's grid cell is left as two
    uniforms, which ``apply_augmentation`` scales by each image's row and
    column count and floors, as randint(0, rows) draws it."""
    u = torch.rand(n, 13, generator=generator, device=device)

    def third(col: int) -> torch.Tensor:  # uniform on {0, 1, 2}
        return torch.clamp(torch.floor(u[:, col] * 3.0), max=2.0)

    return {
        "brightness": u[:, 0] * 0.4 + 0.8,  # U[0.8, 1.2]
        "saturation": u[:, 1] * 0.2 + 0.9,  # U[0.9, 1.1]
        "hue": u[:, 2] * 0.01 - 0.005,  # U[-0.005, 0.005] turns
        "blur": u[:, 3] < 0.4,
        "gauss": third(4) == 2.0,  # kind in {box, box (median), gauss}
        "blur_k": third(5) * 2.0 + 3.0,  # {3, 5, 7} crop px
        "sigma": third(6) + 1.0,  # {1, 2, 3} crop px
        "sharpen": u[:, 7] < 0.3,
        "posterize": u[:, 8] < 0.3,
        "occlude": u[:, 9] < 0.3,
        "occ_size": torch.clamp(torch.floor(u[:, 10] * 57.0), max=56.0) + 8.0,  # 8..64 crop px
        "occ_row": u[:, 11],
        "occ_col": u[:, 12],
    }


def _per_image(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, 1, 1, 1)


def _adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    gray = (img[..., 0] * _RGB_TO_GRAY[0] + img[..., 1] * _RGB_TO_GRAY[1]
            + img[..., 2] * _RGB_TO_GRAY[2])[..., None]
    return gray + (img - gray) * factor


def _adjust_hue(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Hue rotation as a rotation of the YIQ chroma (delta in turns)."""
    theta = delta.reshape(-1, 1, 1) * 2.0 * np.pi
    cos_h, sin_h = torch.cos(theta), torch.sin(theta)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    i = 0.596 * r - 0.274 * g - 0.322 * b
    q = 0.211 * r - 0.523 * g + 0.312 * b
    i2 = i * cos_h - q * sin_h
    q2 = i * sin_h + q * cos_h
    r2 = y + 0.956 * i2 + 0.621 * q2
    g2 = y - 0.272 * i2 - 0.647 * q2
    b2 = y - 1.106 * i2 + 1.703 * q2
    return torch.stack([r2, g2, b2], dim=-1)


def _box_blur_axis(x: torch.Tensor, width: torch.Tensor, dim: int) -> torch.Tensor:
    """Box mean along ``dim`` of [N, H, W, C] with each image's integer width
    ([N]); the windows shrink at the borders. A cumsum and two gathers, as
    _box_blur_axis computes it."""
    n, size = x.shape[0], x.shape[dim]
    csum = torch.cumsum(x, dim=dim)
    idx = torch.arange(size, device=x.device)
    hi = torch.clamp(idx + (width // 2)[:, None], 0, size - 1)  # [N, size]
    lo = idx - ((width - 1) // 2)[:, None] - 1
    shape = [n, 1, 1, 1]
    shape[dim] = size
    hi_v = torch.take_along_dim(csum, hi.reshape(shape), dim=dim)
    lo_v = torch.where((lo >= 0).reshape(shape),
                       torch.take_along_dim(csum, torch.clamp(lo, 0, size - 1).reshape(shape),
                                            dim=dim), 0.0)
    count = (hi - torch.clamp(lo, min=-1)).to(x.dtype).reshape(shape)
    return (hi_v - lo_v) / count


def _box_blur(img: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Separable box blur, each image at its own width (at least 1)."""
    width = torch.clamp(width, min=1)
    return _box_blur_axis(_box_blur_axis(img, width, 1), width, 2)


def _edge_pad(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    idx = torch.arange(-pad, x.shape[dim] + pad, device=x.device)
    return x.index_select(dim, torch.clamp(idx, 0, x.shape[dim] - 1))


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian with each image's sigma ([N]), truncated at
    +-support pixels, over 31 static taps with edge padding."""
    xs = torch.arange(-_GAUSS_RADIUS, _GAUSS_RADIUS + 1, dtype=img.dtype, device=img.device)
    g = (torch.exp(-(xs ** 2) / (2.0 * sigma[:, None] * sigma[:, None]))
         * (torch.abs(xs) <= support[:, None]))
    g = g / g.sum(dim=1, keepdim=True)  # [N, 31]
    out = img
    for dim in (1, 2):
        size = out.shape[dim]
        x = _edge_pad(out, dim, _GAUSS_RADIUS)
        out = _per_image(g[:, 0]) * x.narrow(dim, 0, size)
        for i in range(1, 2 * _GAUSS_RADIUS + 1):
            out = out + _per_image(g[:, i]) * x.narrow(dim, i, size)
    return out


def _sharpness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """torchvision's adjust_sharpness: a blend with a fixed 3x3 smoothing
    (edge-padded, as the JAX function pads)."""
    h, w = img.shape[1:3]
    x = _edge_pad(_edge_pad(img, 1, 1), 2, 1)
    smooth = None
    for i in range(3):
        for j in range(3):
            tap = (_SHARP_CENTER if (i, j) == (1, 1) else _SHARP_EDGE) * x[:, i:i + h, j:j + w]
            smooth = tap if smooth is None else smooth + tap
    return smooth + (img - smooth) * factor


def _posterize(img: torch.Tensor, bits: int = 6) -> torch.Tensor:
    """Keep the top ``bits`` bits of each 8-bit channel (img in [0, 1])."""
    q = torch.floor(img * 255.0).to(torch.int32)
    q = (q >> (8 - bits)) << (8 - bits)
    return q.to(img.dtype) / 255.0


def _occlude(img: torch.Tensor, size_crop: torch.Tensor, row_u: torch.Tensor,
             col_u: torch.Tensor, crop_scale: torch.Tensor) -> torch.Tensor:
    """A square zero patch of side size_crop crop px on each image's grid of
    such squares in crop space (reference augment.py:102-129), mapped onto
    the raster by crop_scale; the cell is floor(u * rows) (rows, cols >= 1)."""
    h, w = img.shape[1:3]
    size = size_crop * crop_scale  # raster-space patch side
    rows = torch.clamp((h / crop_scale / size_crop).to(torch.int32), min=1)
    cols = torch.clamp((w / crop_scale / size_crop).to(torch.int32), min=1)
    r = torch.minimum(torch.floor(row_u * rows), (rows - 1).to(torch.float32))
    c = torch.minimum(torch.floor(col_u * cols), (cols - 1).to(torch.float32))
    y0, x0 = (r * size)[:, None, None], (c * size)[:, None, None]
    size = size[:, None, None]
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    inside = (xs >= x0) & (xs < x0 + size) & (ys >= y0) & (ys < y0 + size)
    return torch.where(inside[..., None], 0.0, img)


def apply_augmentation(images: torch.Tensor, draws: dict[str, torch.Tensor],
                       crop_scales: torch.Tensor) -> torch.Tensor:
    """The chain of handmvnet_tpu/data/augment.py::augment_image on N images
    [N, H, W, 3] float32 in [0, 1] at the given draws (``draw_augmentation``'s
    keys, [N] each) and raster/crop magnifications ``crop_scales`` [N]:
    colour jitter and a clip, blur, sharpness and a clip, posterize,
    occlusion. Every branch is computed for every image and selected per
    image, so nothing reads back to the host."""
    scale = crop_scales.to(torch.float32)
    img = images * _per_image(draws["brightness"])
    img = _adjust_saturation(img, _per_image(draws["saturation"]))
    img = torch.clamp(_adjust_hue(img, draws["hue"]), 0.0, 1.0)

    k = draws["blur_k"] * scale
    box = _box_blur(img, torch.round(k).to(torch.int64))  # round half to even, as jnp.round
    gauss = _gaussian_blur(img, draws["sigma"] * scale, k / 2.0)
    blurred = torch.where(_per_image(draws["gauss"]), gauss, box)
    img = torch.where(_per_image(draws["blur"]), blurred, img)

    img = torch.where(_per_image(draws["sharpen"]), _sharpness(img, 2.0), img)
    img = torch.clamp(img, 0.0, 1.0)
    img = torch.where(_per_image(draws["posterize"]), _posterize(img, 6), img)
    occluded = _occlude(img, draws["occ_size"], draws["occ_row"], draws["occ_col"], scale)
    return torch.where(_per_image(draws["occlude"]), occluded, img)


def augment_batch(images: torch.Tensor, generator: torch.Generator,
                  crop_scales: torch.Tensor) -> torch.Tensor:
    """images: [N, H, W, 3] float32 in [0, 1]; an independent augmentation of
    each image, drawn from ``generator`` (on the images' device). crop_scales:
    [N] raster/crop magnifications."""
    draws = draw_augmentation(images.shape[0], generator, images.device)
    return apply_augmentation(images, draws, crop_scales)


def draw_box_jitter(shape: tuple[int, ...], generator: torch.Generator,
                    device: str | torch.device, max_shift: float = 10.0,
                    max_scale: float = 0.1) -> dict[str, torch.Tensor]:
    """The draws of ``jitter_square_boxes`` for boxes of ``shape`` [..., 4]:
    a centre shift [..., 2] in U[-max_shift, max_shift] px and a side
    factor [...] in U[1 - max_scale, 1 + max_scale]."""
    batch = tuple(shape[:-1])
    shift = torch.rand(*batch, 2, generator=generator, device=device) * (2 * max_shift) - max_shift
    scale = 1.0 + (torch.rand(*batch, generator=generator, device=device) * (2 * max_scale)
                   - max_scale)
    return {"shift": shift, "scale": scale}


def apply_box_jitter(boxes: torch.Tensor, draws: dict[str, torch.Tensor]) -> torch.Tensor:
    """Shift the centre of square xyxy boxes [..., 4] and scale their side
    by the draws, keeping them square."""
    center = (boxes[..., 0:2] + boxes[..., 2:4]) * 0.5 + draws["shift"]
    half = (boxes[..., 2] - boxes[..., 0]) * draws["scale"] * 0.5
    return torch.cat([center - half[..., None], center + half[..., None]], dim=-1)


def jitter_square_boxes(boxes: torch.Tensor, generator: torch.Generator,
                        max_shift: float = 10.0, max_scale: float = 0.1) -> torch.Tensor:
    """Randomly shift and scale square xyxy boxes [..., 4], keeping them
    square: the reference's dormant bbox-jitter augmentation, drawn from
    ``generator`` (on the boxes' device)."""
    draws = draw_box_jitter(boxes.shape, generator, boxes.device, max_shift, max_scale)
    return apply_box_jitter(boxes, draws)
