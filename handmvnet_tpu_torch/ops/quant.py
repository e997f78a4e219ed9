"""Int8 post-training quantization of the backbone's convolutions for serving
(counterpart of handmvnet_tpu/ops/quant.py), behind ``model.backbone_int8``.

The scheme is the JAX package's, operation for operation:
  * weights: symmetric per-output-channel absmax scales, computed from the
    weights as the model holds them (fp32, or the bf16 copy of a bf16 model,
    as the JAX package's bf16 serving casts every variable first);
  * activations: a symmetric per-tensor dynamic absmax scale, computed per
    call;
  * scale = max(amax, 1e-12) / 127 and q = clamp(round(x / scale), -127,
    127): divisions, not products by a reciprocal, rounding half to even;
  * the convolution accumulates int8 x int8 products in int32 and
    dequantizes as int32 -> fp32 times (s_x * s_w[c]), cast to the input's
    dtype; a bias adds after the dequant, in fp32.

The route, on the card and on the CPU alike: an im2col of the quantized
activations (NCHW, the conv's padding and stride) and one ``torch._int_mm``
(cuBLASLt's int8 product with int32 accumulation on the card). ``F.unfold``
has no int8 kernel on CUDA, so it unfolds the quantized values while they
are still floats (integers of at most 127, exact in any float type) and
casts the columns to int8 after. The JAX package computes this as an XLA
int8 convolution; no Pallas kernel is involved.

These are the JAX package's operations as its source and its eager ops
compute them. Under jit XLA rewrites two of them, ``/ 127.0`` into a
product by float32(1/127) and the dequant scale s_x * s_w into (amax_w *
s_x) * float32(1/127), each a last-bit change of some scales; so the
jitted JAX model and the port agree to an ulp of those scales, and an
activation whose x / scale sits within that ulp of a half rounds to the
next int8 level, one step (amax / 127) away.

This changes the model's arithmetic: it serves in eval mode only, and a
``Q8Conv`` in train mode is the plain convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def quantize_sym(x: torch.Tensor, dim: tuple[int, ...] | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization of ``x`` (computed in fp32): the
    scale over all of it (``dim`` None, a 0-d scale) or over ``dim``, kept as
    size-1 axes. Returns (int8 values, fp32 scale)."""
    xf = x.float()
    amax = xf.abs().amax() if dim is None else xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N] through ``torch._int_mm``,
    zero-padded to its CUDA limits (M > 16; K and N multiples of 8; a row-
    major A and a column-major B); zeros add nothing to a sum."""
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(0, 17 - m), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    bt = b.t()  # [N, K]
    if pad_k or pad_n:
        bt = F.pad(bt, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return out[:m, :n] if pad_m or pad_n else out


def q8_conv_int32(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """The int32 sums of a convolution of int8 operands: xq [B, C, H, W],
    wq [O, C, kh, kw] -> [B, O, H', W'] int32, zero padding ``padding`` a
    side, square ``stride``."""
    b, c = xq.shape[:2]
    o, _, kh, kw = wq.shape
    ho = (xq.shape[2] + 2 * padding - kh) // stride + 1
    wo = (xq.shape[3] + 2 * padding - kw) // stride + 1
    if kh == kw == 1 and padding == 0:  # a 1x1 conv: the strided pixels are the rows
        cols = xq[:, :, ::stride, ::stride].permute(0, 2, 3, 1).reshape(b * ho * wo, c)
    else:  # [B, C*kh*kw, L], channel-major as the weight's rows
        cols = F.unfold(xq.float(), (kh, kw), padding=padding, stride=stride)
        cols = cols.transpose(1, 2).reshape(b * ho * wo, c * kh * kw).to(torch.int8)
    y = _int_mm(cols, wq.reshape(o, -1).t())  # [B*H'*W', O]
    return y.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def q8_conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
            padding: int = 0) -> torch.Tensor:
    """NCHW conv on the int8 path: per-tensor dynamic activation scale,
    per-output-channel weight scales, int32 sums, dequantized to x.dtype."""
    xq, sx = quantize_sym(x)
    wq, sw = quantize_sym(weight, dim=(1, 2, 3))  # [O, 1, 1, 1]
    y = q8_conv_int32(xq, wq, stride, padding)
    return (y.float() * (sx * sw).reshape(1, -1, 1, 1)).to(x.dtype)


class Q8Conv(nn.Conv2d):
    """An ``nn.Conv2d`` (square kernel, stride and padding, no groups or
    dilation) that serves on the int8 path in eval mode and is the plain
    convolution in train mode. Its parameters are the conv's (``weight``
    [O, C, kh, kw], the reference's layout, and ``bias``), so a state_dict
    loads into it unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        y = q8_conv(x, self.weight, self.stride[0], self.padding[0])
        if self.bias is not None:
            y = (y.float() + self.bias.float()[:, None, None]).to(x.dtype)
        return y
