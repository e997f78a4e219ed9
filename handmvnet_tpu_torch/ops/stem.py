"""ResNet stem conv, 7x7 / stride 2 / pad 3, 3 -> 64 channels (counterpart of
handmvnet_tpu/ops/pallas/stem.py).

The conv is the custom op ``hmv::stem_conv`` (``torch.library``), so that
``torch.export`` keeps it as one node of a graph. Its CUDA implementation
launches the hand-written kernel (csrc/stem.cu: a persistent implicit GEMM on
wgmma, bf16 and 3xTF32) or raises; its CPU implementation computes
``stem_conv_plain``. Both return contiguous NCHW,
as its fake does; the kernel is exact at every input size, odd ones
included. Its backward takes the convolution's weight and input gradients
from ``torch.nn.grad``: the counterpart of the gradient XLA takes through
the JAX package's training stem, the plain ``lax.conv``, since the Pallas
kernel has no VJP. Callers use the plain function ``stem_conv_nchw``;
``stem_conv`` keeps the JAX package's NHWC input / HWIO kernel layout for
comparison with ``stem_s2d_fused``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from handmvnet_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WEIGHT_SHAPE = (64, 3, 7, 7)  # the kernel's OIHW weight
STRIDE, PADDING = 2, 3


def stem_conv_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x: [N, 3, H, W]; weight: [F, 3, 7, 7] OIHW -> [N, F, ceil(H/2), ceil(W/2)]."""
    return F.conv2d(x, weight.to(x.dtype), stride=STRIDE, padding=PADDING)


def _entry():
    lib = _build.load("stem")
    fn = lib.hmv_stem_conv
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib, fn


def stem_routes(x: torch.Tensor, out: torch.Tensor) -> tuple[str, str]:
    """How the kernel moves these tensors (CUDA only): the input patches and
    the output tiles, each "tma" or, where TMA cannot take the tensor's
    strides or alignment, "threads" (csrc/stem.cu's hmv_stem_routes)."""
    lib = _build.load("stem")
    fn = lib.hmv_stem_routes
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    n, _, h, w = x.shape
    bits = fn(_DTYPES[x.dtype], n, h, w, *x.stride(), x.data_ptr(), out.data_ptr())
    return tuple("tma" if bits >> i & 1 else "threads" for i in (0, 1))


def _out_shape(x: torch.Tensor) -> tuple[int, int, int, int]:
    n, _, h, w = x.shape
    return n, WEIGHT_SHAPE[0], (h + 1) // 2, (w + 1) // 2


def _launch(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors (f32 or bf16, input and weight alike);
    raises on what it does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv_nchw: unsupported device {x.device}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"stem_conv_nchw: dtypes {x.dtype}/{weight.dtype}; the kernel "
                        "takes float32 or bfloat16, input and weight alike")
    if weight.device != x.device:
        raise ValueError("stem_conv_nchw: x and weight on different devices")
    if x.dim() != 4 or x.shape[1] != 3 or tuple(weight.shape) != WEIGHT_SHAPE:
        raise ValueError(f"stem_conv_nchw: shapes {tuple(x.shape)}, {tuple(weight.shape)}; "
                         f"the kernel takes [N, 3, H, W] and {WEIGHT_SHAPE}")
    if not weight.is_contiguous():
        raise ValueError("stem_conv_nchw: weight must be contiguous OIHW")
    n, _, h, w = x.shape
    if not (1 <= n <= 65535 and h >= 1 and w >= 1):
        raise ValueError(f"stem_conv_nchw: input shape {tuple(x.shape)}")

    lib, fn = _entry()
    out = x.new_empty(_out_shape(x))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
                  n, h, w, *x.stride(), stream)
    _build.check(lib, code, "stem_conv_nchw")
    stem_conv_nchw.launches += 1
    return out


# the op; its CUDA implementation is the launch
_stem_conv_op = torch.library.custom_op(
    "hmv::stem_conv", _launch, mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor weight) -> Tensor")


@_stem_conv_op.register_kernel("cpu")
def _(x, weight):
    return stem_conv_plain(x, weight).contiguous()


@_stem_conv_op.register_fake
def _(x, weight):
    return x.new_empty(_out_shape(x))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    """Weight and input gradients by ``torch.nn.grad``, the input's only
    when asked for (a training image has none)."""
    x, weight = ctx.saved_tensors
    gx = gw = None
    if ctx.needs_input_grad[0]:
        gx = torch.nn.grad.conv2d_input(x.shape, weight.to(g.dtype), g,
                                        stride=STRIDE, padding=PADDING)
    if ctx.needs_input_grad[1]:
        gw = torch.nn.grad.conv2d_weight(x, weight.shape, g, stride=STRIDE,
                                         padding=PADDING).to(weight.dtype)
    return gx, gw


_stem_conv_op.register_autograd(_backward, setup_context=_setup_context)


def stem_conv_nchw(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The stem conv, differentiable in x and weight. x: [N, 3, H, W], any
    strides; weight: [64, 3, 7, 7] OIHW in x's dtype. CPU tensors take
    ``stem_conv_plain``; CUDA tensors launch the kernel (f32 or bf16) or
    raise. Returns contiguous NCHW."""
    return torch.ops.hmv.stem_conv(x, weight)


stem_conv_nchw.launches = 0  # forward kernel launches, for showing a run went through it


def stem_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """JAX-layout stem: x [N, H, W, 3] NHWC, kernel [7, 7, 3, F] HWIO ->
    [N, ceil(H/2), ceil(W/2), F] NHWC (a view of the NCHW result)."""
    weight = kernel.permute(3, 2, 0, 1).contiguous().to(x.dtype)
    return stem_conv_nchw(x.permute(0, 3, 1, 2), weight).permute(0, 2, 3, 1)
