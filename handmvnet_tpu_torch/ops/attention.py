"""Fused attention core of the fusion blocks (counterpart of
handmvnet_tpu/ops/pallas/attention.py).

The core is the custom op ``hmv::fused_attention`` (``torch.library``), so
that ``torch.export`` keeps it as one node of a graph. Its CUDA
implementation launches the hand-written kernel (csrc/attention.cu) or
raises; its CPU implementation computes ``attention_plain``. Both return
the kernel's layout, a [B, Nq, H, D] tensor seen as [B, H, Nq, D], and so
does its fake, whose shapes and strides ``torch.export`` traces with. Its
backward is ``attention_backward``, PyTorch ops that mirror the JAX
package's VJP (``_pallas_attention_bwd``): like it, they recompute the
softmax from the saved q, k, v, since neither package has a backward
kernel. Layout [B, H, N, D] as in the JAX package. Callers use the plain
function ``fused_attention``.
"""

from __future__ import annotations

import ctypes

import torch

from handmvnet_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 128  # the kernel's head width (dim_head of every fusion block)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over the last two dims, computed in >= f32
    and returned in q's dtype. q: [B, H, Nq, D]; k, v: [B, H, Nk, D]."""
    ct = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhid,bhjd->bhij", q.to(ct), k.to(ct)) * scale
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", attn, v.to(ct)).to(q.dtype)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T * scale) v for the output gradient g:
    p recomputed, then dv = p^T g, dp = g v^T, ds = p (dp - sum(dp p)),
    dq = ds k * scale, dk = ds^T q * scale. Computed in >= f32 and returned
    in the inputs' dtypes."""
    ct = torch.promote_types(q.dtype, torch.float32)
    qc, kc, vc, gc = (t.to(ct) for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bhid,bhjd->bhij", qc, kc) * scale, dim=-1)
    dv = torch.einsum("bhij,bhid->bhjd", p, gc)
    dp = torch.einsum("bhid,bhjd->bhij", gc, vc)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhij,bhjd->bhid", ds, kc) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, qc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _entry():
    lib = _build.load("attention")
    fn = lib.hmv_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib, fn


def _empty_out(q: torch.Tensor) -> torch.Tensor:
    """The output, written as [B, Nq, H, D] so that the caller's merge of
    heads is a free view, and seen as [B, H, Nq, D]."""
    b, h, nq, d = q.shape
    return q.new_empty((b, nq, h, d)).transpose(1, 2)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's forward on CUDA tensors (f32 or bf16, D = 128, any
    strides with a contiguous last dim and every row starting on 16 bytes);
    raises on what it does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernel takes float32 or bfloat16, all alike")
    if not (q.device == k.device == v.device):
        raise ValueError("fused_attention: q, k, v on different devices")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"fused_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d or d != HEAD_DIM or nq < 1 or nk < 1:
        raise ValueError(f"fused_attention: shapes {tuple(q.shape)}, {tuple(k.shape)} "
                         f"(the kernel needs D = {HEAD_DIM})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("fused_attention: the head dim must be contiguous")

    lib, fn = _entry()
    out = _empty_out(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPES[q.dtype], b, h, nq, nk, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  float(scale), stream)
    _build.check(lib, code, "fused_attention")
    fused_attention.launches += 1
    return out


# the op; its CUDA implementation is the launch
_fused_attention_op = torch.library.custom_op(
    "hmv::fused_attention", _launch, mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, float scale) -> Tensor")


@_fused_attention_op.register_kernel("cpu")
def _(q, k, v, scale):
    return _empty_out(q).copy_(attention_plain(q, k, v, scale))


@_fused_attention_op.register_fake
def _(q, k, v, scale):
    return _empty_out(q)


def _setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.scale = scale


def _backward(ctx, g):
    q, k, v = ctx.saved_tensors
    return (*attention_backward(q, k, v, g, ctx.scale), None)


_fused_attention_op.register_autograd(_backward, setup_context=_setup_context)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Multi-head attention core, differentiable in q, k and v.
    q: [B, H, Nq, D]; k, v: [B, H, Nk, D] -> [B, H, Nq, D]. CPU tensors take
    ``attention_plain``; CUDA tensors launch the kernel or raise."""
    return torch.ops.hmv.fused_attention(q, k, v, float(scale))


fused_attention.launches = 0  # forward kernel launches, for showing a run went through it
