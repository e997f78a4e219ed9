"""Fused attention core of the fusion blocks (counterpart of
handmvnet_tpu/ops/pallas/attention.py).

The core is the custom op ``hmv::fused_attention`` (``torch.library``), so
that ``torch.export`` keeps it as one node of a graph. Its CUDA
implementation launches one of two hand-written kernels or raises:
``attention_design`` picks, from the call's dtype and shape, between
"key_split" (csrc/attention.cu: 16 query rows a block, its warps splitting
the keys; fp32 at batch 1) and "query_tiles" (csrc/attention_tiles.cu: up to
64 query rows of one (batch, head) a block, Q, K and V loaded once by TMA;
bf16, and fp32 at the batched training and eval shapes). Its CPU
implementation computes ``attention_plain``. Both return
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
DESIGNS = ("key_split", "query_tiles")
# the most keys a "query_tiles" block holds: K and V beside the block's query
# rows in shared memory. The rule is pure, so it holds its own copy of the
# library's hmv_attention_tiles_max_keys; the first CUDA launch of the design
# checks the two agree (_entry).
TILE_MAX_KEYS = {torch.float32: 128, torch.bfloat16: 192}
# fp32 takes "query_tiles" from this many (batch, head) pairs, and only where
# "key_split" would need more than one wave of blocks (16 query rows of one pair
# each) on the card's SMS streaming multiprocessors: below that, key_split's many
# small blocks finish first. bf16 takes "query_tiles" wherever the keys fit: it
# was faster at every shape timed, batch 1 included. kernel_variants.py's sweep
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, "K1's two designs").
TILE_MIN_PAIRS_F32 = 64
SMS = 132  # the SMs of the H100 SXM the sweep ran on


def attention_design(dtype: torch.dtype, batch: int, heads: int, nq: int, nk: int) -> str:
    """Which K1 kernel ``fused_attention`` launches for CUDA tensors of this
    dtype and shape, one of DESIGNS. A pure function of its arguments."""
    if nk > TILE_MAX_KEYS[dtype]:
        return "key_split"
    if dtype == torch.bfloat16:
        return "query_tiles"
    pairs = batch * heads
    key_split_blocks = pairs * -(-nq // 16)
    return "query_tiles" if pairs >= TILE_MIN_PAIRS_F32 and key_split_blocks > SMS \
        else "key_split"


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


_ENTRIES = {"key_split": ("attention", "hmv_attention_fwd"),
            "query_tiles": ("attention_tiles", "hmv_attention_tiles_fwd")}


def _entry(design: str):
    source, name = _ENTRIES[design]
    lib = _build.load(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        if design == "query_tiles":
            lib.hmv_attention_tiles_max_keys.argtypes = [ctypes.c_int]
            lib.hmv_attention_tiles_max_keys.restype = ctypes.c_int
            held = {dtype: lib.hmv_attention_tiles_max_keys(code)
                    for dtype, code in _DTYPES.items()}
            if held != TILE_MAX_KEYS:
                raise RuntimeError(f"fused_attention: {source}'s tile holds {held} keys, the "
                                   f"rule's TILE_MAX_KEYS {TILE_MAX_KEYS}")
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


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what neither kernel takes: they need CUDA tensors of one
    dtype (f32 or bf16), D = 128, a contiguous last dim."""
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
    if k.shape[:2] != (b, h) or k.shape[3] != d or d != HEAD_DIM or nq < 1 or k.shape[2] < 1:
        raise ValueError(f"fused_attention: shapes {tuple(q.shape)}, {tuple(k.shape)} "
                         f"(the kernel needs D = {HEAD_DIM})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("fused_attention: the head dim must be contiguous")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The forward on CUDA tensors (f32 or bf16, D = 128, any strides with a
    contiguous last dim and every row starting on 16 bytes) by the kernel
    that ``attention_design`` picks; raises on what it does not take."""
    _validate(q, k, v)
    b, h, nq, _ = q.shape
    return _run(q, k, v, scale, attention_design(q.dtype, b, h, nq, k.shape[2]))


def launch_design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  design: str) -> torch.Tensor:
    """``_launch`` with the kernel named, one of DESIGNS, whatever the rule
    would pick (the card tests hold each design at the same shapes). Raises
    on what that kernel does not take; never falls over to the other."""
    _validate(q, k, v)
    return _run(q, k, v, scale, design)


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         design: str) -> torch.Tensor:
    b, h, nq, d = q.shape
    nk = k.shape[2]
    lib, fn = _entry(design)
    out = _empty_out(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPES[q.dtype], b, h, nq, nk, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  float(scale), stream)
    _build.check(lib, code, f"fused_attention ({design})")
    fused_attention.launches += 1
    fused_attention.design_launches[design] += 1
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
fused_attention.design_launches = dict.fromkeys(DESIGNS, 0)  # the same, by design
