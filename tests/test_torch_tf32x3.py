"""The precision argument of the fp32 kernels, checked on the CPU.

The fp32 CUDA kernels (csrc/attention.cu, csrc/stem.cu) run every product
on the tensor cores in 3xTF32 (csrc/mma.cuh): each f32 operand x is split into
hi = tf32(x) and lo = tf32(x - hi), and a b is taken as lo_a hi_b + hi_a lo_b
+ hi_a hi_b in one f32 accumulator, 8 terms of k at a time. Here numpy
emulates that arithmetic (cvt.rna.tf32.f32 and the three-product split sum)
at the main path's attention shapes and a small stem, and holds it against
the JAX package's Pallas kernels in interpret mode at the port's fp32
tolerances: attention 2e-5 absolute, stem 1e-5 x max|ref|. One TF32 product
alone (hi_a hi_b) misses both; its error is printed beside each case
(``pytest -s``) and asserted to exceed the tolerance, so the test also shows
why the split is needed. K1's second fp32 kernel ("query_tiles",
csrc/attention_tiles.cu) leaves lo = x - hi unrounded for the tensor core to
truncate, splits each row tile's keys over two warps and merges their
softmaxes: its emulation is held to the same 2e-5 at (105, 105). The stem's
emulation is its wgmma kernel's: the K order of csrc/stem.cu (window rows of
22 elements, a padded tap first, then 7 columns x 3 channels; K = 154 padded
to 160), the weights' lo rounded and the image's truncated, and per k step
of 8 the three m64n64k8 products hi_a lo_b, lo_a hi_b, hi_a hi_b added to
one accumulator. The card holds the kernels themselves against the
plain versions at the same tolerances (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from handmvnet_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from handmvnet_tpu.ops.pallas.stem import _reorder_weights, stem_s2d_fused

K_STEP = 8  # k of one mma.m16n8k8
LOG2E = np.float32(1.4426950408889634)


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits (the 13 low bits cleared). Finite inputs."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_truncated(x: np.ndarray) -> np.ndarray:
    """An f32 operand as the tensor core reads it for a TF32 product: its 13
    low mantissa bits dropped."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_matmul(a: np.ndarray, b: np.ndarray, split: bool, lo=tf32, lo_b=None,
                b_lo_first: bool = False) -> np.ndarray:
    """a [..., M, K] @ b [..., K, N] as the tensor cores take it: per step of
    8 k, each TF32 product summed exactly and added to an f32 accumulator.
    split: 3xTF32 (lo_a hi_b, hi_a lo_b, hi_a hi_b, or with b_lo_first hi_a
    lo_b first); else hi_a hi_b alone. lo: how x - hi becomes TF32 (rounded by
    cvt.rna, or truncated as read); lo_b: the same for b where it differs."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = lo(a - a_hi), (lo_b or lo)(b - b_hi)
    small = [(a_hi, b_lo), (a_lo, b_hi)] if b_lo_first else [(a_lo, b_hi), (a_hi, b_lo)]
    terms = small + [(a_hi, b_hi)] if split else [(a_hi, b_hi)]
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        for x, y in terms:
            step = x[..., k0:k0 + K_STEP].astype(np.float64) @ y[..., k0:k0 + K_STEP, :]
            acc = (acc + step).astype(np.float32)
    return acc


def attention_emulated(q, k, v, scale, split):
    """The fp32 attention kernel's arithmetic: S = Q K^T and O = P V in
    (3x)TF32, the softmax in f32 with exp2 of log2-scaled logits, O / l."""
    s = tf32_matmul(q, np.swapaxes(k, -1, -2), split) * (np.float32(scale) * LOG2E)
    p = np.exp2(s - s.max(axis=-1, keepdims=True)).astype(np.float32)
    return tf32_matmul(p, v, split) / p.sum(axis=-1, keepdims=True, dtype=np.float32)


def attention_tiles_emulated(q, k, v, scale, key_splits):
    """The "query_tiles" fp32 kernel's arithmetic: S = Q K^T and each split's
    P V in 3xTF32 with lo truncated; for each run of keys (key_splits: its
    bounds, as a warp takes them) the max m_w, the sum l_w and O_w = P_w V_w
    with p = exp2(s - m_w); then O = sum_w O_w exp2(m_w - m) / sum_w l_w
    exp2(m_w - m)."""
    s = tf32_matmul(q, np.swapaxes(k, -1, -2), True, tf32_truncated) * (np.float32(scale) * LOG2E)
    parts = []
    for lo, hi in zip(key_splits[:-1], key_splits[1:]):
        m = s[..., lo:hi].max(axis=-1, keepdims=True)
        p = np.exp2(s[..., lo:hi] - m).astype(np.float32)
        parts.append((m, p.sum(axis=-1, keepdims=True, dtype=np.float32),
                      tf32_matmul(p, v[..., lo:hi, :], True, tf32_truncated)))
    m = np.max([part[0] for part in parts], axis=0)
    total = sum(l_w * np.exp2(m_w - m) for m_w, l_w, _ in parts).astype(np.float32)
    return sum(o_w * (np.exp2(m_w - m) / total) for m_w, _, o_w in parts).astype(np.float32)


def test_query_tiles_fp32_holds_the_fp32_tolerance():
    """At (105, 105) a block's row tiles take the keys in two warps: 14 tiles
    of 8 keys, 7 each (keys 0-55 and 56-104)."""
    rng = np.random.default_rng(210)
    q, k, v = (rng.normal(size=(1, 8, 105, 128)).astype(np.float32) for _ in range(3))
    scale = 128 ** -0.5
    ref = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         scale, interpret=True))
    got = attention_tiles_emulated(q, k, v, scale, (0, 56, 105))
    err = float(np.abs(got - ref).max())
    print(f"query_tiles fp32 (105, 105): max_abs_err={err:.3e}, tolerance 2e-5")
    assert got.shape == ref.shape and err <= 2e-5, err


def stem_k_order(win: int = 7) -> list:
    """The K order of csrc/stem.cu's kernels: each window row r a run of
    (3 win + 1) // 2 * 2 elements, its padded taps first, then win columns x 3
    channels (the image's NHWC order); win 7 the kernels' (runs of 22, K =
    154), win 8 the TPU kernel's s2d order over an 8 x 8 window whose first
    row and column are zero (K = 192). Each k's tap (c, kh, kw), or None."""
    run = (3 * win + 1) // 2 * 2
    front = run - 3 * win
    taps = []
    for k in range(win * run):
        r, e = divmod(k, run)
        e -= front
        valid = r >= win - 7 and e >= 3 * (win - 7)
        taps.append((e % 3, r - (win - 7), e // 3 - (win - 7)) if valid else None)
    return taps


def stem_weight_matrix(kernel: np.ndarray, win: int = 7) -> np.ndarray:
    """kernel [7, 7, 3, F] HWIO -> [K, F] rows in stem_k_order, zeros at the
    padded taps."""
    rows = [kernel[kh, kw, c] if tap else np.zeros(kernel.shape[-1], kernel.dtype)
            for tap in stem_k_order(win) for c, kh, kw in [tap or (0, 0, 0)]]
    return np.stack(rows)


def stem_emulated(x, kernel, split):
    """The fp32 stem kernel's arithmetic: the 7x7 / stride 2 / pad 3 conv as
    im2col [pixels, K] x W [K, 64] in the kernel's K order, padded with zeros
    to 160 (20 k steps of 8); the image's lo truncated, the weights' rounded,
    and per step hi_a lo_b, lo_a hi_b, hi_a hi_b. x [N, H, W, 3] NHWC, kernel
    [7, 7, 3, 64] HWIO."""
    n, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    xp = np.pad(x, ((0, 0), (3, 4), (3, 4), (0, 0)))
    zero = np.zeros((n, ho, wo), np.float32)
    taps = [xp[:, kh:kh + 2 * ho:2, kw:kw + 2 * wo:2, c] if tap else zero
            for tap in stem_k_order() for c, kh, kw in [tap or (0, 0, 0)]]
    cols = np.stack(taps + [zero] * (160 - len(taps)), axis=-1)  # [N, Ho, Wo, 160]
    weights = stem_weight_matrix(kernel)
    weights = np.concatenate([weights, np.zeros((160 - len(weights), 64), np.float32)])
    return tf32_matmul(cols.reshape(-1, 160), weights, split, tf32_truncated, tf32,
                       b_lo_first=True).reshape(n, ho, wo, 64)


@pytest.mark.parametrize("win", [7, 8])
def test_stem_k_order_holds_every_tap_once(win):
    taps = [tap for tap in stem_k_order(win) if tap is not None]
    assert sorted(taps) == [(c, kh, kw) for c in range(3) for kh in range(7) for kw in range(7)]


def test_stem_k_order_192_is_the_tpu_kernels():
    """The 8 x 8 window's order (the kernel's kWin = 8 variant) is the Pallas
    kernel's s2d column order (a, r, b, s, c), bitwise."""
    kernel = np.random.default_rng(192).normal(size=(7, 7, 3, 64)).astype(np.float32)
    ours = stem_weight_matrix(kernel, 8)
    assert ours.shape == (192, 64)
    assert np.array_equal(ours, np.asarray(_reorder_weights(jnp.asarray(kernel))))


CASES = [("attention", (168, 168)), ("attention", (21, 147)), ("attention", (21, 21)),
         ("stem", (2, 64, 64)), ("stem", (1, 32, 96))]


@pytest.mark.parametrize("kernel,shape", CASES, ids=[f"{k}-{'x'.join(map(str, s))}"
                                                     for k, s in CASES])
def test_tf32x3_holds_the_fp32_tolerance(kernel, shape):
    rng = np.random.default_rng(sum(shape))
    if kernel == "attention":
        nq, nk = shape
        q, k, v = (rng.normal(size=(1, 8, n, 128)).astype(np.float32) for n in (nq, nk, nk))
        scale = 128 ** -0.5
        ref = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             scale, interpret=True))
        tol = 2e-5  # tests/test_pallas_attention.py's forward tolerance
        got = {split: attention_emulated(q, k, v, scale, split) for split in (True, False)}
    else:
        n, h, w = shape
        x = rng.normal(size=(n, h, w, 3)).astype(np.float32)
        kern = (rng.normal(size=(7, 7, 3, 64)) * 0.05).astype(np.float32)
        ref = np.asarray(stem_s2d_fused(jnp.asarray(x), jnp.asarray(kern), interpret=True))
        tol = 1e-5 * float(np.abs(ref).max())
        got = {split: stem_emulated(x, kern, split) for split in (True, False)}
    err = {split: float(np.abs(out - ref).max()) for split, out in got.items()}
    print(f"{kernel} {shape}: 3xTF32 max_abs_err={err[True]:.3e}, "
          f"1xTF32 max_abs_err={err[False]:.3e}, tolerance {tol:.3e}")
    assert got[True].shape == ref.shape
    assert err[True] <= tol, err
    assert err[False] > tol, err  # one TF32 product would not do
