"""Port parity, attention (K1): handmvnet_tpu_torch.ops.attention and
models.layers.MultiHeadAttention against the JAX package on the CPU, in fp32,
and in bf16 for the function the card's bf16 kernel computes.

On a CPU tensor ``fused_attention`` computes its plain version, which is what
these tests hold against the Pallas kernel (interpret mode) and its jnp
oracle. The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handmvnet_tpu.models.layers import MultiHeadAttention as FlaxMHA
from handmvnet_tpu.ops.pallas.attention import _attention_jnp
from handmvnet_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.models.layers import MultiHeadAttention
from handmvnet_tpu_torch.ops.attention import (
    DESIGNS, attention_design, attention_plain, fused_attention)
from torch_parity import random_flax_variables

# the (Nq, Nk) pairs one b1 x v8 forward launches: self blocks over 168
# tokens, the cross block (21 queries over 147), self blocks over 21
MAIN_PATH_SHAPES = [(168, 168), (21, 147), (21, 21)]
# a training microbatch's (batch 8, 5 views) and an eval batch's (16): 105
# tokens, the cross block's 21 queries over 84, 21
BATCHED_SHAPES = [(105, 105), (21, 84), (21, 21)]
ATOL = 2e-5  # tests/test_pallas_attention.py's forward tolerance


def _qkv(nq, nk, seed, batch=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(batch, 8, nq, 128)).astype(np.float32)
    k = rng.normal(size=(batch, 8, nk, 128)).astype(np.float32)
    v = rng.normal(size=(batch, 8, nk, 128)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("nq,nk", MAIN_PATH_SHAPES)
def test_plain_matches_pallas_interpret_and_jnp(nq, nk):
    q, k, v = _qkv(nq, nk, seed=nq * 1000 + nk)
    scale = 128 ** -0.5
    ours = fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           scale).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = np.asarray(jax_fused_attention(jq, jk, jv, scale, interpret=True))
    oracle = np.asarray(_attention_jnp(jq, jk, jv, scale))
    assert ours.shape == oracle.shape == (1, 8, nq, 128)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)
    np.testing.assert_allclose(ours, oracle, atol=ATOL)


@pytest.mark.parametrize("nq,nk", MAIN_PATH_SHAPES)
def test_plain_matches_pallas_interpret_bf16(nq, nk):
    """The bf16 function the card's kernel is held to: the plain version in
    bf16 against the Pallas kernel in bf16 (which rounds p to bf16 before
    the p v product), within 2^-6 x max|plain|, an ulp or two."""
    q, k, v = _qkv(nq, nk, seed=0)
    scale = 128 ** -0.5
    ours = fused_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                           scale)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    pallas = jax_fused_attention(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)),
                                 scale, interpret=True)
    assert pallas.dtype == jnp.bfloat16
    pallas = np.asarray(pallas.astype(jnp.float32))
    assert ours.shape == pallas.shape == (1, 8, nq, 128)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=2.0 ** -6 * np.abs(ours).max())


@pytest.mark.parametrize("nq,nk", BATCHED_SHAPES)
def test_plain_matches_pallas_interpret_at_batch_8(nq, nk):
    """The batched shapes the "query_tiles" kernel serves, as a training
    microbatch has them (batch 8)."""
    q, k, v = _qkv(nq, nk, seed=nq * 1000 + nk + 8, batch=8)
    scale = 128 ** -0.5
    ours = fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           scale).numpy()
    pallas = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            scale, interpret=True))
    assert ours.shape == pallas.shape == (8, 8, nq, 128)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


FP32, BF16 = torch.float32, torch.bfloat16
K, T = "key_split", "query_tiles"
# (dtype, batch, (Nq, Nk) of the forward, the design of each call) for every
# K1 call chip_smoke.py times or counts: serving b1 x 8 views (the main path,
# HR, export, int8, the family, a view rank's fuse stage), infer.py at b1 x 5,
# a training microbatch (batch 8), an eval batch (16), the absolute-root
# branch at serving (b1, 8 views) and in training (batch 8, 5 views); and a
# key count past both tiles
DESIGN_CASES = [
    (FP32, 1, MAIN_PATH_SHAPES, (K, K, K)), (BF16, 1, MAIN_PATH_SHAPES, (T, T, T)),
    (FP32, 1, BATCHED_SHAPES, (K, K, K)), (BF16, 1, BATCHED_SHAPES, (T, T, T)),
    (FP32, 8, BATCHED_SHAPES, (T, K, K)), (BF16, 8, BATCHED_SHAPES, (T, T, T)),
    (FP32, 16, BATCHED_SHAPES, (T, T, T)), (BF16, 16, BATCHED_SHAPES, (T, T, T)),
    (FP32, 1, [(8, 8), (1, 7), (1, 1)], (K, K, K)), (BF16, 1, [(8, 8), (1, 7), (1, 1)], (T, T, T)),
    (FP32, 8, [(5, 5), (1, 4), (1, 1)], (K, K, K)), (BF16, 8, [(5, 5), (1, 4), (1, 1)], (T, T, T)),
    (FP32, 16, [(21, 300), (21, 129)], (K, K)), (BF16, 16, [(21, 300), (21, 193)], (K, K)),
]


@pytest.mark.parametrize("dtype,batch,shapes,designs", DESIGN_CASES)
def test_attention_design_at_every_timed_shape(dtype, batch, shapes, designs):
    got = tuple(attention_design(dtype, batch, 8, nq, nk) for nq, nk in shapes)
    assert got == designs and set(got) <= set(DESIGNS)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(21, 147, seed=1))
    before = fused_attention.launches, dict(fused_attention.design_launches)
    out = fused_attention(q, k, v, 0.1)
    assert (fused_attention.launches, fused_attention.design_launches) == before
    torch.testing.assert_close(out, attention_plain(q, k, v, 0.1), rtol=0, atol=0)


def test_plain_accepts_strided_views():
    """The model hands the kernel [b, n, h, d] projections viewed as
    [b, h, n, d]; the result must not depend on the layout."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(21, 147, seed=2))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    torch.testing.assert_close(fused_attention(*views, 0.3), attention_plain(q, k, v, 0.3))


@pytest.mark.parametrize("cql", [0, 21], ids=["self", "cross"])
def test_multihead_attention_matches_flax(cql):
    """One fusion block at its b1 x v8 width: 168 tokens of 524 features."""
    rng = np.random.default_rng(11 + cql)
    x = rng.normal(size=(1, 168, 524)).astype(np.float32)
    flax_mha = FlaxMHA(d_model=524, dropout=0.0, custom_query_length=cql)
    variables = random_flax_variables(flax_mha, 5 + cql, jnp.asarray(x))
    ref = np.asarray(flax_mha.apply(variables, jnp.asarray(x)))

    port = MultiHeadAttention(524, custom_query_length=cql)
    port.load_state_dict(load_flax_variables(variables), strict=True)
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (1, 168 if cql == 0 else cql, 524)
    # two LayerNorms over 1024-wide products; outputs are O(1)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)
