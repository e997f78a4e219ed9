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
from handmvnet_tpu_torch.ops.attention import attention_plain, fused_attention
from torch_parity import random_flax_variables

# the (Nq, Nk) pairs one b1 x v8 forward launches: self blocks over 168
# tokens, the cross block (21 queries over 147), self blocks over 21
MAIN_PATH_SHAPES = [(168, 168), (21, 147), (21, 21)]
ATOL = 2e-5  # tests/test_pallas_attention.py's forward tolerance


def _qkv(nq, nk, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, 8, nq, 128)).astype(np.float32)
    k = rng.normal(size=(1, 8, nk, 128)).astype(np.float32)
    v = rng.normal(size=(1, 8, nk, 128)).astype(np.float32)
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


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(21, 147, seed=1))
    before = fused_attention.launches
    out = fused_attention(q, k, v, 0.1)
    assert fused_attention.launches == before
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
