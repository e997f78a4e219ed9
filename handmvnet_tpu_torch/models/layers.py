"""Building blocks shared by the backbone and the model core (counterpart of
handmvnet_tpu/models/layers.py).

Module and parameter names are the reference's torch names, so the port's
state_dict keys are the reference's keys (checkpoint.py maps the JAX
package's flax names onto them). Numerics follow the reference:
  * BatchNorm and LayerNorm epsilon 1e-5
  * GELU in its exact erf form
  * LeakyReLU negative slope 0.01
In ``.train()`` BatchNorm normalises with the batch statistics and updates
its running statistics as torch does (unbiased running variance, momentum
0.1), which is the JAX package's ``TorchBatchNorm``; ``Dropout`` draws its
masks from a ``torch.Generator`` that the caller passes down. In ``.eval()``
BatchNorm reads its running statistics and dropout is the identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from handmvnet_tpu_torch.ops import attention as attention_ops

BN_EPS = 1e-5
LN_EPS = 1e-5


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def sinusoidal_position_table(d_model: int, max_len: int) -> np.ndarray:
    """Transformer sinusoidal table [1, max_len, d_model] float32 (with the
    reference's odd-d_model branch)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((1, max_len, d_model), dtype=np.float64)
    pe[0, :, 0::2] = np.sin(position * div_term)
    if d_model % 2 == 0:
        pe[0, :, 1::2] = np.cos(position * div_term)
    else:
        pe[0, :, 1::2] = np.cos(position * div_term[:-1])
    return pe.astype(np.float32)


class Dropout(nn.Module):
    """Inverted dropout at rate ``p`` whose masks come from the generator
    passed to ``forward`` (``nn.Dropout`` reads the global RNG): kept
    elements are scaled by 1 / (1 - p), as flax's Dropout does. The identity
    in eval mode or at p = 0; in train mode with p > 0 a generator is
    required."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate {p} outside [0, 1)")
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout draws its masks from an explicit "
                             "torch.Generator: pass generator=")
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=generator)
        return x * keep / (1.0 - self.p)


class FeedForward(nn.Module):
    """LN -> Linear(dim, hidden) -> GELU -> Dropout -> Linear(hidden, dim) ->
    Dropout; the Sequential indices give the reference's net.0/1/4 keys."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            layer_norm(dim),
            nn.Linear(dim, hidden_dim),
            nn.GELU(),
            Dropout(dropout),
            nn.Linear(hidden_dim, dim),
            Dropout(dropout),
        )

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        norm, fc1, gelu, drop1, fc2, drop2 = self.net
        return drop2(fc2(drop1(gelu(fc1(norm(x))), generator)), generator)


class MultiHeadAttention(nn.Module):
    """Post-LN transformer block with optional fixed-split cross attention.

    With custom_query_length q > 0 the first q tokens attend, as queries,
    over the remaining tokens; the output has q tokens (all of them when 0).
    The attention core is ``ops.attention.fused_attention`` (the K1 kernel
    on the card).
    """

    def __init__(self, d_model: int, n_heads: int = 8, dim_head: int = 128,
                 dropout: float = 0.0, custom_query_length: int = 0):
        super().__init__()
        inner = n_heads * dim_head
        self.n_heads = n_heads
        self.dim_head = dim_head
        self.custom_query_length = custom_query_length
        self.to_q = nn.Linear(d_model, inner, bias=False)
        self.to_k = nn.Linear(d_model, inner, bias=False)
        self.to_v = nn.Linear(d_model, inner, bias=False)
        self.to_out = nn.Linear(inner, d_model)
        self.dropout = Dropout(dropout)
        self.norm1 = layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_head, dropout)
        self.norm2 = layer_norm(d_model)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        cql = self.custom_query_length
        xq, xkv = (x[:, :cql], x[:, cql:]) if cql > 0 else (x, x)

        b, nq, _ = xq.shape
        nk = xkv.shape[1]
        heads = (self.n_heads, self.dim_head)
        # [b, n, h*d] -> [b, h, n, d] views; the kernel takes the strides
        q = self.to_q(xq).view(b, nq, *heads).transpose(1, 2)
        k = self.to_k(xkv).view(b, nk, *heads).transpose(1, 2)
        v = self.to_v(xkv).view(b, nk, *heads).transpose(1, 2)
        out = attention_ops.fused_attention(q, k, v, self.dim_head ** -0.5)
        out = out.transpose(1, 2).reshape(b, nq, self.n_heads * self.dim_head)

        out = self.dropout(self.to_out(out), generator)
        out = self.norm1(out + xq)
        return self.norm2(self.ff(out, generator) + out)


class MultiHeadAttentionLearnableQuery(nn.Module):
    """A block of the learnable-query fusion: the sinusoidal PE is added to
    its input, and, in cross mode, the learned ``probe`` [1, 21, d_model]
    (plus the PE) queries all the tokens. dim_head 256; no LayerNorm around
    the attention. The cross block returns ff(a) + a on its 21 query tokens,
    a self block ff(a + x) + (a + x).

    The attention is plain PyTorch ops (einsum, softmax), as the JAX package
    computes it outside any Pallas kernel: K1 takes D = 128 only."""

    def __init__(self, d_model: int, max_tokens: int, n_heads: int = 8, dim_head: int = 256,
                 dropout: float = 0.0, cross_attn: bool = True, num_query_tokens: int = 21):
        super().__init__()
        inner = n_heads * dim_head
        self.n_heads = n_heads
        self.dim_head = dim_head
        self.cross_attn = cross_attn
        if cross_attn:
            self.probe = nn.Parameter(torch.randn(1, num_query_tokens, d_model))
        self.to_q = nn.Linear(d_model, inner, bias=False)
        self.to_k = nn.Linear(d_model, inner, bias=False)
        self.to_v = nn.Linear(d_model, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, d_model))
        self.dropout = Dropout(dropout)
        self.ff = FeedForward(d_model, dim_head, dropout)
        pe = torch.from_numpy(sinusoidal_position_table(d_model, max_tokens))
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        pe = self.pe.to(x.dtype)
        x = x + pe[:, : x.shape[1]]
        b = x.shape[0]
        if self.cross_attn:
            probe = self.probe.expand(b, -1, -1)
            xq = probe + pe[:, : probe.shape[1]]
        else:
            xq = x
        nq, nk = xq.shape[1], x.shape[1]
        heads = (self.n_heads, self.dim_head)
        q = self.to_q(xq).view(b, nq, *heads)
        k = self.to_k(x).view(b, nk, *heads)
        v = self.to_v(x).view(b, nk, *heads)
        logits = torch.einsum("bihd,bjhd->bhij", q, k) * self.dim_head ** -0.5
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, nq, -1)
        out = self.dropout(self.to_out(out), generator)
        if not self.cross_attn:
            out = out + x
        return self.ff(out, generator) + out


class ChebConv(nn.Module):
    """Chebyshev graph convolution over a precomputed basis [K+1, N, N]:
    out = sum_k (T_k x) W_k + bias. weight [K+1, 1, in, out] and bias
    [1, 1, out] keep the reference's shapes."""

    def __init__(self, in_features: int, out_features: int, order: int = 2):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(order + 1, 1, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(1, 1, out_features))
        nn.init.xavier_normal_(self.weight)

    def forward(self, x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
        propagated = torch.einsum("knm,bmc->kbnc", basis.to(x.dtype), x)
        return torch.einsum("kbnc,kcd->bnd", propagated, self.weight[:, 0]) + self.bias


class LearnablePositionalEncoding(nn.Module):
    """A learned additive position table ``pe`` [1, max_len, d_model], then
    dropout (dormant: no config selects it)."""

    def __init__(self, d_model: int, max_len: int = 5000, dropout: float = 0.0):
        super().__init__()
        self.pe = nn.Parameter(torch.randn(1, max_len, d_model))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.dropout(x + self.pe[:, : x.shape[1]].to(x.dtype), generator)


def frequency_encoding(x: torch.Tensor, num_frequencies: int = 4) -> torch.Tensor:
    """sin and cos of each scalar at num_frequencies / 2 frequencies,
    flattened over the last input dim: [..., n] -> [..., n * num_frequencies]
    (dormant)."""
    freqs = torch.exp(torch.arange(0, num_frequencies, 2, dtype=torch.float32, device=x.device)
                      * (-math.log(10000.0) / num_frequencies))
    scaled = x[..., None] * freqs
    enc = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    return enc.reshape(*x.shape[:-1], -1)


class GraphConv(nn.Module):
    """Dense-adjacency graph conv: act(fc(L x)) with L = D^-1/2 A D^-1/2 from
    the (possibly learned) adjacency A, D its column sums (dormant)."""

    def __init__(self, in_features: int, out_features: int, use_relu: bool = True):
        super().__init__()
        self.fc = nn.Linear(in_features, out_features)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        d = (adj.sum(dim=-2) + 1e-5) ** -0.5
        lap = d[..., :, None] * adj * d[..., None, :]
        h = self.fc(torch.matmul(lap.to(x.dtype), x))
        return F.relu(h) if self.use_relu else h


class GraphPool(nn.Module):
    """A linear map across the node axis, [B, in_nodes, C] -> [B, out_nodes,
    C] (dormant)."""

    def __init__(self, in_nodes: int, out_nodes: int):
        super().__init__()
        self.fc = nn.Linear(in_nodes, out_nodes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.transpose(-1, -2)).transpose(-1, -2)


class GraphUnpool(GraphPool):
    """The inverse direction of GraphPool: more nodes out than in."""
