"""Cross-view attention fusion (counterpart of
handmvnet_tpu/models/fusion.py).

CrossAttentionFusion: sinusoidal PE once at entry, then (num_layers-1)/2
self-attention blocks over all 21*V tokens, one cross block in which the
first 21 tokens (view 0) query the other 21*(V-1), and (num_layers-1)/2
self-attention blocks over the 21 fused tokens. Its attention is K1.

CrossAttentionFusionLearnableQuery: five blocks (self, self, cross, self,
self) of dim_head 256, each adding the PE to its input; the cross block's
queries are a learned probe over all the tokens. Its attention is plain ops.
"""

from __future__ import annotations

import torch
from torch import nn

from handmvnet_tpu_torch.models.layers import (
    MultiHeadAttention,
    MultiHeadAttentionLearnableQuery,
    sinusoidal_position_table,
)


class CrossAttentionFusion(nn.Module):
    def __init__(self, feat_dim: int, max_tokens: int, custom_query_length: int = 21,
                 num_layers: int = 5, dropout: float = 0.1, add_pos: bool = True):
        super().__init__()
        if num_layers % 2 != 1:
            raise ValueError(f"num_layers must be odd, got {num_layers}")
        half = (num_layers - 1) // 2
        self.add_pos = add_pos
        self.attn_fusion = nn.ModuleList(
            MultiHeadAttention(
                feat_dim, dropout=dropout,
                custom_query_length=custom_query_length if i == half else 0,
            )
            for i in range(num_layers)
        )
        pe = torch.from_numpy(sinusoidal_position_table(feat_dim, max_tokens))
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x [b, 21*V, feat] -> [b, 21, feat]; ``generator`` draws the
        dropout masks in train mode."""
        if self.add_pos:
            x = x + self.pe[:, : x.shape[1]].to(x.dtype)
        for block in self.attn_fusion:
            x = block(x, generator)
        return x


class CrossAttentionFusionLearnableQuery(nn.Module):
    """x [b, 21*V, feat] -> [b, 21, feat]. The config's ``fusion_layers`` and
    ``pos_enc`` do not reach it, as in the JAX package (the PE is added in
    every block); dropout is 0 there too."""

    def __init__(self, feat_dim: int, max_tokens: int, dropout: float = 0.0):
        super().__init__()
        self.attn_fusion = nn.ModuleList(
            MultiHeadAttentionLearnableQuery(feat_dim, max_tokens, dropout=dropout,
                                             cross_attn=cross)
            for cross in (False, False, True, False, False)
        )

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for block in self.attn_fusion:
            x = block(x, generator)
        return x
