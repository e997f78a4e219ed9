"""Stacked hourglass backbones, NCHW (counterpart of
handmvnet_tpu/models/backbones/hourglass.py). Dormant: no config selects
them, and HandMvNet refuses ``backbone: hourglass`` as the JAX model does.

``StackedHourglass`` returns (early features, the stacks' heatmaps, the
final feature); ``StackedBisectedHourglass`` adds a parallel mask stream.
For a [B, 3, H, W] image the maps are H/8 on a side: features [B, inp_dim,
H/8, W/8], heatmaps [B, nstack, oup_dim, H/8, W/8], masks [B, nstack, 1,
H/8, W/8].

Module names are the reference's, wrappers included: a ``ConvBlock`` holds
its conv as ``.conv`` (``pre.1.conv1.conv.weight``) and a ``Merge`` holds a
ConvBlock (``merge_preds.0.conv.conv.weight``), where the JAX package's flax
tree is flat (``conv1_conv``, ``merge_preds_0/conv``); checkpoint.py maps
one onto the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from handmvnet_tpu_torch.models.layers import batch_norm


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride, padding=(kernel - 1) // 2, bias=bias)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ConvBlock(nn.Module):
    """Conv (with bias), then an optional BN and an optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 bn: bool = False, relu: bool = True):
        super().__init__()
        self.conv = _conv(in_ch, out_ch, kernel, stride)
        self.bn = batch_norm(out_ch) if bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class Merge(nn.Module):
    """A 1x1 ConvBlock without BN or ReLU, under the reference's extra level."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = ConvBlock(in_ch, out_ch, 1, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Residual(nn.Module):
    """Pre-activation bottleneck: BN, ReLU, 1x1 to out/2, BN, ReLU, 3x3, BN,
    ReLU, 1x1 to out, plus the input (through a 1x1 ``skip_layer`` when the
    widths differ)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        half = out_ch // 2
        self.bn1 = batch_norm(in_ch)
        self.conv1 = ConvBlock(in_ch, half, 1, relu=False)
        self.bn2 = batch_norm(half)
        self.conv2 = ConvBlock(half, half, 3, relu=False)
        self.bn3 = batch_norm(half)
        self.conv3 = ConvBlock(half, out_ch, 1, relu=False)
        self.skip_layer = ConvBlock(in_ch, out_ch, 1, relu=False) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        h = self.conv3(F.relu(self.bn3(h)))
        return h + (x if self.skip_layer is None else self.skip_layer(x))


class Hourglass(nn.Module):
    """The recursive hourglass of depth ``n``: ``up1`` at this scale plus the
    nearest 2x upsampling of pool -> low1 -> (hourglass n-1 | residual) ->
    low3."""

    def __init__(self, n: int, features: int, increase: int = 0):
        super().__init__()
        nf = features + increase
        self.up1 = Residual(features, features)
        self.low1 = Residual(features, nf)
        self.low2 = Hourglass(n - 1, nf) if n > 1 else Residual(nf, nf)
        self.low3 = Residual(nf, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low = self.low3(self.low2(self.low1(F.max_pool2d(x, 2, 2))))
        return self.up1(x) + _up2(low)


class StackedHourglass(nn.Module):
    """[B, 3, H, W] -> (early features [B, inp_dim, H/8, W/8], heatmaps
    [B, nstack, oup_dim, H/8, W/8], final feature [B, inp_dim, H/8, W/8])."""

    def __init__(self, nstack: int = 4, inp_dim: int = 256, oup_dim: int = 21,
                 recur_hg: int = 4, increase: int = 0):
        super().__init__()
        self.nstack = nstack
        self.pre = nn.Sequential(
            ConvBlock(3, 64, 7, 2, bn=True, relu=True),
            Residual(64, 128),
            nn.MaxPool2d(2, 2),
            Residual(128, 128),
            Residual(128, inp_dim),
        )
        self.hgs = nn.ModuleList(nn.Sequential(Hourglass(recur_hg, inp_dim, increase))
                                 for _ in range(nstack))
        self.features = nn.ModuleList(
            nn.Sequential(Residual(inp_dim, inp_dim),
                          ConvBlock(inp_dim, inp_dim, 1, bn=True, relu=True))
            for _ in range(nstack))
        self.outs = nn.ModuleList(ConvBlock(inp_dim, oup_dim, 1, relu=False)
                                  for _ in range(nstack))
        self.merge_features = nn.ModuleList(Merge(inp_dim, inp_dim) for _ in range(nstack - 1))
        self.merge_preds = nn.ModuleList(Merge(oup_dim, inp_dim) for _ in range(nstack - 1))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = F.max_pool2d(self.pre(x), 2, 2)
        img_features, preds_all = h, []
        for i in range(self.nstack):
            feature = self.features[i](self.hgs[i](h))
            preds = self.outs[i](feature)
            preds_all.append(preds)
            if i < self.nstack - 1:
                h = h + self.merge_preds[i](preds) + self.merge_features[i](feature)
        return img_features, torch.stack(preds_all, dim=1), feature


def _streams(features: int, n: int) -> nn.ModuleList:
    """``n`` parallel streams of one Residual each (the reference's
    ModuleList of one-module Sequentials)."""
    return nn.ModuleList(nn.Sequential(Residual(features, features)) for _ in range(n))


class HourglassBisected(nn.Module):
    """The recursive hourglass with two output streams (heatmap and mask).
    ``hg[n - 1]`` holds level n's residuals: [0] the two skips at this
    scale, [1] the shared one after the pool, [2] the two after the
    recursion, and at the bottom level [3] the two that replace it."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        self.hg = nn.ModuleList(
            nn.ModuleList([_streams(features, 2), _streams(features, 1), _streams(features, 2)]
                          + ([_streams(features, 2)] if level == 0 else []))
            for level in range(depth))

    def _forward(self, n: int, x: torch.Tensor):
        level = self.hg[n - 1]
        up1, up2 = level[0][0](x), level[0][1](x)
        low = level[1][0](F.max_pool2d(x, 2, 2))
        if n > 1:
            low1, low2, latent = self._forward(n - 1, low)
        else:
            latent = low
            low1, low2 = level[3][0](low), level[3][1](low)
        low1, low2 = level[2][0](low1), level[2][1](low2)
        return up1 + _up2(low1), up2 + _up2(low2), latent

    def forward(self, x: torch.Tensor):
        return self._forward(self.depth, x)


def _conv_bn_relu(in_ch: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(_conv(in_ch, out_ch, 1, bias=False), batch_norm(out_ch), nn.ReLU())


class StackedBisectedHourglass(nn.Module):
    """[B, 3, H, W] -> (early features, heatmaps [B, nstack, oup_dim, H/8,
    W/8], final feature, masks [B, nstack, 1, H/8, W/8]): the heatmap and
    mask twin-stream variant."""

    def __init__(self, nstack: int = 4, inp_dim: int = 256, oup_dim: int = 21,
                 recur_hg: int = 4):
        super().__init__()
        self.nstack = nstack
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = batch_norm(64)
        self.layer1 = nn.Sequential(Residual(64, 128))
        self.layer2 = nn.Sequential(Residual(128, 256))
        self.layer3 = nn.Sequential(Residual(256, inp_dim))
        self.hg2b = nn.ModuleList(HourglassBisected(recur_hg, inp_dim) for _ in range(nstack))
        self.res1 = nn.ModuleList(nn.Sequential(Residual(inp_dim, inp_dim)) for _ in range(nstack))
        self.fc1 = nn.ModuleList(_conv_bn_relu(inp_dim, inp_dim) for _ in range(nstack))
        self.hm = nn.ModuleList(_conv(inp_dim, oup_dim, 1) for _ in range(nstack))
        self.res2 = nn.ModuleList(nn.Sequential(Residual(inp_dim, inp_dim)) for _ in range(nstack))
        self.fc2 = nn.ModuleList(_conv_bn_relu(inp_dim, inp_dim) for _ in range(nstack))
        self.mask = nn.ModuleList(_conv(inp_dim, 1, 1) for _ in range(nstack))
        merges = nstack - 1
        self._fc1 = nn.ModuleList(_conv(inp_dim, inp_dim, 1, bias=False) for _ in range(merges))
        self._fc2 = nn.ModuleList(_conv(inp_dim, inp_dim, 1, bias=False) for _ in range(merges))
        self._hm = nn.ModuleList(_conv(oup_dim, inp_dim, 1, bias=False) for _ in range(merges))
        self._mask = nn.ModuleList(_conv(1, inp_dim, 1, bias=False) for _ in range(merges))

    def forward(self, x: torch.Tensor):
        h = self.layer1(F.relu(self.bn1(self.conv1(x))))
        h = self.layer3(self.layer2(F.max_pool2d(h, 2, 2)))
        h = F.max_pool2d(h, 2, 2)
        img_features, hms, masks = h, [], []
        for i in range(self.nstack):
            y1, y2, _ = self.hg2b[i](h)
            y1 = self.fc1[i](self.res1[i](y1))
            y2 = self.fc2[i](self.res2[i](y2))
            est_hm, est_mask = self.hm[i](y1), self.mask[i](y2)
            hms.append(est_hm)
            masks.append(est_mask)
            if i < self.nstack - 1:
                h = (h + self._fc1[i](y1) + self._fc2[i](y2) + self._hm[i](est_hm)
                     + self._mask[i](est_mask))
            else:
                h = h + y1 + y2
        return img_features, torch.stack(hms, dim=1), h, torch.stack(masks, dim=1)
