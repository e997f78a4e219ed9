"""HRNet-v2 backbone, w40 and w64, NCHW (counterpart of
handmvnet_tpu/models/backbones/hrnet.py).

  stem: two 3x3 stride-2 conv + BN + ReLU (3 -> 64 -> 64 channels, H/4)
  layer1: 4 Bottlenecks at 64 planes (256 channels out)
  transition1 -> stage2: 1 module of 2 branches
  transition2 -> stage3: 4 modules of 3 branches
  transition3 -> stage4: 3 modules of 4 branches
Each branch of a module is 4 BasicBlocks; then every output i sums every
branch j (SUM fuse), through a 1x1 conv + BN and a nearest upsample by
2^(j-i) for j > i, and through (i-j) stride-2 3x3 conv + BN, with a ReLU
after each but the last, for j < i. A [B, 3, H, W] image gives four maps
[B, {w, 2w, 4w, 8w}, H/4, H/8, H/16, H/32].

With ``remat`` (``train.remat``) each BasicBlock of the branches runs under
``torch.utils.checkpoint`` in train mode (``resnet.run_block``), as the JAX
package remats them; the stem, layer1, the transitions and the fuse do not.
The int8 convs of ``model.backbone_int8`` are ResNet's only: HRNet ignores
the flag, as the JAX package does.

Module names are the reference's torch names (``stage3.1.fuse_layers.2.0.1.0``,
``transition1.1.0.0``), with ``None`` where the reference has no module.
Only the plain fuse is here: the JAX package's ``packed`` fuse and
``branch_grouped`` branches are eval-time layout rewrites of the same math
for the TPU's matrix unit, which pads narrow convs to its lane width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from handmvnet_tpu_torch.models.backbones.resnet import BasicBlock, Bottleneck, run_block
from handmvnet_tpu_torch.models.layers import batch_norm

WIDTHS = {"w40": (40, 80, 160, 320), "w64": (64, 128, 256, 512)}
_STAGES = ((1, 2), (4, 3), (3, 4))  # (modules, branches) of stages 2..4
_BLOCKS = 4  # BasicBlocks per branch


def _conv_bn(cin: int, cout: int, stride: int, relu: bool) -> nn.Sequential:
    """3x3 conv (no bias) + BN, and a ReLU when ``relu``."""
    layers = [nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False), batch_norm(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class HRModule(nn.Module):
    """One high-resolution module: per-branch BasicBlock chains, then the
    SUM fuse over every pair of branches."""

    def __init__(self, channels: tuple[int, ...], remat: bool = False):
        super().__init__()
        n = len(channels)
        self.remat = remat
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c, c) for _ in range(_BLOCKS))) for c in channels)
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        nn.Conv2d(channels[j], channels[i], 1, bias=False),
                        batch_norm(channels[i]),
                        nn.Upsample(scale_factor=2 ** (j - i), mode="nearest")))
                elif j < i:
                    row.append(nn.Sequential(*(
                        _conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j],
                                 2, relu=k < i - j - 1)
                        for k in range(i - j))))
                else:
                    row.append(None)
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for branch, h in zip(self.branches, xs):
            for block in branch:
                h = run_block(block, h, self.remat)
            outs.append(h)
        xs = outs
        fused = []
        for row in self.fuse_layers:
            acc = None
            for path, x in zip(row, xs):
                y = x if path is None else path(x)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRNetBackbone(nn.Module):
    """[B, 3, H, W] -> four maps [B, w_i, H / 2^(i+2), W / 2^(i+2)]."""

    def __init__(self, width: str = "w40", remat: bool = False):
        super().__init__()
        if width not in WIDTHS:
            raise ValueError(f"unsupported HRNet width {width!r} (the port has {sorted(WIDTHS)})")
        widths = WIDTHS[width]
        self.remat = remat
        self.conv1 = nn.Conv2d(3, 64, 3, 2, padding=1, bias=False)
        self.bn1 = batch_norm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, padding=1, bias=False)
        self.bn2 = batch_norm(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if b == 0 else 256, 64) for b in range(4)))
        # transition1 adapts layer1's 256 channels to branch 0 and starts
        # branch 1; each later transition starts one branch from the last
        self.transition1 = nn.ModuleList([
            _conv_bn(256, widths[0], 1, relu=True),
            nn.Sequential(_conv_bn(256, widths[1], 2, relu=True))])
        for stage, (modules, branches) in enumerate(_STAGES, start=2):
            if stage > 2:
                setattr(self, f"transition{stage - 1}", nn.ModuleList(
                    [None] * (branches - 1)
                    + [nn.Sequential(_conv_bn(widths[branches - 2], widths[branches - 1], 2,
                                              relu=True))]))
            setattr(self, f"stage{stage}", nn.ModuleList(
                HRModule(widths[:branches], remat) for _ in range(modules)))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.layer1(h)
        xs = [t(h) for t in self.transition1]
        for stage in range(2, 5):
            if stage > 2:
                xs = xs + [getattr(self, f"transition{stage - 1}")[-1](xs[-1])]
            for module in getattr(self, f"stage{stage}"):
                xs = module(xs)
        return xs
