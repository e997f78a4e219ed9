"""ResNet-50 "paper" backbone, NCHW (counterpart of
handmvnet_tpu/models/backbones/resnet.py).

torchvision's bottleneck topology with layer3 at stride 1 and no layer4: a
[B, 3, H, W] image gives one [B, 1024, H/8, W/8] map. The stem conv goes
through ``ops.stem.stem_conv_nchw`` (the K2 kernel on the card) at every
batch shape, in training too. The other convolutions are plain large
products and stay ``F.conv2d``, as the JAX package left them to XLA. With
``frozen_bn`` every BatchNorm of the backbone reads its running statistics
in train mode as well (the config's ``freeze_bn``); its scale and shift
still train.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from handmvnet_tpu_torch.models.layers import batch_norm
from handmvnet_tpu_torch.ops import stem as stem_ops

_LAYOUTS = {"50_paper": (3, 4, 6)}  # bottleneck blocks of layer1..3


class StemConv(nn.Module):
    """The 7x7 / stride-2 / pad-3 conv, 3 -> 64 channels, without bias;
    ``weight`` [64, 3, 7, 7] is the reference's conv1.weight."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(64, 3, 7, 7))
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stem_ops.stem_conv_nchw(x, self.weight)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = batch_norm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = batch_norm(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride, bias=False), batch_norm(out)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetBackbone(nn.Module):
    """[B, 3, H, W] -> [B, 1024, H/8, W/8] for version "50_paper"."""

    def __init__(self, version: str = "50_paper", frozen_bn: bool = False):
        super().__init__()
        if version not in _LAYOUTS:
            raise ValueError(f"unsupported ResNet version {version!r} "
                             f"(the port has {sorted(_LAYOUTS)})")
        self.frozen_bn = frozen_bn
        self.conv1 = StemConv()
        self.bn1 = batch_norm(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256), _LAYOUTS[version])):
            stride = 2 if stage == 1 else 1  # the paper variant keeps layer3 at stride 1
            layer = []
            for bidx in range(blocks):
                layer.append(Bottleneck(inplanes, planes, stride if bidx == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.train()  # modules start in train mode: freeze the BNs from the start

    def train(self, mode: bool = True) -> "ResNetBackbone":
        super().train(mode)
        if self.frozen_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, kernel_size=3, stride=2, padding=1)
        return self.layer3(self.layer2(self.layer1(h)))
