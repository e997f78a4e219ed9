"""ResNet backbones, NCHW (counterpart of
handmvnet_tpu/models/backbones/resnet.py), in every layout of the JAX
package: 18 and 34 (BasicBlock), 50, 101 and 152 (Bottleneck), and the
"50_paper" variant.

  * "default" (every type without "paper"): torchvision's topology, four
    stages, layer2 to layer4 at stride 2. It returns a dict of the maps
    ``res_layer1`` .. ``res_layer4`` and ``res_layer4_mean`` ([B, C], the
    mean over H and W, computed before the early-return check as in the
    JAX package); ``early_return`` in 1-4 returns after that stage, 0 runs
    all four.
  * "paper": layer3 at stride 1 and no layer4, so a [B, 3, H, W] image gives
    one [B, 1024, H/8, W/8] map; ``early_return`` is ignored.

The stem conv goes through ``ops.stem.stem_conv_nchw`` (the K2 kernel on
the card) in every layout and at every batch shape, in training too. The
other convolutions are plain large products and stay ``F.conv2d``, as the
JAX package left them to XLA; with ``int8`` (``model.backbone_int8``) every
block's convs, the downsample's 1x1 included, are ``ops.quant.Q8Conv``: the
int8 path in eval mode, the plain conv in train mode (the stem stays K2).
With ``remat`` (``train.remat``) each block runs under
``torch.utils.checkpoint`` in train mode (``run_block``). With
``frozen_bn`` every BatchNorm of the backbone reads its running
statistics in train mode as well (the config's ``freeze_bn``); its scale
and shift still train. ``BasicBlock`` is also the
block of HRNet's branches (hrnet.py). Module names are torchvision's, so an
ImageNet state_dict grafts by key (pretrained.py).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from handmvnet_tpu_torch.models.layers import batch_norm
from handmvnet_tpu_torch.ops import stem as stem_ops
from handmvnet_tpu_torch.ops.quant import Q8Conv

# block kind and blocks of layer1..4 (the paper variant stops after layer3)
LAYOUTS = {
    "18": ("basic", (2, 2, 2, 2)),
    "34": ("basic", (3, 4, 6, 3)),
    "50": ("bottleneck", (3, 4, 6, 3)),
    "50_paper": ("bottleneck", (3, 4, 6, 3)),
    "101": ("bottleneck", (3, 4, 23, 3)),
    "152": ("bottleneck", (3, 8, 36, 3)),
}
_STAGE_PLANES = (64, 128, 256, 512)
_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


@contextlib.contextmanager
def _scratch_bn_stats(block: nn.Module):
    """The recompute of a checkpointed block: its train-mode BatchNorms
    update scratch copies of their running statistics and counters, so that
    the step updates the real ones once, in the forward, as flax's
    ``nn.remat`` (which drops the recompute's mutations) does. The copies
    keep the saved tensors of the recompute those of the forward."""
    bns = [m for m in block.modules()
           if isinstance(m, nn.BatchNorm2d) and m.training and m.track_running_stats]
    saved = [(m, {k: getattr(m, k) for k in _BN_STATS}) for m in bns]
    for m, stats in saved:
        for k, t in stats.items():
            setattr(m, k, t.clone())
    try:
        yield
    finally:
        for m, stats in saved:
            for k, t in stats.items():
                setattr(m, k, t)


def run_block(block: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``block(x)``; with ``remat``, in train mode with gradients on, under
    ``torch.utils.checkpoint`` (non-reentrant): the block keeps only its
    input for the backward and runs again there. The recompute takes the
    parameter tensors of the forward as arguments, so a bf16 copy of
    ``functional_call`` (train_step.py) is what it reruns, and its
    BatchNorms leave their running statistics alone (``_scratch_bn_stats``).
    A block draws no random numbers: the RNG state is not kept."""
    if not (remat and block.training and torch.is_grad_enabled()):
        return block(x)
    names, params = zip(*block.named_parameters())

    def forward(x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(block, dict(zip(names, params)), (x,))

    return checkpoint(forward, x, *params, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _scratch_bn_stats(block)))


class StemConv(nn.Module):
    """The 7x7 / stride-2 / pad-3 conv, 3 -> 64 channels, without bias;
    ``weight`` [64, 3, 7, 7] is the reference's conv1.weight."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(64, 3, 7, 7))
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stem_ops.stem_conv_nchw(x, self.weight)


class BasicBlock(nn.Module):
    """Two 3x3 conv + BN with a residual. A stage's first block, where the
    stride or the width changes, adds the 1x1 conv + BN ``downsample`` to
    its residual (HRNet's branches chain four at stride 1 and equal width,
    so theirs have none). With ``int8`` every conv is a ``Q8Conv``."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, int8: bool = False):
        super().__init__()
        conv = Q8Conv if int8 else nn.Conv2d
        self.conv1 = conv(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3, 1, padding=1, bias=False)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                conv(inplanes, planes, 1, stride, bias=False), batch_norm(planes)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1, 3x3 (the stride) and 1x1 conv + BN with a residual, 4x the planes
    out; ``downsample`` and ``int8`` as in ``BasicBlock``."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, int8: bool = False):
        super().__init__()
        conv = Q8Conv if int8 else nn.Conv2d
        out = planes * self.expansion
        self.conv1 = conv(inplanes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv(planes, out, 1, bias=False)
        self.bn3 = batch_norm(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                conv(inplanes, out, 1, stride, bias=False), batch_norm(out)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def deepest_side(paper: bool, stages: int, size: int) -> int:
    """The side of the last of ``stages`` maps for a ``size``-sided image:
    the stem and the max pool halve it (rounding up), and so does every stage
    past the first but the paper variant's layer3."""
    side = -(-size // 4)
    for stage in range(1, stages):
        if not (paper and stage == 2):
            side = -(-side // 2)
    return side


class ResNetBackbone(nn.Module):
    """[B, 3, H, W] -> one [B, 1024, H/8, W/8] map ("50_paper"), or the dict
    of the default variant's maps up to ``early_return`` (see the module's
    docstring; ``int8`` and ``remat`` there too)."""

    def __init__(self, version: str = "50_paper", frozen_bn: bool = False,
                 early_return: int = 3, int8: bool = False, remat: bool = False):
        super().__init__()
        if version not in LAYOUTS:
            raise ValueError(f"unsupported ResNet version {version!r} "
                             f"(the port has {sorted(LAYOUTS)})")
        self.paper = "paper" in version
        self.frozen_bn = frozen_bn
        self.remat = remat
        kind, blocks = LAYOUTS[version]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = StemConv()
        self.bn1 = batch_norm(64)
        inplanes = 64
        # stages past the early return are not built (the JAX module never
        # creates them, so its tree has no weights for them)
        self.stages = 3 if self.paper else early_return if 1 <= early_return <= 4 else 4
        # the channels of each stage's map
        self.channels = tuple(p * block_cls.expansion for p in _STAGE_PLANES[:self.stages])
        for stage in range(self.stages):
            planes = _STAGE_PLANES[stage]
            # the paper variant keeps layer3 at stride 1
            stride = 1 if stage == 0 or (self.paper and stage == 2) else 2
            layer = []
            for bidx in range(blocks[stage]):
                layer.append(block_cls(inplanes, planes, stride if bidx == 0 else 1, int8))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.train()  # modules start in train mode: freeze the BNs from the start

    def train(self, mode: bool = True) -> "ResNetBackbone":
        super().train(mode)
        if self.frozen_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor | dict[str, torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, kernel_size=3, stride=2, padding=1)
        features: dict[str, torch.Tensor] = {}
        for stage in range(self.stages):
            for block in getattr(self, f"layer{stage + 1}"):
                h = run_block(block, h, self.remat)
            features[f"res_layer{stage + 1}"] = h
            if stage == 3:
                features["res_layer4_mean"] = h.mean(dim=(2, 3))
        return h if self.paper else features
