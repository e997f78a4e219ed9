"""The frozen reference of the HandMvNet forward, plain PyTorch, float32:
ResNet-50 "paper" (early_return 3) or HRNet-w40, the pose_net head,
soft-argmax at temperature 1000, the SampleNets, the crop-FoV and
sinusoidal encodings, the 5-block cross-attention fusion and the ChebConv
GCN decoder, root-relative.

Module names give the state_dict keys of the reference's torch model, which
the program takes too, so one state_dict made from a seed loads into both.
The attention is softmax(q k^T / sqrt(d)) v in einsum and softmax, the stem
a ``F.conv2d``: nothing of the program's kernels. In ``.train()`` BatchNorm
takes the batch statistics and updates its running ones (momentum 0.1,
unbiased variance) and each dropout draws its mask as
``torch.empty_like(x).bernoulli_(1 - p, generator=g)`` in the blocks'
order (attention output, then the feed-forward's two), so a generator in the
same state gives the same masks as the program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hmvbench.reference.constants import HAND_EDGES, NUM_JOINTS

EPS = 1e-5  # BatchNorm and LayerNorm
HRNET_WIDTHS = {"w40": (40, 80, 160, 320)}


def batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=EPS)


# ---------------------------------------------------------------- backbones

class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = batch_norm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = batch_norm(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, out, 1, stride, bias=False),
                                            batch_norm(out))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class BasicBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, 1, padding=1, bias=False)
        self.bn1 = batch_norm(c)
        self.conv2 = nn.Conv2d(c, c, 3, 1, padding=1, bias=False)
        self.bn2 = batch_norm(c)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class Stem(nn.Module):
    """The 7x7 / stride-2 / pad-3 conv, 3 -> 64, no bias."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(64, 3, 7, 7))

    def forward(self, x):
        return F.conv2d(x, self.weight, stride=2, padding=3)


class ResNet50Paper(nn.Module):
    """[B, 3, H, W] -> [B, 1024, H/8, W/8]: stem, max pool, layer1 (3 blocks),
    layer2 (4, stride 2), layer3 (6, stride 1)."""

    channels = (1024,)

    def __init__(self):
        super().__init__()
        self.conv1 = Stem()
        self.bn1 = batch_norm(64)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(((64, 3, 1), (128, 4, 2), (256, 6, 1))):
            layer = []
            for i in range(blocks):
                layer.append(Bottleneck(inplanes, planes, stride if i == 0 else 1))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))

    def forward(self, x):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        return [self.layer3(self.layer2(self.layer1(h)))]


def conv_bn(cin: int, cout: int, stride: int, relu: bool) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False), batch_norm(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class HRModule(nn.Module):
    """Four BasicBlocks a branch, then every output i sums every branch j:
    1x1 conv + BN + nearest upsample for j > i, (i - j) stride-2 3x3 conv +
    BN (ReLU between) for j < i."""

    def __init__(self, channels):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c) for _ in range(4))) for c in channels)
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
                        conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j], 2,
                                relu=k < i - j - 1) for k in range(i - j))))
                else:
                    row.append(None)
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        out = []
        for row in self.fuse_layers:
            acc = None
            for path, x in zip(row, xs):
                y = x if path is None else path(x)
                acc = y if acc is None else acc + y
            out.append(F.relu(acc))
        return out


class HRNet(nn.Module):
    """[B, 3, H, W] -> four maps of w, 2w, 4w, 8w channels at H/4 .. H/32,
    the head and the SampleNets taking them in that order."""

    def __init__(self, width: str = "w40"):
        super().__init__()
        widths = HRNET_WIDTHS[width]
        self.channels = widths
        self.conv1 = nn.Conv2d(3, 64, 3, 2, padding=1, bias=False)
        self.bn1 = batch_norm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, padding=1, bias=False)
        self.bn2 = batch_norm(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if b == 0 else 256, 64) for b in range(4)))
        self.transition1 = nn.ModuleList([
            conv_bn(256, widths[0], 1, relu=True),
            nn.Sequential(conv_bn(256, widths[1], 2, relu=True))])
        for stage, (modules, branches) in zip((2, 3, 4), ((1, 2), (4, 3), (3, 4))):
            if stage > 2:
                setattr(self, f"transition{stage - 1}", nn.ModuleList(
                    [None] * (branches - 1)
                    + [nn.Sequential(conv_bn(widths[branches - 2], widths[branches - 1], 2,
                                             relu=True))]))
            setattr(self, f"stage{stage}", nn.ModuleList(
                HRModule(widths[:branches]) for _ in range(modules)))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.layer1(F.relu(self.bn2(self.conv2(h))))
        xs = [t(h) for t in self.transition1]
        for stage in (2, 3, 4):
            if stage > 2:
                xs = xs + [getattr(self, f"transition{stage - 1}")[-1](xs[-1])]
            for module in getattr(self, f"stage{stage}"):
                xs = module(xs)
        return xs


# ------------------------------------------------------------- model core

def soft_argmax_2d(heatmap: torch.Tensor, temperature: float = 1000.0) -> torch.Tensor:
    """[..., J, H, W] -> expected (x, y) [..., J, 2] under softmax(t * h)."""
    *lead, j, h, w = heatmap.shape
    probs = torch.softmax(heatmap.reshape(*lead, j, h * w) * temperature, dim=-1)
    probs = probs.reshape(*lead, j, h, w)
    xs = torch.arange(w, dtype=probs.dtype, device=probs.device)
    ys = torch.arange(h, dtype=probs.dtype, device=probs.device)
    return torch.stack([probs.sum(-2) @ xs, probs.sum(-1) @ ys], dim=-1)


def sample_bilinear(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``grid_sample(align_corners=True, zeros padding)`` at pixel points:
    feat [B, C, H, W], points [B, N, 2] (x, y) -> [B, N, C]."""
    b, c, h, w = feat.shape
    grid = torch.stack([points[..., 0] * (2.0 / (w - 1)) - 1.0,
                        points[..., 1] * (2.0 / (h - 1)) - 1.0], dim=-1)
    out = F.grid_sample(feat, grid[:, :, None], mode="bilinear", padding_mode="zeros",
                        align_corners=True)  # [B, C, N, 1]
    return out[..., 0].transpose(1, 2)


class SampleNet(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, cout, 1), batch_norm(cout), nn.ReLU())

    def forward(self, feat, coords):
        return sample_bilinear(self.conv(feat), coords)


def crop_fov(bboxes: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """The crop encoding: atan((p - c) / f) of the box's four corners and
    its centre. bboxes [N, 4] xyxy, intrinsics [N, 4] (fx, fy, cx, cy) ->
    [N, 10]."""
    x1, y1, x2, y2 = bboxes.unbind(-1)
    xs = torch.stack([x1, x1, x2, x2, (x1 + x2) * 0.5], -1)
    ys = torch.stack([y1, y2, y1, y2, (y1 + y2) * 0.5], -1)
    fx, fy, cx, cy = (t[:, None] for t in intrinsics.unbind(-1))
    return torch.stack([torch.atan((xs - cx) / fx), torch.atan((ys - cy) / fy)], -1).reshape(-1, 10)


def sinusoidal_table(d: int, n: int) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe = np.zeros((n, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * (div if d % 2 == 0 else div[:-1]))
    return torch.from_numpy(pe.astype(np.float32))


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=generator)
        return x * keep / (1.0 - self.p)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, p: float):
        super().__init__()
        self.net = nn.Sequential(nn.LayerNorm(dim, eps=EPS), nn.Linear(dim, hidden), nn.GELU(),
                                 Dropout(p), nn.Linear(hidden, dim), Dropout(p))

    def forward(self, x, generator):
        norm, fc1, gelu, drop1, fc2, drop2 = self.net
        return drop2(fc2(drop1(gelu(fc1(norm(x))), generator)), generator)


class Block(nn.Module):
    """Post-LN attention block, 8 heads x 128; with ``queries`` > 0 the first
    ``queries`` tokens attend over the rest (the cross block)."""

    def __init__(self, d: int, p: float, queries: int = 0, heads: int = 8, dim_head: int = 128):
        super().__init__()
        self.heads, self.dim_head, self.queries = heads, dim_head, queries
        inner = heads * dim_head
        self.to_q = nn.Linear(d, inner, bias=False)
        self.to_k = nn.Linear(d, inner, bias=False)
        self.to_v = nn.Linear(d, inner, bias=False)
        self.to_out = nn.Linear(inner, d)
        self.dropout = Dropout(p)
        self.norm1 = nn.LayerNorm(d, eps=EPS)
        self.ff = FeedForward(d, dim_head, p)
        self.norm2 = nn.LayerNorm(d, eps=EPS)

    def forward(self, x, generator):
        xq, xkv = (x[:, :self.queries], x[:, self.queries:]) if self.queries else (x, x)
        b, nq, nk = x.shape[0], xq.shape[1], xkv.shape[1]
        q = self.to_q(xq).view(b, nq, self.heads, self.dim_head)
        k = self.to_k(xkv).view(b, nk, self.heads, self.dim_head)
        v = self.to_v(xkv).view(b, nk, self.heads, self.dim_head)
        attn = torch.softmax(torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(self.dim_head), -1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, nq, -1)
        out = self.norm1(self.dropout(self.to_out(out), generator) + xq)
        return self.norm2(self.ff(out, generator) + out)


class Fusion(nn.Module):
    def __init__(self, d: int, tokens: int, layers: int, p: float, add_pos: bool):
        super().__init__()
        self.add_pos = add_pos
        half = (layers - 1) // 2
        self.attn_fusion = nn.ModuleList(
            Block(d, p, NUM_JOINTS if i == half else 0) for i in range(layers))
        self.register_buffer("pe", sinusoidal_table(d, tokens), persistent=False)

    def forward(self, x, generator):
        if self.add_pos:
            x = x + self.pe[: x.shape[1]]
        for block in self.attn_fusion:
            x = block(x, generator)
        return x


def cheb_basis(order: int = 2) -> torch.Tensor:
    """[order + 1, 21, 21] Chebyshev polynomials of the skeleton's normalised
    Laplacian (row-normalised adjacency with self-loops)."""
    a = np.zeros((NUM_JOINTS, NUM_JOINTS))
    for i, j in HAND_EDGES:
        a[i, j] = a[j, i] = 1.0
    a = a + np.eye(NUM_JOINTS)
    a = a / a.sum(1, keepdims=True)
    d = np.diag(a.sum(-1) ** -0.5)
    lap = np.eye(NUM_JOINTS) - d @ a @ d
    terms = [np.eye(NUM_JOINTS), lap]
    for _ in range(2, order + 1):
        terms.append(2.0 * lap @ terms[-1] - terms[-2])
    return torch.from_numpy(np.stack(terms).astype(np.float32))


class ChebConv(nn.Module):
    def __init__(self, cin: int, cout: int, order: int = 2):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(order + 1, 1, cin, cout))
        self.bias = nn.Parameter(torch.zeros(1, 1, cout))

    def forward(self, x, basis):
        return torch.einsum("knm,bmc,kcd->bnd", basis, x, self.weight[:, 0]) + self.bias


class Decoder(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.joints_gcn1 = ChebConv(d, 256)
        self.joints_gcn2 = ChebConv(256, 64)
        self.joints_gcn3 = ChebConv(64, 3)
        self.register_buffer("basis", cheb_basis(), persistent=False)

    def forward(self, x):
        h = F.leaky_relu(self.joints_gcn1(x, self.basis), 0.01)
        h = F.leaky_relu(self.joints_gcn2(h, self.basis), 0.01)
        return self.joints_gcn3(h, self.basis)


class HandMvNet(nn.Module):
    """rgb [b, v, S, S, 3], bboxes [b, v, 4], intrinsics [b, v, 4] ->
    {"joints_cam" [b, 21, 3] m, "joints_crop_img" [b, v, 21, 2] px,
    "heatmap" [b, v, 21, S/8, S/8]}. ``model`` is the configuration's
    ``model`` section; ``views`` the views a sample has."""

    def __init__(self, model: dict, views: int, image_size: int = 256, heatmap_size: int = 32,
                 dropout: float = 0.1):
        super().__init__()
        if model["fusion"] != "cross_attn" or not model["use_gcn"]:
            raise ValueError("the reference has the cross_attn fusion and the GCN decoder")
        if model["backbone"] == "resnet" and model["backbone_type"] == "50_paper":
            self.backbone = ResNet50Paper()
            self.pose_net = nn.Sequential(nn.Conv2d(1024, 512, 1), batch_norm(512), nn.ReLU(),
                                          nn.Conv2d(512, NUM_JOINTS, 1))
        elif model["backbone"] == "hrnet":
            self.backbone = HRNet(model["backbone_type"])
            self.pose_net = nn.Conv2d(self.backbone.channels[0], NUM_JOINTS, 3, 2, padding=1)
        else:
            raise ValueError(f"no reference for backbone {model['backbone']} "
                             f"{model['backbone_type']}")
        channels = self.backbone.channels
        self.sample_nets = nn.ModuleList(SampleNet(c, c // 2) for c in channels)
        self.pos_enc = tuple(model["pos_enc"])
        d = sum(channels) // 2 + 2 * ("pos2d" in self.pos_enc) + 10 * ("crop" in self.pos_enc)
        self.joints_late_fusion = Fusion(d, NUM_JOINTS * views, model["fusion_layers"], dropout,
                                         "sin" in self.pos_enc)
        self.joints_decoder = Decoder(d)
        self.scale = image_size / heatmap_size

    def forward(self, rgb, bboxes, intrinsics, generator=None):
        b, v = rgb.shape[:2]
        j = NUM_JOINTS
        feats = self.backbone(rgb.reshape(b * v, *rgb.shape[2:]).permute(0, 3, 1, 2))
        heatmaps = self.pose_net(feats[0])
        coords = soft_argmax_2d(heatmaps)
        parts = [net(f, coords) for net, f in zip(self.sample_nets, feats)]
        if "pos2d" in self.pos_enc:
            parts.append(coords)
        if "crop" in self.pos_enc:
            fov = crop_fov(bboxes.reshape(b * v, 4), intrinsics.reshape(b * v, 4))
            parts.append(fov[:, None].expand(b * v, j, 10))
        tokens = torch.cat(parts, dim=-1).reshape(b, v * j, -1)
        fused = self.joints_late_fusion(tokens, generator)
        return {"joints_cam": self.joints_decoder(fused),
                "joints_crop_img": coords.reshape(b, v, j, 2) * self.scale,
                "heatmap": heatmaps.reshape(b, v, j, *heatmaps.shape[-2:])}
