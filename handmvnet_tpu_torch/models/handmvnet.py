"""HandMvNet forward (counterpart of handmvnet_tpu/models/handmvnet.py),
for inference (``.eval()``) and training (``.train()``: BatchNorm batch
statistics, dropout in the fusion blocks):

  rgb [b, v, H, W, 3]
    -> per-view backbone over b*v images (NCHW inside): ResNet-50 "paper"
       (one map, 1024 ch at H/8), a default ResNet 18/34/50/101/152 (the maps
       of layer1 up to its early_return, deepest first) or HRNet w40/w64
       (four maps, H/4..H/32)
    -> pose_net head on the first map -> heatmaps [b*v, 21, H/8, W/8]
       ("paper": 1x1 conv, BN, ReLU, 1x1 conv; a default ResNet: a 4x4
       stride-2 transposed conv to 128, BN, ReLU, 3x3 conv to 64, BN, ReLU,
       3x3 conv; HRNet: one 3x3 stride-2 conv)
    -> soft-argmax at temperature 1000, in >= f32 -> coords [b*v, 21, 2]
    -> one SampleNet per map, halving its channels, sampled at the same
       H/8-space coordinates on every map (the reference's cross-scale
       quirk, kept), concatenated (+ coords, + crop-FoV angles)
    -> tokens [b, v*21, feat] -> fusion -> [b, 21, feat]: CrossAttentionFusion
       (K1) or, with fusion cross_attn_learnable_query, the learned-probe
       fusion (plain ops)
    -> ChebConv GCN decoder (or the MLP one) -> joints_cam [b, 21, 3]

feat is 524 for ResNet-50 "paper" (512 + 12), 312 for HRNet w40 (300 + 12)
and 236 for ResNet-18 at early_return 3 (128 + 64 + 32 + 12). The forward
splits at the token boundary, as the JAX model's ``stage`` does: "tokens"
runs the per-view trunk, "fuse" the fusion and the decoder, "full" both
(view-parallel inference, parallel/view_parallel.py, runs them apart).

With ``root_relative=False`` the absolute-root branch runs too: each view's
wrist token with its absolute 2D coordinates, a 3-layer CrossAttentionFusion
over the V of them (K1 at (V, V), (1, V-1) and (1, 1)) and an MLP give
``root_joint`` [b, 1, 3].

The public layout is the JAX package's; the output dict is the same, every
entry at >= f32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from handmvnet_tpu_torch.config import ModelConfig
from handmvnet_tpu_torch.models.backbones.hrnet import WIDTHS as HRNET_WIDTHS, HRNetBackbone
from handmvnet_tpu_torch.models.backbones.resnet import ResNetBackbone, deepest_side
from handmvnet_tpu_torch.models.fusion import (
    CrossAttentionFusion,
    CrossAttentionFusionLearnableQuery,
)
from handmvnet_tpu_torch.models.layers import batch_norm
from handmvnet_tpu_torch.models.nets import JointsDecoderGCN, JointsDecoderNN, SampleNet
from handmvnet_tpu_torch.ops.geometry import (
    box_corner_points,
    centered_coordinates,
    fov_angles,
    joints_crop_to_img,
)
from handmvnet_tpu_torch.ops.heatmap import soft_argmax_2d
from handmvnet_tpu_torch.utils.profiling import span


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class HandMvNet(nn.Module):
    """Every model of the JAX package's HandMvNet: the ResNet types of
    ``resnet.LAYOUTS`` and HRNet w40 / w64, the cross_attn and
    cross_attn_learnable_query fusions, root-relative or with the
    absolute-root branch (``root_relative=False``). ``dropout`` is the rate
    of the cross_attn fusion blocks and of the root branch (the reference
    fixes 0.1; 0 trains without dropout); the learnable-query fusion has
    none, as in the JAX package. ``backbone_int8`` serves a ResNet's block
    convs on the int8 path in eval mode (ops/quant.py; training runs the
    plain convs) and is ignored on HRNet, as in the JAX package;
    ``hrnet_branch_grouped`` is a TPU layout option of the JAX package and
    is ignored. ``remat`` checkpoints the backbone's blocks in training
    (``train_step.resolve_remat`` decides it from ``train.remat``). A
    combination the JAX forward cannot run is refused here, at
    construction."""

    def __init__(self, cfg: ModelConfig, image_size: int = 256, heatmap_size: int = 32,
                 dropout: float = 0.1, root_relative: bool = True, remat: bool = False):
        super().__init__()
        if cfg.fusion not in ("cross_attn", "cross_attn_learnable_query"):
            raise ValueError(f"invalid fusion type: {cfg.fusion}")
        self.cfg = cfg
        self.image_size = image_size
        self.heatmap_size = heatmap_size
        self.root_relative = root_relative
        j = cfg.num_joints
        if cfg.backbone == "resnet":
            channels = self._resnet(cfg, image_size, heatmap_size, remat)
        elif cfg.backbone == "hrnet" and cfg.backbone_type in HRNET_WIDTHS:
            channels = HRNET_WIDTHS[cfg.backbone_type]
            self.backbone = HRNetBackbone(cfg.backbone_type, remat)
            self.pose_net = nn.Conv2d(channels[0], j, 3, 2, padding=1)  # H/4 -> H/8
        elif cfg.backbone == "hrnet":
            raise ValueError(f"unsupported HRNet width {cfg.backbone_type!r} "
                             f"(the port has {'/'.join(HRNET_WIDTHS)})")
        else:
            raise ValueError(f"unsupported backbone: {cfg.backbone}")
        self.sample_nets = nn.ModuleList(SampleNet(c, c // 2) for c in channels)
        # the token width of the backbone's own maps, as the JAX model takes it
        feat_dim = dataclasses.replace(cfg, backbone_channels=channels).feat_dim
        if cfg.fusion == "cross_attn":
            self.joints_late_fusion = CrossAttentionFusion(
                feat_dim, max_tokens=j * cfg.num_views, custom_query_length=j,
                num_layers=cfg.fusion_layers, dropout=dropout, add_pos="sin" in cfg.pos_enc,
            )
        else:
            self.joints_late_fusion = CrossAttentionFusionLearnableQuery(
                feat_dim, max_tokens=j * cfg.num_views)
        decoder = JointsDecoderGCN if cfg.use_gcn else JointsDecoderNN
        self.joints_decoder = decoder(feat_dim)
        if not root_relative:
            self.root_late_fusion = CrossAttentionFusion(
                feat_dim + 2, max_tokens=cfg.num_views, custom_query_length=1, num_layers=3,
                dropout=dropout, add_pos="sin" in cfg.pos_enc)
            self.root_decoder = JointsDecoderNN(feat_dim + 2)

    def _resnet(self, cfg: ModelConfig, image_size: int, heatmap_size: int,
                remat: bool) -> tuple[int, ...]:
        """Build the ResNet backbone and its head; return the channels of the
        maps the model samples, deepest first. Refuses a layout whose
        heatmaps would not be heatmap_size on a side, where the JAX forward
        fails on its reshape of the heatmaps."""
        version, j = cfg.backbone_type, cfg.num_joints
        self.backbone = ResNetBackbone(version, frozen_bn=cfg.freeze_bn,
                                       early_return=cfg.backbone_early_return,
                                       int8=cfg.backbone_int8, remat=remat)
        paper, maps = self.backbone.paper, self.backbone.channels
        side = deepest_side(paper, len(maps), image_size) * (1 if paper else 2)
        if side != heatmap_size:
            raise ValueError(
                f"resnet {version} at backbone_early_return {cfg.backbone_early_return} gives "
                f"{side}^2 heatmaps from {image_size}^2 images, not the heatmap_size "
                f"{heatmap_size}^2 that the JAX forward reshapes them to")
        if paper:  # its last map
            self.pose_net = nn.Sequential(
                nn.Conv2d(maps[-1], 512, 1), batch_norm(512), nn.ReLU(), nn.Conv2d(512, j, 1))
            return maps[-1:]
        # flax ConvTranspose(4, stride 2, padding ((2, 2), (2, 2)), transpose_kernel)
        # dilates by 2 and pads 2 a side: torch's padding is k - 1 - 2 = 1 (2x up)
        self.pose_net = nn.Sequential(
            nn.ConvTranspose2d(maps[-1], 128, 4, stride=2, padding=1), batch_norm(128),
            nn.ReLU(), nn.Conv2d(128, 64, 3, padding=1), batch_norm(64), nn.ReLU(),
            nn.Conv2d(64, j, 3, padding=1))
        return maps[::-1]  # every map, deepest first

    def _fuse_decode(self, tokens_b: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """Cross-view fusion and joint decoder over the whole token tensor
        [b, v*j, feat] -> joints_cam [b, j, 3] in the compute dtype."""
        return self.joints_decoder(self.joints_late_fusion(tokens_b, generator))

    def forward(self, x: torch.Tensor, bboxes: torch.Tensor | None = None,
                intrinsics: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                stage: str = "full") -> dict[str, torch.Tensor] | torch.Tensor:
        """x: rgb [b, v, H, W, 3]; bboxes [b, v, 4] xyxy; intrinsics [b, v, 4]
        (fx, fy, cx, cy); ``generator`` draws the dropout masks in train mode.

        ``stage`` picks the part of the forward that runs:
          "full"   returns joints_cam [b, 21, 3], joints_crop_img
                   [b, v, 21, 2] and heatmap [b, v, 21, h, w];
          "tokens" runs the per-view trunk on any subset of views and returns
                   tokens [b, v*21, feat] (compute dtype) with joints_crop_img
                   and heatmap;
          "fuse"   takes the whole token tensor as ``x`` and returns
                   joints_cam [b, 21, 3] in the compute dtype.
        The parameters are the same in every stage, so one state_dict serves
        all three."""
        if stage == "fuse":
            return self._fuse_decode(x, generator)
        if stage not in ("full", "tokens"):
            raise ValueError(f"stage {stage!r}: full, tokens or fuse")
        cfg = self.cfg
        b, v = x.shape[:2]
        j = cfg.num_joints
        images = x.reshape(b * v, *x.shape[2:]).permute(0, 3, 1, 2)  # NCHW view

        with span("backbone"):
            feats = self.backbone(images)
        if isinstance(feats, dict):
            # deepest map first; the rank-2 res_layer4_mean is not sampled
            feats = [f for f in reversed(feats.values()) if f.dim() == 4]
        elif isinstance(feats, torch.Tensor):
            feats = [feats]
        heatmaps = self.pose_net(feats[0])  # [b*v, J, h, w]
        # the x1000 softmax overflows bf16: promote, never downcast
        joint_coords = soft_argmax_2d(heatmaps.to(_at_least_f32(heatmaps.dtype))).to(x.dtype)

        # [b*v, J, C_i / 2] per map, then the encodings; one concatenation
        parts = [net(f, joint_coords) for net, f in zip(self.sample_nets, feats)]
        if "pos2d" in cfg.pos_enc:
            parts.append(joint_coords)
        if "crop" in cfg.pos_enc:
            if bboxes is None or intrinsics is None:
                raise ValueError("the crop encoding needs bboxes and intrinsics")
            enc_dtype = _at_least_f32(bboxes.dtype)
            boxes = bboxes.reshape(b * v, 4).to(enc_dtype)
            intr = intrinsics.reshape(b * v, 4).to(enc_dtype)
            cc = centered_coordinates(box_corner_points(boxes), intr[:, 2], intr[:, 3])
            fov = fov_angles(cc, intr[:, 0], intr[:, 1]).reshape(b * v, 1, 10)
            parts.append(fov.to(joint_coords.dtype).expand(b * v, j, 10))
        tokens = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        tokens_b = tokens.reshape(b, v * j, tokens.shape[-1])

        scale = float(self.image_size) / float(self.heatmap_size)
        out_dtype = _at_least_f32(x.dtype)
        hs = heatmaps.shape[-2:]
        per_view = {
            "joints_crop_img": (joint_coords.reshape(b, v, j, 2) * scale).to(out_dtype),
            "heatmap": heatmaps.reshape(b, v, j, *hs).to(out_dtype),
        }
        if stage == "tokens":
            return {"tokens": tokens_b, **per_view}
        out = {"joints_cam": self._fuse_decode(tokens_b, generator).to(out_dtype), **per_view}
        if not self.root_relative:
            if bboxes is None:
                raise ValueError("the absolute-root branch needs bboxes for the wrist tokens' "
                                 "absolute 2D coordinates")
            # the heatmap-space coordinates go in with the image size, as in the JAX model
            abs_coords = joints_crop_to_img(joint_coords, bboxes.reshape(b * v, 4).to(
                joint_coords.dtype), float(self.image_size))
            wrist = torch.cat([tokens[:, 0], abs_coords[:, 0]], dim=-1).reshape(b, v, -1)
            root = self.root_decoder(self.root_late_fusion(wrist, generator))
            out["root_joint"] = root.to(out_dtype)
        return out
