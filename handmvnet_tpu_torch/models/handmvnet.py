"""HandMvNet forward (counterpart of handmvnet_tpu/models/handmvnet.py,
relative root), for inference (``.eval()``) and training (``.train()``:
BatchNorm batch statistics, dropout in the fusion blocks):

  rgb [b, v, H, W, 3]
    -> per-view backbone over b*v images (NCHW inside): ResNet-50 "paper"
       (one map, 1024 ch at H/8) or HRNet w40/w64 (four maps, H/4..H/32)
    -> pose_net head on the first map -> heatmaps [b*v, 21, H/8, W/8]
       (ResNet: 1x1 conv, BN, ReLU, 1x1 conv; HRNet: one 3x3 stride-2 conv)
    -> soft-argmax at temperature 1000, in >= f32 -> coords [b*v, 21, 2]
    -> one SampleNet per map, halving its channels, sampled at the same
       H/8-space coordinates on every map (the reference's cross-scale
       quirk, kept), concatenated (+ coords, + crop-FoV angles)
    -> tokens [b, v*21, feat] -> CrossAttentionFusion -> [b, 21, feat]
    -> ChebConv GCN decoder -> joints_cam [b, 21, 3]

feat is 524 for ResNet-50 "paper" (512 + 12) and 312 for HRNet w40 (300 + 12).
The forward splits at the token boundary, as the JAX model's ``stage`` does:
"tokens" runs the per-view trunk, "fuse" the fusion and the decoder, "full"
both (view-parallel inference, parallel/view_parallel.py, runs them apart).

The public layout is the JAX package's; the output dict is the same, every
entry at >= f32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from handmvnet_tpu_torch.config import ModelConfig
from handmvnet_tpu_torch.models.backbones.hrnet import WIDTHS as HRNET_WIDTHS, HRNetBackbone
from handmvnet_tpu_torch.models.backbones.resnet import ResNetBackbone
from handmvnet_tpu_torch.models.fusion import CrossAttentionFusion
from handmvnet_tpu_torch.models.layers import batch_norm
from handmvnet_tpu_torch.models.nets import JointsDecoderGCN, JointsDecoderNN, SampleNet
from handmvnet_tpu_torch.ops.geometry import box_corner_points, centered_coordinates, fov_angles
from handmvnet_tpu_torch.ops.heatmap import soft_argmax_2d


INT8_TODO = ("model.backbone_int8 is not ported: ROADMAP.md queue 1, \"ops/quant.py, the int8 "
             "PTQ behind model.backbone_int8\"; set backbone_int8: false")


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class HandMvNet(nn.Module):
    """The port covers the release configs' models: ResNet "50_paper" or
    HRNet w40 (and w64), the cross_attn fusion, root-relative output.
    ``dropout`` is the fusion blocks' rate (the reference fixes 0.1; 0
    trains without dropout). ``hrnet_branch_grouped`` is a TPU layout
    option of the JAX package and is ignored; so is ``backbone_int8`` on
    HRNet, as in the JAX package, while on ResNet it raises (the int8 convs
    are not ported)."""

    def __init__(self, cfg: ModelConfig, image_size: int = 256, heatmap_size: int = 32,
                 dropout: float = 0.1):
        super().__init__()
        if cfg.fusion != "cross_attn":
            raise ValueError(f"the port has the cross_attn fusion only, not {cfg.fusion}")
        self.cfg = cfg
        self.image_size = image_size
        self.heatmap_size = heatmap_size
        j = cfg.num_joints
        if cfg.backbone == "resnet" and cfg.backbone_int8:
            raise NotImplementedError(INT8_TODO)
        if cfg.backbone == "resnet" and cfg.backbone_type == "50_paper":
            channels = (1024,)
            self.backbone = ResNetBackbone(cfg.backbone_type, frozen_bn=cfg.freeze_bn)
            self.pose_net = nn.Sequential(
                nn.Conv2d(1024, 512, 1), batch_norm(512), nn.ReLU(), nn.Conv2d(512, j, 1))
        elif cfg.backbone == "hrnet" and cfg.backbone_type in HRNET_WIDTHS:
            channels = HRNET_WIDTHS[cfg.backbone_type]
            self.backbone = HRNetBackbone(cfg.backbone_type)
            self.pose_net = nn.Conv2d(channels[0], j, 3, 2, padding=1)  # H/4 -> H/8
        else:
            raise ValueError(f"the port has the ResNet 50_paper and HRNet "
                             f"{'/'.join(HRNET_WIDTHS)} backbones, not "
                             f"{cfg.backbone} {cfg.backbone_type}")
        self.sample_nets = nn.ModuleList(SampleNet(c, c // 2) for c in channels)
        # the token width of the backbone's own maps, as the JAX model takes it
        feat_dim = dataclasses.replace(cfg, backbone_channels=channels).feat_dim
        self.joints_late_fusion = CrossAttentionFusion(
            feat_dim, max_tokens=j * cfg.num_views, custom_query_length=j,
            num_layers=cfg.fusion_layers, dropout=dropout, add_pos="sin" in cfg.pos_enc,
        )
        decoder = JointsDecoderGCN if cfg.use_gcn else JointsDecoderNN
        self.joints_decoder = decoder(feat_dim)

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

        feats = self.backbone(images)
        if isinstance(feats, torch.Tensor):
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
        return {"joints_cam": self._fuse_decode(tokens_b, generator).to(out_dtype), **per_view}
