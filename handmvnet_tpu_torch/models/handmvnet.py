"""HandMvNet forward (counterpart of handmvnet_tpu/models/handmvnet.py, stage
"full", relative root), for inference (``.eval()``) and training
(``.train()``: BatchNorm batch statistics, dropout in the fusion blocks):

  rgb [b, v, H, W, 3]
    -> per-view ResNet-50 "paper" backbone over b*v images (NCHW inside)
    -> 1x1 pose_net head -> heatmaps [b*v, 21, H/8, W/8]
    -> soft-argmax at temperature 1000, in >= f32 -> coords [b*v, 21, 2]
    -> SampleNet point features [b*v, 21, 512] (+ coords, + crop-FoV angles)
    -> tokens [b, v*21, 524] -> CrossAttentionFusion -> [b, 21, 524]
    -> ChebConv GCN decoder -> joints_cam [b, 21, 3]

The public layout is the JAX package's; the output dict is the same, every
entry at >= f32.
"""

from __future__ import annotations

import torch
from torch import nn

from handmvnet_tpu_torch.config import ModelConfig
from handmvnet_tpu_torch.models.backbones.resnet import ResNetBackbone
from handmvnet_tpu_torch.models.fusion import CrossAttentionFusion
from handmvnet_tpu_torch.models.layers import batch_norm
from handmvnet_tpu_torch.models.nets import JointsDecoderGCN, JointsDecoderNN, SampleNet
from handmvnet_tpu_torch.ops.geometry import box_corner_points, centered_coordinates, fov_angles
from handmvnet_tpu_torch.ops.heatmap import soft_argmax_2d


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class HandMvNet(nn.Module):
    """The port covers the release configs' model: ResNet "50_paper", the
    cross_attn fusion, root-relative output. ``dropout`` is the fusion
    blocks' rate (the reference fixes 0.1; 0 trains without dropout)."""

    def __init__(self, cfg: ModelConfig, image_size: int = 256, heatmap_size: int = 32,
                 dropout: float = 0.1):
        super().__init__()
        if cfg.backbone != "resnet" or cfg.backbone_type != "50_paper":
            raise ValueError(f"the port has the ResNet 50_paper backbone only, not "
                             f"{cfg.backbone} {cfg.backbone_type}")
        if cfg.fusion != "cross_attn":
            raise ValueError(f"the port has the cross_attn fusion only, not {cfg.fusion}")
        self.cfg = cfg
        self.image_size = image_size
        self.heatmap_size = heatmap_size
        j = cfg.num_joints
        channels = 1024
        self.backbone = ResNetBackbone(cfg.backbone_type, frozen_bn=cfg.freeze_bn)
        self.pose_net = nn.Sequential(
            nn.Conv2d(channels, 512, 1), batch_norm(512), nn.ReLU(), nn.Conv2d(512, j, 1)
        )
        self.sample_nets = nn.ModuleList([SampleNet(channels, channels // 2)])
        feat_dim = cfg.feat_dim
        self.joints_late_fusion = CrossAttentionFusion(
            feat_dim, max_tokens=j * cfg.num_views, custom_query_length=j,
            num_layers=cfg.fusion_layers, dropout=dropout, add_pos="sin" in cfg.pos_enc,
        )
        decoder = JointsDecoderGCN if cfg.use_gcn else JointsDecoderNN
        self.joints_decoder = decoder(feat_dim)

    def forward(self, rgb: torch.Tensor, bboxes: torch.Tensor | None = None,
                intrinsics: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """rgb [b, v, H, W, 3]; bboxes [b, v, 4] xyxy; intrinsics [b, v, 4]
        (fx, fy, cx, cy); ``generator`` draws the dropout masks in train mode.
        Returns joints_cam [b, 21, 3], joints_crop_img [b, v, 21, 2] and
        heatmap [b, v, 21, h, w]."""
        cfg = self.cfg
        b, v = rgb.shape[:2]
        j = cfg.num_joints
        x = rgb.reshape(b * v, *rgb.shape[2:]).permute(0, 3, 1, 2)  # NCHW view

        feat = self.backbone(x)
        heatmaps = self.pose_net(feat)  # [b*v, J, h, w]
        # the x1000 softmax overflows bf16: promote, never downcast
        joint_coords = soft_argmax_2d(heatmaps.to(_at_least_f32(heatmaps.dtype))).to(rgb.dtype)

        tokens = self.sample_nets[0](feat, joint_coords)  # [b*v, J, 512]
        if "pos2d" in cfg.pos_enc:
            tokens = torch.cat([tokens, joint_coords], dim=-1)
        if "crop" in cfg.pos_enc:
            if bboxes is None or intrinsics is None:
                raise ValueError("the crop encoding needs bboxes and intrinsics")
            enc_dtype = _at_least_f32(bboxes.dtype)
            boxes = bboxes.reshape(b * v, 4).to(enc_dtype)
            intr = intrinsics.reshape(b * v, 4).to(enc_dtype)
            cc = centered_coordinates(box_corner_points(boxes), intr[:, 2], intr[:, 3])
            fov = fov_angles(cc, intr[:, 0], intr[:, 1]).reshape(b * v, 1, 10)
            tokens = torch.cat([tokens, fov.to(tokens.dtype).expand(b * v, j, 10)], dim=-1)

        tokens_b = tokens.reshape(b, v * j, tokens.shape[-1])
        joints_cam = self.joints_decoder(self.joints_late_fusion(tokens_b, generator))

        scale = float(self.image_size) / float(self.heatmap_size)
        out_dtype = _at_least_f32(rgb.dtype)
        hs = heatmaps.shape[-2:]
        return {
            "joints_cam": joints_cam.to(out_dtype),
            "joints_crop_img": (joint_coords.reshape(b, v, j, 2) * scale).to(out_dtype),
            "heatmap": heatmaps.reshape(b, v, j, *hs).to(out_dtype),
        }
