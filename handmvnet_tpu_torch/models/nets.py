"""Point-feature sampler and joint decoders (counterpart of
handmvnet_tpu/models/nets.py), and the dormant sub-networks no config
selects: the legacy PoseNet head and the graph nets."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from handmvnet_tpu_torch import constants
from handmvnet_tpu_torch.models.layers import ChebConv, GraphConv, batch_norm, leaky_relu
from handmvnet_tpu_torch.ops.graph import cheb_basis
from handmvnet_tpu_torch.ops.heatmap import soft_argmax_2d
from handmvnet_tpu_torch.ops.sampling import sample_points_bilinear


class SampleNet(nn.Module):
    """1x1 conv + BN + ReLU halving the channels, then bilinear sampling of
    the joint locations. Coordinates arrive in 32x32-heatmap pixel units for
    every feature map (the reference's cross-scale quirk, kept)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 1), batch_norm(out_channels), nn.ReLU()
        )

    def forward(self, feat: torch.Tensor, joint_coords: torch.Tensor) -> torch.Tensor:
        """feat [B, C, H, W], joint_coords [B, J, 2] -> [B, J, C/2]."""
        return sample_points_bilinear(self.conv(feat), joint_coords)


def hand_cheb_basis(order: int = 2) -> torch.Tensor:
    return torch.from_numpy(cheb_basis(constants.NUM_JOINTS, constants.HAND_EDGES, order))


class JointsDecoderGCN(nn.Module):
    """Three ChebConv(K=2) layers over the hand skeleton, feat -> 256 -> 64 ->
    3, with LeakyReLU between them. The basis is a constant buffer (not in
    the state_dict)."""

    def __init__(self, in_features: int, out_dim: int = 3):
        super().__init__()
        self.joints_gcn1 = ChebConv(in_features, 256, order=2)
        self.joints_gcn2 = ChebConv(256, 64, order=2)
        self.joints_gcn3 = ChebConv(64, out_dim, order=2)
        self.register_buffer("basis", hand_cheb_basis(order=2), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.joints_gcn1(x, self.basis))
        h = leaky_relu(self.joints_gcn2(h, self.basis))
        return self.joints_gcn3(h, self.basis)


class JointsDecoderNN(nn.Module):
    """MLP decoder feat -> 64 -> 3 (the decoder of configs with use_gcn off)."""

    def __init__(self, in_features: int, out_dim: int = 3):
        super().__init__()
        self.joints_fc1 = nn.Linear(in_features, 64)
        self.joints_fc2 = nn.Linear(64, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.joints_fc2(leaky_relu(self.joints_fc1(x)))


class PoseNet(nn.Module):
    """The legacy heatmap head: 1x1 conv + BN + ReLU for each width of
    ``channels`` but the last, then a 1x1 conv to the last; returns the
    soft-argmax coordinates [B, J, 2] and the heatmaps [B, J, H, W]. Its
    ``conv.N`` keys are the source of the legacy ``pose_net.conv.*`` keys
    (checkpoint.LEGACY_REMAPS)."""

    def __init__(self, in_channels: int, channels: tuple[int, ...] = (512, 21)):
        super().__init__()
        layers: list[nn.Module] = []
        for c in channels[:-1]:
            layers += [nn.Conv2d(in_channels, c, 1), batch_norm(c), nn.ReLU()]
            in_channels = c
        layers.append(nn.Conv2d(in_channels, channels[-1], 1))
        self.conv = nn.Sequential(*layers)

    def forward(self, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        hm = self.conv(feat)
        return soft_argmax_2d(hm), hm


class GraphChebConvNet(nn.Module):
    """A ChebConv stack of ``num_layers`` over the hand skeleton, in_dim ->
    hidden_dim ... -> out_dim, LeakyReLU between the layers."""

    def __init__(self, in_dim: int, out_dim: int = 3, hidden_dim: int = 128,
                 num_layers: int = 3, order: int = 2):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.gcn_layers = nn.ModuleList(ChebConv(dims[i], dims[i + 1], order=order)
                                        for i in range(num_layers))
        self.register_buffer("basis", hand_cheb_basis(order=order), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.gcn_layers):
            x = layer(x, self.basis)
            if i < len(self.gcn_layers) - 1:
                x = leaky_relu(x)
        return x


class GraphConvNet(nn.Module):
    """Two dense GraphConvs (to in_features / 2, then out_features, ReLU
    after each) over a learned adjacency ``A_hat`` [nodes, nodes]."""

    def __init__(self, in_features: int, out_features: int, nodes: int):
        super().__init__()
        self.A_hat = nn.Parameter(torch.randn(nodes, nodes))
        self.gconv1 = GraphConv(in_features, in_features // 2)
        self.gconv2 = GraphConv(in_features // 2, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gconv2(self.gconv1(x, self.A_hat), self.A_hat)


class ResidualGraphConv(nn.Module):
    """relu(x + g2(relu(g1(x)))) with g1, g2 GraphConvNets of widths
    input_dim -> hid_dim -> input_dim."""

    def __init__(self, input_dim: int, hid_dim: int, nodes: int):
        super().__init__()
        self.gconv1 = GraphConvNet(input_dim, hid_dim, nodes)
        self.gconv2 = GraphConvNet(hid_dim, input_dim, nodes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x + self.gconv2(F.relu(self.gconv1(x))))
