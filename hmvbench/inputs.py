"""Everything a run feeds the program and the reference, made from ``--seed``
on the run's device with ``torch.Generator``s, in a few large calls: the
model's weights, the synthetic MANO model, and pools of frames (images,
boxes, cameras and, for training, labels). The same seed gives the same
tensors; only the values change with it, never a size.

Weight scales (a configuration's ``init`` section states them): conv and
linear weights normal with He (conv) or LeCun (linear, ChebConv) deviation;
the last BatchNorm of each residual branch scaled to ``branch_gamma`` so that
eval-mode activations stay within a few units through the depth; other
norms' scales 1 + 0.1 n and shifts 0.1 n; biases 0.02 n; running means 0 and
variances 1. ``leaf_std`` sets two leaves apart: the heatmap head's last
conv, small enough that the x1000 soft-argmax is not saturated (a saturated
soft-argmax snaps each joint to one pixel, and which pixel then turns on the
last bits of the heatmap), and the decoder's last layer, so that the joints
start within a few centimetres of the root and project in front of every
camera (a point near a camera's plane makes the reprojection losses turn on
last bits too).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from hmvbench.reference.constants import (
    MANO_TIP_VERT_IDS,
    MEAN_HAND_POSE,
    NUM_JOINTS,
    NUM_MANO_VERTS,
)


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one use of the run's seed, under 2**63 for any seed."""
    h = 1469598103934665603
    for ch in f"{seed}:{tag}":
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _scale(name: str, module: nn.Module, shape: tuple, init: dict) -> tuple[float, float]:
    """(deviation, mean) of the normal draw for one state_dict entry."""
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
        if leaf == "weight":
            # a Bottleneck's bn3, a BasicBlock's bn2 in HRNet's branches
            last = isinstance(module, nn.BatchNorm2d) and (name.endswith("bn3.weight") or (
                ".branches." in name and name.endswith("bn2.weight")))
            return (0.1 * init["branch_gamma"], init["branch_gamma"]) if last else (0.1, 1.0)
        return 0.1, 0.0  # shift
    if leaf == "bias":
        return 0.02, 0.0
    if name in init["leaf_std"]:
        return init["leaf_std"][name], 0.0
    if len(shape) == 4 and module.__class__.__name__ == "ChebConv":
        return 1.0 / math.sqrt(shape[2]), 0.0
    fan_in = int(np.prod(shape[1:]))
    gain = 2.0 if len(shape) == 4 else 1.0  # He for convs (ReLU), LeCun for linears
    return math.sqrt(gain / fan_in), 0.0


def make_weights(model: nn.Module, seed: int, device, init: dict) -> dict[str, torch.Tensor]:
    """A state_dict for ``model``'s keys (the reference's, which the
    program shares), float32 on ``device``: one normal draw for every
    parameter, split and scaled leaf by leaf."""
    modules = dict(model.named_modules())
    entries = list(model.state_dict().items())
    params = [(k, tuple(v.shape)) for k, v in entries
              if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    total = sum(int(np.prod(s)) for _, s in params)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for k, shape in params:
        n = int(np.prod(shape))
        std, mean = _scale(k, modules[k.rsplit(".", 1)[0]], shape, init)
        out[k] = (flat[at:at + n] * std + mean).view(shape)
        at += n
    for k, v in entries:
        if k.endswith("running_mean"):
            out[k] = torch.zeros(v.shape, device=device)
        elif k.endswith("running_var"):
            out[k] = torch.ones(v.shape, device=device)
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
    return out


def make_mano(seed: int, device) -> dict[str, np.ndarray]:
    """A synthetic MANO model (the licensed one cannot ship): the 16 joints
    and 5 tips at the mean flat-hand layout, the other vertices scattered
    around the joints, one-hot joint regression and skinning, small shape
    and pose blend shapes. Float32 numpy arrays, drawn on ``device``."""
    g = generator(seed, "mano", device)
    mean = torch.tensor(MEAN_HAND_POSE, device=device) / 1000.0  # m
    joint_of_21 = (0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3)  # MANO order
    joints16 = mean[list(joint_of_21)]
    n = NUM_MANO_VERTS
    anchor = torch.randint(0, 16, (n,), generator=g, device=device)
    v_template = joints16[anchor] + torch.randn(n, 3, generator=g, device=device) * 0.004
    joint_ids = torch.arange(16, device=device) * 37
    tip_ids = torch.tensor(MANO_TIP_VERT_IDS, device=device)
    v_template[joint_ids] = joints16
    v_template[tip_ids] = mean[[4, 8, 12, 16, 20]]
    anchor[tip_ids] = torch.tensor([15, 3, 6, 12, 9], device=device)
    lbs = torch.zeros(n, 16, device=device)
    lbs[torch.arange(n, device=device), anchor] = 1.0
    lbs[joint_ids] = torch.eye(16, device=device)
    j_regressor = torch.zeros(16, n, device=device)
    j_regressor[torch.arange(16, device=device), joint_ids] = 1.0
    shapedirs = torch.randn(n, 3, 10, generator=g, device=device) * 1e-3
    posedirs = torch.randn(n, 3, 135, generator=g, device=device) * 1e-4
    fixed = torch.cat([joint_ids, tip_ids])  # markers stay on their joints
    shapedirs[fixed] = 0.0
    posedirs[fixed] = 0.0
    out = {"v_template": v_template, "shapedirs": shapedirs, "posedirs": posedirs,
           "j_regressor": j_regressor, "lbs_weights": lbs}
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def _rotations(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3]."""
    angle = axis_angle.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    x, y, z = (axis_angle / angle).unbind(-1)
    c, s = torch.cos(angle[..., 0]), torch.sin(angle[..., 0])
    k = 1.0 - c
    return torch.stack([
        torch.stack([c + x * x * k, x * y * k - z * s, x * z * k + y * s], -1),
        torch.stack([y * x * k + z * s, c + y * y * k, y * z * k - x * s], -1),
        torch.stack([z * x * k - y * s, z * y * k + x * s, c + z * z * k], -1)], -2)


def make_frames(count: int, views: int, image_size: int, heatmap_size: int, seed: int,
                device, labels: bool) -> dict[str, torch.Tensor]:
    """``count`` samples of ``views`` synchronised crops, float32 on
    ``device``: rgb [count, views, S, S, 3], bboxes [count, views, 4] xyxy,
    intrinsic [count, views, 4] (fx, fy, cx, cy) of a 640 x 480 camera,
    extrinsic [count, views, 4, 4] camera -> world (translation in metres).
    With ``labels`` also the training labels: joints_cam [count, 21, 3] mm
    relative to the root joint in view 0's frame, root_joint [count, 1, 3]
    mm, joints_crop_img [count, views, 21, 2] px of the crop, heatmap
    [count, views, 21, h, h] (Gaussians of deviation 1 px at the joints) and
    joints_img_mask [count, views, 21] (True = invisible, ~10%).

    The hand is the mean flat hand, turned at random and perturbed by 5 mm;
    the cameras sit 450-650 mm from it, looking at it from the front
    hemisphere, so that every joint projects inside the image and the
    reprojection losses are well posed."""
    g = generator(seed, f"frames{count}x{views}", device)
    f32 = dict(device=device, dtype=torch.float32)
    n, v, j = count, views, NUM_JOINTS
    hand = torch.tensor(MEAN_HAND_POSE, **f32)
    hand = hand - hand.mean(0)
    turn = _rotations(torch.randn(n, 3, generator=g, **f32) * 0.6)
    world = hand @ turn.transpose(-1, -2) + torch.randn(n, j, 3, generator=g, **f32) * 5.0
    # cameras: a direction in the front hemisphere, a distance, a roll
    d = torch.randn(n, v, 3, generator=g, **f32)
    d[..., 2] = -(d[..., 2].abs() + 0.8)
    d = d / d.norm(dim=-1, keepdim=True)
    dist = 450.0 + 200.0 * torch.rand(n, v, 1, generator=g, **f32)
    centre = d * dist  # camera position; the hand is at the origin
    fwd = -d
    up = torch.tensor([0.0, -1.0, 0.0], **f32).expand_as(fwd)
    right = torch.linalg.cross(up, fwd, dim=-1)
    right = right / right.norm(dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right, dim=-1)
    rot = torch.stack([right, down, fwd], dim=-1)  # camera -> world, columns
    roll = _rotations(fwd * (torch.rand(n, v, 1, generator=g, **f32) - 0.5) * 0.6)
    rot = roll @ rot
    extr = torch.zeros(n, v, 4, 4, **f32)
    extr[..., :3, :3] = rot
    extr[..., :3, 3] = centre / 1000.0  # metres, as the reprojection loss takes them
    extr[..., 3, 3] = 1.0
    fxy = 600.0 + 20.0 * torch.randn(n, v, 1, generator=g, **f32)
    intr = torch.cat([fxy, fxy, torch.full((n, v, 1), 320.0, **f32),
                      torch.full((n, v, 1), 240.0, **f32)], -1)
    cam = torch.einsum("nvji,nvkj->nvki", rot, world[:, None] - centre[:, :, None])  # R^T (p - c)
    uv = cam[..., :2] / cam[..., 2:3] * intr[..., None, :2] + intr[..., None, 2:]
    # a square box around the projected joints, jittered, 1.3-1.6x their extent
    lo, hi = uv.amin(-2), uv.amax(-2)
    side = (hi - lo).amax(-1, keepdim=True) * (1.3 + 0.3 * torch.rand(n, v, 1, generator=g, **f32))
    mid = (lo + hi) / 2 + (torch.rand(n, v, 2, generator=g, **f32) - 0.5) * 0.1 * side
    bboxes = torch.cat([mid - side / 2, mid + side / 2], -1)
    rgb = torch.randn(n, v, image_size, image_size, 3, generator=g, **f32) * 0.5
    out = {"rgb": rgb, "bboxes": bboxes, "intrinsic": intr, "extrinsic": extr}
    if not labels:
        return out
    crop = (uv - bboxes[..., None, :2]) * (image_size / side[..., None])
    root = cam[:, 0, :1]  # the wrist in view 0's frame
    hm_pts = crop * (heatmap_size / image_size)
    grid = torch.arange(heatmap_size, **f32)
    gx = torch.exp(-0.5 * (grid - hm_pts[..., :1]) ** 2)
    gy = torch.exp(-0.5 * (grid - hm_pts[..., 1:2]) ** 2)
    out.update(
        joints_cam=cam[:, 0] - root, root_joint=root, joints_crop_img=crop,
        heatmap=gy[..., :, None] * gx[..., None, :],
        joints_img_mask=torch.rand(n, v, j, generator=g, **f32) < 0.1)
    return out
