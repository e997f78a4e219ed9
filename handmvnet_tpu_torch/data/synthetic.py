"""Deterministic synthetic batches (handmvnet_tpu/data/synthetic.py::
synthetic_batch: every field drawn from the same numpy generator in the same
order, so one seed gives both packages equal arrays), and hand-like joints
for the mesh stage."""

from __future__ import annotations

import numpy as np
import torch

from handmvnet_tpu_torch.ops.heatmap import render_gaussian_heatmaps
from handmvnet_tpu_torch.ops.resize import resize_bilinear_antialias


def synthetic_batch(batch_size: int = 2, num_views: int = 5, image_size: int = 256,
                    heatmap_size: int = 32, num_joints: int = 21, seed: int = 0,
                    with_heatmaps: bool = True) -> dict[str, np.ndarray]:
    """A collated training batch of numpy arrays shaped like the reference's
    HO3D-MV samples: ``rgb`` [b, v, S, S, 3], ``bboxes`` [b, v, 4] xyxy,
    ``intrinsic`` [b, v, 4] (fx, fy, cx, cy), ``extrinsic`` [b, v, 4, 4]
    camera -> world, ``joints_crop_img`` [b, v, J, 2] pixels of the crop,
    ``joints_cam`` [b, J, 3] and ``root_joint`` [b, 1, 3] mm, ``vertices``
    [b, 778, 3] mm, ``joints_img_mask`` [b, v, J] bool (True = invisible)
    and, with ``with_heatmaps``, ``heatmap`` [b, v, J, h, h]: Gaussians
    rendered at image size and resized with antialiasing, as the reference's
    loader makes its labels."""
    rng = np.random.default_rng(seed)
    b, v, j = batch_size, num_views, num_joints
    rgb = rng.normal(size=(b, v, image_size, image_size, 3)).astype(np.float32) * 0.5
    centers = rng.uniform(200, 400, size=(b, v, 2))
    scales = rng.uniform(150, 250, size=(b, v))
    bboxes = np.concatenate(
        [centers - scales[..., None] / 2, centers + scales[..., None] / 2], axis=-1
    ).astype(np.float32)
    intr = np.tile(
        np.array([600.0, 600.0, 320.0, 240.0], dtype=np.float32), (b, v, 1)
    ) + rng.normal(size=(b, v, 4)).astype(np.float32)

    q, _ = np.linalg.qr(rng.normal(size=(b * v, 3, 3)))  # proper rotations
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    extr = np.tile(np.eye(4, dtype=np.float32), (b * v, 1, 1))
    extr[:, :3, :3] = q
    extr[:, :3, 3] = rng.normal(size=(b * v, 3)) * 0.2
    extr = extr.reshape(b, v, 4, 4).astype(np.float32)

    # the JAX package's margin: 30 px from 64^2 up, proportional below
    margin = 30 if image_size >= 64 else int(image_size * 0.3)
    joints_crop = rng.uniform(margin, image_size - margin, size=(b, v, j, 2)).astype(np.float32)
    joints_cam = (rng.normal(size=(b, j, 3)) * 30.0).astype(np.float32)
    root_joint = (rng.normal(size=(b, 1, 3)) * 100.0 + np.array([0, 0, 500.0])).astype(np.float32)
    vertices = (rng.normal(size=(b, 778, 3)) * 40.0).astype(np.float32)
    mask = rng.uniform(size=(b, v, j)) < 0.1  # ~10% of the joints invisible

    batch = {
        "rgb": rgb, "bboxes": bboxes, "intrinsic": intr, "extrinsic": extr,
        "joints_crop_img": joints_crop, "joints_cam": joints_cam, "root_joint": root_joint,
        "vertices": vertices, "joints_img_mask": mask,
    }
    if with_heatmaps:
        # one sample at a time: the full-size maps of a whole batch at 256^2
        # would take b * v * J * 256 KiB
        points = torch.from_numpy(joints_crop)
        batch["heatmap"] = np.stack([
            resize_bilinear_antialias(
                render_gaussian_heatmaps(points[i], image_size, image_size),
                (heatmap_size, heatmap_size)).numpy()
            for i in range(b)
        ]).astype(np.float32)
    return batch


# synthetic_hand_joints: rad of each axis-angle component, mm of joint
# noise, mm of the rigid shift (each the deviation of a normal draw)
HAND_POSE_RAD, HAND_NOISE_MM, HAND_SHIFT_MM = 0.3, 3.0, 100.0


def synthetic_hand_joints(mano, batch_size: int, seed: int = 0) -> torch.Tensor:
    """Hand-like joints [b, 21, 3] float32 in mm, on the CPU: ``mano`` (a
    ManoLayer on the CPU) posed with random axis-angle rotations, Gaussian
    noise on every joint but the wrist, then a random rotation and shift."""
    rng = np.random.default_rng(seed)
    pose = torch.from_numpy((rng.normal(size=(batch_size, 48)) * HAND_POSE_RAD).astype(np.float32))
    with torch.no_grad():
        _, joints = mano.from_axis_angle(pose)
    noise = rng.normal(size=(batch_size, 21, 3)) * HAND_NOISE_MM
    noise[:, 0] = 0.0
    q, _ = np.linalg.qr(rng.normal(size=(batch_size, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]  # proper rotations
    shift = rng.normal(size=(batch_size, 1, 3)) * HAND_SHIFT_MM
    out = (joints.numpy() + noise) @ np.swapaxes(q, -1, -2) + shift
    return torch.from_numpy(out.astype(np.float32))
