"""Deterministic synthetic model inputs (the inference fields of
handmvnet_tpu/data/synthetic.py::synthetic_batch, drawn from the same numpy
generator in the same order, so one seed gives both packages equal inputs),
and hand-like joints for the mesh stage."""

from __future__ import annotations

import numpy as np
import torch


def synthetic_batch(batch_size: int = 2, num_views: int = 5, image_size: int = 256,
                    seed: int = 0) -> dict[str, np.ndarray]:
    """float32 numpy arrays: ``rgb`` [b, v, S, S, 3], ``bboxes`` [b, v, 4]
    xyxy and ``intrinsic`` [b, v, 4] (fx, fy, cx, cy)."""
    rng = np.random.default_rng(seed)
    b, v = batch_size, num_views
    rgb = rng.normal(size=(b, v, image_size, image_size, 3)).astype(np.float32) * 0.5
    centers = rng.uniform(200, 400, size=(b, v, 2))
    scales = rng.uniform(150, 250, size=(b, v))
    bboxes = np.concatenate(
        [centers - scales[..., None] / 2, centers + scales[..., None] / 2], axis=-1
    ).astype(np.float32)
    intr = np.tile(
        np.array([600.0, 600.0, 320.0, 240.0], dtype=np.float32), (b, v, 1)
    ) + rng.normal(size=(b, v, 4)).astype(np.float32)
    return {"rgb": rgb, "bboxes": bboxes, "intrinsic": intr}


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
