"""Deterministic synthetic data (handmvnet_tpu/data/synthetic.py: every field
drawn from the same numpy generator in the same order, so one seed gives both
packages equal arrays): collated batches (``synthetic_batch``), tar shards in
the reference's format (``write_synthetic_ho3d_shards``), and hand-like
joints for the mesh stage."""

from __future__ import annotations

import numpy as np
import torch

from handmvnet_tpu_torch import constants
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


def _look_at_extrinsic(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """camera -> world 4x4 of a pinhole camera at ``position`` looking (+z)
    at ``target``, y down as in image coordinates."""
    z = target - position
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0])
    if abs(np.dot(up, z)) > 0.99:
        up = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    extr = np.eye(4)
    extr[:3, 0], extr[:3, 1], extr[:3, 2], extr[:3, 3] = x, y, z, position
    return extr


def _consistent_rig(num_views: int, target: np.ndarray) -> np.ndarray:
    """camera -> world [V, 4, 4] of a fixed rig: view 0 is the world frame
    (HO3D's root camera), the others on a ring around the hand, looking at it."""
    extrs = [np.eye(4)]
    radius = np.linalg.norm(target)
    for v in range(1, num_views):
        ang = 2.0 * np.pi * v / num_views
        pos = target + radius * np.array([np.sin(ang), 0.25 * np.cos(ang), -np.cos(ang)])
        extrs.append(_look_at_extrinsic(pos, target))
    return np.stack(extrs)


def _draw_hand(img: np.ndarray, joints_2d: np.ndarray) -> np.ndarray:
    """Draw the skeleton into a frame in place (bones 3 px wide at 200,
    joints discs of radius 4 at 250), so that crops show a hand. numpy, where
    the JAX package draws with cv2: the pixels differ, the labels do not."""
    h, w = img.shape[:2]

    def paint(lo, hi, inside, value):
        x0, y0 = np.maximum(np.floor(lo).astype(int), 0)
        x1, y1 = np.minimum(np.ceil(hi).astype(int) + 1, (w, h))
        if x0 >= x1 or y0 >= y1:
            return
        ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float64)
        img[y0:y1, x0:x1][inside(xs, ys)] = value

    for a, b in constants.HAND_EDGES:
        pa, pb = np.round(joints_2d[a]), np.round(joints_2d[b])
        d = pb - pa
        length2 = max(float(d @ d), 1e-12)

        def on_bone(xs, ys, pa=pa, d=d, length2=length2):
            t = np.clip(((xs - pa[0]) * d[0] + (ys - pa[1]) * d[1]) / length2, 0.0, 1.0)
            return (xs - pa[0] - t * d[0]) ** 2 + (ys - pa[1] - t * d[1]) ** 2 <= 1.5 ** 2

        paint(np.minimum(pa, pb) - 2, np.maximum(pa, pb) + 2, on_bone, 200)
    for j in np.round(joints_2d):
        paint(j - 4, j + 4, lambda xs, ys, j=j: (xs - j[0]) ** 2 + (ys - j[1]) ** 2 <= 16.0,
              250)
    return img


def write_synthetic_ho3d_shards(out_dir, num_shards: int = 3, samples_per_shard: int = 4,
                                num_views: int = 5, split: str = "train", seed: int = 0,
                                image_hw: tuple = (480, 640), consistent_geometry: bool = False,
                                prefix: str = "HO3D", device: str = "cuda") -> list:
    """Tar shards in the reference's HO3D-MV format (``image_{i}.jpg`` +
    ``label.pyd``, reference ho3d.py:52-91) with deterministic synthetic
    content: handmvnet_tpu/data/synthetic.py::write_synthetic_ho3d_shards,
    draw for draw, so one seed gives both packages the same labels (and,
    encoded on the CPU without ``consistent_geometry``, the same bytes). The
    JPEGs are encoded on ``device`` (data/jpeg.py).

    With ``consistent_geometry`` a fixed camera ring sees one world-space
    hand: ``joints_2d`` is the pinhole projection of ``joints_3d``, and the
    skeleton is drawn into the frames. ``prefix`` names the shard family
    (HO3D / DexYCB / MVHand). Returns the shard paths."""
    from pathlib import Path

    from handmvnet_tpu_torch.data.webdataset import write_tar_shard

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = image_hw
    fx = fy = 600.0
    cx, cy = w / 2.0, h / 2.0
    intr = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    target = np.array([0.0, 0.0, 0.55])
    rig = _consistent_rig(num_views, target) if consistent_geometry else None
    mean_hand_m = np.asarray(constants.MEAN_HAND_POSE, np.float64) / 1000.0

    paths = []
    counter = 0
    for shard_idx in range(num_shards):
        samples = []
        for _ in range(samples_per_shard):
            key = f"{counter:09d}"
            counter += 1
            sample = {"__key__": key}
            if consistent_geometry:
                joints_w = (target + mean_hand_m * rng.uniform(0.9, 1.1)
                            + rng.normal(size=(21, 3)) * 0.004)
                verts_w = joints_w[rng.integers(0, 21, size=778)] + rng.normal(
                    size=(778, 3)) * 0.006
                j3d, v3d, j2d, centers, scales = [], [], [], [], []
                for v in range(num_views):
                    world_to_cam = np.linalg.inv(rig[v])
                    jc = joints_w @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
                    vc = verts_w @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
                    uv = jc[:, :2] / jc[:, 2:3] * [fx, fy] + [cx, cy]
                    j3d.append(jc)
                    v3d.append(vc)
                    j2d.append(uv)
                    lo, hi = uv.min(axis=0), uv.max(axis=0)
                    centers.append((lo + hi) / 2.0)
                    scales.append(float((hi - lo).max() * 1.6))
                extr_list = [rig[v] for v in range(num_views)]
            else:
                j3d = [rng.normal(size=(21, 3)) * 0.03 + [0, 0, 0.5] for _ in range(num_views)]
                v3d = [rng.normal(size=(778, 3)) * 0.04 + [0, 0, 0.5] for _ in range(num_views)]
                j2d = [rng.uniform(100, 400, size=(21, 2)) for _ in range(num_views)]
                centers = [rng.uniform(200, 400, size=2) for _ in range(num_views)]
                scales = [float(rng.uniform(150, 250)) for _ in range(num_views)]
                extr_list = [np.eye(4, dtype=np.float64) for _ in range(num_views)]
            sample["label.pyd"] = {
                "sample_idx": [counter] * num_views,
                "idx": list(range(num_views)),
                "cam_serial": [f"cam{i}" for i in range(num_views)],
                "cam_extr": extr_list,
                "cam_intr": [intr.copy() for _ in range(num_views)],
                "bbox_center": centers,
                "bbox_scale": scales,
                "joints_2d": j2d,
                "joints_3d": j3d,
                "verts_3d": v3d,
                "joints_vis": [np.ones(21) for _ in range(num_views)],
                "mano_pose": [rng.normal(size=48) * 0.1 for _ in range(num_views)],
                "mano_shape": [rng.normal(size=10) * 0.1 for _ in range(num_views)],
                "image_path": [f"synth/{key}_{i}.jpg" for i in range(num_views)],
                "raw_size": [np.array([w, h]) for _ in range(num_views)],
            }
            for i in range(num_views):
                if consistent_geometry:
                    img = rng.integers(20, 60, size=(h, w, 3), dtype=np.uint8)
                    img = _draw_hand(img, np.asarray(j2d[i]))
                else:
                    img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
                sample[f"image_{i}.jpg"] = img
            samples.append(sample)
        path = out_dir / f"{prefix}_mv_{split}-{shard_idx:06d}.tar"
        write_tar_shard(path, samples, device=device)
        paths.append(str(path))
    return paths
