"""HO3D-MV dataset: shard layout and label parsing (counterpart of
handmvnet_tpu/data/ho3d.py, its python reader).

The reference's HO3D pipeline (src/datasets/ho3d.py):
  * shard URLs ``HO3D_mv_train-{000000..00008}.tar`` and test
    ``-{000000..00002}``; train = shards[1:-1] (all of them with
    add_val_to_train), val = [first, last], test = all (ho3d.py:221-249);
  * label.pyd parsing: intrinsics [fx, fy, cx, cy], center/scale -> integer
    xyxy box and its clamp to the 480 x 640 frame, joints and vertices in
    mm, root-relative at the root camera, visibility -> invisibility mask
    (ho3d.py:93-129);
  * the train split's stream: shards drawn with replacement and shuffled
    every pass, a 500-sample reservoir, seed 42 (ho3d.py:251-263);
  * split sizes: train 7718 (9087 with val), val 1369, test 2706
    (ho3d.py:275-280), corrected by the config's split_size_overrides
    (``DataConfig.split_size``; every dataset's sizes are in
    config.SPLIT_SIZES).

The reader stops at frames and labels: on the CPU the frames come decoded
(``full_rgb``), for a card as JPEG bytes (``full_jpeg``), which the loader's
device_prepare decodes there. Crops, augmentation and heatmaps are made on
the device (data/pipeline.py).

``data.decode_scale_denom`` d > 1 downscales the frames by d
(data/jpeg.py's ``downscale_frames``, cv2's INTER_AREA bit for bit): the
CPU reader after its cv2 decode, as the JAX python reader does; on a card
the loader after nvJPEG. d must divide both sides of ``input_res``.
``data.cache_decoded`` serves the split from the decode cache
(data/cache.py), built by the first pass (handmvnet_tpu/data/ho3d.py:212-288).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from handmvnet_tpu_torch.config import DataConfig
from handmvnet_tpu_torch.data.cache import DecodedCache
from handmvnet_tpu_torch.data.jpeg import check_scale_denom, decode_jpeg, downscale_frames
from handmvnet_tpu_torch.data.webdataset import ShardDataset, brace_expand, decode_field

_VIEW_KEYS = ("intrinsic", "intrinsic_mat", "extrinsic", "bboxes", "cropped_bboxes",
              "joints_img", "joints_crop_img", "all_joints_cam", "all_root_joints",
              "joints_img_mask")


def parse_multiview_labels(labels: dict, root_idx: int, input_res: tuple[int, int],
                           selected_views: tuple[int, ...] | None = None) -> dict:
    """label.pyd dict -> flat numpy sample fields of every view (or of
    ``selected_views``), numerically as reference ho3d.py:96-129: mm, integer
    box truncation, clamping."""
    extr = np.asarray(labels["cam_extr"], dtype=np.float32)  # (v, 4, 4)
    intr_mat = np.asarray(labels["cam_intr"], dtype=np.float32)  # (v, 3, 3)
    intr = np.stack([intr_mat[:, 0, 0], intr_mat[:, 1, 1], intr_mat[:, 0, 2],
                     intr_mat[:, 1, 2]], axis=1)

    center = np.asarray(labels["bbox_center"], dtype=np.float64)
    scale = np.asarray(labels["bbox_scale"], dtype=np.float64)
    xmin = center[:, 0] - scale * 0.5
    ymin = center[:, 1] - scale * 0.5
    boxes = np.stack([xmin, ymin, xmin + scale, ymin + scale], axis=1).astype(int)
    h, w = input_res
    clamped = np.stack([np.maximum(boxes[:, 0], 0), np.maximum(boxes[:, 1], 0),
                        np.minimum(boxes[:, 2], w), np.minimum(boxes[:, 3], h)], axis=1)

    joints_img = np.asarray(labels["joints_2d"], dtype=np.float32)  # (v, 21, 2)
    # frame -> crop coordinates (reference utils.py:124-143)
    wh = (boxes[:, 2:4] - boxes[:, 0:2]).astype(np.float32)
    joints_crop = (joints_img - boxes[:, None, 0:2]) * (256.0 / wh[:, None, :])

    joints_3d = np.asarray(labels["joints_3d"], dtype=np.float32) * 1000.0  # mm
    verts_3d = np.asarray(labels["verts_3d"], dtype=np.float32) * 1000.0
    roots = joints_3d[:, 0:1, :]
    all_joints_cam = joints_3d - roots
    all_vertices = verts_3d - roots
    invisible = np.asarray(labels["joints_vis"]) == 0  # (v, 21)
    mano_pose = np.asarray(labels["mano_pose"], dtype=np.float32)
    mano_shape = np.asarray(labels["mano_shape"], dtype=np.float32)

    sample = {
        "intrinsic": intr.astype(np.float32),
        "intrinsic_mat": intr_mat,
        "extrinsic": extr,
        "bboxes": boxes.astype(np.float32),
        "cropped_bboxes": clamped.astype(np.float32),
        "joints_img": joints_img,
        "joints_crop_img": joints_crop.astype(np.float32),
        "joints_cam": all_joints_cam[root_idx],
        "root_joint": roots[root_idx],
        "vertices": all_vertices[root_idx],
        "all_joints_cam": all_joints_cam,
        "all_root_joints": roots,
        "joints_img_mask": invisible,
        "mano_pose": mano_pose[root_idx],
        "mano_shape": mano_shape[root_idx],
        "root_idx": np.int32(root_idx),
    }
    if selected_views is not None:
        sv = np.asarray(selected_views)
        for key in _VIEW_KEYS:
            sample[key] = sample[key][sv]
    return sample


class MultiviewTarDataset:
    """The samples of one split (train, val or test) in the reference's tar
    format; the train split is the resampled, shuffled stream.

    ``device`` picks the frames' form: decoded by cv2 in the reader for the
    CPU (``full_rgb`` [V, H, W, 3] uint8), JPEG bytes for a card
    (``full_jpeg``, one bytes object a view) for nvJPEG there; the reader
    then reads raw entries and unpickles only the labels. ``split_index`` /
    ``split_count`` pick a reader's share (``ShardDataset``); ``by_sample``
    deals the samples out by ordinal whatever the shard count. With
    ``cache_decoded`` every sample carries ``full_rgb`` from the cache, on
    either device.
    """

    name = "ho3d"
    root_idx = 0
    input_res = (480, 640)  # (h, w), reference ho3d.py:26
    train_pattern = "HO3D_mv_train-{000000..00008}.tar"
    test_pattern = "HO3D_mv_test-{000000..00002}.tar"

    def __init__(self, cfg: DataConfig, split: str, split_index: int = 0, split_count: int = 1,
                 device: str | torch.device = "cuda", by_sample: bool = False):
        if split not in ("train", "val", "test"):
            raise ValueError(f"unknown split {split!r}")
        check_scale_denom(cfg.decode_scale_denom, self.input_res)
        self.cfg = cfg
        self.split = split
        self.device = torch.device(device)
        self.decoded = self.device.type == "cpu"
        self.by_sample = by_sample
        self._split = (split_index, split_count)
        train = split == "train"
        self.dataset = ShardDataset(self._split_urls(split), preprocess=self._parse,
                                    shuffle_shards=train, resample=train,
                                    shuffle_buffer=500 if train else 0,
                                    split_index=split_index, split_count=split_count,
                                    by_sample=by_sample, decode=self.decoded)

    def _split_urls(self, split: str) -> list[str]:
        train_urls = brace_expand(os.path.join(self.cfg.dataset_dir, self.train_pattern))
        if split == "test":
            return brace_expand(os.path.join(self.cfg.dataset_dir, self.test_pattern))
        if split == "train":
            return train_urls if self.cfg.add_val_to_train else train_urls[1:-1]
        return [train_urls[0], train_urls[-1]]

    def count_samples(self) -> int:
        """The samples the split's shards hold (every reader's), counted from
        the tar headers."""
        return self.dataset.count_samples()

    def num_samples(self) -> int:
        """The split's size (``DataConfig.split_size``), which sizes its epoch."""
        return self.cfg.split_size(self.split)

    def _parse(self, raw: dict) -> dict:
        views = self.cfg.selected_views
        labels = raw["label.pyd"] if self.decoded else decode_field("label.pyd", raw["label.pyd"])
        sample = parse_multiview_labels(labels, self.root_idx, self.input_res, views)
        if self.decoded:
            frames = np.stack([raw[f"image_{i}.jpg"] for i in views]).astype(np.uint8)
            sample["full_rgb"] = downscale_frames(torch.from_numpy(frames),
                                                  self.cfg.decode_scale_denom).numpy()
        else:
            sample["full_jpeg"] = [raw[f"image_{i}.jpg"] for i in views]
        sample["mv_sample_id"] = os.path.join(raw["__url__"], raw["__key__"])
        return sample

    def __iter__(self) -> Iterator[dict]:
        if self.cfg.cache_decoded:
            return self._iter_cached()
        return iter(self.dataset)

    # ------------------------------------------------------------ decode cache --
    def _cache(self) -> DecodedCache:
        """This reader's store, its identity taken at first use, while the
        shards are there to stat. The decoder is part of it: a card's nvJPEG
        pixels are not libjpeg's, so a card build ("nvjpeg") never shares a
        directory with a CPU one, which records what JAX's python reader
        records ("any" at d = 1, where libjpeg's readers agree, else
        "python") and so shares JAX's."""
        cached = getattr(self, "_cache_obj", None)
        if cached is not None:
            return cached

        def stat(url: str) -> list:
            st = os.stat(url)
            return [os.path.basename(url), st.st_size, int(st.st_mtime)]

        d = self.cfg.decode_scale_denom
        identity = {
            "name": self.name,
            "split": self.split,
            "views": list(self.cfg.selected_views),
            "denom": d,
            "split_slice": list(self._split),
            "input_res": list(self.input_res),
            "shards": [stat(u) for u in self._split_urls(self.split)],
            "reader": "nvjpeg" if not self.decoded else ("any" if d == 1 else "python"),
        }
        if self.by_sample:
            identity["by_sample"] = True
        self._cache_obj = DecodedCache(self.cfg.decoded_cache_dir, identity)
        return self._cache_obj

    def _iter_cached(self) -> Iterator[dict]:
        """One epoch from the store: a cold store is first built from one
        pass over this reader's share; the train split is shuffled over the
        whole epoch (seed 42 + epoch x 10007), val and test keep their order."""
        cache = self._cache()
        if not cache.complete:
            cache.build(self._decode_once())
        epoch = getattr(self, "_cache_epoch", 0)
        self._cache_epoch = epoch + 1
        return cache.iter_samples(shuffle=self.split == "train", seed=42, epoch=epoch)

    def _decode_once(self) -> Iterator[dict]:
        """This reader's share, each sample once, in shard order (no
        resampling, no reservoir: the store shuffles), decoded."""
        samples = iter(ShardDataset(self._split_urls(self.split), preprocess=self._parse,
                                    split_index=self._split[0], split_count=self._split[1],
                                    by_sample=self.by_sample, decode=self.decoded))
        return samples if self.decoded else self._decode_on_card(samples)

    def _decode_on_card(self, samples: Iterator[dict]) -> Iterator[dict]:
        """The card's samples with ``full_rgb`` in place of ``full_jpeg``:
        ``batch_size`` samples a nvJPEG call, as the loader decodes a batch
        (nvJPEG's pixels depend on the batch's size), then the downscale,
        on a stream of the build's own, so that a step queued on another
        stream neither waits for it nor runs into it (csrc/jpeg.cpp drains
        the stream it decodes on)."""
        stream = torch.cuda.Stream(self.device)
        d = self.cfg.decode_scale_denom
        while True:
            chunk = [s for _, s in zip(range(self.cfg.batch_size), samples)]
            if not chunk:
                return
            with torch.cuda.stream(stream):
                flat = [jpeg for s in chunk for jpeg in s["full_jpeg"]]
                frames = downscale_frames(decode_jpeg(flat, self.device), d).cpu().numpy()
            for sample, rgb in zip(chunk, frames.reshape(len(chunk), -1, *frames.shape[1:])):
                sample = {k: v for k, v in sample.items() if k != "full_jpeg"}
                sample["full_rgb"] = rgb
                yield sample


class HO3DDataset(MultiviewTarDataset):
    pass
