"""The decode cache behind ``data.cache_decoded`` (counterpart of
handmvnet_tpu/data/cache.py, the same layout and naming, so that a store the
JAX package built serves the port's CPU readers and the other way round).

The first full pass over a split writes every parsed sample, its decoded
uint8 frames and its labels, to a store; every later epoch reads the frames
from a memmap (the page cache) and decodes nothing.

Layout, one directory per cache identity under ``data.cache_dir`` (default
``<dataset_dir>/decoded_cache``), named ``<name>_<split>_<sha256(identity)[:16]>``:

  frames.u8   the samples' ``full_rgb`` back to back, one fixed
              [V, H, W, 3] uint8 shape, memmapped for reading
  labels.pkl  the list of each sample's other fields
  meta.json   the sample count and frame shape, written last and atomically:
              a directory without it is an aborted build, which is rebuilt

The identity (data/ho3d.py's ``_cache``) covers the shards (basename, size,
mtime), the views, decode_scale_denom, the reader's share of the split and
the decoder, so that any change builds a new store instead of serving stale
or other frames. Each reader's share is part of it, so no two ranks build
into one directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np


class DecodedCache:
    def __init__(self, root: str | Path, identity: dict):
        blob = json.dumps(identity, sort_keys=True, default=str).encode()
        digest = hashlib.sha256(blob).hexdigest()[:16]
        name, split = identity.get("name", "ds"), identity.get("split", "data")
        self.dir = Path(root) / f"{name}_{split}_{digest}"
        self.identity = identity
        self._frames: np.memmap | None = None
        self._labels: list[dict] | None = None
        self._meta: dict | None = None

    @property
    def complete(self) -> bool:
        return (self.dir / "meta.json").exists()

    def build(self, samples: Iterable[dict]) -> int:
        """Write one full pass of parsed samples (each with ``full_rgb``) and
        return their count. meta.json lands last, so a build that dies
        midway leaves a directory that the next run builds again."""
        self.dir.mkdir(parents=True, exist_ok=True)
        labels: list[dict] = []
        shape: tuple[int, ...] | None = None
        with open(self.dir / "frames.u8", "wb") as f:
            for sample in samples:
                rgb = np.ascontiguousarray(sample["full_rgb"], dtype=np.uint8)
                if shape is None:
                    shape = rgb.shape
                elif rgb.shape != shape:
                    raise ValueError(f"decode cache build: a frame stack of {rgb.shape} after "
                                     f"{shape}: every sample must share one [V, H, W, 3] layout")
                f.write(rgb.tobytes())
                labels.append({k: v for k, v in sample.items() if k != "full_rgb"})
        if not labels:
            raise RuntimeError("decode cache build saw no sample: check the shard paths and "
                               "patterns (data.cache_decoded)")
        with open(self.dir / "labels.pkl", "wb") as f:
            pickle.dump(labels, f, protocol=pickle.HIGHEST_PROTOCOL)
        tmp = self.dir / "meta.json.tmp"
        tmp.write_text(json.dumps({"n": len(labels), "frame_shape": list(shape),
                                   "identity": self.identity}, indent=2, default=str))
        os.replace(tmp, self.dir / "meta.json")  # the atomic completion marker
        return len(labels)

    def _open(self) -> None:
        # the labels load into memory; the frames stay on disk behind a memmap
        if self._meta is None:
            self._meta = json.loads((self.dir / "meta.json").read_text())
            shape = (self._meta["n"], *self._meta["frame_shape"])
            self._frames = np.memmap(self.dir / "frames.u8", dtype=np.uint8, mode="r",
                                     shape=shape)
            with open(self.dir / "labels.pkl", "rb") as f:
                self._labels = pickle.load(f)

    def __len__(self) -> int:
        self._open()
        return self._meta["n"]

    def iter_samples(self, shuffle: bool = False, seed: int = 42,
                     epoch: int = 0) -> Iterator[dict]:
        """One pass over the stored samples, in stored order or, with
        ``shuffle``, in a permutation of the whole epoch from
        ``default_rng(seed + epoch * 10007)``. ``full_rgb`` is a memmap view,
        which collate's np.stack reads from the page cache."""
        self._open()
        order = np.arange(self._meta["n"])
        if shuffle:
            np.random.default_rng(seed + epoch * 10007).shuffle(order)
        for i in order:
            sample = dict(self._labels[i])
            sample["full_rgb"] = self._frames[i]
            yield sample
