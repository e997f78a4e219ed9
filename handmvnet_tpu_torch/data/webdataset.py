"""WebDataset-style tar shards (counterpart of handmvnet_tpu/data/webdataset.py).

The reference's shard format: entries named ``<key>.<field>`` grouped by
key, e.g. ``000002187.image_0.jpg`` ... ``000002187.label.pyd``
(src/datasets/ho3d.py:52-91).

  * brace_expand: the ``prefix-{000000..00008}.tar`` URL pattern;
  * iter_tar_samples: the grouped samples of one shard, decoded or as raw
    bytes (the card's reader leaves the JPEGs to nvJPEG);
  * ShardDataset: samples across shards, with the train pipeline's
    resampled, shuffled shard stream and reservoir shuffle, and the split of
    shards (or of samples) between readers, as the reference's pipelines set
    them through wds (ho3d.py:251-263);
  * write_tar_shard: shards in the same format, for tests and smoke runs.

Decoding: .jpg through data/jpeg.py on the CPU (cv2, rgb8 like wds's
``.decode('rgb8')``); .pyd by pickle, since the reference's labels are
pickled dicts: read only shards you trust. Other fields stay bytes.
"""

from __future__ import annotations

import io
import pickle
import re
import tarfile
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from handmvnet_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg


def brace_expand(url: str) -> list[str]:
    """Expand each ``{A..B}`` numeric range (zero-padded to A's width)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", url)
    if not m:
        return [url]
    lo, hi = m.group(1), m.group(2)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(brace_expand(url[: m.start()] + str(i).zfill(len(lo)) + url[m.end():]))
    return out


def decode_field(name: str, payload: bytes) -> Any:
    """One tar entry's value by its field's extension (on the CPU)."""
    if name.endswith(".jpg"):
        return decode_jpeg([payload], "cpu")[0].numpy()
    if name.endswith(".pyd"):
        return pickle.loads(payload)
    return payload


def iter_tar_samples(path: str | Path, decode: bool = True) -> Iterator[dict]:
    """Yield {'__key__', '__url__', '<field>': value, ...} per sample group;
    with ``decode=False`` every value is the entry's bytes."""
    path = str(path)
    current_key: str | None = None
    sample: dict[str, Any] = {}
    with tarfile.open(path, "r") as tf:
        for member in tf:
            if not member.isfile():
                continue
            key, _, field = Path(member.name).name.partition(".")
            if key != current_key:
                if current_key is not None and sample:
                    yield sample
                current_key = key
                sample = {"__key__": key, "__url__": path}
            payload = tf.extractfile(member).read()
            sample[field] = decode_field(field, payload) if decode else payload
    if current_key is not None and sample:
        yield sample


class ShardDataset:
    """Iterable over the samples of tar shards.

    Args:
      urls: shard paths (already brace-expanded).
      preprocess: per-sample callable.
      shuffle_shards: shuffle the shard order every pass.
      resample: draw the pass's shards with replacement (the train stream,
        reference ho3d.py:255 ``resampled=True``).
      shuffle_buffer: reservoir shuffle of samples (reference .shuffle(500)).
      split_index / split_count: this reader's slice of the shards, or of the
        samples when readers outnumber shards (never with ``resample``).
      seed: epoch-stable RNG seed.
      decode: decode each entry (``decode_field``), or yield raw bytes.
    """

    def __init__(self, urls: Iterable[str], preprocess: Callable[[dict], Any] | None = None,
                 shuffle_shards: bool = False, resample: bool = False, shuffle_buffer: int = 0,
                 split_index: int = 0, split_count: int = 1, seed: int = 42,
                 decode: bool = True):
        self.urls = list(urls)
        self.preprocess = preprocess
        self.shuffle_shards = shuffle_shards
        self.resample = resample
        self.shuffle_buffer = shuffle_buffer
        self.split_index = split_index
        self.split_count = split_count
        self.seed = seed
        self.decode = decode
        self._epoch = 0

    @property
    def _sample_split(self) -> bool:
        """More readers than shards, not resampled: split by sample ordinal,
        so that no two readers see the same sample (decided from the counts
        alone, so that every reader decides alike)."""
        return not self.resample and self.split_count > max(len(self.urls), 1)

    def _shards_for_epoch(self, rng: np.random.Generator) -> list[str]:
        if self._sample_split:  # every reader walks the shards in one order
            return list(self.urls)
        urls = self.urls[self.split_index::self.split_count]
        if self.resample:
            urls = urls or self.urls  # a reader without shards of its own draws from all
            return [str(rng.choice(urls)) for _ in range(len(urls))]
        if self.shuffle_shards:
            urls = list(urls)
            rng.shuffle(urls)
        return urls

    def __iter__(self) -> Iterator[Any]:
        rng = np.random.default_rng(self.seed + self._epoch * 10007 + self.split_index)
        sample_split = self._sample_split
        self._epoch += 1
        buffer: list[Any] = []

        def emit(sample):
            return self.preprocess(sample) if self.preprocess else sample

        ordinal = 0
        for shard in self._shards_for_epoch(rng):
            for sample in iter_tar_samples(shard, decode=self.decode):
                if sample_split:
                    mine = ordinal % self.split_count == self.split_index
                    ordinal += 1
                    if not mine:
                        continue
                if self.shuffle_buffer > 1:
                    buffer.append(sample)
                    if len(buffer) >= self.shuffle_buffer:
                        idx = int(rng.integers(len(buffer)))
                        buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                        yield emit(buffer.pop())
                else:
                    yield emit(sample)
        while buffer:
            idx = int(rng.integers(len(buffer)))
            buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
            yield emit(buffer.pop())


def write_tar_shard(path: str | Path, samples: Iterable[dict],
                    device: str | torch.device = "cuda") -> None:
    """Write samples ({'__key__', field: value}) to a tar shard in the
    reference's format. JPEG fields (uint8 [H, W, 3] RGB) are encoded by
    data/jpeg.py on ``device``: nvJPEG on a card, cv2 on the CPU, whose
    bytes are the JAX package's own; .pyd fields are pickled, any other
    field is written as its bytes."""
    device = torch.device(device)
    with tarfile.open(str(path), "w") as tf:
        for sample in samples:
            key = sample["__key__"]
            for field, value in sample.items():
                if field.startswith("__"):
                    continue
                if field.endswith(".jpg"):
                    frame = torch.as_tensor(np.ascontiguousarray(value)).to(device)
                    payload = encode_jpeg(frame[None])[0]
                elif field.endswith(".pyd"):
                    payload = pickle.dumps(value)
                else:
                    payload = bytes(value)
                info = tarfile.TarInfo(name=f"{key}.{field}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
