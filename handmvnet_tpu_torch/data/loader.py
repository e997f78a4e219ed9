"""Batched loader (counterpart of handmvnet_tpu/data/loader.py).

In place of the reference's wds.WebLoader with worker processes
(src/datasets/ho3d.py:285-311): a producer thread that reads, parses and
collates numpy batches into a bounded prefetch queue, and ``device_prepare``
(upload, JPEG decode on the card, crop/resize/heatmaps) on the consumer's
thread, so that the card's work stays on the thread that runs the model.
An epoch is a fixed ``steps_per_epoch`` of batches over a stream that
starts the dataset again when it runs out (the reference's ``with_epoch``,
ho3d.py:290).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np

_COLLATE_KEYS = (
    "full_rgb", "intrinsic", "extrinsic", "bboxes", "cropped_bboxes",
    "joints_img", "joints_crop_img", "joints_cam", "root_joint", "vertices",
    "all_joints_cam", "all_root_joints", "joints_img_mask",
    "mano_pose", "mano_shape",
)


def collate(samples: list[dict]) -> dict:
    """Stack the samples' arrays; ``full_jpeg`` (JPEG bytes a view) stays a
    list of the samples' lists, ``mv_sample_id`` a list of strings."""
    batch = {}
    for key in _COLLATE_KEYS:
        if key in samples[0]:
            batch[key] = np.stack([s[key] for s in samples])
    if "full_jpeg" in samples[0]:
        batch["full_jpeg"] = [s["full_jpeg"] for s in samples]
    batch["root_idx"] = np.asarray([s.get("root_idx", 0) for s in samples])
    batch["mv_sample_id"] = [s.get("mv_sample_id", "") for s in samples]
    return batch


class BatchLoader:
    """Fixed-size collated batches with a producer thread ahead.

    Args:
      dataset: iterable of parsed samples (e.g. HO3DDataset).
      batch_size: samples a batch.
      steps_per_epoch: batches an epoch.
      device_prepare: callable(batch) -> batch, run on the consumer's thread.

    One consumer at a time; an epoch abandoned early (or closed) can be
    followed by another. After a pipeline error the loader is dead.
    """

    PREFETCH = 2  # collated batches the producer may hold ready

    def __init__(self, dataset: Iterable[dict], batch_size: int, steps_per_epoch: int,
                 device_prepare: Callable[[dict], dict] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self.device_prepare = device_prepare
        self._iter: Iterator[dict] | None = None
        self._failed = False
        # two epoch iterators at once would race on the shared sample stream;
        # released when an epoch iterator closes
        self._iterating = threading.Lock()

    def _sample_stream(self) -> Iterator[dict]:
        while True:  # start the dataset again; an epoch is steps_per_epoch batches
            count = 0
            for sample in self.dataset:
                count += 1
                yield sample
            if count == 0:
                raise RuntimeError(
                    "dataset yielded zero samples in a full pass: check shard "
                    "paths and patterns and the view count of the tar samples")

    def __iter__(self) -> Iterator[dict]:
        # not a generator: the checks below run at iter(), not at the first next()
        if self._failed:
            raise RuntimeError("BatchLoader is dead after a previous pipeline error: "
                               "create a fresh BatchLoader")
        if not self._iterating.acquire(blocking=False):
            raise RuntimeError("BatchLoader is single-consumer: a previous epoch iterator "
                               "is still active (exhaust or close() it first)")
        try:
            if self._iter is None:
                self._iter = self._sample_stream()
            return _EpochIterator(self)
        except BaseException:
            self._iterating.release()
            raise

    def __len__(self) -> int:
        return self.steps_per_epoch


class _EpochIterator:
    """One epoch of a BatchLoader: owns its producer thread. A class, not a
    generator, so that the producer starts at iter() and close() (or
    __del__) winds it down and frees the loader even when the iterator is
    dropped before its first next()."""

    def __init__(self, loader: BatchLoader):
        self.loader = loader
        self._closed = False
        self._queue: queue.Queue = queue.Queue(maxsize=loader.PREFETCH)
        self._stop = stop = object()
        # set when the consumer stops early, so that the producer never
        # stays blocked on a full queue while it holds the sample stream
        self._cancelled = cancelled = threading.Event()
        q = self._queue

        def put(item) -> bool:
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for _ in range(loader.steps_per_epoch):
                    if cancelled.is_set():
                        return
                    samples = [next(loader._iter) for _ in range(loader.batch_size)]
                    if not put(collate(samples)):
                        return
            except BaseException as e:  # re-raised in the consumer
                # a producer that died must not read as a clean, short epoch
                put(e)
            finally:
                put(stop)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._closed:
            raise StopIteration
        try:
            item = self._queue.get()
            if item is self._stop:
                self.close()
                raise StopIteration
            if isinstance(item, BaseException):
                self.loader._failed = True
                raise item
            if self.loader.device_prepare is not None:
                item = self.loader.device_prepare(item)
            return item
        except StopIteration:
            raise
        except BaseException:
            self.loader._failed = True
            self.close()
            raise

    def close(self) -> None:
        """Wind the producer down (it then no longer holds the sample
        stream) and free the loader for the next epoch. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._cancelled.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():  # wedged in the dataset itself: stay dead
            self.loader._failed = True
        self.loader._iterating.release()

    def __del__(self):  # a safety net for an iterator dropped unclosed
        try:
            self.close()
        except Exception:
            pass
