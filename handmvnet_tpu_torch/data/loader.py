"""Batched loader (counterpart of handmvnet_tpu/data/loader.py).

In place of the reference's wds.WebLoader with worker processes
(src/datasets/ho3d.py:285-311), two pipeline stages on threads of their own:
  * a producer that reads, parses and collates numpy batches into a bounded
    prefetch queue;
  * a preparer (``device_prefetch``, on by default, as in the JAX loader)
    that runs ``device_prepare`` (upload, JPEG decode on the card,
    crop/resize/augmentation/heatmaps) on batch N+1 while the caller's step
    runs on batch N. On a card it works on a CUDA stream of its own: the
    decode synchronises its stream (csrc/jpeg.cpp), which must not be the
    one that queues the training step. The consumer's stream waits on an
    event recorded after the preparation, and every tensor of the batch is
    marked as used on the consumer's stream, so that the caching allocator
    does not hand its memory back to the preparer's stream early.
With ``device_prefetch=False`` the consumer's thread prepares each batch.
An epoch is a fixed ``steps_per_epoch`` of batches over a stream that
starts the dataset again when it runs out (the reference's ``with_epoch``,
ho3d.py:290).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

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
      device_prepare: callable(batch) -> batch.
      device_prefetch: run device_prepare on a preparer thread of its own,
        ahead of the consumer; else on the consumer's thread.
      device: where device_prepare puts the batches; on a CUDA device the
        preparer works on a CUDA stream of its own.

    One consumer at a time; an epoch abandoned early (or closed) can be
    followed by another. After a pipeline error the loader is dead.
    """

    PREFETCH = 2  # batches each stage may hold ready

    def __init__(self, dataset: Iterable[dict], batch_size: int, steps_per_epoch: int,
                 device_prepare: Callable[[dict], dict] | None = None,
                 device_prefetch: bool = True, device: str | torch.device = "cpu"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self.device_prepare = device_prepare
        self.device_prefetch = device_prefetch
        self.device = torch.device(device)
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
    """One epoch of a BatchLoader: owns its producer and preparer threads. A
    class, not a generator, so that the stages start at iter() and close()
    (or __del__) winds them down and frees the loader even when the iterator
    is dropped before its first next()."""

    def __init__(self, loader: BatchLoader):
        self.loader = loader
        self._closed = False
        collated: queue.Queue = queue.Queue(maxsize=loader.PREFETCH)
        self._stop = stop = object()
        # set when the consumer stops early, so that no stage stays blocked
        # on a full queue (the producer holding the sample stream)
        self._cancelled = cancelled = threading.Event()

        def put(q: queue.Queue, item) -> bool:
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
                    if not put(collated, collate(samples)):
                        return
            except BaseException as e:  # re-raised in the consumer
                # a producer that died must not read as a clean, short epoch
                put(collated, e)
            finally:
                put(collated, stop)

        self._threads = [threading.Thread(target=producer, daemon=True)]
        self._queues = [collated]
        self._inline_prepare = loader.device_prepare
        if loader.device_prepare is not None and loader.device_prefetch:
            self._inline_prepare = None
            prepared: queue.Queue = queue.Queue(maxsize=loader.PREFETCH)

            def preparer():
                # items: (batch, the event the consumer's stream waits on, or None)
                try:
                    stream = None
                    if loader.device.type == "cuda":
                        stream = torch.cuda.Stream(loader.device)
                    with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
                        while not cancelled.is_set():
                            try:
                                item = collated.get(timeout=0.1)
                            except queue.Empty:
                                continue
                            if item is stop or isinstance(item, BaseException):
                                put(prepared, item)
                                if item is stop:
                                    return
                                continue
                            batch = loader.device_prepare(item)
                            ready = None
                            if stream is not None:
                                ready = torch.cuda.Event()
                                ready.record(stream)
                            if not put(prepared, (batch, ready)):
                                return
                except BaseException as e:  # re-raised in the consumer
                    put(prepared, e)
                    put(prepared, stop)

            self._threads.append(threading.Thread(target=preparer, daemon=True))
            self._queues.append(prepared)
        self._out = self._queues[-1]
        for thread in self._threads:
            thread.start()

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._closed:
            raise StopIteration
        try:
            item = self._out.get()
            if item is self._stop:
                self.close()
                raise StopIteration
            if isinstance(item, BaseException):
                self.loader._failed = True
                raise item
            if self._inline_prepare is not None:
                return self._inline_prepare(item)
            if self.loader.device_prepare is None:
                return item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(self.loader.device)
                consumer.wait_event(ready)
                for value in batch.values():
                    if isinstance(value, torch.Tensor) and value.is_cuda:
                        value.record_stream(consumer)
            return batch
        except StopIteration:
            raise
        except BaseException:
            self.loader._failed = True
            self.close()
            raise

    def close(self) -> None:
        """Wind the stages down (the producer then no longer holds the
        sample stream) and free the loader for the next epoch. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._cancelled.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for thread in self._threads:
            thread.join(timeout=30.0)
            if thread.is_alive():  # wedged in the dataset or the preparation: stay dead
                self.loader._failed = True
        self.loader._iterating.release()

    def __del__(self):  # a safety net for an iterator dropped unclosed
        try:
            self.close()
        except Exception:
            pass
