"""Data parallelism over ranks, one process a device (counterpart of
handmvnet_tpu/parallel/mesh.py).

The reference trains its release configs with Lightning DDP over ``gpus: 2``
(reference train.py:39-44); the JAX package shard_maps one step over a 1-D
data mesh. Here each rank is one process with one device, joined by
``torch.distributed`` from the ``env://`` rendezvous that ``torchrun`` sets
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or
that ``spawn_local_ranks`` sets for N ranks on this host. The training path
needs two collectives, ``all_reduce`` and ``broadcast``, which NCCL runs on
cards and gloo on the CPU (and on CUDA tensors, through host memory, which
lets two ranks share one card).
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

# A rank that raises leaves the others in their next collective; the timeout
# ends them there instead of leaving them to wait forever. It must exceed the
# longest skew between ranks at one collective: a checkpoint written by rank 0
# while the others wait at the barrier after it, or one rank's first kernel
# build (seconds; spawn_local_ranks' caller builds before the ranks start).
TIMEOUT = timedelta(minutes=10)


def launched() -> bool:
    """Whether a launcher set the env:// rendezvous for this process."""
    return "WORLD_SIZE" in os.environ


def check_device_count(ranks: int, device_type: str) -> None:
    """Raise when ``ranks`` ranks of this host would share its cards:
    make_mesh's rule (handmvnet_tpu/parallel/mesh.py:30-36). CPU ranks share
    the host."""
    if device_type == "cuda" and ranks > torch.cuda.device_count():
        raise ValueError(f"{ranks} ranks asked for on this host, which has "
                         f"{torch.cuda.device_count()} CUDA devices: one rank a card")


def init_data_parallel(device_type: str = "cuda", backend: str | None = None
                       ) -> tuple[torch.device, dist.ProcessGroup]:
    """Join the env:// rendezvous; returns this rank's device (cuda:LOCAL_RANK,
    or the CPU) and the process group of all ranks. ``backend`` defaults to
    NCCL for CUDA devices and gloo for the CPU."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    check_device_count(int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1)), device_type)
    device = torch.device(device_type, local_rank) if device_type == "cuda" \
        else torch.device(device_type)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    return device, dist.group.WORLD


def is_main(group: dist.ProcessGroup | None = None) -> bool:
    """Rank 0, or the one process when there is no group: the rank that
    writes files and logs."""
    return group is None or dist.get_rank(group) == 0


def rank_and_world(group: dist.ProcessGroup | None = None) -> tuple[int, int]:
    return (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))


def all_reduce_mean_(flat: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The mean of ``flat`` over the group's ranks, in place, in one call
    (a sum and a division: gloo has no average)."""
    dist.all_reduce(flat, group=group)
    return flat.div_(dist.get_world_size(group))


def barrier(group: dist.ProcessGroup | None) -> None:
    if group is not None:
        dist.barrier(group)


def broadcast_module_(module: nn.Module, group: dist.ProcessGroup, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` from rank ``src``, in place,
    one broadcast a dtype (replicate_state, handmvnet_tpu/parallel/mesh.py:133-153)."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, src, group=group)
            torch._foreach_copy_(tensors, [c.view_as(t) for c, t in zip(
                flat.split([t.numel() for t in tensors]), tensors)])


def warmup_collectives(group: dist.ProcessGroup, device: torch.device) -> None:
    """One tiny all-reduce right after the rendezvous, while every rank is
    there: it sets up the backend's channels before the first long stretch
    of rank-local work (handmvnet_tpu/parallel/mesh.py:117-131)."""
    dist.all_reduce(torch.zeros(1, device=device), group=group)


class StopSignal:
    """A request to stop (SIGTERM) that any rank may take, agreed by every
    rank at the same optimizer step, so that all of them reach the
    checkpoint's barrier together.

    Without a group ``poll`` answers the request at once. With one, each
    ``poll`` all-reduces (MAX) the flag on the step's stream and copies the
    result to host memory behind an event, and reads the result of the
    previous ``poll``: the step before the last, whose work the card has
    finished or is finishing while the last step is queued. So no rank reads
    the card's state at once after a step, and every rank reads the same
    flags in the same step."""

    def __init__(self, device: torch.device, group: dist.ProcessGroup | None = None):
        self.requested = False
        self.group = group
        if group is not None:
            self._flag = torch.zeros(1, device=device)
            self._seen = torch.zeros(1, pin_memory=device.type == "cuda")
            self._done = torch.cuda.Event() if device.type == "cuda" else None
            self._pending = False

    def poll(self) -> bool:
        """Call after every optimizer step; True when every rank stops now."""
        if self.group is None:
            return self.requested
        stop = False
        if self._pending:
            if self._done is not None:
                self._done.synchronize()
            stop = bool(self._seen[0] > 0)
        self._flag.fill_(float(self.requested))
        dist.all_reduce(self._flag, op=dist.ReduceOp.MAX, group=self.group)
        self._seen.copy_(self._flag, non_blocking=True)
        if self._done is not None:
            self._done.record()
        self._pending = True
        return stop


def free_port() -> int:
    """A TCP port of localhost free at the time of the call (a rendezvous
    port for MASTER_PORT)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local_rank: int, world: int, port: int, fn: Callable, args: tuple) -> None:
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    # the ranks share the host's cores, as torchrun's ranks do
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    fn(*args)


def spawn_local_ranks(fn: Callable, args: tuple, ranks: int) -> None:
    """Run ``fn(*args)`` in ``ranks`` new processes of this host, ranks 0 ..
    ranks - 1 of one env:// rendezvous on localhost (torchrun --nproc-per-node
    ranks). Returns when all of them have; when one fails, the others are
    ended and SystemExit names it."""
    import torch.multiprocessing as mp

    try:
        mp.start_processes(_rank_entry, args=(ranks, free_port(), fn, args), nprocs=ranks,
                           start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SystemExit(f"rank {e.error_index} of {ranks} failed: {e}") from e


def start_local_ranks(main_fn, argv: list, ranks: int, device_type: str) -> None:
    """``main_fn(argv)`` in ``ranks`` new rank processes of this host, one a
    device, the kernels built once before they start."""
    check_device_count(ranks, device_type)
    if device_type == "cuda":
        from handmvnet_tpu_torch.ops import _build

        _build.build_all()
    spawn_local_ranks(main_fn, (argv,), ranks)
