"""View-parallel inference over ranks, one rank a device (counterpart of
handmvnet_tpu/parallel/view_parallel.py).

HandMvNet's forward is per view up to the tokens: the backbone, the heatmap
head and the SampleNets run each view alone, and the views meet only in the
cross-view fusion over 21 tokens a view. So the views spread over ranks:

  a (data, view) grid of D x V ranks, view the minor axis: rank r sits at
  row r // V and column r % V
    rgb [b, v, H, W, 3] -> this rank's block [b/D, v/V, H, W, 3]
    -> the "tokens" stage on the block       (the per-view trunk)
    -> all_gather of the tokens over the row's V ranks, in view order
    -> the "fuse" stage on [b/D, v*21, feat] (replicated over the row)

The collective moves b/D x v*21 x feat values; the weights are replicated
(no weight is sharded: the fusion's matmuls are too small to gain from it).
Inference only. The ranks join as parallel/mesh.py's do (env://, NCCL on
cards, gloo on the CPU, ``init_data_parallel``). This module imports no
model code, so that a serving bundle's loader (export.load_bundle) can use
the grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

DATA_AXIS, VIEW_AXIS = "data", "view"
ROW_KEYS = ("joints_cam", "vertices")  # outputs of a whole sample, the same on a row's ranks
ROOT_RELATIVE_ONLY = (
    "view-parallel inference supports the release (root-relative) configs; the "
    "dormant absolute-root branch fuses per-view wrist tokens and is not plumbed "
    "through the token gather")


@dataclass(frozen=True)
class InferenceMesh:
    """This rank's place in a (data, view) grid of ranks."""

    data: int
    view: int
    group: dist.ProcessGroup  # every rank of the grid
    view_group: dist.ProcessGroup  # the V ranks of this rank's row, in column order
    rank: int  # in ``group``

    @property
    def row(self) -> int:
        return self.rank // self.view

    @property
    def column(self) -> int:
        return self.rank % self.view


def make_inference_mesh(data: int, view: int,
                        group: dist.ProcessGroup | None = None) -> InferenceMesh:
    """The (data, view) grid over the ``data * view`` ranks of ``group``
    (default: every rank), view the minor axis. Every rank of the group must
    call it: it makes the rows' subgroups with ``dist.new_group``."""
    group = group or dist.group.WORLD
    world = dist.get_world_size(group)
    if data < 1 or view < 1 or data * view != world:
        raise ValueError(f"a {data}x{view} mesh needs {data * view} ranks; the process group "
                         f"has {world}")
    rank = dist.get_rank(group)
    rows = [dist.new_group([dist.get_global_rank(group, r * view + c) for c in range(view)])
            for r in range(data)]
    return InferenceMesh(data, view, group, rows[rank // view], rank)


def view_block(mesh: InferenceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block [b/D, v/V, ...] of a global [b, v, ...] batch leaf
    (a view; the counterpart of ``view_data_sharding``). Refuses what the
    JAX forward refuses (handmvnet_tpu/parallel/view_parallel.py:119-130)."""
    b, v = x.shape[:2]
    if v % mesh.view:
        raise ValueError(f"num_views={v} must divide over the view mesh axis ({mesh.view})")
    if b % mesh.data:
        raise ValueError(f"batch={b} must divide over the data mesh axis ({mesh.data})")
    bd, vv = b // mesh.data, v // mesh.view
    return x[mesh.row * bd:(mesh.row + 1) * bd, mesh.column * vv:(mesh.column + 1) * vv]


def gather_views(mesh: InferenceMesh, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The row's blocks of ``x``, concatenated along ``dim`` in column
    order: the tokens [b/D, v/V*21, feat] of every column as
    [b/D, v*21, feat]."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.view)]
    dist.all_gather(parts, x, group=mesh.view_group)
    return torch.cat(parts, dim=dim)


def gather_outputs(mesh: InferenceMesh,
                   out: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The global outputs of a view-parallel step on every rank, from every
    rank's own: the per-view entries put back at [b, v, ...], and the
    entries of a row (joints_cam, vertices: ROW_KEYS) at [b, ...] from each
    row's first column. One all_gather over the grid a key."""
    full = {}
    for key, x in out.items():
        parts = [torch.empty_like(x) for _ in range(mesh.data * mesh.view)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        rows = [parts[r * mesh.view:(r + 1) * mesh.view] for r in range(mesh.data)]
        full[key] = torch.cat([row[0] if key in ROW_KEYS else torch.cat(row, dim=1)
                               for row in rows])
    return full


def stage_runner(model: torch.nn.Module, compute_dtype: str) -> Callable:
    """model(x, ..., stage=...) in the compute dtype: bf16 runs on the
    parameters cast as the bf16 training step casts them (the JAX forward
    casts every fp32 parameter, :79-87), on rgb cast to bf16."""
    if compute_dtype == "float32":
        return model
    if compute_dtype != "bfloat16":
        raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")
    from handmvnet_tpu_torch.train_step import bf16_compute_params

    def run(x, *args, stage):
        if stage != "fuse":
            x = x.to(torch.bfloat16)
        return torch.func.functional_call(model, bf16_compute_params(model), (x, *args),
                                          {"stage": stage})

    return run


def view_parallel_forward(mesh: InferenceMesh, tokens_stage: Callable,
                          fuse_stage: Callable) -> Callable:
    """fn(rgb, bboxes, intrinsic) -> dict on each rank of ``mesh``, from the
    global [b, v, ...] batch: ``tokens_stage`` on this rank's block (a dict
    of tokens, joints_crop_img, heatmap), the tokens' all_gather over the
    row, then ``fuse_stage`` on [b/D, v*21, feat] (a dict of the row's
    entries). Returns this rank's per-view entries and its row's."""

    def forward(rgb, bboxes, intrinsic):
        with torch.inference_mode():
            tk = tokens_stage(*(view_block(mesh, t) for t in (rgb, bboxes, intrinsic)))
            return {"joints_crop_img": tk["joints_crop_img"], "heatmap": tk["heatmap"],
                    **fuse_stage(gather_views(mesh, tk["tokens"]))}

    return forward


def make_view_parallel_forward(model: torch.nn.Module, mesh: InferenceMesh,
                               compute_dtype: str = "float32",
                               root_relative: bool = True) -> Callable:
    """``view_parallel_forward`` of ``model``'s "tokens" and "fuse" stages:
    this rank's joints_crop_img [b/D, v/V, 21, 2] and heatmap
    [b/D, v/V, 21, h, w], and its row's joints_cam [b/D, 21, 3], the same on
    each rank of the row. Outputs at >= f32 in either compute dtype.
    ``model`` in eval mode."""
    if not root_relative:
        raise ValueError(ROOT_RELATIVE_ONLY)
    run = stage_runner(model, compute_dtype)

    def fuse(tokens):
        joints_cam = run(tokens, stage="fuse")
        return {"joints_cam": joints_cam.to(torch.promote_types(joints_cam.dtype, torch.float32))}

    return view_parallel_forward(mesh, lambda *block: run(*block, stage="tokens"), fuse)


def make_replication_check(model: torch.nn.Module, mesh: InferenceMesh,
                           compute_dtype: str = "float32",
                           root_relative: bool = True) -> Callable:
    """fn(rgb, bboxes, intrinsic) -> [b/D, V, 21, 3]: each column's copy of
    its row's joints_cam, all-gathered over the row, so that callers can
    assert that the columns are bitwise equal (:135-190)."""
    forward = make_view_parallel_forward(model, mesh, compute_dtype, root_relative)

    def check(rgb, bboxes, intrinsic):
        joints_cam = forward(rgb, bboxes, intrinsic)["joints_cam"]
        return gather_views(mesh, joints_cam.unsqueeze(1))

    return check
