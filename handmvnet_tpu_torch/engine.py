"""Training and evaluation engine (counterpart of handmvnet_tpu/engine.py):
the reference's per-batch metrics as one device computation, the labels in
meters, the MANO vertex map, a metric averager that keeps its sums on the
device, the JSONL logger with its TensorBoard scalars, the
best-on-val_mpjpe + last checkpoint manager and the evaluation pass.

Over the ranks of a process group (parallel/) every rank evaluates its own
batches and all of them get the metrics of the union of the ranks' batches,
which is what the JAX package computes on its global batch (engine.py:303-313
over sharded arrays): each metric is a mean over samples of a per-sample
term (invisible joints are zeroed, not dropped), so the ranks' sample-weighted
sums and sample counts, added up, give the union's means. Files are written
by rank 0 alone.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from handmvnet_tpu_torch import metrics as M
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.ops.geometry import mask_joints
from handmvnet_tpu_torch.parallel.mesh import barrier, is_main
from handmvnet_tpu_torch.train_step import eval_step


def pose_metrics_device(
    out: Mapping[str, torch.Tensor],
    labels: Mapping[str, torch.Tensor],
    auc_thresholds: tuple[float, float],
    mask_invisible: bool = True,
    root_relative: bool = True,
    vertices_fn: Callable | None = None,
) -> Dict[str, torch.Tensor]:
    """The mpjpe family in mm, AUC/PCK aggregates and, with ``vertices_fn``
    and ``labels["vertices"]``, the vertex metrics. Model outputs and labels
    are tensors on one device (labels in meters), and so is every result."""
    lo, hi = auc_thresholds
    pred2d, gt2d = out["joints_crop_img"], labels["joints_crop_img"]
    if "joints_img_mask" in labels and mask_invisible:
        m = labels["joints_img_mask"]
        pred2d = mask_joints(pred2d, m)
        gt2d = mask_joints(gt2d, m)

    pj = out["joints_cam"]
    gj = labels["joints_cam"]
    auc = M.pck_auc(pj, gj, lo, hi, steps=20)
    result: Dict[str, torch.Tensor] = {
        "mpjpe2d": M.mpjpe(pred2d, gt2d),
        "mpjpe": M.mpjpe(pj, gj) * 1000.0,
        "pa_mpjpe": M.pa_mpjpe(pj, gj) * 1000.0,
        "auc_j": auc.auc,
        "norm_auc_j": auc.norm_auc,
        "pck_j": auc.pck_values,
    }

    if vertices_fn is not None and "vertices" in labels:
        pred_verts = vertices_fn(out["joints_cam"] * 1000.0) / 1000.0  # meters
        gt_verts = labels["vertices"]
        auc_v = M.pck_auc(pred_verts, gt_verts, lo, hi, steps=20)
        result.update(
            mpvpe=M.mpjpe(pred_verts, gt_verts) * 1000.0,
            pa_mpvpe=M.pa_mpjpe(pred_verts, gt_verts) * 1000.0,
            auc_v=auc_v.auc,
            norm_auc_v=auc_v.norm_auc,
            pck_v=auc_v.pck_values,
        )

    if not root_relative and "root_joint" in out:
        result["w_mpjpe"] = (
            M.mpjpe(out["joints_cam"] + out["root_joint"], gj + labels["root_joint"]) * 1000.0
        )
    return result


def labels_in_meters(batch: Mapping[str, np.ndarray], device: str = "cuda",
                     dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The batch with joints_cam, root_joint and (if present) vertices, all
    in mm, as ``dtype`` tensors in meters on ``device``; other entries as
    they were."""
    labels = dict(batch)
    keys = ("joints_cam", "root_joint") + (("vertices",) if "vertices" in batch else ())
    for key in keys:
        labels[key] = torch.as_tensor(batch[key], dtype=dtype, device=device) / 1000.0
    return labels


def make_vertices_fn(cfg: Config, device: str = "cuda") -> Callable | None:
    """The joints -> MANO vertices map for the vertex metrics, on ``device``.
    None when the licensed MANO pkl is absent (with a warning), so the
    caller still runs."""
    try:
        from handmvnet_tpu_torch.models.joints_to_vertices import joints_to_vertices_fn
        from handmvnet_tpu_torch.models.mano import ManoLayer, load_mano_model

        mano = ManoLayer(load_mano_model(cfg.data.mano_models_dir)).to(device)
        return joints_to_vertices_fn(mano)
    except (FileNotFoundError, OSError) as e:
        print(f"[warning] MANO model unavailable ({e}); skipping vertex metrics")
        return None


class DeviceMetricAverager:
    """Weighted running mean of metrics whose sums stay on the device: no
    host read per update, one in ``result()``. Values are tensors (scalars
    or vectors such as PCK curves, averaged elementwise). With ``group``,
    ``result()`` adds up the sums and counts of every rank (each must have
    updated the same keys), so that every rank gets the same means."""

    def __init__(self, group: dist.ProcessGroup | None = None) -> None:
        self._sums: Dict[str, torch.Tensor] = {}
        self._count = 0.0
        self.group = group

    def update(self, metrics: Mapping[str, torch.Tensor], weight: float = 1.0) -> None:
        """weight: the batch's sample count, so that uneven batches do not
        bias the mean."""
        self._count += weight
        for k, v in metrics.items():
            v = v.detach().double() * weight
            self._sums[k] = self._sums[k] + v if k in self._sums else v

    def result(self) -> Dict[str, Any]:
        if not self._sums:
            return {}
        flat = torch.cat([v.reshape(-1) for v in self._sums.values()])
        if self.group is not None:
            flat = torch.cat([flat, flat.new_tensor([self._count])])
            dist.all_reduce(flat, group=self.group)
        flat = flat.cpu().numpy()
        count = flat[-1] if self.group is not None else self._count
        out, i = {}, 0
        for k, v in self._sums.items():
            avg = flat[i:i + v.numel()].reshape(v.shape) / count
            i += v.numel()
            out[k] = avg.tolist() if avg.ndim else float(avg)
        return out


class JsonlLogger:
    """Append-only metrics log, one JSON object per line, echoed to stdout
    with ``echo`` (list values, such as PCK curves, only into the file); with
    ``tensorboard_dir``, each record's numbers but the epoch also as
    TensorBoard scalars at step ``epoch`` (the reference logs through
    Lightning to TensorBoard), flushed after each record. Without the
    tensorboard package it warns once and logs the file alone, as the JAX
    logger does (handmvnet_tpu/engine.py:154-190)."""

    def __init__(self, path: str | Path, echo: bool = True,
                 tensorboard_dir: str | Path | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.echo = echo
        self._tb = None
        if tensorboard_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[warning] tensorboard unavailable: {e}", flush=True)
            else:
                self._tb = SummaryWriter(str(tensorboard_dir))

    def log(self, record: Mapping[str, Any]) -> None:
        rec = {k: v for k, v in record.items() if not isinstance(v, (list, tuple))}
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, default=float) + "\n")
        if self._tb is not None:
            step = int(record.get("epoch", record.get("step", 0)))
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k not in ("epoch", "step"):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()
        if self.echo:
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in rec.items()), flush=True)

    def close(self) -> None:
        """Close the TensorBoard writer (the JSONL file is closed after
        each record)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def save_checkpoint(path: str | Path, state) -> None:
    """model, optimizer and scheduler state_dicts and the step, in one file
    written atomically."""
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(), "step": state.step}, tmp)
    tmp.replace(path)


def restore_checkpoint(path: str | Path, state):
    """Load a ``save_checkpoint`` file into ``state`` (its tensors onto the
    model's device) and return it."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    return state


class CheckpointManager:
    """``last.pt`` after every epoch, and the best on val_mpjpe under the
    reference's name ``epoch={epoch}-step={step}-val_mpjpe={val:.3f}.pt``
    (only the best is kept). ``best.json`` records it, so that a resumed run
    does not demote the best of the run before.

    With ``group`` every rank calls each method, with the same values (the
    ranks' states and metrics are equal): rank 0 writes, and a barrier
    after each save lets every rank read what it wrote."""

    def __init__(self, out_dir: str | Path, group: dist.ProcessGroup | None = None):
        self.out_dir = Path(out_dir)
        self.group = group
        self.writes = is_main(group)
        if self.writes:
            self.out_dir.mkdir(parents=True, exist_ok=True)
        self.best_val = float("inf")
        self.best_path: Path | None = None
        self._meta_path = self.out_dir / "best.json"
        if self._meta_path.exists():
            meta = json.loads(self._meta_path.read_text())
            if Path(meta["best_path"]).exists():
                self.best_val = float(meta["best_val"])
                self.best_path = Path(meta["best_path"])

    @property
    def last_path(self) -> Path:
        return self.out_dir / "last.pt"

    def save_last(self, state) -> None:
        if self.writes:
            save_checkpoint(self.last_path, state)
        barrier(self.group)

    def save(self, state, epoch: int, val_mpjpe: float) -> None:
        if val_mpjpe < self.best_val:
            prev = self.best_path
            self.best_val = val_mpjpe
            self.best_path = self.out_dir / (
                f"epoch={epoch}-step={state.step}-val_mpjpe={val_mpjpe:.3f}.pt")
            if self.writes:
                save_checkpoint(self.best_path, state)
                self._meta_path.write_text(json.dumps(
                    {"best_val": self.best_val, "best_path": str(self.best_path)}))
                if prev is not None and prev != self.best_path:
                    prev.unlink(missing_ok=True)
        self.save_last(state)

    def restore_best(self, state):
        """``state`` loaded from the best checkpoint (``last.pt`` if none)."""
        return restore_checkpoint(self.best_path or self.last_path, state)


EVAL_LABELS = ("joints_crop_img", "joints_cam", "root_joint", "vertices", "joints_img_mask")


def evaluate(model, batches: Iterable[Mapping[str, torch.Tensor]], cfg: Config,
             mode: str = "val", vertices_fn: Callable | None = None,
             group: dist.ProcessGroup | None = None) -> Dict[str, Any]:
    """One evaluation pass: the eval-mode forward and ``pose_metrics_device``
    per batch (labels in mm, as the batch holds them), averaged over the
    samples with one host read at the end; with ``group``, over the samples
    of every rank's batches (each rank passes as many batches). Keys are
    prefixed ``{mode}_``."""
    avg = DeviceMetricAverager(group)
    for batch in batches:
        out = eval_step(model, batch)
        labels = labels_in_meters({k: batch[k] for k in EVAL_LABELS if k in batch},
                                  out["joints_cam"].device, out["joints_cam"].dtype)
        metrics = pose_metrics_device(out, labels, cfg.auc_thresholds,
                                      root_relative=cfg.train.root_relative,
                                      vertices_fn=vertices_fn)
        avg.update(metrics, weight=float(batch["rgb"].shape[0]))
    return {f"{mode}_{k}": v for k, v in avg.result().items()}


def write_results_json(path: str | Path, results: Mapping[str, Any]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump([dict(results)], f, indent=2, default=float)
