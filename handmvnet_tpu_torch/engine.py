"""Evaluation metric assembly (counterpart of the evaluation part of
handmvnet_tpu/engine.py): the reference's per-batch metrics as one device
computation, the labels in meters, and the MANO vertex map. The epoch loop,
the averagers, the loggers and the checkpoint manager are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from handmvnet_tpu_torch import metrics as M
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.ops.geometry import mask_joints


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


def labels_in_meters(batch: Mapping[str, np.ndarray], device: str = "cuda") -> Dict[str, Any]:
    """The batch with joints_cam, root_joint and (if present) vertices, all
    in mm, as float32 tensors in meters on ``device``; other entries as they
    were."""
    labels = dict(batch)
    keys = ("joints_cam", "root_joint") + (("vertices",) if "vertices" in batch else ())
    for key in keys:
        labels[key] = torch.as_tensor(batch[key], dtype=torch.float32, device=device) / 1000.0
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
