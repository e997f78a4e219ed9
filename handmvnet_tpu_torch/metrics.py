"""Pose metrics: MPJPE, PA-MPJPE (Procrustes), PCK and PCK-AUC (counterpart
of handmvnet_tpu/metrics.py). Each returns a tensor on its inputs' device;
nothing is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from handmvnet_tpu_torch.ops.procrustes import similarity_align


def _dist(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(preds - labels, dim=-1)


def mpjpe(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean Euclidean distance over the last-but-one axis points."""
    return _dist(preds, labels).mean()


def weighted_mpjpe(preds: torch.Tensor, labels: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (w * _dist(preds, labels)).mean()


def pa_mpjpe(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MPJPE after optimal similarity (Procrustes) alignment per sample."""
    return mpjpe(similarity_align(preds, labels), labels)


def n_mpjpe(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Scale-normalized MPJPE; expects [B, S, N, 3]-style inputs (dims 2/3
    reductions)."""
    norm_pred = (preds ** 2).sum(dim=3, keepdim=True).mean(dim=2, keepdim=True)
    norm_tgt = (labels * preds).sum(dim=3, keepdim=True).mean(dim=2, keepdim=True)
    return mpjpe(norm_tgt / norm_pred * preds, labels)


def mka(preds: torch.Tensor) -> torch.Tensor:
    """Mean keypoint acceleration over a temporal sequence [B, T, J, 3]
    (tracking-jitter metric)."""
    acc = preds[:, :-2] + preds[:, 2:] - 2.0 * preds[:, 1:-1]
    return torch.linalg.vector_norm(acc, dim=-1).mean(dim=-1).mean(dim=-1)


def pck(preds: torch.Tensor, labels: torch.Tensor, threshold,
        reference_len: torch.Tensor | None = None) -> torch.Tensor:
    """Share of points within ``threshold`` (a number, or a tensor on the
    inputs' device), scaled per sample by ``reference_len`` [B] if given."""
    dist = _dist(preds, labels)  # [B, N]
    thr = threshold if reference_len is None else threshold * reference_len[:, None]
    return (dist <= thr).to(torch.float32).mean()


class PckAuc(NamedTuple):
    auc: torch.Tensor
    norm_auc: torch.Tensor
    pck_values: torch.Tensor  # [steps]
    thresholds: torch.Tensor  # [steps]


def pck_auc(preds: torch.Tensor, labels: torch.Tensor, min_threshold: float = 0.0,
            max_threshold: float = 0.02, steps: int = 20,
            reference_len: torch.Tensor | None = None) -> PckAuc:
    """Trapezoid-rule area under the PCK curve over ``steps`` thresholds."""
    thresholds = torch.linspace(min_threshold, max_threshold, steps, device=preds.device)
    dist = _dist(preds, labels)  # [B, N]
    if reference_len is not None:
        dist = dist / reference_len[:, None]
    values = (dist[None] <= thresholds[:, None, None]).to(torch.float32).mean(dim=(1, 2))
    auc = torch.trapezoid(values, thresholds)
    perfect = torch.trapezoid(torch.ones_like(values), thresholds)
    return PckAuc(auc=auc, norm_auc=auc / perfect, pck_values=values, thresholds=thresholds)
