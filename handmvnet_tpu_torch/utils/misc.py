"""Small utilities (counterpart of handmvnet_tpu/utils/misc.py; the
reference's src/utils/misc.py:4-7, 50-56)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _tensors(params: nn.Module | Mapping[str, torch.Tensor]):
    return params.parameters() if isinstance(params, nn.Module) else params.values()


def param_count(params: nn.Module | Mapping[str, torch.Tensor]) -> float:
    """Parameters in millions, of a module's parameters or a dict of tensors
    (a state_dict)."""
    return sum(t.numel() for t in _tensors(params)) / 1e6


def param_size(params: nn.Module | Mapping[str, torch.Tensor]) -> float:
    """Size in MB at 4 bytes a parameter (the reference's convention,
    misc.py:54-56), whatever the tensors' dtype."""
    return sum(t.numel() for t in _tensors(params)) * 4 / (1024 * 1024)


def rotate_y(points: np.ndarray, angle: float) -> np.ndarray:
    """Rotate [N, 3] points about the Y axis by ``angle`` radians."""
    c, s = np.cos(angle), np.sin(angle)
    ry = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return points @ ry
