"""Weights from the JAX package's flax variables into the port.

``load_flax_variables`` is the inverse of the torch -> flax table of
handmvnet_tpu/checkpoint.py:

  flax                                   port (torch)
  conv kernel    [kh, kw, I, O]   ->  weight [O, I, kh, kw]
  Dense kernel   [I, O]           ->  weight [O, I]
  BN/LN scale    [C]              ->  weight [C]
  batch_stats mean / var          ->  running_mean / running_var
  ChebConv weight [K+1, 1, I, O]  ->  weight (unchanged)
  bias                            ->  bias (unchanged)

and module names lose every trailing ``_N`` to ``.N`` (``layer1_0`` ->
``layer1.0``, ``fuse_layers_2_0_1_0`` -> ``fuse_layers.2.0.1.0``), the
inverse of the JAX converter's merge of every numeric segment. The port's
state_dict keys are the reference's torch keys.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(.+)_(\d+)$")


def _torch_path(path: tuple[str, ...]) -> str:
    segs = []
    for seg in path:
        indices = []
        while m := _INDEXED.match(seg):
            seg, index = m.groups()
            indices.insert(0, index)
        segs.extend([seg, *indices])
    return ".".join(segs)


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert_param(leaf: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        if v.ndim == 4:
            return "weight", np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
        if v.ndim == 2:
            return "weight", np.transpose(v, (1, 0))  # [in, out] -> [out, in]
        raise ValueError(f"kernel of rank {v.ndim}")
    if leaf == "scale":
        return "weight", v
    if leaf in ("bias", "weight"):  # ChebConv weight keeps its layout
        return leaf, v
    raise ValueError(f"unknown flax parameter {leaf!r}")


def load_flax_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} nested numpy dicts -> a state_dict
    for the port's module of the same tree. Every leaf gives exactly one key;
    each BatchNorm also gets a zero ``num_batches_tracked``, which torch keeps
    and flax has no counterpart of."""
    state: dict[str, torch.Tensor] = {}

    def put(key: str, value: np.ndarray) -> None:
        if key in state:
            raise ValueError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value))

    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown variable collections {sorted(unknown)}")
    for path, value in _leaves(variables.get("params", {})):
        leaf, arr = _convert_param(path[-1], np.asarray(value))
        put(f"{_torch_path(path[:-1])}.{leaf}", arr)
    for path, value in _leaves(variables.get("batch_stats", {})):
        names = {"mean": "running_mean", "var": "running_var"}
        if path[-1] not in names:
            raise ValueError(f"unknown batch statistic {path[-1]!r}")
        module = _torch_path(path[:-1])
        put(f"{module}.{names[path[-1]]}", np.asarray(value))
        if path[-1] == "mean":
            put(f"{module}.num_batches_tracked", np.zeros((), np.int64))
    return state
