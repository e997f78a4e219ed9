"""Weights into the port: a reference checkpoint by key, or the JAX package's
flax variables.

``load_torch_checkpoint`` loads a reference Lightning ``.ckpt``, a ``.pth``
state_dict, or the port's own ``CheckpointManager`` file, told apart by
their contents, after the reference's legacy key remaps (``LEGACY_REMAPS``,
the port's copy of handmvnet_tpu/checkpoint.py:28-32; reference
src/eval.py:15-52).

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
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(.+)_(\d+)$")
LEGACY_REMAPS = (
    (re.compile(r"^model\."), ""),
    (re.compile(r"^pose_net\.conv\."), "pose_net."),
    (re.compile(r"^sample_net\."), "sample_nets.0."),
)
# the keys of a file that engine.save_checkpoint writes
_PORT_CHECKPOINT_KEYS = {"model", "optimizer", "scheduler", "step"}


def remap_legacy_keys(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """The reference's keys as the port names them: without a Lightning
    ``model.`` prefix, ``pose_net.conv.*`` -> ``pose_net.*``, ``sample_net.*``
    -> ``sample_nets.0.*``. Raises if two keys map to one."""
    out: dict[str, Any] = {}
    for key, value in state_dict.items():
        new = key
        for pat, repl in LEGACY_REMAPS:
            new = pat.sub(repl, new)
        if new in out:
            raise ValueError(f"two checkpoint keys map to {new}")
        out[new] = value
    return out


def load_torch_checkpoint(path: str | Path, model: torch.nn.Module) -> str:
    """Load a checkpoint file into ``model`` by key and return its kind:
    "port" (a ``CheckpointManager`` file: model/optimizer/scheduler/step,
    loaded as is), "lightning" (a dict with a ``state_dict``) or
    "state_dict" (a bare state_dict, such as a ``.pth``); the last two after
    ``remap_legacy_keys``. The contents decide, not the suffix: the port's
    files are ``.pt`` too.

    Every key of the model must be there, except BatchNorm's
    ``num_batches_tracked`` (which eval does not read), and no other key may
    be: anything else raises, as does a shape that differs.

    The file is unpickled in full (``weights_only=False``), as the reference's
    eval.py and the JAX package's load it: a Lightning ``.ckpt`` also holds
    hyper-parameters and callback states, objects the restricted unpickler
    refuses. Load only checkpoints you trust.
    """
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(payload, Mapping):
        raise ValueError(f"{path}: not a checkpoint (a {type(payload).__name__})")
    if _PORT_CHECKPOINT_KEYS <= set(payload) and isinstance(payload["model"], Mapping):
        model.load_state_dict(payload["model"])
        return "port"
    kind = "lightning" if isinstance(payload.get("state_dict"), Mapping) else "state_dict"
    state = remap_legacy_keys(payload["state_dict"] if kind == "lightning" else payload)
    expected = set(model.state_dict())
    missing = sorted(k for k in expected - set(state) if not k.endswith(".num_batches_tracked"))
    unexpected = sorted(set(state) - expected)
    if missing or unexpected:
        raise ValueError(f"{path}: checkpoint keys do not match the model: "
                         f"missing {missing[:8]} ({len(missing)}), "
                         f"unexpected {unexpected[:8]} ({len(unexpected)})")
    model.load_state_dict(state, strict=False)
    return kind


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
