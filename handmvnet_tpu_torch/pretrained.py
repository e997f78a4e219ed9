"""ImageNet backbone graft (counterpart of handmvnet_tpu/pretrained.py).

  * ResNet: a torchvision ImageNet state_dict, loaded strictly: every
    parameter and running statistic of the backbone must be in the file.
    The "paper" variant drops ``layer4.*`` first; ``fc.*`` and
    ``classifier*`` always go.
  * HRNet: a partial load. Only keys the backbone has are taken (the
    hrnetv2 ImageNet files carry a classification head the pose model does
    not have); a file that matches none is refused.
  * Wiring: ``backbone_pretrained`` turns it on and
    ``backbone_pretrained_path`` names the weight file, or a directory that
    holds it under the conventional name.

The port's state_dict keys are the reference's torch keys, so the file's
keys are the backbone's own. Nothing is downloaded: with the graft on and
no path, the backbone keeps its random initialisation and a warning says so.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

_RESNET_FILE_CANDIDATES = (
    "resnet{v}_imagenet.pth",
    "resnet{v}.pth",
    "resnet{v}_imagenet.npz",
    "resnet{v}.npz",
)


def load_state_dict_file(path: str | Path) -> dict[str, torch.Tensor]:
    """A torch file (.pth/.pt, read with ``weights_only``) or an .npz as
    {key: tensor}; a nested ``state_dict`` entry is unwrapped."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    nested = obj.get("state_dict") if isinstance(obj, dict) else None
    if isinstance(nested, Mapping) and all(hasattr(v, "shape") for v in nested.values()):
        obj = nested
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def resolve_pretrained_path(cfg_model) -> Path:
    """``backbone_pretrained_path`` as a file, or the conventionally named
    file in that directory: ``hrnetv2_{type}_imagenet_pretrained.pth`` for
    HRNet, ``resnet{N}[_imagenet].{pth,npz}`` for ResNet."""
    raw = cfg_model.backbone_pretrained_path
    p = Path(raw)
    if p.is_file():
        return p
    if p.is_dir():
        if cfg_model.backbone == "hrnet":
            names = [f"hrnetv2_{cfg_model.backbone_type}_imagenet_pretrained.pth"]
        else:
            ver = "".join(c for c in cfg_model.backbone_type if c.isdigit())
            names = [pat.format(v=ver) for pat in _RESNET_FILE_CANDIDATES]
        for name in names:
            if (p / name).is_file():
                return p / name
    raise FileNotFoundError(f"no pretrained backbone weights found at {raw!r} for "
                            f"{cfg_model.backbone}/{cfg_model.backbone_type}")


def graft_backbone(backbone_module: nn.Module, state_dict: Mapping[str, torch.Tensor],
                   backbone: str, variant: str = "default") -> list[str]:
    """Copy ``state_dict``'s tensors into ``backbone_module`` in place and
    return the keys taken. ``backbone`` "resnet" is strict, "hrnet" partial;
    ``variant`` "paper" drops ``layer4.*``. A shape that differs raises.
    BatchNorm's ``num_batches_tracked`` is neither taken nor required."""
    sd = dict(state_dict)
    if backbone == "resnet":
        sd = {k: v for k, v in sd.items()
              if not (variant == "paper" and k.startswith("layer4"))
              and not k.startswith(("fc.", "classifier"))}
    own = {k: v for k, v in backbone_module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    taken = {}
    for key, value in own.items():
        if key in sd:
            src = torch.as_tensor(sd[key])
            if tuple(src.shape) != tuple(value.shape):
                raise ValueError(f"pretrained shape mismatch at {key}: model "
                                 f"{tuple(value.shape)} vs checkpoint {tuple(src.shape)}")
            taken[key] = src.to(value.dtype)
    if backbone == "resnet":
        missing = sorted(set(own) - set(taken))
        if missing:
            raise ValueError(f"the pretrained resnet load is strict but {len(missing)} "
                             f"backbone keys are not in the checkpoint, e.g. {missing[:6]}")
    elif not taken:
        raise ValueError("the pretrained hrnet checkpoint matched no backbone key")
    backbone_module.load_state_dict(taken, strict=False)
    return sorted(taken)


def load_pretrained_backbone(model: nn.Module, cfg) -> None:
    """Apply ``cfg.model.backbone_pretrained{,_path}`` to ``model.backbone``
    (call after building the model, before any resume)."""
    mcfg = cfg.model
    if not mcfg.backbone_pretrained:
        return
    if not mcfg.backbone_pretrained_path:
        print("[warning] backbone_pretrained=True but no backbone_pretrained_path set, and "
              "nothing is downloaded: training from a random backbone initialisation",
              flush=True)
        return
    path = resolve_pretrained_path(mcfg)
    variant = "paper" if "paper" in mcfg.backbone_type else "default"
    graft_backbone(model.backbone, load_state_dict_file(path), mcfg.backbone, variant)
    print(f"loaded pretrained {mcfg.backbone} backbone from {path}", flush=True)
