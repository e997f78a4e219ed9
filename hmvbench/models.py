"""What both traffic kinds build: the program's configuration and model,
the frozen reference's model, and the weights they share, all from a
configuration file of ``configs/``.

The program is ``handmvnet_tpu_torch``, imported here and in the traffic
kinds only; the reference (``hmvbench/reference/``) imports nothing of it.
"""

from __future__ import annotations

import torch

from hmvbench import inputs
from hmvbench.reference.model import HandMvNet as ReferenceModel


def set_precision(precision: str, tf32: bool = False) -> None:
    """fp32 cells run in full fp32: TF32 off for matmuls and cuDNN's convs
    (``tf32`` turns it on, for the control)."""
    if precision != "float32":
        raise ValueError(f"precision {precision!r}: the cells so far are float32")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def program_config(config: dict, views: int, batch: int):
    """The program's ``Config`` of a configuration file, at ``views`` views a
    sample and ``batch`` samples a step."""
    from handmvnet_tpu_torch.config import Config
    raw = {k: config[k] for k in ("model", "data", "train")}
    raw["model"] = dict(raw["model"], selected_views=list(range(views)))
    raw["data"] = dict(raw["data"], batch_size=batch)
    return Config.from_dict(raw)


def reference_model(config: dict, views: int, device) -> ReferenceModel:
    data = config["data"]
    with torch.device(device):
        model = ReferenceModel(config["model"], views, data["image_size"], data["heatmap_size"],
                               dropout=config["dropout"])
    return model.to(device)


def weights(config: dict, views: int, seed: int, device) -> dict[str, torch.Tensor]:
    """The state_dict both sides load, made from ``seed`` on ``device``."""
    with torch.device("meta"):
        shapes = ReferenceModel(config["model"], views, dropout=config["dropout"])
    return inputs.make_weights(shapes, seed, device, config["init"])


def program_model(cfg, config: dict, state: dict, device):
    """The program's HandMvNet of ``cfg`` with ``state`` loaded, on ``device``
    (its backbone remats as the program's own rule decides for the step's
    microbatches)."""
    from handmvnet_tpu_torch.models.handmvnet import HandMvNet
    from handmvnet_tpu_torch.train_step import resolve_remat
    with torch.device(device):
        model = HandMvNet(cfg.model, image_size=cfg.data.image_size,
                          heatmap_size=cfg.data.heatmap_size, dropout=config["dropout"],
                          remat=resolve_remat(cfg, cfg.train.accumulate_batch))
    model = model.to(device)
    model.load_state_dict(state)
    return model


def mano_layer(mano: dict, device):
    """The program's MANO layer over the benchmark's MANO arrays."""
    import numpy as np
    from handmvnet_tpu_torch.models.mano import ManoLayer, ManoModel
    n = mano["v_template"].shape[0]
    faces = np.stack([np.arange(n - 2), np.arange(1, n - 1), np.arange(2, n)], 1).astype(np.int32)
    return ManoLayer(ManoModel(faces=faces, hands_mean=np.zeros(45, np.float32), **mano)).to(device)
