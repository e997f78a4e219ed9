"""Faults planted in the program, to show that the comparison catches them
(``tests/test_hmvbench_faults.py`` on the CPU; ``calibrate.py`` reads the
half batch on the card to set the training cells' upper readings). Never
used by a benchmark run.

  unchanged   the optimizer step returns the state as it was
  half_batch  each microbatch's loss is taken over its first half of rows
  altered     an answer changed where it is produced: serving's joints_cam
              moved by 1 mm, training's loss terms scaled by 1.01
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

FAULTS = ("unchanged", "half_batch", "altered")


@contextmanager
def planted(name: str):
    from handmvnet_tpu_torch import train_step as ts
    from handmvnet_tpu_torch.models.handmvnet import HandMvNet
    saved = {"optimizer_step": ts.optimizer_step, "forward_loss": ts.forward_loss,
             "train_step": ts.train_step}
    forward = HandMvNet.forward
    if name == "unchanged":
        def optimizer_step(state, cfg):
            state.step += 1
            return torch.zeros(())
        ts.optimizer_step = optimizer_step
    elif name == "half_batch":
        def forward_loss(model, cfg, batch, generator=None):
            half = batch["rgb"].shape[0] // 2
            return saved["forward_loss"](model, cfg, {k: v[:half] for k, v in batch.items()},
                                         generator)
        ts.forward_loss = forward_loss
    elif name == "altered":
        def train_step(*args, **kwargs):
            return {k: v * 1.01 for k, v in saved["train_step"](*args, **kwargs).items()}

        def moved(self, *args, **kwargs):
            out = forward(self, *args, **kwargs)
            if isinstance(out, dict) and "joints_cam" in out:
                out["joints_cam"] = out["joints_cam"] + 1e-3
            return out
        ts.train_step = train_step
        HandMvNet.forward = moved
    else:
        raise ValueError(f"fault {name!r}: one of {FAULTS}")
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(ts, attr, fn)
        HandMvNet.forward = forward
