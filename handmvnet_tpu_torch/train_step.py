"""The training step on one device (counterpart of
handmvnet_tpu/parallel/train_step.py without ``shard_map`` and ``pmean``).

The optimizer is the reference's: global-norm gradient clipping at
``grad_clip``, then AdamW(lr, betas (0.9, 0.999), eps 1e-8, weight decay on
every parameter), with MultiStepLR decays at ``milestone * steps_per_epoch``
optimizer steps. An optimizer step averages the gradients of
``accum_steps`` microbatches, run one after another: each updates the
BatchNorm running statistics in turn and draws fresh dropout masks from the
one generator it is given. Losses stay on the device.

With ``compute_dtype: bfloat16`` the forward and backward run on a bf16 copy
of the parameters, cast inside the graph so the gradients land in fp32 on the
fp32 master parameters; the rgb input is cast too. The JAX package casts
every parameter; flax's batch norm then computes in fp32 with the
bf16-rounded scale and shift. PyTorch's batch norm takes bf16 activations
with fp32 affine parameters and fp32 running statistics, but not bf16 affine
parameters with fp32 statistics, so the copy rounds the BatchNorm scale and
shift through bf16 and keeps them fp32: the same values in the same
precision. Running statistics and losses stay fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.losses import handmvnet_loss
from handmvnet_tpu_torch.models.handmvnet import HandMvNet


@dataclass
class TrainState:
    model: HandMvNet
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    step: int = 0  # optimizer steps taken


def build_model(cfg: Config, device: str = "cuda", seed: int = 0,
                dropout: float = 0.1) -> HandMvNet:
    """The config's model with PyTorch's default initialisation drawn under
    ``seed``, in fp32 on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = HandMvNet(cfg.model, image_size=cfg.data.image_size,
                          heatmap_size=cfg.data.heatmap_size, dropout=dropout)
    return model.to(device)


def make_lr_schedule(cfg: Config, optimizer: torch.optim.Optimizer,
                     steps_per_epoch: int) -> torch.optim.lr_scheduler.MultiStepLR:
    """MultiStepLR in optimizer steps: lr *= gamma at each milestone epoch's
    first step. Step it once after every optimizer step."""
    sched = cfg.train.lr_scheduler
    milestones = [int(m) * steps_per_epoch for m in sched.milestones]
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones, gamma=sched.gamma)


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=cfg.train.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.train.weight_decay)


def create_train_state(model: HandMvNet, cfg: Config, steps_per_epoch: int) -> TrainState:
    if not cfg.train.root_relative:
        raise ValueError("the port has the root-relative model only (train.root_relative)")
    if cfg.train.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.train.compute_dtype!r}: float32 or bfloat16")
    optimizer = make_optimizer(cfg, model)
    return TrainState(model, optimizer, make_lr_schedule(cfg, optimizer, steps_per_epoch))


def batch_to_device(batch: Mapping[str, np.ndarray], device: str | torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A numpy batch (data/synthetic.synthetic_batch's keys) as tensors on
    ``device``: float32, and the joint mask as bool."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _bf16_compute_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: parameter cast to bf16}; the BatchNorm affine ones rounded to
    bf16 and kept fp32, all of them in one flat tensor (three launches, not
    two for each of the hundreds of BatchNorm parameters)."""
    bn_affine = {id(p) for m in model.modules() if isinstance(m, nn.BatchNorm2d)
                 for p in m.parameters()}
    named = dict(model.named_parameters())
    bn_names = [n for n, p in named.items() if id(p) in bn_affine]  # 1-D: scale, shift
    flat = torch.cat([named[n] for n in bn_names]).to(torch.bfloat16).float()
    rounded = dict(zip(bn_names, flat.split([named[n].numel() for n in bn_names])))
    return {n: rounded[n] if n in rounded else p.to(torch.bfloat16) for n, p in named.items()}


def forward_loss(model: HandMvNet, cfg: Config, batch: Mapping[str, torch.Tensor],
                 generator: torch.Generator | None = None
                 ) -> tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(losses, model outputs) of one batch in the model's current mode; the
    3D labels go from mm to metres for the loss."""
    args = (batch["rgb"], batch["bboxes"], batch["intrinsic"])
    if cfg.train.compute_dtype == "bfloat16":
        args = (args[0].to(torch.bfloat16),) + args[1:]
        out = torch.func.functional_call(model, _bf16_compute_params(model), args,
                                         {"generator": generator})
    else:
        out = model(*args, generator=generator)
    labels = dict(batch)
    labels["joints_cam"] = batch["joints_cam"] / 1000.0
    labels["root_joint"] = batch["root_joint"] / 1000.0
    losses = handmvnet_loss(
        out, labels, cfg.train.loss_weights,
        mask_invisible_joints=cfg.train.mask_invisible_joints,
        intrinsics=batch.get("intrinsic"), extrinsics=batch.get("extrinsic"),
        root_idx=cfg.root_idx, image_size=float(cfg.data.image_size),
    )
    return losses, out


def accumulate_grads(state: TrainState, cfg: Config, batch: Mapping[str, torch.Tensor],
                     generator: torch.Generator | None = None,
                     accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """Forward and backward of ``accum_steps`` microbatches (the batch split
    along its first axis, in order), in train mode. Leaves the mean of their
    gradients in each parameter's ``.grad`` and returns the mean of their
    losses, detached, on the device."""
    model = state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    b = batch["rgb"].shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} microbatches")
    mb = b // accum_steps
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum_steps):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        losses, _ = forward_loss(model, cfg, micro, generator)
        (losses["loss"] / accum_steps).backward()
        for k, v in losses.items():
            sums[k] = sums[k] + v.detach() if k in sums else v.detach()
    return {k: v / accum_steps for k, v in sums.items()}


def optimizer_step(state: TrainState, cfg: Config) -> torch.Tensor:
    """Clip the gradients to ``grad_clip`` global norm, take the AdamW step,
    advance the LR schedule. Returns the norm before clipping (on the
    device)."""
    norm = torch.nn.utils.clip_grad_norm_(state.model.parameters(), cfg.train.grad_clip)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return norm


def train_step(state: TrainState, cfg: Config, batch: Mapping[str, torch.Tensor],
               generator: torch.Generator | None = None,
               accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """One optimizer step over ``batch``; returns its losses (on the device)."""
    losses = accumulate_grads(state, cfg, batch, generator, accum_steps)
    optimizer_step(state, cfg)
    return losses


def eval_step(model: HandMvNet, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The eval-mode forward (running statistics, no dropout) in fp32."""
    model.eval()
    with torch.inference_mode():
        return model(batch["rgb"], batch["bboxes"], batch["intrinsic"])
