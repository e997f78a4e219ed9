"""The training step (counterpart of handmvnet_tpu/parallel/train_step.py),
on one device or on each rank of a process group.

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

With a process group each rank runs the step on its own batch, and after its
microbatches one all-reduce of one flat buffer averages over the ranks the
gradients, the loss terms and every BatchNorm running statistic: the three
``pmean``s of the JAX step (parallel/train_step.py:235-237). The clip then
sees the averaged gradients, as optax's does, and the ranks' parameters and
statistics stay bitwise equal. No DistributedDataParallel wrapper: the bf16
forward goes through ``functional_call``, never through its ``forward``, and
it would all-reduce at every microbatch's backward.

``train.remat`` (``resolve_remat``) checkpoints the backbone's blocks: "on"
and "off" force it, "auto" turns it on where a microbatch's images exceed
the remat-free anchor measured on the card for the backbone and dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.losses import handmvnet_loss
from handmvnet_tpu_torch.models.handmvnet import HandMvNet
from handmvnet_tpu_torch.parallel.mesh import all_reduce_mean_
from handmvnet_tpu_torch.utils.profiling import span


@dataclass
class TrainState:
    model: HandMvNet
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    step: int = 0  # optimizer steps taken


# The most images a microbatch of each (backbone, compute dtype) trains
# without remat: where the remat-free step's peak of allocated memory, fitted
# as fixed + bytes an image over 40, 80 and 160 images, reaches 0.85 of the
# card's 85.0e9 bytes (remat_probe.py on one H100 80GB HBM3 at 700 W; the fit
# in PERF.md). The JAX package's 80 images (halved for fp32) were a 16 GB
# v5e's and do not carry over.
REMAT_FREE_IMAGES = {
    ("resnet", "float32"): 407,  # 0.701 GB + 175.75 MB an image
    ("resnet", "bfloat16"): 774,  # 0.337 GB + 92.83 MB
    ("hrnet", "float32"): 296,  # 0.928 GB + 240.66 MB
    ("hrnet", "bfloat16"): 581,  # 0.841 GB + 122.86 MB
}


def resolve_remat(cfg: Config, accum_steps: int = 1, *, batch_size: int | None = None,
                  num_views: int | None = None) -> bool:
    """The train step's remat policy, ``train.remat``, as the JAX package's
    (handmvnet_tpu/parallel/train_step.py:155-188): "on"/"true" and
    "off"/"false" force it; "auto" turns it on where a microbatch's images
    (ceil(batch / accum_steps) x views) exceed ``REMAT_FREE_IMAGES`` of the
    backbone and compute dtype (0, so on, where none was measured); anything
    else raises ValueError. ``batch_size`` and ``num_views`` stand in for
    the config's where a caller's batches have other shapes. Each rank takes
    the config's whole batch (train.py), so the world size changes the
    microbatch only through ``accum_steps`` (train.accumulation), where the
    JAX package's one process splits the batch over its devices."""
    setting = str(cfg.train.remat).lower()
    if setting in ("on", "true"):
        return True
    if setting in ("off", "false"):
        return False
    if setting != "auto":
        raise ValueError(f"train.remat must be auto/on/off, got {cfg.train.remat!r}")
    batch = cfg.data.batch_size if batch_size is None else batch_size
    views = cfg.data.num_views if num_views is None else num_views
    images = -(-batch // max(1, accum_steps)) * views
    return images > REMAT_FREE_IMAGES.get((cfg.model.backbone, cfg.train.compute_dtype), 0)


def build_model(cfg: Config, device: str = "cuda", seed: int = 0,
                dropout: float = 0.1, accum_steps: int = 1) -> HandMvNet:
    """The config's model with PyTorch's default initialisation drawn under
    ``seed``, in fp32 on ``device``; with ``train.root_relative`` off it has
    the absolute-root branch; its backbone remats as ``resolve_remat``
    decides for microbatches of ``accum_steps``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = HandMvNet(cfg.model, image_size=cfg.data.image_size,
                          heatmap_size=cfg.data.heatmap_size, dropout=dropout,
                          root_relative=cfg.train.root_relative,
                          remat=resolve_remat(cfg, accum_steps))
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
    built = getattr(model, "root_relative", cfg.train.root_relative)
    if built != cfg.train.root_relative:
        raise ValueError(f"train.root_relative is {cfg.train.root_relative} but the model was "
                         f"built with root_relative={built}")
    if cfg.train.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.train.compute_dtype!r}: float32 or bfloat16")
    optimizer = make_optimizer(cfg, model)
    return TrainState(model, optimizer, make_lr_schedule(cfg, optimizer, steps_per_epoch))


def batch_to_device(batch: Mapping[str, np.ndarray], device: str | torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A numpy batch (data/synthetic.synthetic_batch's keys) as tensors on
    ``device``: float32, and the joint mask as bool."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def bf16_compute_params(model: nn.Module) -> Dict[str, torch.Tensor]:
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
        out = torch.func.functional_call(model, bf16_compute_params(model), args,
                                         {"generator": generator})
    else:
        out = model(*args, generator=generator)
    labels = dict(batch)
    labels["joints_cam"] = batch["joints_cam"] / 1000.0
    labels["root_joint"] = batch["root_joint"] / 1000.0
    losses = handmvnet_loss(
        out, labels, cfg.train.loss_weights,
        mask_invisible_joints=cfg.train.mask_invisible_joints,
        root_relative=cfg.train.root_relative,
        intrinsics=batch.get("intrinsic"), extrinsics=batch.get("extrinsic"),
        root_idx=cfg.root_idx, image_size=float(cfg.data.image_size),
    )
    return losses, out


def accumulate_grads(state: TrainState, cfg: Config, batch: Mapping[str, torch.Tensor],
                     generator: torch.Generator | None = None, accum_steps: int = 1,
                     group: dist.ProcessGroup | None = None) -> Dict[str, torch.Tensor]:
    """Forward and backward of ``accum_steps`` microbatches (the batch split
    along its first axis, in order), in train mode. Leaves the mean of their
    gradients in each parameter's ``.grad`` and returns the mean of their
    losses, detached, on the device. With ``group``, both means and the
    BatchNorm running statistics are then averaged over its ranks."""
    model = state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    b = batch["rgb"].shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} microbatches")
    mb = b // accum_steps
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum_steps):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        with span("forward"):
            losses, _ = forward_loss(model, cfg, micro, generator)
        with span("backward"):
            (losses["loss"] / accum_steps).backward()
        for k, v in losses.items():
            sums[k] = sums[k] + v.detach() if k in sums else v.detach()
    means = {k: v / accum_steps for k, v in sums.items()}
    return means if group is None else _average_over_ranks(model, means, group)


def _average_over_ranks(model: nn.Module, losses: Dict[str, torch.Tensor],
                        group: dist.ProcessGroup) -> Dict[str, torch.Tensor]:
    """Average the gradients (each ``.grad`` becomes a view of the reduced
    buffer), the BatchNorm running statistics (in place) and ``losses``
    (returned) over the group's ranks, in one all-reduce."""
    params = [p for p in model.parameters() if p.grad is not None]
    stats = [t for m in model.modules() if isinstance(m, nn.BatchNorm2d)
             for t in (m.running_mean, m.running_var)]
    keys = list(losses)
    parts = [p.grad for p in params] + [losses[k] for k in keys] + stats
    dtype = params[0].grad.dtype
    flat = all_reduce_mean_(torch.cat([t.reshape(-1).to(dtype) for t in parts]), group)
    chunks = iter(flat.split([t.numel() for t in parts]))
    for p in params:
        p.grad = next(chunks).view_as(p)
    averaged = {k: next(chunks).view_as(losses[k]).to(losses[k].dtype) for k in keys}
    with torch.no_grad():
        torch._foreach_copy_(stats, [next(chunks).view_as(t) for t in stats])
    return averaged


def optimizer_step(state: TrainState, cfg: Config) -> torch.Tensor:
    """Clip the gradients to ``grad_clip`` global norm, take the AdamW step,
    advance the LR schedule. Returns the norm before clipping (on the
    device)."""
    with span("clip"):
        norm = torch.nn.utils.clip_grad_norm_(state.model.parameters(), cfg.train.grad_clip)
    with span("adamw"):
        state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return norm


def train_step(state: TrainState, cfg: Config, batch: Mapping[str, torch.Tensor],
               generator: torch.Generator | None = None, accum_steps: int = 1,
               group: dist.ProcessGroup | None = None) -> Dict[str, torch.Tensor]:
    """One optimizer step over ``batch`` (this rank's, with ``group``);
    returns its losses (on the device; with ``group``, their mean over the
    ranks). Its span, ``train_step``, carries the optimizer steps taken
    before it as its step id, and its microbatches' ``forward`` (with the
    model's ``backbone``) and ``backward``, ``clip`` and ``adamw`` spans
    inherit it."""
    with span("train_step", state.step):
        losses = accumulate_grads(state, cfg, batch, generator, accum_steps, group)
        optimizer_step(state, cfg)
    return losses


def eval_step(model: HandMvNet, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The eval-mode forward (running statistics, no dropout) in fp32."""
    model.eval()
    with torch.inference_mode():
        return model(batch["rgb"], batch["bboxes"], batch["intrinsic"])
