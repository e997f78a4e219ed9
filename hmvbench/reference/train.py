"""The frozen reference of the training step, plain PyTorch, float32: the
HandMvNet loss (heatmap MSE, masked 2D L1, 3D L1, and the g2d / p2d
reprojection L1s through the cameras), gradient accumulation over
microbatches, global-norm clipping and AdamW, one tensor at a time.
"""

from __future__ import annotations

import math

import torch


def reproject(joints_m: torch.Tensor, intr: torch.Tensor, extr: torch.Tensor,
              root_idx: int = 0) -> torch.Tensor:
    """Absolute joints [B, N, 3] in metres in the root view's frame -> pixels
    [B, V, N, 2] in every view (extrinsics camera -> world, metres; the
    projection in mm with 1e-6 added to z)."""
    rot, t = extr[..., :3, :3], extr[..., :3, 3]
    world = joints_m @ rot[:, root_idx].transpose(-1, -2) + t[:, root_idx, None]  # [B, N, 3]
    cam = torch.einsum("bvji,bvnj->bvni", rot, world[:, None] - t[:, :, None]) * 1000.0
    z = cam[..., 2] + 1e-6
    u = cam[..., 0] * intr[..., 0:1] / z + intr[..., 2:3]
    v = cam[..., 1] * intr[..., 1:2] / z + intr[..., 3:4]
    return torch.stack([u, v], dim=-1)


def loss_terms(out: dict, batch: dict, train: dict, image_size: float) -> dict:
    """Each weighted term and their sum ``loss``; 3D labels in mm."""
    w = train["loss_weights"]
    terms = {"heatmap_loss": torch.mean((out["heatmap"] - batch["heatmap"]) ** 2) * w["heatmap"]}
    pred2d, gt2d = out["joints_crop_img"], batch["joints_crop_img"]
    if train["mask_invisible_joints"]:
        keep = (~batch["joints_img_mask"]).float()[..., None]
        pred2d, gt2d = pred2d * keep, gt2d * keep
    terms["joints_2d_loss"] = torch.mean(torch.abs(pred2d - gt2d)) * w["joints_2d"]
    root = batch["root_joint"] / 1000.0
    terms["joints_3d_loss"] = torch.mean(
        torch.abs(out["joints_cam"] - batch["joints_cam"] / 1000.0)) * w["joints_3d"]
    proj = reproject(out["joints_cam"] + root, batch["intrinsic"], batch["extrinsic"])
    box = batch["bboxes"][..., None, :]
    crop = (proj - box[..., :2]) * (image_size / (box[..., 2:] - box[..., :2]))
    terms["g2d_loss"] = torch.mean(torch.abs(crop - batch["joints_crop_img"])) * w["g2d"]
    terms["p2d_loss"] = torch.mean(torch.abs(crop - out["joints_crop_img"])) * w["p2d"]
    terms["loss"] = sum(terms.values())
    return terms


class AdamW:
    """torch's AdamW, written out: decoupled decay lr * wd, bias-corrected
    moments, eps added to the corrected root."""

    def __init__(self, params, lr: float, weight_decay: float, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.wd, self.betas, self.eps, self.t = lr, weight_decay, betas, eps, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = v.sqrt() / math.sqrt(1.0 - b2 ** self.t) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / (1.0 - b1 ** self.t))


@torch.no_grad()
def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients so that their global norm is at most ``max_norm``
    (the factor max_norm / (norm + 1e-6), capped at 1); return the norm."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return norm


def train_step(model, opt: AdamW, batch: dict, train: dict, image_size: float,
               accumulate: int, generator: torch.Generator) -> dict:
    """One optimizer step: ``accumulate`` microbatches in order, each loss
    divided by their count before its backward, then clip and AdamW. Returns
    the mean of the microbatches' terms."""
    model.train()
    for p in opt.params:
        p.grad = None
    mb = batch["rgb"].shape[0] // accumulate
    sums: dict = {}
    for i in range(accumulate):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        out = model(micro["rgb"], micro["bboxes"], micro["intrinsic"], generator)
        terms = loss_terms(out, micro, train, image_size)
        (terms["loss"] / accumulate).backward()
        for k, v in terms.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    clip_grad_norm(opt.params, train["grad_clip"])
    opt.step()
    return {k: v / accumulate for k, v in sums.items()}
