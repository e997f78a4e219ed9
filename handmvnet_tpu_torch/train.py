"""Training driver:
``python -m handmvnet_tpu_torch.train --config configs/release/HO3D_HandMvNet.yaml``
``[--epochs N] [--steps-per-epoch N] [--output-dir DIR] [--resume] [--eval-first]``
``[--device cuda]``

The counterpart of handmvnet_tpu/train.py on one device: seed 42 (the
config's), the reference's gradient accumulation (the config's
``accumulate_batch``, else 2 when the batch is under 64), AdamW with
gradient clipping and MultiStepLR sized from the dataset's full epoch,
checkpoints of the best val_mpjpe and of the last epoch (``--resume``
continues from ``last``), a checkpoint of ``last`` on SIGTERM, one JSONL
record per epoch with the LR its steps used, and after training a validation
of the best checkpoint written to ``val.json``. fp32 is full fp32 (TF32 off);
``compute_dtype: bfloat16`` trains in bf16 on fp32 master weights.

Data: the config's tar shards (``build_dataloaders``), as the JAX trainer
reads them. The train split is the resampled, reservoir-shuffled stream,
decoded, cropped and augmented on the device (the generator of the n-th
batch a loader prepares is seeded 42 + n, JAX's PRNGKey(seed + counter)),
with the preparation of batch N+1 on the loader's preparer thread while
step N runs; validation reads the val split without augmentation. An epoch
has the train split's size // batch steps, which also size the LR
milestones; ``--steps-per-epoch`` cuts the training loop only (smoke runs).
Dropout of optimizer step s draws from seed * 1000003 + s. ``--resume``
restores the model, optimizer, scheduler and step; the data stream and the
augmentation counter start again, as in the JAX trainer. The model starts
from PyTorch's default initialisation; with ``backbone_pretrained`` the
backbone then takes the ImageNet weights at ``backbone_pretrained_path``
(``pretrained.py``), before ``--resume``, so a restored checkpoint wins over
the graft.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import time
from pathlib import Path

import numpy as np
import torch

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.dexycb import DexYCBDataset
from handmvnet_tpu_torch.data.ho3d import HO3DDataset
from handmvnet_tpu_torch.data.jpeg import decode_jpeg
from handmvnet_tpu_torch.data.loader import BatchLoader
from handmvnet_tpu_torch.data.mvhand import MVHandDataset
from handmvnet_tpu_torch.data.pipeline import preprocess_views
from handmvnet_tpu_torch.engine import (
    CheckpointManager,
    DeviceMetricAverager,
    JsonlLogger,
    evaluate,
    make_vertices_fn,
    restore_checkpoint,
    save_checkpoint,
    write_results_json,
)
from handmvnet_tpu_torch.pretrained import load_pretrained_backbone
from handmvnet_tpu_torch.train_step import build_model, create_train_state, train_step

DATASETS = {"ho3d": HO3DDataset, "dexycb": DexYCBDataset, "mvhand": MVHandDataset}
# a collated batch's host-only fields, which the model, losses and metrics do not read
HOST_ONLY = ("full_rgb", "full_jpeg", "mv_sample_id", "root_idx", "intrinsic_mat",
             "joints_img", "mano_pose", "mano_shape", "all_joints_cam", "all_root_joints",
             "cropped_bboxes")


AUGMENT_SEED = 42  # the n-th prepared batch augments from seed AUGMENT_SEED + n


def make_device_prepare(cfg: Config, device: str | torch.device = "cuda",
                        augment: bool = False):
    """Collated batch -> batch on ``device``: the frames there (JPEG bytes
    decoded by nvJPEG on a card; on the CPU the reader has decoded them),
    then ``preprocess_views`` (crops, augmentation with ``augment``,
    black-image rule, heatmaps) and the labels as tensors, without the
    host-only fields. With ``augment`` the n-th batch prepared (from 1) draws
    from a generator on ``device`` seeded AUGMENT_SEED + n
    (handmvnet_tpu/train.py:50-57), so one thread must call it, in order."""
    device = torch.device(device)
    generator = torch.Generator(device) if augment else None
    prepared = 0

    def prepare(batch: dict) -> dict:
        nonlocal prepared
        if "full_jpeg" in batch:
            flat = [jpeg for views in batch["full_jpeg"] for jpeg in views]
            frames = decode_jpeg(flat, device)
            frames = frames.reshape(len(batch["full_jpeg"]), -1, *frames.shape[1:])
        else:
            frames = torch.from_numpy(batch["full_rgb"]).to(device)
        any_visible = torch.from_numpy(~np.all(batch["joints_img_mask"], axis=-1)).to(device)
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in batch.items() if k not in HOST_ONLY}
        if augment:
            prepared += 1
            generator.manual_seed(AUGMENT_SEED + prepared)
        out["rgb"], out["heatmap"] = preprocess_views(
            frames, out["bboxes"], out["joints_crop_img"], any_visible,
            image_size=cfg.data.image_size, heatmap_size=cfg.data.heatmap_size,
            augment=augment, generator=generator)
        return out

    return prepare


def build_dataloaders(cfg: Config, device: str | torch.device = "cuda",
                      splits: tuple[str, ...] = ("val", "test")) -> tuple[BatchLoader, ...]:
    """A loader for each split asked for, over the config's shards, in that
    order: epochs of the split's size // batch batches (at least one), each
    batch prepared on ``device`` by the loader's preparer stage, the train
    split's with augmentation when the config asks for it."""
    ds_cls = DATASETS[cfg.data.name]
    bs = cfg.data.batch_size
    loaders = []
    for split in splits:
        ds = ds_cls(cfg.data, split, device=device)
        augment = split == "train" and cfg.data.augment
        loaders.append(BatchLoader(ds, batch_size=bs,
                                   steps_per_epoch=max(1, ds.num_samples() // bs),
                                   device_prepare=make_device_prepare(cfg, device, augment),
                                   device=device))
    return tuple(loaders)


def accumulation(cfg: Config) -> int:
    """The config's accumulate_batch, else the reference's rule on one
    device: 2 when the batch is under 64."""
    return cfg.train.accumulate_batch or (2 if cfg.data.batch_size < 64 else 1)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--epochs", type=int, default=0, help="override the config's epochs")
    parser.add_argument("--steps-per-epoch", type=int, default=0,
                        help="cut each training epoch to N steps (smoke runs)")
    parser.add_argument("--output-dir", default="")
    parser.add_argument("--resume", action="store_true",
                        help="resume from <output-dir>/checkpoints/last.pt")
    parser.add_argument("--eval-first", action="store_true",
                        help="one validation pass before training, logged as epoch -1")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = Config.from_yaml(args.config)
    if args.epochs:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=args.epochs))
    out_dir = Path(args.output_dir or cfg.base_output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))
    logger = JsonlLogger(out_dir / "metrics.jsonl")

    seed = cfg.train.seed
    accum = accumulation(cfg)
    bs = cfg.data.batch_size
    train_loader, val_loader = build_dataloaders(cfg, device, ("train", "val"))
    sched_steps = len(train_loader)  # the LR milestones' epoch
    if args.steps_per_epoch:
        train_loader.steps_per_epoch = args.steps_per_epoch
    steps_per_epoch = len(train_loader)

    model = build_model(cfg, str(device), seed)
    load_pretrained_backbone(model, cfg)
    state = create_train_state(model, cfg, sched_steps)
    ckpt = CheckpointManager(out_dir / "checkpoints")
    if args.resume and ckpt.last_path.exists():
        restore_checkpoint(ckpt.last_path, state)
        print(f"resumed from {ckpt.last_path} at step {state.step}")
    start_epoch = state.step // steps_per_epoch
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"params: {n_params / 1e6:.2f}M; batch {bs} x {cfg.data.num_views} views, "
          f"accumulation {accum}, {steps_per_epoch} steps an epoch, {cfg.train.compute_dtype}, "
          f"device {device}", flush=True)
    vertices_fn = make_vertices_fn(cfg, str(device)) if cfg.model.get_vertices else None
    generator = torch.Generator(device)

    def validate():
        return evaluate(state.model, val_loader, cfg, mode="val", vertices_fn=vertices_fn)

    preempted = []
    previous_handler = signal.signal(signal.SIGTERM, lambda signum, frame: preempted.append(signum))
    try:
        if args.eval_first and start_epoch == 0:
            t0 = time.time()
            init_val = validate()
            logger.log({"epoch": -1, "time_s": round(time.time() - t0, 1),
                        **{k: v for k, v in init_val.items() if "pck" not in k}})

        for epoch in range(start_epoch, cfg.train.epochs):
            t0 = time.time()
            lr = state.optimizer.param_groups[0]["lr"]  # what this epoch's steps use
            avg = DeviceMetricAverager()
            for batch in train_loader:
                generator.manual_seed(seed * 1_000_003 + state.step)
                avg.update(train_step(state, cfg, batch, generator, accum))
                if preempted:
                    save_checkpoint(ckpt.last_path, state)
                    print(f"SIGTERM: checkpointed at epoch {epoch} step {state.step}, exiting",
                          flush=True)
                    return
            train_metrics = avg.result()
            val_metrics = validate()
            ckpt.save(state, epoch, val_metrics.get("val_mpjpe", float("inf")))
            logger.log({
                "epoch": epoch, "time_s": round(time.time() - t0, 1), "lr": lr,
                **{f"train/{k}": v for k, v in train_metrics.items()},
                **{k: v for k, v in val_metrics.items() if "pck" not in k},
            })
    finally:
        signal.signal(signal.SIGTERM, previous_handler)

    ckpt.restore_best(state)
    val = validate()
    write_results_json(out_dir / "val.json", val)
    print("Validation result:", {k: v for k, v in val.items() if "pck" not in k}, flush=True)


if __name__ == "__main__":
    main()
