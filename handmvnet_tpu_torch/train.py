"""Training driver:
``python -m handmvnet_tpu_torch.train --config configs/release/HO3D_HandMvNet.yaml``
``[--epochs N] [--steps-per-epoch N] [--output-dir DIR] [--resume] [--eval-first]``
``[--device cuda] [--num-devices N] [--detect-anomaly]``

The counterpart of handmvnet_tpu/train.py: seed 42 (the config's), the
reference's gradient accumulation (the config's ``accumulate_batch``, else 2
when the batch is under 64 and there are fewer than 3 ranks), AdamW with
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
``data.decode_scale_denom`` d downscales the frames by d after the decode
(the crop boxes divided by d, the model's boxes not); ``data.cache_decoded``
serves every split from the decode cache (data/cache.py), which the first
pass builds; each rank's slice of the shards is part of its store's
identity, so that ranks never build into one directory
(handmvnet_tpu/train.py:292-297). Dropout of optimizer step s draws from
seed * 1000003 + s. ``--resume`` restores the model, optimizer, scheduler
and step; the data stream and the augmentation counter start again, as in
the JAX trainer. The model starts
from PyTorch's default initialisation; with ``backbone_pretrained`` the
backbone then takes the ImageNet weights at ``backbone_pretrained_path``
(``pretrained.py``), before ``--resume``, so a restored checkpoint wins over
the graft.

``train.remat`` checkpoints the backbone's blocks (train_step.resolve_remat,
for this rank's microbatches). ``--detect-anomaly`` runs the fit under
``torch.autograd.detect_anomaly(check_nan=True)``, the reference's own
switch: a backward that makes a NaN raises, naming the forward op that
produced it. A declared divergence: the JAX trainer's ``jax_debug_nans``
raises at the jitted primitive that makes the NaN, forward or backward.

Every ``vis_every_n_epochs`` epochs (make_vis_hook) it draws the 2D joints
that the model predicts for the first sample of the epoch's last training
batch and of a val batch on their crops, ``vis/{train,val}/joints2d_{epoch}.png``,
and, when the g2d loss is on, the projected 3D joints,
``projected_joints2d_{epoch}.png``; ``tb/`` holds each epoch's record as
TensorBoard scalars.

Over N devices it trains data-parallel, one process (rank) a device: under
``torchrun --nproc-per-node N -m handmvnet_tpu_torch.train ...`` (several
hosts through torchrun's rendezvous), or with N ranks that it starts on this
host itself, N being ``--num-devices``, else the config's
``train.num_devices``, else the host's cards (1 with ``--device cpu``), as
the JAX trainer counts its devices (handmvnet_tpu/train.py:250; ``gpus`` is
read by neither). One rank starts no process group. Each rank takes the
config's ``batch_size`` from its own slice of the shards
(``split_index=rank``, ``split_count=N``), so an optimizer step averages N x
batch_size samples:
the reference's DDP semantics (``gpus: 2`` in the release configs) and the
JAX trainer's over several processes. (The JAX trainer in one process over
N devices splits the config's batch instead; the port has one device a
process, so it follows the multi-process reading.) An epoch is the split's
size // (batch x N) steps on every rank. The step averages the gradients,
loss terms and BatchNorm statistics over the ranks (train_step.py); every
rank builds and grafts the model from the seed, then takes rank 0's
weights, and restores ``--resume``'s checkpoint itself. Dropout folds the
rank into its seed (seed of the step x N + rank); augmentation does not.
Rank 0 alone writes config.json, metrics.jsonl, tb/, vis/, the checkpoints
and val.json. A SIGTERM to any rank stops every rank at the same step
(parallel.StopSignal) and checkpoints ``last``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from handmvnet_tpu_torch.config import Config, refuse_absolute_root
from handmvnet_tpu_torch.data.dexycb import DexYCBDataset
from handmvnet_tpu_torch.data.ho3d import HO3DDataset
from handmvnet_tpu_torch.data.jpeg import decode_jpeg, downscale_frames
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
    write_results_json,
)
from handmvnet_tpu_torch.ops.camera import reproject_to_views
from handmvnet_tpu_torch.ops.geometry import joints_img_to_crop
from handmvnet_tpu_torch.parallel import (
    StopSignal,
    broadcast_module_,
    init_data_parallel,
    is_main,
    launched,
    rank_and_world,
    start_local_ranks,
    warmup_collectives,
)
from handmvnet_tpu_torch.pretrained import load_pretrained_backbone
from handmvnet_tpu_torch.train_step import build_model, create_train_state, eval_step, train_step

DATASETS = {"ho3d": HO3DDataset, "dexycb": DexYCBDataset, "mvhand": MVHandDataset}
# a collated batch's host-only fields, which the model, losses and metrics do not read
HOST_ONLY = ("full_rgb", "full_jpeg", "mv_sample_id", "root_idx", "intrinsic_mat",
             "joints_img", "mano_pose", "mano_shape", "all_joints_cam", "all_root_joints",
             "cropped_bboxes")


AUGMENT_SEED = 42  # the n-th prepared batch augments from seed AUGMENT_SEED + n


def batch_frames(batch: dict, device: torch.device, denom: int = 1) -> torch.Tensor:
    """A collated batch's frames, uint8 [B, V, H, W, 3] on ``device``: its
    JPEG bytes decoded there (one nvJPEG call on a card) and downscaled by
    ``denom`` (the config's decode_scale_denom), or the frames that the CPU
    reader or the decode cache gives, already at that scale."""
    if "full_jpeg" in batch:
        flat = [jpeg for views in batch["full_jpeg"] for jpeg in views]
        frames = downscale_frames(decode_jpeg(flat, device), denom)
        return frames.reshape(len(batch["full_jpeg"]), -1, *frames.shape[1:])
    return torch.from_numpy(batch["full_rgb"]).to(device)


def make_device_prepare(cfg: Config, device: str | torch.device = "cuda",
                        augment: bool = False):
    """Collated batch -> batch on ``device``: the frames there (JPEG bytes
    decoded by nvJPEG on a card; on the CPU the reader has decoded them;
    cached frames uploaded), then ``preprocess_views`` (crops, augmentation
    with ``augment``, black-image rule, heatmaps) and the labels as tensors,
    without the host-only fields. With decode_scale_denom d > 1 the frames
    are 1/d the size and the crop boxes, only they, are divided by d: the
    model's ``bboxes`` stay in source pixels (handmvnet_tpu/train.py:59-66).
    With ``augment`` the n-th batch prepared (from 1) draws from a generator
    on ``device`` seeded AUGMENT_SEED + n (handmvnet_tpu/train.py:50-57), so
    one thread must call it, in order."""
    device = torch.device(device)
    generator = torch.Generator(device) if augment else None
    denom = cfg.data.decode_scale_denom
    prepared = 0

    def prepare(batch: dict) -> dict:
        nonlocal prepared
        frames = batch_frames(batch, device, denom)
        any_visible = torch.from_numpy(~np.all(batch["joints_img_mask"], axis=-1)).to(device)
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in batch.items() if k not in HOST_ONLY}
        if augment:
            prepared += 1
            generator.manual_seed(AUGMENT_SEED + prepared)
        crop_boxes = out["bboxes"] / float(denom) if denom > 1 else out["bboxes"]
        out["rgb"], out["heatmap"] = preprocess_views(
            frames, crop_boxes, out["joints_crop_img"], any_visible,
            image_size=cfg.data.image_size, heatmap_size=cfg.data.heatmap_size,
            augment=augment, generator=generator, box_scale_denom=denom)
        return out

    return prepare


def build_dataloaders(cfg: Config, device: str | torch.device = "cuda",
                      splits: tuple[str, ...] = ("val", "test"), rank: int = 0,
                      world: int = 1, by_sample: bool = False) -> tuple[BatchLoader, ...]:
    """A loader for each split asked for, over rank ``rank``'s slice of the
    config's shards out of ``world`` (handmvnet_tpu/train.py:93-110; with
    ``by_sample``, of their samples, dealt out by ordinal), in that order:
    epochs of the split's size // (batch x world) batches (at least one),
    the same count on every rank, each batch prepared on ``device`` by the
    loader's preparer stage, the train split's with augmentation when the
    config asks for it."""
    ds_cls = DATASETS[cfg.data.name]
    bs = cfg.data.batch_size
    loaders = []
    for split in splits:
        ds = ds_cls(cfg.data, split, split_index=rank, split_count=world, device=device,
                    by_sample=by_sample)
        augment = split == "train" and cfg.data.augment
        loaders.append(BatchLoader(ds, batch_size=bs,
                                   steps_per_epoch=max(1, ds.num_samples() // (bs * world)),
                                   device_prepare=make_device_prepare(cfg, device, augment),
                                   device=device))
    return tuple(loaders)


def accumulation(cfg: Config, world: int = 1) -> int:
    """The config's accumulate_batch, else the reference's rule
    (handmvnet_tpu/train.py:269): 2 when the batch is under 64 and there are
    fewer than 3 ranks."""
    return cfg.train.accumulate_batch or (
        2 if cfg.data.batch_size < 64 and world < 3 else 1)


def dropout_seed(seed: int, step: int, rank: int = 0, world: int = 1) -> int:
    """The seed of rank ``rank``'s dropout generator at optimizer step
    ``step``: distinct for every (step, rank), and at one rank the seed of
    the step alone."""
    return (seed * 1_000_003 + step) * world + rank


def project_crop(cfg: Config, joints_cam: torch.Tensor, batch: dict) -> torch.Tensor:
    """Predicted root-relative joints_cam [b, 21, 3] (m) -> their projection
    into each view's crop [b, v, 21, 2] pixels, through the batch's root
    joint (mm), cameras and boxes (handmvnet_tpu/train.py:124-135)."""
    projected = reproject_to_views(joints_cam + batch["root_joint"] / 1000.0, cfg.root_idx,
                                   batch["intrinsic"], batch["extrinsic"])
    b, v = projected.shape[:2]
    return joints_img_to_crop(projected.reshape(b * v, -1, 2), batch["bboxes"].reshape(b * v, 4),
                              float(cfg.data.image_size)).reshape(b, v, -1, 2)


def vis_due(cfg: Config, epoch: int) -> bool:
    """Whether the vis hook draws after epoch ``epoch`` (from 0)."""
    return (epoch + 1) % max(1, cfg.train.vis_every_n_epochs) == 0


def make_vis_hook(cfg: Config, out_dir: Path):
    """The per-epoch visualisation hook (handmvnet_tpu/train.py:112-180; the
    reference's handmvnet.py:425-441 and train.py:62-73 directory layout):
    ``hook(model, batch, epoch, mode)`` on an epoch that ``vis_due``, runs
    the eval-mode forward on the prepared batch (on the caller's stream,
    which waits on the batch's preparation as a step does) and writes
    vis/{mode}/joints2d_{epoch}.png, the predicted 2D joints of batch
    element 0 on its normalised crops, and, when the g2d loss is on and the
    batch has cameras, projected_joints2d_{epoch}.png, its predicted 3D
    joints projected into the crops. One copy to the host a call.

    Under a process group the port's forward is not collective, so rank 0
    alone calls the hook (and builds the val batch it draws); the other
    ranks issue nothing for it. The JAX hook runs its collective eval step
    on every process and writes on process 0."""
    vis_dir = out_dir / "vis"
    for split in ("train", "val", "test"):
        (vis_dir / split).mkdir(parents=True, exist_ok=True)
    with_proj = cfg.train.loss_weights.g2d is not None

    def hook(model, batch: dict, epoch: int, mode: str) -> None:
        if not vis_due(cfg, epoch):
            return
        import cv2

        from handmvnet_tpu_torch.vis.visualizer import HandPoseVisualizer

        out = eval_step(model, batch)
        panels = {f"joints2d_{epoch}.png": out["joints_crop_img"][0]}
        if with_proj and "extrinsic" in batch:
            with torch.inference_mode():
                proj = project_crop(cfg, out["joints_cam"], batch)
            panels[f"projected_joints2d_{epoch}.png"] = proj[0]
        parts = [batch["rgb"][0].float()] + list(panels.values())
        host = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        sizes = np.cumsum([p.numel() for p in parts])[:-1]
        rgb, *joints = (h.reshape(p.shape) for h, p in zip(np.split(host, sizes), parts))
        for name, j in zip(panels, joints):
            cv2.imwrite(str(vis_dir / mode / name),
                        HandPoseVisualizer.plot_images_with_joints(rgb, j))

    return hook


def local_devices(device_type: str) -> int:
    """This host's devices of ``device_type`` for ranks: its cards, or 1 CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def rank_count(num_devices: int, cfg: Config | None, device_type: str) -> int:
    """Ranks to start on this host: ``num_devices`` (the argument), else the
    config's ``train.num_devices``, else every local device
    (handmvnet_tpu/train.py:250). ``cfg`` is read only without the argument."""
    return num_devices or cfg.train.num_devices or local_devices(device_type)


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
    parser.add_argument("--num-devices", type=int, default=0,
                        help="train data-parallel over N ranks of this host, one a device "
                             "(default: the config's train.num_devices, else every card; "
                             "not under torchrun, which starts the ranks itself)")
    parser.add_argument("--detect-anomaly", action="store_true",
                        help="raise where the backward makes a NaN, naming its forward op "
                             "(torch.autograd.detect_anomaly with check_nan)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    device_type = torch.device(args.device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    if not launched():
        cfg = None if args.num_devices else Config.from_yaml(args.config)
        ranks = rank_count(args.num_devices, cfg, device_type)
        if ranks == 1:
            _train(args, torch.device(args.device))
        else:
            start_local_ranks(main, argv, ranks, device_type)
        return
    device, group = init_data_parallel(device_type)
    try:
        warmup_collectives(group, device)
        _train(args, device, group)
    finally:
        dist.destroy_process_group()


def _train(args, device: torch.device, group: dist.ProcessGroup | None = None) -> None:
    anomaly = torch.autograd.detect_anomaly(check_nan=True) if args.detect_anomaly \
        else contextlib.nullcontext()
    with anomaly:
        _fit(args, device, group)


def _fit(args, device: torch.device, group: dist.ProcessGroup | None = None) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = rank_and_world(group)
    main_rank = is_main(group)

    cfg = Config.from_yaml(args.config)
    refuse_absolute_root(cfg, "train.py")
    if args.epochs:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=args.epochs))
    out_dir = Path(args.output_dir or cfg.base_output_dir)
    logger = None
    if main_rank:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))
        logger = JsonlLogger(out_dir / "metrics.jsonl", tensorboard_dir=out_dir / "tb")

    seed = cfg.train.seed
    accum = accumulation(cfg, world)
    bs = cfg.data.batch_size
    train_loader, val_loader = build_dataloaders(cfg, device, ("train", "val"), rank, world)
    sched_steps = len(train_loader)  # the LR milestones' epoch
    if args.steps_per_epoch:
        train_loader.steps_per_epoch = args.steps_per_epoch
    steps_per_epoch = len(train_loader)

    model = build_model(cfg, str(device), seed, accum_steps=accum)
    load_pretrained_backbone(model, cfg)
    if group is not None:
        broadcast_module_(model, group)
    state = create_train_state(model, cfg, sched_steps)
    ckpt = CheckpointManager(out_dir / "checkpoints", group)
    if args.resume and ckpt.last_path.exists():
        restore_checkpoint(ckpt.last_path, state)
        if main_rank:
            print(f"resumed from {ckpt.last_path} at step {state.step}")
    start_epoch = state.step // steps_per_epoch
    if main_rank:
        n_params = sum(p.numel() for p in state.model.parameters())
        ranks = f" on each of {world} ranks" if group is not None else ""
        print(f"params: {n_params / 1e6:.2f}M; batch {bs} x {cfg.data.num_views} views{ranks}, "
              f"accumulation {accum}, remat {state.model.backbone.remat}, "
              f"{steps_per_epoch} steps an epoch, "
              f"{cfg.train.compute_dtype}, device {device}", flush=True)
    vertices_fn = make_vertices_fn(cfg, str(device)) if cfg.model.get_vertices else None
    generator = torch.Generator(device)
    vis_hook = vis_val_loader = None
    if main_rank:
        vis_hook = make_vis_hook(cfg, out_dir)
        if any(vis_due(cfg, e) for e in range(start_epoch, cfg.train.epochs)):
            import cv2  # noqa: F401 -- the hook draws with it: fail now, not at its epoch

    def validate():
        return evaluate(state.model, val_loader, cfg, mode="val", vertices_fn=vertices_fn,
                        group=group)

    def log(record: dict) -> None:
        if logger is not None:
            logger.log(record)

    stop = StopSignal(device, group)

    def on_sigterm(signum, frame):
        stop.requested = True

    previous_handler = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        if args.eval_first and start_epoch == 0:
            t0 = time.time()
            init_val = validate()
            log({"epoch": -1, "time_s": round(time.time() - t0, 1),
                 **{k: v for k, v in init_val.items() if "pck" not in k}})

        for epoch in range(start_epoch, cfg.train.epochs):
            t0 = time.time()
            lr = state.optimizer.param_groups[0]["lr"]  # what this epoch's steps use
            avg = DeviceMetricAverager()
            batch = None
            for batch in train_loader:
                generator.manual_seed(dropout_seed(seed, state.step, rank, world))
                avg.update(train_step(state, cfg, batch, generator, accum, group))
                if stop.poll():
                    ckpt.save_last(state)
                    if main_rank:
                        print(f"SIGTERM: checkpointed at epoch {epoch} step {state.step}, "
                              "exiting", flush=True)
                    return
            train_metrics = avg.result()
            val_metrics = validate()
            ckpt.save(state, epoch, val_metrics.get("val_mpjpe", float("inf")))
            if vis_hook is not None and vis_due(cfg, epoch):
                if batch is not None:
                    vis_hook(state.model, batch, epoch, "train")
                # a one-shot loader of its own: drawing from val_loader would take
                # batches from the next validation's window
                if vis_val_loader is None:
                    (vis_val_loader,) = build_dataloaders(cfg, device, ("val",), rank, world)
                    vis_val_loader.steps_per_epoch = 1
                batches = iter(vis_val_loader)
                try:
                    vis_hook(state.model, next(batches), epoch, "val")
                finally:
                    batches.close()
            log({
                "epoch": epoch, "time_s": round(time.time() - t0, 1), "lr": lr,
                **{f"train/{k}": v for k, v in train_metrics.items()},
                **{k: v for k, v in val_metrics.items() if "pck" not in k},
            })
        signal.signal(signal.SIGTERM, previous_handler)  # the fit is over
        ckpt.restore_best(state)
        val = validate()
        if main_rank:
            write_results_json(out_dir / "val.json", val)
            print("Validation result:", {k: v for k, v in val.items() if "pck" not in k},
                  flush=True)
    finally:
        signal.signal(signal.SIGTERM, previous_handler)
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
