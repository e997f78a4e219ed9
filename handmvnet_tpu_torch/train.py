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

Batches: the data path and the loader are not ported yet, so every batch is
``data/synthetic.synthetic_batch``, the stand-in the JAX trainer itself falls
back to when no dataset tars are mounted. Optimizer step s trains on seed s,
and validation batch j is seed ``VAL_SEED + j`` in every pass. An epoch has
the train split's size // batch steps and validation the val split's;
``--steps-per-epoch`` cuts both (smoke runs) while the LR milestones stay
sized from the full epoch. The model starts from PyTorch's default
initialisation (the ImageNet backbone graft is not ported yet).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import time
from pathlib import Path

import torch

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
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
from handmvnet_tpu_torch.train_step import (
    batch_to_device,
    build_model,
    create_train_state,
    train_step,
)

VAL_SEED = 1 << 30  # validation batches' seeds start here, far from the train steps'


def accumulation(cfg: Config) -> int:
    """The config's accumulate_batch, else the reference's rule on one
    device: 2 when the batch is under 64."""
    return cfg.train.accumulate_batch or (2 if cfg.data.batch_size < 64 else 1)


def synthetic_batches(cfg: Config, seeds, device):
    """The config's batch shape from ``synthetic_batch``, one per seed, on ``device``."""
    for seed in seeds:
        yield batch_to_device(synthetic_batch(
            cfg.data.batch_size, cfg.data.num_views, cfg.data.image_size,
            cfg.data.heatmap_size, seed=seed), device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--epochs", type=int, default=0, help="override the config's epochs")
    parser.add_argument("--steps-per-epoch", type=int, default=0,
                        help="cut each epoch and each validation to N batches (smoke runs)")
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
    sched_steps = max(1, cfg.split_size("train") // bs)  # the LR milestones' epoch
    steps_per_epoch = args.steps_per_epoch or sched_steps
    val_steps = max(1, cfg.split_size("val") // bs)
    if args.steps_per_epoch:
        val_steps = min(val_steps, args.steps_per_epoch)
    val_seeds = range(VAL_SEED, VAL_SEED + val_steps)

    state = create_train_state(build_model(cfg, str(device), seed), cfg, sched_steps)
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
        return evaluate(state.model, synthetic_batches(cfg, val_seeds, device), cfg,
                        mode="val", vertices_fn=vertices_fn)

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
            end = (epoch + 1) * steps_per_epoch
            for batch in synthetic_batches(cfg, range(state.step, end), device):
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
