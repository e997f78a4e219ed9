"""Training throughput on the card (the counterpart of scripts/train_bench.py):
``python -m handmvnet_tpu_torch.train_bench [--batch 16] [--views 5] [--iters 50]``
``[--dtype bfloat16|float32] [--config ...]``

The whole optimizer step (forward, the loss with its reprojection terms,
backward, clipping, AdamW) of the config's model at full width, on one fixed
synthetic batch, accumulation 1, dropout on, with the backbone's remat as
``train.remat`` resolves for that batch (train_step.resolve_remat). Warmup
steps first, then ``--iters`` steps back to back between two CUDA events,
with no host read until the end. Prints the card's name and power limit
(nvidia-smi), then one JSON line: ms a step, samples/s, images/s, the final
loss, the peak of allocated device memory, whether the backbone remats, and
the card. fp32 is full fp32 (TF32 off).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.train_step import batch_to_device, build_model, create_train_state, train_step

WARMUP = 5


def bench(cfg: Config, batch_size: int, views: int, iters: int) -> dict:
    """Time ``iters`` train steps of the config's model on the card (weights,
    batch and dropout masks from seed 0)."""
    seed = 0
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=tuple(range(views))),
        data=dataclasses.replace(cfg.data, batch_size=batch_size))
    state = create_train_state(build_model(cfg, "cuda", seed), cfg, steps_per_epoch=1000)
    batch = batch_to_device(synthetic_batch(batch_size, views, cfg.data.image_size,
                                            cfg.data.heatmap_size, seed=seed), "cuda")
    generator = torch.Generator("cuda").manual_seed(seed)
    for _ in range(WARMUP):
        losses = train_step(state, cfg, batch, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        losses = train_step(state, cfg, batch, generator)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    return {
        "dtype": cfg.train.compute_dtype, "batch": batch_size, "views": views,
        "accumulation": 1, "remat": state.model.backbone.remat, "iters": iters,
        "ms_per_step": ms,
        "samples_per_s": batch_size / ms * 1e3, "images_per_s": batch_size * views / ms * 1e3,
        "final_loss": float(losses["loss"]),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/release/HO3D_HandMvNet.yaml")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--views", type=int, default=5)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_bench measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    cfg = Config.from_yaml(args.config)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype=args.dtype))
    print(json.dumps(bench(cfg, args.batch, args.views, args.iters)), flush=True)


if __name__ == "__main__":
    main()
