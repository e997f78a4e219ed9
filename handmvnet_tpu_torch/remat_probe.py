"""Where the card needs remat: ``python -m handmvnet_tpu_torch.remat_probe``

For the release recipe's two backbones (configs/release/HO3D_HandMvNet.yaml,
ResNet-50 "paper", and HO3D_HandMvNet_HR.yaml, HRNet w40) in fp32 and bf16,
and for microbatches of IMAGES images (5 views a sample), the peak
of allocated device memory (``torch.cuda.max_memory_allocated``) of the
second of two optimizer steps at accumulation 1, with remat off and on: the
step holds the parameters, their gradients, AdamW's two moments and one
microbatch's activations. It fits the remat-free peaks as fixed + bytes an
image x images (least squares) and prints the anchor, the most images whose
fitted peak stays within SHARE of the card's memory: the numbers that
``train_step.REMAT_FREE_IMAGES`` holds. Prints the card's name and power
limit (nvidia-smi) first, then one JSON line a measurement and one a fit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.train_step import (
    batch_to_device, build_model, create_train_state, train_step)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = {"resnet": REPO / "configs/release/HO3D_HandMvNet.yaml",
           "hrnet": REPO / "configs/release/HO3D_HandMvNet_HR.yaml"}
VIEWS = 5
IMAGES = (40, 80, 160)
SHARE = 0.85  # of the card's memory, for a remat-free step (the rest: the allocator, cuDNN)


def step_peak_bytes(cfg: Config, images: int, remat: bool) -> int:
    """Peak allocated bytes of the second optimizer step on a synthetic
    batch of images / VIEWS samples, accumulation 1."""
    batch_size = images // VIEWS
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch_size),
        train=dataclasses.replace(cfg.train, remat="on" if remat else "off"))
    state = create_train_state(build_model(cfg, "cuda", seed=0), cfg, steps_per_epoch=1000)
    batch = batch_to_device(synthetic_batch(batch_size, VIEWS, cfg.data.image_size,
                                            cfg.data.heatmap_size, seed=0), "cuda")
    generator = torch.Generator("cuda").manual_seed(0)
    train_step(state, cfg, batch, generator)  # AdamW's moments exist from here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step(state, cfg, batch, generator)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del state, batch
    torch.cuda.empty_cache()
    return peak


def fit_anchor(images: list[int], peaks: list[int], capacity: float) -> dict:
    """Least-squares peak = fixed + per_image * images; the anchor is the most
    images whose fitted peak is within ``capacity`` bytes."""
    per_image, fixed = np.polyfit(np.asarray(images, float), np.asarray(peaks, float), 1)
    residual = max(abs(fixed + per_image * i - p) for i, p in zip(images, peaks))
    return {"fixed_gb": fixed / 1e9, "per_image_mb": per_image / 1e6,
            "max_residual_gb": residual / 1e9,
            "anchor_images": int((capacity - fixed) // per_image)}


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("remat_probe measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    for backbone, path in CONFIGS.items():
        for dtype in ("float32", "bfloat16"):
            cfg = Config.from_yaml(path)
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                     compute_dtype=dtype))
            peaks = {}
            for images in IMAGES:
                for remat in (False, True):
                    peak = step_peak_bytes(cfg, images, remat)
                    if not remat:
                        peaks[images] = peak
                    print(json.dumps({"backbone": backbone, "dtype": dtype, "images": images,
                                      "remat": remat, "peak_gb": peak / 1e9}), flush=True)
            fit = fit_anchor(list(peaks), list(peaks.values()), SHARE * total)
            print(json.dumps({"backbone": backbone, "dtype": dtype, "fit": fit,
                              "share": SHARE, "card_memory_gb": total / 1e9,
                              "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
