"""Inference speed of the port on the card:
``python -m handmvnet_tpu_torch.eval_fps [--config ...] [--views 8] [--no-vertices]``

The reference's eval_fps protocol (the counterpart of ``bench.py``): batch 1
x 8 views x 256^2 synthetic images; each step is the HandMvNet forward, then
the mesh stage (SVD alignment, adaptive IK, MANO LBS) on ``joints_cam * 1000``
with the synthetic MANO model standing in for the licensed one, as bench.py
does. 100 warmup then 1000 timed steps, in fp32 and bf16; ``--no-vertices``
times the forward alone. Weights are random from a numpy seed (normal * 0.05,
BatchNorm variance 1), as bench.py makes them: values do not change the work.
Prints one JSON line.

Two numbers per dtype, both from CUDA events on the card:
  * p50_ms: median latency of one request, each step waited for alone;
  * fps: frames per second over back-to-back steps with one wait at the end.
fp32 runs in full fp32 (TF32 off for matmuls and cuDNN convs); the mesh stage
runs in fp32 in both dtypes, since joints_cam is fp32.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.models.handmvnet import HandMvNet
from handmvnet_tpu_torch.models.joints_to_vertices import joints_to_vertices_fn
from handmvnet_tpu_torch.models.mano import ManoLayer, synthetic_mano_model

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def random_state_dict(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """normal * 0.05 for every parameter and buffer, 1 for BN running_var."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros_like(t)
        elif name.endswith("running_var"):
            out[name] = torch.ones_like(t)
        else:
            arr = rng.standard_normal(size=tuple(t.shape), dtype=np.float32) * 0.05
            out[name] = torch.from_numpy(arr)
    return out


def build_model(cfg: Config, views: int = 8, image_size: int = 256, device: str = "cuda",
                dtype: torch.dtype = torch.float32, seed: int = 0) -> HandMvNet:
    """The config's model with ``views`` views and random weights, in eval
    mode on ``device`` in ``dtype``."""
    mcfg = dataclasses.replace(cfg.model, selected_views=tuple(range(views)))
    model = HandMvNet(mcfg, image_size=image_size, heatmap_size=image_size // 8)
    model.load_state_dict(random_state_dict(model, seed))
    return model.eval().to(device=device, dtype=dtype)


def model_inputs(views: int, image_size: int, device: str, dtype: torch.dtype,
                 seed: int = 0) -> tuple[torch.Tensor, ...]:
    """One request of the protocol (batch 1): (rgb in ``dtype``, bboxes f32,
    intrinsics f32) on ``device``."""
    data = synthetic_batch(1, views, image_size, seed=seed, with_heatmaps=False)
    return (
        torch.from_numpy(data["rgb"]).to(device=device, dtype=dtype),
        torch.from_numpy(data["bboxes"]).to(device),
        torch.from_numpy(data["intrinsic"]).to(device),
    )


def build_mesh_stage(device: str = "cuda") -> torch.nn.Module:
    """The protocol's mesh stage on ``device``: joints_to_vertices_fn (fast,
    fused SVD) over the synthetic MANO model, as bench.py builds it."""
    return joints_to_vertices_fn(ManoLayer(synthetic_mano_model()).to(device))


def protocol_step(cfg: Config, views: int = 8, image_size: int = 256,
                  dtype: torch.dtype = torch.float32, device: str = "cuda", seed: int = 0,
                  with_vertices: bool = True):
    """The timed step as a function of no arguments: the forward on one
    request, then, with ``with_vertices``, the mesh stage on its joints_cam
    (m -> mm). Returns the forward's outputs, plus ``vertices`` [1, 778, 3]
    mm when the mesh stage ran. Call it under ``torch.inference_mode()``."""
    model = build_model(cfg, views, image_size, device, dtype, seed)
    inputs = model_inputs(views, image_size, device, dtype, seed)
    j2v = build_mesh_stage(device) if with_vertices else None

    def step() -> dict:
        out = model(*inputs)
        if j2v is not None:
            out["vertices"] = j2v(out["joints_cam"] * 1000.0)
        return out

    return step


def _timer(device: torch.device):
    """(mark, elapsed_ms): CUDA events on the card, the host clock on CPU."""
    if device.type == "cuda":
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def elapsed_ms(a, b):
            b.synchronize()
            return a.elapsed_time(b)
    else:
        def mark():
            return time.perf_counter()

        def elapsed_ms(a, b):
            return (b - a) * 1e3
    return mark, elapsed_ms


def run_protocol(cfg: Config, views: int = 8, image_size: int = 256,
                 dtype: torch.dtype = torch.float32, warmup: int = 100, iters: int = 1000,
                 device: str = "cuda", seed: int = 0,
                 with_vertices: bool = True) -> tuple[dict, dict]:
    """Time the protocol's step (``protocol_step``). Returns (stats, outputs
    of the last step); stats holds fps, p50_ms, mean_ms, the number of
    forwards run, whether the step included the mesh stage, and the device."""
    dev = torch.device(device)
    step = protocol_step(cfg, views, image_size, dtype, device, seed, with_vertices)
    mark, elapsed_ms = _timer(dev)

    with torch.inference_mode():
        for _ in range(warmup):
            out = step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        lat = []
        for _ in range(iters):
            t0 = mark()
            out = step()
            t1 = mark()
            lat.append(elapsed_ms(t0, t1))

        t0 = mark()
        for _ in range(iters):
            out = step()
        t1 = mark()
        total_ms = elapsed_ms(t0, t1)

    stats = {
        "dtype": str(dtype).removeprefix("torch."),
        "batch": 1,
        "views": views,
        "image_size": image_size,
        "fps": iters / (total_ms / 1e3),
        "p50_ms": float(np.percentile(lat, 50)),
        "mean_ms": float(np.mean(lat)),
        "forwards": warmup + 2 * iters,
        "with_vertices": with_vertices,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return stats, out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/release/HO3D_HandMvNet.yaml")
    parser.add_argument("--views", type=int, default=8)
    parser.add_argument("--iters", type=int, default=1000)
    parser.add_argument("--warmup", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-vertices", action="store_true",
                        help="time the forward alone, without the mesh stage")
    args = parser.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.from_yaml(args.config)
    record = {}
    for name, dtype in DTYPES.items():
        stats, _ = run_protocol(cfg, args.views, dtype=dtype, warmup=args.warmup,
                                iters=args.iters, device=args.device,
                                with_vertices=not args.no_vertices)
        record[name] = stats
    print(json.dumps(record))


if __name__ == "__main__":
    main()
