"""Where the protocol step's time goes on the card:
``python -m handmvnet_tpu_torch.profile_forward [--config ...] [--views 8] [--no-vertices]``

For fp32 and bf16, the step that eval_fps times (batch 1 x 8 views x 256^2,
random weights: the forward, then the mesh stage unless ``--no-vertices``),
and for each one JSON line with:
  * wall_p50_ms: host clock around one eager step that is waited for;
  * device_ms: the summed device time of the kernels (and copies) one step
    runs, from torch.profiler, and how many there are
    (device_ops_per_forward);
  * graph_ms: the same step captured once in a CUDA graph and replayed,
    i.e. the card's time when the host does not hold it back;
  * top: the kernels with the most device time per step.
  * forward_gflops: the forward's work (``forward_gflops``, counted on the
    CPU), beside which device_ms gives the rate the card reaches.
Then one line with the same keys for the mesh stage alone at batch 1 (fp32,
hand-like joints), where wall_p50_ms is its eager time per call.
fp32 runs in full fp32 (TF32 off).
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_hand_joints
from handmvnet_tpu_torch.eval_fps import (
    DTYPES, build_mesh_stage, build_model, model_inputs, protocol_step)


def graph_ms(fn, calls: int = 1, replays: int = 50) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times, so no host work is in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # capture needs the work warmed up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def profile_calls(fn, warmup: int = 10, iters: int = 50, profiled: int = 10,
                  top: int = 12) -> dict:
    """wall_p50_ms, device_ms, device_ops_per_forward, graph_ms and the top
    kernels of one call of ``fn`` on the card."""
    with torch.inference_mode():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        wall = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                fn()
            torch.cuda.synchronize()
        per_name: dict[str, float] = defaultdict(float)
        n_device = 0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                per_name[ev.name] += ev.time_range.elapsed_us() / 1e3 / profiled
                n_device += 1
        graph = graph_ms(fn)

    return {
        "wall_p50_ms": float(np.percentile(wall, 50)),
        "device_ms": sum(per_name.values()) if n_device else None,
        "device_ops_per_forward": n_device / profiled,
        "graph_ms": graph,
        "top": sorted(([name, ms] for name, ms in per_name.items()), key=lambda t: -t[1])[:top],
    }


def forward_gflops(cfg: Config, views: int = 8, image_size: int = 256) -> float:
    """GFLOPs (2 per multiply-add) of one protocol forward at batch 1, as
    torch's flop counter sees the convolutions and matmuls of the model run
    on the CPU (where K1 is its plain version); the mesh stage is not
    counted. A count of the work, the same on any device."""
    model = build_model(cfg, views, image_size, device="cpu")
    inputs = model_inputs(views, image_size, "cpu", torch.float32)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(*inputs)
    return counter.get_total_flops() / 1e9


def profile_forward(cfg: Config, views: int, dtype: torch.dtype,
                    with_vertices: bool = True) -> dict:
    meta = {"dtype": str(dtype).removeprefix("torch."), "views": views,
            "with_vertices": with_vertices, "device": torch.cuda.get_device_name(0)}
    return {**meta, **profile_calls(protocol_step(cfg, views, dtype=dtype, device="cuda",
                                                   with_vertices=with_vertices))}


def profile_mesh() -> dict:
    """The mesh stage alone on one request's hand-like joints (fp32)."""
    j2v = build_mesh_stage("cpu")
    joints = synthetic_hand_joints(j2v.mano, 1, seed=0).cuda()
    j2v.to("cuda")
    meta = {"stage": "mesh", "batch": 1, "device": torch.cuda.get_device_name(0)}
    return {**meta, **profile_calls(lambda: j2v(joints))}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/release/HO3D_HandMvNet.yaml")
    parser.add_argument("--views", type=int, default=8)
    parser.add_argument("--no-vertices", action="store_true",
                        help="profile the forward alone, without the mesh stage")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.from_yaml(args.config)
    gflops = forward_gflops(cfg, args.views)
    for dtype in DTYPES.values():
        record = profile_forward(cfg, args.views, dtype, not args.no_vertices)
        print(json.dumps({"config": args.config, "forward_gflops": gflops, **record}), flush=True)
    print(json.dumps(profile_mesh()), flush=True)


if __name__ == "__main__":
    main()
