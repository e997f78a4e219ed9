"""Closed-loop serving of one stream of synchronised multi-view frames: the
next frame is sent when the last one's outputs are on the host.

A frame is one request of the reference's eval_fps protocol: the program's
``HandMvNet`` forward on [1, views] crops, then its mesh stage
(``joints_to_vertices_fn``) on ``joints_cam * 1000``, and the outputs
(heatmaps, crop joints, joints_cam, vertices) copied to the host. Frames
come from a pool of ``pool`` distinct frames made from the seed, in a seeded
order. A frame's latency runs from its dispatch to its outputs on the host
(four copies into pinned buffers, one wait).

Parameters (``traffic/<mix>.json``): views, pool, warmup_frames,
check_frames (the seeded sample of finished frames judged after the
window), reference_block (frames a reference call takes) and trace_frames
(the traced slice after the window).
"""

from __future__ import annotations

import math
import random
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from hmvbench import counts, inputs, models, trace
from hmvbench.reference.mesh import MeshStage

OUTPUTS = ("heatmap", "joints_crop_img", "joints_cam", "vertices")
NUMBERS = ("heatmap_rel", "crop_px", "joints_mm", "vertices_mm")  # compared, each with its limit


@dataclass
class State:
    model: object
    mesh: object
    frames: dict
    order: list
    mano: dict
    host: dict = field(default_factory=dict)  # a frame's outputs on the host (pinned on a card)
    sample: list = field(default_factory=list)  # (frame index in the pool, host outputs)


def _serve(state: State, k: int, ranges: bool = False) -> tuple[dict, float]:
    """One frame: (its outputs on the host, the host's seconds in the mesh
    stage's call); ``ranges`` opens the benchmark's profiler ranges."""
    from torch.profiler import record_function
    frames = state.frames
    with record_function("hmvbench::forward") if ranges else nullcontext():
        out = state.model(frames["rgb"][k:k + 1], frames["bboxes"][k:k + 1],
                          frames["intrinsic"][k:k + 1])
    t = time.perf_counter()
    with record_function("hmvbench::mesh") if ranges else nullcontext():
        out["vertices"] = state.mesh(out["joints_cam"] * 1000.0)
    mesh_s = time.perf_counter() - t
    with record_function("hmvbench::to_host") if ranges else nullcontext():
        if not state.host:
            state.host = {n: torch.empty(out[n].shape, pin_memory=out[n].is_cuda) for n in OUTPUTS}
        for n in OUTPUTS:
            state.host[n].copy_(out[n], non_blocking=True)
        if out["vertices"].is_cuda:
            torch.cuda.current_stream().synchronize()  # one wait a frame, for all four
    return state.host, mesh_s


def setup(run) -> State:
    p, config = run.cell.traffic, run.cell.config
    models.set_precision(run.precision)
    cfg = models.program_config(config, p["views"], 1)
    weights = models.weights(config, p["views"], run.seed, run.device)
    run.mark("weights")
    model = models.program_model(cfg, config, weights, run.device).eval()
    del weights
    run.mark("model")
    mano = inputs.make_mano(run.seed, run.device)
    from handmvnet_tpu_torch.models.joints_to_vertices import joints_to_vertices_fn
    mesh = joints_to_vertices_fn(models.mano_layer(mano, run.device))
    frames = inputs.make_frames(p["pool"], p["views"], cfg.data.image_size,
                                cfg.data.heatmap_size, run.seed, run.device, labels=False)
    order = random.Random(inputs.sub_seed(run.seed, "order")).sample(range(p["pool"]), p["pool"])
    state = State(model, mesh, frames, order, mano)
    run.mark("mesh stage, frames")
    with torch.inference_mode():
        for i in range(p["warmup_frames"]):
            _serve(state, order[i % p["pool"]])
        if run.device == "cuda":
            torch.cuda.synchronize()
    return state


def window(run, state: State) -> None:
    p = run.cell.traffic
    rng = random.Random(inputs.sub_seed(run.seed, "sample"))
    latency, failed, mesh_s = [], 0, 0.0
    with torch.inference_mode():
        start = time.perf_counter()
        deadline = start + run.seconds
        while (t0 := time.perf_counter()) < deadline:
            k = state.order[len(latency) % p["pool"]]
            out, mesh = _serve(state, k)
            latency.append(time.perf_counter() - t0)
            mesh_s += mesh
            # a NaN anywhere reaches the joints and the vertices
            failed += not (np.isfinite(out["joints_cam"].numpy()).all()
                           and np.isfinite(out["vertices"].numpy()).all())
            # reservoir sample of the finished frames, drawn from the seed
            n = len(latency)
            if n <= p["check_frames"]:
                state.sample.append((k, {name: t.clone() for name, t in out.items()}))
            elif (j := rng.randrange(n)) < p["check_frames"]:
                state.sample[j] = (k, {name: t.clone() for name, t in out.items()})
        elapsed = time.perf_counter() - start
    run.window.update(attempted=len(latency), failed=failed, seconds=elapsed,
                      units=len(latency), mesh_host_s=mesh_s)
    run.values.update(frame_p95_ms=float(np.percentile(latency, 95)) * 1e3)


def traced_slice(run, state: State) -> None:
    """``trace_frames`` frames traced twice: the device alone, then with the
    host's calls, ranges around the forward, its backbone (module hooks),
    the mesh stage and the copies."""
    from torch.profiler import record_function
    n, out = run.cell.traffic["trace_frames"], []
    order = state.order
    with torch.inference_mode():
        with trace.traced(out, n, host=False):
            for i in range(n):
                _serve(state, order[i % len(order)])
        open_ranges = []

        def opener(*_):
            open_ranges.append(record_function("hmvbench::backbone").__enter__())

        def closer(*_):
            open_ranges.pop().__exit__(None, None, None)

        backbone = state.model.backbone
        hooks = [backbone.register_forward_pre_hook(opener),
                 backbone.register_forward_hook(closer)]
        try:
            with trace.traced(out, n, host=True):
                for i in range(n):
                    _serve(state, order[i % len(order)], ranges=True)
        finally:
            for h in hooks:
                h.remove()
    run.summary, run.host_summary = out


def k1_calls(run) -> list:
    """K1's calls in a frame's forward, as (batch, heads, queries, keys)."""
    return counts.k1_calls(run.cell.config["model"], 1, run.cell.traffic["views"])


def stem_images(run) -> list[int]:
    """The images of each stem conv a frame runs: one call on its views."""
    return [run.cell.traffic["views"]]


def flops(run) -> float:
    """A frame's forward operations, counted on the frozen reference."""
    return counts.forward_flops(run.cell.config, 1, run.cell.traffic["views"])


def reference_outputs(run, state: State, tf32: bool = False) -> list[dict]:
    """The reference's outputs for the sampled frames, the mesh stage run on
    the program's own joints (the stage is judged as a function of its
    input; the forward is judged on joints_cam)."""
    p, config = run.cell.traffic, run.cell.config
    models.set_precision(run.precision, tf32)
    weights = models.weights(config, p["views"], run.seed, run.device)
    ref = models.reference_model(config, p["views"], run.device)
    ref.load_state_dict(weights)
    ref.eval()
    mesh = MeshStage(state.mano).to(run.device)
    results = []
    with torch.no_grad():
        for at in range(0, len(state.sample), p["reference_block"]):
            block = state.sample[at:at + p["reference_block"]]
            idx = torch.tensor([k for k, _ in block], device=run.device)
            out = ref(*(state.frames[n][idx] for n in ("rgb", "bboxes", "intrinsic")))
            joints = torch.cat([o["joints_cam"] for _, o in block]).to(run.device)
            out["vertices"] = mesh(joints * 1000.0)
            results += [{n: out[n][i:i + 1].cpu() for n in OUTPUTS} for i in range(len(block))]
    models.set_precision(run.precision)
    return results


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference; infinite where either side is not
    finite, so that a NaN never passes."""
    gap = float((got - want).abs().max())
    return gap if math.isfinite(gap) else math.inf


def compare(sample: list, reference: list) -> dict:
    """The numbers judged: the worst frame's heatmap gap over its largest
    value, crop joints in px, joints_cam in mm, vertices in mm."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for (_, got), want in zip(sample, reference):
        for name, gap in (
                ("heatmap_rel", _gap(got["heatmap"], want["heatmap"])
                 / float(want["heatmap"].abs().max())),
                ("crop_px", _gap(got["joints_crop_img"], want["joints_crop_img"])),
                ("joints_mm", _gap(got["joints_cam"], want["joints_cam"]) * 1e3),
                ("vertices_mm", _gap(got["vertices"], want["vertices"]))):
            worst[name] = max(worst[name], gap)
    return worst


def release(state: State) -> None:
    """Free the program and its device state before the reference runs."""
    state.model = state.mesh = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run, state: State) -> dict:
    release(state)
    numbers = compare(state.sample, reference_outputs(run, state))
    return {k: {"value": v, "limit": run.cell.limits[k]} for k, v in numbers.items()}


def peak_share(state: State) -> float:
    """The largest soft-argmax probability among the sampled frames' joints
    (1 is saturated), read from their heatmaps."""
    hm = torch.cat([o["heatmap"] for _, o in state.sample]).flatten(-2)
    return float(torch.softmax(hm * 1000.0, dim=-1).amax())
