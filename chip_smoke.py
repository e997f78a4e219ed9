#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (handmvnet_tpu_torch) on one NVIDIA
Hopper GPU. Run from the repository root: ``python3 chip_smoke.py``.

Phases; any failure exits nonzero and prints no result:
  1. the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from handmvnet_tpu_torch/csrc (nvcc, in parallel),
     and count the tensor-core instructions (HMMA) in each library's SASS
     (cuobjdump): the bf16 and the fp32 (3xTF32) kernel of each must have some;
  3. hold each kernel against its plain PyTorch version at the shapes of the
     b1 x v8 main path, fp32 and bf16, with the tolerance stated;
  4. time each kernel, its plain version and one library call of the same
     function (used nowhere in the port), beside the card's bound;
  5. drive the main path, the eval_fps protocol (HO3D release model, batch 1
     x 8 views x 256^2, each step the forward and then the mesh stage: SVD
     alignment, adaptive IK and MANO LBS over the synthetic MANO model) in fp32
     and bf16, with the launch counters set to 0 just before and read just
     after: K1 must launch 5 times per forward and K2 once; outputs, vertices
     [1, 778, 3] among them, finite and of the expected shapes; the same
     protocol without the mesh stage (--no-vertices) for comparison; the mesh
     stage on the card against the same function on the CPU, and one call of
     it under the sync debug mode "error" (no synchronising copy, no read to
     the host); the fp32 kernel path against the plain path on the card;
  6. the training path at the HO3D release recipe (batch 16 x 5 views x
     256^2, accumulation 2, full width): each kernel at the training shapes
     against its plain version, forward and backward (the backwards are
     PyTorch ops), and timed; then, in fp32 and in bf16, 3 warmup and 20
     timed optimizer steps on one synthetic batch with the counters set to 0
     just before and read just after: K1 must launch 10 times a step and K2
     twice, the loss must be finite at every step and lower at the end;
     ms a step, samples/s, peak memory and the device ops of one
     microbatch's forward and backward; then one fp32 step of the kernel
     path against the plain path from the same weights and batch (dropout 0):
     loss terms rel 1e-4, global gradient norm rel 1e-3 (judged with the
     heatmap head scaled so that the soft-argmax is not saturated, printed
     without it);
  7. a {"kernels": [...]} line, then the {"ok": true, ...} line last.

fp32 means fp32 here: TF32 is switched off for matmuls and cuDNN convs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "release" / "HO3D_HandMvNet.yaml"
WARMUP, ITERS = 100, 1000  # the reference's protocol; warmup + 2 * ITERS forwards per dtype

# H100 SXM data sheet: HBM rate, dense tensor-core peaks. The fp32 kernels run
# each f32 product as three TF32 products (3xTF32), so their peak is a third of
# the 495 TFLOP/s TF32 rate (above the 67 TFLOP/s of f32 FMAs on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
MMA_KERNELS = ("bf16_mma", "tf32x3_mma")  # each library's tensor-core kernels, by symbol

ATTN_SHAPES = ((168, 168), (21, 147), (21, 21))  # (Nq, Nk) of the 5 fusion blocks
ATTN_CALLS = {(168, 168): 2, (21, 147): 1, (21, 21): 2}  # launches per forward
STEM_SHAPE = (8, 256, 256)  # b*v images of 256^2
# training, release recipe: microbatches of 8 samples x 5 views
TRAIN_BATCH, TRAIN_VIEWS, TRAIN_WARMUP, TRAIN_ITERS = 16, 5, 3, 20
TRAIN_ATTN_BATCH = 8
TRAIN_ATTN_SHAPES = ((105, 105), (21, 84), (21, 21))
TRAIN_ATTN_CALLS = {(105, 105): 2, (21, 84): 1, (21, 21): 2}  # launches per microbatch
TRAIN_STEM_SHAPE = (40, 256, 256)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# mesh stage, card against CPU, on the same fp32 joints: vertices of |v| up to
# ~400 mm, where the fp32 stage differs from float64 by up to ~5e-3 mm and the
# card's kernels round in other orders than the CPU's
MESH_ATOL_MM = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Per call over back-to-back eager calls (CUDA events): the device
    timeline, including the gaps while the host prepares each launch."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fns: dict) -> dict:
    """{name: {"device": ms, "eager": ms}} per call of each function, inputs
    warm in L2, measured in turns a b .. b a with the lower of the two kept."""
    from handmvnet_tpu_torch.profile_forward import graph_ms

    times = {name: {"device": float("inf"), "eager": float("inf")} for name in fns}
    for name in list(fns) + list(reversed(fns)):
        t = times[name]
        t["device"] = min(t["device"], graph_ms(fns[name], calls=20, replays=20))
        t["eager"] = min(t["eager"], _eager_ms(fns[name]))
    return times


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tensor_core_counts(lib: Path) -> dict:
    """{kernel symbol: count of HMMA (mma.sync) and HGMMA (wgmma) instructions}
    in a library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass {lib.name}: {sass.stderr.strip()}")
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    return counts


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


@contextlib.contextmanager
def plain_kernels(attention_ops, stem_ops):
    """Route the model through the plain versions on the card (a reference
    path for this script; the port itself never does this)."""
    saved = attention_ops.fused_attention, stem_ops.stem_conv_nchw
    attention_ops.fused_attention = attention_ops.attention_plain
    stem_ops.stem_conv_nchw = stem_ops.stem_conv_plain
    try:
        yield
    finally:
        attention_ops.fused_attention, stem_ops.stem_conv_nchw = saved


def check_attention(attention_ops, dtype, gen, shapes=ATTN_SHAPES, batch=1) -> dict:
    """K1 at each shape: error vs plain, times, bound."""
    scale = 128 ** -0.5
    rows = {}
    for nq, nk in shapes:
        # the model's layout: [b, n, h, d] projections viewed as [b, h, n, d]
        q, k, v = (torch.randn(batch, n, 8, 128, generator=gen, device="cuda").to(dtype)
                   .transpose(1, 2) for n in (nq, nk, nk))
        with torch.no_grad():
            out = attention_ops.fused_attention(q, k, v, scale)
        torch.cuda.synchronize()
        ref = attention_ops.attention_plain(q, k, v, scale)
        err = max_err(out, ref)
        tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * float(ref.float().abs().max())
        print(f"K1 fused_attention {dtype} batch {batch} (Nq, Nk)=({nq}, {nk}): "
              f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
        if not err <= tol:
            fail(f"K1 disagrees with its plain version at ({nq}, {nk}) {dtype}: {err} > {tol}")
        with torch.no_grad():
            t = time_ms({
                "kernel": lambda: attention_ops.fused_attention(q, k, v, scale),
                "plain": lambda: attention_ops.attention_plain(q, k, v, scale),
                "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            })
        elt = q.element_size()
        flops = 4.0 * batch * 8 * nq * nk * 128  # q k^T and p v, 8 heads
        nbytes = batch * 8 * 128 * (2 * nq + 2 * nk) * elt  # q, k, v read and o written once
        b, by = bound_ms(flops, nbytes, dtype)
        print(f"   device ms: kernel={t['kernel']['device']:.5f} plain={t['plain']['device']:.5f} "
              f"sdpa={t['library']['device']:.5f} bound={b:.5f} ({by}); eager ms: "
              f"kernel={t['kernel']['eager']:.5f} plain={t['plain']['eager']:.5f} "
              f"sdpa={t['library']['eager']:.5f}", flush=True)
        rows[(nq, nk)] = {"err": err, "t": t, "bound": b, "flops": flops, "bytes": nbytes}
    return rows


def check_stem(stem_ops, dtype, gen, shape=STEM_SHAPE) -> dict:
    """K2 at one input shape: error vs plain, times, bound."""
    n, h, w = shape
    # the model's layout: the NHWC images viewed as NCHW
    x = torch.randn(n, h, w, 3, generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    weight = (torch.randn(64, 3, 7, 7, generator=gen, device="cuda") * 0.05).to(dtype)
    with torch.no_grad():
        out = stem_ops.stem_conv_nchw(x, weight)
    torch.cuda.synchronize()
    ref = stem_ops.stem_conv_plain(x, weight)
    err = max_err(out, ref)
    ref_max = float(ref.float().abs().max())
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -6) * ref_max
    print(f"K2 stem_conv {dtype} x=[{n}, 3, {h}, {w}]: max_abs_err={err:.3e} tol={tol:.3e}",
          flush=True)
    if out.shape != ref.shape or not err <= tol:
        fail(f"K2 disagrees with its plain version {dtype}: {err} > {tol}")
    with torch.no_grad():
        t = time_ms({
            "kernel": lambda: stem_ops.stem_conv_nchw(x, weight),
            "plain": lambda: stem_ops.stem_conv_plain(x, weight),
            "library": lambda: F.conv2d(x, weight, stride=2, padding=3),
        })
    elt = x.element_size()
    ho, wo = (h + 1) // 2, (w + 1) // 2
    flops = 2.0 * n * ho * wo * 64 * 147
    nbytes = (n * 3 * h * w + 64 * 147 + n * 64 * ho * wo) * elt
    b, by = bound_ms(flops, nbytes, dtype)
    print(f"   device ms: kernel={t['kernel']['device']:.5f} plain={t['plain']['device']:.5f} "
          f"conv2d={t['library']['device']:.5f} bound={b:.5f} ({by}); eager ms: "
          f"kernel={t['kernel']['eager']:.5f} plain={t['plain']['eager']:.5f} "
          f"conv2d={t['library']['eager']:.5f}", flush=True)
    return {"err": err, "t": t, "bound": b, "bound_by": by}


def check_attention_backward(attention_ops, dtype, gen) -> dict:
    """The K1 Function's gradients at the training shapes against autograd
    through the plain version, and the backward's device time per microbatch
    (attention_backward: PyTorch ops)."""
    from handmvnet_tpu_torch.profile_forward import graph_ms

    scale = 128 ** -0.5
    worst, ms = 0.0, 0.0
    for nq, nk in TRAIN_ATTN_SHAPES:
        base = [torch.randn(TRAIN_ATTN_BATCH, n, 8, 128, generator=gen, device="cuda").to(dtype)
                for n in (nq, nk, nk)]
        g = torch.randn(TRAIN_ATTN_BATCH, 8, nq, 128, generator=gen, device="cuda").to(dtype)
        grads = []
        for fn in (attention_ops.fused_attention, attention_ops.attention_plain):
            qkv = [t.clone().requires_grad_(True) for t in base]
            out = fn(*(t.transpose(1, 2) for t in qkv), scale)
            if fn is attention_ops.fused_attention and \
                    type(out.grad_fn).__name__ != "FusedAttentionBackward":
                fail(f"K1's output has grad_fn {out.grad_fn}, not the port's Function")
            out.backward(g)
            grads.append([t.grad for t in qkv])
        for name, ours, ref in zip(("dq", "dk", "dv"), *grads):
            err = max_err(ours, ref)
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * float(ref.float().abs().max())
            print(f"K1 backward {dtype} ({nq}, {nk}) {name}: max_abs_err={err:.3e} tol={tol:.3e}",
                  flush=True)
            if not err <= tol:
                fail(f"K1's backward disagrees with autograd through the plain version "
                     f"at ({nq}, {nk}) {dtype} {name}: {err} > {tol}")
            worst = max(worst, err)
        q, k, v = (t.transpose(1, 2) for t in base)
        t = graph_ms(lambda: attention_ops.attention_backward(q, k, v, g, scale), 20, 20)
        ms += TRAIN_ATTN_CALLS[(nq, nk)] * t
    print(f"   K1 backward (PyTorch ops) device ms per microbatch: {ms:.5f}", flush=True)
    return {"err": worst, "ms": ms}


def check_stem_backward(stem_ops, dtype, gen) -> dict:
    """The K2 Function's weight gradient at the training shape against
    autograd through the plain version, and its device time
    (torch.nn.grad.conv2d_weight)."""
    from handmvnet_tpu_torch.profile_forward import graph_ms

    n, h, w = TRAIN_STEM_SHAPE
    x = torch.randn(n, h, w, 3, generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    base = (torch.randn(64, 3, 7, 7, generator=gen, device="cuda") * 0.05).to(dtype)
    g = torch.randn(n, 64, (h + 1) // 2, (w + 1) // 2, generator=gen, device="cuda").to(dtype)
    grads = []
    for fn in (stem_ops.stem_conv_nchw, stem_ops.stem_conv_plain):
        weight = base.clone().requires_grad_(True)
        out = fn(x, weight)
        if fn is stem_ops.stem_conv_nchw and type(out.grad_fn).__name__ != "StemConvBackward":
            fail(f"K2's output has grad_fn {out.grad_fn}, not the port's Function")
        out.backward(g)
        grads.append(weight.grad)
    err = max_err(*grads)
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -6) * float(grads[1].float().abs().max())
    print(f"K2 backward {dtype} weight grad x=[{n}, 3, {h}, {w}]: max_abs_err={err:.3e} "
          f"tol={tol:.3e}", flush=True)
    if not err <= tol:
        fail(f"K2's weight gradient disagrees with autograd through the plain version "
             f"{dtype}: {err} > {tol}")
    ms = graph_ms(lambda: torch.nn.grad.conv2d_weight(x, base.shape, g, stride=2, padding=3),
                  20, 20)
    print(f"   K2 backward (torch.nn.grad.conv2d_weight) device ms: {ms:.5f}", flush=True)
    return {"err": err, "ms": ms}


def train_config(dtype_name: str):
    from handmvnet_tpu_torch.config import Config

    cfg = Config.from_yaml(CONFIG)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype=dtype_name))


def train_run(attention_ops, stem_ops, dtype_name: str) -> dict:
    """The training path at the release recipe: TRAIN_WARMUP + TRAIN_ITERS
    optimizer steps of the train step on one fixed synthetic batch, the
    launch counters set to 0 just before and read just after."""
    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.train import accumulation
    from handmvnet_tpu_torch.train_step import (
        batch_to_device, build_model, create_train_state, forward_loss, train_step)

    cfg = train_config(dtype_name)
    accum = accumulation(cfg)
    state = create_train_state(build_model(cfg, "cuda", seed=0), cfg,
                               steps_per_epoch=cfg.split_size("train") // TRAIN_BATCH)
    batch = batch_to_device(synthetic_batch(TRAIN_BATCH, TRAIN_VIEWS, cfg.data.image_size,
                                            cfg.data.heatmap_size, seed=0), "cuda")
    gen = torch.Generator("cuda")
    steps = TRAIN_WARMUP + TRAIN_ITERS
    losses = []
    attention_ops.fused_attention.launches = 0
    stem_ops.stem_conv_nchw.launches = 0
    for i in range(TRAIN_WARMUP):
        losses.append(train_step(state, cfg, batch, gen.manual_seed(i), accum)["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TRAIN_WARMUP, steps):
        losses.append(train_step(state, cfg, batch, gen.manual_seed(i), accum)["loss"])
    end.record()
    end.synchronize()
    launches = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    ms = start.elapsed_time(end) / TRAIN_ITERS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    curve = torch.stack(losses).cpu().tolist()

    print(f"training {dtype_name}: batch {TRAIN_BATCH} x {TRAIN_VIEWS} views, accumulation "
          f"{accum}: ms_per_step={ms:.3f} samples_per_s={TRAIN_BATCH / ms * 1e3:.2f} "
          f"images_per_s={TRAIN_BATCH * TRAIN_VIEWS / ms * 1e3:.2f} peak_memory_gb={peak_gb:.3f} "
          f"launches K1={launches[0]} K2={launches[1]} in {steps} steps", flush=True)
    print(f"   loss by step: {[round(v, 3) for v in curve]}", flush=True)
    want = (10 * steps, 2 * steps)
    if launches != want:
        fail(f"training {dtype_name}: kernel launches {launches}, expected {want} "
             "(10 and 2 per optimizer step)")
    if not all(math.isfinite(v) for v in curve) or not curve[-1] < curve[0]:
        fail(f"training {dtype_name}: the loss is not finite or did not fall: {curve}")

    # device ops of one microbatch's forward and backward (not counted above)
    micro = {k: v[:TRAIN_BATCH // accum] for k, v in batch.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss = forward_loss(state.model, cfg, micro, gen.manual_seed(0))[0]["loss"]
        loss.backward()
        torch.cuda.synchronize()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    n_ops = sum(1 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)
    device_ms = sum(by_name.values())
    print(f"   one microbatch's forward + backward: {n_ops} device ops, {device_ms:.3f} "
          "device ms (profiler); the largest:", flush=True)
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"      {t:9.3f} ms  {name[:110]}", flush=True)
    return {"launches": launches, "ms": ms, "peak_gb": peak_gb, "device_ops": n_ops}


def train_kernel_vs_plain(attention_ops, stem_ops) -> None:
    """One fp32 optimizer step (accumulation 2) of the kernel path and of the
    plain path from the same weights and batch, dropout 0: loss terms rel
    1e-4, global gradient norm before clipping rel 1e-3, the largest per-leaf
    difference printed.

    Two sets of weights. With PyTorch's initialisation the heatmap head's
    logits are large, the soft-argmax (at x1000) is saturated, and its
    gradient turns rounding into percent: the gradient norm is printed there,
    not judged (the fp32 plain path alone differs as much from its float64
    self). With the head's last conv scaled by 1e-3, as
    tests/test_torch_train.py scales it for the comparison with JAX, the
    norm is judged. The loss terms are judged on both."""
    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.train import accumulation
    from handmvnet_tpu_torch.train_step import (
        accumulate_grads, batch_to_device, build_model, create_train_state, optimizer_step)

    cfg = train_config("float32")
    data = synthetic_batch(TRAIN_BATCH, TRAIN_VIEWS, cfg.data.image_size,
                           cfg.data.heatmap_size, seed=1)
    # The synthetic batch's random camera rotations put some joints of other
    # views within millimetres of the camera plane, where the g2d/p2d
    # projection turns rounding into pixels (g2d ~3000 px a joint). With
    # every view at the root camera's pose each joint projects from ~0.5 m,
    # and the loss terms measure the two paths, not the pole.
    data["extrinsic"][:] = np.eye(4, dtype=np.float32)
    batch = batch_to_device(data, "cuda")
    bad = []
    for head_scale in (1.0, 1e-3):
        results = []
        for path in ("kernel", "plain"):
            model = build_model(cfg, "cuda", seed=1, dropout=0.0)
            with torch.no_grad():
                for p in model.pose_net[3].parameters():
                    p.mul_(head_scale)
            state = create_train_state(model, cfg, 1000)
            with plain_kernels(attention_ops, stem_ops) if path == "plain" \
                    else contextlib.nullcontext():
                losses = accumulate_grads(state, cfg, batch, None, accumulation(cfg))
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
            norm = optimizer_step(state, cfg)
            results.append(({k: float(v) for k, v in losses.items()}, grads, float(norm)))
        (lk, gk, nk), (lp, gp, norm_p) = results
        label = f"train fp32 kernel path vs plain path, head x{head_scale:g}"
        for key in lp:
            rel = abs(lk[key] - lp[key]) / abs(lp[key])
            print(f"{label}, {key}: {lk[key]:.6f} vs {lp[key]:.6f} rel={rel:.3e} tol=1e-4",
                  flush=True)
            if not rel <= 1e-4:
                bad.append(f"head x{head_scale:g} {key} rel {rel}")
        rel = abs(nk - norm_p) / norm_p
        judged = head_scale != 1.0
        print(f"{label}, gradient norm: {nk:.6e} vs {norm_p:.6e} rel={rel:.3e} "
              + ("tol=1e-3" if judged else "not judged"), flush=True)
        if judged and not rel <= 1e-3:
            bad.append(f"head x{head_scale:g} gradient norm rel {rel}")
        # per leaf, relative to the leaf's largest gradient; the conv biases
        # before a train-mode BatchNorm, whose exact gradient is 0, are left out
        top = max(float(g.abs().max()) for g in gp.values())
        leaf = max((n for n in gp if float(gp[n].abs().max()) > 1e-6 * top),
                   key=lambda n: float((gk[n] - gp[n]).abs().max()) / float(gp[n].abs().max()))
        print(f"   largest per-leaf difference: {leaf} max_abs_err="
              f"{float((gk[leaf] - gp[leaf]).abs().max()):.3e} "
              f"(max|plain|={float(gp[leaf].abs().max()):.3e})", flush=True)
        for name in ["backbone.conv1.weight"] + [n for n in gk if n.endswith(
                ("to_q.weight", "to_k.weight", "to_v.weight"))]:
            if not float(gk[name].abs().max()) > 0:
                fail(f"training: {name} got no gradient through the kernels")
    if bad:
        fail(f"training: the kernel path disagrees with the plain path: {bad}")
    print("   conv1.weight and every to_q/to_k/to_v weight have non-zero gradients", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA GPU only")
    if not (REPO / "handmvnet_tpu_torch").is_dir() or not CONFIG.exists():
        fail(f"run from a checkout of the repository ({REPO} lacks the port)")

    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.synthetic import synthetic_hand_joints
    from handmvnet_tpu_torch.eval_fps import build_mesh_stage, protocol_step, run_protocol
    from handmvnet_tpu_torch.ops import _build
    from handmvnet_tpu_torch.ops import attention as attention_ops
    from handmvnet_tpu_torch.ops import stem as stem_ops

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"   {name}: {line.strip()}", flush=True)
    for name, path in sorted(libs.items()):
        counts = tensor_core_counts(path)
        for fn, c in counts.items():
            print(f"   {name}: {c} HMMA/HGMMA in {fn}", flush=True)
        for tag in MMA_KERNELS:
            if not any(c > 0 for fn, c in counts.items() if tag in fn):
                fail(f"{name}: no tensor-core instruction in its {tag} kernel ({counts})")

    # 3 + 4. each kernel against its plain version, and times
    gen = torch.Generator("cuda").manual_seed(0)
    attn = {d: check_attention(attention_ops, d, gen) for d in DTYPES.values()}
    stem = {d: check_stem(stem_ops, d, gen) for d in DTYPES.values()}

    # 5. the main path, through the entry point a user calls
    cfg = Config.from_yaml(CONFIG)
    launches, joints_cam = {}, {}
    for name, dtype in DTYPES.items():
        for with_vertices in (True, False):
            attention_ops.fused_attention.launches = 0
            stem_ops.stem_conv_nchw.launches = 0
            stats, out = run_protocol(cfg, views=8, dtype=dtype, warmup=WARMUP, iters=ITERS,
                                      device="cuda", seed=0, with_vertices=with_vertices)
            torch.cuda.synchronize()
            got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
            want = (5 * stats["forwards"], stats["forwards"])
            step = "forward + mesh stage" if with_vertices else "forward only (--no-vertices)"
            print(f"main path {name} {step}: fps={stats['fps']:.2f} p50_ms={stats['p50_ms']:.4f} "
                  f"mean_ms={stats['mean_ms']:.4f} forwards={stats['forwards']} "
                  f"launches K1={got[0]} K2={got[1]}", flush=True)
            if got != want:
                fail(f"{name} {step}: kernel launches {got}, expected {want} "
                     "(5 and 1 per forward)")
            shapes = {"joints_cam": (1, 21, 3), "joints_crop_img": (1, 8, 21, 2),
                      "heatmap": (1, 8, 21, 32, 32)}
            if with_vertices:
                launches[dtype] = got
                joints_cam[name] = out["joints_cam"]
                shapes["vertices"] = (1, 778, 3)
            elif "vertices" in out:
                fail(f"{name}: --no-vertices returned vertices")
            for key, shape in shapes.items():
                if tuple(out[key].shape) != shape or out[key].dtype != torch.float32:
                    fail(f"{name}: {key} is {tuple(out[key].shape)} {out[key].dtype}")
                if out[key].device.type != "cuda" or not torch.isfinite(out[key]).all():
                    fail(f"{name}: {key} is not finite on the card ({out[key].device})")

    # the mesh stage on the card against the same port function on the CPU
    mesh_cpu, mesh_gpu = build_mesh_stage("cpu"), build_mesh_stage("cuda")
    mesh_inputs = {f"joints_cam * 1000 ({name})": j * 1000.0 for name, j in joints_cam.items()}
    mesh_inputs["64 hand-like joints"] = synthetic_hand_joints(mesh_cpu.mano, 64, seed=1).cuda()
    with torch.inference_mode():
        for label, joints in mesh_inputs.items():
            ref = mesh_cpu(joints.cpu())
            got = mesh_gpu(joints)
            err = max_err(got.cpu(), ref)
            print(f"mesh stage card vs CPU, {label}: max_abs_err={err:.3e} mm "
                  f"(max|v|={float(ref.abs().max()):.1f} mm) tol={MESH_ATOL_MM:.0e}", flush=True)
            if got.device.type != "cuda" or not err <= MESH_ATOL_MM:
                fail(f"mesh stage on the card disagrees with the CPU on {label}: {err} mm")
        # no hidden host work: a synchronising copy or a read to the host raises
        joints = mesh_inputs["64 hand-like joints"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = mesh_gpu(joints)
        except RuntimeError as e:
            fail(f"the mesh stage synchronises with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if got.device.type != "cuda":
            fail(f"the mesh stage returned vertices on {got.device}")
        print("mesh stage under sync debug mode 'error': no synchronising call", flush=True)

    # the fp32 kernel path against the plain path on the card, same weights
    step = protocol_step(cfg, views=8, dtype=torch.float32, device="cuda", seed=0)
    with torch.inference_mode():
        out_k = step()
        with plain_kernels(attention_ops, stem_ops):
            out_p = step()
    # absolute tolerances: the paths differ only by the stem's and attention's
    # summation order; heatmaps (|h| < 1 here) feed soft-argmax at x1000,
    # whose coordinates are pixels of the 256^2 crop
    path_tols = {"heatmap": 1e-4, "joints_crop_img": 5e-2, "joints_cam": 1e-4}
    for key, tol in path_tols.items():
        err = max_err(out_k[key], out_p[key])
        print(f"fp32 kernel path vs plain path {key}: max_abs_err={err:.3e} "
              f"(max|plain|={float(out_p[key].abs().max()):.3e}) tol={tol:.1e}", flush=True)
        if not err <= tol:
            fail(f"fp32 kernel path disagrees with the plain path on {key}: {err} > {tol}")
    # The kernels end before the mesh stage, so joints_cam decides this
    # comparison. The vertices are printed, not judged: the random-weight
    # model's joints lie within ~0.02 mm of each other, where the IK turns a
    # joint difference d into a vertex difference of up to ~1e5 d; the mesh
    # stage itself is held card against CPU above.
    err = max_err(out_k["vertices"], out_p["vertices"])
    print(f"fp32 kernel path vs plain path vertices: max_abs_err={err:.3e} mm "
          f"(max|plain|={float(out_p['vertices'].abs().max()):.1f} mm), not judged", flush=True)

    # 6. the training path at the release recipe
    train_attn = {d: check_attention(attention_ops, d, gen, TRAIN_ATTN_SHAPES, TRAIN_ATTN_BATCH)
                  for d in DTYPES.values()}
    train_stem = {d: check_stem(stem_ops, d, gen, TRAIN_STEM_SHAPE) for d in DTYPES.values()}
    attn_bwd = {d: check_attention_backward(attention_ops, d, gen) for d in DTYPES.values()}
    stem_bwd = {d: check_stem_backward(stem_ops, d, gen) for d in DTYPES.values()}
    train = {DTYPES[name]: train_run(attention_ops, stem_ops, name) for name in DTYPES}
    train_kernel_vs_plain(attention_ops, stem_ops)

    # 7. the record
    def times(t: dict) -> dict:
        return {"ms": t["kernel"]["device"], "plain_ms": t["plain"]["device"],
                "library_ms": t["library"]["device"], "eager_ms": t["kernel"]["eager"],
                "plain_eager_ms": t["plain"]["eager"], "library_eager_ms": t["library"]["eager"]}

    def attention_record(dtype, rows, calls, n_launches, per, **extra) -> dict:
        # the calls of one forward: sums of the per-call times and of the work
        per_call = {s: times(rows[s]["t"]) for s in calls}
        summed = {key: sum(n * per_call[s][key] for s, n in calls.items())
                  for key in per_call[next(iter(calls))]}
        work = {key: sum(n * rows[s][key] for s, n in calls.items()) for key in ("flops", "bytes")}
        bound, by = bound_ms(work["flops"], work["bytes"], dtype)
        return {"name": f"fused_attention[{str(dtype).removeprefix('torch.')}]{per[0]}",
                "route": "cuda", "source": "handmvnet_tpu_torch/csrc/attention.cu",
                "replaces": "handmvnet_tpu/ops/pallas/attention.py:69",
                "launches": n_launches, "max_abs_err": max(r["err"] for r in rows.values()),
                **summed, "bound_ms": bound, "bound_by": by, "per": per[1], **extra}

    def stem_record(dtype, r, n_launches, per, **extra) -> dict:
        return {"name": f"stem_conv[{str(dtype).removeprefix('torch.')}]{per[0]}",
                "route": "cuda", "source": "handmvnet_tpu_torch/csrc/stem.cu",
                "replaces": "handmvnet_tpu/ops/pallas/stem.py:120",
                "launches": n_launches, "max_abs_err": r["err"], **times(r["t"]),
                "bound_ms": r["bound"], "bound_by": r["bound_by"], "per": per[1], **extra}

    kernels = []
    for dtype in DTYPES.values():
        kernels.append(attention_record(
            dtype, attn[dtype], ATTN_CALLS, launches[dtype][0],
            ("", "forward: (168,168) x2 + (21,147) + (21,21) x2")))
    for dtype in DTYPES.values():
        kernels.append(stem_record(dtype, stem[dtype], launches[dtype][1],
                                   ("", "forward: x [8, 3, 256, 256]")))
    for dtype in DTYPES.values():
        kernels.append(attention_record(
            dtype, train_attn[dtype], TRAIN_ATTN_CALLS, train[dtype]["launches"][0],
            ("/train", "microbatch forward at batch 8: (105,105) x2 + (21,84) + (21,21) x2"),
            backward="PyTorch ops (ops/attention.py::attention_backward)",
            backward_ms=attn_bwd[dtype]["ms"], backward_max_abs_err=attn_bwd[dtype]["err"]))
    for dtype in DTYPES.values():
        kernels.append(stem_record(
            dtype, train_stem[dtype], train[dtype]["launches"][1],
            ("/train", "microbatch forward: x [40, 3, 256, 256]"),
            backward="torch.nn.grad.conv2d_weight", backward_ms=stem_bwd[dtype]["ms"],
            backward_max_abs_err=stem_bwd[dtype]["err"]))
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
