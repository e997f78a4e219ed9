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
     timed optimizer steps on one synthetic batch (every view at the root
     camera's pose: see train_run) with the counters set to 0
     just before and read just after: K1 must launch 10 times a step and K2
     twice, the loss must be finite at every step and lower at the end;
     ms a step, samples/s, peak memory and the device ops of one
     microbatch's forward and backward; then one fp32 step of the kernel
     path against the plain path from the same weights and batch (dropout 0):
     loss terms rel 1e-4, global gradient norm rel 1e-3 (judged with the
     heatmap head scaled so that the soft-argmax is not saturated, printed
     without it);
  7. the HRNet model of the HR release configs (configs/release/*_HR*.yaml,
     HRNet w40, whose stem is two 3x3 convs: K2 is off its path): the
     eval_fps protocol on the HO3D HR config with the mesh stage in fp32 and
     bf16, the counters set to 0 just before and read just after (K1 5
     launches a forward, K2 none; outputs, vertices among them, finite
     fp32 of the expected shapes on the card); the fp32 kernel path against
     the plain path (phase 5's tolerances); then the HR release recipe's
     training (batch 16 x 5 views, accumulation 2), 3 warmup and 20 timed
     optimizer steps per dtype (K1 10 launches a step, K2 none, a finite
     falling loss) and one fp32 step of the kernel path against the plain
     path (phase 6's tolerances and scaled-head rule);
  8. the data path and eval.py on tar shards in the config's layout: the
     JPEG decoder (nvJPEG) against the shipped fixture's libjpeg pixels at
     one frame and at the eval batch's 80, and its time a frame and a KB
     on the fixture (a smooth frame, 27 KB) and on a batch of the smoke
     shards' noise frames (~170 KB), so that it scales to real frames;
     HO3D-layout shards written on the
     card (write_synthetic_ho3d_shards, 5 views of 480 x 640, coherent
     geometry; 9 train shards, of which val reads two, and 3 test shards);
     one val batch through make_device_prepare on the card against the CPU
     on the same decoded frames; K1 at the eval shapes (batch 16 x 5 views)
     and K2 at 80 images, against their plain versions and timed; eval.py on
     a reference-layout checkpoint (random weights, ``model.`` prefix and
     the legacy ``pose_net.conv.`` keys) for the ResNet and the HR release
     configs in fp32, the counters set to 0 just before and read just after
     (K1 5 launches a forward, K2 1 on ResNet and 0 on HR), val.json and
     test.json with every metric finite, vertex metrics included (the
     synthetic MANO model); one eval batch's forward, kernel path against
     plain path (phase 5's tolerances); samples/s of the loader with its
     preprocessing alone, of the whole eval loop, and of the eval forward on
     a synthetic batch of the same shape, for both models;
  9. training on shards (train.py's data path): 9 HO3D-layout train shards
     of 16 samples written on the card (the release configs' train split
     reads all 9, add_val_to_train: 144 samples, 9 steps of 16; val the
     first and the last); one train batch's 80 crops through the
     augmentation at fixed draws, card against CPU (2e-4 but for posterize
     flips of 4/255 on at most 1e-4 of the elements), then from a
     generator on the card under the sync debug mode "error", its device
     ms and launches; the train loader alone (resampled stream, nvJPEG,
     crops, augmentation, heatmaps on its preparer stage) in samples/s;
     train.main on the HO3D release config, 2 epochs in fp32 and in bf16,
     once more in fp32 with the preparer stage off (device_prefetch=False)
     and once with --resume for a third epoch, the counters set to 0 just
     before and read just after each run: K1 10 and K2 2 launches every
     optimizer step, 5 and 1 a validation forward, every logged value
     finite; ms a step from CUDA events between consecutive steps, against
     phase 6's synthetic step; one fp32 step of the kernel path against the
     plain path on an augmented shard batch (phase 6's limits); train.main
     on the HR config, one epoch of 2 steps (K1 10 a step, K2 none);
 10. a {"kernels": [...]} line (the HR rows carry K1's launches on the HR
     paths, the /eval rows the launches of phase 8's eval runs, the
     /train_shards rows phase 9's), then the {"ok": true, ...} line last.
Each phase prints its seconds.

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
HR_CONFIG = REPO / "configs" / "release" / "HO3D_HandMvNet_HR.yaml"
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
# eval (phase 8): the reference eval.py's batch 16 x 5 views of 256^2
EVAL_BATCH, EVAL_VIEWS = 16, 5
EVAL_STEM_SHAPE = (EVAL_BATCH * EVAL_VIEWS, 256, 256)
SHARD_SAMPLES = 4  # samples a smoke shard: val reads 2 shards (8), test 3 (12)
THROUGHPUT_BATCHES = 24  # over the 12 test samples, resampled
# card against CPU on the same frames: tests/test_torch_data.py's CPU-vs-JAX limits
PREP_ATOL = {"rgb": 1e-5, "heatmap": 1e-6}
# kernel path against plain path of an eval forward (phase 5's serving limits)
PATH_TOLS = {"heatmap": 1e-4, "joints_crop_img": 5e-2, "joints_cam": 1e-4}
# training on shards (phase 9): 9 train shards of 16 samples, all of which the
# release configs' train split reads (add_val_to_train), so 144 samples, 9 steps
# of 16 an epoch; val reads the first and the last shard, 2 batches
SHARD_TRAIN_SAMPLES, SHARD_EPOCHS = 16, 2
# augmentation card against CPU at the same draws (tests/test_torch_augment.py's
# chain rule at 256^2): the box blur's cumsums round in other orders, 4 S eps / w
# = 6.1e-5 at S = 256 and w >= 2 (a blur of k >= 3 crop px at a magnification
# >= 0.5), and the 2x sharpening (2 img - smooth) triples that: 2e-4; elsewhere
# posterize flips, each exactly 4/255 (to that limit), on at most 1e-4 of the
# elements
AUG_ATOL, AUG_FLIP_SHARE = 2e-4, 1e-4
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


def train_config(dtype_name: str, config: Path = CONFIG):
    from handmvnet_tpu_torch.config import Config

    cfg = Config.from_yaml(config)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype=dtype_name))


def train_run(attention_ops, stem_ops, dtype_name: str, config: Path = CONFIG,
              stem_per_step: int = 2) -> dict:
    """The training path at the config's release recipe: TRAIN_WARMUP +
    TRAIN_ITERS optimizer steps of the train step on one fixed synthetic
    batch, the launch counters set to 0 just before and read just after; K1
    must launch 10 times a step and K2 ``stem_per_step`` times.

    Every view sits at the root camera's pose, as in ``train_kernel_vs_plain``;
    the work is the same. The synthetic batch's random camera rotations put
    some predicted joints within millimetres of a camera plane, where the
    g2d/p2d reprojection terms jump by thousands between steps, so "lower at
    the end" read those jumps. On an H100 the HRNet model's fp32 loss went
    3187 -> 3435 in 23 steps with jumps to 11622 and 36911, and the ResNet
    model's, in one run of several, 5448 -> 6576; with the cameras aligned
    the HRNet loss fell at every step but two (520.7 -> 424.7)."""
    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.train import accumulation
    from handmvnet_tpu_torch.train_step import (
        batch_to_device, build_model, create_train_state, forward_loss, train_step)

    cfg = train_config(dtype_name, config)
    label = f"{config.stem} training {dtype_name}"
    accum = accumulation(cfg)
    state = create_train_state(build_model(cfg, "cuda", seed=0), cfg,
                               steps_per_epoch=cfg.data.split_size("train") // TRAIN_BATCH)
    data = synthetic_batch(TRAIN_BATCH, TRAIN_VIEWS, cfg.data.image_size, cfg.data.heatmap_size,
                           seed=0)
    data["extrinsic"][:] = np.eye(4, dtype=np.float32)
    batch = batch_to_device(data, "cuda")
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

    print(f"{label}: batch {TRAIN_BATCH} x {TRAIN_VIEWS} views, accumulation "
          f"{accum}: ms_per_step={ms:.3f} samples_per_s={TRAIN_BATCH / ms * 1e3:.2f} "
          f"images_per_s={TRAIN_BATCH * TRAIN_VIEWS / ms * 1e3:.2f} peak_memory_gb={peak_gb:.3f} "
          f"launches K1={launches[0]} K2={launches[1]} in {steps} steps", flush=True)
    print(f"   loss by step: {[round(v, 3) for v in curve]}", flush=True)
    want = (10 * steps, stem_per_step * steps)
    if launches != want:
        fail(f"{label}: kernel launches {launches}, expected {want} "
             f"(10 and {stem_per_step} per optimizer step)")
    if not all(math.isfinite(v) for v in curve) or not curve[-1] < curve[0]:
        fail(f"{label}: the loss is not finite or did not fall: {curve}")

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


def train_kernel_vs_plain(attention_ops, stem_ops, config: Path = CONFIG,
                          batch: dict | None = None, what: str = "a synthetic batch") -> None:
    """One fp32 optimizer step (accumulation 2) of the kernel path and of the
    plain path from the same weights and batch (by default a synthetic batch,
    every view at the root camera's pose), dropout 0: loss terms rel 1e-4,
    global gradient norm before clipping rel 1e-3, the largest per-leaf
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

    cfg = train_config("float32", config)
    if batch is None:
        data = synthetic_batch(TRAIN_BATCH, TRAIN_VIEWS, cfg.data.image_size,
                               cfg.data.heatmap_size, seed=1)
        # The synthetic batch's random camera rotations put some joints of
        # other views within millimetres of the camera plane, where the
        # g2d/p2d projection turns rounding into pixels (g2d ~3000 px a
        # joint). With every view at the root camera's pose each joint
        # projects from ~0.5 m, and the loss terms measure the two paths, not
        # the pole.
        data["extrinsic"][:] = np.eye(4, dtype=np.float32)
        batch = batch_to_device(data, "cuda")
    bad = []
    for head_scale in (1.0, 1e-3):
        results = []
        for path in ("kernel", "plain"):
            model = build_model(cfg, "cuda", seed=1, dropout=0.0)
            # the heatmap head's last conv (HRNet's head is that one conv)
            head = model.pose_net[-1] if isinstance(model.pose_net, torch.nn.Sequential) \
                else model.pose_net
            with torch.no_grad():
                for p in head.parameters():
                    p.mul_(head_scale)
            state = create_train_state(model, cfg, 1000)
            with plain_kernels(attention_ops, stem_ops) if path == "plain" \
                    else contextlib.nullcontext():
                losses = accumulate_grads(state, cfg, batch, None, accumulation(cfg))
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
            norm = optimizer_step(state, cfg)
            results.append(({k: float(v) for k, v in losses.items()}, grads, float(norm)))
        (lk, gk, nk), (lp, gp, norm_p) = results
        label = (f"{config.stem} train fp32 on {what}, kernel path vs plain path, "
                 f"head x{head_scale:g}")
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
        fail(f"{config.stem} training: the kernel path disagrees with the plain path: {bad}")
    print("   conv1.weight and every to_q/to_k/to_v weight have non-zero gradients", flush=True)


def serve(attention_ops, stem_ops, cfg, label: str, dtype_name: str, with_vertices: bool,
          stem_per_forward: int):
    """The eval_fps protocol (b1 x v8 x 256^2, WARMUP + 2 x ITERS forwards)
    with the launch counters set to 0 just before and read just after: K1
    must launch 5 times a forward and K2 ``stem_per_forward`` times; the
    outputs must be fp32, finite, on the card and of the expected shapes.
    Returns (launches, outputs of the last step)."""
    from handmvnet_tpu_torch.eval_fps import run_protocol

    attention_ops.fused_attention.launches = 0
    stem_ops.stem_conv_nchw.launches = 0
    stats, out = run_protocol(cfg, views=8, dtype=DTYPES[dtype_name], warmup=WARMUP, iters=ITERS,
                              device="cuda", seed=0, with_vertices=with_vertices)
    torch.cuda.synchronize()
    got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    want = (5 * stats["forwards"], stem_per_forward * stats["forwards"])
    step = "forward + mesh stage" if with_vertices else "forward only (--no-vertices)"
    print(f"{label} {dtype_name} {step}: fps={stats['fps']:.2f} p50_ms={stats['p50_ms']:.4f} "
          f"mean_ms={stats['mean_ms']:.4f} forwards={stats['forwards']} "
          f"launches K1={got[0]} K2={got[1]}", flush=True)
    if got != want:
        fail(f"{label} {dtype_name} {step}: kernel launches {got}, expected {want} "
             f"(5 and {stem_per_forward} per forward)")
    shapes = {"joints_cam": (1, 21, 3), "joints_crop_img": (1, 8, 21, 2),
              "heatmap": (1, 8, 21, 32, 32)}
    if with_vertices:
        shapes["vertices"] = (1, 778, 3)
    elif "vertices" in out:
        fail(f"{label} {dtype_name}: --no-vertices returned vertices")
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape or out[key].dtype != torch.float32:
            fail(f"{label} {dtype_name}: {key} is {tuple(out[key].shape)} {out[key].dtype}")
        if out[key].device.type != "cuda" or not torch.isfinite(out[key]).all():
            fail(f"{label} {dtype_name}: {key} is not finite on the card ({out[key].device})")
    return got, out


def compare_paths(out_k: dict, out_p: dict, label: str) -> None:
    """The fp32 kernel path's outputs against the plain path's, PATH_TOLS:
    absolute, as the paths differ only by the stem's and attention's
    summation order; heatmaps (|h| < 1 here) feed soft-argmax at x1000,
    whose coordinates are pixels of the 256^2 crop."""
    for key, tol in PATH_TOLS.items():
        err = max_err(out_k[key], out_p[key])
        print(f"{label} fp32 kernel path vs plain path {key}: max_abs_err={err:.3e} "
              f"(max|plain|={float(out_p[key].abs().max()):.3e}) tol={tol:.1e}", flush=True)
        if not err <= tol:
            fail(f"{label}: fp32 kernel path disagrees with the plain path on {key}: "
                 f"{err} > {tol}")


def serve_kernel_vs_plain(attention_ops, stem_ops, cfg, label: str) -> None:
    """The fp32 kernel path against the plain path on the card, same weights."""
    from handmvnet_tpu_torch.eval_fps import protocol_step

    step = protocol_step(cfg, views=8, dtype=torch.float32, device="cuda", seed=0)
    with torch.inference_mode():
        out_k = step()
        with plain_kernels(attention_ops, stem_ops):
            out_p = step()
    compare_paths(out_k, out_p, label)
    # The kernels end before the mesh stage, so joints_cam decides this
    # comparison. The vertices are printed, not judged: the random-weight
    # model's joints lie within ~0.02 mm of each other, where the IK turns a
    # joint difference d into a vertex difference of up to ~1e5 d; the mesh
    # stage itself is held card against CPU in phase 5.
    err = max_err(out_k["vertices"], out_p["vertices"])
    print(f"{label} fp32 kernel path vs plain path vertices: max_abs_err={err:.3e} mm "
          f"(max|plain|={float(out_p['vertices'].abs().max()):.1f} mm), not judged", flush=True)


def write_eval_config(src: Path, out_dir: Path, shard_dir: Path, mano: Path,
                      sizes: dict | None = None, compute_dtype: str = "float32") -> Path:
    """A copy of a release config whose dataset_dir is the smoke shards, with
    the split sizes at their sample counts (``sizes``; by default phase 8's:
    HO3D's hard-coded 1369 and 2706 would cycle the few samples for 85 and
    169 batches), the synthetic MANO model for the vertex metrics and the
    training's compute dtype."""
    sizes = sizes or {"val": 2 * SHARD_SAMPLES, "test": 3 * SHARD_SAMPLES}
    text = src.read_text()
    text, n_data = re.subn(r"(?m)^  dataset_dir: .*$", (
        f"  dataset_dir: {shard_dir}\n  split_size_overrides:\n"
        + "\n".join(f"    {k}: {v}" for k, v in sizes.items())), text)
    text, n_mano = re.subn(r"(?m)^  mano_models_dir: .*$", f"  mano_models_dir: {mano}", text)
    text, n_train = re.subn(r"(?m)^train:$", f"train:\n  compute_dtype: {compute_dtype}", text)
    if (n_data, n_mano, n_train) != (1, 1, 1):
        fail(f"{src.name}: no dataset_dir, mano_models_dir or train: line to point at the "
             "smoke data")
    path = out_dir / f"{src.stem}_{compute_dtype}.yaml"
    path.write_text(text)
    return path


def write_reference_checkpoint(cfg, path: Path) -> None:
    """Random weights (eval_fps.random_state_dict) as the reference's old
    checkpoints name them: a Lightning ``model.`` prefix, ``pose_net.conv.``
    and, with one SampleNet, ``sample_net.``, so that eval.py's remaps run."""
    from handmvnet_tpu_torch.eval_fps import build_model, random_state_dict

    model = build_model(cfg, views=cfg.model.num_views, image_size=cfg.data.image_size,
                        device="cpu")
    state = random_state_dict(model, seed=0)
    single = not any(k.startswith("sample_nets.1.") for k in state)
    legacy = {}
    for key, value in state.items():
        if key.startswith("pose_net."):
            key = "pose_net.conv." + key[len("pose_net."):]
        elif single and key.startswith("sample_nets.0."):
            key = "sample_net." + key[len("sample_nets.0."):]
        legacy["model." + key] = value
    torch.save(legacy, path)


def decode_timed(payloads: list[bytes], what: str, card_line: str) -> torch.Tensor:
    """nvJPEG's decode of a batch, timed over 5 calls after one; prints ms
    a batch, a frame and a KB of JPEG (its time grows with the coded size,
    so a KB is what carries over to frames of other content)."""
    from handmvnet_tpu_torch.data.jpeg import decode_jpeg

    decode_jpeg(payloads, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        frames = decode_jpeg(payloads, "cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    kb = sum(map(len, payloads)) / 1e3
    print(f"nvJPEG decode of {what} ({len(payloads)} frames of 480 x 640, "
          f"{kb / len(payloads):.1f} KB each): {ms:.3f} ms, {ms / len(payloads):.4f} ms a frame, "
          f"{ms / kb * 1e3:.3f} us a KB; {card_line}", flush=True)
    return frames


def data_path_check(cfg, card_line: str) -> None:
    """One val batch (EVAL_BATCH samples, JPEG bytes) through
    make_device_prepare on the card, and through it on the CPU with the
    frames the card decoded (the decoders are compared on the fixture);
    also the decode's time on those frames."""
    from handmvnet_tpu_torch.data.ho3d import HO3DDataset
    from handmvnet_tpu_torch.data.loader import BatchLoader
    from handmvnet_tpu_torch.train import make_device_prepare

    batch = next(iter(BatchLoader(HO3DDataset(cfg.data, "val", device="cuda"), EVAL_BATCH, 1)))
    flat = [p for views in batch["full_jpeg"] for p in views]
    frames = decode_timed(flat, "one eval batch of the smoke shards", card_line)
    cpu_batch = {k: v for k, v in batch.items() if k != "full_jpeg"}
    cpu_batch["full_rgb"] = frames.cpu().numpy().reshape(EVAL_BATCH, -1, *frames.shape[1:])
    got = make_device_prepare(cfg, "cuda")(batch)
    ref = make_device_prepare(cfg, "cpu")(cpu_batch)
    if set(got) != set(ref):
        fail(f"make_device_prepare: keys {sorted(got)} on the card, {sorted(ref)} on the CPU")
    for key, value in ref.items():
        err = max_err(got[key].cpu(), value)
        tol = PREP_ATOL.get(key, 0.0)
        if key in PREP_ATOL:
            print(f"data path card vs CPU {key} {tuple(value.shape)}: max_abs_err={err:.3e} "
                  f"tol={tol:.0e}", flush=True)
        if got[key].device.type != "cuda" or got[key].dtype != value.dtype or not err <= tol:
            fail(f"make_device_prepare on the card disagrees with the CPU on {key}: {err}")
    print(f"   labels exact; heatmap max {float(ref['heatmap'].max()):.3f}", flush=True)


def eval_run(attention_ops, stem_ops, config: Path, ckpt: Path, label: str,
             stem_per_forward: int) -> tuple[int, int]:
    """eval.py on the card in fp32 (val, then test), the counters set to 0
    just before and read just after: K1 5 launches a forward, K2
    ``stem_per_forward``; val.json and test.json beside the checkpoint with
    every metric finite, vertex metrics included."""
    from handmvnet_tpu_torch import eval as port_eval
    from handmvnet_tpu_torch.config import Config

    cfg = Config.from_yaml(config)
    forwards = sum(max(1, cfg.data.split_size(s) // EVAL_BATCH) for s in ("val", "test"))
    attention_ops.fused_attention.launches = 0
    stem_ops.stem_conv_nchw.launches = 0
    t0 = time.perf_counter()
    results = port_eval.main(["--config", str(config), "--checkpoint", str(ckpt)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    print(f"{label} eval.py fp32: {forwards} forwards of {EVAL_BATCH} x {EVAL_VIEWS} views in "
          f"{secs:.2f} s (load and first calls included), launches K1={got[0]} K2={got[1]}",
          flush=True)
    if got != (5 * forwards, stem_per_forward * forwards):
        fail(f"{label} eval: kernel launches {got}, expected 5 and {stem_per_forward} per "
             f"forward over {forwards} forwards")
    for mode in ("val", "test"):
        written = json.loads((ckpt.parent / f"{mode}.json").read_text())[0]
        values = np.concatenate([np.ravel(v) for v in written.values()])
        print(f"   {mode}.json: " + ", ".join(f"{k}={v:.4f}" for k, v in written.items()
                                              if not isinstance(v, list)), flush=True)
        if written != results[mode] or f"{mode}_mpvpe" not in written:
            fail(f"{label} eval: {mode}.json lacks the vertex metrics or differs from the run")
        if not np.isfinite(values).all():
            fail(f"{label} eval: {mode}.json has a metric that is not finite: {written}")
    return got


def eval_kernel_vs_plain(attention_ops, stem_ops, config: Path, ckpt: Path, label: str) -> None:
    """One prepared val batch through the eval forward, kernel path against
    plain path, same weights (PATH_TOLS)."""
    import dataclasses as dc

    from handmvnet_tpu_torch.checkpoint import load_torch_checkpoint
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.eval_fps import build_model
    from handmvnet_tpu_torch.train import build_dataloaders
    from handmvnet_tpu_torch.train_step import eval_step

    cfg = Config.from_yaml(config)
    cfg = dc.replace(cfg, data=dc.replace(cfg.data, batch_size=EVAL_BATCH))
    model = build_model(cfg, views=EVAL_VIEWS, device="cpu")
    load_torch_checkpoint(ckpt, model)
    model = model.cuda()
    val, _ = build_dataloaders(cfg, "cuda")
    batch = next(iter(val))
    out_k = eval_step(model, batch)
    with plain_kernels(attention_ops, stem_ops):
        out_p = eval_step(model, batch)
    compare_paths(out_k, out_p, f"{label} eval batch")


def eval_throughput(config: Path, label: str, card_line: str) -> dict:
    """samples/s, fp32, batch 16 x 5 views: the test loader with its
    preparation alone (tar read, nvJPEG, crops and heatmaps), the whole eval
    loop (the same and engine.evaluate's forward, mesh stage and metrics),
    and the eval forward alone on a synthetic batch of the same shape."""
    import dataclasses as dc

    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.ho3d import HO3DDataset
    from handmvnet_tpu_torch.data.loader import BatchLoader
    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.engine import evaluate, make_vertices_fn
    from handmvnet_tpu_torch.eval_fps import build_model
    from handmvnet_tpu_torch.train import make_device_prepare
    from handmvnet_tpu_torch.train_step import batch_to_device, eval_step

    cfg = Config.from_yaml(config)
    cfg = dc.replace(cfg, data=dc.replace(cfg.data, batch_size=EVAL_BATCH))

    def loader(steps: int) -> BatchLoader:
        return BatchLoader(HO3DDataset(cfg.data, "test", device="cuda"), EVAL_BATCH, steps,
                           device_prepare=make_device_prepare(cfg, "cuda"), device="cuda")

    samples = THROUGHPUT_BATCHES * EVAL_BATCH
    list(loader(1))  # first calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in loader(THROUGHPUT_BATCHES):
        pass
    torch.cuda.synchronize()
    loader_sps = samples / (time.perf_counter() - t0)

    model = build_model(cfg, views=EVAL_VIEWS, device="cuda")
    vertices_fn = make_vertices_fn(cfg, "cuda")
    evaluate(model, loader(1), cfg, "test", vertices_fn)  # first calls
    t0 = time.perf_counter()
    evaluate(model, loader(THROUGHPUT_BATCHES), cfg, "test", vertices_fn)  # ends in a host read
    eval_sps = samples / (time.perf_counter() - t0)

    batch = batch_to_device(synthetic_batch(EVAL_BATCH, EVAL_VIEWS, with_heatmaps=False), "cuda")
    for _ in range(3):
        eval_step(model, batch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        eval_step(model, batch)
    end.record()
    end.synchronize()
    fwd_ms = start.elapsed_time(end) / 10
    print(f"{label} eval throughput fp32, batch {EVAL_BATCH} x {EVAL_VIEWS} views, "
          f"{THROUGHPUT_BATCHES} batches: loader + preprocess alone {loader_sps:.2f} samples/s; "
          f"whole eval loop {eval_sps:.2f} samples/s; eval forward alone {fwd_ms:.3f} ms, "
          f"{EVAL_BATCH / fwd_ms * 1e3:.2f} samples/s; {card_line}", flush=True)
    return {"loader_sps": loader_sps, "eval_sps": eval_sps, "forward_ms": fwd_ms}


def data_and_eval_phase(attention_ops, stem_ops, gen, card_line: str) -> dict:
    """Phase 8 (see the module docstring). Returns the kernel rows' inputs."""
    import tempfile

    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data import jpeg
    from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards
    from handmvnet_tpu_torch.models.mano import synthetic_mano_model

    print(f"JPEG decoder on the card: nvJPEG (CUDA toolkit; backend {jpeg.NVJPEG_BACKEND}, "
          "GPU_HYBRID), chosen because the card has no libjpeg for native/libtario.so and "
          "no jpeglib.h to build it", flush=True)
    payload, ref = jpeg.jpeg_fixture()
    for n in (1, EVAL_BATCH * EVAL_VIEWS):
        out = jpeg.decode_jpeg([payload] * n, "cuda").cpu().numpy().astype(np.int16)
        diff = np.abs(out - ref[None])
        print(f"nvJPEG vs libjpeg (cv2) on the fixture, batch {n}: max_abs={int(diff.max())} "
              f"(limit {jpeg.NVJPEG_MAX_ABS_DIFF}) mean_abs={diff.mean():.4f} "
              f"(limit {jpeg.NVJPEG_MEAN_ABS_DIFF})", flush=True)
        if not (diff.max() <= jpeg.NVJPEG_MAX_ABS_DIFF
                and diff.mean() <= jpeg.NVJPEG_MEAN_ABS_DIFF):
            fail(f"nvJPEG's decode of the fixture is off libjpeg's pixels at batch {n}")
    decode_timed([payload] * (EVAL_BATCH * EVAL_VIEWS), "the fixture", card_line)

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        for split, shards in (("train", 9), ("test", 3)):
            write_synthetic_ho3d_shards(tmp / "data", num_shards=shards,
                                        samples_per_shard=SHARD_SAMPLES, num_views=EVAL_VIEWS,
                                        split=split, seed=len(split),
                                        consistent_geometry=True, device="cuda")
        mano = synthetic_mano_model()
        np.savez(tmp / "MANO_RIGHT.npz", v_template=mano.v_template, shapedirs=mano.shapedirs,
                 posedirs=mano.posedirs, J_regressor=mano.j_regressor,
                 weights=mano.lbs_weights, f=mano.faces, hands_mean=mano.hands_mean)
        print(f"wrote 12 HO3D-layout shards ({12 * SHARD_SAMPLES * EVAL_VIEWS} frames "
              f"encoded by nvJPEG) in {time.perf_counter() - t0:.2f} s", flush=True)

        rows = {}
        for label, src, stem_per_forward in (("ResNet", CONFIG, 1), ("HR", HR_CONFIG, 0)):
            run_dir = tmp / label
            run_dir.mkdir()
            config = write_eval_config(src, run_dir, tmp / "data", tmp / "MANO_RIGHT.npz")
            cfg = Config.from_yaml(config)
            if label == "ResNet":
                data_path_check(cfg, card_line)
            ckpt = run_dir / "reference.pth"
            write_reference_checkpoint(cfg, ckpt)
            rows[label] = {"launches": eval_run(attention_ops, stem_ops, config, ckpt, label,
                                                stem_per_forward)}
            eval_kernel_vs_plain(attention_ops, stem_ops, config, ckpt, label)
            rows[label].update(eval_throughput(config, label, card_line))

    # K1 at the eval shapes (batch 16, 5 views) and K2 at 80 images
    rows["attn"] = {d: check_attention(attention_ops, d, gen, TRAIN_ATTN_SHAPES, EVAL_BATCH)
                    for d in DTYPES.values()}
    rows["stem"] = {d: check_stem(stem_ops, d, gen, EVAL_STEM_SHAPE) for d in DTYPES.values()}
    return rows


def augmentation_check(cfg, card_line: str) -> None:
    """One train batch's crops (EVAL_BATCH x 5 views of the smoke shards at
    their own crop scales) through apply_augmentation at fixed draws, drawn
    once on the CPU and moved: card against CPU (AUG_ATOL, posterize flips
    of exactly 4/255 on at most AUG_FLIP_SHARE of the elements); then
    augment_batch from a generator on the card under the sync debug mode
    "error"; its device ms and launches (profiler) and host ms."""
    from handmvnet_tpu_torch.data import augment
    from handmvnet_tpu_torch.data.ho3d import HO3DDataset
    from handmvnet_tpu_torch.data.jpeg import decode_jpeg
    from handmvnet_tpu_torch.data.loader import BatchLoader
    from handmvnet_tpu_torch.ops.resize import crop_resize

    batch = next(iter(BatchLoader(HO3DDataset(cfg.data, "train", device="cuda"), EVAL_BATCH, 1)))
    frames = decode_jpeg([p for views in batch["full_jpeg"] for p in views], "cuda")
    boxes = torch.from_numpy(batch["bboxes"].reshape(-1, 4)).cuda()
    crops = crop_resize(frames, boxes, cfg.data.image_size)
    n = crops.shape[0]
    scales = cfg.data.image_size / torch.clamp(boxes[:, 2] - boxes[:, 0], min=1.0)
    draws = augment.draw_augmentation(n, torch.Generator().manual_seed(0), "cpu")
    ref = augment.apply_augmentation(crops.cpu(), draws, scales.cpu())
    got = augment.apply_augmentation(crops, {k: v.cuda() for k, v in draws.items()}, scales)
    diff = (got.cpu() - ref).abs()
    flips = diff > AUG_ATOL
    rest = float(diff[~flips].max())
    flip_err = float((diff[flips] - 4.0 / 255.0).abs().max()) if flips.any() else 0.0
    share = float(flips.float().mean())
    print(f"augmentation card vs CPU, {n} crops of {cfg.data.image_size}^2 at fixed draws "
          f"({int(draws['blur'].sum())} blurred, {int(draws['posterize'].sum())} posterized, "
          f"{int(draws['occlude'].sum())} occluded): max_abs_err={rest:.3e} (tol {AUG_ATOL:.0e}) "
          f"besides {int(flips.sum())} posterize flips (share {share:.2e}, limit "
          f"{AUG_FLIP_SHARE:.0e}; |flip - 4/255| <= {flip_err:.1e})", flush=True)
    if not (rest <= AUG_ATOL and flip_err <= AUG_ATOL and share <= AUG_FLIP_SHARE):
        fail("the augmentation on the card disagrees with the CPU")

    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        augment.augment_batch(crops, gen, scales)
    except RuntimeError as e:
        fail(f"the augmentation synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("augmentation under sync debug mode 'error': no synchronising call", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        augment.augment_batch(crops, gen, scales)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        augment.augment_batch(crops, gen, scales)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    nbytes = 2 * crops.numel() * crops.element_size()
    print(f"augmentation of {n} crops ({nbytes / 2e6:.1f} MB in): {len(kernels)} device ops, "
          f"{device_ms:.3f} device ms (profiler), {host_ms:.3f} ms of host launches; one "
          f"read and one write at HBM rate "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {card_line}", flush=True)


def train_loader_rate(cfg, eval_loader_sps: float, step_sps: float, card_line: str) -> None:
    """samples/s of the train loader alone (build_dataloaders: the resampled
    stream, nvJPEG, crops, augmentation, heatmaps, on the preparer stage)
    over THROUGHPUT_BATCHES batches after one."""
    from handmvnet_tpu_torch.train import build_dataloaders

    (loader,) = build_dataloaders(cfg, "cuda", ("train",))
    loader.steps_per_epoch = 1
    list(loader)  # first calls
    loader.steps_per_epoch = THROUGHPUT_BATCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in loader:
        pass
    torch.cuda.synchronize()
    sps = THROUGHPUT_BATCHES * EVAL_BATCH / (time.perf_counter() - t0)
    print(f"train loader with preparation and augmentation alone, batch {EVAL_BATCH} x "
          f"{EVAL_VIEWS} views, {THROUGHPUT_BATCHES} batches: {sps:.2f} samples/s (phase 8's "
          f"test loader without augmentation {eval_loader_sps:.2f}; phase 6's fp32 step "
          f"{step_sps:.2f}); {card_line}", flush=True)
    if tuple(batch["rgb"].shape) != (EVAL_BATCH, EVAL_VIEWS, 256, 256, 3):
        fail(f"train loader: rgb {tuple(batch['rgb'].shape)}")


def shard_train_run(attention_ops, stem_ops, config: Path, out_dir: Path, label: str,
                    args: list, stem_per_step: int, device_prefetch: bool = True) -> dict:
    """train.main on the smoke shards with the counters set to 0 just before
    and read just after: every optimizer step must launch K1 10 times and K2
    ``stem_per_step`` times, and the run in all 10 and 2 (or 0) a step plus 5
    and 1 (or 0) a validation forward; every logged value finite. ms a step
    is the mean gap between CUDA events recorded after consecutive steps of
    an epoch (the first step of each epoch, after validation, left out): the
    device's time per step, waits for data included. ``device_prefetch``
    False prepares each batch on the consumer's thread (this run is the one
    caller of that setting)."""
    import functools

    from handmvnet_tpu_torch import train as train_mod
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.loader import BatchLoader

    cfg = Config.from_yaml(config)
    spe = next((int(a) for a, b in zip(args[1:], args) if b == "--steps-per-epoch"),
               cfg.data.split_size("train") // cfg.data.batch_size)
    ends, per_step = [], []
    real_step = train_mod.train_step

    def timed_step(state, *a, **k):
        before = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
        out = real_step(state, *a, **k)
        per_step.append((attention_ops.fused_attention.launches - before[0],
                         stem_ops.stem_conv_nchw.launches - before[1]))
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    records_before = 0
    metrics = out_dir / "metrics.jsonl"
    if metrics.exists():
        records_before = len(metrics.read_text().splitlines())
    train_mod.train_step = timed_step
    if not device_prefetch:
        train_mod.BatchLoader = functools.partial(BatchLoader, device_prefetch=False)
    attention_ops.fused_attention.launches = 0
    stem_ops.stem_conv_nchw.launches = 0
    t0 = time.perf_counter()
    try:
        train_mod.main(["--config", str(config), "--output-dir", str(out_dir), *args])
    finally:
        train_mod.train_step = real_step
        train_mod.BatchLoader = BatchLoader
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    steps = len(ends)
    records = [json.loads(line) for line in metrics.read_text().splitlines()][records_before:]
    val_steps = max(1, cfg.data.split_size("val") // cfg.data.batch_size)
    val_forwards = (len(records) + 1) * val_steps  # each epoch's and the best's validation
    gaps = [a.elapsed_time(b) for e in range(0, steps, spe)
            for a, b in zip(ends[e:e + spe], ends[e + 1:e + spe])]
    ms = sum(gaps) / len(gaps)
    bs = cfg.data.batch_size
    print(f"{label}: {steps} steps of {bs} x {cfg.data.num_views} views in {len(records)} "
          f"epochs, {secs:.2f} s in all (build, validation, checkpoints included): "
          f"ms_per_step={ms:.3f} samples_per_s={bs / ms * 1e3:.2f} over {len(gaps)} gaps; "
          f"launches K1={got[0]} K2={got[1]}", flush=True)
    for r in records:
        print(f"   epoch {r['epoch']}: train/loss={r['train/loss']:.3f} "
              f"val_mpjpe={r['val_mpjpe']:.3f} lr={r['lr']:g}", flush=True)
    want_step = (10, stem_per_step)
    want = (10 * steps + 5 * val_forwards,
            stem_per_step * steps + stem_per_step // 2 * val_forwards)
    if any(d != want_step for d in per_step) or got != want:
        fail(f"{label}: kernel launches {got} (per step {sorted(set(per_step))}), expected "
             f"{want}: {want_step} a step and (5, {stem_per_step // 2}) a validation forward")
    values = [v for r in records for v in r.values() if isinstance(v, float)]
    if not records or not all(math.isfinite(v) for v in values):
        fail(f"{label}: a logged value is not finite: {records}")
    return {"ms": ms, "sps": bs / ms * 1e3, "launches": got, "steps": steps, "secs": secs,
            "records": records}


def shard_training_phase(attention_ops, stem_ops, train: dict, evals: dict,
                         card_line: str) -> dict:
    """Phase 9 (see the module docstring). Returns train.main's runs, with the
    launches of the kernel rows."""
    import tempfile

    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards
    from handmvnet_tpu_torch.models.mano import synthetic_mano_model
    from handmvnet_tpu_torch.train import build_dataloaders

    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_synthetic_ho3d_shards(tmp / "data", num_shards=9,
                                    samples_per_shard=SHARD_TRAIN_SAMPLES, num_views=EVAL_VIEWS,
                                    split="train", seed=9, consistent_geometry=True,
                                    device="cuda")
        mano = synthetic_mano_model()
        np.savez(tmp / "MANO_RIGHT.npz", v_template=mano.v_template, shapedirs=mano.shapedirs,
                 posedirs=mano.posedirs, J_regressor=mano.j_regressor,
                 weights=mano.lbs_weights, f=mano.faces, hands_mean=mano.hands_mean)
        n = 9 * SHARD_TRAIN_SAMPLES
        sizes = {"train+val": n, "val": 2 * SHARD_TRAIN_SAMPLES}
        print(f"wrote 9 HO3D-layout train shards ({n * EVAL_VIEWS} frames encoded by nvJPEG) "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        configs = {d: write_eval_config(CONFIG, tmp, tmp / "data", tmp / "MANO_RIGHT.npz",
                                        sizes, d) for d in DTYPES}
        cfg = Config.from_yaml(configs["float32"])

        augmentation_check(cfg, card_line)
        fp32_step_sps = TRAIN_BATCH / train[torch.float32]["ms"] * 1e3
        train_loader_rate(cfg, evals["ResNet"]["loader_sps"], fp32_step_sps, card_line)

        runs = {}
        epochs = ["--epochs", str(SHARD_EPOCHS)]
        for name in DTYPES:
            runs[name] = shard_train_run(attention_ops, stem_ops, configs[name], tmp / name,
                                         f"training on shards {name}", epochs, stem_per_step=2)
        runs["serial"] = shard_train_run(
            attention_ops, stem_ops, configs["float32"], tmp / "serial",
            "training on shards float32, device_prefetch=False", epochs, stem_per_step=2,
            device_prefetch=False)
        runs["resume"] = shard_train_run(
            attention_ops, stem_ops, configs["float32"], tmp / "float32",
            "training on shards float32, --resume for one more epoch",
            ["--epochs", str(SHARD_EPOCHS + 1), "--resume"], stem_per_step=2)
        spe = runs["float32"]["steps"] // SHARD_EPOCHS
        if runs["resume"]["steps"] != spe or [r["epoch"] for r in runs["resume"]["records"]] \
                != [SHARD_EPOCHS]:
            fail(f"--resume: {runs['resume']['steps']} steps, epochs "
                 f"{[r['epoch'] for r in runs['resume']['records']]}: expected one epoch of "
                 f"{spe} steps, epoch {SHARD_EPOCHS}")
        for name, dtype in DTYPES.items():
            synth = train[dtype]["ms"]
            print(f"training {name} on shards: {runs[name]['ms']:.3f} ms a step "
                  f"({runs[name]['sps']:.2f} samples/s) against phase 6's synthetic step "
                  f"{synth:.3f} ms ({TRAIN_BATCH / synth * 1e3:.2f} samples/s): ratio "
                  f"{runs[name]['ms'] / synth:.3f}; {card_line}", flush=True)
        print(f"training float32 on shards, preparer stage on / off: {runs['float32']['ms']:.3f}"
              f" / {runs['serial']['ms']:.3f} ms a step ({runs['float32']['sps']:.2f} / "
              f"{runs['serial']['sps']:.2f} samples/s)", flush=True)

        (train_loader,) = build_dataloaders(cfg, "cuda", ("train",))
        batch = next(iter(train_loader))
        train_kernel_vs_plain(attention_ops, stem_ops, configs["float32"], batch,
                              "an augmented shard batch")

        hr_config = write_eval_config(HR_CONFIG, tmp, tmp / "data", tmp / "MANO_RIGHT.npz",
                                      sizes, "float32")
        runs["hr"] = shard_train_run(attention_ops, stem_ops, hr_config, tmp / "hr",
                                     "HR training on shards float32",
                                     ["--epochs", "1", "--steps-per-epoch", "2"], stem_per_step=0)
    return runs


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA GPU only")
    if not (REPO / "handmvnet_tpu_torch").is_dir() or not CONFIG.exists():
        fail(f"run from a checkout of the repository ({REPO} lacks the port)")

    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.synthetic import synthetic_hand_joints
    from handmvnet_tpu_torch.eval_fps import build_mesh_stage
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
    t_start = t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"   {name}: {line.strip()}", flush=True)
    for name in _build.KERNELS:  # jpeg.cpp is host code over nvJPEG
        counts = tensor_core_counts(libs[name])
        for fn, c in counts.items():
            print(f"   {name}: {c} HMMA/HGMMA in {fn}", flush=True)
        for tag in MMA_KERNELS:
            if not any(c > 0 for fn, c in counts.items() if tag in fn):
                fail(f"{name}: no tensor-core instruction in its {tag} kernel ({counts})")

    # 3 + 4. each kernel against its plain version, and times
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    attn = {d: check_attention(attention_ops, d, gen) for d in DTYPES.values()}
    stem = {d: check_stem(stem_ops, d, gen) for d in DTYPES.values()}
    print(f"phases 3-4 (kernels): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 5. the main path, through the entry point a user calls
    t_phase = time.perf_counter()
    cfg = Config.from_yaml(CONFIG)
    launches, joints_cam = {}, {}
    for name, dtype in DTYPES.items():
        for with_vertices in (True, False):
            got, out = serve(attention_ops, stem_ops, cfg, "main path", name, with_vertices,
                             stem_per_forward=1)
            if with_vertices:
                launches[dtype] = got
                joints_cam[name] = out["joints_cam"]

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

    serve_kernel_vs_plain(attention_ops, stem_ops, cfg, "main path")
    print(f"phase 5 (main path): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 6. the training path at the release recipe
    t_phase = time.perf_counter()
    train_attn = {d: check_attention(attention_ops, d, gen, TRAIN_ATTN_SHAPES, TRAIN_ATTN_BATCH)
                  for d in DTYPES.values()}
    train_stem = {d: check_stem(stem_ops, d, gen, TRAIN_STEM_SHAPE) for d in DTYPES.values()}
    attn_bwd = {d: check_attention_backward(attention_ops, d, gen) for d in DTYPES.values()}
    stem_bwd = {d: check_stem_backward(stem_ops, d, gen) for d in DTYPES.values()}
    train = {DTYPES[name]: train_run(attention_ops, stem_ops, name) for name in DTYPES}
    train_kernel_vs_plain(attention_ops, stem_ops)
    print(f"phase 6 (training): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 7. the HRNet model: serving, then training (K2 is off this path)
    t_phase = time.perf_counter()
    hr_cfg = Config.from_yaml(HR_CONFIG)
    hr_launches = {dtype: serve(attention_ops, stem_ops, hr_cfg, "HR", name, True,
                                stem_per_forward=0)[0] for name, dtype in DTYPES.items()}
    serve_kernel_vs_plain(attention_ops, stem_ops, hr_cfg, "HR")
    hr_train = {DTYPES[name]: train_run(attention_ops, stem_ops, name, HR_CONFIG, stem_per_step=0)
                for name in DTYPES}
    train_kernel_vs_plain(attention_ops, stem_ops, HR_CONFIG)
    print(f"phase 7 (HRNet): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 8. the data path and eval.py on shards in the config's layout
    t_phase = time.perf_counter()
    evals = data_and_eval_phase(attention_ops, stem_ops, gen, card_line)
    print(f"phase 8 (data path and eval): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 9. training on shards: the train split's stream, augmentation, the preparer stage
    t_phase = time.perf_counter()
    shards = shard_training_phase(attention_ops, stem_ops, train, evals, card_line)
    print(f"phase 9 (training on shards): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 10. the record
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
    # the HR paths call K1 at the same shapes: their times are the rows above
    for dtype in DTYPES.values():
        kernels.append(attention_record(
            dtype, attn[dtype], ATTN_CALLS, hr_launches[dtype][0],
            ("/hr", "HRNet forward: (168,168) x2 + (21,147) + (21,21) x2")))
    for dtype in DTYPES.values():
        kernels.append(attention_record(
            dtype, train_attn[dtype], TRAIN_ATTN_CALLS, hr_train[dtype]["launches"][0],
            ("/hr_train", "HRNet microbatch forward at batch 8: (105,105) x2 + (21,84) + "
             "(21,21) x2"),
            backward="PyTorch ops (ops/attention.py::attention_backward)",
            backward_ms=attn_bwd[dtype]["ms"], backward_max_abs_err=attn_bwd[dtype]["err"]))
    # eval runs fp32: its rows carry the fp32 launches of phase 8's eval runs
    fp32 = torch.float32
    eval_calls = TRAIN_ATTN_CALLS  # the training microbatch's shapes, at batch 16
    kernels.append(attention_record(
        fp32, evals["attn"][fp32], eval_calls, evals["ResNet"]["launches"][0],
        ("/eval", "eval forward at batch 16 x 5 views: (105,105) x2 + (21,84) + (21,21) x2")))
    kernels.append(stem_record(fp32, evals["stem"][fp32], evals["ResNet"]["launches"][1],
                               ("/eval", "eval forward: x [80, 3, 256, 256]")))
    kernels.append(attention_record(
        fp32, evals["attn"][fp32], eval_calls, evals["HR"]["launches"][0],
        ("/eval_hr", "HRNet eval forward at batch 16 x 5 views: (105,105) x2 + (21,84) + "
         "(21,21) x2")))
    # phase 9's train.main runs (steps and validation forwards) at the training
    # microbatch's shapes: their times are the /train rows'
    for dtype in DTYPES.values():
        name = str(dtype).removeprefix("torch.")
        kernels.append(attention_record(
            dtype, train_attn[dtype], TRAIN_ATTN_CALLS, shards[name]["launches"][0],
            ("/train_shards", "train.py on shards: microbatch forward at batch 8 (validation "
             "at batch 16): (105,105) x2 + (21,84) + (21,21) x2"),
            backward="PyTorch ops (ops/attention.py::attention_backward)",
            backward_ms=attn_bwd[dtype]["ms"], backward_max_abs_err=attn_bwd[dtype]["err"]))
        kernels.append(stem_record(
            dtype, train_stem[dtype], shards[name]["launches"][1],
            ("/train_shards", "train.py on shards: microbatch forward x [40, 3, 256, 256] "
             "(validation [80, 3, 256, 256])"),
            backward="torch.nn.grad.conv2d_weight", backward_ms=stem_bwd[dtype]["ms"],
            backward_max_abs_err=stem_bwd[dtype]["err"]))
    kernels.append(attention_record(
        fp32, train_attn[fp32], TRAIN_ATTN_CALLS, shards["hr"]["launches"][0],
        ("/hr_train_shards", "HR train.py on shards: microbatch forward at batch 8 "
         "(validation at batch 16)"),
        backward="PyTorch ops (ops/attention.py::attention_backward)",
        backward_ms=attn_bwd[fp32]["ms"], backward_max_abs_err=attn_bwd[fp32]["err"]))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check", flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
