#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (handmvnet_tpu_torch) on one NVIDIA
Hopper GPU. Run from the repository root: ``python3 chip_smoke.py``.

Phases; any failure exits nonzero and prints no result:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from handmvnet_tpu_torch/csrc (nvcc, in parallel):
     K1's two designs, "key_split" (attention.cu) and "query_tiles"
     (attention_tiles.cu), and K2 (stem.cu, one design: a persistent
     implicit GEMM on wgmma); count the tensor-core instructions in each
     library's SASS (cuobjdump): K1's bf16 and fp32 (3xTF32) kernels must
     have mma.sync (HMMA) but the "query_tiles" bf16 kernel, which must have
     wgmma (HGMMA), as must both of K2's (bf16, and fp32 in 3xTF32);
  3. hold each kernel against its plain PyTorch version at the shapes of the
     b1 x v8 main path, fp32 and bf16, with the tolerance stated (K1: each
     design that takes the shape, called directly);
  4. time each kernel (K1: both designs), its plain version and one library
     call of the same function (used nowhere in the port), beside the card's
     bound; K1's rows are the design that ops/attention.attention_design
     picks; K2 prints its design, the copies it takes (TMA or its threads)
     and its share of the bound, here at x [8] and at its other main-path
     shapes in phases 6 (x [40]), 8 (x [80]) and 11 (x [5]), both dtypes. Every run below counts K1's launches by design from 0 with its
     other counts, and they must add up to K1's; where the run's batches are
     known (the serving protocol, training steps and validation, eval.py,
     infer.py, data-parallel ranks) they must be the rule's split, or the
     script fails;
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
     eval_fps protocol, cut to 20 warmup + 2 x 200 forwards, on the HO3D HR
     config with the mesh stage in fp32 and bf16, the counters set to 0 just before and read just after (K1 5
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
 10. data-parallel training (train_step's process-group path, parallel/):
     (a) two processes on the one card over gloo (NCCL refuses two ranks on
     one device), each on its half of a synthetic batch of 2 x 16 x 5 views
     at accumulation 2 from rank 0's broadcast weights (seed 1, head scaled,
     dropout 0), 1 warmup + 3 optimizer steps: K1 10 and K2 2 launches a step
     on each rank, one all-reduce a step, finite losses, parameters and
     BatchNorm statistics bitwise equal across ranks at the end, and the
     first step's all-reduced loss terms (rel 1e-4) and gradient norm (rel
     1e-3) against one process accumulating the same 4 microbatches; ms a
     step and the all-reduce's ms (a shared-card figure, not a scaling
     figure); (b) train.main through the env:// rendezvous at world size 1
     on NCCL, one epoch on phase 9's shards (phase 9's launch and finiteness
     checks), its ms a step against phase 9's one-process fp32 step and the
     all-reduce's ms;
 11. the user-facing drivers: the versions of cv2, matplotlib and
     tensorboard (their imports are lazy, and each may be absent); infer.py
     on the card in fp32 (prepare, infer_step, write_panels) with
     --synthetic on the HO3D release config and its HR config, and on phase
     8's test shards with phase 8's reference checkpoint, the counters set
     to 0 just before the step and read just after (K1 5 launches, K2 1 on
     ResNet and 0 on HR), outputs fp32, finite and of the expected shapes
     (vertices [1, 778, 3]), the kernel path against the plain path (phase
     5's tolerances), the step's device and wall ms, and the panels whose
     library is present, non-empty; train.main with the vis hook every epoch
     and train.num_devices 1 on phase 9's shards (1 epoch of 2 steps, fp32,
     no process group): phase 9's launch checks with the hook's two eval
     forwards (K1 5 and K2 1 each), vis/{train,val}/joints2d_0.png and
     projected_joints2d_0.png, tb/'s scalars equal to metrics.jsonl's where
     tensorboard is present, and the hook's ms; eval.main through the
     env:// rendezvous at world size 1 on NCCL on phase 8's shards and
     checkpoint, every metric within rel 1e-6 of phase 8's one-process eval;
     K1 at infer's shapes and K2 at x [5, 3, 256, 256] in fp32 and bf16,
     against their plain versions and timed;
 12. the serving structure, fp32 at full width with random weights (seed
     0): (a) export.main --device cuda --verify on the DexYCB release
     config (ResNet-50 "paper", its 8 views, b1 x 8 x 256^2), then
     load_bundle and 1 + 20 + 200 replays in a fresh process that imports
     no model code, the counters set to 0 just before and read just after
     (K1 5 launches a replay, K2 1); the replay's outputs against the live
     infer_step on the same weights and batch (phase 5's serving limits;
     the vertices within 2e-2 mm of the mesh stage on the replay's joints,
     and their difference from the live step's printed), the replay's p50
     beside the eager step's; (b) the same for a bundle exported with
     --device cpu and loaded onto the card, 1 + 2 + 10 replays; (c) the HO3D
     HR release config exported on the card and replayed 1 + 2 + 10 times
     (K1 5, K2 0); (d) view parallelism:
     a 1x1 grid through the env:// rendezvous at world size 1 on NCCL,
     bitwise equal to the plain forward, then a 1x2 grid of two processes
     sharing the card over gloo on the DexYCB config: each rank's K1 5 and
     K2 1 launches (x [4, 3, 256, 256]), the gathered outputs against the
     plain forward within JAX's view-parallel limits (heatmap 1e-5,
     joints_crop_img 1e-2 px, joints_cam 1e-4), joints_cam bitwise equal
     across the columns, the step's and the token all_gather's ms from
     CUDA events (a shared-card figure, not a scaling figure); (e) infer.py
     --view-mesh 1x1 (its steps, world size 1 on NCCL) on the HO3D release
     config with the drawable panels; the host time that the custom ops'
     dispatch adds to a launch (each op against its launch function);
 13. the rest of the model family, fp32 at full width with random weights:
     (a) the DexYCB release config (b1 x 8 x 256^2) with backbone_type each
     of 18, 34, 50, 101 and 152 at early_return 3 (the transposed-conv
     head): a short eval_fps protocol (10 + 2 x 50 steps, the mesh stage
     included), K1 5 and K2 1 launches a forward, the p50 and the forward's
     GFLOPs, the forward alone's device ms and ops (profiler) and
     CUDA-graph ms, and the kernel path against the plain path (phase
     5's serving limits); (b) the learnable-query fusion on the ResNet-50 "paper" model:
     the same protocol with K1 0 and K2 1 launches a forward (its attention
     is plain ops, D = 256), and the kernel path against the plain path;
     (c) the absolute-root branch: K1 against its plain version at the
     branch's shapes (V, V), (1, V-1) and (1, 1), at B = 1 (V = 8) and B = 8
     (V = 5), fp32 and bf16, and its backward at B = 8; two fp32 optimizer
     steps of the HO3D release recipe with train.root_relative off, the
     kernel path (K1 16 and K2 2 launches a step) against the plain path
     (phase 6's limits: loss terms rel 1e-4, the gradient norm rel 1e-3 with
     the heatmap head scaled by 1e-3 before each step, printed without it;
     deterministic algorithms, so every run compares the same states); a b1 x 8 serving
     forward of the DexYCB model with root_joint (K1 8, K2 1), its p50 and
     the kernel path against the plain path (root_joint 1e-4 m); (d)
     StackedHourglass and StackedBisectedHourglass at their defaults, one
     forward on the card against the CPU (no kernel; rel 1e-4 of max);
 14. geometry and tooling, the int8 serving path and remat, fp32 unless
     said: (a) the DLT, RANSAC and confidence-masked triangulations at B 16
     x V 8 x 21 joints on the card against the CPU (rel 1e-5 of the
     points' scale); sanity.main on the HO3D release config against
     consistent shards written on the card (both of its checks, its MPJPE
     printed) and the GT panels drawable here (infer.py's PANELS rule); (b)
     model.backbone_int8 on the main path's model (b1 x 8 x 256^2): each
     Q8Conv's int32 sums on the card bitwise equal to the CPU's on the
     same int8 operands, and the forward's convs timed against F.conv2d;
     the eval_fps protocol cut as the HR one, int8 off then on, in fp32
     and bf16 (K1 5 and K2 1 launches a forward, the p50s side by side);
     int8 against the exact model on the same weights (backbone map
     correlation > 0.98, median joints_crop_img delta < 4 px: the JAX
     package's bounds) with the int8 forward's device ms and ops; the int8 kernel path against the plain path (phase 5's
     limits); an export bundle of the int8 model replayed against the live
     infer_step (K1 5, K2 1); (c) on the HO3D ResNet and HR release
     recipes, two optimizer steps with train.remat on against off from
     one init under deterministic algorithms (loss terms, gradient norm
     and every BN running statistic rel 1e-6; whether bitwise printed),
     K1 10 and K2 2 (HR 0) launches a step with remat on, the ms a step
     and peak memory both ways, and resolve_remat's "auto" at every
     release config's shapes (off at all of them);
 15. the downscaled decode and the decode cache, on phase 9's train shards
     beside 3 test shards of 16 written on the card (every split whole
     batches of 16), fp32 unless said: (a) data/jpeg.py's downscale_frames at
     d = 2, 4 and 8 on the card bitwise equal to the CPU on the same frames
     (the fixture decoded by nvJPEG at batch 1 and 80, a val batch of the
     shards), nvJPEG + downscale against the fixture's cv2 pixels
     downscaled on the CPU (phase 8's nvJPEG limits), its device ms;
     eval.py and 2 training steps with decode_scale_denom 2 (phase 8's and
     9's launch and finiteness checks); (b) with cache_decoded: eval.py
     without the cache, with it cold (it builds the val and test stores)
     and warm, under deterministic algorithms: the metrics and launches
     bitwise equal, nvJPEG calls only the build's (a batch a call) and none
     warm; every stored frame bitwise nvJPEG's decode of its JPEGs, in the
     reader's order; train.py on the shards for 2 epochs cold (its first
     epoch builds the stores) against warm, no augmentation (its box blur's
     float cumsum has no deterministic CUDA kernel), under deterministic
     algorithms: loss terms and gradient norms of every step bitwise equal,
     no nvJPEG call warm; augmented runs from the stores, ms a step beside
     phase 9's and phase 6's: fp32 once, bf16 in turns with runs without
     the cache (without, with, with, without); the train loader's samples/s
     cold and warm and the store's bytes on disk;
 16. a {"kernels": [...]} line, K1 an entry for each design a row's calls
     take (its calls' times, both designs' device ms, its launches as the
     run counted them by design), K2's entries with its design and the
     copies it takes (the /infer rows with its bf16 time at x [5] too); the /denom and /cache rows phase 15's; the
     /int8 and /remat rows phase 14's;
     the HR rows carry K1's launches on the HR
     paths, the /eval rows the launches of phase 8's eval runs, the
     /train_shards rows phase 9's, the /train_dp rows phase 10's, the
     /infer, /vis and /eval_dp rows phase 11's, the /export and /view rows
     phase 12's, the /family and /root rows phase 13's), then the
     {"ok": true, ...} line last.
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
# the HR model's protocol, cut to a fifth: at 45-105 ms a step the whole one took
# 240-350 s of the script's time limit
HR_WARMUP, HR_ITERS = 20, 200

# H100 SXM data sheet: HBM rate, dense tensor-core peaks. The fp32 kernels run
# each f32 product as three TF32 products (3xTF32), so their peak is a third of
# the 495 TFLOP/s TF32 rate (above the 67 TFLOP/s of f32 FMAs on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
# each library's tensor-core kernels, by symbol, and the instruction each must hold:
# mma.sync (HMMA) or, for K1's "query_tiles" bf16 kernel and both of K2's, wgmma (HGMMA)
MMA_KERNELS = {"attention": {"bf16_mma": "HMMA", "tf32x3_mma": "HMMA"},
               "attention_tiles": {"bf16_wgmma": "HGMMA", "tf32x3_mma": "HMMA"},
               "stem": {"bf16_wgmma": "HGMMA", "tf32x3_wgmma": "HGMMA"}}
K1_SOURCES = {"key_split": "handmvnet_tpu_torch/csrc/attention.cu",
              "query_tiles": "handmvnet_tpu_torch/csrc/attention_tiles.cu"}
STEM_DESIGN = "persistent_wgmma"  # K2's one design (csrc/stem.cu)

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
# data-parallel training (phase 10): two ranks of the release recipe on the one
# card, each batch 16 x 5 views at accumulation 2, 1 warmup + 3 optimizer steps
DP_RANKS, DP_WARMUP, DP_STEPS = 2, 1, 3
# the serving structure (phase 12): the DexYCB release model at its 8 views;
# the bundle exported on the card replayed 20 + 200 times, as eval_fps times the
# HR model, the others 2 + 10; JAX's own view-parallel limits against the plain
# forward (tests/test_view_parallel.py:52-62)
DEXYCB_CONFIG = REPO / "configs" / "release" / "DexYCB_HandMvNet.yaml"
EXPORT_WARMUP, EXPORT_ITERS = HR_WARMUP, HR_ITERS
CHECK_WARMUP, CHECK_ITERS = 2, 10
VIEW_TOLS = {"heatmap": 1e-5, "joints_crop_img": 1e-2, "joints_cam": 1e-4}
VIEW_RANKS, VIEW_WARMUP, VIEW_STEPS = 2, 3, 20
INPUT_KEYS = ("rgb", "bboxes", "intrinsic")
# the rest of the model family (phase 13): the default ResNets on the DexYCB
# release model at early_return 3, a short protocol each; the absolute-root
# branch's K1 shapes at serving (b1, 8 views) and in a training microbatch
# (batch 8, 5 views), 3 more calls a forward
FAMILY_TYPES = ("18", "34", "50", "101", "152")
FAMILY_WARMUP, FAMILY_ITERS = 10, 50
ROOT_ATTN_SHAPES = ((8, 8), (1, 7), (1, 1))
ROOT_TRAIN_ATTN_SHAPES = ((5, 5), (1, 4), (1, 1))
ROOT_TOL_M = 1e-4  # root_joint, kernel path against plain path (as joints_cam)
HOURGLASS_REL = 1e-4
# geometry and tooling, int8 serving, remat (phase 14): the DLT triangulations
# at B = 16 samples x 8 views x 21 joints, card against CPU (rel 1e-5 of the
# points' scale); the int8 protocol cut as the HR one; JAX's own int8 bounds
# against the exact model (tests/test_quant.py:102, :147); two optimizer
# steps with remat on against off (rel 1e-6), then 2 + 5 timed steps each way
TRI_BATCH, TRI_VIEWS, TRI_REL = 16, 8, 1e-5
INT8_CORR, INT8_MEDIAN_PX = 0.98, 4.0
REMAT_STEPS, REMAT_WARMUP, REMAT_ITERS, REMAT_REL = 2, 2, 5, 1e-6
# the decode cache and the downscaled decode (phase 15): the downscale's factors;
# phase 9's train shards beside 3 test shards of 16 (eval.py reads the test split),
# so that every split is whole batches of 16 and the cache's build decodes the
# loader's own batches (nvJPEG's pixels depend on a batch's size)
DENOMS = (2, 4, 8)
CACHE_TEST_SHARDS = 3


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
    """{kernel symbol: {"HMMA": n, "HGMMA": n}}: the mma.sync and wgmma
    instructions in a library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass {lib.name}: {sass.stderr.strip()}")
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            op = re.search(r"\b(HG?MMA)\b", line)
            if op:
                counts[name][op.group(1)] += 1
    return counts


def reset_launches(attention_ops, stem_ops) -> None:
    """Set every launch count to 0: K1's, K1's by design and K2's."""
    attention_ops.fused_attention.launches = 0
    attention_ops.fused_attention.design_launches = dict.fromkeys(attention_ops.DESIGNS, 0)
    stem_ops.stem_conv_nchw.launches = 0


def rule_split(attention_ops, dtype, calls: dict, forwards: dict) -> dict:
    """K1's launches by design that ``attention_design`` gives ``forwards``
    ({batch: forwards}) of a model whose forward makes ``calls`` ({(Nq, Nk):
    calls}), each over 8 heads."""
    want = dict.fromkeys(attention_ops.DESIGNS, 0)
    for batch, n in forwards.items():
        for (nq, nk), c in calls.items():
            want[attention_ops.attention_design(dtype, batch, 8, nq, nk)] += c * n
    return want


def k1_designs(attention_ops, label: str, want: dict | None = None) -> dict:
    """K1's launches by design since ``reset_launches``: they must add up to
    its launches and, given ``want`` (``rule_split``'s), be the rule's."""
    got = dict(attention_ops.fused_attention.design_launches)
    print(f"   {label}: K1 launches by design {got}", flush=True)
    if sum(got.values()) != attention_ops.fused_attention.launches or \
            (want is not None and got != want):
        fail(f"{label}: K1 launches by design {got} (of "
             f"{attention_ops.fused_attention.launches}), expected {want} from attention_design")
    return got


def add_designs(*counts: dict) -> dict:
    """The sum of K1's launch counts by design."""
    return {d: sum(c.get(d, 0) for c in counts) for d in K1_SOURCES}


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


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the block (an op without one raises)."""
    saved = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]


@contextlib.contextmanager
def world_of_one():
    """The env:// rendezvous of one rank, as torchrun sets it, for the block."""
    import os

    from handmvnet_tpu_torch.parallel.mesh import free_port

    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    try:
        yield
    finally:
        for key in env:
            del os.environ[key]


def check_attention(attention_ops, dtype, gen, shapes=ATTN_SHAPES, batch=1) -> dict:
    """K1 at each shape: each design that takes it (launch_design) against the
    plain version, the time of each beside the plain version's and SDPA's,
    the bound, and the design that ``attention_design`` picks there."""
    scale = 128 ** -0.5
    rows = {}
    for nq, nk in shapes:
        # the model's layout: [b, n, h, d] projections viewed as [b, h, n, d]
        q, k, v = (torch.randn(batch, n, 8, 128, generator=gen, device="cuda").to(dtype)
                   .transpose(1, 2) for n in (nq, nk, nk))
        design = attention_ops.attention_design(dtype, batch, 8, nq, nk)
        designs = [d for d in attention_ops.DESIGNS
                   if d == "key_split" or nk <= attention_ops.TILE_MAX_KEYS[dtype]]
        ref = attention_ops.attention_plain(q, k, v, scale)
        tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * float(ref.float().abs().max())
        errs = {}
        for d in designs:
            with torch.no_grad():
                out = attention_ops.launch_design(q, k, v, scale, d)
            torch.cuda.synchronize()
            errs[d] = max_err(out, ref)
            print(f"K1 fused_attention {dtype} batch {batch} (Nq, Nk)=({nq}, {nk}) {d}"
                  f"{' (the rule)' if d == design else ''}: max_abs_err={errs[d]:.3e} "
                  f"tol={tol:.3e}", flush=True)
            if not errs[d] <= tol:
                fail(f"K1 {d} disagrees with its plain version at ({nq}, {nk}) {dtype}: "
                     f"{errs[d]} > {tol}")
        with torch.no_grad():
            t = time_ms({
                **{d: lambda d=d: attention_ops.launch_design(q, k, v, scale, d)
                   for d in designs},
                "plain": lambda: attention_ops.attention_plain(q, k, v, scale),
                "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            })
        elt = q.element_size()
        flops = 4.0 * batch * 8 * nq * nk * 128  # q k^T and p v, 8 heads
        nbytes = batch * 8 * 128 * (2 * nq + 2 * nk) * elt  # q, k, v read and o written once
        b, by = bound_ms(flops, nbytes, dtype)
        print(f"   device ms: " + " ".join(f"{d}={t[d]['device']:.5f}" for d in designs) +
              f" plain={t['plain']['device']:.5f} sdpa={t['library']['device']:.5f} "
              f"bound={b:.5f} ({by}); eager ms: " +
              " ".join(f"{d}={t[d]['eager']:.5f}" for d in designs) +
              f" plain={t['plain']['eager']:.5f} sdpa={t['library']['eager']:.5f}", flush=True)
        rows[(nq, nk)] = {"err": errs[design], "errs": errs, "design": design,
                          "t": {"kernel": t[design], "plain": t["plain"],
                                "library": t["library"]},
                          "design_ms": {d: t[d]["device"] for d in designs},
                          "bound": b, "flops": flops, "bytes": nbytes}
    return rows


def check_stem(stem_ops, dtype, gen, shape=STEM_SHAPE) -> dict:
    """K2 at one input shape: error vs plain, times, bound, its design and
    the copies it takes (stem_routes)."""
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
    routes = dict(zip(("load", "store"), stem_ops.stem_routes(x, out)))
    print(f"K2 stem_conv {dtype} x=[{n}, 3, {h}, {w}] design {STEM_DESIGN} (load "
          f"{routes['load']}, store {routes['store']}): max_abs_err={err:.3e} tol={tol:.3e}",
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
          f"conv2d={t['library']['device']:.5f} bound={b:.5f} ({by}, "
          f"{b / t['kernel']['device']:.0%} of it); eager ms: "
          f"kernel={t['kernel']['eager']:.5f} plain={t['plain']['eager']:.5f} "
          f"conv2d={t['library']['eager']:.5f}", flush=True)
    return {"err": err, "t": t, "bound": b, "bound_by": by, "routes": routes}


def check_attention_backward(attention_ops, dtype, gen, calls=TRAIN_ATTN_CALLS) -> dict:
    """The K1 Function's gradients at the training shapes (``calls``: each
    (Nq, Nk) and its calls a microbatch, at batch 8) against autograd
    through the plain version, and the backward's device time per microbatch
    (attention_backward: PyTorch ops)."""
    from handmvnet_tpu_torch.profile_forward import graph_ms

    scale = 128 ** -0.5
    worst, ms = 0.0, 0.0
    for nq, nk in calls:
        base = [torch.randn(TRAIN_ATTN_BATCH, n, 8, 128, generator=gen, device="cuda").to(dtype)
                for n in (nq, nk, nk)]
        g = torch.randn(TRAIN_ATTN_BATCH, 8, nq, 128, generator=gen, device="cuda").to(dtype)
        grads = []
        for fn in (attention_ops.fused_attention, attention_ops.attention_plain):
            qkv = [t.clone().requires_grad_(True) for t in base]
            out = fn(*(t.transpose(1, 2) for t in qkv), scale)
            if fn is attention_ops.fused_attention and \
                    "hmv_fused_attention" not in type(out.grad_fn).__name__:
                fail(f"K1's output has grad_fn {out.grad_fn}, not the port's op")
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
        ms += calls[(nq, nk)] * t
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
        if fn is stem_ops.stem_conv_nchw and "hmv_stem_conv" not in type(out.grad_fn).__name__:
            fail(f"K2's output has grad_fn {out.grad_fn}, not the port's op")
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
    state = create_train_state(build_model(cfg, "cuda", seed=0, accum_steps=accum), cfg,
                               steps_per_epoch=cfg.data.split_size("train") // TRAIN_BATCH)
    data = synthetic_batch(TRAIN_BATCH, TRAIN_VIEWS, cfg.data.image_size, cfg.data.heatmap_size,
                           seed=0)
    data["extrinsic"][:] = np.eye(4, dtype=np.float32)
    batch = batch_to_device(data, "cuda")
    gen = torch.Generator("cuda")
    steps = TRAIN_WARMUP + TRAIN_ITERS
    losses = []
    reset_launches(attention_ops, stem_ops)
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
    designs = k1_designs(attention_ops, label, rule_split(
        attention_ops, DTYPES[dtype_name], TRAIN_ATTN_CALLS, {TRAIN_BATCH // accum: accum * steps}))
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
    return {"launches": launches, "k1_designs": designs, "ms": ms, "peak_gb": peak_gb,
            "device_ops": n_ops}


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
          stem_per_forward: int, warmup: int = WARMUP, iters: int = ITERS,
          attn_per_forward: int = 5):
    """The eval_fps protocol (b1 x v8 x 256^2, warmup + 2 x iters forwards)
    with the launch counters set to 0 just before and read just after: K1
    must launch ``attn_per_forward`` times a forward (the fusion's 5 calls,
    or 0), each by the design ``attention_design`` picks, and K2
    ``stem_per_forward`` times; the outputs must be fp32, finite, on the card
    and of the expected shapes. Returns (launches, outputs of the last step,
    the protocol's stats with "k1_designs", K1's launches by design)."""
    from handmvnet_tpu_torch.eval_fps import run_protocol

    reset_launches(attention_ops, stem_ops)
    stats, out = run_protocol(cfg, views=8, dtype=DTYPES[dtype_name], warmup=warmup, iters=iters,
                              device="cuda", seed=0, with_vertices=with_vertices)
    torch.cuda.synchronize()
    got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    step = "forward + mesh stage" if with_vertices else "forward only (--no-vertices)"
    stats["k1_designs"] = k1_designs(attention_ops, f"{label} {dtype_name} {step}", rule_split(
        attention_ops, DTYPES[dtype_name], ATTN_CALLS if attn_per_forward else {},
        {1: stats["forwards"]}))
    want = (attn_per_forward * stats["forwards"], stem_per_forward * stats["forwards"])
    print(f"{label} {dtype_name} {step}: fps={stats['fps']:.2f} p50_ms={stats['p50_ms']:.4f} "
          f"mean_ms={stats['mean_ms']:.4f} forwards={stats['forwards']} "
          f"launches K1={got[0]} K2={got[1]}", flush=True)
    if got != want:
        fail(f"{label} {dtype_name} {step}: kernel launches {got}, expected {want} "
             f"({attn_per_forward} and {stem_per_forward} per forward)")
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
    return got, out, stats


def compare_paths(out_k: dict, out_p: dict, label: str,
                  what: str = "fp32 kernel path vs plain path", tols: dict = PATH_TOLS,
                  relative: tuple = ()) -> None:
    """The fp32 kernel path's outputs against the plain path's (or ``what``
    else), PATH_TOLS: absolute, as the paths differ only by the stem's and
    attention's summation order; heatmaps (|h| < 1 here) feed soft-argmax
    at x1000, whose coordinates are pixels of the 256^2 crop. The keys in
    ``relative`` are judged at their tolerance times max(1, max|ref|)."""
    for key, tol in tols.items():
        if key in relative:
            tol *= max(1.0, float(out_p[key].abs().max()))
        err = max_err(out_k[key], out_p[key])
        print(f"{label} {what} {key}: max_abs_err={err:.3e} "
              f"(max|ref|={float(out_p[key].abs().max()):.3e}) tol={tol:.1e}", flush=True)
        if not err <= tol:
            fail(f"{label}: {what} disagree on {key}: {err} > {tol}")


def serve_kernel_vs_plain(attention_ops, stem_ops, cfg, label: str,
                          relative: tuple = ()) -> None:
    """The fp32 kernel path against the plain path on the card, same weights
    (``relative``: compare_paths')."""
    from handmvnet_tpu_torch.eval_fps import protocol_step

    step = protocol_step(cfg, views=8, dtype=torch.float32, device="cuda", seed=0)
    with torch.inference_mode():
        out_k = step()
        with plain_kernels(attention_ops, stem_ops):
            out_p = step()
    compare_paths(out_k, out_p, label, relative=relative)
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
             stem_per_forward: int, argv: tuple = ()) -> tuple[tuple[int, int], dict, dict]:
    """eval.py on the card in fp32 (val, then test), the counters set to 0
    just before and read just after: K1 5 launches a forward, K2
    ``stem_per_forward``; val.json and test.json beside the checkpoint with
    every metric finite, vertex metrics included; K1's launches by design
    the rule's at batch 16 (eval.py's batches are full). Returns the
    launches, the results and K1's launches by design."""
    from handmvnet_tpu_torch import eval as port_eval
    from handmvnet_tpu_torch.config import Config

    cfg = Config.from_yaml(config)
    forwards = sum(max(1, cfg.data.split_size(s) // EVAL_BATCH) for s in ("val", "test"))
    reset_launches(attention_ops, stem_ops)
    t0 = time.perf_counter()
    results = port_eval.main(["--config", str(config), "--checkpoint", str(ckpt), *argv])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    designs = k1_designs(attention_ops, f"{label} eval.py", rule_split(
        attention_ops, torch.float32, TRAIN_ATTN_CALLS, {EVAL_BATCH: forwards}))
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
    return got, results, designs


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


def data_and_eval_phase(attention_ops, stem_ops, gen, card_line: str, tmp: Path) -> dict:
    """Phase 8 (see the module docstring), in the new directory ``tmp``.
    Returns the kernel rows' inputs, and each model's config, checkpoint and
    eval results."""
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

    tmp.mkdir(parents=True)
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
        launches, results, designs = eval_run(attention_ops, stem_ops, config, ckpt, label,
                                              stem_per_forward)
        rows[label] = {"launches": launches, "k1_designs": designs, "results": results,
                       "config": config, "ckpt": ckpt}
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


def train_loader_rate(cfg, eval_loader_sps: float, step_sps: float, card_line: str) -> float:
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
    return sps


def shard_train_run(attention_ops, stem_ops, config: Path, out_dir: Path, label: str,
                    args: list, stem_per_step: int, device_prefetch: bool = True,
                    extra_forwards: int = 0) -> dict:
    """train.main on the smoke shards with the counters set to 0 just before
    and read just after: every optimizer step must launch K1 10 times and K2
    ``stem_per_step`` times, and the run in all 10 and 2 (or 0) a step plus 5
    and 1 (or 0) a validation forward, K1 by the design the rule picks for
    the microbatches and for the validation batches; every logged value
    finite. ms a step is the mean gap between CUDA events recorded after
    consecutive steps of an epoch (the first step of each epoch, after
    validation, left out): the device's time per step, waits for data
    included. ``device_prefetch``
    False prepares each batch on the consumer's thread (this run is the one
    caller of that setting). ``extra_forwards``: eval forwards beyond the
    validations' (the vis hook's), each K1 5 and K2 ``stem_per_step // 2``.
    Returns each step's loss terms and gradient norm (before clipping) too,
    and the nvJPEG calls of the run."""
    import functools

    from handmvnet_tpu_torch import train as train_mod
    from handmvnet_tpu_torch import train_step as train_step_mod
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.jpeg import decode_jpeg
    from handmvnet_tpu_torch.data.loader import BatchLoader

    cfg = Config.from_yaml(config)
    spe = next((int(a) for a, b in zip(args[1:], args) if b == "--steps-per-epoch"),
               cfg.data.split_size("train") // cfg.data.batch_size)
    ends, per_step, losses, norms = [], [], [], []
    real_step, real_optimizer_step = train_mod.train_step, train_step_mod.optimizer_step

    def timed_step(state, *a, **k):
        before = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
        out = real_step(state, *a, **k)
        per_step.append((attention_ops.fused_attention.launches - before[0],
                         stem_ops.stem_conv_nchw.launches - before[1]))
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        losses.append({key: value.detach() for key, value in out.items()})
        return out

    def recorded_optimizer_step(state, cfg):
        norm = real_optimizer_step(state, cfg)
        norms.append(norm.detach())
        return norm

    records_before = 0
    metrics = out_dir / "metrics.jsonl"
    if metrics.exists():
        records_before = len(metrics.read_text().splitlines())
    train_mod.train_step = timed_step
    train_step_mod.optimizer_step = recorded_optimizer_step
    if not device_prefetch:
        train_mod.BatchLoader = functools.partial(BatchLoader, device_prefetch=False)
    reset_launches(attention_ops, stem_ops)
    decode_jpeg.calls = 0
    t0 = time.perf_counter()
    try:
        train_mod.main(["--config", str(config), "--output-dir", str(out_dir), *args])
    finally:
        train_mod.train_step = real_step
        train_step_mod.optimizer_step = real_optimizer_step
        train_mod.BatchLoader = BatchLoader
    torch.cuda.synchronize()
    decodes = decode_jpeg.calls
    secs = time.perf_counter() - t0
    got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    steps = len(ends)
    records = [json.loads(line) for line in metrics.read_text().splitlines()][records_before:]
    val_steps = max(1, cfg.data.split_size("val") // cfg.data.batch_size)
    # each epoch's validation, the best checkpoint's and the extra forwards
    val_forwards = (len(records) + 1) * val_steps + extra_forwards
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
    accum, dtype = train_mod.accumulation(cfg), DTYPES[cfg.train.compute_dtype]
    designs = k1_designs(attention_ops, label, add_designs(
        rule_split(attention_ops, dtype, TRAIN_ATTN_CALLS, {bs // accum: accum * steps}),
        rule_split(attention_ops, dtype, TRAIN_ATTN_CALLS, {bs: val_forwards})))
    values = [v for r in records for v in r.values() if isinstance(v, float)]
    if not records or not all(math.isfinite(v) for v in values):
        fail(f"{label}: a logged value is not finite: {records}")
    return {"ms": ms, "sps": bs / ms * 1e3, "launches": got, "k1_designs": designs,
            "steps": steps, "secs": secs, "records": records, "decodes": decodes,
            "losses": [{key: float(value) for key, value in step.items()} for step in losses],
            "norms": [float(norm) for norm in norms]}


def shard_training_phase(attention_ops, stem_ops, train: dict, evals: dict,
                         card_line: str, tmp: Path) -> tuple[dict, dict]:
    """Phase 9 (see the module docstring), in the directory ``tmp``. Returns
    train.main's runs, with the launches of the kernel rows, and the configs
    of the shards it wrote there, by dtype."""
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards
    from handmvnet_tpu_torch.models.mano import synthetic_mano_model
    from handmvnet_tpu_torch.train import build_dataloaders

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
    loader_sps = train_loader_rate(cfg, evals["ResNet"]["loader_sps"], fp32_step_sps, card_line)

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
    runs["loader"] = {"sps": loader_sps}
    return runs, configs


@contextlib.contextmanager
def timed_all_reduce():
    """train_step's all-reduce with CUDA events recorded around each call;
    yields the list of (start, end, bytes) of the calls."""
    from handmvnet_tpu_torch import train_step as step_mod

    calls, real = [], step_mod.all_reduce_mean_

    def timed(flat, group):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(flat, group)
        end.record()
        calls.append((start, end, flat.numel() * flat.element_size()))
        return out

    step_mod.all_reduce_mean_ = timed
    try:
        yield calls
    finally:
        step_mod.all_reduce_mean_ = real


def dp_rank(out: str) -> None:
    """One rank of phase 10 (a), started by parallel.spawn_local_ranks: gloo
    on cuda:0, which both ranks share (the port gives each rank a card of its
    own; NCCL refuses two ranks on one device). From seed 1 with the heatmap
    head scaled by 1e-3 and dropout 0 (train_kernel_vs_plain's model), rank
    0's weights broadcast, DP_WARMUP + DP_STEPS optimizer steps of
    train_step's process-group path on this rank's half of a
    DP_RANKS x TRAIN_BATCH synthetic batch, every view at the root camera's
    pose. Writes to ``<out>/rank<r>.pt`` its launch counts a step, its loss
    terms and gradient norm a step, ms a step over the timed steps, the
    all-reduce's ms (CUDA events around each call in the step) and its final
    state_dict."""
    import torch.distributed as dist

    from handmvnet_tpu_torch import train_step as step_mod
    from handmvnet_tpu_torch.ops import attention as attention_ops
    from handmvnet_tpu_torch.ops import stem as stem_ops
    from handmvnet_tpu_torch.parallel import broadcast_module_
    from handmvnet_tpu_torch.parallel.mesh import TIMEOUT
    from handmvnet_tpu_torch.train import accumulation

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://", timeout=TIMEOUT)
    group = dist.group.WORLD
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    try:
        cfg = train_config("float32")
        model = dp_model(cfg)
        broadcast_module_(model, group)
        state = step_mod.create_train_state(model, cfg, 1000)
        batch = {k: v[rank * TRAIN_BATCH:(rank + 1) * TRAIN_BATCH]
                 for k, v in dp_batch(cfg).items()}
        accum = accumulation(cfg, world)
        reset_launches(attention_ops, stem_ops)
        launches, losses, norms = [], [], []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with timed_all_reduce() as reduce_ms:
            for i in range(DP_WARMUP + DP_STEPS):
                if i == DP_WARMUP:
                    start.record()
                before = (attention_ops.fused_attention.launches,
                          stem_ops.stem_conv_nchw.launches)
                losses.append(step_mod.accumulate_grads(state, cfg, batch, None, accum, group))
                norms.append(step_mod.optimizer_step(state, cfg))
                launches.append((attention_ops.fused_attention.launches - before[0],
                                 stem_ops.stem_conv_nchw.launches - before[1]))
            end.record()
            end.synchronize()
        designs = k1_designs(attention_ops, f"data-parallel rank {rank}", rule_split(
            attention_ops, torch.float32, TRAIN_ATTN_CALLS,
            {TRAIN_BATCH // accum: accum * (DP_WARMUP + DP_STEPS)}))
        torch.save({"launches": launches, "k1_designs": designs,
                    "losses": [{k: float(v) for k, v in lo.items()} for lo in losses],
                    "norms": [float(n) for n in norms],
                    "ms": start.elapsed_time(end) / DP_STEPS,
                    "reduce_ms": [a.elapsed_time(b) for a, b, _ in reduce_ms],
                    "reduce_bytes": reduce_ms[0][2],
                    "state": {k: v.cpu() for k, v in state.model.state_dict().items()}},
                   Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_model(cfg):
    """train_kernel_vs_plain's judged model: seed 1, dropout 0, the heatmap
    head's last conv scaled by 1e-3."""
    from handmvnet_tpu_torch.train_step import build_model

    model = build_model(cfg, "cuda", seed=1, dropout=0.0)
    with torch.no_grad():
        for p in model.pose_net[-1].parameters():
            p.mul_(1e-3)
    return model


def dp_batch(cfg) -> dict:
    """Phase 6's synthetic data at DP_RANKS x TRAIN_BATCH samples, every view
    at the root camera's pose, on the card."""
    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.train_step import batch_to_device

    data = synthetic_batch(DP_RANKS * TRAIN_BATCH, TRAIN_VIEWS, cfg.data.image_size,
                           cfg.data.heatmap_size, seed=0)
    data["extrinsic"][:] = np.eye(4, dtype=np.float32)
    return batch_to_device(data, "cuda")


def dp_shared_card(card_line: str) -> dict:
    """Phase 10 (a): DP_RANKS processes on the one card over gloo (dp_rank),
    then one process accumulating the same 2 x 2 microbatches from the same
    weights: the first step's all-reduced loss terms (rel 1e-4) and gradient
    norm (rel 1e-3) against it, as in phase 6; K1 10 and K2 2 launches every
    step on each rank, finite losses; after the steps parameters and
    BatchNorm statistics bitwise equal across ranks."""
    import tempfile

    from handmvnet_tpu_torch.parallel import spawn_local_ranks
    from handmvnet_tpu_torch.train_step import accumulate_grads, create_train_state, optimizer_step

    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_dp_") as tmp:
        t0 = time.perf_counter()
        spawn_local_ranks(dp_rank, (tmp,), DP_RANKS)
        secs = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=True) for r in range(DP_RANKS)]
    label = f"data-parallel training fp32, {DP_RANKS} ranks on one card over gloo"
    steps = DP_WARMUP + DP_STEPS
    for r, seen in enumerate(ranks):
        reduce = seen["reduce_ms"]
        print(f"{label}, rank {r}: batch {TRAIN_BATCH} x {TRAIN_VIEWS} views a rank, accumulation "
              f"2: ms_per_step={seen['ms']:.3f} over {DP_STEPS} steps after {DP_WARMUP} "
              f"(shared-card figure, not a scaling figure); all-reduce of "
              f"{seen['reduce_bytes'] / 1e6:.1f} MB (gradients, loss terms, BatchNorm "
              f"statistics): {[round(t, 3) for t in reduce]} ms; launches a step "
              f"{seen['launches']}; loss by step {[round(lo['loss'], 3) for lo in seen['losses']]}"
              f"; {card_line}", flush=True)
        if any(n != (10, 2) for n in seen["launches"]) or len(seen["launches"]) != steps:
            fail(f"{label}: rank {r} launches {seen['launches']}, expected (10, 2) in each of "
                 f"{steps} steps")
        if not all(math.isfinite(v) for lo in seen["losses"] for v in lo.values()):
            fail(f"{label}: rank {r}'s losses are not finite: {seen['losses']}")
        if len(reduce) != steps:
            fail(f"{label}: rank {r} made {len(reduce)} all-reduces in {steps} steps, expected 1 "
                 "a step")
    first, second = (seen["state"] for seen in ranks)
    unequal = [k for k in first if not torch.equal(first[k], second[k])]
    if unequal or first.keys() != second.keys():
        fail(f"{label}: the ranks' parameters or statistics differ after {steps} steps: "
             f"{unequal[:5]}")
    print(f"{label}: after {steps} steps all {len(first)} parameters and buffers bitwise equal "
          f"across ranks; {secs:.1f} s in all (process start included)", flush=True)

    cfg = train_config("float32")
    state = create_train_state(dp_model(cfg), cfg, 1000)
    losses = {k: float(v) for k, v in accumulate_grads(
        state, cfg, dp_batch(cfg), None, 2 * DP_RANKS).items()}
    norm = float(optimizer_step(state, cfg))
    got, got_norm = ranks[0]["losses"][0], ranks[0]["norms"][0]
    bad = []
    for key, ref in losses.items():
        rel = abs(got[key] - ref) / abs(ref)
        print(f"{label}, first step against one process accumulating the same "
              f"{2 * DP_RANKS} microbatches, {key}: {got[key]:.6f} vs {ref:.6f} rel={rel:.3e} "
              "tol=1e-4", flush=True)
        if not rel <= 1e-4:
            bad.append(f"{key} rel {rel}")
    rel = abs(got_norm - norm) / norm
    print(f"{label}, first step's all-reduced gradient norm: {got_norm:.6e} vs {norm:.6e} "
          f"rel={rel:.3e} tol=1e-3", flush=True)
    if not rel <= 1e-3:
        bad.append(f"gradient norm rel {rel}")
    if bad:
        fail(f"{label}: the all-reduced step disagrees with one process: {bad}")
    return {"launches": [seen["launches"] for seen in ranks],
            "k1_designs": [seen["k1_designs"] for seen in ranks],
            "ms": [seen["ms"] for seen in ranks],
            "reduce_ms": [seen["reduce_ms"] for seen in ranks], "secs": secs}


def dp_train_main(attention_ops, stem_ops, config: Path, out_dir: Path, one_process: dict,
                  card_line: str) -> dict:
    """Phase 10 (b): train.main through the env:// rendezvous at world size 1
    on NCCL, one epoch on phase 9's shards (shard_train_run's launch and
    finiteness checks), the all-reduce timed with CUDA events around each
    call; ms a step against phase 9's one-process fp32 step."""
    with world_of_one(), timed_all_reduce() as reduce_ms:
        run = shard_train_run(attention_ops, stem_ops, config, out_dir,
                              "training on shards float32, world size 1 on NCCL (env://)",
                              ["--epochs", "1"], stem_per_step=2)
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b, _ in reduce_ms]
    if len(times) != run["steps"]:
        fail(f"world size 1: {len(times)} all-reduces in {run['steps']} steps, expected 1 a step")
    print(f"training on shards float32, world size 1 on NCCL: {run['ms']:.3f} ms a step against "
          f"phase 9's one-process step {one_process['ms']:.3f} ms: ratio "
          f"{run['ms'] / one_process['ms']:.4f}; the all-reduce (gradients, loss terms, "
          f"BatchNorm statistics) {sum(times) / len(times):.4f} ms mean over {len(times)} "
          f"steps (min {min(times):.4f}); {card_line}", flush=True)
    return {**run, "reduce_ms": times}


def probe_libraries() -> dict:
    """{name: version, or None where absent} of the drivers' lazy imports:
    cv2 (the 2D panels), matplotlib (the 3D panels), tensorboard (tb/)."""
    import importlib
    import importlib.util

    found = {}
    for name in ("cv2", "matplotlib", "tensorboard"):
        found[name] = None
        if importlib.util.find_spec(name) is not None:
            found[name] = getattr(importlib.import_module(name), "__version__", "present")
        print(f"library {name}: {found[name] or 'absent'}", flush=True)
    return found


def infer_run(attention_ops, stem_ops, argv: list, label: str, stem_per_forward: int,
              libs: dict, card_line: str) -> dict:
    """infer.py's step on the card (prepare, infer_step, write_panels), fp32,
    the counters set to 0 just before the step and read just after: K1 5
    launches, K2 ``stem_per_forward``; outputs fp32, finite, on the card, of
    the expected shapes; the kernel path against the plain path (PATH_TOLS);
    the step's device ms (CUDA events) and wall ms (host clock to a
    synchronize), medians of 20; the panels whose library is present,
    non-empty."""
    from handmvnet_tpu_torch import infer

    args = infer.parse_args(argv)
    model, batch, mesh_stage = infer.prepare(args)
    reset_launches(attention_ops, stem_ops)
    out = infer.infer_step(model, mesh_stage, batch)
    torch.cuda.synchronize()
    got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    if got != (5, stem_per_forward):
        fail(f"{label}: kernel launches {got}, expected (5, {stem_per_forward}) in one step")
    views = batch["rgb"].shape[1]
    designs = k1_designs(attention_ops, label, rule_split(
        attention_ops, torch.float32, {5: TRAIN_ATTN_CALLS, 8: ATTN_CALLS}[views], {1: 1}))
    shapes = {"joints_cam": (1, 21, 3), "joints_crop_img": (1, views, 21, 2),
              "heatmap": (1, views, 21, 32, 32), "vertices": (1, 778, 3)}
    for key, shape in shapes.items():
        v = out[key]
        if tuple(v.shape) != shape or v.dtype != torch.float32 or v.device.type != "cuda" \
                or not torch.isfinite(v).all():
            fail(f"{label}: {key} is {tuple(v.shape)} {v.dtype} on {v.device}, expected "
                 f"{shape} fp32 finite on the card")
    with plain_kernels(attention_ops, stem_ops):
        out_p = infer.infer_step(model, mesh_stage, batch)
    compare_paths(out, out_p, label)

    step_ms = step_p50_ms(lambda: infer.infer_step(model, mesh_stage, batch), 0, 20)
    print(f"{label} fp32: launches K1={got[0]} K2={got[1]}; step device_ms="
          f"{step_ms['device_ms']:.4f} wall_ms={step_ms['wall_ms']:.4f} (medians of 20); "
          f"{card_line}", flush=True)

    drawable = [n for n, lib in infer.PANELS.items() if libs[lib]]
    for name in sorted(set(infer.PANELS) - set(drawable)):
        print(f"{label}: {name} not drawn: {infer.PANELS[name]} is absent", flush=True)
    t0 = time.perf_counter()
    paths = infer.write_panels(Path(args.output_dir), batch, out, mesh_stage.mano.model.faces,
                               drawable)
    sizes = {p.name: p.stat().st_size for p in paths}
    print(f"{label}: panels {sizes} bytes in {time.perf_counter() - t0:.2f} s", flush=True)
    if not all(sizes.values()):
        fail(f"{label}: an empty panel: {sizes}")
    return {"launches": got, "k1_designs": designs, **step_ms}


def tensorboard_matches(run_dir: Path) -> None:
    """tb/'s scalars, read back with TensorBoard's EventAccumulator, equal
    metrics.jsonl's numbers (as float32) at each record's epoch."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events = EventAccumulator(str(run_dir / "tb"))
    events.Reload()
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    want = {(k, r["epoch"]): np.float32(v) for r in records for k, v in r.items()
            if isinstance(v, (int, float)) and k != "epoch"}
    got = {(k, e.step): np.float32(e.value) for k in events.Tags()["scalars"]
           for e in events.Scalars(k)}
    print(f"tb/: {len(got)} scalars against metrics.jsonl's {len(want)}", flush=True)
    if got != want:
        fail(f"tb/ differs from metrics.jsonl: {sorted(set(got.items()) ^ set(want.items()))[:6]}")


def vis_train_run(attention_ops, stem_ops, phase9_config: Path, out_dir: Path, libs: dict
                  ) -> dict:
    """train.main at world size 1 on phase 9's shards with the vis hook every
    epoch and ``train.num_devices: 1`` (1 epoch of 2 steps, fp32; phase 9's
    launch and finiteness checks, with the hook's two eval forwards): no
    process group, the four PNGs of epoch 0, and tb/ equal to
    metrics.jsonl where tensorboard is present. Returns the run, with the
    hook's ms and launches."""
    import torch.distributed as dist

    from handmvnet_tpu_torch import train as train_mod

    text = phase9_config.read_text()
    text, n_vis = re.subn(r"(?m)^  vis_every_n_epochs: .*$", "  vis_every_n_epochs: 1", text)
    text, n_train = re.subn(r"(?m)^train:$", "train:\n  num_devices: 1", text)
    if (n_vis, n_train) != (1, 1):
        fail(f"{phase9_config.name}: no vis_every_n_epochs or train: line")
    config = out_dir.parent / "vis_train.yaml"
    config.write_text(text)
    args = ["--epochs", "1", "--steps-per-epoch", "2"]
    if not libs["cv2"]:  # train.py must refuse before its first step
        try:
            train_mod.main(["--config", str(config), "--output-dir", str(out_dir), *args])
        except ImportError as e:
            print(f"vis hook: train.main stopped before step 1 without cv2: {e}", flush=True)
            return {}
        fail("train.main ran a run whose vis hook draws without cv2")

    calls = []
    real_make = train_mod.make_vis_hook

    def make_timed_hook(*a, **k):
        hook = real_make(*a, **k)

        def timed(model, batch, epoch, mode):
            if dist.is_initialized():
                fail("train.main started a process group with train.num_devices: 1")
            before = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
            designs = dict(attention_ops.fused_attention.design_launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hook(model, batch, epoch, mode)  # ends in its copy to the host
            calls.append({"mode": mode, "ms": (time.perf_counter() - t0) * 1e3,
                          "launches": (attention_ops.fused_attention.launches - before[0],
                                       stem_ops.stem_conv_nchw.launches - before[1]),
                          "k1_designs": {d: n - designs[d] for d, n in
                                         attention_ops.fused_attention.design_launches.items()}})
        return timed

    train_mod.make_vis_hook = make_timed_hook
    try:
        run = shard_train_run(attention_ops, stem_ops, config, out_dir,
                              "training on shards float32 with the vis hook every epoch", args,
                              stem_per_step=2, extra_forwards=2)
    finally:
        train_mod.make_vis_hook = real_make
    for call in calls:
        print(f"vis hook ({call['mode']}, batch {EVAL_BATCH} x {EVAL_VIEWS} views): "
              f"{call['ms']:.2f} ms, launches K1={call['launches'][0]} "
              f"K2={call['launches'][1]}, K1 by design {call['k1_designs']}", flush=True)
    if [c["launches"] for c in calls] != [(5, 1), (5, 1)]:
        fail(f"vis hook: {calls}, expected a train and a val call of K1 5 and K2 1")
    names = [f"{mode}/{p}joints2d_0.png" for mode in ("train", "val") for p in ("", "projected_")]
    sizes = {n: (out_dir / "vis" / n).stat().st_size if (out_dir / "vis" / n).exists() else 0
             for n in names}
    print(f"vis/: {sizes} bytes", flush=True)
    if not all(sizes.values()):
        fail(f"vis hook: a PNG is missing or empty: {sizes}")
    if libs["tensorboard"]:
        tensorboard_matches(out_dir)
    else:
        print("tb/ not checked: tensorboard is absent (train.py warned and logged "
              "metrics.jsonl alone)", flush=True)
    return {**run, "hook": calls,
            "hook_launches": tuple(map(sum, zip(*(c["launches"] for c in calls)))),
            "hook_k1_designs": add_designs(*(c["k1_designs"] for c in calls))}


def eval_nccl_run(attention_ops, stem_ops, phase8: dict, out_dir: Path) -> dict:
    """eval.main through the env:// rendezvous at world size 1 on NCCL
    (--num-devices unset; the config with train.num_devices: 1) on phase 8's
    shards and reference checkpoint: eval_run's checks, and every metric
    within rel 1e-6 of phase 8's one-process eval. Returns the launches and
    K1's by design."""
    out_dir.mkdir(parents=True)
    config = out_dir / "eval_nccl.yaml"
    config.write_text(re.sub(r"(?m)^train:$", "train:\n  num_devices: 1",
                             phase8["config"].read_text()))
    ckpt = out_dir / phase8["ckpt"].name
    shutil.copy(phase8["ckpt"], ckpt)
    with world_of_one():
        launches, results, designs = eval_run(attention_ops, stem_ops, config, ckpt,
                                              "ResNet, world size 1 on NCCL (env://),", 1)
    worst = 0.0
    for mode, ref in phase8["results"].items():
        for key, value in ref.items():
            a, b = np.asarray(results[mode][key], np.float64), np.asarray(value, np.float64)
            scale = np.abs(b).max()
            worst = max(worst, float(np.abs(a - b).max() / scale) if scale else
                        float(np.abs(a).max()))
    print(f"eval.main at world size 1 on NCCL against phase 8's one-process eval: worst rel "
          f"{worst:.3e} (limit 1e-6)", flush=True)
    if not worst <= 1e-6:
        fail(f"eval.main on NCCL differs from the one-process eval by rel {worst}")
    return {"launches": launches, "k1_designs": designs}


def drivers_phase(attention_ops, stem_ops, gen, evals: dict, phase9_config: Path,
                  card_line: str, tmp: Path) -> dict:
    """Phase 11 (see the module docstring), in the new directory ``tmp``.
    Returns the kernel rows' inputs."""
    t0 = time.perf_counter()
    tmp.mkdir(parents=True)
    libs = probe_libraries()
    rows = {}
    for label, config, stem_per_forward in (("infer", CONFIG, 1), ("infer HR", HR_CONFIG, 0)):
        rows[label] = infer_run(attention_ops, stem_ops, [
            "--config", str(config), "--synthetic", "--output-dir", str(tmp / label)],
            f"{label} --synthetic", stem_per_forward, libs, card_line)
    resnet = evals["ResNet"]
    rows["infer shards"] = infer_run(attention_ops, stem_ops, [
        "--config", str(resnet["config"]), "--checkpoint", str(resnet["ckpt"]),
        "--output-dir", str(tmp / "infer_shards")],
        "infer on phase 8's test shards and checkpoint", 1, libs, card_line)
    rows["vis"] = vis_train_run(attention_ops, stem_ops, phase9_config, tmp / "vis_train", libs)
    rows["eval_dp"] = eval_nccl_run(attention_ops, stem_ops, resnet, tmp / "eval_nccl")
    print(f"phase 11 (drivers), checks: {time.perf_counter() - t0:.1f} s", flush=True)
    # K1 and K2 at infer's shapes (batch 1 x 5 views), for the kernel line (K2 in
    # both dtypes: its fourth main-path shape)
    rows["attn"] = check_attention(attention_ops, torch.float32, gen, TRAIN_ATTN_SHAPES, 1)
    rows["stem_bf16"] = check_stem(stem_ops, torch.bfloat16, gen, (EVAL_VIEWS, 256, 256))
    rows["stem"] = check_stem(stem_ops, torch.float32, gen, (EVAL_VIEWS, 256, 256))
    return rows


def step_p50_ms(fn, warmup: int, iters: int) -> dict:
    """Medians over ``iters`` calls (after ``warmup``) of one call waited for
    alone, the latency of one request: "device_ms" from CUDA events around
    it (idle gaps included), "wall_ms" on the host's clock."""
    device_ms, wall_ms = [], []
    for i in range(warmup + iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(start.elapsed_time(end))
    return {"device_ms": float(np.median(device_ms)), "wall_ms": float(np.median(wall_ms))}


def replay_bundles(spec_path: str) -> None:
    """Phase 12's fresh process (``python -c "import chip_smoke; ..."``):
    each bundle of the spec loaded onto the card with export.load_bundle
    and replayed 1 + warmup + iters times on its saved batch, the counters
    set to 0 just before and read just after; writes the first replay's
    outputs, the launches and the port's modules this process imported.
    Only then is the model imported: the eager infer_step on the bundle's
    weights (infer.prepare's, as export.main's) and batch is timed in this
    process, in turns replay, eager, eager, replay (p50s, CUDA events)."""
    from handmvnet_tpu_torch.export import load_bundle
    from handmvnet_tpu_torch.ops import attention as attention_ops
    from handmvnet_tpu_torch.ops import stem as stem_ops

    spec = json.loads(Path(spec_path).read_text())
    seen, replays = {}, {}
    for name, item in spec["bundles"].items():
        t0 = time.perf_counter()
        fn, meta = load_bundle(item["dir"], "cuda")
        load_s = time.perf_counter() - t0
        batch = torch.load(item["batch"])
        args = [batch[k].cuda() for k in INPUT_KEYS]
        reset_launches(attention_ops, stem_ops)
        out = fn(*args)
        p50 = step_p50_ms(lambda: fn(*args), *item["repeats"])["device_ms"]
        torch.cuda.synchronize()
        seen[name] = {"launches": (attention_ops.fused_attention.launches,
                                   stem_ops.stem_conv_nchw.launches),
                      "k1_designs": k1_designs(attention_ops, f"{name} replays"),
                      "replays": 1 + sum(item["repeats"]), "p50_ms": [p50],
                      "load_s": load_s, "exported_on": meta["device"],
                      "devices": sorted({str(v.device) for v in out.values()})}
        torch.save({k: v.cpu() for k, v in out.items()}, item["out"])
        replays[name] = (fn, dict(zip(INPUT_KEYS, args)))
    seen["modules"] = sorted(m for m in sys.modules if m.startswith("handmvnet_tpu_torch"))

    from handmvnet_tpu_torch import infer

    steps = {}
    for name, item in spec["bundles"].items():
        if item["config"] not in steps:
            model, _, mesh_stage = infer.prepare(infer_args(Path(item["config"])), "cuda")
            steps[item["config"]] = (model, mesh_stage)
        (model, mesh_stage), (fn, batch) = steps[item["config"]], replays[name]
        seen[name]["eager_p50_ms"] = [step_p50_ms(
            lambda: infer.infer_step(model, mesh_stage, batch), *item["repeats"])["device_ms"]
            for _ in range(2)]
        seen[name]["p50_ms"].append(step_p50_ms(
            lambda: fn(*(batch[k] for k in INPUT_KEYS)), *item["repeats"])["device_ms"])
    Path(spec["result"]).write_text(json.dumps(seen))


def infer_args(config: Path, *flags):
    from handmvnet_tpu_torch import infer

    return infer.parse_args(["--config", str(config), "--synthetic", *flags])


def export_phase(card_line: str, tmp: Path) -> dict:
    """Phase 12 (a)-(c): the bundles exported by export.main, replayed in a
    fresh process (replay_bundles) and held against the live infer_step
    on the same weights (infer.prepare's, as export.main's) and batch.
    Returns {label: launches, p50s}; the p50s are replay_bundles'."""
    from handmvnet_tpu_torch import export, infer

    full, check = (EXPORT_WARMUP, EXPORT_ITERS), (CHECK_WARMUP, CHECK_ITERS)
    cases = {"export": (DEXYCB_CONFIG, "cuda", 1, full),
             "export_cpu": (DEXYCB_CONFIG, "cpu", 1, check),
             "export_hr": (HR_CONFIG, "cuda", 0, check)}
    spec = {"bundles": {}, "result": str(tmp / "replays.json")}
    live = {}
    for label, (config, device, _, repeats) in cases.items():
        t0 = time.perf_counter()
        export.main(["--config", str(config), "--out", str(tmp / label), "--device", device]
                    + (["--verify"] if label == "export" else []))
        print(f"{label}: export.main --device {device} on {config.name}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if config not in live:
            model, batch, mesh_stage = infer.prepare(infer_args(config), "cuda")
            live[config] = {"out": infer.infer_step(model, mesh_stage, batch),
                            "mesh_stage": mesh_stage}
            torch.save({k: batch[k].cpu() for k in INPUT_KEYS}, tmp / f"{config.stem}.pt")
        spec["bundles"][label] = {"dir": str(tmp / label), "batch": str(tmp / f"{config.stem}.pt"),
                                  "out": str(tmp / f"{label}_out.pt"), "repeats": repeats,
                                  "config": str(config)}
    (tmp / "replays.spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    code = "import sys, chip_smoke; chip_smoke.replay_bundles(sys.argv[1])"
    done = subprocess.run([sys.executable, "-c", code, str(tmp / "replays.spec.json")],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        fail(f"replaying the bundles in a fresh process: {done.stderr[-4000:]}")
    seen = json.loads(Path(spec["result"]).read_text())
    print(f"replays in a fresh process: {time.perf_counter() - t0:.1f} s; it imported "
          f"{seen['modules']}", flush=True)
    if any(m.startswith(("handmvnet_tpu_torch.models", "handmvnet_tpu_torch.config"))
           for m in seen["modules"]):
        fail(f"load_bundle imported model code: {seen['modules']}")

    rows = {}
    for label, (config, device, stem_per_forward, repeats) in cases.items():
        got, ref = seen[label], live[config]
        n = got["replays"]
        if tuple(got["launches"]) != (5 * n, stem_per_forward * n) or got["devices"] != ["cuda:0"]:
            fail(f"{label}: launches {got['launches']} in {n} replays, expected "
                 f"({5 * n}, {stem_per_forward * n}); outputs on {got['devices']}")
        out = torch.load(spec["bundles"][label]["out"])
        views = out["heatmap"].shape[1]
        shapes = {"joints_cam": (1, 21, 3), "joints_crop_img": (1, views, 21, 2),
                  "heatmap": (1, views, 21, 32, 32), "vertices": (1, 778, 3)}
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape or out[key].dtype != torch.float32 or \
                    not torch.isfinite(out[key]).all():
                fail(f"{label}: {key} is {tuple(out[key].shape)} {out[key].dtype}, expected "
                     f"{shape} fp32 finite")
        compare_paths({k: v.cuda() for k, v in out.items()}, ref["out"], label,
                      "replay vs live infer_step")
        with torch.inference_mode():
            same_joints = ref["mesh_stage"](out["joints_cam"].cuda() * 1000.0)
        err = max_err(out["vertices"].cuda(), same_joints)
        live_err = max_err(out["vertices"].cuda(), ref["out"]["vertices"])
        print(f"{label} replay vertices: max_abs_err={err:.3e} mm against the mesh stage on the "
              f"replay's joints (tol {MESH_ATOL_MM:.0e}), {live_err:.3e} mm against the live "
              f"step's", flush=True)
        if not err <= MESH_ATOL_MM:
            fail(f"{label}: the replay's vertices differ from the mesh stage's by {err} mm")
        replay, eager = got["p50_ms"], got["eager_p50_ms"]
        print(f"{label} (exported on {got['exported_on']}): launches K1={got['launches'][0]} "
              f"K2={got['launches'][1]} in {n} replays; in one process, in turns replay, eager, "
              f"eager, replay ({repeats[0]} + {repeats[1]} each): replay p50_ms "
              f"{replay[0]:.4f}, {replay[1]:.4f}; eager infer_step p50_ms {eager[0]:.4f}, "
              f"{eager[1]:.4f}; load {got['load_s']:.1f} s; {card_line}", flush=True)
        rows[label] = {"launches": tuple(got["launches"]), "k1_designs": got["k1_designs"],
                       "replays": n,
                       "p50_ms": min(replay), "eager_p50_ms": min(eager)}
    return rows


def _host_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """The host's own time a call (perf_counter) over ``iters`` back-to-back
    calls with no wait, the card idle at the start: 200 launches stay far
    below the launch queue's depth, so the host never waits for the card,
    whatever the kernel's device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / iters * 1e3


def dispatch_cost(attention_ops, stem_ops, gen, card_line: str) -> dict:
    """Host time that a custom op's dispatch adds to its kernel's launch:
    the host's time a call (_host_ms) through the op (``fused_attention``,
    ``stem_conv_nchw``) and through its CUDA implementation called directly
    (``_launch``), at the main path's (168, 168) and x [8, 3, 256^2], under
    inference_mode, in turns a b b a with the lower of the two kept."""
    q, k, v = (torch.randn(1, 168, 8, 128, generator=gen, device="cuda").transpose(1, 2)
               for _ in range(3))
    x = torch.randn(8, 256, 256, 3, generator=gen, device="cuda").permute(0, 3, 1, 2)
    weight = torch.randn(64, 3, 7, 7, generator=gen, device="cuda") * 0.05
    scale = 128 ** -0.5
    fns = {"K1 op": lambda: attention_ops.fused_attention(q, k, v, scale),
           "K1 launch": lambda: attention_ops._launch(q, k, v, scale),
           "K2 op": lambda: stem_ops.stem_conv_nchw(x, weight),
           "K2 launch": lambda: stem_ops._launch(x, weight)}
    ms = {name: float("inf") for name in fns}
    with torch.inference_mode():
        for name in list(fns) + list(reversed(fns)):
            ms[name] = min(ms[name], _host_ms(fns[name]))
    added = {kernel: ms[f"{kernel} op"] - ms[f"{kernel} launch"] for kernel in ("K1", "K2")}
    per_forward = 5 * added["K1"] + added["K2"]
    print(f"custom-op dispatch: host ms a call {', '.join(f'{n}={t:.5f}' for n, t in ms.items())}"
          f"; the op adds K1 {added['K1'] * 1e3:.2f} us, K2 {added['K2'] * 1e3:.2f} us a call, "
          f"{per_forward * 1e3:.2f} us a forward (5 + 1 calls); {card_line}", flush=True)
    return {"ms": ms, "added_ms": added, "per_forward_ms": per_forward}


def view_rank(out_dir: str) -> None:
    """One rank of phase 12 (d)'s 1x2 grid, started by parallel.spawn_local_ranks:
    gloo on cuda:0, which both ranks share; infer.prepare's model and batch
    on the DexYCB config. Writes to ``<out_dir>/rank<r>.pt`` the launches of one
    forward, the gathered outputs, the replication check, and the ms of each
    step and of its token all_gather (CUDA events)."""
    import torch.distributed as dist

    from handmvnet_tpu_torch import infer
    from handmvnet_tpu_torch.ops import attention as attention_ops
    from handmvnet_tpu_torch.ops import stem as stem_ops
    from handmvnet_tpu_torch.parallel import view_parallel as vp
    from handmvnet_tpu_torch.parallel.mesh import TIMEOUT

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://", timeout=TIMEOUT)
    group = dist.group.WORLD
    try:
        model, batch, _ = infer.prepare(infer_args(DEXYCB_CONFIG), torch.device("cuda", 0))
        args = [batch[k] for k in INPUT_KEYS]
        mesh = vp.make_inference_mesh(1, VIEW_RANKS, group)
        forward = vp.make_view_parallel_forward(model, mesh)
        reset_launches(attention_ops, stem_ops)
        out = forward(*args)
        torch.cuda.synchronize()
        launches = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
        designs = k1_designs(attention_ops, f"view rank {dist.get_rank(group)}")
        full = vp.gather_outputs(mesh, out)
        cols = vp.make_replication_check(model, mesh)(*args)
        gathers, real = [], vp.gather_views

        def timed(mesh_, x, dim=1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = real(mesh_, x, dim)
            end.record()
            gathers.append((start, end, x.numel() * x.element_size()))
            return y

        vp.gather_views = timed
        try:
            step_ms = step_p50_ms(lambda: forward(*args), VIEW_WARMUP, VIEW_STEPS)["device_ms"]
        finally:
            vp.gather_views = real
        torch.save({"launches": launches, "k1_designs": designs,
                    "out": {k: v.cpu() for k, v in full.items()},
                    "cols": cols.cpu(), "step_ms": step_ms,
                    "gather_ms": [a.elapsed_time(b) for a, b, _ in gathers[VIEW_WARMUP:]],
                    "gather_bytes": gathers[0][2]},
                   Path(out_dir) / f"rank{dist.get_rank(group)}.pt")
    finally:
        dist.destroy_process_group()


def view_phase(attention_ops, stem_ops, card_line: str, tmp: Path) -> dict:
    """Phase 12 (d) and (e). Returns {label: launches, ms}."""
    import importlib.util
    import tempfile

    import torch.distributed as dist

    from handmvnet_tpu_torch import infer
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.parallel import (init_data_parallel, make_inference_mesh,
                                              make_view_parallel_forward, spawn_local_ranks)

    rows = {}
    model, batch, _ = infer.prepare(infer_args(DEXYCB_CONFIG), "cuda")
    args = [batch[k] for k in INPUT_KEYS]
    with torch.inference_mode():
        plain = model(*args)
    with world_of_one():
        device, group = init_data_parallel("cuda")
        try:
            mesh = make_inference_mesh(1, 1, group)
            reset_launches(attention_ops, stem_ops)
            out = make_view_parallel_forward(model, mesh)(*args)
            torch.cuda.synchronize()
            got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
            unequal = [k for k in plain if not torch.equal(out[k], plain[k])]
            print(f"view-parallel 1x1, world size 1 on NCCL (env://): launches K1={got[0]} "
                  f"K2={got[1]}; bitwise equal to the plain forward on "
                  f"{sorted(set(plain) - set(unequal))}", flush=True)
            if got != (5, 1) or unequal:
                fail(f"view-parallel 1x1: launches {got}, expected (5, 1); differs from the "
                     f"plain forward on {unequal}")
            rows["view_nccl"] = {"launches": got,
                                 "k1_designs": k1_designs(attention_ops, "view-parallel 1x1")}

            # (e) infer.py --view-mesh 1x1: its steps in this rank, the drawable panels
            e_args = infer_args(CONFIG, "--view-mesh", "1x1", "--output-dir", str(tmp / "infer"))
            d, v = infer.view_mesh_shape(e_args, Config.from_yaml(CONFIG))
            reset_launches(attention_ops, stem_ops)
            batch_e, out_e, mesh_stage = infer.view_parallel_step(e_args, d, v, device, group)
            torch.cuda.synchronize()
            got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
            drawable = [n for n, lib in infer.PANELS.items() if importlib.util.find_spec(lib)]
            paths = infer.write_panels(Path(e_args.output_dir), batch_e, out_e,
                                       mesh_stage.mano.model.faces, drawable)
            sizes = {p.name: p.stat().st_size for p in paths}
            print(f"infer.py --view-mesh 1x1 (world size 1 on NCCL): launches K1={got[0]} "
                  f"K2={got[1]}; vertices {tuple(out_e['vertices'].shape)}; panels {sizes}",
                  flush=True)
            if got != (5, 1) or tuple(out_e["vertices"].shape) != (1, 778, 3) or \
                    not all(torch.isfinite(t).all() for t in out_e.values()) or \
                    not all(sizes.values()):
                fail(f"infer.py --view-mesh 1x1: launches {got}, outputs "
                     f"{ {k: tuple(t.shape) for k, t in out_e.items()} }, panels {sizes}")
            rows["infer_view"] = {"launches": got, "k1_designs": k1_designs(
                attention_ops, "infer.py --view-mesh 1x1")}
        finally:
            dist.destroy_process_group()

    # the 1x2 grid: two processes sharing the card over gloo
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_view_") as out_dir:
        t0 = time.perf_counter()
        spawn_local_ranks(view_rank, (out_dir,), VIEW_RANKS)
        secs = time.perf_counter() - t0
        ranks = [torch.load(Path(out_dir) / f"rank{r}.pt") for r in range(VIEW_RANKS)]
    label = f"view-parallel 1x{VIEW_RANKS}, {VIEW_RANKS} ranks sharing the card over gloo"
    for r, seen in enumerate(ranks):
        if tuple(seen["launches"]) != (5, 1):
            fail(f"{label}: rank {r} launches {seen['launches']}, expected (5, 1)")
        for key, tol in VIEW_TOLS.items():
            err = max_err(seen["out"][key].cuda(), plain[key])
            print(f"{label}, rank {r}, {key} against the plain forward: max_abs_err={err:.3e} "
                  f"tol={tol:.0e}", flush=True)
            if not err <= tol:
                fail(f"{label}: rank {r}'s {key} differs from the plain forward by {err}")
        cols = seen["cols"]
        if not torch.equal(cols, cols[:, :1].expand_as(cols)):
            fail(f"{label}: rank {r}'s view columns hold different joints_cam")
        print(f"{label}, rank {r}: launches K1={seen['launches'][0]} K2={seen['launches'][1]} "
              f"(x [{8 // VIEW_RANKS}, 3, 256, 256]); joints_cam bitwise equal across columns; "
              f"step p50_ms {seen['step_ms']:.4f} over {VIEW_STEPS}; token all_gather of "
              f"{seen['gather_bytes']} bytes: median {np.median(seen['gather_ms']):.4f} ms "
              f"(a shared-card figure, not a scaling figure); {card_line}", flush=True)
    print(f"{label}: {secs:.1f} s in all (process start included)", flush=True)
    rows["view"] = {"launches": tuple(ranks[0]["launches"]),
                    "k1_designs": ranks[0]["k1_designs"], "step_ms": ranks[0]["step_ms"],
                    "gather_ms": float(np.median(ranks[0]["gather_ms"]))}
    return rows


def family_config(config: Path = DEXYCB_CONFIG, **model):
    """A release config with its model fields replaced (``model``) and, with
    ``root_relative``, its train.root_relative."""
    from handmvnet_tpu_torch.config import Config

    cfg = Config.from_yaml(config)
    root_relative = model.pop("root_relative", cfg.train.root_relative)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model),
                               train=dataclasses.replace(cfg.train, root_relative=root_relative))


def card_gflops(model, inputs) -> float:
    """GFLOPs of one forward on the card, as torch's flop counter sees the
    convolutions and matmuls, with K1's and K2's work (custom ops, which it
    does not know) counted from their shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    def attention_flops(q, k, v, scale, *, out_shape=None, **kwargs) -> int:
        b, h, nq, d = q
        return 4 * b * h * nq * k[2] * d  # q k^T and p v

    def stem_flops(x, weight, *, out_shape=None, **kwargs) -> int:
        return 2 * math.prod(out_shape) * math.prod(weight[1:])

    mapping = {torch.ops.hmv.fused_attention: attention_flops,
               torch.ops.hmv.stem_conv: stem_flops}
    with torch.inference_mode(), FlopCounterMode(display=False, custom_mapping=mapping) as c:
        model(*inputs)
    return c.get_total_flops() / 1e9


def family_serving(attention_ops, stem_ops, card_line: str) -> dict:
    """Phase 13 (a) and (b): the default ResNets at early_return 3 and the
    learnable-query fusion on the DexYCB release model, each a short
    eval_fps protocol with its launches checked, its p50 and GFLOPs, and the
    kernel path against the plain path."""
    from handmvnet_tpu_torch.eval_fps import build_model, model_inputs
    from handmvnet_tpu_torch.profile_forward import profile_calls

    cases = {f"resnet{t}": ({"backbone_type": t, "backbone_early_return": 3}, 5)
             for t in FAMILY_TYPES}
    cases["learnable_query"] = ({"fusion": "cross_attn_learnable_query"}, 0)
    rows = {}
    for name, (fields, k1) in cases.items():
        cfg = family_config(**fields)
        launches, _, stats = serve(attention_ops, stem_ops, cfg, f"family {name}", "float32",
                                   True, stem_per_forward=1, warmup=FAMILY_WARMUP,
                                   iters=FAMILY_ITERS, attn_per_forward=k1)
        model = build_model(cfg, 8, 256, "cuda")
        inputs = model_inputs(8, 256, "cuda", torch.float32)
        gflops = card_gflops(model, inputs)
        # the forward alone: device time and ops (profiler), CUDA-graph replay
        prof = profile_calls(lambda: model(*inputs), warmup=3, iters=20, profiled=5, top=3)
        print(f"family {name}: p50_ms={stats['p50_ms']:.4f} forward_gflops={gflops:.3f}; "
              f"forward alone: wall_p50_ms={prof['wall_p50_ms']:.3f} device_ms="
              f"{prof['device_ms']:.3f} device_ops={prof['device_ops_per_forward']:.0f} "
              f"graph_ms={prof['graph_ms']:.3f} "
              f"TFLOP/s={gflops / prof['device_ms']:.2f} ({card_line})", flush=True)
        del model
        # The learnable-query blocks have no LayerNorm, so on random weights (the
        # N(0, 1) probe, five residual blocks) joints_cam reaches ~340 m: judged
        # relative to its largest value, as fp32's rounding scales with it
        serve_kernel_vs_plain(attention_ops, stem_ops, cfg, f"family {name}",
                              relative=("joints_cam",) if k1 == 0 else ())
        rows[name] = {"launches": launches, "k1_designs": stats["k1_designs"],
                      "p50_ms": stats["p50_ms"], "gflops": gflops,
                      "forwards": stats["forwards"], "forward_device_ms": prof["device_ms"]}
        torch.cuda.empty_cache()
    return rows


def root_train_kernel_vs_plain(attention_ops, stem_ops) -> dict:
    """Phase 13 (c): two fp32 optimizer steps (accumulation 2) of the HO3D
    release recipe with train.root_relative off, dropout 0. Each step runs
    on the kernel path and, from a copy of the same state (weights, AdamW
    moments, BN statistics), on the plain path: phase 6's limits on that
    step's loss terms and gradient norm; the kernel path's update carries
    on. (Two trajectories would part after the first step: Adam's first
    update is ~lr sign(g), so a leaf whose gradient is ~0 moves by +-lr on
    either path.) The kernel path's launches are counted from 0: K1 16 and
    K2 2 a step.

    Phase 6's scaled-head rule judges the gradient norm only where the x1000
    soft-argmax is not saturated, so the judged run scales the heatmap
    head's last conv by 1e-3 before every step, not only the first: AdamW's
    first update moves each of its weights by ~lr = 1e-4, several times
    their scaled size and all along the gradient, and saturates the
    soft-argmax again. From such a state the two paths' fp32 roundings (the
    kernel path's the larger, K2 being 3xTF32) part the gradient norms by
    up to rel ~1e-3. The judged run prints, not judged, each step's mean
    peak probability of the soft-argmax before and after the rescale, and
    both paths' gradient norms against the plain path's in float64 from the
    same state. The comparison runs under deterministic algorithms:
    otherwise the first step's atomics flip the sign of near-zero
    gradients, each flip moves a weight by 2 lr, and every run judges its
    second step at another state.

    Every view sits at the root camera's pose, as in train_kernel_vs_plain,
    and the root decoder's last layer is scaled by 1e-2 with its bias at the
    batch's mean root, so that the predicted root, which the reprojection
    adds to the joints, lies in front of the cameras as a trained model's
    does (tests/test_torch_root.py does the same)."""
    import copy

    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.train import accumulation
    from handmvnet_tpu_torch.train_step import (
        accumulate_grads, batch_to_device, build_model, create_train_state, forward_loss,
        optimizer_step)

    base = train_config("float32")
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, root_relative=False))
    accum = accumulation(cfg)
    data = synthetic_batch(TRAIN_BATCH, TRAIN_VIEWS, cfg.data.image_size, cfg.data.heatmap_size,
                           seed=1)
    data["extrinsic"][:] = np.eye(4, dtype=np.float32)
    batch = batch_to_device(data, "cuda")
    mean_root = torch.from_numpy(data["root_joint"].mean(axis=(0, 1)) / 1000.0).cuda()
    steps, bad, launches = 2, [], (0, 0)
    for head_scale in (1.0, 1e-3):
        model = build_model(cfg, "cuda", seed=1, dropout=0.0)
        with torch.no_grad():
            model.root_decoder.joints_fc2.weight.mul_(1e-2)
            model.root_decoder.joints_fc2.bias.copy_(mean_root)
        state = create_train_state(model, cfg, 1000)
        label = f"root training fp32, kernel path vs plain path, head x{head_scale:g}"
        launches, designs = (0, 0), {}
        judged = head_scale != 1.0

        def peak() -> float:
            # the first microbatch on a copy (train mode moves BN statistics)
            micro = {k: v[:TRAIN_BATCH // accum] for k, v in batch.items()}
            with torch.no_grad():
                hm = forward_loss(copy.deepcopy(model).train(), cfg, micro)[1]["heatmap"]
            return float(torch.softmax(hm.flatten(-2) * 1000.0, -1).amax(-1).mean())

        for i in range(steps):
            before = peak() if judged else None
            with torch.no_grad():
                for p in model.pose_net[-1].parameters():
                    p.mul_(head_scale)
            plain_state = copy.deepcopy(state)
            if judged:
                f64 = copy.deepcopy(state)
                f64.model.double()
                with plain_kernels(attention_ops, stem_ops):
                    accumulate_grads(f64, cfg, {k: v.double() if v.is_floating_point() else v
                                                for k, v in batch.items()}, None, accum)
                n64 = float(torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(p.grad) for p in f64.model.parameters()
                     if p.grad is not None])))
                del f64
                after = peak()
            reset_launches(attention_ops, stem_ops)
            lk = {k: float(v) for k, v in accumulate_grads(state, cfg, batch, None, accum).items()}
            nk = float(optimizer_step(state, cfg))
            torch.cuda.synchronize()
            launches = (launches[0] + attention_ops.fused_attention.launches,
                        launches[1] + stem_ops.stem_conv_nchw.launches)
            designs = add_designs(designs, k1_designs(attention_ops, f"{label}, step {i}"))
            with plain_kernels(attention_ops, stem_ops):
                lp = {k: float(v) for k, v in
                      accumulate_grads(plain_state, cfg, batch, None, accum).items()}
                np_ = float(optimizer_step(plain_state, cfg))
            del plain_state
            if "root_3d_loss" not in lp:
                fail(f"{label}: no root_3d_loss in {sorted(lp)}")
            for key in lp:
                rel = abs(lk[key] - lp[key]) / abs(lp[key])
                print(f"{label}, step {i}, {key}: {lk[key]:.6f} vs {lp[key]:.6f} "
                      f"rel={rel:.3e} tol=1e-4", flush=True)
                if not (math.isfinite(lk[key]) and rel <= 1e-4):
                    bad.append(f"head x{head_scale:g} step {i} {key} rel {rel}")
            rel = abs(nk - np_) / np_
            print(f"{label}, step {i}, gradient norm: {nk:.6e} vs {np_:.6e} rel={rel:.3e} "
                  + ("tol=1e-3" if judged else "not judged"), flush=True)
            if judged:
                print(f"   soft-argmax mean peak {before:.4f} before the rescale, {after:.4f} "
                      f"after; gradient norm against float64 plain {n64:.6e}: kernel path "
                      f"rel={abs(nk - n64) / n64:.3e}, plain path rel={abs(np_ - n64) / n64:.3e}"
                      " (not judged)", flush=True)
                if not rel <= 1e-3:
                    bad.append(f"head x{head_scale:g} step {i} gradient norm rel {rel}")
        print(f"{label}: launches K1={launches[0]} K2={launches[1]} in {steps} steps", flush=True)
        if launches != (16 * steps, 2 * steps):
            fail(f"{label}: kernel launches {launches}, expected {(16 * steps, 2 * steps)} "
                 "(16 and 2 per optimizer step)")
    if bad:
        fail(f"root training: the kernel path disagrees with the plain path: {bad}")
    return {"launches": launches, "k1_designs": designs, "steps": steps}


def root_serving(attention_ops, stem_ops, card_line: str) -> dict:
    """Phase 13 (c): the DexYCB release model with the absolute-root branch,
    b1 x 8 x 256^2, random weights: FAMILY_WARMUP + FAMILY_ITERS forwards
    with the counters set to 0 just before and read just after (K1 8, K2 1
    a forward), root_joint [1, 1, 3] fp32 and finite, the p50 on CUDA
    events, and the kernel path against the plain path."""
    from handmvnet_tpu_torch.eval_fps import model_inputs, random_state_dict
    from handmvnet_tpu_torch.models import HandMvNet

    cfg = family_config(root_relative=False)
    model = HandMvNet(cfg.model, image_size=256, heatmap_size=32, root_relative=False)
    model.load_state_dict(random_state_dict(model, 0))
    model = model.eval().cuda()
    inputs = model_inputs(8, 256, "cuda", torch.float32)
    with torch.inference_mode():
        for _ in range(FAMILY_WARMUP):
            model(*inputs)
        torch.cuda.synchronize()
        reset_launches(attention_ops, stem_ops)
        lat = []
        for _ in range(FAMILY_ITERS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = model(*inputs)
            end.record()
            end.synchronize()
            lat.append(start.elapsed_time(end))
        launches = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
        designs = k1_designs(attention_ops, "root serving fp32")
        with plain_kernels(attention_ops, stem_ops):
            out_p = model(*inputs)
    p50 = float(np.percentile(lat, 50))
    print(f"root serving fp32 b1 x 8: p50_ms={p50:.4f} forwards={FAMILY_ITERS} launches "
          f"K1={launches[0]} K2={launches[1]} ({card_line})", flush=True)
    if launches != (8 * FAMILY_ITERS, FAMILY_ITERS):
        fail(f"root serving: kernel launches {launches}, expected "
             f"{(8 * FAMILY_ITERS, FAMILY_ITERS)} (8 and 1 per forward)")
    root = out["root_joint"]
    if tuple(root.shape) != (1, 1, 3) or root.dtype != torch.float32 or \
            not torch.isfinite(root).all():
        fail(f"root serving: root_joint {tuple(root.shape)} {root.dtype} not finite fp32")
    compare_paths(out, out_p, "root serving", tols={**PATH_TOLS, "root_joint": ROOT_TOL_M})
    return {"launches": launches, "k1_designs": designs, "p50_ms": p50, "forwards": FAMILY_ITERS}


def hourglass_check() -> None:
    """Phase 13 (d): the dormant hourglass backbones at their defaults (4
    stacks of 256 channels, depth 4), one forward of one 256^2 image on the
    card against the same module on the CPU (fp32; no kernel of the port)."""
    from handmvnet_tpu_torch.models.backbones.hourglass import (
        StackedBisectedHourglass, StackedHourglass)

    x = torch.randn(1, 3, 256, 256, generator=torch.Generator().manual_seed(0))
    for cls in (StackedHourglass, StackedBisectedHourglass):
        torch.manual_seed(0)
        model = cls().eval()
        with torch.inference_mode():
            ref = model(x)
            got = model.cuda()(x.cuda())
        torch.cuda.synchronize()
        for i, (g, r) in enumerate(zip(got, ref)):
            err, top = max_err(g.cpu(), r), float(r.abs().max())
            print(f"{cls.__name__} output {i} {tuple(g.shape)}: card vs CPU max_abs_err="
                  f"{err:.3e} (max|cpu|={top:.3e}) tol={HOURGLASS_REL:.0e} x max", flush=True)
            if g.device.type != "cuda" or not err <= HOURGLASS_REL * top:
                fail(f"{cls.__name__} output {i}: card and CPU disagree, {err} > "
                     f"{HOURGLASS_REL} x {top}")
        del model
    torch.cuda.empty_cache()


def family_phase(attention_ops, stem_ops, gen, card_line: str) -> dict:
    """Phase 13: the rest of the model family (see the module docstring)."""
    out = {"serving": family_serving(attention_ops, stem_ops, card_line)}
    out["root_attn"] = {d: check_attention(attention_ops, d, gen, ROOT_ATTN_SHAPES, 1)
                        for d in DTYPES.values()}
    out["root_train_attn"] = {d: check_attention(attention_ops, d, gen, ROOT_TRAIN_ATTN_SHAPES,
                                                 TRAIN_ATTN_BATCH) for d in DTYPES.values()}
    out["root_attn_bwd"] = {d: check_attention_backward(
        attention_ops, d, gen, {s: 1 for s in ROOT_TRAIN_ATTN_SHAPES}) for d in DTYPES.values()}
    with deterministic():
        out["root_train"] = root_train_kernel_vs_plain(attention_ops, stem_ops)
    out["root_serving"] = root_serving(attention_ops, stem_ops, card_line)
    hourglass_check()
    return out

def triangulation_inputs(rng: np.random.Generator) -> dict:
    """TRI_BATCH hands of 21 joints seen by a ring of TRI_VIEWS cameras
    (data.synthetic's consistent rig, fx = fy = 600 at 640 x 480): the world
    points, their projections with 0.3 px of noise, the same with a fifth of
    the (view, joint) entries thrown 150-400 px off (RANSAC's outliers),
    confidences that give the outliers 0-0.4 and the others 0.6-1, and the
    intrinsics and world -> camera extrinsics, float32 on the CPU."""
    from handmvnet_tpu_torch.data.synthetic import _consistent_rig

    b, v, j = TRI_BATCH, TRI_VIEWS, 21
    target = np.array([0.0, 0.0, 0.55])
    w2c = np.linalg.inv(_consistent_rig(v, target))  # [V, 4, 4]
    k = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]])
    world = target + rng.normal(size=(b, j, 3)) * 0.04
    cam = np.einsum("vik,bjk->bvji", w2c[:, :3, :3], world) + w2c[None, :, None, :3, 3]
    uv = cam[..., :2] / cam[..., 2:3] * 600.0 + [320.0, 240.0]
    clean = uv + rng.normal(size=uv.shape) * 0.3
    off = rng.uniform(150, 400, size=uv.shape) * rng.choice([-1, 1], size=uv.shape)
    outlier = rng.uniform(size=uv.shape[:-1]) < 0.2
    noisy = np.where(outlier[..., None], clean + off, clean)
    conf = np.where(outlier, rng.uniform(0.0, 0.4, outlier.shape),
                    rng.uniform(0.6, 1.0, outlier.shape))
    t = {"world": world, "clean": clean, "noisy": noisy, "conf": conf,
         "ks": np.broadcast_to(k, (b, v, 3, 3)), "extrs": np.broadcast_to(w2c, (b, v, 4, 4))}
    return {name: torch.from_numpy(np.ascontiguousarray(a, np.float32)) for name, a in t.items()}


def triangulation_check() -> None:
    """Phase 14 (a): the DLT, RANSAC and confidence-masked triangulations on
    the card against the same functions on the CPU (rel TRI_REL of the
    points' scale), and each against the true points, printed."""
    from handmvnet_tpu_torch.ops import triangulation as tri

    t = triangulation_inputs(np.random.default_rng(0))

    def run(d: dict) -> dict:
        return {
            "DLT": tri.batch_triangulate_dlt(d["clean"], d["ks"], d["extrs"]),
            "RANSAC": tri.batch_triangulate_dlt_ransac(d["noisy"], d["ks"], d["extrs"],
                                                       n_cams=3, n_iterations=100),
            "confident": torch.stack([tri.triangulate_dlt_confident(
                d["noisy"][i], d["conf"][i], d["ks"][i], d["extrs"][i])
                for i in range(TRI_BATCH)]),
        }

    cpu = run(t)
    card = run({k: v.cuda() for k, v in t.items()})
    torch.cuda.synchronize()
    scale = float(t["world"].abs().max())
    for name, ref in cpu.items():
        err = max_err(card[name].cpu(), ref)
        truth = max_err(ref, t["world"])
        print(f"triangulation {name} at B {TRI_BATCH} x V {TRI_VIEWS} x J 21: card vs CPU "
              f"max_abs_err={err:.3e} m (scale {scale:.3f} m, tol {TRI_REL * scale:.1e}); "
              f"CPU vs the true points {truth:.3e} m", flush=True)
        if card[name].device.type != "cuda" or not err <= TRI_REL * scale:
            fail(f"triangulation {name}: the card disagrees with the CPU by {err} m")


def sanity_check(tmp: Path, libs: dict) -> dict:
    """Phase 14 (a): sanity.main on the HO3D release config against
    consistent shards written on the card, and the drawable GT panels."""
    from handmvnet_tpu_torch import sanity
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards

    shards = tmp / "shards"
    t0 = time.perf_counter()
    for split, n, seed in (("train", 9, 0), ("test", 3, 7)):
        write_synthetic_ho3d_shards(shards, num_shards=n, samples_per_shard=2, num_views=5,
                                    split=split, seed=seed, consistent_geometry=True,
                                    device="cuda")
    config = tmp / "HO3D_sanity.yaml"
    text, n_data = re.subn(r"(?m)^  dataset_dir: .*$", f"  dataset_dir: {shards}",
                           CONFIG.read_text())
    if n_data != 1:
        fail(f"{CONFIG.name}: no dataset_dir line to point at the sanity shards")
    config.write_text(text)
    t1 = time.perf_counter()
    try:
        summary = sanity.main(["--config", str(config), "--device", "cuda"])
    except SystemExit as e:
        fail(f"sanity.main on the card: {e}")
    t2 = time.perf_counter()
    mpjpe = summary["triangulation"]["mpjpe_mm"]
    print(f"sanity.main --device cuda: triangulation MPJPE {mpjpe:.6f} mm over "
          f"{summary['triangulation']['num_samples']} samples, extrinsics drift "
          f"{summary['extrinsics']['max_abs_drift']:.1e}; shards written on the card in "
          f"{t1 - t0:.1f} s, checks {t2 - t1:.1f} s", flush=True)
    drawable = tuple(n for n, lib in sanity.PANELS.items() if libs[lib])
    for name in sorted(set(sanity.PANELS) - set(drawable)):
        print(f"sanity panels: {name} not drawn: {sanity.PANELS[name]} is absent", flush=True)
    panels = sanity.gt_overlay_panels(Config.from_yaml(config), out_dir=tmp / "panels",
                                      device="cuda", names=drawable)
    for name, canvas in panels.items():
        if canvas.ndim != 3 or not float(canvas.std()) > 1.0:
            fail(f"sanity panel {name} is blank or not an image")
    missing = [n for n in drawable if not (tmp / "panels" / n).is_file()]
    if missing:
        fail(f"sanity panels not written: {missing}")
    print(f"sanity panels: wrote {' '.join(drawable)} ({time.perf_counter() - t2:.1f} s)",
          flush=True)
    return {"mpjpe_mm": mpjpe}


def q8_conv_check(card_line: str) -> dict:
    """Phase 14 (b): every Q8Conv of the int8 main-path model at its input of
    one fp32 forward: the int32 sums on the card bitwise equal to the CPU's
    on the same int8 operands; then the forward's int8 convs timed against
    the same convs in fp32 and bf16 F.conv2d (CUDA events, back to back)."""
    from handmvnet_tpu_torch.eval_fps import build_model, model_inputs
    from handmvnet_tpu_torch.ops.quant import Q8Conv, q8_conv, q8_conv_int32, quantize_sym

    model = build_model(family_config(CONFIG, backbone_int8=True), 8, 256, "cuda")
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: calls.append((mod, args[0])))
             for m in model.modules() if isinstance(m, Q8Conv)]
    with torch.inference_mode():
        model(*model_inputs(8, 256, "cuda", torch.float32))
    for h in hooks:
        h.remove()
    shapes = set()
    with torch.inference_mode():
        for mod, x in calls:
            xq, _ = quantize_sym(x)
            wq, _ = quantize_sym(mod.weight, dim=(1, 2, 3))
            s, p = mod.stride[0], mod.padding[0]
            got = q8_conv_int32(xq, wq, s, p)
            ref = q8_conv_int32(xq.cpu(), wq.cpu(), s, p)
            if got.device.type != "cuda" or got.dtype != torch.int32 or \
                    not torch.equal(got.cpu(), ref):
                fail(f"q8_conv_int32 at x {tuple(x.shape)}, w {tuple(mod.weight.shape)}, stride "
                     f"{s}: the card's int32 sums differ from the CPU's")
            shapes.add((tuple(x.shape), tuple(mod.weight.shape), s, p))

        def int8():
            for mod, x in calls:
                q8_conv(x, mod.weight, mod.stride[0], mod.padding[0])

        def plain(dtype):
            ws = [(mod.weight.to(dtype), x.to(dtype)) for mod, x in calls]

            def run():
                for (mod, _), (w, x) in zip(calls, ws):
                    F.conv2d(x, w, stride=mod.stride, padding=mod.padding)
            return run

        f32, bf16 = plain(torch.float32), plain(torch.bfloat16)
        ms = {name: min(_eager_ms(fn, 10, 3) for _ in range(2))
              for name, fn in (("int8", int8), ("fp32", f32), ("bf16", bf16))}
    print(f"q8_conv_int32 card vs CPU: bitwise equal int32 sums at {len(shapes)} conv shapes "
          f"({len(calls)} convs a forward); the forward's block convs back to back: int8 path "
          f"{ms['int8']:.3f} ms, F.conv2d fp32 {ms['fp32']:.3f} ms, bf16 {ms['bf16']:.3f} ms "
          f"({card_line})", flush=True)
    return {"shapes": len(shapes), "convs": len(calls), "ms": ms}


def int8_serving(attention_ops, stem_ops, card_line: str, tmp: Path) -> dict:
    """Phase 14 (b): the int8 main path (see the module docstring)."""
    from handmvnet_tpu_torch import export, infer
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.eval_fps import build_model, model_inputs
    from handmvnet_tpu_torch.profile_forward import profile_calls

    out = {"q8": q8_conv_check(card_line)}
    cfg, exact = family_config(CONFIG, backbone_int8=True), Config.from_yaml(CONFIG)
    launches, designs, p50 = {}, {}, {}
    for name in DTYPES:
        for label, c in (("int8 off", exact), ("int8", cfg)):
            got, _, stats = serve(attention_ops, stem_ops, c, label, name, True,
                                  stem_per_forward=1, warmup=HR_WARMUP, iters=HR_ITERS)
            p50[(label, name)] = stats["p50_ms"]
            if label == "int8":
                launches[DTYPES[name]] = got
                designs[DTYPES[name]] = stats["k1_designs"]
        print(f"int8 serving {name}: p50_ms {p50[('int8', name)]:.4f} against "
              f"{p50[('int8 off', name)]:.4f} with int8 off ({HR_WARMUP} + 2 x {HR_ITERS} steps "
              f"each, the mesh stage included; {card_line})", flush=True)
    out["launches"], out["k1_designs"], out["p50"] = launches, designs, p50

    # the int8 outputs against the exact model's, on the same weights and request
    images = None
    for name, dtype in DTYPES.items():
        res = {}
        for label, c in (("exact", exact), ("int8", cfg)):
            model = build_model(c, 8, 256, "cuda", dtype)
            inputs = model_inputs(8, 256, "cuda", dtype)
            images = inputs[0].reshape(8, 256, 256, 3).permute(0, 3, 1, 2)
            with torch.inference_mode():
                res[label] = (model.backbone(images).float(), model(*inputs))
            if label == "int8":
                prof = profile_calls(lambda: model(*inputs), warmup=3, iters=20, profiled=5, top=3)
                print(f"int8 {name} forward alone: wall_p50_ms={prof['wall_p50_ms']:.3f} "
                      f"device_ms={prof['device_ms']:.3f} device_ops="
                      f"{prof['device_ops_per_forward']:.0f} "
                      f"graph_ms={prof['graph_ms']:.3f} ({card_line})", flush=True)
                out[f"device_ms_{name}"] = prof["device_ms"]
            del model
        a, b = (res[k][0].flatten().cpu().numpy() for k in ("exact", "int8"))
        corr = float(np.corrcoef(a, b)[0, 1])
        px = float((res["int8"][1]["joints_crop_img"] - res["exact"][1]["joints_crop_img"])
                   .abs().median())
        cam = max_err(res["int8"][1]["joints_cam"], res["exact"][1]["joints_cam"])
        print(f"int8 vs exact {name}: backbone map correlation {corr:.7f} (> {INT8_CORR}), "
              f"median joints_crop_img delta {px:.4f} px (< {INT8_MEDIAN_PX}), joints_cam "
              f"max_abs_err {cam:.3e} m", flush=True)
        if not (corr > INT8_CORR and px < INT8_MEDIAN_PX):
            fail(f"int8 {name}: backbone correlation {corr} or median crop delta {px} px "
                 "outside the JAX package's bounds")
        out[f"corr_{name}"], out[f"median_px_{name}"] = corr, px

    serve_kernel_vs_plain(attention_ops, stem_ops, cfg, "int8")

    # an export bundle of the int8 model, replayed against the live step
    config = tmp / "HO3D_int8.yaml"
    text, n = re.subn(r"(?m)^model:$", "model:\n  backbone_int8: true", CONFIG.read_text())
    if n != 1:
        fail(f"{CONFIG.name}: no model: line to set backbone_int8 under")
    config.write_text(text)
    t0 = time.perf_counter()
    export.main(["--config", str(config), "--out", str(tmp / "bundle"), "--device", "cuda"])
    fn, meta = export.load_bundle(tmp / "bundle", "cuda")
    model, batch, mesh_stage = infer.prepare(infer_args(config), "cuda")
    if not model.cfg.backbone_int8:
        fail("the int8 config did not reach the model")
    live = infer.infer_step(model, mesh_stage, batch)
    reset_launches(attention_ops, stem_ops)
    replay = fn(*(batch[k] for k in INPUT_KEYS))
    torch.cuda.synchronize()
    got = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    print(f"int8 export: bundle written and loaded in {time.perf_counter() - t0:.1f} s, "
          f"exported on {meta['device']}; one replay launches K1={got[0]} K2={got[1]}",
          flush=True)
    if got != (5, 1):
        fail(f"the int8 bundle's replay launched {got}, expected (5, 1)")
    compare_paths(replay, live, "int8 export", "replay vs live infer_step")
    out["export_launches"] = got
    return out


def remat_run(attention_ops, stem_ops, config: Path, remat: bool, stem_per_step: int) -> dict:
    """Phase 14 (c): REMAT_STEPS fp32 optimizer steps of the release recipe
    (the synthetic batch of train_run, dropout on) from PyTorch's init at
    seed 0 with train.remat forced, under deterministic algorithms, the
    counters set to 0 just before and read just after; then REMAT_WARMUP +
    REMAT_ITERS steps timed (CUDA events) with their peak allocated memory,
    beside what the process held before the model was built (earlier
    phases' tensors)."""
    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.train import accumulation
    from handmvnet_tpu_torch.train_step import (
        accumulate_grads, batch_to_device, build_model, create_train_state, optimizer_step,
        train_step)

    cfg = train_config("float32", config)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, remat="on" if remat else "off"))
    accum = accumulation(cfg)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    model = build_model(cfg, "cuda", seed=0, accum_steps=accum)
    if model.backbone.remat != remat:
        fail(f"{config.stem}: train.remat {cfg.train.remat} built a backbone with remat "
             f"{model.backbone.remat}")
    state = create_train_state(model, cfg, steps_per_epoch=1000)
    data = synthetic_batch(TRAIN_BATCH, TRAIN_VIEWS, cfg.data.image_size, cfg.data.heatmap_size,
                           seed=0)
    data["extrinsic"][:] = np.eye(4, dtype=np.float32)
    batch = batch_to_device(data, "cuda")
    gen = torch.Generator("cuda")
    losses, norms = [], []
    reset_launches(attention_ops, stem_ops)
    with deterministic():
        for i in range(REMAT_STEPS):
            losses.append(accumulate_grads(state, cfg, batch, gen.manual_seed(i), accum))
            norms.append(optimizer_step(state, cfg))
        torch.cuda.synchronize()
    launches = (attention_ops.fused_attention.launches, stem_ops.stem_conv_nchw.launches)
    designs = k1_designs(attention_ops, f"{config.stem} remat {'on' if remat else 'off'}")
    want = (10 * REMAT_STEPS, stem_per_step * REMAT_STEPS)
    if remat and launches != want:
        fail(f"{config.stem} remat on: kernel launches {launches} in {REMAT_STEPS} steps, "
             f"expected {want}")
    record = {"losses": [{k: float(v) for k, v in l.items()} for l in losses],
              "norms": [float(n) for n in norms], "launches": launches, "k1_designs": designs,
              "stats": {n: b.clone() for n, b in model.named_buffers()
                        if n.endswith(("running_mean", "running_var", "num_batches_tracked"))}}
    for i in range(REMAT_WARMUP):
        train_step(state, cfg, batch, gen.manual_seed(100 + i), accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(REMAT_ITERS):
        train_step(state, cfg, batch, gen.manual_seed(200 + i), accum)
    end.record()
    end.synchronize()
    record["ms"] = start.elapsed_time(end) / REMAT_ITERS
    record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["base_gb"] = base_gb
    del state, model
    torch.cuda.empty_cache()
    return record


def remat_check(attention_ops, stem_ops, card_line: str) -> dict:
    """Phase 14 (c): remat on against off on the ResNet and HR release
    recipes, and resolve_remat's "auto" at every release config's shapes."""
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.train import accumulation
    from handmvnet_tpu_torch.train_step import resolve_remat

    def own(run: dict) -> float:  # the step's peak over what was held before it
        return run["peak_gb"] - run["base_gb"]

    rows = {}
    for name, config, k2 in (("resnet", CONFIG, 2), ("hrnet", HR_CONFIG, 0)):
        off = remat_run(attention_ops, stem_ops, config, False, k2)
        on = remat_run(attention_ops, stem_ops, config, True, k2)
        worst, bitwise = 0.0, True
        for step, (lo, ln) in enumerate(zip(off["losses"], on["losses"])):
            for key in lo:
                worst = max(worst, abs(ln[key] - lo[key]) / max(abs(lo[key]), 1e-30))
                bitwise &= ln[key] == lo[key]
            worst = max(worst, abs(on["norms"][step] - off["norms"][step]) / off["norms"][step])
            bitwise &= on["norms"][step] == off["norms"][step]
        stat_worst = 0.0
        for key, ref in off["stats"].items():
            got = on["stats"][key]
            bitwise &= torch.equal(got, ref)
            stat_worst = max(stat_worst, max_err(got, ref) / max(float(ref.abs().max()), 1e-30))
        print(f"{config.stem} fp32 remat on vs off, {REMAT_STEPS} steps under deterministic "
              f"algorithms: {'bitwise equal' if bitwise else 'not bitwise equal'}; loss terms and "
              f"gradient norm worst rel {worst:.3e}, BN running statistics worst rel "
              f"{stat_worst:.3e} of max (tol {REMAT_REL:.0e}); launches with remat K1="
              f"{on['launches'][0]} K2={on['launches'][1]}", flush=True)
        print(f"   losses by step off {[round(l['loss'], 6) for l in off['losses']]} on "
              f"{[round(l['loss'], 6) for l in on['losses']]}; gradient norms off "
              f"{off['norms']} on {on['norms']}", flush=True)
        if not (worst <= REMAT_REL and stat_worst <= REMAT_REL):
            fail(f"{config.stem}: remat on differs from off: rel {worst}, BN statistics "
                 f"{stat_worst}")
        print(f"{config.stem} fp32 training, batch {TRAIN_BATCH} x {TRAIN_VIEWS} views at "
              f"accumulation 2, {REMAT_WARMUP} + {REMAT_ITERS} steps: remat off ms_per_step="
              f"{off['ms']:.3f} peak_memory_gb={off['peak_gb']:.3f}; remat on ms_per_step="
              f"{on['ms']:.3f} peak_memory_gb={on['peak_gb']:.3f}; held before the model "
              f"{off['base_gb']:.3f} and {on['base_gb']:.3f} GB (x{on['ms'] / off['ms']:.3f} time, "
              f"the step's own peak x{own(on) / own(off):.3f}; {card_line})", flush=True)
        rows[name] = {"launches": on["launches"], "k1_designs": on["k1_designs"],
                      "steps": REMAT_STEPS, "bitwise": bitwise,
                      "worst_rel": max(worst, stat_worst), "ms": {"off": off["ms"], "on": on["ms"]},
                      "peak_gb": {"off": off["peak_gb"], "on": on["peak_gb"]},
                      "held_before_gb": {"off": off["base_gb"], "on": on["base_gb"]}}
    resolved = {}
    for path in sorted((REPO / "configs" / "release").glob("*.yaml")):
        cfg = Config.from_yaml(path)
        for dtype in DTYPES:
            c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype=dtype))
            for world in (1, 2):
                resolved[(path.stem, dtype, world)] = resolve_remat(c, accumulation(c, world))
    print(f"resolve_remat(train.remat auto) at the {len(resolved) // 4} release configs' "
          f"shapes, fp32 and bf16, at 1 and 2 ranks: on at "
          f"{sorted(k for k, v in resolved.items() if v) or 'none'}", flush=True)
    if any(resolved.values()):
        fail("train.remat auto turns remat on at a release shape")
    return rows


def tooling_phase(attention_ops, stem_ops, card_line: str) -> dict:
    """Phase 14: geometry and sanity, the int8 serving path, remat (see the
    module docstring)."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        triangulation_check()
        out["sanity"] = sanity_check(tmp / "sanity", probe_libraries())
        print(f"phase 14 (a) (geometry and sanity): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        (tmp / "int8").mkdir()
        out["int8"] = int8_serving(attention_ops, stem_ops, card_line, tmp / "int8")
        print(f"phase 14 (b) (int8 serving): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["remat"] = remat_check(attention_ops, stem_ops, card_line)
    print(f"phase 14 (c) (remat): {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def config_variant(path: Path, name: str, augment: bool = True, **data) -> Path:
    """A copy of the config ``path`` beside it, ``name``.yaml, with the
    options ``data`` added to its data: section and, without ``augment``,
    the augmentation off."""
    lines = "".join(f"\n  {k}: {json.dumps(v) if isinstance(v, bool) else v}"
                    for k, v in data.items())
    text, n = re.subn(r"(?m)^data:$", "data:" + lines, path.read_text())
    m = 1
    if not augment:
        text, m = re.subn(r"(?m)^  augment: true$", "  augment: false", text)
    if (n, m) != (1, 1):
        fail(f"{path.name}: no data: or augment: true line for the options {data}")
    out = path.parent / f"{name}.yaml"
    out.write_text(text)
    return out


def downscale_check(cfg, card_line: str) -> dict:
    """Phase 15 (a): downscale_frames at DENOMS on the card against the CPU
    on the same frames (bitwise), nvJPEG's decode of the fixture at batch 1
    and 80 and one val batch of the shards; the fixture decoded by nvJPEG and
    downscaled on the card against its cv2 pixels downscaled on the CPU
    (phase 8's nvJPEG limits); the downscale's device ms on that batch."""
    from handmvnet_tpu_torch.data import jpeg
    from handmvnet_tpu_torch.data.ho3d import HO3DDataset
    from handmvnet_tpu_torch.data.loader import BatchLoader

    payload, ref = jpeg.jpeg_fixture()
    batch = next(iter(BatchLoader(HO3DDataset(cfg.data, "val", device="cuda"), EVAL_BATCH, 1)))
    frames = {n: jpeg.decode_jpeg([payload] * n, "cuda") for n in (1, EVAL_BATCH * EVAL_VIEWS)}
    shard = jpeg.decode_jpeg([p for views in batch["full_jpeg"] for p in views], "cuda")
    out = {}
    for d in DENOMS:
        for what, x in (("the fixture at batch 1", frames[1]),
                        ("the fixture at batch 80", frames[EVAL_BATCH * EVAL_VIEWS]),
                        ("a val batch of the shards", shard)):
            on_card = jpeg.downscale_frames(x, d).cpu()
            if not torch.equal(on_card, jpeg.downscale_frames(x.cpu(), d)):
                fail(f"downscale_frames at d = {d} on the card differs from the CPU on {what}")
        want = jpeg.downscale_frames(torch.from_numpy(ref)[None], d).numpy().astype(np.int16)
        worst = (0, 0.0)
        for n, x in frames.items():
            diff = np.abs(jpeg.downscale_frames(x, d).cpu().numpy().astype(np.int16) - want)
            worst = (max(worst[0], int(diff.max())), max(worst[1], float(diff.mean())))
        if not (worst[0] <= jpeg.NVJPEG_MAX_ABS_DIFF and worst[1] <= jpeg.NVJPEG_MEAN_ABS_DIFF):
            fail(f"nvJPEG + downscale at d = {d} is off the fixture's cv2 pixels: {worst}")
        jpeg.downscale_frames(shard, d)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            jpeg.downscale_frames(shard, d)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        nbytes = shard.numel() * (1 + 1 / d ** 2)
        print(f"downscale d = {d}: card = CPU bitwise on the fixture (batch 1, 80) and a val "
              f"batch; nvJPEG + downscale vs the fixture's cv2 pixels downscaled: max_abs="
              f"{worst[0]} (limit {jpeg.NVJPEG_MAX_ABS_DIFF}) mean_abs={worst[1]:.4f} (limit "
              f"{jpeg.NVJPEG_MEAN_ABS_DIFF}); {shard.shape[0]} frames in {ms:.4f} device ms "
              f"(one read and one write at HBM rate {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
              f"{card_line}", flush=True)
        out[d] = {"ms": ms, "max_abs": worst[0], "mean_abs": worst[1]}
    return out


def cache_frames_check(cfg, cached_cfg) -> None:
    """Phase 15 (b): every frame of the val and test stores that eval.py
    built (its by_sample readers) bitwise equal to nvJPEG's decode of the
    same JPEGs in the same batches of ``batch_size`` samples, the samples
    in the order of the reader without the cache."""
    from handmvnet_tpu_torch.data.ho3d import HO3DDataset
    from handmvnet_tpu_torch.data.jpeg import decode_jpeg

    bs = cfg.data.batch_size
    for split in ("val", "test"):
        store = HO3DDataset(cached_cfg.data, split, device="cuda", by_sample=True)._cache()
        if not store.complete:
            fail(f"eval.py with cache_decoded built no {split} store at {store.dir}")
        cached = list(store.iter_samples())
        plain = list(HO3DDataset(cfg.data, split, device="cuda", by_sample=True))
        if [s["mv_sample_id"] for s in cached] != [s["mv_sample_id"] for s in plain]:
            fail(f"the {split} store's samples or their order differ from the reader's")
        for i in range(0, len(plain), bs):
            chunk = plain[i:i + bs]
            frames = decode_jpeg([p for s in chunk for p in s["full_jpeg"]], "cuda").cpu()
            want = frames.reshape(len(chunk), -1, *frames.shape[1:]).numpy()
            if not all(np.array_equal(c["full_rgb"], w) for c, w in zip(cached[i:i + bs], want)):
                fail(f"the {split} store's frames differ from nvJPEG's decode of its JPEGs")
        print(f"cache {split} store: {len(cached)} samples of {tuple(cached[0]['full_rgb'].shape)}"
              f", every frame bitwise nvJPEG's, in the reader's order", flush=True)


def cache_loader_rate(config: Path, phase9_sps: float, card_line: str) -> dict:
    """Phase 15 (b): samples/s of the train loader (augmented, as phase 9's)
    over one pass of the split from a store it builds (cold: the build
    included) and again from the built store (warm), and the store's bytes
    on disk."""
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.train import build_dataloaders

    cfg = Config.from_yaml(config)
    rates = {}
    for run in ("cold", "warm"):
        (loader,) = build_dataloaders(cfg, "cuda", ("train",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in loader:
            pass
        torch.cuda.synchronize()
        rates[run] = len(loader) * cfg.data.batch_size / (time.perf_counter() - t0)
    nbytes = sum(f.stat().st_size for f in Path(cfg.data.decoded_cache_dir).rglob("*")
                 if f.is_file())
    print(f"train loader from the decode cache, {len(loader)} batches of {cfg.data.batch_size} x "
          f"{EVAL_VIEWS} views (one pass): cold (the build included) {rates['cold']:.2f} "
          f"samples/s, warm {rates['warm']:.2f} samples/s (phase 9's without the cache "
          f"{phase9_sps:.2f}); the store {nbytes / 1e6:.1f} MB on disk; {card_line}", flush=True)
    return {**rates, "bytes": nbytes}


def cache_phase(attention_ops, stem_ops, train: dict, evals: dict, shards: dict,
                card_line: str, phase9: Path, tmp: Path) -> dict:
    """Phase 15 (see the module docstring) in the new directory ``tmp``, on
    phase 9's shards in ``phase9``. Returns the kernel rows' launches and
    the figures."""
    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.jpeg import decode_jpeg
    from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards

    (tmp / "data").mkdir(parents=True)
    for shard in sorted((phase9 / "data").glob("*.tar")):
        (tmp / "data" / shard.name).symlink_to(shard)
    write_synthetic_ho3d_shards(tmp / "data", num_shards=CACHE_TEST_SHARDS,
                                samples_per_shard=SHARD_TRAIN_SAMPLES, num_views=EVAL_VIEWS,
                                split="test", seed=15, consistent_geometry=True, device="cuda")
    n = 9 * SHARD_TRAIN_SAMPLES
    sizes = {"train+val": n, "val": 2 * SHARD_TRAIN_SAMPLES,
             "test": CACHE_TEST_SHARDS * SHARD_TRAIN_SAMPLES}
    base = write_eval_config(CONFIG, tmp, tmp / "data", phase9 / "MANO_RIGHT.npz", sizes)
    cfg = Config.from_yaml(base)
    ckpt = tmp / "reference.pth"
    shutil.copy(evals["ResNet"]["ckpt"], ckpt)
    launches = {"denom": [0, 0], "cache": {d: [0, 0] for d in DTYPES}}
    designs = {"denom": {}, "cache": {d: {} for d in DTYPES}}

    def count(key, got, k1_by_design, dtype_name="float32"):
        row = launches[key] if key == "denom" else launches[key][dtype_name]
        row[0] += got[0]
        row[1] += got[1]
        if key == "denom":
            designs["denom"] = add_designs(designs["denom"], k1_by_design)
        else:
            designs["cache"][dtype_name] = add_designs(designs["cache"][dtype_name], k1_by_design)

    # (a) the downscaled decode
    t0 = time.perf_counter()
    out = {"downscale": downscale_check(cfg, card_line)}
    denom2 = config_variant(base, "denom2", decode_scale_denom=2)
    got, _, by_design = eval_run(attention_ops, stem_ops, denom2, ckpt, "decode_scale_denom 2", 1)
    count("denom", got, by_design)
    run = shard_train_run(attention_ops, stem_ops, denom2, tmp / "denom2",
                          "training on shards float32, decode_scale_denom 2",
                          ["--epochs", "1", "--steps-per-epoch", "2"], stem_per_step=2)
    count("denom", run["launches"], run["k1_designs"])
    print(f"phase 15 (a) (the downscaled decode): {time.perf_counter() - t0:.1f} s", flush=True)

    # (b) the decode cache: eval.py without, with (cold: it builds), with (warm)
    t0 = time.perf_counter()
    evals_cached = config_variant(base, "eval_cached", cache_decoded=True,
                                  cache_dir=tmp / "eval_cache")
    with deterministic():
        plain = eval_run(attention_ops, stem_ops, base, ckpt, "without the cache", 1)
        decode_jpeg.calls = 0
        cold = eval_run(attention_ops, stem_ops, evals_cached, ckpt, "with the cache, cold", 1)
        cold_decodes = decode_jpeg.calls
        cache_frames_check(cfg, Config.from_yaml(evals_cached))
        decode_jpeg.calls = 0
        warm = eval_run(attention_ops, stem_ops, evals_cached, ckpt, "with the cache, warm", 1)
        warm_decodes = decode_jpeg.calls
    for result in (cold, warm):
        count("cache", result[0], result[2])
    builds = math.ceil(sizes["val"] / EVAL_BATCH) + math.ceil(sizes["test"] / EVAL_BATCH)
    print(f"eval.py with the cache against without: metrics bitwise equal cold "
          f"{cold[1] == plain[1]}, warm {warm[1] == plain[1]}; launches {plain[0]} / {cold[0]} / "
          f"{warm[0]}; nvJPEG calls cold {cold_decodes} (the build's {builds}), warm "
          f"{warm_decodes}", flush=True)
    if not (cold[1] == plain[1] == warm[1] and cold[0] == plain[0] == warm[0]
            and cold_decodes == builds and warm_decodes == 0):
        fail("eval.py with the decode cache differs from eval.py without it")

    # training cold (the first epoch builds) against warm (the same stores)
    train_cached = config_variant(base, "train_cached_plain", augment=False, cache_decoded=True,
                                  cache_dir=tmp / "train_cache")
    epochs = ["--epochs", str(SHARD_EPOCHS)]
    with deterministic():
        pair = [shard_train_run(attention_ops, stem_ops, train_cached, tmp / name,
                                f"training on shards float32 from the cache, {name}, no "
                                "augmentation, deterministic", epochs, stem_per_step=2)
                for name in ("cold", "warm")]
    for run in pair:
        count("cache", run["launches"], run["k1_designs"])
    cold_run, warm_run = pair
    builds = math.ceil(n / EVAL_BATCH) + math.ceil(sizes["val"] / EVAL_BATCH)
    same = cold_run["losses"] == warm_run["losses"] and cold_run["norms"] == warm_run["norms"]
    print(f"training cold against warm, {len(cold_run['norms'])} steps: loss terms and "
          f"gradient norms bitwise equal {same} (first step loss "
          f"{cold_run['losses'][0]['loss']!r} / {warm_run['losses'][0]['loss']!r}, norm "
          f"{cold_run['norms'][0]!r} / {warm_run['norms'][0]!r}); nvJPEG calls cold "
          f"{cold_run['decodes']} (the builds' {builds}), warm {warm_run['decodes']}", flush=True)
    if not same or cold_run["decodes"] != builds or warm_run["decodes"] != 0 \
            or len(cold_run["norms"]) != cold_run["steps"]:
        fail("training from the decode cache: the cold and the warm run differ, or a warm "
             "epoch decoded")

    # ms a step from cached frames, augmented, beside phase 9's and phase 6's; bf16,
    # host-bound and unsteady from run to run, in turns with uncached runs
    out["steps"] = {}
    for name, dtype in DTYPES.items():
        plain = write_eval_config(CONFIG, tmp, tmp / "data", phase9 / "MANO_RIGHT.npz", sizes, name)
        cached = config_variant(plain, f"train_cached_{name}", cache_decoded=True,
                                cache_dir=tmp / "train_cache")
        order = ("cached",) if name == "float32" else ("uncached", "cached", "cached", "uncached")
        ms = {"cached": [], "uncached": []}
        for i, kind in enumerate(order):
            run = shard_train_run(attention_ops, stem_ops, cached if kind == "cached" else plain,
                                  tmp / f"{kind}_{name}_{i}", f"training on shards {name}, {kind}",
                                  epochs, stem_per_step=2)
            ms[kind].append(run["ms"])
            if kind == "cached":
                count("cache", run["launches"], run["k1_designs"], name)
                if run["decodes"]:
                    fail(f"training {name} from a built store made {run['decodes']} nvJPEG calls")
        uncached = ms["uncached"] or [shards[name]["ms"]]
        cached_ms, uncached_ms = float(np.median(ms["cached"])), float(np.median(uncached))
        synth = train[dtype]["ms"]
        print(f"training {name} from the decode cache: {ms['cached']} ms a step (median "
              f"{cached_ms:.3f}, {TRAIN_BATCH / cached_ms * 1e3:.2f} samples/s); without it "
              f"{uncached} ms ({'in turns, ' if ms['uncached'] else ''}phase 9's "
              f"{shards[name]['ms']:.3f}); phase 6's synthetic step {synth:.3f} ms: ratios "
              f"{cached_ms / uncached_ms:.3f} and {cached_ms / synth:.3f}; {card_line}", flush=True)
        out["steps"][name] = {"ms": cached_ms, "uncached_ms": uncached_ms,
                              "runs_ms": ms["cached"], "uncached_runs_ms": uncached}
    out["loader"] = cache_loader_rate(
        config_variant(base, "loader_cached", cache_decoded=True, cache_dir=tmp / "loader_cache"),
        shards["loader"]["sps"], card_line)
    print(f"phase 15 (b) (the decode cache): {time.perf_counter() - t0:.1f} s", flush=True)
    out["launches"], out["k1_designs"] = launches, designs
    return out


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
            if ("Used" in line and "registers" in line) or "spill" in line:
                print(f"   {name}: {line.strip()}", flush=True)
    for name in _build.KERNELS:  # jpeg.cpp is host code over nvJPEG
        counts = tensor_core_counts(libs[name])
        for fn, c in counts.items():
            print(f"   {name}: {c['HMMA']} HMMA, {c['HGMMA']} HGMMA in {fn}", flush=True)
        for tag, op in MMA_KERNELS[name].items():
            kernels = [c for fn, c in counts.items() if tag in fn]
            if not kernels or not all(c[op] > 0 for c in kernels):
                fail(f"{name}: a {tag} kernel without {op} instructions ({counts})")

    # 3 + 4. each kernel against its plain version, and times
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    attn = {d: check_attention(attention_ops, d, gen) for d in DTYPES.values()}
    stem = {d: check_stem(stem_ops, d, gen) for d in DTYPES.values()}
    print(f"phases 3-4 (kernels): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 5. the main path, through the entry point a user calls
    t_phase = time.perf_counter()
    cfg = Config.from_yaml(CONFIG)
    launches, designs, joints_cam = {}, {}, {}
    for name, dtype in DTYPES.items():
        for with_vertices in (True, False):
            got, out, stats = serve(attention_ops, stem_ops, cfg, "main path", name,
                                    with_vertices, stem_per_forward=1)
            if with_vertices:
                launches[dtype], designs[dtype] = got, stats["k1_designs"]
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
    hr_stats = {dtype: serve(attention_ops, stem_ops, hr_cfg, "HR", name, True,
                             stem_per_forward=0, warmup=HR_WARMUP, iters=HR_ITERS)[2]
                for name, dtype in DTYPES.items()}
    serve_kernel_vs_plain(attention_ops, stem_ops, hr_cfg, "HR")
    hr_train = {DTYPES[name]: train_run(attention_ops, stem_ops, name, HR_CONFIG, stem_per_step=0)
                for name in DTYPES}
    train_kernel_vs_plain(attention_ops, stem_ops, HR_CONFIG)
    print(f"phase 7 (HRNet): {time.perf_counter() - t_phase:.1f} s", flush=True)

    import tempfile

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        # 8. the data path and eval.py on shards in the config's layout
        t_phase = time.perf_counter()
        evals = data_and_eval_phase(attention_ops, stem_ops, gen, card_line, tmp / "eval")
        print(f"phase 8 (data path and eval): {time.perf_counter() - t_phase:.1f} s", flush=True)

        # 9. training on shards: the train split's stream, augmentation, the preparer stage
        t_phase = time.perf_counter()
        (tmp / "train").mkdir()
        shards, shard_configs = shard_training_phase(attention_ops, stem_ops, train, evals,
                                                     card_line, tmp / "train")
        print(f"phase 9 (training on shards): {time.perf_counter() - t_phase:.1f} s", flush=True)

        # 10. data-parallel training: two ranks sharing the card, then train.py on NCCL
        t_phase = time.perf_counter()
        torch.cuda.empty_cache()
        dp = dp_shared_card(card_line)
        dp_nccl = dp_train_main(attention_ops, stem_ops, shard_configs["float32"],
                                tmp / "train" / "dp_nccl", shards["float32"], card_line)
        print(f"phase 10 (data-parallel training): {time.perf_counter() - t_phase:.1f} s",
              flush=True)

        # 11. the user-facing drivers: infer.py, the vis hook and tb/, eval.py on NCCL
        t_phase = time.perf_counter()
        drivers = drivers_phase(attention_ops, stem_ops, gen, evals, shard_configs["float32"],
                                card_line, tmp / "drivers")
        print(f"phase 11 (drivers): {time.perf_counter() - t_phase:.1f} s", flush=True)

        # 12. the serving structure: export bundles, view parallelism, infer --view-mesh
        t_phase = time.perf_counter()
        (tmp / "serving").mkdir()
        serving = export_phase(card_line, tmp / "serving")
        serving["dispatch"] = dispatch_cost(attention_ops, stem_ops, gen, card_line)
        serving.update(view_phase(attention_ops, stem_ops, card_line, tmp / "serving"))
        # K2 at a view rank's shape (4 of the 8 views), for the kernel line
        serving["stem"] = check_stem(stem_ops, torch.float32, gen, (8 // VIEW_RANKS, 256, 256))
        print(f"phase 12 (serving structure): {time.perf_counter() - t_phase:.1f} s", flush=True)

        # 13. the rest of the model family: the default ResNets, the learnable-query
        # fusion, the absolute-root branch, the hourglasses
        t_phase = time.perf_counter()
        family = family_phase(attention_ops, stem_ops, gen, card_line)
        print(f"phase 13 (model family): {time.perf_counter() - t_phase:.1f} s", flush=True)

        # 14. geometry and sanity, the int8 serving path, remat
        t_phase = time.perf_counter()
        tooling = tooling_phase(attention_ops, stem_ops, card_line)
        print(f"phase 14 (tooling, int8, remat): {time.perf_counter() - t_phase:.1f} s",
              flush=True)

        # 15. the downscaled decode and the decode cache, on phase 9's shards
        t_phase = time.perf_counter()
        torch.cuda.empty_cache()
        decode = cache_phase(attention_ops, stem_ops, train, evals, shards, card_line,
                             tmp / "train", tmp / "cache")
        print(f"phase 15 (the decode cache and the downscaled decode): "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # 16. the record
    def times(t: dict) -> dict:
        return {"ms": t["kernel"]["device"], "plain_ms": t["plain"]["device"],
                "library_ms": t["library"]["device"], "eager_ms": t["kernel"]["eager"],
                "plain_eager_ms": t["plain"]["eager"], "library_eager_ms": t["library"]["eager"]}

    def attention_record(dtype, rows, calls, launched, per, **extra) -> list:
        # one entry per K1 design that the rows' calls take, with the sums of its
        # calls' times and work, and its launches as the run counted them by design
        # (``launched``); a design the run launched must have an entry
        by_design: dict = {}
        for s, n in calls.items():
            by_design.setdefault(rows[s]["design"], {})[s] = n
        if any(n and d not in by_design for d, n in launched.items()):
            fail(f"kernels line{per[0]}: K1 launches by design {launched}, timed rows only for "
                 f"{sorted(by_design)}")
        entries = []
        for design, dcalls in by_design.items():
            per_call = {s: times(rows[s]["t"]) for s in dcalls}
            summed = {key: sum(n * per_call[s][key] for s, n in dcalls.items())
                      for key in per_call[next(iter(dcalls))]}
            work = {key: sum(n * rows[s][key] for s, n in dcalls.items())
                    for key in ("flops", "bytes")}
            bound, by = bound_ms(work["flops"], work["bytes"], dtype)
            both = {d: sum(n * rows[s]["design_ms"][d] for s, n in dcalls.items())
                    for d in attention_ops.DESIGNS
                    if all(d in rows[s]["design_ms"] for s in dcalls)}
            shapes = " + ".join(f"({s[0]},{s[1]}) x{n}" for s, n in dcalls.items())
            entries.append({
                "name": f"fused_attention[{str(dtype).removeprefix('torch.')}]{per[0]} {design}",
                "route": "cuda", "source": K1_SOURCES[design],
                "replaces": "handmvnet_tpu/ops/pallas/attention.py:69",
                "launches": launched.get(design, 0),
                "max_abs_err": max(rows[s]["err"] for s in dcalls),
                **summed, "bound_ms": bound, "bound_by": by, "per": per[1],
                "design": design, "design_calls": shapes, "design_ms": both, **extra})
        return entries

    def stem_record(dtype, r, n_launches, per, **extra) -> dict:
        return {"name": f"stem_conv[{str(dtype).removeprefix('torch.')}]{per[0]}",
                "route": "cuda", "source": "handmvnet_tpu_torch/csrc/stem.cu",
                "replaces": "handmvnet_tpu/ops/pallas/stem.py:120",
                "launches": n_launches, "max_abs_err": r["err"], **times(r["t"]),
                "bound_ms": r["bound"], "bound_by": r["bound_by"], "per": per[1],
                "design": STEM_DESIGN, "copies": r["routes"], **extra}

    kernels = []
    for dtype in DTYPES.values():
        kernels.extend(attention_record(
            dtype, attn[dtype], ATTN_CALLS, designs[dtype],
            ("", "forward: (168,168) x2 + (21,147) + (21,21) x2")))
    for dtype in DTYPES.values():
        kernels.append(stem_record(dtype, stem[dtype], launches[dtype][1],
                                   ("", "forward: x [8, 3, 256, 256]")))
    for dtype in DTYPES.values():
        kernels.extend(attention_record(
            dtype, train_attn[dtype], TRAIN_ATTN_CALLS, train[dtype]["k1_designs"],
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
        kernels.extend(attention_record(
            dtype, attn[dtype], ATTN_CALLS, hr_stats[dtype]["k1_designs"],
            ("/hr", "HRNet forward: (168,168) x2 + (21,147) + (21,21) x2")))
    for dtype in DTYPES.values():
        kernels.extend(attention_record(
            dtype, train_attn[dtype], TRAIN_ATTN_CALLS, hr_train[dtype]["k1_designs"],
            ("/hr_train", "HRNet microbatch forward at batch 8: (105,105) x2 + (21,84) + "
             "(21,21) x2"),
            backward="PyTorch ops (ops/attention.py::attention_backward)",
            backward_ms=attn_bwd[dtype]["ms"], backward_max_abs_err=attn_bwd[dtype]["err"]))
    # eval runs fp32: its rows carry the fp32 launches of phase 8's eval runs
    fp32 = torch.float32
    eval_calls = TRAIN_ATTN_CALLS  # the training microbatch's shapes, at batch 16
    kernels.extend(attention_record(
        fp32, evals["attn"][fp32], eval_calls, evals["ResNet"]["k1_designs"],
        ("/eval", "eval forward at batch 16 x 5 views: (105,105) x2 + (21,84) + (21,21) x2")))
    kernels.append(stem_record(fp32, evals["stem"][fp32], evals["ResNet"]["launches"][1],
                               ("/eval", "eval forward: x [80, 3, 256, 256]")))
    kernels.extend(attention_record(
        fp32, evals["attn"][fp32], eval_calls, evals["HR"]["k1_designs"],
        ("/eval_hr", "HRNet eval forward at batch 16 x 5 views: (105,105) x2 + (21,84) + "
         "(21,21) x2")))
    # phase 9's train.main runs (steps and validation forwards) at the training
    # microbatch's shapes: their times are the /train rows'
    for dtype in DTYPES.values():
        name = str(dtype).removeprefix("torch.")
        kernels.extend(attention_record(
            dtype, train_attn[dtype], TRAIN_ATTN_CALLS, shards[name]["k1_designs"],
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
    kernels.extend(attention_record(
        fp32, train_attn[fp32], TRAIN_ATTN_CALLS, shards["hr"]["k1_designs"],
        ("/hr_train_shards", "HR train.py on shards: microbatch forward at batch 8 "
         "(validation at batch 16)"),
        backward="PyTorch ops (ops/attention.py::attention_backward)",
        backward_ms=attn_bwd[fp32]["ms"], backward_max_abs_err=attn_bwd[fp32]["err"]))
    # phase 10's runs, at the training microbatch's shapes: their times are the /train rows'
    dp_runs = {
        "/train_dp": (tuple(map(sum, zip(*dp["launches"][0]))), dp["k1_designs"][0],
                      "rank 0 of 2 sharing the card over gloo, 4 steps (rank 1 as many)"),
        "/train_dp_nccl": (dp_nccl["launches"], dp_nccl["k1_designs"], "train.py at world size "
                           "1 on NCCL, 1 epoch (validation at batch 16)")}
    for label, ((_, k2), by_design, what) in dp_runs.items():
        kernels.extend(attention_record(
            fp32, train_attn[fp32], TRAIN_ATTN_CALLS, by_design,
            (label, f"{what}: microbatch forward at batch 8: (105,105) x2 + (21,84) + (21,21) "
             "x2"),
            backward="PyTorch ops (ops/attention.py::attention_backward)",
            backward_ms=attn_bwd[fp32]["ms"], backward_max_abs_err=attn_bwd[fp32]["err"]))
        kernels.append(stem_record(
            fp32, train_stem[fp32], k2, (label, f"{what}: microbatch forward x [40, 3, 256, 256]"),
            backward="torch.nn.grad.conv2d_weight", backward_ms=stem_bwd[fp32]["ms"],
            backward_max_abs_err=stem_bwd[fp32]["err"]))
    # phase 11's: infer at batch 1 x 5 views (its own rows' times), the vis hook and
    # eval.py on NCCL at the /eval shapes (batch 16 x 5 views: the /eval rows' times)
    infer_calls = TRAIN_ATTN_CALLS  # the training microbatch's shapes, at batch 1
    for label, key, what in (("/infer", "infer", "ResNet"), ("/infer_hr", "infer HR", "HRNet")):
        kernels.extend(attention_record(
            fp32, drivers["attn"], infer_calls, drivers[key]["k1_designs"],
            (label, f"infer.py {what} step at batch 1 x 5 views: (105,105) x2 + (21,84) + "
             "(21,21) x2"), step_device_ms=drivers[key]["device_ms"],
            step_wall_ms=drivers[key]["wall_ms"]))
    kernels.append(stem_record(fp32, drivers["stem"], drivers["infer"]["launches"][1],
                               ("/infer", "infer.py ResNet step: x [5, 3, 256, 256]"),
                               step_device_ms=drivers["infer"]["device_ms"],
                               step_wall_ms=drivers["infer"]["wall_ms"],
                               bf16_ms=drivers["stem_bf16"]["t"]["kernel"]["device"],
                               bf16_bound_ms=drivers["stem_bf16"]["bound"],
                               bf16_library_ms=drivers["stem_bf16"]["t"]["library"]["device"],
                               bf16_max_abs_err=drivers["stem_bf16"]["err"]))
    dp_evals = {"/eval_dp": (drivers["eval_dp"]["launches"], drivers["eval_dp"]["k1_designs"],
                             "eval.py at world size 1 on NCCL")}
    if drivers["vis"]:
        dp_evals["/vis"] = (drivers["vis"]["hook_launches"], drivers["vis"]["hook_k1_designs"],
                            "train.py's vis hook, a train and a val batch")
    for label, ((_, k2), by_design, what) in dp_evals.items():
        kernels.extend(attention_record(
            fp32, evals["attn"][fp32], eval_calls, by_design,
            (label, f"{what}: forward at batch 16 x 5 views: (105,105) x2 + (21,84) + "
             "(21,21) x2")))
        kernels.append(stem_record(fp32, evals["stem"][fp32], k2,
                                   (label, f"{what}: forward x [80, 3, 256, 256]")))
    # phase 12's: the replays and the fuse stage of every view rank call K1 at the main
    # path's shapes (its rows' times); K2 at the main path's x and at a view rank's
    for label, key, what in (
            ("/export", "export", "bundle exported on the card, replayed in a fresh process"),
            ("/export_cpu", "export_cpu", "bundle exported on the CPU, replayed on the card"),
            ("/export_hr", "export_hr", "HR bundle exported on the card, replayed")):
        row = serving[key]
        extra = {"step_p50_ms": row["p50_ms"], "eager_step_p50_ms": row["eager_p50_ms"],
                 "op_dispatch_ms_per_forward": serving["dispatch"]["per_forward_ms"]}
        replays = row["replays"]
        if key == "export_hr":  # the HO3D HR config's 5 views: the /infer_hr rows' shapes
            kernels.extend(attention_record(
                fp32, drivers["attn"], infer_calls, row["k1_designs"],
                (label, f"{what}, {replays} replays: (105,105) x2 + (21,84) + (21,21) x2"),
                **extra))
            continue
        kernels.extend(attention_record(
            fp32, attn[fp32], ATTN_CALLS, row["k1_designs"],
            (label, f"{what}, {replays} replays: (168,168) x2 + (21,147) + (21,21) x2"),
            **extra))
        kernels.append(stem_record(fp32, stem[fp32], row["launches"][1],
                                   (label, f"{what}, {replays} replays: x [8, 3, 256, 256]"),
                                   **extra))
    for label, key, what in (("/view", "view", f"rank 0 of a 1x{VIEW_RANKS} grid sharing the "
                              "card over gloo, one forward"),
                             ("/view_nccl", "view_nccl", "a 1x1 grid on NCCL, one forward"),
                             ("/infer_view", "infer_view", "infer.py --view-mesh 1x1 (HO3D, 5 "
                              "views), one step")):
        row = serving[key]
        extra = {"step_p50_ms": row["step_ms"], "all_gather_ms": row["gather_ms"]} \
            if key == "view" else {}
        calls = infer_calls if key == "infer_view" else ATTN_CALLS
        rows_k1 = drivers["attn"] if key == "infer_view" else attn[fp32]
        kernels.extend(attention_record(fp32, rows_k1, calls, row["k1_designs"],
                                        (label, f"{what}: the fuse stage over every view"),
                                        **extra))
        stem_rows = {"view": (serving["stem"], "x [4, 3, 256, 256]"),
                     "view_nccl": (stem[fp32], "x [8, 3, 256, 256]"),
                     "infer_view": (drivers["stem"], "x [5, 3, 256, 256]")}[key]
        kernels.append(stem_record(fp32, stem_rows[0], row["launches"][1],
                                   (label, f"{what}: {stem_rows[1]}"), **extra))
    # phase 13's: the family's forwards call K1 and K2 at the main path's shapes (its
    # rows' times); the root branch adds its three calls at serving and in training
    fam = family["serving"]
    fam_k2 = sum(r["launches"][1] for r in fam.values())
    by_type = {name: {"launches": r["launches"], "forwards": r["forwards"],
                      "p50_ms": r["p50_ms"], "forward_gflops": r["gflops"],
                      "forward_device_ms": r["forward_device_ms"]}
               for name, r in fam.items()}
    kernels.extend(attention_record(
        fp32, attn[fp32], ATTN_CALLS, add_designs(*(r["k1_designs"] for r in fam.values())),
        ("/family", "ResNet 18/34/50/101/152 at early_return 3 on the DexYCB model: "
         "(168,168) x2 + (21,147) + (21,21) x2 a forward (none on the learnable-query "
         "fusion)"), by_model=by_type))
    kernels.append(stem_record(fp32, stem[fp32], fam_k2,
                               ("/family", "every family model: x [8, 3, 256, 256]"),
                               by_model=by_type))
    root_calls = {**ATTN_CALLS, **{s: 1 for s in ROOT_ATTN_SHAPES}}
    root_rows = {**attn[fp32], **family["root_attn"][fp32]}
    rs = family["root_serving"]
    kernels.extend(attention_record(
        fp32, root_rows, root_calls, rs["k1_designs"],
        ("/root", "absolute-root DexYCB model b1 x 8: the main path's 5 calls + (8,8) + (1,7) "
         "+ (1,1)"), step_p50_ms=rs["p50_ms"],
        bf16_max_abs_err=max(r["err"] for r in family["root_attn"][torch.bfloat16].values())))
    kernels.append(stem_record(fp32, stem[fp32], rs["launches"][1],
                               ("/root", "absolute-root DexYCB model: x [8, 3, 256, 256]"),
                               step_p50_ms=rs["p50_ms"]))
    root_train_calls = {**TRAIN_ATTN_CALLS, **{s: 1 for s in ROOT_TRAIN_ATTN_SHAPES}}
    root_train_rows = {**train_attn[fp32], **family["root_train_attn"][fp32]}
    rt = family["root_train"]
    kernels.extend(attention_record(
        fp32, root_train_rows, root_train_calls, rt["k1_designs"],
        ("/root_train", f"root_relative off, HO3D release recipe, {rt['steps']} steps: "
         "microbatch forward at batch 8: (105,105) x2 + (21,84) + (21,21) x2 + (5,5) + (1,4) "
         "+ (1,1)"),
        backward="PyTorch ops (ops/attention.py::attention_backward)",
        backward_ms=attn_bwd[fp32]["ms"] + family["root_attn_bwd"][fp32]["ms"],
        backward_max_abs_err=max(attn_bwd[fp32]["err"], family["root_attn_bwd"][fp32]["err"]),
        bf16_max_abs_err=max(r["err"] for r in
                             family["root_train_attn"][torch.bfloat16].values())))
    kernels.append(stem_record(
        fp32, train_stem[fp32], rt["launches"][1],
        ("/root_train", f"root_relative off, {rt['steps']} steps: microbatch forward "
         "x [40, 3, 256, 256]"),
        backward="torch.nn.grad.conv2d_weight", backward_ms=stem_bwd[fp32]["ms"],
        backward_max_abs_err=stem_bwd[fp32]["err"]))
    # phase 14's: the int8 main path calls K1 and K2 at the main path's shapes (its rows'
    # times, the kernels are unchanged); remat training at the training microbatch's
    int8 = tooling["int8"]
    for dtype in DTYPES.values():
        name = str(dtype).removeprefix("torch.")
        extra = {"step_p50_ms": int8["p50"][("int8", name)],
                 "int8_off_step_p50_ms": int8["p50"][("int8 off", name)],
                 "forward_device_ms": int8[f"device_ms_{name}"]}
        kernels.extend(attention_record(
            dtype, attn[dtype], ATTN_CALLS, int8["k1_designs"][dtype],
            ("/int8", "model.backbone_int8 main path b1 x 8 (the eval_fps protocol, "
             f"{HR_WARMUP} + 2 x {HR_ITERS}): (168,168) x2 + (21,147) + (21,21) x2"), **extra))
        kernels.append(stem_record(
            dtype, stem[dtype], int8["launches"][dtype][1],
            ("/int8", "model.backbone_int8 main path: x [8, 3, 256, 256] (the stem stays K2)"),
            **extra))
    remat = tooling["remat"]
    by_model = {name: {"launches": r["launches"], "steps": r["steps"], "ms_per_step": r["ms"],
                       "peak_memory_gb": r["peak_gb"], "held_before_gb": r["held_before_gb"],
                       "bitwise_equal_to_off": r["bitwise"]}
                for name, r in remat.items()}
    kernels.extend(attention_record(
        fp32, train_attn[fp32], TRAIN_ATTN_CALLS,
        add_designs(*(r["k1_designs"] for r in remat.values())),
        ("/remat", f"train.remat on, HO3D ResNet and HR release recipes, {REMAT_STEPS} steps "
         "each: microbatch forward at batch 8: (105,105) x2 + (21,84) + (21,21) x2"),
        backward="PyTorch ops (ops/attention.py::attention_backward)",
        backward_ms=attn_bwd[fp32]["ms"], backward_max_abs_err=attn_bwd[fp32]["err"],
        by_model=by_model))
    kernels.append(stem_record(
        fp32, train_stem[fp32], remat["resnet"]["launches"][1],
        ("/remat", f"train.remat on, ResNet release recipe, {REMAT_STEPS} steps: microbatch "
         "forward x [40, 3, 256, 256] (outside the checkpointed blocks)"),
        backward="torch.nn.grad.conv2d_weight", backward_ms=stem_bwd[fp32]["ms"],
        backward_max_abs_err=stem_bwd[fp32]["err"], by_model=by_model))
    # phase 15's: train.py and eval.py on downscaled and on cached frames, at the
    # training microbatch's shapes (validation and eval at batch 16: the /eval shapes)
    steps = decode["steps"]
    denom_extra = {"downscale_device_ms": {d: r["ms"] for d, r in decode["downscale"].items()},
                   "downscale_frames": EVAL_BATCH * EVAL_VIEWS}
    k2 = decode["launches"]["denom"][1]
    kernels.extend(attention_record(
        fp32, train_attn[fp32], TRAIN_ATTN_CALLS, decode["k1_designs"]["denom"],
        ("/denom", "decode_scale_denom 2 (240 x 320 frames): eval.py and 2 training steps: "
         "microbatch forward at batch 8 (eval and validation at batch 16): (105,105) x2 + "
         "(21,84) + (21,21) x2"),
        backward="PyTorch ops (ops/attention.py::attention_backward)",
        backward_ms=attn_bwd[fp32]["ms"], backward_max_abs_err=attn_bwd[fp32]["err"],
        **denom_extra))
    kernels.append(stem_record(
        fp32, train_stem[fp32], k2,
        ("/denom", "decode_scale_denom 2: microbatch forward x [40, 3, 256, 256] (eval "
         "[80, 3, 256, 256])"),
        backward="torch.nn.grad.conv2d_weight", backward_ms=stem_bwd[fp32]["ms"],
        backward_max_abs_err=stem_bwd[fp32]["err"], **denom_extra))
    cache_extra = {"loader_samples_per_s": {k: decode["loader"][k] for k in ("cold", "warm")},
                   "store_bytes": decode["loader"]["bytes"]}
    for dtype in DTYPES.values():
        name = str(dtype).removeprefix("torch.")
        k2 = decode["launches"]["cache"][name][1]
        what = ("eval.py cold and warm, train.py cold and warm (no augmentation) and one "
                "augmented run" if name == "float32" else "two augmented train.py runs")
        extra = {**cache_extra, "ms_per_step": steps[name]["runs_ms"],
                 "uncached_ms_per_step": steps[name]["uncached_runs_ms"]}
        kernels.extend(attention_record(
            dtype, train_attn[dtype], TRAIN_ATTN_CALLS, decode["k1_designs"]["cache"][name],
            ("/cache", f"cache_decoded, {what}: microbatch forward at batch 8 (eval and "
             "validation at batch 16): (105,105) x2 + (21,84) + (21,21) x2"),
            backward="PyTorch ops (ops/attention.py::attention_backward)",
            backward_ms=attn_bwd[dtype]["ms"], backward_max_abs_err=attn_bwd[dtype]["err"],
            **extra))
        kernels.append(stem_record(
            dtype, train_stem[dtype], k2,
            ("/cache", f"cache_decoded, {what}: microbatch forward x [40, 3, 256, 256] (eval "
             "[80, 3, 256, 256])"),
            backward="torch.nn.grad.conv2d_weight", backward_ms=stem_bwd[dtype]["ms"],
            backward_max_abs_err=stem_bwd[dtype]["err"], **extra))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check", flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
