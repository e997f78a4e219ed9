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
  6. a {"kernels": [...]} line, then the {"ok": true, ...} line last.

fp32 means fp32 here: TF32 is switched off for matmuls and cuDNN convs.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

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


def check_attention(attention_ops, dtype, gen) -> dict:
    """K1 at each main-path shape: error vs plain, times, bound."""
    scale = 128 ** -0.5
    rows = {}
    for nq, nk in ATTN_SHAPES:
        # the model's layout: [b, n, h, d] projections viewed as [b, h, n, d]
        q, k, v = (torch.randn(1, n, 8, 128, generator=gen, device="cuda").to(dtype).transpose(1, 2)
                   for n in (nq, nk, nk))
        out = attention_ops.fused_attention(q, k, v, scale)
        torch.cuda.synchronize()
        ref = attention_ops.attention_plain(q, k, v, scale)
        err = max_err(out, ref)
        tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * float(ref.float().abs().max())
        print(f"K1 fused_attention {dtype} (Nq, Nk)=({nq}, {nk}): max_abs_err={err:.3e} "
              f"tol={tol:.3e}", flush=True)
        if not err <= tol:
            fail(f"K1 disagrees with its plain version at ({nq}, {nk}) {dtype}: {err} > {tol}")
        t = time_ms({
            "kernel": lambda: attention_ops.fused_attention(q, k, v, scale),
            "plain": lambda: attention_ops.attention_plain(q, k, v, scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
        })
        elt = q.element_size()
        flops = 4.0 * 8 * nq * nk * 128  # q k^T and p v, 8 heads
        nbytes = 8 * 128 * (2 * nq + 2 * nk) * elt  # q, k, v read and o written once
        b, by = bound_ms(flops, nbytes, dtype)
        print(f"   device ms: kernel={t['kernel']['device']:.5f} plain={t['plain']['device']:.5f} "
              f"sdpa={t['library']['device']:.5f} bound={b:.5f} ({by}); eager ms: "
              f"kernel={t['kernel']['eager']:.5f} plain={t['plain']['eager']:.5f} "
              f"sdpa={t['library']['eager']:.5f}", flush=True)
        rows[(nq, nk)] = {"err": err, "t": t, "bound": b, "flops": flops, "bytes": nbytes}
    return rows


def check_stem(stem_ops, dtype, gen) -> dict:
    """K2 at the main-path shape: error vs plain, times, bound."""
    n, h, w = STEM_SHAPE
    # the model's layout: the NHWC images viewed as NCHW
    x = torch.randn(n, h, w, 3, generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    weight = (torch.randn(64, 3, 7, 7, generator=gen, device="cuda") * 0.05).to(dtype)
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

    # 6. the record
    def times(t: dict) -> dict:
        return {"ms": t["kernel"]["device"], "plain_ms": t["plain"]["device"],
                "library_ms": t["library"]["device"], "eager_ms": t["kernel"]["eager"],
                "plain_eager_ms": t["plain"]["eager"], "library_eager_ms": t["library"]["eager"]}

    kernels = []
    for dtype in DTYPES.values():
        rows = attn[dtype]
        # one forward's five calls: sums of the per-call times and of the work
        per_call = {s: times(rows[s]["t"]) for s in ATTN_SHAPES}
        per_fwd = {key: sum(ATTN_CALLS[s] * per_call[s][key] for s in ATTN_SHAPES)
                   for key in per_call[ATTN_SHAPES[0]]}
        work = {key: sum(ATTN_CALLS[s] * rows[s][key] for s in ATTN_SHAPES)
                for key in ("flops", "bytes")}
        bound, by = bound_ms(work["flops"], work["bytes"], dtype)
        kernels.append({
            "name": f"fused_attention[{str(dtype).removeprefix('torch.')}]",
            "route": "cuda", "source": "handmvnet_tpu_torch/csrc/attention.cu",
            "replaces": "handmvnet_tpu/ops/pallas/attention.py:69",
            "launches": launches[dtype][0],
            "max_abs_err": max(r["err"] for r in rows.values()),
            **per_fwd, "bound_ms": bound, "bound_by": by,
            "per": "forward: (168,168) x2 + (21,147) + (21,21) x2",
        })
    for dtype in DTYPES.values():
        r = stem[dtype]
        kernels.append({
            "name": f"stem_conv[{str(dtype).removeprefix('torch.')}]",
            "route": "cuda", "source": "handmvnet_tpu_torch/csrc/stem.cu",
            "replaces": "handmvnet_tpu/ops/pallas/stem.py:120",
            "launches": launches[dtype][1], "max_abs_err": r["err"],
            **times(r["t"]), "bound_ms": r["bound"], "bound_by": r["bound_by"],
            "per": "forward: x [8, 3, 256, 256]",
        })
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
