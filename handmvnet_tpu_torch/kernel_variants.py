"""Variants of the port's kernels (csrc/stem.cu, csrc/attention.cu,
csrc/attention_tiles.cu), built side by side and timed at the main-path shapes
on the card:
``python -m handmvnet_tpu_torch.kernel_variants {stem,attention,attention_tiles}
[--dtype float32|bfloat16] [--batch 1,8,16] [--against DIR]``

Each variant is the kernel's source with text substitutions: another output
tile or key slice, or one phase of the kernel taken out. Each is compiled by
nvcc with the port's flags into build/kernels/variants/, called through the
same C entry at the main path's shapes, and timed as a CUDA graph of 20
calls, inputs warm in L2, in turns with the others and with one library call
of the same function (``F.conv2d``, SDPA). The stem runs on x [b, 3, 256,
256] (``--batch``, a list of image counts, default 8: the serving forward's),
the model's NHWC image viewed as NCHW; its variants change the tile (rows,
warpgroups a block, patches in flight), the K order or the rounding of the
image's lo (fp32), or take out the gathers, the products or the store, and
each variant's RMS error against the conv in float64 is printed beside
F.conv2d's. Attention runs one forward's
five calls on [b, n, h, d] views: at batch 1 the serving forward's, (168, 168)
x2, (21, 147), (21, 21) x2, at a larger batch (``--batch``, a list) a
training or eval microbatch's, (105, 105) x2, (21, 84), (21, 21) x2.
``attention_tiles`` (K1's "query_tiles" design) is timed beside the
unchanged "key_split" kernel (attention.cu), at every batch of the list:
the sweep that fixes ``ops/attention.py::attention_design``'s rule. Its
fp32 variants change a block's query rows (32) or its warps (4, 16); the
bf16 kernel's block is wgmma's one warpgroup of 64 rows (the two-warpgroup
block it was timed against is in PERF.md).
Variants with a phase taken out compute wrong results by design: their times
say how much of the kernel's time that phase holds.

``--against DIR`` adds the same kernel built from another checkout's
sources (DIR/handmvnet_tpu_torch/csrc, e.g. the parent commit unpacked with
``git archive``) as the variant "against", so two versions of a kernel are
timed in turns in one process on one card.

Prints the card's name and power limit, one line per variant, then one JSON
line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from handmvnet_tpu_torch.ops import _build
from handmvnet_tpu_torch.ops.attention import attention_plain
from handmvnet_tpu_torch.ops.stem import stem_conv_plain
from handmvnet_tpu_torch.profile_forward import graph_ms

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the C entries' dtype argument
ATTN_CALLS = {(168, 168): 2, (21, 147): 1, (21, 21): 2}  # (Nq, Nk): launches per forward
BATCH_ATTN_CALLS = {(105, 105): 2, (21, 84): 1, (21, 21): 2}  # a batched microbatch's


def _subs(**consts: int) -> list:
    return [(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")
            for name, value in consts.items()]


def _drop(line: str, repl: str) -> list:
    return [(re.escape(line), repl)]


VARIANTS = {
    ("stem", "bfloat16"): {
        "source": [],
        # a warpgroup's tile (rows x 32 pixels: N of the tile 64 x rows / 2),
        # warpgroups a block (one block a SM), patches in flight (each variant
        # compiles the fp32 kernel too: kF32Groups=3 keeps its shared memory
        # within a block's)
        "rows_4_groups_2": _subs(kBf16Rows=4, kBf16Groups=2),
        "rows_4_groups_3": _subs(kBf16Rows=4, kBf16Groups=3),
        "stages_3": _subs(kStages=3, kF32Groups=3),
        "k192": _subs(kWin=8, kF32Groups=3),  # the TPU kernel's s2d K order, 8 x 8 x 3 = 192
        # phases taken out: the gathers (the fragments from the k table), the
        # products (the gathers feed the accumulators), the TMA store
        "no_gather": _drop("  v[0] = *reinterpret_cast<const uint32_t*>(q + e.x);\n"
                           "  v[1] = *reinterpret_cast<const uint32_t*>(q + 48 + e.x);\n"
                           "  v[2] = *reinterpret_cast<const uint32_t*>(q + e.z);\n"
                           "  v[3] = *reinterpret_cast<const uint32_t*>(q + 48 + e.z);",
                           "  v[0] = v[1] = v[2] = v[3] = e.x;"),
        "no_wgmma": _drop("for (int mt = 0; mt < kMT; ++mt) wgmma_bf16(acc[mt], f[mt], b, s > 0);",
                          "for (int mt = 0; mt < kMT; ++mt) acc[mt][s % 32] += "
                          "__uint_as_float(f[mt][0] ^ f[mt][1] ^ f[mt][2] ^ f[mt][3]);"),
        "no_store": _drop("tma_store_4d(ym, stage_s, at.ox0, 0, at.oy0, at.n);", ""),
    },
    ("stem", "float32"): {
        "source": [],
        "rows_4_groups_2": _subs(kF32Rows=4, kF32Groups=2),
        "groups_3": _subs(kF32Groups=3),
        "rows_8_groups_1": _subs(kF32Rows=8, kF32Groups=1),  # (shared memory: one group)
        # at 3 warpgroups (4 would overflow a block's shared memory): against groups_3
        "groups_3_stages_3": _subs(kStages=3, kF32Groups=3),
        "groups_3_k192": _subs(kWin=8, kF32Groups=3),
        # the image's lo rounded to TF32 too (as the weights'), not truncated
        "lo_rounded": _drop("  split_hi(__uint_as_float(v[0] & e.y), h[0], l[0]);\n"
                            "  split_hi(__uint_as_float(v[2] & e.y), h[1], l[1]);\n"
                            "  split_hi(__uint_as_float(v[1] & e.z), h[2], l[2]);\n"
                            "  split_hi(__uint_as_float(v[3] & e.z), h[3], l[3]);",
                            "  split_tf32(__uint_as_float(v[0] & e.y), h[0], l[0]);\n"
                            "  split_tf32(__uint_as_float(v[2] & e.y), h[1], l[1]);\n"
                            "  split_tf32(__uint_as_float(v[1] & e.z), h[2], l[2]);\n"
                            "  split_tf32(__uint_as_float(v[3] & e.z), h[3], l[3]);"),
        "no_gather": _drop("  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;",
                           "  v[0] = v[1] = v[2] = v[3] = e.x;"),
        "no_wgmma": _drop("for (int mt = 0; mt < kMT; ++mt) "
                          "wgmma_tf32x3(acc[mt], h[mt], l[mt], bh, bl, s > 0);",
                          "for (int mt = 0; mt < kMT; ++mt) acc[mt][s % 32] += "
                          "__uint_as_float(h[mt][0] ^ h[mt][1] ^ l[mt][2] ^ l[mt][3]);"),
        "no_store": _drop("tma_store_4d(ym, stage_s, at.ox0, 0, at.oy0, at.n);", ""),
    },
    ("attention", "float32"): {
        "source": [],
        # keys per warp and pass (the bf16 kernel, which shares the tiling, changes too)
        "slice_32": _subs(kKeyBlocks=2),
        "slice_16": _subs(kKeyBlocks=1),
        # the slice's three 16-key blocks unrolled: three copies of the loop body
        "kb_unrolled": _drop("#pragma unroll 1\n    for (int kb16 = 0; kb16 < blocks; ++kb16) {",
                             "#pragma unroll\n    for (int kb16 = 0; kb16 < kKeyBlocks; ++kb16) {"
                             "\n      if (kb16 >= blocks) break;"),
        "kk_unroll_4": _drop("#pragma unroll\n      for (int kk = 0;",
                             "#pragma unroll 4\n      for (int kk = 0;"),
        # the fragment loads and splits feed only the products, so they go too
        "no_mma": (_drop("mma_tf32x3(s[j], qh, ql, bh, bl);", "(void)qh, (void)ql;")
                   + _drop("mma_tf32x3(acc[dt], ph, pl, bh, bl);", "(void)ph, (void)pl;")),
        "no_kv_loads": (_drop("cp_async16(k_s + r * kKRow + c, kb + key * ksn + c, in);",
                              "(void)key;")
                        + _drop("cp_async16(v_s + r * kVRow + c, vb + key * vsn + c, in);", "")),
    },
    ("attention", "bfloat16"): {
        "source": [],
    },
    ("attention_tiles", "bfloat16"): {
        "source": [],
    },
    ("attention_tiles", "float32"): {
        "source": [],
        "rows_32": _subs(kF32Rows=32),
        "warps_4": _subs(kF32Warps=4),
        "warps_16": _subs(kF32Warps=16),
        # phases taken out: the products (their loads and splits go too), the merge
        "no_s_mma": _drop("      mma_tf32x3(s[j], ah, al, bh, bl);", "      (void)ah, (void)al;"),
        "no_pv_mma": _drop("      mma_tf32x3(acc[dt], ph, pl, bh, bl);",
                           "      (void)ph, (void)pl;"),
        "no_merge": _drop("      if (l_s[w][row] > 0.f) l += l_s[w][row] * exp2f(m_s[w][row] - m);",
                          "      l += 1.f;"),
    },
}


def _entry(lib: ctypes.CDLL, kernel: str):
    """The library's C entry point, its argument types declared."""
    if kernel == "stem":
        fn = lib.hmv_stem_conv
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    else:
        fn = lib.hmv_attention_tiles_fwd if kernel == "attention_tiles" else lib.hmv_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build(kernel: str, variants: dict, out_dir: Path, against: Path | None = None) -> dict:
    """Compile every variant, and the other checkout's source, in parallel;
    {name: ctypes entry}."""
    jobs = {}  # name: (directory holding the .cu and its headers, source text)
    for name, subs in variants.items():
        text = (_build._CSRC / f"{kernel}.cu").read_text()
        for pattern, repl in subs:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                raise RuntimeError(f"{name}: {pattern!r} matched {n} times in {kernel}.cu")
        jobs[name] = (out_dir, _build._CSRC, text)
    if against is not None:
        csrc = against / "handmvnet_tpu_torch" / "csrc"
        jobs["against"] = (out_dir / "against", csrc, (csrc / f"{kernel}.cu").read_text())
    procs = {}
    for name, (where, headers, text) in jobs.items():
        where.mkdir(parents=True, exist_ok=True)
        for header in headers.glob("*.cuh"):
            (where / header.name).write_text(header.read_text())
        (where / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(where / f"{name}.so"),
               str(where / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        entries[name] = _entry(ctypes.CDLL(str(jobs[name][0] / f"{name}.so")), kernel)
    return entries


def _check(code: int) -> None:
    if code != 0:
        raise RuntimeError(f"launch failed: CUDA error {code}")


def stem_cases(entries: dict, dtype, images: int = 8) -> tuple[dict, dict, float, dict]:
    """{name: call} for each variant and F.conv2d on x [images, 3, 256, 256],
    {name: max error against the plain version}, max|ref|, and {name: RMS
    error against the conv in float64 on the same inputs} (F.conv2d's too)."""
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(images, 256, 256, 3, generator=g, device="cuda").to(dtype).permute(0, 3, 1, 2)
    w = (torch.randn(64, 3, 7, 7, generator=g, device="cuda") * 0.05).to(dtype)
    ref = stem_conv_plain(x, w)
    ref64 = F.conv2d(x.double(), w.double(), stride=2, padding=3)

    def rms(y: torch.Tensor) -> float:
        return float((y.double() - ref64).pow(2).mean().sqrt())

    fns, errs, rms64 = {}, {}, {"library": rms(ref)}
    for name, fn in entries.items():
        y = torch.empty((images, 64, 128, 128), dtype=dtype, device="cuda")

        def call(fn=fn, y=y):
            _check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), DTYPE_CODES[dtype], images,
                      256, 256, *x.stride(), torch.cuda.current_stream().cuda_stream))

        call()
        torch.cuda.synchronize()
        errs[name] = float((y.float() - ref.float()).abs().max())
        rms64[name] = rms(y)
        fns[name] = call
    fns["library"] = lambda: F.conv2d(x, w, stride=2, padding=3)
    return fns, errs, float(ref.float().abs().max()), rms64


def attention_cases(entries: dict, dtype, batch: int = 1) -> tuple[dict, dict, float]:
    """{(name, shape): call} for each variant and SDPA at each (Nq, Nk) of
    ``batch``'s forward, {name: max error over the shapes}, max|ref|."""
    g = torch.Generator("cuda").manual_seed(0)
    scale = 128 ** -0.5
    fns, errs, ref_max = {}, {}, 0.0
    for nq, nk in (ATTN_CALLS if batch == 1 else BATCH_ATTN_CALLS):
        q, k, v = (torch.randn(batch, n, 8, 128, generator=g, device="cuda").to(dtype)
                   .transpose(1, 2) for n in (nq, nk, nk))
        ref = attention_plain(q, k, v, scale)
        ref_max = max(ref_max, float(ref.float().abs().max()))
        for name, fn in entries.items():
            o = torch.empty((batch, nq, 8, 128), dtype=dtype, device="cuda").transpose(1, 2)

            def call(fn=fn, q=q, k=k, v=v, o=o, nq=nq, nk=nk):
                _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                          DTYPE_CODES[dtype], batch, 8, nq, nk, 128, *q.stride()[:3],
                          *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], scale,
                          torch.cuda.current_stream().cuda_stream))

            try:
                call()
            except RuntimeError:  # a shape the kernel refuses (attention_tiles: nk too large)
                continue
            torch.cuda.synchronize()
            errs[name] = max(errs.get(name, 0.0), float((o.float() - ref.float()).abs().max()))
            fns[(name, (nq, nk))] = call
        fns[("library", (nq, nk))] = (
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v, scale=scale))
    return fns, errs, ref_max


def _time(fns: dict) -> dict:
    """us per call of each function, in turns a b .. b a a b, the least kept."""
    us = {key: float("inf") for key in fns}
    for key in list(fns) + list(reversed(fns)) + list(fns):
        us[key] = min(us[key], graph_ms(fns[key], calls=20, replays=20) * 1e3)
    return us


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("kernel", choices=("stem", "attention", "attention_tiles"))
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    parser.add_argument("--batch", default=None,
                        help="batches to time, comma-separated: attention's (default 1, the "
                        "serving shapes), the stem's images of 256^2 (default 8)")
    parser.add_argument("--against", type=Path, default=None,
                        help="another checkout whose kernel source is timed beside these")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    dtype = DTYPES[args.dtype]
    entries = build(args.kernel, VARIANTS[(args.kernel, args.dtype)],
                    _build.BUILD_DIR / "variants" / f"{args.kernel}-{args.dtype}", args.against)
    if args.kernel == "attention_tiles":  # the other design, as the port builds it
        entries["key_split"] = _entry(_build.load("attention"), "attention")
    runs = []
    batches = args.batch or ("8" if args.kernel == "stem" else "1")
    for batch in [int(b) for b in batches.split(",")]:
        rms64 = {}
        if args.kernel == "stem":
            fns, errs, ref_max, rms64 = stem_cases(entries, dtype, batch)
            us, per_call = _time(fns), {}
        else:
            fns, errs, ref_max = attention_cases(entries, dtype, batch)
            calls = ATTN_CALLS if batch == 1 else BATCH_ATTN_CALLS
            per_call = {}  # {name: {(Nq, Nk): us}}, and us per forward (its five calls)
            for (name, shape), t in _time(fns).items():
                per_call.setdefault(name, {})[shape] = t
            us = {name: sum(calls[s] * t for s, t in by_shape.items())
                  for name, by_shape in per_call.items() if len(by_shape) == len(calls)}
        for name in per_call or us:
            err = f" max_abs_err={errs[name]:.3e}" if name in errs else ""
            err += f" rms_err_f64={rms64[name]:.3e}" if name in rms64 else ""
            total = f"{us[name]:.2f} us" if name in us else "refused at some shape"
            shapes = "".join(f" ({s[0]},{s[1]}) {c:.2f}"
                             for s, c in per_call.get(name, {}).items())
            print(f"batch {batch} {name}: {total}{' per call' + shapes if shapes else ''}{err}",
                  flush=True)
        runs.append({"batch": batch, "us": us, "max_abs_err": errs, "max_abs_ref": ref_max,
                     "rms_err_f64": rms64,
                     "per_call_us": {name: {f"{s[0]},{s[1]}": c for s, c in by_shape.items()}
                                     for name, by_shape in per_call.items()}})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi.stdout.strip(),
                      "kernel": args.kernel, "dtype": args.dtype, "runs": runs}))


if __name__ == "__main__":
    main()
