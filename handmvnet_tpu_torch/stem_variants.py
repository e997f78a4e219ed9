"""Variants of the bf16 stem kernel (csrc/stem.cu), built side by side and
timed at the main-path shape on the card:
``python -m handmvnet_tpu_torch.stem_variants``

Each variant is the source with text substitutions: another output tile, or
one phase of the kernel taken out. Each is compiled by nvcc with the port's
flags into build/kernels/variants/, called through the same C entry on
x [8, 3, 256, 256] (the model's NHWC image viewed as NCHW), and timed as a
CUDA graph of 20 calls, inputs warm in L2, in turns with the others and with
``F.conv2d``. Variants with a phase taken out compute wrong results by
design: their times say how much of the kernel's time that phase holds.
Prints one line per variant, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch
import torch.nn.functional as F

from handmvnet_tpu_torch.ops import _build
from handmvnet_tpu_torch.profile_forward import graph_ms


def _tile(th: int, tw: int):
    return [(r"constexpr int kGTH = \d+;", f"constexpr int kGTH = {th};"),
            (r"constexpr int kGTW = \d+;", f"constexpr int kGTW = {tw};")]


VARIANTS = {
    "source": [],
    "tile_4x64": _tile(4, 64),
    "tile_2x128": _tile(2, 128),
    # the gathers and ldmatrix feed only the products, so they go too
    "no_gather_mma": [(re.escape("mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);"), "(void)a;")],
    "no_global_loads": [(re.escape("rw[it] = e < kCout * kTaps ? w[e] : 0;"), "rw[it] = e & 7;"),
                        (re.escape("rp[it] = in ? xn[c * sc + ih * sh + iw * sw] : 0;"),
                         "rp[it] = in;")],
    "no_output_store": [(re.escape("*reinterpret_cast<uint4*>(dst) = "
                                   "*reinterpret_cast<const uint4*>(src);"),
                         "if (src[0] == 0x7fff) dst[0] = 1;")],
}


def build(out_dir) -> dict:
    """Compile every variant in parallel; {name: ctypes entry}."""
    source = (_build._CSRC / "stem.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build._CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for pattern, repl in subs:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                raise RuntimeError(f"{name}: {pattern!r} matched {n} times in stem.cu")
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
               str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).hmv_stem_conv
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stem_variants: needs a CUDA device")
    entries = build(_build.BUILD_DIR / "variants")
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(8, 256, 256, 3, generator=g, device="cuda").to(torch.bfloat16)
    x = x.permute(0, 3, 1, 2)
    w = (torch.randn(64, 3, 7, 7, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
    ref = F.conv2d(x, w, stride=2, padding=3)

    fns, errs = {}, {}
    for name, fn in entries.items():
        y = torch.empty((8, 64, 128, 128), dtype=torch.bfloat16, device="cuda")

        def call(fn=fn, y=y):
            code = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, 8, 256, 256, *x.stride(),
                      torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        call()
        torch.cuda.synchronize()
        errs[name] = float((y.float() - ref.float()).abs().max())
        fns[name] = call
    fns["conv2d"] = lambda: F.conv2d(x, w, stride=2, padding=3)

    us = {name: float("inf") for name in fns}
    for name in list(fns) + list(reversed(fns)) + list(fns):
        us[name] = min(us[name], graph_ms(fns[name], calls=20, replays=20) * 1e3)
    for name, t in us.items():
        err = f" max_abs_err={errs[name]:.3e}" if name in errs else ""
        print(f"{name}: {t:.2f} us{err}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "us": us,
                      "max_abs_err": errs, "max_abs_ref": float(ref.float().abs().max())}))


if __name__ == "__main__":
    main()
