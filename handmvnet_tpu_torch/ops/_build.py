"""Build and load the port's native sources (csrc/) at first use: the CUDA
kernels (attention.cu, stem.cu) and the nvJPEG binding (jpeg.cpp, host code
linked with the toolkit's libnvjpeg).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, in ``build/kernels/`` at the repository root
(git-ignored), and loaded with ``ctypes``. A library's file name carries a
hash of its source, the shared headers (csrc/*.cuh) and the flags, so an
edited source or header is rebuilt and a stale one
never loaded. All sources build in parallel, one ``nvcc`` process each, the
first time any of them is needed; nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# name: (source file, flags after the source); the kernels are the .cu sources
SOURCES = {
    "attention": ("attention.cu", ()),
    "stem": ("stem.cu", ()),
    "jpeg": ("jpeg.cpp", ("-lnvjpeg",)),
}
KERNELS = ("attention", "stem")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # ptxas report of each library built by this process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built at first use and "
        "need the CUDA toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc)"
    )


def _lib_path(name: str) -> Path:
    source, libs = SOURCES[name]
    digest = hashlib.sha256()
    for src in (_CSRC / source, *sorted(_CSRC.glob("*.cuh"))):  # a header edit rebuilds too
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + libs).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; return
    {name: library path}. Raises with nvcc's output if any build fails."""
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        source, libs = SOURCES[name]
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / source), *libs]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode == 0:
            tmp.replace(paths[name])  # atomic: readers never see half a file
        else:
            failed.append(f"--- {SOURCES[name][0]} (nvcc exit {proc.returncode}) ---\n{out}")
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of the source ``name`` (a key of SOURCES), building
    the sources first if needed. Declares ``hmv_error_string``; callers
    declare their entries."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            lib.hmv_error_string.argtypes = [ctypes.c_int]
            lib.hmv_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.hmv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
