"""JPEG decode and encode for the shards' frames: one codec per device.

* On the card: nvJPEG from the CUDA toolkit, bound through csrc/jpeg.cpp
  (built at first use by ops/_build.py). ``decode_jpeg`` turns a batch of
  JPEG byte strings into one CUDA uint8 tensor [N, H, W, 3] RGB with one
  batched decode, so that the frames cross PCIe as JPEG bytes, not pixels.
* On the CPU: cv2, imported when first used, as the JAX package's python
  reader decodes (handmvnet_tpu/data/webdataset.py:42-48): its pixels are
  the JAX reader's, bit for bit.

The device asked for picks the codec; nothing on the card gives way to the
CPU. nvJPEG's IDCT and chroma upsampling are not libjpeg's, so its pixels
differ from cv2's by a few levels (``NVJPEG_MAX_ABS_DIFF``).
"""

from __future__ import annotations

import ctypes
import lzma
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from handmvnet_tpu_torch.ops import _build

# cv2.imencode's default quality, which the JAX package's shards are written at
JPEG_QUALITY = 95
# nvjpegBackend_t NVJPEG_BACKEND_GPU_HYBRID: Huffman decoding on the card for
# large batches. The hardware backend (3) is refused on the H100 with
# NVJPEG_STATUS_ARCH_MISMATCH, and the default one decodes Huffman on the host.
# At a batch of ~80 frames and up the library takes another decode path, whose
# pixels differ from its small-batch ones by up to 2 levels; both stay within
# NVJPEG_MAX_ABS_DIFF of libjpeg (chip_smoke.py checks both sizes).
NVJPEG_BACKEND = 2
# Largest |nvJPEG - libjpeg| a pixel may show on a smooth frame (data/
# fixtures/jpeg_fixture.jpg), from the decoders' documented behaviour, not
# from a run: a compliant IDCT is within 1 level of the exact one (ITU-T
# T.81 Annex A, IEEE 1180) on each of Y, Cb and Cr, and RGB conversion
# weighs Cb by up to 1.772 (B = Y + 1.772 Cb), so 2.772; chroma upsampling
# is not standardised (libjpeg interpolates, a decoder may replicate), which
# on chroma changing <= 2 levels a pixel adds <= 1 level x 1.772 at the
# fixture's gradients; rounding of the two conversions adds 1. ceil: 6.
NVJPEG_MAX_ABS_DIFF = 6
# mean over the frame: the IDCT's mean error per pixel is bounded by 0.015
# (IEEE 1180), so disagreement is rounding flips of single levels
NVJPEG_MEAN_ABS_DIFF = 1.0

_lock = threading.Lock()
_decoders: dict[int, ctypes.c_void_p] = {}
_encoders: dict[int, ctypes.c_void_p] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("jpeg")
    if lib.hmv_jpeg_decode.argtypes is None:
        vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.hmv_jpeg_decoder_create.argtypes = [i, ctypes.POINTER(vp)]
        lib.hmv_jpeg_encoder_create.argtypes = [i, ctypes.POINTER(vp)]
        lib.hmv_jpeg_image_size.argtypes = [vp, ctypes.c_char_p, sz, ctypes.POINTER(i),
                                            ctypes.POINTER(i)]
        lib.hmv_jpeg_decode.argtypes = [vp, i, ctypes.POINTER(ctypes.c_char_p),
                                        ctypes.POINTER(sz), vp, i, i, vp]
        lib.hmv_jpeg_encode.argtypes = [vp, vp, i, i, ctypes.c_char_p, sz, ctypes.POINTER(sz),
                                        vp]
        for fn in ("hmv_jpeg_decoder_create", "hmv_jpeg_encoder_create", "hmv_jpeg_image_size",
                   "hmv_jpeg_decode", "hmv_jpeg_encode"):
            getattr(lib, fn).restype = i
    return lib


def _codec(cache: dict, create: str, arg: int, device: torch.device) -> ctypes.c_void_p:
    """The process's decoder or encoder for a card, made on first use."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    handle = cache.get(index)
    if handle is None:
        lib = _lib()
        handle = ctypes.c_void_p()
        with torch.cuda.device(index):
            _build.check(lib, getattr(lib, create)(arg, ctypes.byref(handle)), create)
        cache[index] = handle
    return handle


def _check_device(device: torch.device) -> None:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no JPEG codec for device {device}")


def decode_jpeg(payloads: Sequence[bytes], device: str | torch.device) -> torch.Tensor:
    """JPEG byte strings, all of one size, -> uint8 [N, H, W, 3] RGB on
    ``device``: nvJPEG's batched decode on a card, cv2 on the CPU. On a card
    the decode runs on the current stream, which it drains before and after
    (csrc/jpeg.cpp): on the training step's stream it waits for the queued
    step, so the loader's preparer stage decodes on a stream of its own."""
    device = torch.device(device)
    _check_device(device)
    if not payloads:
        raise ValueError("decode_jpeg: no images")
    if device.type == "cpu":
        frames = [_decode_cv2(p) for p in payloads]
        if any(f.shape != frames[0].shape for f in frames):
            raise ValueError("decode_jpeg: the images of a batch differ in size")
        return torch.from_numpy(np.stack(frames))
    lib = _lib()
    with _lock:
        dec = _codec(_decoders, "hmv_jpeg_decoder_create", NVJPEG_BACKEND, device)
        h, w = ctypes.c_int(), ctypes.c_int()
        _build.check(lib, lib.hmv_jpeg_image_size(dec, payloads[0], len(payloads[0]),
                                                  ctypes.byref(h), ctypes.byref(w)),
                     "hmv_jpeg_image_size")
        n = len(payloads)
        out = torch.empty((n, h.value, w.value, 3), dtype=torch.uint8, device=device)
        data = (ctypes.c_char_p * n)(*payloads)
        lengths = (ctypes.c_size_t * n)(*map(len, payloads))
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(lib, lib.hmv_jpeg_decode(dec, n, data, lengths, out.data_ptr(), h.value,
                                              w.value, stream), "hmv_jpeg_decode")
    return out


def encode_jpeg(images: torch.Tensor) -> list[bytes]:
    """uint8 [N, H, W, 3] RGB -> N JPEG byte strings at ``JPEG_QUALITY``,
    4:2:0: nvJPEG for a tensor on a card, cv2 for one on the CPU."""
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"encode_jpeg takes uint8 [N, H, W, 3], not {images.dtype} "
                         f"{tuple(images.shape)}")
    _check_device(images.device)
    if images.device.type == "cpu":
        import cv2

        out = []
        for img in images.numpy():
            ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[:, :, ::-1]))
            if not ok:
                raise RuntimeError("cv2.imencode failed")
            out.append(buf.tobytes())
        return out
    lib = _lib()
    n, h, w, _ = images.shape
    images = images.contiguous()
    capacity = 2 * h * w * 3 + (1 << 16)  # JPEG of 8-bit RGB stays well under this
    buf = ctypes.create_string_buffer(capacity)
    out = []
    with _lock:
        enc = _codec(_encoders, "hmv_jpeg_encoder_create", JPEG_QUALITY, images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        for i in range(n):
            length = ctypes.c_size_t()
            _build.check(lib, lib.hmv_jpeg_encode(enc, images[i].data_ptr(), h, w, buf,
                                                  capacity, ctypes.byref(length), stream),
                         "hmv_jpeg_encode")
            out.append(ctypes.string_at(buf, length.value))
    return out


def _decode_cv2(payload: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(payload, dtype=np.uint8), cv2.IMREAD_COLOR)  # BGR
    if img is None:
        raise ValueError("cv2 could not decode a JPEG")
    return np.ascontiguousarray(img[:, :, ::-1])


FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures"
FIXTURE_HW = (480, 640)


def jpeg_fixture() -> tuple[bytes, np.ndarray]:
    """(JPEG bytes, the pixels cv2 decodes them to: uint8 [480, 640, 3] RGB)
    of a smooth synthetic frame, for holding a decoder against libjpeg
    without cv2. The pixels are stored as lzma-compressed differences along
    each row, modulo 256 (tests/test_torch_data.py writes and checks both
    files)."""
    payload = (FIXTURE_DIR / "jpeg_fixture.jpg").read_bytes()
    diff = np.frombuffer(lzma.decompress((FIXTURE_DIR / "jpeg_fixture_rgb.xz").read_bytes()),
                         dtype=np.uint8).reshape(*FIXTURE_HW, 3)
    return payload, np.cumsum(diff, axis=1, dtype=np.uint8)
