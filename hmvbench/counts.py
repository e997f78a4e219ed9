"""The work the benchmark counts itself, from shapes and from its frozen
reference, never from the program's modules: the operations and bytes of
the program's two hand-written kernels (K1, the fusion's attention core; K2,
the ResNet stem conv), the floating-point operations of a forward and of a
training step, and the chip's peaks (``peaks.json``).

A kernel's bound is the larger of its operations over the peak of the
work's precision and its bytes over the memory bandwidth, each input read
and each output written once. The peaks are tied to the precision of the
work, not to how a kernel computes it: fp32 work is held against the TF32
tensor-core peak, since no fp32-accurate scheme on the tensor cores goes
faster.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import torch

from hmvbench.reference.constants import NUM_JOINTS

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}
HEADS, HEAD_DIM = 8, 128  # every fusion block's attention


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take for this work, in seconds."""
    return max(flops / PEAKS["flops_per_s"][precision], nbytes / PEAKS["hbm_bytes_per_s"])


def k1_calls(model: dict, batch: int, views: int) -> list[tuple[int, int, int, int]]:
    """K1's calls in one forward, as (batch, heads, queries, keys): the
    fusion's self blocks over all 21 V tokens, the cross block (view 0's 21
    over the other 21 (V - 1)), the self blocks over the 21 fused tokens."""
    n, half = NUM_JOINTS * views, (model["fusion_layers"] - 1) // 2
    return ([(batch, HEADS, n, n)] * half + [(batch, HEADS, NUM_JOINTS, n - NUM_JOINTS)]
            + [(batch, HEADS, NUM_JOINTS, NUM_JOINTS)] * half)


def k1_work(calls, precision: str) -> tuple[float, float]:
    """(operations, bytes) of K1's forward calls: q k^T and p v; q, k, v read
    and the output written once."""
    elt = ELEMENT_BYTES[precision]
    flops = sum(4.0 * b * h * nq * nk * HEAD_DIM for b, h, nq, nk in calls)
    nbytes = sum(b * h * HEAD_DIM * (2 * nq + 2 * nk) * elt for b, h, nq, nk in calls)
    return flops, nbytes


def k2_work(images: int, size: int, precision: str) -> tuple[float, float]:
    """(operations, bytes) of K2 on [images, 3, size, size]: the 7x7 stride-2
    conv to 64 channels, 147 taps an output; the input, the weights and the
    output moved once."""
    elt = ELEMENT_BYTES[precision]
    out = (size + 1) // 2
    flops = 2.0 * images * out * out * 64 * 147
    nbytes = (images * 3 * size * size + 64 * 147 + images * 64 * out * out) * elt
    return flops, nbytes


def _reference(config: dict, views: int):
    from hmvbench.reference.model import HandMvNet
    data = config["data"]
    with torch.device("meta"):
        model = HandMvNet(config["model"], views, data["image_size"], data["heatmap_size"],
                          dropout=0.0)  # no masks to draw on the meta device
    return model.to("meta")  # the constant tables are made on the host


def _meta_inputs(config: dict, batch: int, views: int):
    s = config["data"]["image_size"]
    boxes = torch.empty(batch, views, 4, device="meta")
    return torch.empty(batch, views, s, s, 3, device="meta"), boxes, boxes


@functools.lru_cache(maxsize=None)
def _flops(config_json: str, batch: int, views: int, backward: bool) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    config = json.loads(config_json)
    model = _reference(config, views)
    model.train(backward)
    with FlopCounterMode(display=False) as counter:
        out = model(*_meta_inputs(config, batch, views))
        if backward:
            sum(v.sum() for v in out.values()).backward()
    return float(counter.get_total_flops())


def forward_flops(config: dict, batch: int, views: int) -> float:
    """Operations of one inference forward on [batch, views] frames, counted
    on the frozen reference by ``FlopCounterMode`` on the meta device."""
    return _flops(json.dumps(config, sort_keys=True), batch, views, False)


def train_step_flops(config: dict, batch: int, views: int, accumulate: int) -> float:
    """Operations of one optimizer step: forward and backward of each of
    ``accumulate`` microbatches (the optimizer's elementwise work is not
    counted)."""
    micro = batch // accumulate
    return accumulate * _flops(json.dumps(config, sort_keys=True), micro, views, True)
