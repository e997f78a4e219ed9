"""The benchmark's own counts, checked by hand from the shapes."""

from __future__ import annotations

import pytest
import torch

from hmvbench import counts
from hmvbench.tests.conftest import small_cell


def test_k2_at_eight_images():
    # 2 * 147 taps * 64 channels * 128^2 outputs * 8 images
    flops, nbytes = counts.k2_work(8, 256, "float32")
    assert flops == 2 * 147 * 64 * 128 * 128 * 8 == pytest.approx(2.466e9, rel=1e-3)
    # input 8 x 3 x 256^2, weights 64 x 147, output 8 x 64 x 128^2, 4 bytes each
    assert nbytes == 4 * (8 * 3 * 256 * 256 + 64 * 147 + 8 * 64 * 128 * 128)
    assert nbytes == pytest.approx(39.9e6, rel=1e-3)
    # bytes-bound at 3.35 TB/s: 0.0119 ms (the operations take 0.0050 ms at 495 TFLOP/s)
    assert counts.bound_s(flops, nbytes, "float32") == pytest.approx(nbytes / 3.35e12)
    assert counts.bound_s(flops, nbytes, "float32") * 1e3 == pytest.approx(0.0119, rel=1e-2)


def test_k1_calls_and_work():
    model = small_cell("r50.serve.b1v8").config["model"]
    calls = counts.k1_calls(model, 1, 8)
    assert calls == [(1, 8, 168, 168)] * 2 + [(1, 8, 21, 147)] + [(1, 8, 21, 21)] * 2
    flops, nbytes = counts.k1_work([(1, 8, 168, 168)], "float32")
    assert flops == 4 * 8 * 168 * 168 * 128  # q k^T and p v
    assert nbytes == 4 * 8 * 128 * 4 * 168  # q, k, v in, out
    flops, nbytes = counts.k1_work(calls, "float32")
    assert counts.bound_s(flops, nbytes, "float32") * 1e3 == pytest.approx(0.00226, rel=1e-2)


def test_peaks_follow_the_precision():
    assert counts.PEAKS["flops_per_s"] == {"float32": 495e12, "bfloat16": 989e12}
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12


def conv_flops(cin, cout, k, out_side, images):
    return 2 * cin * cout * k * k * out_side * out_side * images


def test_the_flop_counter_against_a_hand_count():
    """The ResNet-50 "paper" trunk at 64^2, counted by hand conv by conv,
    against FlopCounterMode on the reference's trunk (meta device)."""
    from torch.utils.flop_counter import FlopCounterMode

    from hmvbench.reference.model import ResNet50Paper
    images, s = 3, 64
    want = conv_flops(3, 64, 7, s // 2, images)  # the stem
    side, inplanes = s // 4, 64
    for planes, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 1)):
        for i in range(blocks):
            st = stride if i == 0 else 1
            out_side = side // st
            want += conv_flops(inplanes, planes, 1, side, images)
            want += conv_flops(planes, planes, 3, out_side, images)
            want += conv_flops(planes, planes * 4, 1, out_side, images)
            if i == 0:
                want += conv_flops(inplanes, planes * 4, 1, out_side, images)
            side, inplanes = out_side, planes * 4
    with torch.device("meta"):
        trunk = ResNet50Paper()
    with FlopCounterMode(display=False) as counter:
        trunk(torch.empty(images, 3, s, s, device="meta"))
    assert counter.get_total_flops() == want


def test_whole_step_counts():
    config = small_cell("r50.serve.b1v8").config
    fwd = counts.forward_flops(config, 1, 2)
    assert fwd > 0
    # a step's forward and backward: about three forwards a microbatch
    step = counts.train_step_flops(config, 4, 2, 2)
    assert 2 * 2 * fwd * 2 < step < 2 * 3.5 * fwd * 2
