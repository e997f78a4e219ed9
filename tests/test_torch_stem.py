"""Port parity, stem (K2) and backbone: handmvnet_tpu_torch.ops.stem and
models.backbones.resnet against the JAX package on the CPU, in fp32, and in
bf16 for the function the card's bf16 kernel computes.

On a CPU tensor ``stem_conv`` computes its plain version, held here against
the Pallas kernel (interpret mode) and the plain JAX conv. The CUDA kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handmvnet_tpu.models.backbones.resnet import ResNetBackbone as FlaxResNet
from handmvnet_tpu.ops.pallas.stem import stem_s2d_fused, stem_s2d_reference
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.models.backbones.resnet import ResNetBackbone
from handmvnet_tpu_torch.ops.stem import stem_conv, stem_conv_nchw, stem_conv_plain
from torch_parity import random_flax_variables, rel_max_err

REL_TOL = 1e-6  # tests/test_stem_modes.py's fp32 rule: max|diff| / max|ref|


def _stem_case(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    kernel = (rng.normal(size=(7, 7, 3, 64)) * 0.05).astype(np.float32)
    return x, kernel


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (8, 64, 96, 3)])
def test_stem_matches_pallas_interpret_and_plain_conv(shape):
    x, kernel = _stem_case(shape, seed=shape[2])
    ours = stem_conv(torch.from_numpy(x), torch.from_numpy(kernel)).numpy()
    pallas = np.asarray(stem_s2d_fused(jnp.asarray(x), jnp.asarray(kernel), interpret=True))
    ref = np.asarray(stem_s2d_reference(jnp.asarray(x), jnp.asarray(kernel)))
    assert ours.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    assert rel_max_err(ours, pallas) < REL_TOL
    assert rel_max_err(ours, ref) < REL_TOL


def test_stem_matches_pallas_interpret_bf16():
    """The bf16 function the card's kernel is held to: the plain conv in bf16
    against the Pallas kernel in bf16 (bf16 products, f32 sums, one rounding),
    within 2^-6 x max|plain|, an ulp or two."""
    x, kernel = _stem_case((2, 64, 64, 3), seed=0)
    ours = stem_conv(torch.from_numpy(x).to(torch.bfloat16),
                     torch.from_numpy(kernel).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    pallas = stem_s2d_fused(jnp.asarray(x, dtype=jnp.bfloat16),
                            jnp.asarray(kernel, dtype=jnp.bfloat16), interpret=True)
    assert pallas.dtype == jnp.bfloat16
    pallas = np.asarray(pallas.astype(jnp.float32))
    assert ours.shape == pallas.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=2.0 ** -6 * np.abs(ours).max())


def test_stem_odd_size_matches_plain_conv():
    """Odd sizes (the Pallas kernel needs even ones): output ceil(H/2)."""
    x, kernel = _stem_case((1, 30, 34, 3), seed=3)
    ours = stem_conv(torch.from_numpy(x), torch.from_numpy(kernel)).numpy()
    x_odd = x[:, :29, :33]
    ours_odd = stem_conv(torch.from_numpy(np.ascontiguousarray(x_odd)),
                         torch.from_numpy(kernel)).numpy()
    for got, inp in ((ours, x), (ours_odd, x_odd)):
        ref = np.asarray(stem_s2d_reference(jnp.asarray(inp), jnp.asarray(kernel)))
        assert got.shape == ref.shape
        assert rel_max_err(got, ref) < REL_TOL
    assert ours_odd.shape == (1, 15, 17, 64)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    x, kernel = _stem_case((2, 20, 20, 3), seed=4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous()
    before = stem_conv_nchw.launches
    out = stem_conv_nchw(xt, w)
    assert stem_conv_nchw.launches == before
    torch.testing.assert_close(out, stem_conv_plain(xt, w), rtol=0, atol=0)


def test_resnet50_paper_matches_flax():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    flax_net = FlaxResNet(version="50_paper", early_return=3)
    variables = random_flax_variables(flax_net, 8, jnp.asarray(x))
    ref = np.asarray(flax_net.apply(variables, jnp.asarray(x)))

    port = ResNetBackbone("50_paper")
    port.load_state_dict(load_flax_variables(variables), strict=True)
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape == (2, 8, 8, 1024)
    # tests/test_parity_model.py's backbone tolerance
    np.testing.assert_allclose(ours, ref, atol=1e-3)
