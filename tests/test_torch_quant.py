"""Port parity, the int8 serving path (ops/quant.py behind
``model.backbone_int8``): the quantizer, the int8 convolution, the int8
ResNet-50 "paper" backbone and model, the untouched train path and the
weight bridge, against the JAX package's ops/quant.py on the same numpy
inputs and weights, on the CPU.

Sizes: activations [2, 16, 9, 9] (NCHW) into 24 channels for the conv;
the backbone at batch 2 x 32^2; the HO3D release model at 2 views, 64^2.

Tolerances, with the largest error measured on this CPU:
  * quantize_sym: int8 values and scales bitwise equal (the same fp32
    division and round-half-to-even on both sides);
  * q8_conv: the int32 sums bitwise equal to XLA's int8 convolution with
    preferred_element_type=int32; the dequantized output within rel 1e-6 of
    max (measured 0: the same fp32 products);
  * the int8 backbone against JAX's ``int8_eval`` backbone on the same
    weights: 1e-4 max abs, the fp32 trunk tolerance of
    test_torch_family.py (measured 5.7e-6 on maps up to 15); a flip of one
    activation's quantization level would show as ~1e-2;
  * the int8 model against JAX's int8 model (eval): joints_crop_img 2e-2
    px, joints_cam 5e-4, heatmap 1e-4, test_torch_model.py's fp32 limits;
  * the train path: bitwise equal to the exact model's (outputs, BN
    statistics, gradients).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.models.backbones.resnet import ResNetBackbone as FlaxResNetBackbone
from handmvnet_tpu.ops import quant as jax_quant
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.models.backbones.resnet import ResNetBackbone
from handmvnet_tpu_torch.ops import quant
from torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
HR_CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet_HR.yaml"
TRUNK_ATOL = 1e-4
F64_TOLERANCES = {"heatmap": 1e-10, "joints_cam": 1e-9, "joints_crop_img": 1e-7}
KEYS = ("rgb", "bboxes", "intrinsic")


def _conv_inputs(ksize: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 9, 9)).astype(np.float32)  # NCHW
    w = (rng.standard_normal((24, 16, ksize, ksize)) * 0.1).astype(np.float32)  # OIHW
    w[3] *= 100.0  # one channel far larger: the per-channel scales must keep the others
    return x, w


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_sym_bitwise_equals_jax(per_channel):
    x, w = _conv_inputs(3)
    if per_channel:  # the weight, in each package's layout
        q, s = quant.quantize_sym(torch.from_numpy(w), dim=(1, 2, 3))
        jq, js = jax_quant.quantize_sym(jnp.asarray(w.transpose(2, 3, 1, 0)), axis=(0, 1, 2))
        jq, js = np.asarray(jq).transpose(3, 2, 0, 1), np.asarray(js).reshape(-1, 1, 1, 1)
    else:
        q, s = quant.quantize_sym(torch.from_numpy(x))
        jq, js = (np.asarray(a) for a in jax_quant.quantize_sym(jnp.asarray(x), axis=None))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    assert int(q.abs().max()) == 127


def test_quantize_sym_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])  # scale 1: q = round(x)
    q, s = quant.quantize_sym(x)
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("ksize,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_q8_conv_matches_jax(ksize, stride):
    x, w = _conv_inputs(ksize, seed=ksize + stride)
    pad = (ksize - 1) // 2
    xq, _ = quant.quantize_sym(torch.from_numpy(x))
    wq, _ = quant.quantize_sym(torch.from_numpy(w), dim=(1, 2, 3))
    ours = quant.q8_conv_int32(xq, wq, stride, pad)
    jxq, _ = jax_quant.quantize_sym(jnp.asarray(x.transpose(0, 2, 3, 1)), axis=None)
    jwq, _ = jax_quant.quantize_sym(jnp.asarray(w.transpose(2, 3, 1, 0)), axis=(0, 1, 2))
    ref = lax.conv_general_dilated(jxq, jwq, (stride, stride), ((pad, pad), (pad, pad)),
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   preferred_element_type=jnp.int32)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))

    deq = quant.q8_conv(torch.from_numpy(x), torch.from_numpy(w), stride, pad).numpy()
    jdeq = np.asarray(jax_quant.q8_conv(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
        strides=(stride, stride), padding=((pad, pad), (pad, pad)))).transpose(0, 3, 1, 2)
    assert deq.dtype == np.float32
    assert np.abs(deq - jdeq).max() <= 1e-6 * np.abs(jdeq).max()
    exact = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride, padding=pad)
    assert float((torch.from_numpy(deq) - exact).abs().max()) < 0.05 * float(exact.abs().max())


def test_q8_conv_pads_to_the_int_mm_limits():
    """A product of 5 rows, K 9 and N 3 (under _int_mm's CUDA limits) is
    padded with zeros: the same int32 sums as the unpadded int64 product."""
    rng = np.random.default_rng(1)
    xq = torch.from_numpy(rng.integers(-127, 128, (1, 1, 3, 3), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 1, 3, 3), dtype=np.int8))
    ours = quant.q8_conv_int32(xq, wq, 1, 1)
    ref = F.conv2d(xq.double(), wq.double(), padding=1)
    assert ours.dtype == torch.int32
    assert torch.equal(ours.double(), ref)


def test_q8conv_module_keeps_the_conv_layout_and_adds_bias_after_dequant():
    x, w = _conv_inputs(3, seed=4)
    conv = quant.Q8Conv(16, 24, 3, 2, padding=1, bias=True)
    assert set(conv.state_dict()) == {"weight", "bias"}
    assert tuple(conv.weight.shape) == (24, 16, 3, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.uniform_(-1, 1)
    xt = torch.from_numpy(x)
    got = conv.eval()(xt)
    want = quant.q8_conv(xt, conv.weight, 2, 1) + conv.bias[:, None, None]
    assert torch.equal(got, want)
    assert torch.equal(conv.train()(xt), F.conv2d(xt, conv.weight, conv.bias, 2, 1))


def test_int8_paper_backbone_matches_jax_int8_eval():
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    flax_trunk = FlaxResNetBackbone(version="50_paper", int8_eval=True)
    variables = random_flax_variables(flax_trunk, 3, jnp.asarray(x))
    ref = np.asarray(jax.jit(flax_trunk.apply)(variables, jnp.asarray(x)))
    trunk = ResNetBackbone("50_paper", int8=True).eval()
    trunk.load_state_dict(load_flax_variables(variables), strict=True)
    n_q8 = sum(isinstance(m, quant.Q8Conv) for m in trunk.modules())
    assert n_q8 == (3 + 4 + 6) * 3 + 3  # each block's 3 convs, 3 downsamples; not the stem
    with torch.no_grad():
        ours = trunk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, ref, atol=TRUNK_ATOL, rtol=0)
    exact = np.asarray(jax.jit(FlaxResNetBackbone(version="50_paper").apply)(
        variables, jnp.asarray(x)))
    assert np.abs(ref - exact).max() > 100 * TRUNK_ATOL  # int8 is not the exact path


def test_int8_train_path_is_the_exact_one():
    """In train mode the int8 backbone runs the plain convs: outputs, BN
    statistics and gradients bitwise equal to the exact backbone's."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 32, 32))
                         .astype(np.float32))
    runs = []
    for int8 in (False, True):
        torch.manual_seed(0)
        trunk = ResNetBackbone("18", early_return=4, int8=int8).train()
        out = trunk(x)
        out["res_layer4"].square().mean().backward()
        runs.append((out, trunk.state_dict(), {n: p.grad for n, p in trunk.named_parameters()}))
    (o0, s0, g0), (o1, s1, g1) = runs
    assert all(torch.equal(o0[k], o1[k]) for k in o0)
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def _model_configs(path: Path, views: int = 2, **changes):
    changes = {"selected_views": tuple(range(views)), **changes}
    return (dataclasses.replace(Config.from_yaml(path).model, **changes),
            dataclasses.replace(JaxConfig.from_yaml(path).model, **changes))


def test_int8_model_weights_load_and_match_jax():
    """The JAX int8 model's variables (the exact model's tree) load into the
    port's int8 model through load_flax_variables; its eval forward matches
    JAX's int8 forward, in float64 on both sides (see the module docstring)."""
    mcfg, jmcfg = _model_configs(CONFIG, backbone_int8=True)
    data = synthetic_batch(1, 2, 64, seed=3)
    data = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in data.items()}
    with jax.enable_x64(True):
        flax_model = FlaxHandMvNet(cfg=jmcfg, image_size=64, heatmap_size=8, dropout=0.0)
        args = [jnp.asarray(data[k]) for k in KEYS]
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 random_flax_variables(flax_model, 17, *args))
        exact_tree = jax.eval_shape(
            FlaxHandMvNet(cfg=dataclasses.replace(jmcfg, backbone_int8=False), image_size=64,
                          heatmap_size=8).init, jax.random.PRNGKey(0), *args)
        assert jax.tree.map(lambda a: a.shape, variables) == \
            jax.tree.map(lambda a: a.shape, exact_tree)
        # op by op, as the port runs: under jit XLA rewrites the scales (ops/quant.py)
        ref = flax_model.apply(variables, *args, train=False)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    model = HandMvNet(mcfg, 64, 8).double().eval()
    model.load_state_dict(load_flax_variables(variables), strict=True)
    assert any(isinstance(m, quant.Q8Conv) for m in model.modules())
    with torch.no_grad():
        out = model(*(torch.from_numpy(data[k]) for k in KEYS))
    for key, tol in F64_TOLERANCES.items():
        assert out[key].dtype == torch.float64
        np.testing.assert_allclose(out[key].numpy(), ref[key], atol=tol, rtol=0, err_msg=key)


def test_hrnet_ignores_the_flag():
    mcfg, _ = _model_configs(HR_CONFIG, backbone_int8=True)
    model = HandMvNet(mcfg, 64, 8)
    assert not any(isinstance(m, quant.Q8Conv) for m in model.modules())
