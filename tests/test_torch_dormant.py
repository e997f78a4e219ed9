"""Port parity, the dormant modules that no config selects: the stacked
hourglass backbones (through the hourglass wrappers' flat names of the
weight bridge), the legacy PoseNet head, the graph nets, the learnable and
frequency encodings, graph pooling, and the square-box jitter, against the
JAX package on the same weights and inputs, fp32 on the CPU.

Sizes are tests/test_dormant_modules.py's: the hourglasses at nstack 2,
inp_dim 32, recur_hg 2 on 64^2 images; the graph nets over the 21 joints.

Tolerances, with the largest error measured on this CPU:
  * the hourglasses, eval mode: 1e-6 of each output's max |x| (outputs up
    to ~260; measured 5.9e-7 and 4.7e-7 of max on the plain and the
    bisected one);
  * PoseNet: heatmaps 1e-5 (measured 9.5e-7), coordinates 1e-3 px of the
    32^2 map (measured 3.2e-4: the x1000 soft-argmax);
  * the graph nets, the encodings and graph pooling: 1e-5 (measured 2.4e-6
    at most, on GraphChebConvNet's outputs up to ~12);
  * the box jitter at JAX's draws: 2e-4 px on boxes up to ~570 px (measured
    6.1e-5, an ulp of the float32 corners).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handmvnet_tpu.data import augment as jax_augment
from handmvnet_tpu.models import layers as jax_layers
from handmvnet_tpu.models import nets as jax_nets
from handmvnet_tpu.models.backbones import hourglass as jax_hourglass
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.data import augment
from handmvnet_tpu_torch.models import layers, nets
from handmvnet_tpu_torch.models.backbones import hourglass
from torch_parity import random_flax_variables


def _load(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(load_flax_variables(variables), strict=True)
    return module.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    """[B, C, H, W] -> [B, H, W, C], and [B, S, C, H, W] -> [B, S, H, W, C]."""
    return np.moveaxis(x.numpy(), -3, -1)


# ---------------------------------------------------------------- hourglass


@pytest.mark.parametrize("bisected", [False, True], ids=["stacked", "bisected"])
def test_hourglass_matches_flax(bisected):
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    if bisected:
        flax_model = jax_hourglass.StackedBisectedHourglass(nstack=2, inp_dim=32, recur_hg=2)
        port = hourglass.StackedBisectedHourglass(nstack=2, inp_dim=32, recur_hg=2)
    else:
        flax_model = jax_hourglass.StackedHourglass(nstack=2, inp_dim=32, recur_hg=2)
        port = hourglass.StackedHourglass(nstack=2, inp_dim=32, recur_hg=2)
    variables = random_flax_variables(flax_model, 11, jnp.asarray(x))
    ref = jax.jit(flax_model.apply)(variables, jnp.asarray(x))
    _load(port, variables)
    with torch.no_grad():
        ours = port(_nchw(x))
    assert len(ours) == len(ref) == (4 if bisected else 3)
    shapes = [(2, 8, 8, 32), (2, 2, 8, 8, 21), (2, 8, 8, 32), (2, 2, 8, 8, 1)]
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert _nhwc(o).shape == r.shape == shapes[i], i
        r = np.asarray(r)
        np.testing.assert_allclose(_nhwc(o), r, atol=1e-6 * np.abs(r).max(), rtol=0,
                                   err_msg=str(i))


def test_hourglass_weights_take_the_reference_nesting():
    """The wrappers' levels come back from the flax tree's flat names:
    conv1_conv -> conv1.conv, merge_preds_0/conv -> merge_preds.0.conv.conv,
    and the bisected hourglass's hg_L_i_j_0 -> hg.L.i.j.0."""
    x = jnp.zeros((1, 64, 64, 3))
    state = load_flax_variables(random_flax_variables(
        jax_hourglass.StackedHourglass(nstack=2, inp_dim=32, recur_hg=2), 0, x))
    for key in ("pre.1.conv1.conv.weight", "pre.1.skip_layer.conv.bias",
                "hgs.0.0.low2.low2.conv3.conv.weight", "merge_preds.0.conv.conv.weight",
                "merge_features.0.conv.conv.bias", "outs.1.conv.weight", "pre.0.bn.running_var",
                "features.1.1.conv.weight"):
        assert key in state, key
    assert not any(k.startswith("hgs.0.0.up1.skip_layer") for k in state)  # same widths
    state = load_flax_variables(random_flax_variables(
        jax_hourglass.StackedBisectedHourglass(nstack=2, inp_dim=32, recur_hg=2), 0, x))
    for key in ("hg2b.1.hg.1.0.1.0.conv2.conv.weight", "hg2b.0.hg.0.3.1.0.bn3.weight",
                "_fc1.0.weight", "fc2.1.1.running_mean", "mask.1.bias", "layer3.0.bn1.bias"):
        assert key in state, key


# ---------------------------------------------------------------- nets


def test_posenet_matches_flax():
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 128)).astype(np.float32)
    flax_model = jax_nets.PoseNet(channels=(64, 21))
    variables = random_flax_variables(flax_model, 12, jnp.asarray(x))
    coords_ref, hm_ref = flax_model.apply(variables, jnp.asarray(x))
    port = _load(nets.PoseNet(128, (64, 21)), variables)
    assert "conv.3.weight" in port.state_dict()
    with torch.no_grad():
        coords, hm = port(_nchw(x))
    np.testing.assert_allclose(hm.numpy(), np.asarray(hm_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(coords.numpy(), np.asarray(coords_ref), atol=1e-3, rtol=0)


def _graph_case(name: str):
    """(flax module, port module, input [2, 21, C]) of each graph net."""
    if name == "cheb":
        return (jax_nets.GraphChebConvNet(in_dim=32, out_dim=3, hidden_dim=16, num_layers=3),
                nets.GraphChebConvNet(32, 3, 16, 3), 32)
    if name == "gconv":
        return jax_nets.GraphConvNet(16, 8, 21), nets.GraphConvNet(16, 8, 21), 16
    return (jax_nets.ResidualGraphConv(input_dim=16, hid_dim=8, nodes=21),
            nets.ResidualGraphConv(16, 8, 21), 16)


@pytest.mark.parametrize("name", ["cheb", "gconv", "residual"])
def test_graph_nets_match_flax(name):
    """A_hat is drawn positive, as an adjacency's weights are: the degree
    normalisation takes (column sum)^-1/2."""
    flax_model, port, width = _graph_case(name)
    x = np.random.default_rng(2).standard_normal((2, 21, width)).astype(np.float32)
    variables = random_flax_variables(flax_model, 13, jnp.asarray(x))
    rng = np.random.default_rng(3)

    def positive(path, a):
        key = str(getattr(path[-1], "key", path[-1]))
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32) if key == "A_hat" else a

    variables = jax.tree_util.tree_map_with_path(positive, variables)
    ref = np.asarray(flax_model.apply(variables, jnp.asarray(x)))
    _load(port, variables)
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape and np.isfinite(ref).all()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_graph_pool_unpool_match_flax():
    x = np.random.default_rng(4).standard_normal((2, 21, 8)).astype(np.float32)
    for flax_cls, cls, (n_in, n_out) in ((jax_layers.GraphPool, layers.GraphPool, (21, 10)),
                                         (jax_layers.GraphUnpool, layers.GraphUnpool, (10, 21))):
        xin = x[:, :n_in]
        flax_model = flax_cls(out_nodes=n_out)
        variables = random_flax_variables(flax_model, 14, jnp.asarray(xin))
        ref = np.asarray(flax_model.apply(variables, jnp.asarray(xin)))
        port = _load(cls(n_in, n_out), variables)
        with torch.no_grad():
            ours = port(torch.from_numpy(np.ascontiguousarray(xin))).numpy()
        assert ours.shape == ref.shape == (2, n_out, 8)
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- encodings


def test_learnable_positional_encoding_matches_flax():
    x = np.random.default_rng(5).standard_normal((2, 30, 16)).astype(np.float32)
    flax_model = jax_layers.LearnablePositionalEncoding(d_model=16, max_len=50)
    variables = random_flax_variables(flax_model, 15, jnp.asarray(x))
    ref = np.asarray(flax_model.apply(variables, jnp.asarray(x)))
    port = _load(layers.LearnablePositionalEncoding(16, max_len=50), variables)
    assert set(port.state_dict()) == {"pe"}
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_frequencies", [4, 6])
def test_frequency_encoding_matches_jax(num_frequencies):
    x = np.random.default_rng(6).standard_normal((2, 21, 2)).astype(np.float32) * 30
    ref = np.asarray(jax_layers.frequency_encoding(jnp.asarray(x), num_frequencies))
    ours = layers.frequency_encoding(torch.from_numpy(x), num_frequencies).numpy()
    assert ours.shape == ref.shape == (2, 21, 2 * num_frequencies)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- box jitter


def _square_boxes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    center = rng.uniform(100, 500, (n, 2))
    side = rng.uniform(100, 300, n)
    return np.concatenate([center - side[:, None] / 2, center + side[:, None] / 2],
                          axis=-1).astype(np.float32)


def test_jitter_square_boxes_matches_jax_at_its_draws():
    """JAX's own draws (its key split into the shift's and the scale's
    uniforms) through apply_box_jitter give JAX's boxes."""
    boxes = _square_boxes(12, 7).reshape(3, 4, 4)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_augment.jitter_square_boxes(jnp.asarray(boxes), key, 10.0, 0.1))
    k_shift, k_scale = jax.random.split(key)
    draws = {"shift": torch.from_numpy(np.asarray(jax.random.uniform(
                 k_shift, (3, 4, 2), minval=-10.0, maxval=10.0))),
             "scale": torch.from_numpy(1.0 + np.asarray(jax.random.uniform(
                 k_scale, (3, 4), minval=-0.1, maxval=0.1)))}
    ours = augment.apply_box_jitter(torch.from_numpy(boxes), draws).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)
    side = ours[..., 2] - ours[..., 0]
    np.testing.assert_allclose(side, ours[..., 3] - ours[..., 1], atol=2e-4)


def test_jitter_square_boxes_draws_from_the_generator():
    """The port's draws: the same generator state gives the same boxes, the
    boxes stay square, and the shift and scale lie in their ranges with
    JAX's means (0 px and 1)."""
    boxes = torch.from_numpy(_square_boxes(4000, 8))
    gen = torch.Generator().manual_seed(0)
    out = augment.jitter_square_boxes(boxes, gen, max_shift=10.0, max_scale=0.1)
    again = augment.jitter_square_boxes(boxes, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    side_in = boxes[:, 2] - boxes[:, 0]
    side = out[:, 2] - out[:, 0]
    torch.testing.assert_close(side, out[:, 3] - out[:, 1], atol=1e-3, rtol=0)
    shift = (out[:, :2] + out[:, 2:]) / 2 - (boxes[:, :2] + boxes[:, 2:]) / 2
    scale = side / side_in
    assert float(shift.abs().max()) <= 10.0 + 1e-3
    assert float((scale - 1).abs().max()) <= 0.1 + 1e-5
    # uniform means: 0 +- 4 sigma of the mean of 4000 (sigma = 10 / sqrt(3 n))
    assert abs(float(shift.mean())) < 4 * 10.0 / np.sqrt(3 * 8000)
    assert abs(float(scale.mean()) - 1.0) < 4 * 0.1 / np.sqrt(3 * 4000)
