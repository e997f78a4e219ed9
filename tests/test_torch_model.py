"""Port parity, the slice as a whole: handmvnet_tpu_torch's HandMvNet
forward against the JAX package's on the same weights and inputs, fp32 on
the CPU, in eval mode and in train mode (batch statistics, dropout 0), plus
the weight bridge and the port's eval_fps entry point.

Models: configs/release/DexYCB_HandMvNet.yaml (the 8-view release model, whose
weight shapes the b1 x v8 protocol runs) and its _wo_cam variant (no crop-FoV
encoding), with views cut to 3, batch 2 and 64^2 images, so heatmaps are 8^2.
"""

import copy
import dataclasses
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from handmvnet_tpu.checkpoint import convert_torch_state_dict, flatten_tree
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config, parse_yaml
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.eval_fps import run_protocol
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.ops.attention import fused_attention
from handmvnet_tpu_torch.ops.stem import stem_conv_nchw
from torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "DexYCB_HandMvNet.yaml"
VIEWS, BATCH, IMAGE, HEATMAP = 3, 2, 64, 8

# fp32 atol of each output, with the largest error measured on this CPU
TOLERANCES = {
    "heatmap": 1e-4,          # logits up to ~3; measured 6e-6 (summation order)
    "joints_crop_img": 2e-2,  # pixels of the 64^2 crop: soft-argmax at x1000
                              # amplifies heatmap noise; measured 4.7e-3
    "joints_cam": 5e-4,       # values up to ~1.5 after 5 fusion blocks fed
                              # those coordinates; measured 7.1e-5
}


@pytest.fixture(scope="module", params=["DexYCB_HandMvNet.yaml", "DexYCB_HandMvNet_wo_cam.yaml"])
def slice_case(request):
    """One JAX forward per config, shared by every case of this module."""
    path = ROOT / "configs" / "release" / request.param
    cfg = Config.from_yaml(path)
    mcfg = dataclasses.replace(cfg.model, selected_views=tuple(range(VIEWS)))
    jcfg = JaxConfig.from_yaml(path)
    jmcfg = dataclasses.replace(jcfg.model, selected_views=tuple(range(VIEWS)))

    data = synthetic_batch(BATCH, VIEWS, IMAGE, seed=3)
    args = (jnp.asarray(data["rgb"]), jnp.asarray(data["bboxes"]), jnp.asarray(data["intrinsic"]))
    flax_model = FlaxHandMvNet(cfg=jmcfg, image_size=IMAGE, heatmap_size=HEATMAP)
    variables = random_flax_variables(flax_model, 17, *args)
    ref = jax.jit(flax_model.apply)(variables, *args)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    port = HandMvNet(mcfg, image_size=IMAGE, heatmap_size=HEATMAP).eval()
    state = load_flax_variables(variables)
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        ours = port(*(torch.from_numpy(data[k]) for k in ("rgb", "bboxes", "intrinsic")))
    return {"variables": variables, "state": state, "port": port, "ref": ref,
            "ours": {k: v.numpy() for k, v in ours.items()}, "data": data, "args": args,
            "cfg": mcfg, "jax_cfg": jmcfg}


@pytest.mark.parametrize("key", sorted(TOLERANCES))
def test_forward_matches_flax(slice_case, key):
    ref, ours = slice_case["ref"][key], slice_case["ours"][key]
    assert ours.shape == ref.shape
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=TOLERANCES[key], rtol=0)


def test_output_shapes(slice_case):
    ours = slice_case["ours"]
    assert ours["joints_cam"].shape == (BATCH, 21, 3)
    assert ours["joints_crop_img"].shape == (BATCH, VIEWS, 21, 2)
    assert ours["heatmap"].shape == (BATCH, VIEWS, 21, HEATMAP, HEATMAP)
    assert all(np.isfinite(v).all() for v in ours.values())


def test_bridge_consumes_every_leaf_once(slice_case):
    """Every flax leaf maps to exactly one port key and no port key is left
    without one (BatchNorm's num_batches_tracked is torch's own counter)."""
    variables, state = slice_case["variables"], slice_case["state"]
    port_keys = set(slice_case["port"].state_dict())
    leaves = flatten_tree(variables["params"]) | {
        ("stats",) + k: v for k, v in flatten_tree(variables["batch_stats"]).items()
    }
    counters = {k for k in state if k.endswith("num_batches_tracked")}
    assert len(state) - len(counters) == len(leaves)
    assert set(state) == port_keys
    assert counters == {k[: -len("running_mean")] + "num_batches_tracked"
                        for k in state if k.endswith("running_mean")}


def test_bridge_round_trips_through_jax_converter(slice_case):
    """The port's state_dict keys are the reference's torch keys: the JAX
    package's own torch converter turns them back into the same flax tree."""
    back = convert_torch_state_dict(slice_case["port"].state_dict())
    for coll in ("params", "batch_stats"):
        want = flatten_tree(slice_case["variables"][coll])
        got = flatten_tree(back[coll])
        assert set(got) == set(want), coll
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


def test_cpu_forward_launches_no_kernel(slice_case):
    before = (fused_attention.launches, stem_conv_nchw.launches)
    with torch.no_grad():
        slice_case["port"](*(torch.zeros(1, VIEWS, IMAGE, IMAGE, 3), torch.ones(1, VIEWS, 4),
                             torch.ones(1, VIEWS, 4)))
    assert (fused_attention.launches, stem_conv_nchw.launches) == before


def test_train_mode_is_refused(slice_case):
    """A train-mode forward with dropout needs the generator its masks come
    from: without one it is refused, not drawn from the global RNG."""
    port = copy.deepcopy(slice_case["port"]).train()
    with pytest.raises(ValueError, match="torch.Generator"):
        port(torch.zeros(1, VIEWS, IMAGE, IMAGE, 3), torch.ones(1, VIEWS, 4) * 100,
             torch.ones(1, VIEWS, 4) * 100)


# Train mode is compared in float64 on both sides: in fp32 both packages' own
# rounding is amplified through 45 train-mode BatchNorms over random weights
# (on this model the port's fp32 heatmaps sit 1.2e-4 from its float64 ones,
# and flax's, whose variance is E[x^2] - E[x]^2, 5.9e-4; joints_crop_img
# 0.13 px and 2.6 px). Tolerances in float64, with the largest error measured:
# heatmap 1e-10 (1.4e-12), joints_cam 1e-9 (8.1e-11), joints_crop_img 1e-7 px
# (1.8e-9: the x1000 soft-argmax of logits up to ~3), running statistics
# 1e-10 (4.4e-14).
TRAIN_TOLERANCES = {"heatmap": 1e-10, "joints_cam": 1e-9, "joints_crop_img": 1e-7}
TRAIN_STATS_ATOL = 1e-10


def test_train_forward_matches_flax(slice_case):
    """Train mode at dropout 0: outputs from batch statistics, and the
    running statistics they update, against flax's train=True forward."""
    to64 = partial(jax.tree.map, lambda a: np.asarray(a, np.float64))
    variables = to64(slice_case["variables"])
    data = to64({k: slice_case["data"][k] for k in ("rgb", "bboxes", "intrinsic")})
    with jax.enable_x64(True):
        flax_model = FlaxHandMvNet(cfg=slice_case["jax_cfg"], image_size=IMAGE,
                                   heatmap_size=HEATMAP, dropout=0.0)
        ref, mutated = jax.jit(lambda v, *a: flax_model.apply(
            v, *a, train=True, mutable=["batch_stats"]))(
                variables, *(jnp.asarray(data[k]) for k in ("rgb", "bboxes", "intrinsic")))
        ref = {k: np.asarray(v) for k, v in ref.items()}
        stats = load_flax_variables({"batch_stats": jax.tree.map(np.asarray,
                                                                 mutated["batch_stats"])})
    port = HandMvNet(slice_case["cfg"], image_size=IMAGE, heatmap_size=HEATMAP, dropout=0.0)
    port.load_state_dict(load_flax_variables(variables))
    with torch.no_grad():
        ours = port.double().train()(
            *(torch.from_numpy(data[k]) for k in ("rgb", "bboxes", "intrinsic")))
    for key, tol in TRAIN_TOLERANCES.items():
        assert ours[key].dtype == torch.float64
        np.testing.assert_allclose(ours[key].numpy(), ref[key], atol=tol, rtol=0, err_msg=key)
    sd = port.state_dict()
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 45
    for key in keys:
        np.testing.assert_allclose(sd[key].numpy(), stats[key].numpy(), atol=TRAIN_STATS_ATOL,
                                   rtol=0, err_msg=key)


def test_synthetic_batch_matches_jax_package():
    ours = synthetic_batch(2, 3, 32, seed=5)
    ref = jax_synthetic_batch(batch_size=2, num_views=3, image_size=32, seed=5,
                              with_heatmaps=False)
    for key in ("rgb", "bboxes", "intrinsic"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_config_matches_jax_package():
    for name in ("DexYCB_HandMvNet.yaml", "HO3D_HandMvNet.yaml"):
        ours = Config.from_yaml(ROOT / "configs" / "release" / name)
        ref = JaxConfig.from_yaml(ROOT / "configs" / "release" / name)
        assert ours.to_dict() == ref.to_dict()
        assert ours.model.feat_dim == ref.model.feat_dim == 524


@pytest.mark.parametrize("path", sorted((ROOT / "configs").rglob("*.yaml")),
                         ids=lambda p: p.name)
def test_yaml_subset_parser_matches_pyyaml(path):
    assert parse_yaml(path.read_text()) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("src", ["a: [1, 2]\n", "a: &x 1\n", "a: |\n  text\n", "a\n"])
def test_yaml_subset_parser_refuses_other_yaml(src):
    with pytest.raises(ValueError):
        parse_yaml(src)


def test_eval_fps_protocol_runs_on_cpu():
    stats, out = run_protocol(Config.from_yaml(CONFIG), views=2, image_size=32,
                              warmup=1, iters=2, device="cpu")
    assert stats["forwards"] == 5 and stats["device"] == "cpu"
    assert stats["fps"] > 0 and stats["p50_ms"] > 0
    assert out["joints_cam"].shape == (1, 21, 3)
    assert torch.isfinite(out["joints_cam"]).all()
