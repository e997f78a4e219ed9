"""Port parity, the rest of the model family: the ResNet trunks of every
layout with their early_return dicts, the transposed-conv head of the
default ResNets, the learnable-query fusion, the refusal of a combination the
JAX forward cannot run, and the ImageNet graft of a default ResNet, against
the JAX package on the same weights (carried by load_flax_variables) and
inputs, on the CPU.

Sizes are test_torch_model.py's: the DexYCB release config with its
backbone swapped, 3 views, batch 2, 64^2 images (8^2 heatmaps).

Tolerances, with the largest error measured on this CPU:
  * trunks, fp32: 1e-4 max abs on maps of |x| up to ~18 (measured 1.8e-5 on
    ResNet-50's layer3; res_layer4_mean 4.3e-6), the backbone tolerance of
    the JAX package's own parity tests being 1e-3;
  * the whole forward, in train mode (dropout 0) and, on ResNet-50, in eval
    mode: float64 on both sides, test_torch_model.py's train-mode
    tolerances (heatmap 1e-10, joints_cam 1e-9, joints_crop_img 1e-7 px;
    measured at most 1.4e-12, 5.9e-11 and 7.9e-10 px). In fp32 the x1000 soft-argmax
    turns the two packages' summation order into 2.02e-2 px of
    joints_crop_img and 5.6e-4 of joints_cam on ResNet-50 at these weights
    (test_torch_model.py's fp32 limits are 2e-2 and 5e-4), so the fp32
    forward is held on ResNet-18 and on the learnable-query model, at
    test_torch_model.py's fp32 tolerances (measured 5.2e-6, 4.8e-3 px and
    1.8e-4);
  * running statistics after the train-mode forward: 1e-10 (as
    test_torch_model.py; measured 8.7e-14);
  * the transposed conv against flax's: 1e-5 (measured 2.4e-7).
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handmvnet_tpu import pretrained as jax_pretrained
from handmvnet_tpu.checkpoint import convert_torch_state_dict, flatten_tree
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.models.backbones.resnet import ResNetBackbone as FlaxResNetBackbone
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.models.backbones.resnet import ResNetBackbone
from handmvnet_tpu_torch.ops import attention as attention_ops
from handmvnet_tpu_torch.pretrained import load_pretrained_backbone
from torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "DexYCB_HandMvNet.yaml"
VIEWS, BATCH, IMAGE, HEATMAP = 3, 2, 64, 8
KEYS = ("rgb", "bboxes", "intrinsic")

TRUNK_ATOL = 1e-4
FP32_TOLERANCES = {"heatmap": 1e-4, "joints_crop_img": 2e-2, "joints_cam": 5e-4}
F64_TOLERANCES = {"heatmap": 1e-10, "joints_cam": 1e-9, "joints_crop_img": 1e-7}
STATS_ATOL = 1e-10


def _configs(**changes):
    """The port's and the JAX package's model config at the test size."""
    changes = {"selected_views": tuple(range(VIEWS)), **changes}
    return (dataclasses.replace(Config.from_yaml(CONFIG).model, **changes),
            dataclasses.replace(JaxConfig.from_yaml(CONFIG).model, **changes))


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


# ---------------------------------------------------------------- trunks


@pytest.mark.parametrize("early_return", [1, 2, 3, 4, 0])
@pytest.mark.parametrize("version", ["18", "50"])
def test_trunk_matches_flax(version, early_return):
    """Every map of the dict, and res_layer4_mean, in the JAX dict's order."""
    x = np.random.default_rng(0).standard_normal((1, IMAGE, IMAGE, 3)).astype(np.float32)
    flax_trunk = FlaxResNetBackbone(version=version, early_return=early_return)
    variables = random_flax_variables(flax_trunk, 3, jnp.asarray(x))
    ref = jax.jit(flax_trunk.apply)(variables, jnp.asarray(x))
    trunk = ResNetBackbone(version, early_return=early_return).eval()
    trunk.load_state_dict(load_flax_variables(variables), strict=True)
    with torch.no_grad():
        ours = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
    stages = early_return or 4
    want = [f"res_layer{i}" for i in range(1, stages + 1)] + \
        (["res_layer4_mean"] if stages == 4 else [])
    assert list(ours) == list(ref) == want
    for key, r in ref.items():
        o = ours[key].numpy()
        o = o.transpose(0, 2, 3, 1) if o.ndim == 4 else o
        assert o.shape == r.shape, key
        np.testing.assert_allclose(o, np.asarray(r), atol=TRUNK_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("version", ["34", "101", "152"])
def test_trunk_state_dict_equals_flax_tree(version):
    """Keys and shapes of the deeper layouts against the flax init tree
    (jax.eval_shape: nothing is computed), through the weight bridge."""
    flax_trunk = FlaxResNetBackbone(version=version, early_return=0)
    shapes = jax.eval_shape(flax_trunk.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMAGE, IMAGE, 3)))
    state = load_flax_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        trunk = ResNetBackbone(version, early_return=0)
    ours = {k: tuple(v.shape) for k, v in trunk.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in state.items()}
    blocks = {"34": (3, 4, 6, 3), "101": (3, 4, 23, 3), "152": (3, 8, 36, 3)}[version]
    for stage, n in enumerate(blocks, start=1):
        assert f"layer{stage}.{n - 1}.bn2.running_var" in ours
        assert f"layer{stage}.{n}.bn2.running_var" not in ours


# ---------------------------------------------------------------- whole model


CASES = {"resnet18": {"backbone_type": "18"}, "resnet50": {"backbone_type": "50"},
         "learnable_query": {"fusion": "cross_attn_learnable_query"}}


@functools.lru_cache(maxsize=None)
def _case(name: str) -> dict:
    """The flax model and its random fp32 variables, the port's config, and
    one batch (shared by the tests of this module)."""
    mcfg, jmcfg = _configs(**CASES[name])
    data = synthetic_batch(BATCH, VIEWS, IMAGE, seed=3)
    flax_model = FlaxHandMvNet(cfg=jmcfg, image_size=IMAGE, heatmap_size=HEATMAP, dropout=0.0)
    variables = random_flax_variables(flax_model, 17, *(jnp.asarray(data[k]) for k in KEYS))
    return {"flax": flax_model, "variables": variables, "data": data, "cfg": mcfg}


def _port(case: dict, variables) -> HandMvNet:
    port = HandMvNet(case["cfg"], image_size=IMAGE, heatmap_size=HEATMAP, dropout=0.0)
    state = load_flax_variables(variables)
    if next(iter(state.values())).dtype == torch.float64:
        port = port.double()
    port.load_state_dict(state, strict=True)
    return port


@pytest.mark.parametrize("name", ["resnet18", "learnable_query"])
def test_forward_matches_flax_fp32(name):
    case = _case(name)
    ref = jax.jit(case["flax"].apply)(case["variables"],
                                      *(jnp.asarray(case["data"][k]) for k in KEYS))
    port = _port(case, case["variables"]).eval()
    with torch.no_grad():
        ours = port(*(torch.from_numpy(case["data"][k]) for k in KEYS))
    assert set(ours) == set(ref)
    for key, tol in FP32_TOLERANCES.items():
        assert ours[key].dtype == torch.float32 and ours[key].shape == ref[key].shape
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=tol, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name,train", [("resnet50", False)] + [(n, True) for n in sorted(CASES)],
                         ids=["resnet50-eval"] + [f"{n}-train" for n in sorted(CASES)])
def test_forward_matches_flax_float64(name, train):
    """Train mode at dropout 0 (batch statistics, and the running statistics
    they update) on every model, and eval mode on ResNet-50, whose fp32
    forward is not held (module docstring)."""
    case = _case(name)
    variables = _f64(case["variables"])
    data = _f64({k: case["data"][k] for k in KEYS})
    with jax.enable_x64(True):
        fn = jax.jit(lambda v, *a: case["flax"].apply(
            v, *a, train=train, mutable=["batch_stats"] if train else False))
        ref = fn(variables, *(jnp.asarray(data[k]) for k in KEYS))
        ref, mutated = ref if train else (ref, None)
        ref = {k: np.asarray(v) for k, v in ref.items()}
        if train:
            stats = load_flax_variables({"batch_stats": jax.tree.map(np.asarray,
                                                                     mutated["batch_stats"])})
    port = _port(case, variables).train(train)
    with torch.no_grad():
        ours = port(*(torch.from_numpy(data[k]) for k in KEYS))
    for key, tol in F64_TOLERANCES.items():
        assert ours[key].dtype == torch.float64
        np.testing.assert_allclose(ours[key].numpy(), ref[key], atol=tol, rtol=0, err_msg=key)
    if train:
        sd = port.state_dict()
        keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
        assert keys and len(keys) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                                             for m in port.modules())
        for key in keys:
            np.testing.assert_allclose(sd[key].numpy(), stats[key].numpy(), atol=STATS_ATOL,
                                       rtol=0, err_msg=key)


def test_bridge_round_trips_every_new_leaf():
    """The ConvTranspose kernel, the probe and every other leaf of the three
    models come back from the port's state_dict through the JAX package's
    own converter unchanged; the transposed conv's weight is torch's
    [I, O, kh, kw]."""
    for name in CASES:
        case = _case(name)
        port = _port(case, case["variables"])
        back = convert_torch_state_dict(port.state_dict())
        for coll in ("params", "batch_stats"):
            want, got = flatten_tree(case["variables"][coll]), flatten_tree(back[coll])
            assert set(got) == set(want), (name, coll)
            for path, value in want.items():
                np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))
    state = _port(_case("resnet18"), _case("resnet18")["variables"]).state_dict()
    assert tuple(state["pose_net.0.weight"].shape) == (256, 128, 4, 4)
    state = _port(_case("learnable_query"), _case("learnable_query")["variables"]).state_dict()
    assert tuple(state["joints_late_fusion.attn_fusion.2.probe"].shape) == (1, 21, 524)


def test_transposed_conv_padding_doubles_like_flax():
    """torch ConvTranspose2d(4, stride 2, padding 1) is flax's
    ConvTranspose(4, strides 2, padding ((2, 2), (2, 2)), transpose_kernel)
    on the same kernel: 2x upsampling, the same values (fp32, 1e-5)."""
    from flax import linen as nn

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    flax_up = nn.ConvTranspose(3, (4, 4), strides=(2, 2), padding=((2, 2), (2, 2)),
                               transpose_kernel=True)
    variables = random_flax_variables(flax_up, 9, jnp.asarray(x))
    ref = np.asarray(flax_up.apply(variables, jnp.asarray(x)))
    up = torch.nn.ConvTranspose2d(6, 3, 4, stride=2, padding=1)
    up.load_state_dict(load_flax_variables(variables))
    with torch.no_grad():
        ours = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_learnable_query_fusion_launches_no_attention_kernel(monkeypatch):
    """A CPU spy in place of fused_attention: the learnable-query model
    never calls it (its D is 256, K1's is 128), the cross_attn model 5
    times a forward."""
    real = attention_ops.fused_attention

    def spy(*args):
        spy.launches += 1
        return real(*args)

    spy.launches = 0
    monkeypatch.setattr(attention_ops, "fused_attention", spy)
    for name, want in (("learnable_query", 0), ("resnet18", 5)):
        case = _case(name)
        port = _port(case, case["variables"]).eval()
        spy.launches = 0
        with torch.no_grad():
            port(*(torch.from_numpy(case["data"][k]) for k in KEYS))
        assert spy.launches == want, name


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("version,early_return", [("18", 4), ("18", 0), ("34", 2), ("50", 1)])
def test_combination_jax_cannot_run_is_refused(version, early_return):
    """A default ResNet whose deepest map does not upsample to the heatmap
    size: the port refuses it at construction, naming it; the JAX forward
    fails on the same combination (its heatmap reshape)."""
    mcfg, jmcfg = _configs(backbone_type=version, backbone_early_return=early_return)
    with pytest.raises(ValueError, match=f"resnet {version} at backbone_early_return "
                                         f"{early_return}"):
        HandMvNet(mcfg, image_size=IMAGE, heatmap_size=HEATMAP)
    data = synthetic_batch(1, VIEWS, IMAGE, seed=0)
    flax_model = FlaxHandMvNet(cfg=jmcfg, image_size=IMAGE, heatmap_size=HEATMAP)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                       *(jnp.asarray(data[k]) for k in KEYS))


def test_every_layout_and_fusion_builds_with_its_token_width():
    """Every backbone_type of the JAX _LAYOUTS at early_return 3 and both
    fusions, with and without the root branch: the token width the JAX
    config computes from the backbone's own maps."""
    widths = {"18": 236, "34": 236, "50": 908, "50_paper": 524, "101": 908, "152": 908}
    for version, width in widths.items():
        for fusion in ("cross_attn", "cross_attn_learnable_query"):
            for root_relative in (True, False):
                mcfg, _ = _configs(backbone_type=version, fusion=fusion)
                with torch.device("meta"):
                    model = HandMvNet(mcfg, root_relative=root_relative)
                block = model.joints_late_fusion.attn_fusion[0]
                assert block.to_q.in_features == width, (version, fusion)
                assert hasattr(model, "root_decoder") == (not root_relative)
                if not root_relative:
                    assert model.root_late_fusion.attn_fusion[0].to_q.in_features == width + 2


# ---------------------------------------------------------------- the graft


def torchvision_resnet18(seed: int) -> dict[str, torch.Tensor]:
    """A state_dict in torchvision's ResNet-18 layout, keys and shapes
    written out here (BasicBlocks, downsample.0/1 at the stage entries, an
    fc head), values from a numpy seed."""
    shapes = {"conv1.weight": (64, 3, 7, 7)}

    def bn(prefix, c):
        shapes.update({f"{prefix}.{n}": (c,) for n in ("weight", "bias", "running_mean",
                                                         "running_var")})

    bn("bn1", 64)
    inplanes = 64
    for stage, planes in enumerate((64, 128, 256, 512), start=1):
        for block in range(2):
            p = f"layer{stage}.{block}"
            shapes[f"{p}.conv1.weight"] = (planes, inplanes, 3, 3)
            bn(f"{p}.bn1", planes)
            shapes[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
            bn(f"{p}.bn2", planes)
            if block == 0 and stage > 1:
                shapes[f"{p}.downsample.0.weight"] = (planes, inplanes, 1, 1)
                bn(f"{p}.downsample.1", planes)
            inplanes = planes
    shapes.update({"fc.weight": (1000, 512), "fc.bias": (1000,)})
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy((rng.uniform(0.5, 1.5, s) if k.endswith("running_var")
                               else rng.standard_normal(s) * 0.05).astype(np.float32))
          for k, s in shapes.items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in shapes if k.endswith("running_mean")})
    return sd


@pytest.mark.parametrize("early_return", [3, 0])
def test_resnet18_graft_keeps_layer4_and_matches_jax(tmp_path, early_return):
    """backbone_pretrained on a ResNet-18 model: the graft is strict, keeps
    layer4 (taken at early_return 0, unused at 3), drops fc, and gives the
    tree handmvnet_tpu.pretrained.graft_backbone gives."""
    sd = torchvision_resnet18(seed=4)
    torch.save(sd, tmp_path / "resnet18.pth")
    mcfg, _ = _configs(backbone_type="18", backbone_early_return=early_return,
                       backbone_pretrained=True, backbone_pretrained_path=str(tmp_path))
    cfg = dataclasses.replace(Config.from_yaml(CONFIG), model=mcfg)
    if early_return == 3:
        model = HandMvNet(mcfg, image_size=IMAGE, heatmap_size=HEATMAP)
    else:  # no head fits the deepest map at early_return 0: the backbone alone
        model = torch.nn.Module()
        model.backbone = ResNetBackbone("18", early_return=0)
    variables = convert_torch_state_dict(model.state_dict())
    load_pretrained_backbone(model, cfg)
    own = {k: v for k, v in model.backbone.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    for key, value in own.items():
        assert torch.equal(value, sd[key]), key
    assert any(k.startswith("layer4") for k in own) == (early_return == 0)
    ref = load_flax_variables(jax_pretrained.graft_backbone(
        variables, {k: v.numpy() for k, v in sd.items()}, "resnet", "default"))
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(value, ref[key]), key
