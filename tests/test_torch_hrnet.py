"""Port parity, the HRNet slice: handmvnet_tpu_torch's BasicBlock, HRNet
backbone and the HR HandMvNet against the JAX package on the same weights
and inputs, on the CPU.

Sizes: the HO3D HR release model (HRNet w40, 4 SampleNets, 312-wide
tokens) with its views cut to 3, batch 2 and 64^2 images, so the four maps
are 16^2 .. 2^2 and the heatmaps 8^2. The backbone alone runs at w40 and
w64 on 3 images of 64^2.

Tolerances, each with the largest error measured on this CPU:
  * BasicBlock, fp32: 1e-5 of max (measured 1.3e-7);
  * the backbone's four maps, fp32, relative to each map's max: 1e-4
    against JAX's plain fuse (measured 1.7e-6) and against its packed fuse,
    which folds each BatchNorm into its conv and so rounds otherwise
    (measured 1.5e-6; the JAX package holds its two fuses to the same 1e-4,
    tests/test_golden_shapes.py);
  * the HR HandMvNet eval forward, fp32, against JAX's forward (packed
    fuse): tests/test_torch_model.py's atol, heatmap 1e-4 (measured 1.4e-8
    on logits up to 9.3e-3), joints_crop_img 2e-2 px (measured 3.4e-5),
    joints_cam 5e-4 (measured 2.7e-7);
  * train mode in float64, dropout 0, through JAX's ``_forward_loss`` and
    ``jax.grad``: the outputs 1e-9 of their max (measured 1.2e-13), the
    2 x 309 BatchNorm running statistics 1e-9 of each one's max (measured
    8.0e-14), each loss term rel 1e-9 (measured 4.3e-15), every gradient
    leaf 1e-7 of its max |g| (measured 1.1e-10 on pose_net.bias, whose
    exact gradient is a small remainder of terms that cancel, since the
    soft-argmax is shift-invariant; 5.9e-13 on every other leaf). 21 leaves
    of stage4's last fuse into the 2^2 map have a gradient of exactly 0 on
    both sides: at this size every joint samples that map outside its
    edge (the cross-scale quirk). The four SampleNet conv biases before a
    train-mode BatchNorm, whose exact gradient is 0, stay below 1e-9 of
    the largest gradient on both sides (measured 1.5e-20).
The random weights' heatmap head is scaled (``HEAD_SCALE``, and 100x that
in train mode, where the BatchNorms shrink its input) so that the
soft-argmax at x1000 is not saturated, and the last GCN layer by 1e-2 so
that the joints lie in front of the cameras, as tests/test_torch_train.py
does: else the coordinates carry no gradient and the loss sits at the
projection's pole.
"""

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
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.models.backbones.hrnet import HRNetBackbone as FlaxHRNetBackbone
from handmvnet_tpu.models.backbones.hrnet import _nearest_upsample
from handmvnet_tpu.models.backbones.resnet import BasicBlock as FlaxBasicBlock
from handmvnet_tpu.parallel.train_step import _forward_loss as jax_forward_loss
from handmvnet_tpu_torch import train as train_driver
from handmvnet_tpu_torch.checkpoint import _torch_path, load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.eval_fps import run_protocol
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.models.backbones.hrnet import HRModule, HRNetBackbone
from handmvnet_tpu_torch.models.backbones.resnet import BasicBlock
from handmvnet_tpu_torch.ops.attention import fused_attention
from handmvnet_tpu_torch.ops.stem import stem_conv_nchw
from handmvnet_tpu_torch.train_step import batch_to_device, forward_loss
from torch_parity import random_flax_variables, rel_max_err, write_train_shards

ROOT = Path(__file__).resolve().parents[1]
RELEASE = ROOT / "configs" / "release"
CONFIG = RELEASE / "HO3D_HandMvNet_HR.yaml"
VIEWS, BATCH, IMAGE, HEATMAP = 3, 2, 64, 8
HEAD_SCALE = 1e-6
NCHW, NHWC = (0, 3, 1, 2), (0, 2, 3, 1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: the test workers run side
    by side, and hundreds of small ops each spread over every core stall one
    another when the cores are oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut(cfg):
    """The release config at the test size."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=tuple(range(VIEWS))),
        data=dataclasses.replace(cfg.data, image_size=IMAGE, heatmap_size=HEATMAP,
                                 batch_size=BATCH))


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(*NHWC).numpy()


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("inplanes,stride", [(16, 1), (8, 2)], ids=["identity", "downsample"])
def test_basic_block_matches_flax(inplanes, stride):
    x = np.random.default_rng(inplanes).normal(size=(2, 8, 8, inplanes)).astype(np.float32)
    flax_block = FlaxBasicBlock(planes=16, stride=stride, has_downsample=stride != 1)
    variables = random_flax_variables(flax_block, inplanes, jnp.asarray(x))
    ref = np.asarray(flax_block.apply(variables, jnp.asarray(x)))
    port = BasicBlock(inplanes, 16, stride).eval()
    port.load_state_dict(load_flax_variables(variables))
    assert (port.downsample is None) == (stride == 1)
    with torch.no_grad():
        ours = _to_nhwc(port(torch.from_numpy(x).permute(*NCHW)))
    assert ours.shape == ref.shape
    assert rel_max_err(ours, ref) < 1e-5


@pytest.mark.parametrize("j", [1, 2, 3])
def test_fuse_upsample_matches_flax(j):
    """The fuse's nearest upsample by 2^j (j > i = 0) repeats each pixel
    exactly as the JAX package's broadcast form does."""
    upsample = HRModule((4, 8, 16, 32)).fuse_layers[0][j][2]
    x = np.random.default_rng(j).normal(size=(2, 3, 5, 4)).astype(np.float32)
    ours = _to_nhwc(upsample(torch.from_numpy(x).permute(*NCHW)))
    np.testing.assert_array_equal(ours, np.asarray(_nearest_upsample(jnp.asarray(x), 2 ** j)))


# ---------------------------------------------------------------- backbone


@pytest.fixture(scope="module", params=["w40", "w64"])
def backbone_case(request):
    width = request.param
    x = np.random.default_rng(5).normal(size=(3, IMAGE, IMAGE, 3)).astype(np.float32)
    variables = random_flax_variables(FlaxHRNetBackbone(width=width, packed=False), 11,
                                      jnp.asarray(x))
    # eager: on this CPU faster than compiling each fuse's graph once
    refs = {fuse: [np.asarray(a) for a in FlaxHRNetBackbone(width=width, packed=packed).apply(
        variables, jnp.asarray(x))] for fuse, packed in (("plain", False), ("packed", True))}
    port = HRNetBackbone(width).eval()
    port.load_state_dict(load_flax_variables(variables), strict=True)
    with torch.no_grad():
        ours = [_to_nhwc(o) for o in port(torch.from_numpy(x).permute(*NCHW))]
    return {"width": width, "refs": refs, "ours": ours, "port": port}


@pytest.mark.parametrize("fuse", ["plain", "packed"])
def test_backbone_matches_flax(backbone_case, fuse):
    widths = {"w40": (40, 80, 160, 320), "w64": (64, 128, 256, 512)}[backbone_case["width"]]
    ours, refs = backbone_case["ours"], backbone_case["refs"][fuse]
    assert len(ours) == len(refs) == 4
    for i, (o, r) in enumerate(zip(ours, refs)):
        side = IMAGE // 2 ** (i + 2)
        assert o.shape == r.shape == (3, side, side, widths[i])
        assert rel_max_err(o, r) < 1e-4, (i, rel_max_err(o, r))


def test_backbone_has_the_reference_modules(backbone_case):
    port = backbone_case["port"]
    bns = [m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 305
    keys = set(port.state_dict())
    assert {"stage2.0.branches.0.0.conv1.weight", "stage3.1.fuse_layers.2.0.1.0.weight",
            "transition1.1.0.0.weight", "transition3.3.0.1.running_var",
            "stage4.2.fuse_layers.0.3.1.weight"} <= keys
    assert not any(k.startswith(("transition2.0", "transition2.1")) for k in keys)


# ---------------------------------------------------------------- the HR model, eval


def _hr_variables(flax_model, args):
    variables = random_flax_variables(flax_model, 17, *args)
    params = variables["params"]
    for name in ("kernel", "bias"):
        params["pose_net"][name] = params["pose_net"][name] * HEAD_SCALE
    for name in ("weight", "bias"):
        params["joints_decoder"]["joints_gcn3"][name] = (
            params["joints_decoder"]["joints_gcn3"][name] * 1e-2)
    return variables


@pytest.fixture(scope="module")
def hr_case():
    cfg, jcfg = _cut(Config.from_yaml(CONFIG)), _cut(JaxConfig.from_yaml(CONFIG))
    data = synthetic_batch(BATCH, VIEWS, IMAGE, HEATMAP, seed=3)
    args = [jnp.asarray(data[k]) for k in ("rgb", "bboxes", "intrinsic")]
    flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP)
    variables = _hr_variables(flax_model, args)
    ref = {k: np.asarray(v) for k, v in jax.jit(flax_model.apply)(variables, *args).items()}
    port = HandMvNet(cfg.model, image_size=IMAGE, heatmap_size=HEATMAP).eval()
    state = load_flax_variables(variables)
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        ours = port(*(torch.from_numpy(data[k]) for k in ("rgb", "bboxes", "intrinsic")))
    return {"cfg": cfg, "jax_cfg": jcfg, "data": data, "variables": variables, "state": state,
            "port": port, "ref": ref, "ours": {k: v.numpy() for k, v in ours.items()}}


# fp32 atol of each output: tests/test_torch_model.py's
EVAL_TOLERANCES = {"heatmap": 1e-4, "joints_crop_img": 2e-2, "joints_cam": 5e-4}


@pytest.mark.parametrize("key", sorted(EVAL_TOLERANCES))
def test_forward_matches_flax(hr_case, key):
    ref, ours = hr_case["ref"][key], hr_case["ours"][key]
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=EVAL_TOLERANCES[key], rtol=0)


def test_output_shapes(hr_case):
    ours = hr_case["ours"]
    assert ours["joints_cam"].shape == (BATCH, 21, 3)
    assert ours["joints_crop_img"].shape == (BATCH, VIEWS, 21, 2)
    assert ours["heatmap"].shape == (BATCH, VIEWS, 21, HEATMAP, HEATMAP)
    port = hr_case["port"]
    assert [n.conv[0].out_channels for n in port.sample_nets] == [20, 40, 80, 160]
    assert port.joints_late_fusion.attn_fusion[0].to_q.in_features == 312


def test_bridge_consumes_every_leaf_once(hr_case):
    variables, state = hr_case["variables"], hr_case["state"]
    leaves = flatten_tree(variables["params"]) | {
        ("stats",) + k: v for k, v in flatten_tree(variables["batch_stats"]).items()}
    counters = {k for k in state if k.endswith("num_batches_tracked")}
    assert len(counters) == 309
    assert len(state) - len(counters) == len(leaves)
    assert set(state) == set(hr_case["port"].state_dict())


def test_bridge_round_trips_through_jax_converter(hr_case):
    back = convert_torch_state_dict(hr_case["port"].state_dict())
    for coll in ("params", "batch_stats"):
        want = flatten_tree(hr_case["variables"][coll])
        got = flatten_tree(back[coll])
        assert set(got) == set(want), coll
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


@pytest.mark.parametrize("flax_name,torch_name", [
    ("branches_0_0", "branches.0.0"),
    ("fuse_layers_2_0_1_0", "fuse_layers.2.0.1.0"),
    ("transition1_1_0_0", "transition1.1.0.0"),
    ("layer1_0", "layer1.0"),
    ("joints_gcn1", "joints_gcn1"),
])
def test_torch_path_splits_every_trailing_index(flax_name, torch_name):
    assert _torch_path(("stage3_1", flax_name)) == f"stage3.1.{torch_name}"


def test_cpu_forward_launches_no_kernel(hr_case):
    before = (fused_attention.launches, stem_conv_nchw.launches)
    with torch.no_grad():
        hr_case["port"](torch.zeros(1, VIEWS, IMAGE, IMAGE, 3), torch.ones(1, VIEWS, 4),
                        torch.ones(1, VIEWS, 4))
    assert (fused_attention.launches, stem_conv_nchw.launches) == before


# ---------------------------------------------------------------- train mode, float64


# conv biases followed by a train-mode BatchNorm: their exact gradient is 0
ZERO_GRAD_LEAVES = tuple(f"sample_nets.{i}.conv.0.bias" for i in range(4))


# batch 1 x 2 views: the float64 backward is the slowest reference here
TRAIN_VIEWS, TRAIN_BATCH = 2, 1


@pytest.fixture(scope="module")
def train_case(hr_case):
    """One train-mode forward and backward of each package in float64 from
    the eval case's weights, on a batch of its own, dropout 0: the JAX side
    is jax.grad of ``_forward_loss`` (the step's own loss), which also
    returns the outputs, the losses and the updated running statistics."""
    cfg, jcfg = (dataclasses.replace(
        c, model=dataclasses.replace(c.model, selected_views=tuple(range(TRAIN_VIEWS))),
        data=dataclasses.replace(c.data, batch_size=TRAIN_BATCH))
        for c in (hr_case["cfg"], hr_case["jax_cfg"]))
    data = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in
            synthetic_batch(TRAIN_BATCH, TRAIN_VIEWS, IMAGE, HEATMAP, seed=4).items()}
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64), hr_case["variables"])
    for name in ("kernel", "bias"):  # train-mode BNs shrink the head's input
        variables["params"]["pose_net"][name] = variables["params"]["pose_net"][name] * 100.0
    with jax.enable_x64(True):
        flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP,
                                   dropout=0.0)
        jbatch = {k: jnp.asarray(v) for k, v in data.items()}
        grad_fn = jax.jit(jax.grad(partial(jax_forward_loss, flax_model, jcfg), has_aux=True))
        grads, (stats, losses, out) = grad_fn(variables["params"], variables["batch_stats"],
                                              jbatch, jax.random.PRNGKey(0))
        ref = {"grads": load_flax_variables({"params": jax.tree.map(np.asarray, grads)}),
               "stats": load_flax_variables({"batch_stats": jax.tree.map(np.asarray, stats)}),
               "losses": {k: float(v) for k, v in losses.items()},
               "out": {k: np.asarray(v) for k, v in out.items()}}

    model = HandMvNet(cfg.model, IMAGE, HEATMAP, dropout=0.0).double().train()
    model.load_state_dict(load_flax_variables(variables))
    losses, out = forward_loss(model, cfg, batch_to_device(data, "cpu"))
    losses["loss"].backward()
    ours = {"grads": {n: p.grad for n, p in model.named_parameters()},
            "stats": model.state_dict(),
            "losses": {k: float(v.detach()) for k, v in losses.items()},
            "out": {k: v.detach().numpy() for k, v in out.items()}}
    return {"ref": ref, "ours": ours}


@pytest.mark.parametrize("key", ["heatmap", "joints_crop_img", "joints_cam"])
def test_train_forward_matches_flax(train_case, key):
    ref, ours = train_case["ref"]["out"][key], train_case["ours"]["out"][key]
    assert ours.dtype == np.float64 and ours.shape == ref.shape
    assert rel_max_err(ours, ref) < 1e-9, rel_max_err(ours, ref)


def test_train_batch_statistics_match_flax(train_case):
    ref, ours = train_case["ref"]["stats"], train_case["ours"]["stats"]
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 309
    for key in keys:
        assert rel_max_err(ours[key].numpy(), ref[key].numpy()) < 1e-9, key


def test_train_loss_terms_match_jax(train_case):
    ref, ours = train_case["ref"]["losses"], train_case["ours"]["losses"]
    assert set(ours) == set(ref) == {"heatmap_loss", "joints_2d_loss", "joints_3d_loss",
                                     "g2d_loss", "p2d_loss", "loss"}
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], rel=1e-9), key


def test_train_gradients_match_jax(train_case):
    ref, ours = train_case["ref"]["grads"], train_case["ours"]["grads"]
    assert set(ours) == set(ref)
    global_max = max(float(g.abs().max()) for g in ref.values())
    for name, r in ref.items():
        g = ours[name]
        assert g.dtype == torch.float64 and g.shape == r.shape
        if name in ZERO_GRAD_LEAVES:
            assert float(g.abs().max()) < 1e-9 * global_max, name
            assert float(r.abs().max()) < 1e-9 * global_max, name
        else:
            err = float((g - r).abs().max())
            assert err <= 1e-7 * float(r.abs().max()), (name, err)


# ---------------------------------------------------------------- configs, entry points


@pytest.mark.parametrize("path", sorted(RELEASE.glob("*.yaml")), ids=lambda p: p.name)
def test_every_release_config_builds(path):
    cfg = Config.from_yaml(path)
    model = HandMvNet(cfg.model)
    tokens = model.joints_late_fusion.attn_fusion[0].to_q.in_features
    bns = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    if cfg.model.backbone == "hrnet":
        assert (cfg.model.backbone_type, len(model.sample_nets), bns) == ("w40", 4, 309)
        assert "pose_net.weight" in model.state_dict()
    else:
        assert (cfg.model.backbone_type, len(model.sample_nets), bns) == ("50_paper", 1, 45)
    assert tokens == cfg.model.feat_dim == JaxConfig.from_yaml(path).model.feat_dim


@pytest.mark.parametrize("field,value", [
    ("backbone_type", "w32"), ("backbone", "hourglass"), ("backbone_type", "18"),
    ("fusion", "cross_attn_learnable_query")])
def test_other_models_are_refused(field, value):
    mcfg = dataclasses.replace(Config.from_yaml(CONFIG).model, **{field: value})
    with pytest.raises(ValueError, match=value):
        HandMvNet(mcfg)


def test_eval_fps_protocol_runs_hr_config_on_cpu():
    stats, out = run_protocol(Config.from_yaml(CONFIG), views=2, image_size=IMAGE,
                              warmup=1, iters=1, device="cpu")
    assert stats["forwards"] == 3 and stats["with_vertices"]
    assert out["heatmap"].shape == (1, 2, 21, HEATMAP, HEATMAP)
    assert out["vertices"].shape == (1, 778, 3)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_train_driver_runs_hr_config(tmp_path, capsys):
    """train.py on the HR release config (cut to 64^2, 2 views, batch 2) on
    test-size shards: one epoch of two steps, warning that the ImageNet graft
    has no path."""
    raw = yaml.safe_load(CONFIG.read_text())
    raw["data"].update(image_size=IMAGE, heatmap_size=HEATMAP, batch_size=BATCH,
                       **write_train_shards(tmp_path / "shards"))
    raw["model"]["selected_views"] = [0, 1]
    config = tmp_path / "hr.yaml"
    config.write_text(yaml.safe_dump(raw, sort_keys=False))
    train_driver.main(["--config", str(config), "--epochs", "1", "--steps-per-epoch", "2",
                       "--output-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert "no backbone_pretrained_path" in capsys.readouterr().out
    (record,) = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert '"epoch": 0' in record
    ckpt = torch.load(tmp_path / "run" / "checkpoints" / "last.pt", weights_only=True)
    assert ckpt["step"] == 2 and "model" in ckpt
    assert "backbone.stage4.0.fuse_layers.3.2.0.0.weight" in ckpt["model"]
