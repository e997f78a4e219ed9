"""Port parity, the training slice: handmvnet_tpu_torch's losses, camera
projection, heatmap labels, synthetic batch, LR schedule, the K1 and K2
backwards, BatchNorm batch statistics, dropout, one optimizer step, the
checkpoints and the train driver, against the JAX package on the same numpy
inputs, on the CPU.

Sizes are test_torch_model.py's: the HO3D release model at full width with
its views cut to 3, 64^2 images (8^2 heatmaps), batch 4.

Tolerances, each with the largest error measured on this CPU:
  * loss primitives and handmvnet_loss, fp32: rel 1e-6 (measured 7.3e-7);
  * reproject_to_views and joints_img_to_crop: 1e-5 px, in float64
    (measured 6.8e-13 px on coordinates up to 2504 px; in fp32 the two
    packages differ by 3.7e-4 px there, a few ulps);
  * heatmap rendering and the antialias resize: 1e-6 (measured 9.3e-10
    and 1.2e-7; the synthetic batch's heatmaps 1.5e-8);
  * K1 backward against ``_pallas_attention_bwd``, fp32: 1e-5 (measured
    1.4e-6 at the three training shapes, on gradients up to 2.6); the
    Function against autograd through ``attention_plain``: fp32 1e-5
    (measured 7.2e-7), bf16 2^-6 x max (measured 4.9e-4 of max 1.3);
  * K2 weight and input grads against jax.vjp of the plain conv: rel 1e-5
    of max (measured 1.1e-6);
  * one optimizer step against ``make_train_step``, in float64 on both
    sides: each loss term rel 1e-9 (measured 4.9e-14); every gradient leaf
    1e-7 of its max |g| (measured 1.7e-9 on pose_net.3.bias, whose exact
    gradient is a small remainder of large terms that cancel, since the
    soft-argmax is shift-invariant; 1.6e-12 on every other leaf); the two
    conv biases before a train-mode BatchNorm, whose exact gradient is 0,
    below 1e-9 of the largest gradient on both sides (measured 1.1e-18);
    BatchNorm running statistics 1e-9 (measured 4.0e-14); parameters within
    2 lr everywhere and 1e-2 lr where |g| > 1e-3 max|g| of the leaf
    (measured 2.0e-8 lr and 2.9e-10 lr). float64 because in fp32 both
    frameworks' own rounding is amplified through the 45 train-mode
    BatchNorms and the x1000 soft-argmax: the port's fp32 gradients differ
    from its own float64 ones by up to 3.5e-2 of a leaf's max, as
    tests/test_grad_parity_oracle.py found for the JAX package against the
    reference. The fp32 train-mode forward is held in
    tests/test_torch_model.py.
"""

import copy
import dataclasses
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from handmvnet_tpu import losses as jax_losses
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.config import LossWeights as JaxLossWeights
from handmvnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.models.layers import batch_norm as flax_batch_norm
from handmvnet_tpu.ops import camera as jax_camera
from handmvnet_tpu.ops.geometry import joints_img_to_crop as jax_joints_img_to_crop
from handmvnet_tpu.ops.heatmap import render_gaussian_heatmaps as jax_render_heatmaps
from handmvnet_tpu.ops.pallas.attention import _pallas_attention_bwd
from handmvnet_tpu.ops.pallas.stem import stem_s2d_reference
from handmvnet_tpu.ops.resize import _resize_weights_np
from handmvnet_tpu.ops.resize import resize_bilinear_antialias as jax_resize
from handmvnet_tpu.parallel import make_lr_schedule as jax_make_lr_schedule
from handmvnet_tpu.parallel import make_mesh, make_train_step
from handmvnet_tpu.parallel import make_optimizer as jax_make_optimizer
from handmvnet_tpu.parallel.train_step import TrainState as JaxTrainState
from handmvnet_tpu.parallel.train_step import _forward_loss as jax_forward_loss
from handmvnet_tpu_torch import losses
from handmvnet_tpu_torch import train as train_driver
from handmvnet_tpu_torch import train_bench
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config, LossWeights
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.engine import CheckpointManager, DeviceMetricAverager
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.models.backbones.resnet import ResNetBackbone
from handmvnet_tpu_torch.models.layers import Dropout, batch_norm
from handmvnet_tpu_torch.ops import camera
from handmvnet_tpu_torch.ops.attention import attention_backward, attention_plain, fused_attention
from handmvnet_tpu_torch.ops.geometry import joints_img_to_crop
from handmvnet_tpu_torch.ops.heatmap import render_gaussian_heatmaps
from handmvnet_tpu_torch.ops.resize import resize_bilinear_antialias, resize_weights
from handmvnet_tpu_torch.ops.stem import stem_conv
from handmvnet_tpu_torch.train_step import (
    _bf16_compute_params,
    accumulate_grads,
    batch_to_device,
    build_model,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    optimizer_step,
    train_step,
)
from torch_parity import random_flax_variables, rel_max_err, write_train_shards

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
VIEWS, BATCH, IMAGE, HEATMAP = 3, 4, 64, 8


def _cut(cfg):
    """The release config at the test size."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=tuple(range(VIEWS))),
        data=dataclasses.replace(cfg.data, image_size=IMAGE, heatmap_size=HEATMAP,
                                 batch_size=BATCH))


# ---------------------------------------------------------------- losses


def _loss_inputs(name, stacked, seed):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    shape = (2, 4, 5) if stacked is not None else (2, 3, 4, 5)
    if name == "bce_loss":
        labels = rng.uniform(size=shape).astype(np.float32)
    else:
        labels = rng.normal(size=shape).astype(np.float32)
    return preds, labels


@pytest.mark.parametrize("stacked", [None, 1])
@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "smooth_l1_loss", "bce_loss"])
def test_loss_primitive_matches_jax(name, stacked):
    preds, labels = _loss_inputs(name, stacked, seed=len(name))
    ref = float(getattr(jax_losses, name)(jnp.asarray(preds), jnp.asarray(labels), 0.7,
                                          stacked_dim=stacked))
    ours = float(getattr(losses, name)(torch.from_numpy(preds), torch.from_numpy(labels), 0.7,
                                       stacked_dim=stacked))
    assert ours == pytest.approx(ref, rel=1e-6)


def _model_outputs(batch, seed):
    """Predictions near the labels of a synthetic batch (3D in metres)."""
    rng = np.random.default_rng(seed)
    b, v, j = batch["joints_crop_img"].shape[:3]
    return {
        "joints_cam": (batch["joints_cam"] / 1000.0
                       + rng.normal(size=(b, j, 3)) * 0.01).astype(np.float32),
        "joints_crop_img": (batch["joints_crop_img"]
                            + rng.normal(size=(b, v, j, 2)) * 3.0).astype(np.float32),
        "heatmap": (batch["heatmap"] + rng.normal(size=batch["heatmap"].shape) * 0.05
                    ).astype(np.float32),
    }


@pytest.mark.parametrize("reproject", [True, False], ids=["g2d_p2d", "no_g2d"])
@pytest.mark.parametrize("mask", [True, False], ids=["masked", "unmasked"])
def test_handmvnet_loss_matches_jax(mask, reproject):
    batch = synthetic_batch(2, VIEWS, IMAGE, HEATMAP, seed=4)
    out = _model_outputs(batch, seed=5)
    labels = dict(batch, joints_cam=batch["joints_cam"] / 1000.0,
                  root_joint=batch["root_joint"] / 1000.0)
    kw = {"g2d": None, "p2d": None} if not reproject else {}
    common = {"mask_invisible_joints": mask, "root_idx": 0, "image_size": float(IMAGE)}

    def run(fn, weights, to, **extra):
        res = fn({k: to(v) for k, v in out.items()}, {k: to(v) for k, v in labels.items()},
                 weights, intrinsics=to(batch["intrinsic"]), extrinsics=to(batch["extrinsic"]),
                 **common, **extra)
        return {k: float(v) for k, v in res.items()}

    ref = run(jax_losses.handmvnet_loss, JaxLossWeights(**kw), jnp.asarray, root_relative=True)
    ours = run(losses.handmvnet_loss, LossWeights(**kw), torch.from_numpy)
    assert set(ours) == set(ref)
    assert ("g2d_loss" in ours) == reproject
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], rel=1e-6), key


def test_handmvnet_loss_fails_loudly_without_cameras():
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(1, 2, 32, 4, seed=0).items()}
    out = {k: torch.from_numpy(v) for k, v in _model_outputs(
        {k: v.numpy() for k, v in batch.items()}, seed=1).items()}
    with pytest.raises(ValueError, match="intrinsics and extrinsics"):
        losses.handmvnet_loss(out, batch, LossWeights())
    with pytest.raises(ValueError, match="p2d is missing"):
        losses.handmvnet_loss(out, batch, LossWeights(p2d=None),
                              intrinsics=batch["intrinsic"], extrinsics=batch["extrinsic"])


# ---------------------------------------------------------------- camera, geometry


def test_reprojection_matches_jax():
    batch = synthetic_batch(2, VIEWS, IMAGE, HEATMAP, seed=6, with_heatmaps=False)
    joints = (batch["joints_cam"] + batch["root_joint"]) / 1000.0
    with jax.enable_x64(True):
        ref = jax_camera.reproject_to_views(
            *(jnp.asarray(a, jnp.float64) for a in (joints,)), 0,
            jnp.asarray(batch["intrinsic"], jnp.float64),
            jnp.asarray(batch["extrinsic"], jnp.float64))
        boxes = jnp.asarray(batch["bboxes"], jnp.float64).reshape(-1, 4)
        ref_crop = np.asarray(jax_joints_img_to_crop(ref.reshape(-1, 21, 2), boxes, 64.0))
        ref = np.asarray(ref)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    ours = camera.reproject_to_views(to(joints), 0, to(batch["intrinsic"]),
                                     to(batch["extrinsic"]))
    ours_crop = joints_img_to_crop(ours.reshape(-1, 21, 2), to(batch["bboxes"]).reshape(-1, 4),
                                   64.0)
    assert ours.shape == (2, VIEWS, 21, 2)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours_crop.numpy(), ref_crop, atol=1e-5, rtol=0)


def test_camera_primitives_match_jax():
    batch = synthetic_batch(2, VIEWS, 32, 4, seed=7, with_heatmaps=False)
    intr, extr = batch["intrinsic"], batch["extrinsic"]
    pts = (np.random.default_rng(0).normal(size=(2, VIEWS, 21, 3)) * 0.1
           + [0, 0, 0.5]).astype(np.float32)
    pairs = [
        (camera.intrinsics_vec_to_matrix(torch.from_numpy(intr)),
         jax_camera.intrinsics_vec_to_matrix(jnp.asarray(intr))),
        (camera.project_points(torch.from_numpy(pts), torch.from_numpy(intr)),
         jax_camera.project_points(jnp.asarray(pts), jnp.asarray(intr))),
        (camera.rigid_inverse(torch.from_numpy(extr)), jax_camera.rigid_inverse(jnp.asarray(extr))),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    eye = torch.from_numpy(extr) @ camera.rigid_inverse(torch.from_numpy(extr))
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(4), eye.shape), atol=1e-6)


# ---------------------------------------------------------------- heatmap labels


def test_render_gaussian_heatmaps_matches_jax():
    rng = np.random.default_rng(8)
    pts = rng.uniform(-12, 76, size=(3, 21, 2)).astype(np.float32)  # some off the map
    pts[0, 0] = (-6.5, 3.0)   # truncated to -6: the window's edge is column 0
    pts[0, 1] = (-7.5, 3.0)   # truncated to -7: the window ends at column -1
    ours = render_gaussian_heatmaps(torch.from_numpy(pts), 64, 48)
    ref = np.asarray(jax_render_heatmaps(jnp.asarray(pts), 64, 48))
    assert ours.shape == (3, 21, 64, 48) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)
    assert ours[0, 0].max() > 0 and ours[0, 1].max() == 0


@pytest.mark.parametrize("sizes", [(256, 32), (64, 8), (32, 64), (7, 3)])
def test_resize_weights_equal_jax(sizes):
    np.testing.assert_array_equal(resize_weights(*sizes), _resize_weights_np(*sizes))


@pytest.mark.parametrize("out_hw", [(16, 24), (64, 70)], ids=["down", "up"])
def test_resize_matches_jax(out_hw):
    rng = np.random.default_rng(9)
    img = rng.uniform(size=(2, 5, 40, 56)).astype(np.float32)
    ours = resize_bilinear_antialias(torch.from_numpy(img), out_hw)
    ref = np.asarray(jax_resize(jnp.asarray(img), out_hw))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


def test_synthetic_batch_matches_jax_training_batch():
    ours = synthetic_batch(2, VIEWS, IMAGE, HEATMAP, seed=5)
    ref = jax_synthetic_batch(batch_size=2, num_views=VIEWS, image_size=IMAGE,
                              heatmap_size=HEATMAP, seed=5)
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        if key == "heatmap":
            np.testing.assert_allclose(ours[key], ref[key], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


# ---------------------------------------------------------------- optimizer, schedule


def test_lr_schedule_matches_jax_at_every_step():
    cfg, jcfg = Config.from_yaml(CONFIG), JaxConfig.from_yaml(CONFIG)
    steps_per_epoch = 7
    ref = jax_make_lr_schedule(jcfg, steps_per_epoch)
    opt = make_optimizer(cfg, torch.nn.Linear(2, 2))
    sched = make_lr_schedule(cfg, opt, steps_per_epoch)
    last = (max(cfg.train.lr_scheduler.milestones) + 1) * steps_per_epoch
    for step in range(last + 1):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(ref(step)), rel=1e-6), step
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(cfg.train.lr * 0.5 ** 4, rel=1e-6)


def test_optimizer_is_the_reference_adamw():
    cfg = Config.from_yaml(CONFIG)
    model = torch.nn.Linear(3, 2)
    (group,) = make_optimizer(cfg, model).param_groups
    assert len(group["params"]) == 2  # every parameter, biases included, takes weight decay
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-4, (0.9, 0.999), 1e-8, 0.05)


# ---------------------------------------------------------------- K1 and K2 backwards

# (Nq, Nk) of one training microbatch's fusion blocks: 8 samples x 5 views
K1_TRAIN_SHAPES = [(105, 105), (21, 84), (21, 21)]


@pytest.mark.parametrize("nq,nk", K1_TRAIN_SHAPES)
def test_attention_backward_matches_pallas_vjp(nq, nk):
    rng = np.random.default_rng(nq * 1000 + nk)
    q, g = (rng.normal(size=(8, 8, nq, 128)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(8, 8, nk, 128)).astype(np.float32) for _ in range(2))
    scale = 128 ** -0.5
    ref = _pallas_attention_bwd(scale, tuple(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(g))
    ours = attention_backward(*(torch.from_numpy(a) for a in (q, k, v, g)), scale)
    for name, o, r in zip(("dq", "dk", "dv"), ours, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_function_grads_equal_autograd_through_plain(dtype):
    gen = torch.Generator().manual_seed(3)
    # the model's layout: [b, n, h, d] projections viewed as [b, h, n, d]
    base = [torch.randn(2, n, 8, 128, generator=gen).to(dtype) for n in (21, 84, 84)]
    g = torch.randn(2, 8, 21, 128, generator=gen).to(dtype)
    grads = []
    for fn in (fused_attention, attention_plain):
        qkv = [t.clone().requires_grad_(True) for t in base]
        out = fn(*(t.transpose(1, 2) for t in qkv), 128 ** -0.5)
        out.backward(g)
        grads.append([t.grad for t in qkv])
        if fn is fused_attention:
            assert type(out.grad_fn).__name__ == "FusedAttentionBackward"
    for ours, ref in zip(*grads):
        assert ours.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * float(ref.float().abs().max())
        assert float((ours.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 31, 33)])
def test_stem_grads_match_jax_vjp(shape):
    n, h, w = shape
    rng = np.random.default_rng(h)
    x = rng.normal(size=(n, h, w, 3)).astype(np.float32)
    kernel = (rng.normal(size=(7, 7, 3, 64)) * 0.05).astype(np.float32)
    g = rng.normal(size=(n, (h + 1) // 2, (w + 1) // 2, 64)).astype(np.float32)
    _, vjp = jax.vjp(stem_s2d_reference, jnp.asarray(x), jnp.asarray(kernel))
    ref_dx, ref_dk = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(kernel).requires_grad_(True)
    out = stem_conv(xt, kt)
    assert type(out.grad_fn).__name__ == "PermuteBackward0"
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "StemConvBackward"
    out.backward(torch.from_numpy(g))
    assert rel_max_err(kt.grad.numpy(), ref_dk) < 1e-5
    assert rel_max_err(xt.grad.numpy(), ref_dx) < 1e-5


def test_stem_input_grad_only_when_asked():
    x = torch.randn(1, 3, 16, 16)
    w = torch.randn(64, 3, 7, 7, requires_grad=True)
    stem_conv(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0)).sum().backward()
    assert x.grad is None and w.grad is not None and float(w.grad.abs().sum()) > 0


# ---------------------------------------------------------------- train-mode layers


def test_batch_norm_train_mode_is_jax_torch_batch_norm():
    """nn.BatchNorm2d in train mode: batch statistics, and running statistics
    updated with torch's unbiased variance, as TorchBatchNorm does."""
    rng = np.random.default_rng(10)
    x = (rng.normal(size=(6, 8, 8, 16)) * 2.0 + 0.5).astype(np.float32)  # NHWC
    mean0 = rng.normal(size=16).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, size=16).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.normal(size=16)).astype(np.float32), rng.normal(size=16).astype(np.float32)
    flax_bn = flax_batch_norm("bn")
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    ref, mutated = flax_bn.apply(variables, jnp.asarray(x), use_running_average=False,
                                 mutable=["batch_stats"])
    bn = batch_norm(16).train()
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0),
                        "num_batches_tracked": torch.tensor(0)})
    ours = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), mutated["batch_stats"]["mean"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), mutated["batch_stats"]["var"],
                               atol=1e-6, rtol=0)


def test_dropout_masks_follow_the_generator():
    drop = Dropout(0.1).train()
    x = torch.ones(200_000)
    a = drop(x, torch.Generator().manual_seed(5))
    b = drop(x, torch.Generator().manual_seed(5))
    c = drop(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    dropped = float((a == 0).double().mean())
    assert abs(dropped - 0.1) < 5e-3  # binomial std ~7e-4
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.9))
    assert torch.equal(drop.eval()(x), x)  # eval: the identity, no generator needed


def test_model_dropout_draws_fresh_masks_from_one_generator():
    """Two forwards from one generator differ (fresh masks per microbatch);
    reseeding repeats them; the rate 0 model ignores the generator."""
    cfg = _cut(Config.from_yaml(CONFIG))
    model = build_model(cfg, "cpu", seed=0).train()
    data = synthetic_batch(1, VIEWS, IMAGE, with_heatmaps=False, seed=1)
    inputs = [torch.from_numpy(data[k]) for k in ("rgb", "bboxes", "intrinsic")]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        state = {k: v.clone() for k, v in model.state_dict().items()}
        first, second = (model(*inputs, generator=gen)["joints_cam"] for _ in range(2))
        model.load_state_dict(state)  # undo the BN updates of those two
        again = model(*inputs, generator=gen.manual_seed(0))["joints_cam"]
    assert not torch.equal(first, second)
    assert torch.equal(first, again)


def test_freeze_bn_keeps_backbone_statistics():
    backbone = ResNetBackbone(frozen_bn=True).train()
    bns = [m for m in backbone.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 43 and not any(m.training for m in bns) and backbone.training
    before = [m.running_mean.clone() for m in bns]
    out = backbone(torch.randn(2, 3, 32, 32))
    out.sum().backward()
    assert all(torch.equal(b, m.running_mean) for b, m in zip(before, bns))
    assert backbone.bn1.weight.grad is not None  # scale and shift still train

    cfg = _cut(Config.from_yaml(CONFIG))
    model = HandMvNet(dataclasses.replace(cfg.model, freeze_bn=True), IMAGE, HEATMAP).train()
    assert model.pose_net[1].training and not model.backbone.bn1.training


# ---------------------------------------------------------------- one optimizer step


def _scaled_random_variables(flax_model, args):
    """Random flax variables in float64, with the heatmap head scaled by 1e-3
    and the last GCN layer by 1e-2, so that the soft-argmax (at x1000) is not
    saturated and the predicted joints lie tens of mm from the root, in front
    of every camera, as a trained model's do: else those paths carry almost
    no gradient, or sit near the projection's pole."""
    variables = random_flax_variables(flax_model, 17, *args)
    params = variables["params"]
    for name in ("kernel", "bias"):
        params["pose_net_3"][name] = params["pose_net_3"][name] * 1e-3
    for name in ("weight", "bias"):
        params["joints_decoder"]["joints_gcn3"][name] = (
            params["joints_decoder"]["joints_gcn3"][name] * 1e-2)
    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


# conv biases followed by a train-mode BatchNorm: their exact gradient is 0
ZERO_GRAD_LEAVES = ("pose_net.0.bias", "sample_nets.0.conv.0.bias")


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def step_case(request):
    """One optimizer step of each package from the same float64 weights and
    batch, dropout 0: the JAX side through make_train_step, its gradients
    through jax.grad of the same _forward_loss per microbatch."""
    accum = request.param
    cfg, jcfg = _cut(Config.from_yaml(CONFIG)), _cut(JaxConfig.from_yaml(CONFIG))
    data = synthetic_batch(BATCH, VIEWS, IMAGE, HEATMAP, seed=7)
    data = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in data.items()}
    with jax.enable_x64(True):
        flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP,
                                   dropout=0.0)
        jbatch = {k: jnp.asarray(v) for k, v in data.items()}
        variables = _scaled_random_variables(
            flax_model, [jbatch[k] for k in ("rgb", "bboxes", "intrinsic")])
        grad_fn = jax.jit(jax.grad(partial(jax_forward_loss, flax_model, jcfg), has_aux=True))
        mb = BATCH // accum
        stats, grads = variables["batch_stats"], None
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in jbatch.items()}
            g, (stats, _, _) = grad_fn(variables["params"], stats, micro, jax.random.PRNGKey(0))
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        ref_grads = jax.tree.map(lambda a: np.asarray(a) / accum, grads)

        tx = jax_make_optimizer(jcfg, steps_per_epoch=10)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
        step = make_train_step(flax_model, jcfg, tx, make_mesh(num_devices=1), accum_steps=accum)
        new_state, ref_losses = step(state, jbatch, jax.random.PRNGKey(0))
        ref_after = load_flax_variables({
            "params": jax.tree.map(np.asarray, new_state.params),
            "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)})
        ref_losses = {k: float(v) for k, v in ref_losses.items()}

    model = HandMvNet(cfg.model, IMAGE, HEATMAP, dropout=0.0)
    model.load_state_dict(load_flax_variables(variables))
    state = create_train_state(model.double(), cfg, steps_per_epoch=10)
    ours_losses = accumulate_grads(state, cfg, batch_to_device(data, "cpu"), None, accum)
    ours_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    optimizer_step(state, cfg)
    return {"ref_losses": ref_losses, "ref_grads": load_flax_variables({"params": ref_grads}),
            "ref_after": ref_after, "ours_losses": {k: float(v) for k, v in ours_losses.items()},
            "ours_grads": ours_grads, "model": model, "lr": cfg.train.lr}


def test_step_loss_terms_match_jax(step_case):
    ref, ours = step_case["ref_losses"], step_case["ours_losses"]
    assert set(ours) == set(ref) == {"heatmap_loss", "joints_2d_loss", "joints_3d_loss",
                                     "g2d_loss", "p2d_loss", "loss"}
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], rel=1e-9), key


def test_step_gradients_match_jax(step_case):
    ref, ours = step_case["ref_grads"], step_case["ours_grads"]
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


def test_step_batch_statistics_match_jax(step_case):
    ref, state = step_case["ref_after"], step_case["model"].state_dict()
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 45  # backbone 43, pose_net 1, SampleNet 1
    for key in keys:
        np.testing.assert_allclose(state[key].numpy(), ref[key].numpy(), atol=1e-9, rtol=0,
                                   err_msg=key)


def test_step_parameters_match_jax(step_case):
    """Adam's first step is close to lr * sign(g): within 2 lr everywhere,
    and within 1e-2 lr where the gradient is not tiny."""
    ref, lr = step_case["ref_after"], step_case["lr"]
    for name, p in step_case["model"].named_parameters():
        diff = (p.detach() - ref[name]).abs()
        assert float(diff.max()) <= 2 * lr, name
        g = step_case["ref_grads"][name].abs()
        big = g > 1e-3 * g.max()
        if big.any():
            assert float(diff[big].max()) <= 1e-2 * lr, name


# ---------------------------------------------------------------- bf16 compute branch


def test_bf16_branch_keeps_fp32_masters_statistics_and_losses():
    cfg = _cut(Config.from_yaml(CONFIG))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    state = create_train_state(build_model(cfg, "cpu", seed=0), cfg, steps_per_epoch=10)
    compute = _bf16_compute_params(state.model)
    bn_affine = {n for n in compute if n.startswith(("backbone.bn1.", "pose_net.1."))}
    assert bn_affine and all(compute[n].dtype == torch.float32 for n in bn_affine)
    assert compute["backbone.conv1.weight"].dtype == torch.bfloat16
    batch = batch_to_device(synthetic_batch(2, VIEWS, IMAGE, HEATMAP, seed=2), "cpu")
    losses_ = accumulate_grads(state, cfg, batch, torch.Generator().manual_seed(0), 2)
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in losses_.values())
    params = dict(state.model.named_parameters())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in params.values())
    assert float(params["backbone.conv1.weight"].grad.abs().sum()) > 0
    optimizer_step(state, cfg)
    assert all(t.dtype == torch.float32 for k, t in state.model.state_dict().items()
               if "num_batches" not in k)


# ---------------------------------------------------------------- engine, checkpoints, driver


def test_device_metric_averager_weights_batches():
    avg = DeviceMetricAverager()
    avg.update({"a": torch.tensor(1.0), "pck": torch.tensor([0.0, 1.0])}, weight=3.0)
    avg.update({"a": torch.tensor(5.0), "pck": torch.tensor([1.0, 1.0])}, weight=1.0)
    assert avg.result() == {"a": 2.0, "pck": [0.25, 1.0]}
    assert DeviceMetricAverager().result() == {}


def test_checkpoint_manager_keeps_best_and_last(tmp_path):
    cfg = _cut(Config.from_yaml(CONFIG))
    state = create_train_state(torch.nn.Linear(2, 2), cfg, steps_per_epoch=10)
    mgr = CheckpointManager(tmp_path)
    for epoch, val in enumerate((5.0, 7.0, 3.0)):
        state.step = epoch + 1
        mgr.save(state, epoch, val)
    assert mgr.best_val == 3.0 and mgr.best_path.name == "epoch=2-step=3-val_mpjpe=3.000.pt"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best.json", "epoch=2-step=3-val_mpjpe=3.000.pt", "last.pt"]
    again = CheckpointManager(tmp_path)  # a resumed run keeps the best
    assert again.best_val == 3.0 and again.best_path == mgr.best_path
    state.step = 0
    assert again.restore_best(state).step == 3


@pytest.fixture(scope="module")
def shard_data(tmp_path_factory):
    return write_train_shards(tmp_path_factory.mktemp("shards"))


def _tiny_config(tmp_path, shard_data, **train):
    raw = yaml.safe_load(CONFIG.read_text())
    raw["data"].update(image_size=IMAGE, heatmap_size=HEATMAP, batch_size=2, **shard_data)
    raw["model"]["selected_views"] = list(range(VIEWS))
    raw["train"].update(train)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


def _run_driver(config, out, *flags):
    train_driver.main(["--config", config, "--steps-per-epoch", "2", "--output-dir", str(out),
                       "--device", "cpu", *flags])


def _records(out) -> list[dict]:
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_train_driver_runs_and_resumes_bit_for_bit(tmp_path, shard_data, monkeypatch):
    """1 epoch x 2 steps on the shards (augmented train stream, dropout on,
    accumulation 2) writes metrics.jsonl, checkpoints and val.json;
    ``--resume`` for a second epoch starts from exactly what last.pt holds
    (step, weights, optimizer state, scheduler) and goes on to step 4. The
    data stream and the augmentation counter start again on resume, as in
    the JAX trainer, so the resumed run is not a straight 2-epoch run."""
    config = _tiny_config(tmp_path, shard_data)
    _run_driver(config, tmp_path / "a", "--epochs", "1", "--eval-first")
    records = _records(tmp_path / "a")
    assert [r["epoch"] for r in records] == [-1, 0]
    assert records[1]["lr"] == 1e-4 and np.isfinite(records[1]["train/loss"])
    assert {"train/g2d_loss", "val_mpjpe", "val_pa_mpjpe"} <= set(records[1])
    (val,) = json.loads((tmp_path / "a" / "val.json").read_text())
    assert np.isfinite(val["val_mpjpe"])
    saved = torch.load(tmp_path / "a" / "checkpoints" / "last.pt", weights_only=True)
    assert saved["step"] == 2

    first_step = []
    real_step = train_driver.train_step

    def spy(state, *args, **kwargs):
        if not first_step:
            first_step.append(copy.deepcopy((state.step, state.model.state_dict(),
                                             state.optimizer.state_dict(),
                                             state.scheduler.state_dict())))
        return real_step(state, *args, **kwargs)

    monkeypatch.setattr(train_driver, "train_step", spy)
    _run_driver(config, tmp_path / "a", "--epochs", "2", "--resume")
    step, weights, optimizer, scheduler = first_step[0]
    assert step == saved["step"] == 2
    assert weights.keys() == saved["model"].keys()
    for key, value in saved["model"].items():
        assert torch.equal(weights[key], value), key
    for idx, st in saved["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(optimizer["state"][idx][key]),
                               torch.as_tensor(st[key])), (idx, key)
    assert scheduler == saved["scheduler"]
    resumed = torch.load(tmp_path / "a" / "checkpoints" / "last.pt", weights_only=True)
    assert resumed["step"] == 4 and resumed["scheduler"]["last_epoch"] == 4
    assert [r["epoch"] for r in _records(tmp_path / "a")] == [-1, 0, 1]


def test_train_straight_runs_agree_bit_for_bit(tmp_path, shard_data):
    """Two straight runs from one seed agree bit for bit: the sample stream,
    the augmentation draws and dropout (1 epoch x 2 steps, accumulation 2);
    without augmentation the losses differ."""
    config = _tiny_config(tmp_path, shard_data)
    for run in ("b", "c"):
        _run_driver(config, tmp_path / run, "--epochs", "1")
    b, c = (torch.load(tmp_path / r / "checkpoints" / "last.pt", weights_only=True)
            for r in ("b", "c"))
    assert b["step"] == c["step"] == 2
    for key, value in b["model"].items():
        assert torch.equal(c["model"][key], value), key
    for idx, st in b["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(c["optimizer"]["state"][idx][key], st[key]), (idx, key)
    (rb,), (rc,) = _records(tmp_path / "b"), _records(tmp_path / "c")
    assert {k: v for k, v in rb.items() if k != "time_s"} == \
        {k: v for k, v in rc.items() if k != "time_s"}
    raw = yaml.safe_load(Path(config).read_text())
    raw["data"]["augment"] = False
    plain = tmp_path / "plain.yaml"
    plain.write_text(yaml.safe_dump(raw, sort_keys=False))
    _run_driver(str(plain), tmp_path / "d", "--epochs", "1")
    (rd,) = _records(tmp_path / "d")
    assert rd["train/loss"] != rb["train/loss"]


def test_train_step_decreases_the_loss_on_one_batch():
    """Gradients reach the loss end to end: 6 steps on one batch at the
    release recipe's lr lower it (measured 271.0 -> 258.1)."""
    cfg = _cut(Config.from_yaml(CONFIG))
    state = create_train_state(build_model(cfg, "cpu", seed=0), cfg, steps_per_epoch=10)
    batch = batch_to_device(synthetic_batch(2, VIEWS, IMAGE, HEATMAP, seed=3), "cpu")
    gen = torch.Generator()
    seen = [float(train_step(state, cfg, batch, gen.manual_seed(i))["loss"]) for i in range(6)]
    assert all(np.isfinite(seen)) and seen[-1] < seen[0], seen
    assert state.step == 6


def test_train_bench_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_bench.main([])
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_driver.main(["--config", str(CONFIG)])
