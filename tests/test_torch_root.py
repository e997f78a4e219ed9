"""Port parity, the absolute-root branch: handmvnet_tpu_torch's
HandMvNet(root_relative=False) against flax's, its training step against
make_train_step with train.root_relative false, the root metric against the
JAX engine's, and the drivers' refusal of that config, on the CPU.

Sizes are tests/test_root_branch.py's: the HO3D release config at 2 views,
64^2 images, heatmap 8, batch 2, and a case at 3 views.

Tolerances, with the largest error measured on this CPU:
  * the forward, fp32: test_torch_model.py's (heatmap 1e-4, joints_crop_img
    2e-2 px, joints_cam 5e-4; measured 4.8e-6, 9.8e-3 px and 2.0e-5), and
    root_joint 1e-5 m (values up to ~0.4 m; measured 1.4e-6);
  * one optimizer step in float64 on both sides (accumulation 1, dropout 0),
    test_torch_train.py's limits: loss terms rel 1e-9 (measured 2.5e-14),
    every gradient leaf 1e-7 of its max |g| (measured 1.7e-10 on
    pose_net.3.bias, 1.1e-12 on the root branch's leaves), parameters within
    2 lr everywhere and 1e-2 lr where |g| > 1e-3 max|g| of the leaf
    (measured 6.1e-9 lr);
  * the metrics of the root model's outputs, w_mpjpe among them: 1e-5 mm
    as tests/test_torch_metrics.py, and rel 1e-6, an ulp or two of the
    random-weight model's w_mpjpe of ~430 mm (measured 6.1e-5 mm).
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

from handmvnet_tpu import engine as jax_engine
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.parallel import make_mesh, make_train_step
from handmvnet_tpu.parallel import make_optimizer as jax_make_optimizer
from handmvnet_tpu.parallel.train_step import TrainState as JaxTrainState
from handmvnet_tpu.parallel.train_step import _forward_loss as jax_forward_loss
from handmvnet_tpu_torch import engine
from handmvnet_tpu_torch import eval as eval_driver
from handmvnet_tpu_torch import infer as infer_driver
from handmvnet_tpu_torch import train as train_driver
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.train_step import (
    accumulate_grads,
    batch_to_device,
    build_model,
    create_train_state,
    optimizer_step,
)
from torch_parity import random_flax_variables, scaled_random_variables

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
BATCH, IMAGE, HEATMAP = 2, 64, 8
KEYS = ("rgb", "bboxes", "intrinsic")
TOLERANCES = {"heatmap": 1e-4, "joints_crop_img": 2e-2, "joints_cam": 5e-4, "root_joint": 1e-5}
# leaves whose exact gradient is 0: the conv biases before a train-mode
# BatchNorm, and the query and key projections of the root branch's last block,
# a softmax over its one key
ZERO_GRAD_LEAVES = ("pose_net.0.bias", "sample_nets.0.conv.0.bias",
                    "root_late_fusion.attn_fusion.2.to_q.weight",
                    "root_late_fusion.attn_fusion.2.to_k.weight")


def _configs(views: int):
    """The port's and the JAX package's config at the test size, with
    train.root_relative false."""
    def cut(cfg):
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, selected_views=tuple(range(views))),
            data=dataclasses.replace(cfg.data, image_size=IMAGE, heatmap_size=HEATMAP,
                                     batch_size=BATCH),
            train=dataclasses.replace(cfg.train, root_relative=False))
    return cut(Config.from_yaml(CONFIG)), cut(JaxConfig.from_yaml(CONFIG))


@pytest.mark.parametrize("views", [2, 3])
def test_root_forward_matches_flax(views):
    cfg, jcfg = _configs(views)
    data = synthetic_batch(BATCH, views, IMAGE, seed=3)
    args = [jnp.asarray(data[k]) for k in KEYS]
    flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP,
                               root_relative=False)
    variables = random_flax_variables(flax_model, 17, *args)
    ref = jax.jit(flax_model.apply)(variables, *args)
    port = HandMvNet(cfg.model, IMAGE, HEATMAP, root_relative=False).eval()
    port.load_state_dict(load_flax_variables(variables), strict=True)
    with torch.no_grad():
        ours = port(*(torch.from_numpy(data[k]) for k in KEYS))
    assert set(ours) == set(ref) == set(TOLERANCES)
    assert ours["root_joint"].shape == (BATCH, 1, 3)
    for key, tol in TOLERANCES.items():
        assert ours[key].dtype == torch.float32 and ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=tol, rtol=0,
                                   err_msg=key)


def test_root_branch_weights_and_k1_shapes():
    """The branch's modules carry the flax names, and its 3 blocks call the
    attention core at (V, V), (1, V-1) and (1, 1): 8 calls a forward with the
    5 of the joints fusion."""
    from handmvnet_tpu_torch.ops import attention as attention_ops

    cfg, _ = _configs(3)
    port = HandMvNet(cfg.model, IMAGE, HEATMAP, root_relative=False).eval()
    keys = port.state_dict()
    assert "root_late_fusion.attn_fusion.2.to_q.weight" in keys
    assert "root_decoder.joints_fc2.bias" in keys
    assert keys["root_late_fusion.attn_fusion.0.to_q.weight"].shape == (1024, 524 + 2)
    calls = []
    real = attention_ops.fused_attention
    try:
        attention_ops.fused_attention = lambda q, k, v, s: calls.append(
            (q.shape[2], k.shape[2])) or real(q, k, v, s)
        with torch.no_grad():
            port(*(torch.from_numpy(v) for v in
                   (synthetic_batch(1, 3, IMAGE, seed=0)[k] for k in KEYS)))
    finally:
        attention_ops.fused_attention = real
    assert calls == [(63, 63), (63, 63), (21, 42), (21, 21), (21, 21), (3, 3), (1, 2), (1, 1)]


@pytest.fixture(scope="module")
def step_case():
    """One optimizer step of each package from the same float64 weights and
    batch, accumulation 1, dropout 0 (test_torch_train.py's step_case with
    the root branch on). The root decoder's last layer is scaled by 1e-2 and
    its bias set to the batch's mean root, so that the predicted root sits in
    front of every camera, as a trained model's does: the reprojection adds
    it to the joints."""
    views = 3
    cfg, jcfg = _configs(views)
    data = synthetic_batch(BATCH, views, IMAGE, HEATMAP, seed=7)
    data = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in data.items()}
    with jax.enable_x64(True):
        flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP,
                                   dropout=0.0, root_relative=False)
        jbatch = {k: jnp.asarray(v) for k, v in data.items()}
        variables = scaled_random_variables(flax_model, [jbatch[k] for k in KEYS])
        fc2 = variables["params"]["root_decoder"]["joints_fc2"]
        fc2["kernel"] = fc2["kernel"] * 1e-2
        fc2["bias"] = data["root_joint"].mean(axis=(0, 1)) / 1000.0
        grad_fn = jax.jit(jax.grad(partial(jax_forward_loss, flax_model, jcfg), has_aux=True))
        grads, _ = grad_fn(variables["params"], variables["batch_stats"], jbatch,
                           jax.random.PRNGKey(0))
        ref_grads = jax.tree.map(np.asarray, grads)
        tx = jax_make_optimizer(jcfg, steps_per_epoch=10)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
        step = make_train_step(flax_model, jcfg, tx, make_mesh(num_devices=1), accum_steps=1)
        new_state, ref_losses = step(state, jbatch, jax.random.PRNGKey(0))
        ref_after = load_flax_variables({
            "params": jax.tree.map(np.asarray, new_state.params),
            "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)})
        ref_losses = {k: float(v) for k, v in ref_losses.items()}

    model = HandMvNet(cfg.model, IMAGE, HEATMAP, dropout=0.0, root_relative=False).double()
    model.load_state_dict(load_flax_variables(variables))
    state = create_train_state(model, cfg, steps_per_epoch=10)
    ours_losses = accumulate_grads(state, cfg, batch_to_device(data, "cpu"), None, 1)
    ours_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    optimizer_step(state, cfg)
    return {"ref_losses": ref_losses, "ref_grads": load_flax_variables({"params": ref_grads}),
            "ref_after": ref_after, "ours_losses": {k: float(v) for k, v in ours_losses.items()},
            "ours_grads": ours_grads, "model": model, "lr": cfg.train.lr}


def test_step_loss_terms_match_jax(step_case):
    ref, ours = step_case["ref_losses"], step_case["ours_losses"]
    assert set(ours) == set(ref) == {"heatmap_loss", "joints_2d_loss", "joints_3d_loss",
                                     "root_3d_loss", "g2d_loss", "p2d_loss", "loss"}
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], rel=1e-9), key


def test_step_gradients_match_jax(step_case):
    ref, ours = step_case["ref_grads"], step_case["ours_grads"]
    assert set(ours) == set(ref)
    assert any(k.startswith("root_late_fusion.") for k in ref)
    assert any(k.startswith("root_decoder.") for k in ref)
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


def test_root_metric_matches_jax_engine():
    """w_mpjpe of the root model's outputs, labels in metres."""
    cfg, jcfg = _configs(2)
    data = synthetic_batch(BATCH, 2, IMAGE, HEATMAP, seed=5)
    model = build_model(cfg, "cpu", seed=0).eval()
    with torch.no_grad():
        out = model(*(torch.from_numpy(data[k]) for k in KEYS))
    kw = {"auc_thresholds": cfg.auc_thresholds, "root_relative": False}
    labels = {k: torch.as_tensor(v) for k, v in engine.labels_in_meters(data, "cpu").items()}
    ours = engine.pose_metrics_device(out, labels, **kw)
    ref = jax_engine.pose_metrics_device(
        {k: jnp.asarray(v.numpy()) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in jax_engine.labels_in_meters(data).items()}, **kw)
    assert "w_mpjpe" in ours and set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(value), atol=1e-5, rtol=1e-6,
                                   err_msg=key)


def test_create_train_state_follows_the_config():
    cfg, _ = _configs(2)
    model = build_model(cfg, "cpu")
    assert model.root_relative is False and hasattr(model, "root_decoder")
    create_train_state(model, cfg, steps_per_epoch=1)
    relative = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, root_relative=True))
    with pytest.raises(ValueError, match="root_relative"):
        create_train_state(model, relative, steps_per_epoch=1)


@pytest.mark.parametrize("driver", ["train.py", "eval.py", "infer.py"])
def test_drivers_refuse_absolute_root(tmp_path, driver):
    """The JAX drivers build HandMvNet without root_relative and fail on the
    missing root_joint; the port's refuse the config up front, saying so."""
    raw = yaml.safe_load(CONFIG.read_text())
    raw["train"]["root_relative"] = False
    config = tmp_path / "absolute_root.yaml"
    config.write_text(yaml.safe_dump(raw, sort_keys=False))
    argv = {"train.py": (train_driver, ["--output-dir", str(tmp_path / "run")]),
            "eval.py": (eval_driver, ["--checkpoint", str(tmp_path / "none.pt")]),
            "infer.py": (infer_driver, ["--synthetic"])}[driver]
    with pytest.raises(ValueError, match=rf"{driver}: train.root_relative: false is refused"):
        argv[0].main(["--config", str(config), "--device", "cpu", *argv[1]])
    assert not (tmp_path / "run").exists()
