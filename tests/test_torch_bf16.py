"""The bf16 training step against the JAX package's, on the CPU:
``compute_dtype: bfloat16`` in both, one optimizer step of
handmvnet_tpu_torch's ``train_step`` against ``make_train_step`` at
accumulation 2, from the same fp32 weights and batch (the HO3D release model
at tests/test_torch_train.py's size: 3 views, batch 4, 64^2 images).

JAX casts every parameter to bf16 for the compute, and flax's batch norm
then computes in fp32 with the bf16 scale and shift. The port rounds each
BatchNorm's scale and shift through bf16 and keeps them fp32, which is the
same arithmetic; before, it kept them unrounded.

Measured on this CPU (``-s`` prints it), loss terms relative to JAX's: with
the rounding the total loss differs by 9.3e-3 and the largest term
(joints_3d) by 1.1e-2; without it, by 5.4e-3 and 1.4e-2 (joints_3d). At the
step the rounding is lost in the noise: both packages round every conv and matmul
output to bf16, in their own order, through 45 train-mode BatchNorms. Each
term is held to 2^-6 (bf16 keeps 8 bits). One BatchNorm alone shows the
repair: against flax's with bf16 parameters, 0.14% of its bf16 outputs
differ with the rounding and 33.7% without. Gradients are not compared: at
this size bf16 rounding through the train-mode BatchNorms moves either
package's gradients by a large part of their norm.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.models.layers import batch_norm as flax_batch_norm
from handmvnet_tpu.parallel import make_mesh, make_optimizer, make_train_step
from handmvnet_tpu.parallel.train_step import TrainState as JaxTrainState
from handmvnet_tpu_torch import train_step as port_step
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.models.layers import batch_norm
from torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
VIEWS, BATCH, IMAGE, HEATMAP, ACCUM = 3, 4, 64, 8, 2


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
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=tuple(range(VIEWS))),
        data=dataclasses.replace(cfg.data, image_size=IMAGE, heatmap_size=HEATMAP,
                                 batch_size=BATCH),
        train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))


def _unrounded_bf16_params(model: nn.Module):
    """The compute copy as it was: BatchNorm scale and shift fp32, unrounded."""
    keep = {id(p) for m in model.modules() if isinstance(m, nn.BatchNorm2d)
            for p in m.parameters()}
    return {n: p if id(p) in keep else p.to(torch.bfloat16) for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def bf16_case():
    cfg, jcfg = _cut(Config.from_yaml(CONFIG)), _cut(JaxConfig.from_yaml(CONFIG))
    data = synthetic_batch(BATCH, VIEWS, IMAGE, HEATMAP, seed=7)
    # every view at the root camera's pose: no joint near a camera plane,
    # where the g2d/p2d projection turns rounding into pixels
    data["extrinsic"][:] = np.eye(4, dtype=np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP, dropout=0.0)
    variables = random_flax_variables(flax_model, 17, *(jbatch[k] for k in
                                                        ("rgb", "bboxes", "intrinsic")))
    params = variables["params"]  # an unsaturated soft-argmax, joints before the cameras
    for name in ("kernel", "bias"):
        params["pose_net_3"][name] = params["pose_net_3"][name] * 1e-3
    for name in ("weight", "bias"):
        params["joints_decoder"]["joints_gcn3"][name] = (
            params["joints_decoder"]["joints_gcn3"][name] * 1e-2)

    tx = make_optimizer(jcfg, steps_per_epoch=10)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables["batch_stats"], opt_state=tx.init(params))
    step = make_train_step(flax_model, jcfg, tx, make_mesh(num_devices=1), accum_steps=ACCUM)
    _, ref = step(state, jbatch, jax.random.PRNGKey(0))
    ref = {k: float(v) for k, v in ref.items()}

    ours = {}
    for label, compute_params in (("rounded", port_step.bf16_compute_params),
                                  ("unrounded", _unrounded_bf16_params)):
        model = HandMvNet(cfg.model, IMAGE, HEATMAP, dropout=0.0)
        model.load_state_dict(load_flax_variables(variables))
        state = port_step.create_train_state(model, cfg, steps_per_epoch=10)
        saved = port_step.bf16_compute_params
        port_step.bf16_compute_params = compute_params
        try:
            losses = port_step.train_step(state, cfg, port_step.batch_to_device(data, "cpu"),
                                          None, ACCUM)
        finally:
            port_step.bf16_compute_params = saved
        ours[label] = {k: float(v) for k, v in losses.items()}
    return {"ref": ref, "ours": ours}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def test_bf16_step_loss_terms_match_jax(bf16_case):
    ref, ours = bf16_case["ref"], bf16_case["ours"]
    for label, losses in ours.items():
        print(f"bf16 step, {label} BatchNorm affine, loss terms relative to JAX's: "
              + ", ".join(f"{k} {_rel(losses[k], ref[k]):.3e}" for k in sorted(ref)),
              file=sys.stderr)
    assert set(ours["rounded"]) == set(ref)
    for key in ref:
        assert _rel(ours["rounded"][key], ref[key]) <= 2.0 ** -6, key


def test_bf16_batch_norm_matches_flax_with_bf16_affine():
    """One train-mode BatchNorm on bf16 activations, its scale and shift as
    the two compute copies make them, against flax's (TorchBatchNorm) with
    the parameters cast to bf16 as JAX's step casts them: with the rounding
    the port computes what flax computes, and outputs differ only where the
    two packages' statistics, summed in another order, flip a bf16 rounding."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(8, 16, 16, 64)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    shift = rng.normal(size=64).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale, jnp.bfloat16),
                            "bias": jnp.asarray(shift, jnp.bfloat16)},
                 "batch_stats": {"mean": np.zeros(64, np.float32), "var": np.ones(64, np.float32)}}
    ref, _ = flax_batch_norm("bn", jnp.bfloat16).apply(
        variables, jnp.asarray(x, jnp.bfloat16), use_running_average=False,
        mutable=["batch_stats"])
    ref = np.asarray(ref.astype(jnp.float32))
    bn = batch_norm(64).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(shift))
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    differ = {}
    for label, compute_params in (("rounded", port_step.bf16_compute_params),
                                  ("unrounded", _unrounded_bf16_params)):
        with torch.no_grad():
            y = torch.func.functional_call(bn, compute_params(bn), (xt,))
        diff = np.abs(y.permute(0, 2, 3, 1).float().numpy() - ref)
        differ[label] = float((diff > 0).mean())
        if label == "rounded":
            assert diff.max() <= 2.0 ** -7 * np.abs(ref).max()
    # measured: 0.14% of the outputs with the rounding, 33.7% without
    assert differ["rounded"] < 1e-2 < 0.1 < differ["unrounded"], differ


def test_bf16_compute_copy_rounds_batch_norm_affine():
    cfg = _cut(Config.from_yaml(CONFIG))
    model = HandMvNet(cfg.model, IMAGE, HEATMAP)
    with torch.no_grad():
        model.backbone.bn1.weight.copy_(torch.linspace(0.5, 1.5, 64))
    compute = port_step.bf16_compute_params(model)
    scale = compute["backbone.bn1.weight"]
    assert scale.dtype == torch.float32 and scale.requires_grad
    assert torch.equal(scale, model.backbone.bn1.weight.detach().to(torch.bfloat16).float())
    assert not torch.equal(scale, model.backbone.bn1.weight.detach())
    assert compute["backbone.layer1.0.conv1.weight"].dtype == torch.bfloat16
