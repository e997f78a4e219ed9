"""Port parity, train.remat: the remat policy (train_step.resolve_remat,
as tests/test_remat_policy.py holds the JAX package's, with the port's
anchors), block remat in the backbones (torch.utils.checkpoint) against the
same step without it, and one remat step against the JAX package's
make_train_step with ``HandMvNet(remat=True)``, on the CPU.

Sizes are test_torch_train.py's: the HO3D release model (and its HR
config) with 3 views, batch 4 at accumulation 2, 64^2 images.

Tolerances:
  * remat on against off, the same weights, batch and dropout: bitwise
    equal (loss terms, every gradient, every BatchNorm running statistic
    and counter), in fp32 and through the bf16 compute copy. The recompute
    runs the same ops on the same inputs; its BatchNorms update scratch
    statistics, so the step updates the real ones once, as flax's
    nn.remat does (without that guard the statistics move twice: the last
    test shows it);
  * remat against make_train_step in float64 on both sides:
    test_torch_train.py's limits, loss terms rel 1e-9, BatchNorm running
    statistics 1e-9, parameters within 2 lr everywhere and 1e-2 lr where
    the gradient is over 1e-3 of its leaf's max.
"""

import contextlib
import dataclasses
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.parallel import make_mesh, make_train_step
from handmvnet_tpu.parallel import make_optimizer as jax_make_optimizer
from handmvnet_tpu.parallel.train_step import TrainState as JaxTrainState
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.models.backbones import resnet
from handmvnet_tpu_torch.ops import attention as attention_ops
from handmvnet_tpu_torch.ops import stem as stem_ops
from handmvnet_tpu_torch.train import accumulation
from handmvnet_tpu_torch.train_step import (
    REMAT_FREE_IMAGES,
    accumulate_grads,
    batch_to_device,
    build_model,
    create_train_state,
    optimizer_step,
    resolve_remat,
)
from torch_parity import scaled_random_variables

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
HR_CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet_HR.yaml"
RELEASE = sorted((ROOT / "configs" / "release").glob("*.yaml"))
VIEWS, BATCH, IMAGE, HEATMAP, ACCUM = 3, 4, 64, 8, 2
BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture
def one_thread():
    """One intra-op thread for the remat steps, whose recompute runs inside
    autograd's backward. Beside five other test workers of eight threads
    each on eight cores, their many small ops stall: six concurrent runs of
    the HR step took over 900 s, against 25 s with one thread each (~5 s
    alone). The thread count changes no result: on and off run alike."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _policy_cfg(batch=16, views=5, dtype="float32", backbone="resnet", remat="auto"):
    cfg = Config.from_yaml(CONFIG)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch,
                                      selected_views=tuple(range(views))),
        model=dataclasses.replace(cfg.model, backbone=backbone),
        train=dataclasses.replace(cfg.train, compute_dtype=dtype, remat=remat))


# ---------------------------------------------------------------- the policy


@pytest.mark.parametrize("path", RELEASE, ids=lambda p: p.stem)
def test_release_recipes_are_remat_free(path):
    cfg = Config.from_yaml(path)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype=dtype))
        for world in (1, 2, 3):  # 3 ranks: accumulation 1, the largest microbatch
            assert resolve_remat(c, accumulation(c, world)) is False, (dtype, world)


@pytest.mark.parametrize("backbone", ["resnet", "hrnet"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_auto_turns_on_past_the_measured_anchor(backbone, dtype):
    anchor = REMAT_FREE_IMAGES[(backbone, dtype)]
    assert anchor > 80  # the release recipe's microbatch, at accumulation 1
    views = 5
    at = anchor // views  # samples whose images stay within the anchor
    assert resolve_remat(_policy_cfg(at, views, dtype, backbone)) is False
    assert resolve_remat(_policy_cfg(at + 1, views, dtype, backbone)) is True
    # accumulation splits the batch: its microbatch is within the anchor again
    assert resolve_remat(_policy_cfg(at + 1, views, dtype, backbone), accum_steps=2) is False


def test_bf16_anchors_are_at_least_the_fp32_ones():
    for backbone in ("resnet", "hrnet"):
        assert REMAT_FREE_IMAGES[(backbone, "bfloat16")] >= \
            REMAT_FREE_IMAGES[(backbone, "float32")]


def test_forced_on_off_and_validation():
    for setting in ("on", "true", "ON"):
        assert resolve_remat(_policy_cfg(remat=setting)) is True
    for setting in ("off", "false"):
        assert resolve_remat(_policy_cfg(batch=10_000, remat=setting)) is False
    with pytest.raises(ValueError, match="auto/on/off"):
        resolve_remat(_policy_cfg(remat="sometimes"))


def test_unknown_backbone_defaults_to_remat():
    assert resolve_remat(_policy_cfg(backbone="hourglass")) is True


def test_explicit_shapes_override_the_config():
    anchor = REMAT_FREE_IMAGES[("resnet", "float32")]
    cfg = _policy_cfg(batch=16, views=5)  # the config: 80 images, remat off
    assert resolve_remat(cfg) is False
    assert resolve_remat(cfg, batch_size=anchor // 5 + 1) is True
    assert resolve_remat(cfg, batch_size=anchor // 8 + 1, num_views=8) is True
    big = _policy_cfg(batch=anchor, views=8)  # the config: remat on
    assert resolve_remat(big) is True
    assert resolve_remat(big, batch_size=8, num_views=5) is False


def test_build_model_follows_the_policy():
    for path in (CONFIG, HR_CONFIG):
        cfg = _cut(Config.from_yaml(path))
        for setting, want in (("on", True), ("off", False), ("auto", False)):
            c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=setting))
            with torch.device("meta"):
                assert build_model(c, "meta", accum_steps=ACCUM).backbone.remat is want


# ---------------------------------------------------------------- remat on against off


def _cut(cfg, remat="off", dtype="float32"):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=tuple(range(VIEWS))),
        data=dataclasses.replace(cfg.data, image_size=IMAGE, heatmap_size=HEATMAP,
                                 batch_size=BATCH),
        train=dataclasses.replace(cfg.train, remat=remat, compute_dtype=dtype))


def _step(path: Path, remat: bool, dtype: str = "float32") -> dict:
    """One optimizer step at accumulation 2, dropout on, from PyTorch's init
    at seed 0: losses, gradients, the BN buffers after, and the calls of
    the stem and attention ops (a spy)."""
    cfg = _cut(Config.from_yaml(path), "on" if remat else "off", dtype)
    state = create_train_state(build_model(cfg, "cpu", seed=0, accum_steps=ACCUM), cfg, 10)
    assert state.model.backbone.remat is remat
    batch = batch_to_device(synthetic_batch(BATCH, VIEWS, IMAGE, HEATMAP, seed=5), "cpu")
    calls = {"stem": 0, "attention": 0}
    stem, attention = stem_ops.stem_conv_nchw, attention_ops.fused_attention

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(stem_ops, "stem_conv_nchw", spy("stem", stem))
    mp.setattr(attention_ops, "fused_attention", spy("attention", attention))
    try:
        losses = accumulate_grads(state, cfg, batch, torch.Generator().manual_seed(3), ACCUM)
    finally:
        mp.undo()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    optimizer_step(state, cfg)
    buffers = {n: b.clone() for n, b in state.model.named_buffers() if n.endswith(BN_STATS)}
    return {"losses": losses, "grads": grads, "buffers": buffers, "calls": calls,
            "params": {n: p.detach().clone() for n, p in state.model.named_parameters()}}


def _assert_same(on: dict, off: dict) -> None:
    for part in ("losses", "grads", "buffers", "params"):
        assert on[part].keys() == off[part].keys(), part
        for key in off[part]:
            assert torch.equal(on[part][key], off[part][key]), (part, key)


@pytest.mark.parametrize("path,dtype", [(CONFIG, "float32"), (HR_CONFIG, "float32"),
                                        (CONFIG, "bfloat16")],
                         ids=["resnet-fp32", "hrnet-fp32", "resnet-bf16"])
def test_remat_step_bitwise_equals_the_plain_step(path, dtype, one_thread):
    off, on = _step(path, False, dtype), _step(path, True, dtype)
    _assert_same(on, off)
    # BN statistics moved once a microbatch: the counter of every BN is 2
    counts = {k: int(v) for k, v in on["buffers"].items() if k.endswith("num_batches_tracked")}
    assert set(counts.values()) == {ACCUM}
    # the stem (K2 on the card) and the fusion (K1) are outside the checkpointed
    # blocks: one stem and five attention calls a microbatch, as without remat
    stem_calls = ACCUM if path == CONFIG else 0
    assert on["calls"] == off["calls"] == {"stem": stem_calls, "attention": 5 * ACCUM}


def test_without_the_guard_the_recompute_updates_bn_twice(monkeypatch, one_thread):
    """The double update that the guard prevents: with the recompute's
    BatchNorms on their real statistics, the counters count the recompute
    and the running statistics move twice."""
    off = _step(CONFIG, False)
    monkeypatch.setattr(resnet, "_scratch_bn_stats", lambda block: contextlib.nullcontext())
    on = _step(CONFIG, True)
    backbone = {k: int(v) for k, v in on["buffers"].items()
                if k.startswith("backbone.layer") and k.endswith("num_batches_tracked")}
    assert set(backbone.values()) == {2 * ACCUM}
    stats = [k for k in off["buffers"] if k.startswith("backbone.layer")
             and k.endswith("running_mean")]
    assert not any(torch.equal(on["buffers"][k], off["buffers"][k]) for k in stats)
    for key in off["losses"]:  # the step's own outputs are the same
        assert torch.equal(on["losses"][key], off["losses"][key])


# ---------------------------------------------------------------- against JAX


def test_remat_step_matches_jax_make_train_step_in_float64(one_thread):
    cfg = _cut(Config.from_yaml(CONFIG), remat="on")
    jcfg = JaxConfig.from_yaml(CONFIG)
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, selected_views=tuple(range(VIEWS))),
        data=dataclasses.replace(jcfg.data, image_size=IMAGE, heatmap_size=HEATMAP,
                                 batch_size=BATCH))
    data = synthetic_batch(BATCH, VIEWS, IMAGE, HEATMAP, seed=7)
    data = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in data.items()}
    with jax.enable_x64(True):
        flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP,
                                   dropout=0.0, remat=True)
        jbatch = {k: jnp.asarray(v) for k, v in data.items()}
        variables = scaled_random_variables(
            flax_model, [jbatch[k] for k in ("rgb", "bboxes", "intrinsic")])
        tx = jax_make_optimizer(jcfg, steps_per_epoch=10)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
        step = make_train_step(flax_model, jcfg, tx, make_mesh(num_devices=1), accum_steps=ACCUM)
        new_state, ref_losses = step(state, jbatch, jax.random.PRNGKey(0))
        ref_after = load_flax_variables({
            "params": jax.tree.map(np.asarray, new_state.params),
            "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)})
        ref_losses = {k: float(v) for k, v in ref_losses.items()}

    model = HandMvNet(cfg.model, IMAGE, HEATMAP, dropout=0.0, remat=True)
    model.load_state_dict(load_flax_variables(variables))
    tstate = create_train_state(model.double(), cfg, steps_per_epoch=10)
    losses = accumulate_grads(tstate, cfg, batch_to_device(data, "cpu"), None, ACCUM)
    grads = {n: p.grad.abs() for n, p in model.named_parameters()}
    optimizer_step(tstate, cfg)

    for key, ref in ref_losses.items():
        assert float(losses[key]) == pytest.approx(ref, rel=1e-9), key
    state_dict = model.state_dict()
    for key in [k for k in state_dict if k.endswith(("running_mean", "running_var"))]:
        np.testing.assert_allclose(state_dict[key].numpy(), ref_after[key].numpy(), atol=1e-9,
                                   rtol=0, err_msg=key)
    lr = cfg.train.lr
    for name, p in model.named_parameters():
        diff = (p.detach() - ref_after[name]).abs()
        assert float(diff.max()) <= 2 * lr, name
        big = grads[name] > 1e-3 * grads[name].max()
        if big.any():
            assert float(diff[big].max()) <= 1e-2 * lr, name
