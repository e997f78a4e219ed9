"""Port parity, the evaluation entry point: handmvnet_tpu_torch's
load_torch_checkpoint against the JAX package's converter, and
``eval.main --device cpu`` end to end against ``handmvnet_tpu.eval.main``
(engine.evaluate on JAX's loader) on the same reference checkpoint and the
same shards, fp32 on the CPU.

The model is the JAX eval test's tiny one (tests/test_eval_e2e.py): 64^2
crops, 2 views, 3 fusion blocks, ResNet-50 "paper"; weights LeCun-scaled
from a numpy seed (tests/torch_parity.py), the joint head scaled down
(HEAD_SCALE); the MANO model for the vertex metrics is the synthetic
stand-in, written as an .npz.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import handmvnet_tpu.eval as jax_eval
from handmvnet_tpu.checkpoint import convert_torch_state_dict
from handmvnet_tpu.data import native_loader
from handmvnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from handmvnet_tpu.data.synthetic import write_synthetic_ho3d_shards
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.models.mano import synthetic_mano_model
from handmvnet_tpu_torch import eval as port_eval
from handmvnet_tpu_torch.checkpoint import (
    load_flax_variables,
    load_torch_checkpoint,
    remap_legacy_keys,
)
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.engine import save_checkpoint
from handmvnet_tpu_torch.eval_fps import build_model, random_state_dict
from handmvnet_tpu_torch.train_step import create_train_state
from torch_parity import random_flax_variables

IMAGE, HEATMAP, VIEWS, BATCH = 64, 8, 2, 2
SIZES = {"val": 4, "test": 6}  # 2 samples a shard: val 2 shards, test 3
# The decoder's last ChebConv is scaled so that the predicted joints spread
# like a hand's (std ~50-70 mm). Unscaled, these random weights put them
# metres apart; the mesh stage of either package then maps them to one
# point for each sample, and PA-MPVPE aligns a point cloud of zero variance
# (0/0): NaN in the port, while JAX's jitted rounding left its cloud a
# spread of ~1e-12 and a finite number.
HEAD_SCALE = 0.1


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Shards, the synthetic MANO model, the config file and shared random
    weights (as flax variables and as the port's state_dict)."""
    root = tmp_path_factory.mktemp("eval")
    write_synthetic_ho3d_shards(root / "data", num_shards=9, samples_per_shard=2,
                                num_views=VIEWS, split="train", consistent_geometry=True)
    write_synthetic_ho3d_shards(root / "data", num_shards=3, samples_per_shard=2,
                                num_views=VIEWS, split="test", seed=3, consistent_geometry=True)
    mano = synthetic_mano_model()
    np.savez(root / "MANO_RIGHT.npz", v_template=mano.v_template, shapedirs=mano.shapedirs,
             posedirs=mano.posedirs, J_regressor=mano.j_regressor, weights=mano.lbs_weights,
             f=mano.faces, hands_mean=mano.hands_mean)
    raw = {
        "name": "evalparity",
        "data": {"name": "ho3d", "batch_size": BATCH, "dataset_dir": str(root / "data"),
                 "image_size": IMAGE, "heatmap_size": HEATMAP, "augment": False,
                 "mano_models_dir": str(root / "MANO_RIGHT.npz"),
                 "split_size_overrides": SIZES},
        "model": {"selected_views": list(range(VIEWS)), "fusion": "cross_attn",
                  "fusion_layers": 3, "pos_enc": ["pos2d", "crop", "sin"], "use_gcn": True,
                  "backbone": "resnet", "backbone_type": "50_paper",
                  "backbone_early_return": 3, "backbone_channels": [1024],
                  "backbone_pretrained": False},
        "train": {"root_relative": True, "mask_invisible_joints": True},
    }
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cfg = Config.from_yaml(cfg_path)

    data = jax_synthetic_batch(BATCH, VIEWS, IMAGE, seed=3, with_heatmaps=False)
    args = (jnp.asarray(data["rgb"]), jnp.asarray(data["bboxes"]),
            jnp.asarray(data["intrinsic"]))
    from handmvnet_tpu.config import Config as JaxConfig

    flax_model = FlaxHandMvNet(cfg=JaxConfig.from_yaml(cfg_path).model, image_size=IMAGE,
                               heatmap_size=HEATMAP)
    state = load_flax_variables(random_flax_variables(flax_model, 23, *args))
    for leaf in ("weight", "bias"):  # hand-sized joints: see HEAD_SCALE
        state[f"joints_decoder.joints_gcn3.{leaf}"] *= HEAD_SCALE
    return {"root": root, "cfg_path": cfg_path, "cfg": cfg, "state": state}


def _legacy(state: dict) -> dict:
    """The port's keys as an old reference checkpoint names them."""
    out = {}
    for key, value in state.items():
        key = key.replace("pose_net.", "pose_net.conv.", 1) if key.startswith("pose_net.") \
            else key
        key = "sample_net." + key[len("sample_nets.0."):] if key.startswith("sample_nets.0.") \
            else key
        out[key] = value
    return out


def _model(cfg):
    return build_model(cfg, views=cfg.model.num_views, image_size=IMAGE, device="cpu", seed=5)


def _assert_loaded(model, state):
    got = model.state_dict()
    for key, value in state.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)


# -------------------------------------------------------- checkpoint load --

@pytest.mark.parametrize("form", ["lightning", "legacy_pth", "plain_pth"])
def test_load_torch_checkpoint_forms(setup, tmp_path, form):
    """A Lightning .ckpt (``model.`` prefix, non-tensor entries beside the
    state_dict), a .pth with the legacy ``pose_net.conv.``/``sample_net.``
    names and no ``num_batches_tracked``, and a plain .pth: every key maps."""
    state = setup["state"]
    no_count = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    payload = {
        "lightning": {"state_dict": {f"model.{k}": v for k, v in _legacy(state).items()},
                      "epoch": 7, "global_step": 123, "hyper_parameters": {"lr": 1e-4}},
        "legacy_pth": _legacy(no_count),
        "plain_pth": state,
    }[form]
    assert any(k.startswith(("model.pose_net.conv.", "pose_net.conv.")) for k in payload.get(
        "state_dict", payload)) == (form != "plain_pth")
    path = tmp_path / ("w.ckpt" if form == "lightning" else "w.pth")
    torch.save(payload, path)
    model = _model(setup["cfg"])
    kind = load_torch_checkpoint(path, model)
    assert kind == ("lightning" if form == "lightning" else "state_dict")
    _assert_loaded(model, no_count)


def test_load_matches_jax_converter_round_trip(setup, tmp_path):
    """The legacy-named reference state_dict through the JAX package's
    convert_torch_state_dict (its own remaps) and back through the port's
    load_flax_variables gives exactly the tensors load_torch_checkpoint
    loads."""
    legacy = _legacy(setup["state"])
    torch.save(legacy, tmp_path / "w.pth")
    model = _model(setup["cfg"])
    load_torch_checkpoint(tmp_path / "w.pth", model)
    via_jax = load_flax_variables(convert_torch_state_dict(legacy))
    assert set(via_jax) == set(model.state_dict())
    _assert_loaded(model, via_jax)
    assert list(remap_legacy_keys(legacy)) == list(setup["state"])


@pytest.mark.parametrize("fault", ["stray", "missing", "shape"])
def test_load_torch_checkpoint_refuses_mismatches(setup, tmp_path, fault):
    state = dict(setup["state"])
    if fault == "stray":
        state["decoder.extra.weight"] = torch.zeros(3)
    elif fault == "missing":
        state.pop("backbone.conv1.weight")
    else:
        state["backbone.conv1.weight"] = torch.zeros(64, 3, 5, 5)
    torch.save(state, tmp_path / "w.pth")
    match = {"stray": "unexpected.*decoder.extra", "missing": "missing.*conv1",
             "shape": "size mismatch"}[fault]
    with pytest.raises((ValueError, RuntimeError), match=match):
        load_torch_checkpoint(tmp_path / "w.pth", _model(setup["cfg"]))


def test_port_checkpoint_and_reference_pth_are_told_apart(setup, tmp_path):
    """Both are files that torch.save wrote; the port's holds
    model/optimizer/scheduler/step and loads as "port"."""
    cfg = setup["cfg"]
    source = _model(cfg)
    source.load_state_dict(random_state_dict(source, seed=9))
    save_checkpoint(tmp_path / "last.pt", create_train_state(source, cfg, 10))
    torch.save(source.state_dict(), tmp_path / "ref.pt")
    for name, kind in (("last.pt", "port"), ("ref.pt", "state_dict")):
        model = _model(cfg)
        assert load_torch_checkpoint(tmp_path / name, model) == kind
        _assert_loaded(model, source.state_dict())


# --------------------------------------------------------------- eval.main --

# (atol, rtol) of each metric, with the largest difference measured on this
# CPU. Joint metrics ride on the forwards, which differ by float order
# (tests/test_torch_model.py): mm and px within 1e-2, measured 6.6e-4 mm
# (mpjpe, rel 2.9e-6) and 7.6e-5 px; shares within 1e-6, measured 0. The
# vertex metrics ride on the adaptive IK, which on joints that are
# hand-sized but not hand-shaped turns a joint difference d into a vertex
# difference of up to ~1e5 d (chip_smoke.py's serving comparison): rel 1e-2,
# measured 3.5e-3 (mpvpe, 0.92 mm of 265) and 6.1e-5 (pa_mpvpe); their shares
# within 1e-3 (a few of the 778 x 6 vertices crossing a threshold),
# measured 0.
EVAL_TOL = {"mpjpe": (1e-2, 0), "pa_mpjpe": (1e-2, 0), "mpjpe2d": (1e-2, 0),
            "mpvpe": (0, 1e-2), "pa_mpvpe": (0, 1e-2),
            "auc_v": (1e-3, 0), "norm_auc_v": (1e-3, 0), "pck_v": (1e-3, 0)}
SHARE_TOL = (1e-6, 0)  # auc_j, norm_auc_j, pck_j


@pytest.fixture(scope="module")
def evaluated(setup):
    """The same reference checkpoint through both entry points."""
    root = setup["root"]
    payload = {"state_dict": {f"model.{k}": v for k, v in _legacy(setup["state"]).items()}}
    out = {}
    for name in ("port", "jax"):
        (root / name).mkdir()
        torch.save(payload, root / name / "ref.ckpt")
    argv = ["--config", str(setup["cfg_path"]), "--batch-size", str(BATCH)]
    port_eval.main(argv + ["--checkpoint", str(root / "port" / "ref.ckpt"), "--device", "cpu"])
    # JAX's python reader (cv2, the same pixels as its native one): the native
    # loader's thread pool emits samples in completion order, and an epoch
    # that starts mid-stream would then not cover each sample exactly once
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_loader, "native_available", lambda: False)
        jax_eval.main(argv + ["--checkpoint", str(root / "jax" / "ref.ckpt")])
    for name in ("port", "jax"):
        out[name] = {split: json.loads((root / name / f"{split}.json").read_text())[0]
                     for split in ("val", "test")}
    return out


@pytest.mark.parametrize("split", ["val", "test"])
def test_eval_main_matches_jax(evaluated, split):
    ours, ref = evaluated["port"][split], evaluated["jax"][split]
    assert set(ours) == set(ref)
    assert f"{split}_mpvpe" in ours and f"{split}_pck_v" in ours  # vertex metrics ran
    for key, value in ref.items():
        atol, rtol = EVAL_TOL.get(key.removeprefix(f"{split}_"), SHARE_TOL)
        got = np.asarray(ours[key], np.float64)
        assert np.all(np.isfinite(got)), key
        np.testing.assert_allclose(got, np.asarray(value, np.float64), atol=atol, rtol=rtol,
                                   err_msg=key)


def test_eval_main_on_the_ports_own_checkpoint(setup, evaluated, tmp_path):
    """The port's CheckpointManager file of the same weights scores the val
    split exactly as the reference checkpoint does."""
    cfg = setup["cfg"]
    model = _model(cfg)
    model.load_state_dict(setup["state"])
    save_checkpoint(tmp_path / "last.pt", create_train_state(model, cfg, 10))
    results = port_eval.main(["--config", str(setup["cfg_path"]), "--batch-size", str(BATCH),
                              "--checkpoint", str(tmp_path / "last.pt"), "--device", "cpu",
                              "--no-vertices"])
    assert json.loads((tmp_path / "test.json").read_text())[0] == results["test"]
    assert "val_mpvpe" not in results["val"]
    for key, value in results["val"].items():
        assert value == evaluated["port"]["val"][key], key


# ------------------------------------------------------------------ over ranks

def test_eval_main_over_two_ranks(setup, evaluated):
    """``--num-devices 2`` on gloo CPU ranks: each rank reads 1 sample of
    each batch of 2, the samples dealt out by ordinal (the test split's 3
    shards do not divide over 2 ranks), and every rank gets the metrics of
    the union. Against the one-process run: the joint metrics within rel
    1e-6 (measured 1.2e-7; mpjpe2d exact). The vertex metrics ride on
    joints_cam through the IK, which on these random weights turns a
    difference of an ulp (the ranks' forwards run at batch 1 and on half the
    threads, and round in other orders) into up to rel 9.3e-3 (val mpvpe;
    ROADMAP.md section 3, "Explained"): they are held within
    test_eval_main_matches_jax's limits. Against JAX: those limits."""
    root = setup["root"]
    (root / "ranks").mkdir()
    torch.save({"state_dict": {f"model.{k}": v for k, v in _legacy(setup["state"]).items()}},
               root / "ranks" / "ref.ckpt")
    results = port_eval.main(["--config", str(setup["cfg_path"]), "--batch-size", str(BATCH),
                              "--checkpoint", str(root / "ranks" / "ref.ckpt"),
                              "--device", "cpu", "--num-devices", "2"])
    for split in ("val", "test"):
        ours, one, ref = results[split], evaluated["port"][split], evaluated["jax"][split]
        assert ours == json.loads((root / "ranks" / f"{split}.json").read_text())[0]
        assert set(ours) == set(one) == set(ref)
        for key, value in one.items():
            metric = key.removeprefix(f"{split}_")
            atol, rtol = EVAL_TOL.get(metric, SHARE_TOL)
            if "mpvpe" in metric or metric.endswith("_v"):
                np.testing.assert_allclose(ours[key], value, atol=atol, rtol=rtol, err_msg=key)
            else:
                np.testing.assert_allclose(ours[key], value, rtol=1e-6, atol=0, err_msg=key)
            np.testing.assert_allclose(ours[key], ref[key], atol=atol, rtol=rtol, err_msg=key)


def test_eval_refuses_a_split_it_cannot_deal_out(setup):
    """A split whose shards hold fewer samples than a pass reads: one
    process starts its stream again and scores samples twice, which ranks
    cannot repeat, so eval.py over ranks refuses it; the shards' own count
    passes."""
    from handmvnet_tpu_torch.train import build_dataloaders

    cfg = setup["cfg"]
    for test_size, ok in ((6, True), (8, False)):
        data = dataclasses.replace(cfg.data, batch_size=1,
                                   split_size_overrides={**SIZES, "test": test_size})
        (loader,) = build_dataloaders(dataclasses.replace(cfg, data=data), "cpu", ("test",),
                                      rank=1, world=2, by_sample=True)
        if ok:
            port_eval.check_dealt_out(loader, 2)
        else:
            with pytest.raises(ValueError, match="cannot be dealt out over 2 ranks: its shards "
                                                 "hold 6 samples, fewer than the 8"):
                port_eval.check_dealt_out(loader, 2)
