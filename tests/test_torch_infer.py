"""Port parity, the user-facing drivers: handmvnet_tpu_torch.infer against
handmvnet_tpu's infer step (model.apply, then joints_to_vertices_fn) on
shared weights, ``infer.main --device cpu`` end to end, its refusals, where
``model.backbone_int8`` takes effect, and the rank counts of train.py
(``train.num_devices``) and eval.py (the divisor rule) against the JAX
drivers' rules, on the CPU.

The model is tests/test_torch_eval.py's: 64^2 crops, 2 views, 3 fusion
blocks, ResNet-50 "paper", LeCun-scaled weights from a numpy seed, with the
last GCN layer fitted so that the model predicts a hand (``_fit_hand_head``).
JAX's own tests/test_infer.py runs its main and is marked slow; these hold
the port against JAX's functions.
"""

import argparse
import dataclasses
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import handmvnet_tpu.eval as jax_eval
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.models.joints_to_vertices import joints_to_vertices_fn as jax_j2v
from handmvnet_tpu.models.mano import ManoLayer as JaxManoLayer
from handmvnet_tpu.models.mano import synthetic_mano_model
from handmvnet_tpu_torch import eval as port_eval
from handmvnet_tpu_torch import infer, train
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch, synthetic_hand_joints
from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards
from handmvnet_tpu_torch.engine import save_checkpoint
from handmvnet_tpu_torch.eval_fps import build_model
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.models.joints_to_vertices import joints_to_vertices_fn
from handmvnet_tpu_torch.models.mano import ManoLayer
from handmvnet_tpu_torch.models.mano import synthetic_mano_model as port_synthetic_mano_model
from handmvnet_tpu_torch.train_step import create_train_state
from torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parents[1]
IMAGE, HEATMAP, VIEWS = 64, 8, 2
# joints_cam: tests/test_torch_model.py's limit (m), measured 2.3e-5 m on this
# CPU (the fp32 forwards' float order; joints_crop_img 1.1e-2 px, heatmap
# 6.0e-6). vertices: mm, against JAX's mesh stage on the same joints, measured
# 7.0e-3 mm on vertices of up to 127 mm; against JAX's whole step, whose
# joints differ by the forward's 2.3e-5 m, the vertices differ by 2.5e-2 mm.
JOINTS_ATOL, VERTICES_ATOL = 5e-4, 2e-2


def hand_joints(batch: int) -> np.ndarray:
    """Posed hands [batch, 21, 3] in m, the wrist at 0 (root-relative)."""
    joints = synthetic_hand_joints(ManoLayer(port_synthetic_mano_model()), batch, seed=1).numpy()
    return (joints - joints[:, :1]).astype(np.float64) / 1000.0


def _fit_hand_head(variables: dict, cfg: Config, data: dict) -> None:
    """Fit the last GCN layer's weights (minimum-norm least squares, float64;
    bias 0) so that the model predicts a posed hand for each sample of
    ``data`` (``hand_joints``), in place. Random weights give joints that
    are at best hand-sized, never hand-shaped, and on those the mesh stage's
    IK turns a joint difference d into a vertex difference of up to ~1e5 d
    (ROADMAP.md section 3, "Explained"): 0.26 mm from the same joints in
    both packages. So does a straight finger (the flat mean hand), where
    the IK's arccos of a bend near 0 is steepest."""
    params = variables["params"]["joints_decoder"]["joints_gcn3"]
    params["bias"] = np.zeros_like(params["bias"])
    model = HandMvNet(cfg.model, IMAGE, HEATMAP).double().eval()
    model.load_state_dict(load_flax_variables(variables))
    seen = {}
    gcn3 = model.joints_decoder.joints_gcn3
    hook = gcn3.register_forward_hook(lambda m, inputs, out: seen.update(zip("hb", inputs)))
    with torch.no_grad():
        model(*(torch.from_numpy(data[k]).double() for k in ("rgb", "bboxes", "intrinsic")))
    hook.remove()
    k, _, c, d = gcn3.weight.shape
    propagated = torch.einsum("knm,bmc->bnkc", seen["b"], seen["h"]).reshape(-1, k * c)
    target = hand_joints(len(data["rgb"])).reshape(-1, d)
    weight = np.linalg.lstsq(propagated.numpy(), target, rcond=None)[0]
    params["weight"] = weight.reshape(k, 1, c, d).astype(np.float32)


def _raw_config(root: Path) -> dict:
    return {
        "name": "inferparity",
        "data": {"name": "ho3d", "batch_size": 1, "dataset_dir": str(root / "data"),
                 "image_size": IMAGE, "heatmap_size": HEATMAP, "augment": False,
                 "mano_models_dir": str(root / "no_mano"),
                 "split_size_overrides": {"test": 3}},
        "model": {"selected_views": list(range(VIEWS)), "fusion": "cross_attn",
                  "fusion_layers": 3, "pos_enc": ["pos2d", "crop", "sin"], "use_gcn": True,
                  "backbone": "resnet", "backbone_type": "50_paper",
                  "backbone_early_return": 3, "backbone_channels": [1024],
                  "backbone_pretrained": False},
        "train": {"root_relative": True},
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The config file, 3 test shards of 1 sample, and shared random weights
    (flax variables and the port's state_dict)."""
    root = tmp_path_factory.mktemp("infer")
    write_synthetic_ho3d_shards(root / "data", num_shards=3, samples_per_shard=1,
                                num_views=VIEWS, split="test", seed=3,
                                consistent_geometry=True, device="cpu")
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_raw_config(root)))
    data = jax_synthetic_batch(batch_size=2, num_views=VIEWS, image_size=IMAGE,
                               heatmap_size=HEATMAP, seed=0, with_heatmaps=False)
    args = tuple(jnp.asarray(data[k]) for k in ("rgb", "bboxes", "intrinsic"))
    flax_model = FlaxHandMvNet(cfg=JaxConfig.from_yaml(cfg_path).model, image_size=IMAGE,
                               heatmap_size=HEATMAP)
    variables = random_flax_variables(flax_model, 23, *args)
    _fit_hand_head(variables, Config.from_yaml(cfg_path), data)
    return {"root": root, "cfg_path": cfg_path, "data": data, "args": args,
            "flax_model": flax_model, "variables": variables,
            "state": load_flax_variables(variables)}


def _port_model(setup) -> HandMvNet:
    cfg = Config.from_yaml(setup["cfg_path"])
    model = HandMvNet(cfg.model, image_size=IMAGE, heatmap_size=HEATMAP).eval()
    model.load_state_dict(setup["state"])
    return model


def test_infer_step_matches_jax(setup):
    """infer_step (forward, then the mesh stage on joints_cam * 1000 over
    the synthetic MANO model) against JAX's infer step on the same weights
    and batch (handmvnet_tpu/infer.py:127-131): the forward's outputs, and
    the vertices against JAX's mesh stage on the port's joints."""
    variables, args = setup["variables"], setup["args"]
    jax_mesh_stage = jax.jit(jax_j2v(JaxManoLayer(synthetic_mano_model())))

    def step(rgb, bboxes, intr):
        out = setup["flax_model"].apply(variables, rgb, bboxes, intr)
        out["vertices"] = jax_mesh_stage(out["joints_cam"] * 1000.0)
        return out

    ref = {k: np.asarray(v) for k, v in jax.jit(step)(*args).items()}
    mesh_stage = joints_to_vertices_fn(ManoLayer(synthetic_mano_model()))
    batch = {k: torch.from_numpy(setup["data"][k]) for k in ("rgb", "bboxes", "intrinsic")}
    ours = {k: v.numpy() for k, v in infer.infer_step(_port_model(setup), mesh_stage,
                                                      batch).items()}
    assert set(ours) == set(ref)
    assert ours["vertices"].shape == (2, 778, 3)
    np.testing.assert_allclose(ref["joints_cam"], hand_joints(2), atol=1e-4)  # the fit
    for key in ("joints_cam", "joints_crop_img", "heatmap"):  # test_torch_model.py's limits
        atol = {"joints_cam": JOINTS_ATOL, "joints_crop_img": 2e-2, "heatmap": 1e-4}[key]
        np.testing.assert_allclose(ours[key], ref[key], atol=atol, rtol=0, err_msg=key)
    same_joints = np.asarray(jax_mesh_stage(jnp.asarray(ours["joints_cam"]) * 1000.0))
    np.testing.assert_allclose(ours["vertices"], same_joints, atol=VERTICES_ATOL, rtol=0)


def _main(setup, tmp_path, *flags) -> dict:
    out = infer.main(["--config", str(setup["cfg_path"]), "--output-dir", str(tmp_path / "vis"),
                      "--device", "cpu", *flags])
    for name in infer.PANELS:
        assert (tmp_path / "vis" / name).stat().st_size > 0, name
    return out


@pytest.mark.parametrize("source", ["synthetic", "checkpoint", "test_shards"])
def test_infer_main_writes_the_panels(setup, tmp_path, source, capsys):
    """The four panels, with random weights on a synthetic batch, with the
    port's .pt checkpoint (whose weights the step then uses), and on the
    first batch of the test split; the absent MANO assets warn."""
    if source == "synthetic":
        out = _main(setup, tmp_path, "--synthetic", "--batch-size", "2")
        assert out["vertices"].shape == (2, 778, 3)
    elif source == "checkpoint":
        cfg = Config.from_yaml(setup["cfg_path"])
        save_checkpoint(tmp_path / "last.pt", create_train_state(_port_model(setup), cfg, 10))
        out = _main(setup, tmp_path, "--synthetic", "--checkpoint", str(tmp_path / "last.pt"))
        data = synthetic_batch(1, VIEWS, IMAGE, HEATMAP, with_heatmaps=False)
        with torch.inference_mode():
            want = _port_model(setup)(*(torch.from_numpy(data[k])
                                        for k in ("rgb", "bboxes", "intrinsic")))
        torch.testing.assert_close(out["joints_cam"], want["joints_cam"], rtol=0, atol=0)
    else:
        out = _main(setup, tmp_path)
        cfg = Config.from_yaml(setup["cfg_path"])
        batches = iter(train.build_dataloaders(cfg, "cpu", ("test",))[0])
        first = next(batches)
        batches.close()
        assert out["joints_crop_img"].shape == (1, VIEWS, 21, 2)
        assert out["heatmap"].shape == (1, VIEWS, 21, HEATMAP, HEATMAP)
        with torch.inference_mode():  # random weights from seed 0, as infer's
            want = build_model(cfg, VIEWS, IMAGE, "cpu")(first["rgb"], first["bboxes"],
                                                          first["intrinsic"])
        torch.testing.assert_close(out["joints_cam"], want["joints_cam"], rtol=0, atol=0)
    printed = capsys.readouterr().out
    assert "synthetic MANO stand-in" in printed
    assert ("no checkpoint given" in printed) == (source != "checkpoint")
    assert all(torch.isfinite(v).all() for v in out.values())


def test_infer_refuses_view_mesh_and_orbax(setup, tmp_path):
    """A --view-mesh whose view axis does not divide the config's views (JAX's
    check, handmvnet_tpu/infer.py:102-116; a mesh that divides runs, see
    tests/test_torch_view_parallel.py), and an orbax directory."""
    argv = ["--config", str(setup["cfg_path"]), "--synthetic", "--device", "cpu"]
    with pytest.raises(SystemExit, match="the config's views divisible by 3 \\(got 2\\)"):
        infer.main(argv + ["--view-mesh", "1x3"])
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        infer.main(argv + ["--checkpoint", str(tmp_path / "orbax_dir")])


def test_entry_points_default_to_the_card(setup):
    """Without --device each driver asks for the card, which this CPU lacks."""
    config = ["--config", str(setup["cfg_path"])]
    for main, argv in ((infer.main, ["--synthetic"]), (port_eval.main, ["--checkpoint", "w.pt"]),
                       (train.main, [])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(config + argv)


def test_backbone_int8_refused_on_resnet_ignored_on_hrnet():
    """JAX quantises the ResNet backbone's convs in eval mode under the flag
    (handmvnet_tpu/models/handmvnet.py:70) and ignores it on HRNet (:59-62).
    The port refused it on ResNet until ops/quant.py landed; now the ResNet
    model is built with the int8 convs (Q8Conv, tests/test_torch_quant.py
    holds them against JAX's), and HRNet still ignores the flag."""
    from handmvnet_tpu_torch.ops.quant import Q8Conv

    cfg = Config.from_yaml(ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml")
    model = HandMvNet(dataclasses.replace(cfg.model, backbone_int8=True))
    assert any(isinstance(m, Q8Conv) for m in model.backbone.modules())
    assert not any(isinstance(m, Q8Conv) for m in HandMvNet(cfg.model).modules())
    hr = Config.from_yaml(ROOT / "configs" / "release" / "HO3D_HandMvNet_HR.yaml")
    assert not any(isinstance(m, Q8Conv)
                   for m in HandMvNet(dataclasses.replace(hr.model, backbone_int8=True)).modules())


# ------------------------------------------------------------------ rank counts


@pytest.mark.parametrize("arg,configured,cards,want", [
    (0, 0, 1, 1), (0, 0, 4, 4), (0, 2, 4, 2), (3, 2, 4, 3), (0, 1, 2, 1), (2, 0, 1, 2)])
def test_rank_count_is_argument_then_config_then_cards(monkeypatch, arg, configured, cards,
                                                       want):
    """handmvnet_tpu/train.py:250: args.num_devices or cfg.train.num_devices
    or every local device (the cards; one CPU with --device cpu)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    cfg = Config.from_dict({"train": {"num_devices": configured}})
    assert train.rank_count(arg, cfg, "cuda") == want
    assert train.rank_count(arg, cfg, "cpu") == (arg or configured or 1)


@pytest.mark.parametrize("configured,flag,spawned", [(0, [], None), (1, [], None),
                                                     (2, [], 2), (2, ["--num-devices", "1"], None),
                                                     (0, ["--num-devices", "3"], 3)])
def test_train_main_starts_the_counted_ranks(tmp_path, monkeypatch, configured, flag, spawned):
    """One rank trains in this process with no process group; more go
    through start_local_ranks (not started here)."""
    calls = []
    monkeypatch.setattr(train, "start_local_ranks",
                        lambda fn, argv, n, device_type: calls.append(("spawn", n)))
    monkeypatch.setattr(train, "_train", lambda args, device, group=None: calls.append(
        ("train", group)))
    raw = yaml.safe_load((ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml").read_text())
    raw["train"]["num_devices"] = configured
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    train.main(["--config", str(path), "--device", "cpu", *flag])
    assert calls == ([("spawn", spawned)] if spawned else [("train", None)])


def _jax_eval_divisor_rule():
    """The lines of handmvnet_tpu/eval.py's main that pick its devices, read
    from its source."""
    source = inspect.getsource(jax_eval.main)
    (block,) = re.findall(r"\n( *usable = max\(1, min\(n_dev, args\.batch_size\)\)\n"
                          r" *while args\.batch_size % usable:\n *usable -= 1\n)", source)
    code = compile(inspect.cleandoc("\n" + block), "handmvnet_tpu/eval.py", "exec")

    def rule(n_dev: int, batch: int) -> int:
        scope = {"n_dev": n_dev, "args": argparse.Namespace(batch_size=batch)}
        exec(code, scope)
        return scope["usable"]

    return rule


@pytest.mark.parametrize("batch", [1, 6, 16, 30])
@pytest.mark.parametrize("devices", [1, 2, 3, 4, 5, 8, 32])
def test_eval_ranks_follow_jax_divisor_rule(devices, batch):
    usable = port_eval.eval_ranks(batch, devices)
    assert usable == _jax_eval_divisor_rule()(devices, batch)
    assert batch % usable == 0 and usable <= devices
