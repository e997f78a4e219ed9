"""The port's ImageNet backbone graft (handmvnet_tpu_torch/pretrained.py)
against the JAX package's (handmvnet_tpu/pretrained.py), on state_dicts the
tests write: nothing is downloaded.

A torchvision-layout ResNet-50 file is the port's own "50_paper" backbone
keys plus a ``layer4`` of three Bottlenecks and an ``fc`` head, as
torchvision names them. An hrnetv2-layout file is the port's HRNet keys
plus a classification head (``incre_modules``, ``final_layer``,
``classifier``) the pose model does not have.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from handmvnet_tpu import pretrained as jax_pretrained
from handmvnet_tpu.checkpoint import convert_torch_state_dict
from handmvnet_tpu_torch import train as train_driver
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.models.backbones.hrnet import HRNetBackbone
from handmvnet_tpu_torch.models.backbones.resnet import Bottleneck, ResNetBackbone
from handmvnet_tpu_torch.pretrained import (
    graft_backbone,
    load_state_dict_file,
    resolve_pretrained_path,
)
from torch_parity import write_train_shards

ROOT = Path(__file__).resolve().parents[1]
RESNET_CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
HRNET_CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet_HR.yaml"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: the test workers run side
    by side, and hundreds of small ops each spread over every core stall one
    another when the cores are oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random(sd: dict, seed: int) -> dict[str, torch.Tensor]:
    """The same keys and shapes with values drawn from a numpy seed: normal
    x 0.05, and running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(key, shape):
        if key.endswith("running_var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.standard_normal(shape) * 0.05

    return {k: v.clone() if k.endswith("num_batches_tracked") else
            torch.from_numpy(draw(k, tuple(v.shape)).astype(np.float32)) for k, v in sd.items()}


def torchvision_resnet50(seed: int = 0) -> dict[str, torch.Tensor]:
    layer4 = torch.nn.Sequential(Bottleneck(1024, 512, 2), Bottleneck(2048, 512),
                                 Bottleneck(2048, 512))
    sd = dict(ResNetBackbone().state_dict())
    sd.update({f"layer4.{k}": v for k, v in layer4.state_dict().items()})
    sd.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)})
    return _random(sd, seed)


def hrnetv2_imagenet(seed: int = 0) -> dict[str, torch.Tensor]:
    sd = dict(HRNetBackbone("w40").state_dict())
    sd.update({"incre_modules.0.0.conv1.weight": torch.zeros(32, 40, 1, 1),
               "final_layer.0.weight": torch.zeros(2048, 1024, 1, 1),
               "classifier.weight": torch.zeros(1000, 2048),
               "classifier.bias": torch.zeros(1000)})
    return _random(sd, seed)


def _own(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}


# ---------------------------------------------------------------- grafts


def test_resnet_graft_is_strict_after_dropping_layer4_and_fc():
    sd = torchvision_resnet50()
    backbone = ResNetBackbone()
    taken = graft_backbone(backbone, sd, "resnet", "paper")
    own = _own(backbone)
    assert taken == sorted(own)
    for key, value in own.items():
        assert torch.equal(value, sd[key]), key
    assert not any(k.startswith(("layer4", "fc")) for k in taken)


def test_resnet_graft_refuses_a_missing_key_or_shape():
    sd = torchvision_resnet50()
    del sd["layer3.5.bn3.running_var"]
    with pytest.raises(ValueError, match="strict.*layer3.5.bn3.running_var"):
        graft_backbone(ResNetBackbone(), sd, "resnet", "paper")
    sd = torchvision_resnet50()
    sd["layer1.0.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch at layer1.0.conv1.weight"):
        graft_backbone(ResNetBackbone(), sd, "resnet", "paper")


def test_hrnet_graft_is_partial():
    full = hrnetv2_imagenet()
    part = {k: v for k, v in full.items()
            if k.startswith(("conv1", "bn1", "layer1", "classifier", "final_layer"))}
    backbone = HRNetBackbone("w40")
    before = {k: v.clone() for k, v in _own(backbone).items()}
    taken = graft_backbone(backbone, part, "hrnet")
    assert taken and all(k.startswith(("conv1", "bn1", "layer1")) for k in taken)
    for key, value in _own(backbone).items():
        assert torch.equal(value, part[key] if key in taken else before[key]), key
    with pytest.raises(ValueError, match="matched no backbone key"):
        graft_backbone(backbone, {"classifier.weight": full["classifier.weight"]}, "hrnet")


@pytest.mark.parametrize("backbone", ["resnet", "hrnet"])
def test_graft_matches_jax_package_leaf_for_leaf(backbone):
    """From the same model weights and the same file, the port's graft and
    handmvnet_tpu.pretrained.graft_backbone give the same tree."""
    if backbone == "resnet":
        module, sd, variant = ResNetBackbone(), torchvision_resnet50(seed=1), "paper"
    else:
        module, sd, variant = HRNetBackbone("w40"), hrnetv2_imagenet(seed=1), "default"
        sd = {k: v for k, v in sd.items() if "stage4" not in k}  # partial: keep stage4's init
    variables = convert_torch_state_dict({f"backbone.{k}": v for k, v in module.state_dict().items()})
    variables["params"]["pose_net"] = {"bias": np.zeros(21, np.float32)}  # outside the backbone
    ref = jax_pretrained.graft_backbone(variables, {k: v.numpy() for k, v in sd.items()},
                                        backbone, variant)
    ref = load_flax_variables(ref)
    graft_backbone(module, sd, backbone, variant)
    ours = {f"backbone.{k}": v for k, v in _own(module).items()}
    assert set(ours) == {k for k in ref if k.startswith("backbone.")
                         and not k.endswith("num_batches_tracked")}
    for key, value in ours.items():
        assert torch.equal(value, ref[key]), key
    assert torch.equal(ref["pose_net.bias"], torch.zeros(21))


# ---------------------------------------------------------------- files, paths


def test_state_dict_files_load_in_every_form(tmp_path):
    sd = {"conv1.weight": torch.randn(4, 3, 3, 3), "bn1.running_var": torch.rand(4)}
    torch.save(sd, tmp_path / "plain.pth")
    torch.save({"state_dict": sd, "epoch": 7}, tmp_path / "nested.pth")
    np.savez(tmp_path / "arrays.npz", **{k: v.numpy() for k, v in sd.items()})
    for name in ("plain.pth", "nested.pth", "arrays.npz"):
        got = load_state_dict_file(tmp_path / name)
        assert set(got) == set(sd), name
        for key, value in sd.items():
            assert isinstance(got[key], torch.Tensor) and torch.equal(got[key], value), name
        ref = jax_pretrained.load_state_dict_file(tmp_path / name)
        assert set(ref) == set(got)


@pytest.mark.parametrize("config,name", [
    (RESNET_CONFIG, "resnet50_imagenet.pth"), (RESNET_CONFIG, "resnet50.npz"),
    (HRNET_CONFIG, "hrnetv2_w40_imagenet_pretrained.pth")])
def test_resolve_pretrained_path_finds_file_and_directory(tmp_path, config, name):
    (tmp_path / name).write_bytes(b"")
    for raw in (tmp_path, tmp_path / name):
        mcfg = dataclasses.replace(Config.from_yaml(config).model,
                                   backbone_pretrained_path=str(raw))
        assert resolve_pretrained_path(mcfg) == tmp_path / name
        assert jax_pretrained.resolve_pretrained_path(mcfg) == tmp_path / name
    mcfg = dataclasses.replace(mcfg, backbone_pretrained_path=str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="absent"):
        resolve_pretrained_path(mcfg)


# ---------------------------------------------------------------- train.py


def _tiny_config(tmp_path: Path, weights: Path, shard_data: dict) -> str:
    raw = yaml.safe_load(RESNET_CONFIG.read_text())
    raw["data"].update(image_size=32, heatmap_size=4, batch_size=2, **shard_data)
    raw["model"].update(selected_views=[0, 1], backbone_pretrained=True,
                        backbone_pretrained_path=str(weights))
    path = tmp_path / f"tiny_{weights.stem}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


def test_train_grafts_before_resume(tmp_path, capsys):
    """train.py grafts the file it is given into the fresh model; with
    --resume the restored checkpoint wins over the graft."""
    imagenet = torchvision_resnet50(seed=2)
    torch.save(imagenet, tmp_path / "imagenet.pth")
    torch.save({k: torch.zeros_like(v) for k, v in imagenet.items()}, tmp_path / "zeros.pth")
    out = tmp_path / "run"
    common = ["--steps-per-epoch", "1", "--output-dir", str(out), "--device", "cpu"]
    shard_data = write_train_shards(tmp_path / "shards")
    train_driver.main(["--config", _tiny_config(tmp_path, tmp_path / "imagenet.pth", shard_data),
                       "--epochs", "1", *common])
    assert "loaded pretrained resnet backbone" in capsys.readouterr().out
    first = torch.load(out / "checkpoints" / "last.pt", weights_only=True)["model"]
    lr = Config.from_yaml(RESNET_CONFIG).train.lr
    for key in ("backbone.conv1.weight", "backbone.layer3.5.conv3.weight"):
        # one AdamW step from the graft: within a few lr of the file's values
        assert float((first[key] - imagenet[key.removeprefix("backbone.")]).abs().max()) < 3 * lr

    # resume with a config whose graft would zero the backbone
    train_driver.main(["--config", _tiny_config(tmp_path, tmp_path / "zeros.pth", shard_data),
                       "--epochs", "2", "--resume", *common])
    second = torch.load(out / "checkpoints" / "last.pt", weights_only=True)
    assert second["step"] == 2
    for key in ("backbone.conv1.weight", "backbone.layer3.5.conv3.weight"):
        assert float((second["model"][key] - first[key]).abs().max()) < 3 * lr, key
        assert float(second["model"][key].abs().max()) > 0.05  # not the zeros' graft
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
