"""Port parity, the decode cache (handmvnet_tpu_torch/data/cache.py and the
readers' ``data.cache_decoded``) against handmvnet_tpu's on the CPU, on 3
train and 3 test shards of 4 samples that the JAX package writes (as
tests/test_decode_cache.py does): the store's layout and directory name, the
samples and their epoch order over two epochs on every split, a JAX-built
store served as it is, invalidation, ranks' shares, the loader with
make_device_prepare, and the card's decoder kept out of the CPU's stores.

Tolerances: samples, frames and order exact; make_device_prepare's rgb 1e-5
and heatmap 1e-6 (tests/test_torch_data.py's).
"""

import dataclasses
import filecmp
import json
import os
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch_parity import assert_same, write_train_shards

from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.config import DataConfig as JaxDataConfig
from handmvnet_tpu.data import ho3d as jax_ho3d
from handmvnet_tpu.data import loader as jax_loader
from handmvnet_tpu.data.cache import DecodedCache as JaxDecodedCache
from handmvnet_tpu.data.synthetic import write_synthetic_ho3d_shards as jax_write_shards
from handmvnet_tpu.train import make_device_prepare as jax_make_device_prepare
from handmvnet_tpu_torch import eval as port_eval
from handmvnet_tpu_torch import infer, sanity, train
from handmvnet_tpu_torch.config import Config, DataConfig
from handmvnet_tpu_torch.data import cache, ho3d, loader
from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "release" / "HO3D_HandMvNet.yaml"

SIZES = {"train": 4, "train+val": 12, "val": 8, "test": 12}


class TinyHO3D(ho3d.HO3DDataset):
    train_pattern = "HO3D_mv_train-{000000..000002}.tar"
    test_pattern = "HO3D_mv_test-{000000..000002}.tar"


class JaxTinyHO3D(jax_ho3d.HO3DDataset):
    train_pattern = TinyHO3D.train_pattern
    test_pattern = TinyHO3D.test_pattern
    split_sizes = SIZES


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ho3d_cache")
    jax_write_shards(d, num_shards=3, samples_per_shard=4, split="train",
                     consistent_geometry=True)
    jax_write_shards(d, num_shards=3, samples_per_shard=4, split="test", seed=3)
    return d


def _cfgs(dataset_dir, cache_dir, **kw):
    kw = {"dataset_dir": str(dataset_dir), "cache_decoded": True, "cache_dir": str(cache_dir),
          "split_size_overrides": SIZES, **kw}
    return DataConfig(**kw), JaxDataConfig(**kw)


def _ids(ds) -> list[str]:
    return [s["mv_sample_id"] for s in ds]


def test_decoded_cache_matches_jax(shard_dir, tmp_path):
    """One pass of parsed samples into both stores: the same directory name,
    frames.u8 byte for byte, meta.json's n and frame shape, equal labels;
    and both read back the same samples in the same shuffled order."""
    samples = list(jax_ho3d.HO3DDataset(JaxDataConfig(dataset_dir=str(shard_dir)), "test",
                                        use_native=False))[:6]
    identity = {"name": "ho3d", "split": "test", "views": [0, 1, 2, 3, 4], "denom": 1}
    ours = cache.DecodedCache(tmp_path / "ours", identity)
    ref = JaxDecodedCache(tmp_path / "ref", identity)
    assert ours.build(iter(samples)) == ref.build(iter(samples)) == 6
    assert ours.dir.name == ref.dir.name and ours.complete
    assert filecmp.cmp(ours.dir / "frames.u8", ref.dir / "frames.u8", shallow=False)
    meta = [json.loads((c.dir / "meta.json").read_text()) for c in (ours, ref)]
    assert meta[0] == meta[1] and meta[0]["n"] == 6
    assert meta[0]["frame_shape"] == [5, 480, 640, 3]
    labels = [pickle.loads((c.dir / "labels.pkl").read_bytes()) for c in (ours, ref)]
    assert_same(labels[0], labels[1])
    for epoch in (0, 1):
        got = list(ours.iter_samples(shuffle=True, epoch=epoch))
        want = list(ref.iter_samples(shuffle=True, epoch=epoch))
        assert_same([dict(s, full_rgb=np.asarray(s["full_rgb"])) for s in got],
                     [dict(s, full_rgb=np.asarray(s["full_rgb"])) for s in want])
    assert len(ours) == 6


@pytest.mark.parametrize("denom", [1, 2])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_cached_dataset_matches_jax_over_two_epochs(shard_dir, tmp_path, split, denom):
    """HO3DDataset(cache_decoded=True, device="cpu") against JAX's python
    reader: each builds its own store (of the same name), then two epochs of
    the same samples, bitwise, in the same order: the train split's
    full-epoch shuffle, val and test in shard order."""
    cfg, jcfg = _cfgs(shard_dir, tmp_path / "ours", add_val_to_train=True,
                      decode_scale_denom=denom)
    ours = TinyHO3D(cfg, split, device="cpu")
    ref = JaxTinyHO3D(dataclasses.replace(jcfg, cache_dir=str(tmp_path / "ref")), split,
                      use_native=False)
    assert ours._cache().dir.name == ref._cache().dir.name
    epochs = []
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == {"train": 12, "val": 8, "test": 12}[split]
        assert_same(got, want)
        epochs.append(_ids(got))
    assert got[0]["full_rgb"].shape == (5, 480 // denom, 640 // denom, 3)
    assert sorted(epochs[0]) == sorted(epochs[1])
    assert (epochs[0] != epochs[1]) == (split == "train")


def test_jax_built_cache_is_served_without_a_rebuild(shard_dir, tmp_path):
    cfg, jcfg = _cfgs(shard_dir, tmp_path / "cache")
    ref = JaxTinyHO3D(jcfg, "test", use_native=False)
    want = list(ref)
    meta = ref._cache().dir / "meta.json"
    stamp = meta.stat().st_mtime_ns
    ours = TinyHO3D(cfg, "test", device="cpu")
    assert ours._cache().dir == ref._cache().dir and ours._cache().complete
    assert_same(list(ours), want)
    assert meta.stat().st_mtime_ns == stamp
    assert sorted(p.name for p in ref._cache().dir.parent.iterdir()) == [ref._cache().dir.name]


def test_second_epoch_serves_without_tars(shard_dir, tmp_path):
    """After the build the tars may go: the store is the steady state (the
    identity was taken at first use)."""
    work = tmp_path / "data"
    shutil.copytree(shard_dir, work)
    cfg, _ = _cfgs(work, tmp_path / "cache")
    ds = TinyHO3D(cfg, "test", device="cpu")
    first = _ids(ds)
    for tar in work.glob("*.tar"):
        tar.unlink()
    assert _ids(ds) == first and len(first) == 12


@pytest.mark.parametrize("change", ["mtime", "size"])
def test_changed_shard_invalidates_the_cache(shard_dir, tmp_path, change):
    work = tmp_path / "data"
    shutil.copytree(shard_dir, work)
    cfg, _ = _cfgs(work, tmp_path / "cache")
    before = TinyHO3D(cfg, "test", device="cpu")._cache().dir
    tar = sorted(work.glob("HO3D_mv_test-*.tar"))[0]
    if change == "mtime":
        os.utime(tar, (time.time() + 100, time.time() + 100))
    else:
        stamp = tar.stat()
        with open(tar, "ab") as f:
            f.write(b"\0" * 512)
        os.utime(tar, ns=(stamp.st_atime_ns, stamp.st_mtime_ns))
    assert TinyHO3D(cfg, "test", device="cpu")._cache().dir != before


def test_cache_without_meta_is_rebuilt(shard_dir, tmp_path):
    cfg, _ = _cfgs(shard_dir, tmp_path / "cache")
    ds = TinyHO3D(cfg, "test", device="cpu")
    store = ds._cache()
    store.dir.mkdir(parents=True)
    (store.dir / "frames.u8").write_bytes(b"garbage")  # a build that died midway
    assert not store.complete
    samples = list(ds)
    assert len(samples) == 12 and store.complete
    assert samples[0]["full_rgb"].shape == (5, 480, 640, 3)


def test_ranks_build_disjoint_shares_of_the_split(shard_dir, tmp_path):
    """Ranks 0 and 1 of 2: separate stores, disjoint shares whose union is
    the split, each as JAX's rank reads it."""
    cfg, jcfg = _cfgs(shard_dir, tmp_path / "cache")
    parts, dirs = [], set()
    for rank in range(2):
        ds = TinyHO3D(cfg, "test", split_index=rank, split_count=2, device="cpu")
        ref = JaxTinyHO3D(dataclasses.replace(jcfg, cache_dir=str(tmp_path / "ref")), "test",
                          split_index=rank, split_count=2, use_native=False)
        parts.append(set(_ids(ds)))
        assert _ids(ds) == _ids(ref)
        dirs.add(ds._cache().dir)
    assert len(dirs) == 2 and parts[0] and parts[1]
    assert not parts[0] & parts[1] and len(parts[0] | parts[1]) == 12


def test_card_stores_never_share_a_cpu_directory(shard_dir, tmp_path):
    """A card's identity records its decoder ("nvjpeg"); the CPU's records
    JAX's python reader's ("any" at d = 1, "python" above), so it hashes to
    JAX's directory and never to a card's. by_sample joins the identity."""
    dirs = {}
    for denom in (1, 2):
        cfg, jcfg = _cfgs(shard_dir, tmp_path / "cache", decode_scale_denom=denom)
        card = TinyHO3D(cfg, "val", device="cuda")._cache()
        cpu = TinyHO3D(cfg, "val", device="cpu")._cache()
        assert card.identity["reader"] == "nvjpeg"
        assert cpu.identity["reader"] == ("any" if denom == 1 else "python")
        assert cpu.dir == JaxTinyHO3D(jcfg, "val", use_native=False)._cache().dir
        dirs[denom] = {card.dir, cpu.dir,
                       TinyHO3D(cfg, "val", device="cpu", by_sample=True)._cache().dir}
    assert len(dirs[1] | dirs[2]) == 6


def test_default_cache_dir_is_under_the_dataset(shard_dir):
    cfg = DataConfig(dataset_dir=str(shard_dir), cache_decoded=True)
    assert cfg.decoded_cache_dir == os.path.join(str(shard_dir), "decoded_cache")
    assert TinyHO3D(cfg, "val", device="cpu")._cache().dir.parent == shard_dir / "decoded_cache"


def test_cache_through_batchloader_with_make_device_prepare(shard_dir, tmp_path):
    """Three batches of the cached test split through BatchLoader and
    make_device_prepare, against JAX's loader and make_device_prepare over
    its own store: the same keys, labels exact, rgb 1e-5, heatmap 1e-6."""
    data_cfg, jdata_cfg = _cfgs(shard_dir, tmp_path / "ours", batch_size=4)
    cfg, jcfg = Config(data=data_cfg), JaxConfig(
        data=dataclasses.replace(jdata_cfg, cache_dir=str(tmp_path / "ref")))
    ours = list(loader.BatchLoader(TinyHO3D(data_cfg, "test", device="cpu"), 4, 3,
                                   device_prepare=train.make_device_prepare(cfg, "cpu")))
    refs = list(jax_loader.BatchLoader(JaxTinyHO3D(jcfg.data, "test", use_native=False), 4, 3,
                                       device_prepare=jax_make_device_prepare(jcfg, False)))
    assert len(ours) == len(refs) == 3
    for got, ref in zip(ours, refs):
        assert set(got) == set(ref)
        for key, value in ref.items():
            want = np.asarray(value)
            assert got[key].shape == want.shape and got[key].numpy().dtype == want.dtype, key
            atol = {"rgb": 1e-5, "heatmap": 1e-6}.get(key, 0.0)
            np.testing.assert_allclose(got[key].numpy(), want, atol=atol, rtol=0, err_msg=key)


@pytest.fixture
def one_thread():
    """One intra-op thread for the drivers' ResNet-50 steps: beside five
    other test workers of eight threads each, their small ops stall (333 s
    in one full run, against ~20 s alone). The count changes no result."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_drivers_run_on_the_cpu_with_the_cache_at_denom_2(tmp_path, one_thread):
    """train.py, eval.py, infer.py and sanity.py with --device cpu on the
    release layout's shards, cache_decoded on and decode_scale_denom 2 (64^2
    crops): the train and val stores are built at 240 x 320, every logged
    value is finite, eval.py's metrics with the cache equal those without
    it exactly, infer.py draws its panels and sanity.py passes."""
    data = write_train_shards(tmp_path / "data")
    write_synthetic_ho3d_shards(tmp_path / "data", num_shards=3, samples_per_shard=2,
                                split="test", seed=3, consistent_geometry=True, device="cpu")
    data["split_size_overrides"]["test"] = 6

    def config(name: str, **options) -> str:
        raw = yaml.safe_load(CONFIG.read_text())
        raw["data"].update(image_size=64, heatmap_size=8, batch_size=2, decode_scale_denom=2,
                           **data, **options)
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(raw, sort_keys=False))
        return str(path)

    cached = config("cached", cache_decoded=True)
    out = tmp_path / "run"
    train.main(["--config", cached, "--epochs", "1", "--steps-per-epoch", "2", "--output-dir",
                str(out), "--device", "cpu"])
    (record,) = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(v) for v in record.values() if isinstance(v, float))
    stores = sorted((tmp_path / "data" / "decoded_cache").iterdir())
    assert [p.name.split("_")[1] for p in stores] == ["train", "val"]
    for store in stores:
        assert json.loads((store / "meta.json").read_text())["frame_shape"] == [5, 240, 320, 3]

    argv = ["--checkpoint", str(out / "checkpoints" / "last.pt"), "--no-vertices",
            "--batch-size", "2", "--device", "cpu"]
    with_cache = port_eval.main(["--config", cached, *argv])
    assert with_cache == port_eval.main(["--config", config("uncached"), *argv])
    assert np.isfinite(with_cache["test"]["test_mpjpe"])
    infer.main(["--config", cached, "--checkpoint", str(out / "checkpoints" / "last.pt"),
                "--output-dir", str(tmp_path / "infer"), "--device", "cpu"])
    assert (tmp_path / "infer" / "joints2d.png").is_file()
    assert sanity.main(["--config", cached, "--device", "cpu"])["extrinsics"]["consistent"]
