"""Port parity, the data path's serving side: handmvnet_tpu_torch's tar
readers, label parsing, loader, JPEG decode, crop/resize/heatmap
preprocessing and ``make_device_prepare`` against the JAX package's, on the
CPU, on shards that handmvnet_tpu.data.synthetic.write_synthetic_ho3d_shards
writes (5 views of 480 x 640).

Tolerances: readers, parsing and collation exact; the CPU decode bit-exact
(both are cv2); preprocessing fp32 absolute, with the largest error
measured on this CPU beside each.
"""

import dataclasses
import filecmp
import lzma
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.config import DataConfig as JaxDataConfig
from handmvnet_tpu.data import dexycb as jax_dexycb
from handmvnet_tpu.data import ho3d as jax_ho3d
from handmvnet_tpu.data import loader as jax_loader
from handmvnet_tpu.data import mvhand as jax_mvhand
from handmvnet_tpu.data import webdataset as jax_wds
from handmvnet_tpu.data.pipeline import preprocess_views as jax_preprocess_views
from handmvnet_tpu.data.synthetic import write_synthetic_ho3d_shards as jax_write_shards
from handmvnet_tpu.ops import heatmap as jax_heatmap
from handmvnet_tpu.ops import resize as jax_resize
from handmvnet_tpu.train import make_device_prepare as jax_make_device_prepare
from handmvnet_tpu_torch import train
from handmvnet_tpu_torch.config import Config, DataConfig
from handmvnet_tpu_torch.data import dexycb, ho3d, jpeg, loader, mvhand, webdataset
from handmvnet_tpu_torch.data.pipeline import preprocess_views
from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards
from handmvnet_tpu_torch.ops import heatmap, resize

DATASETS = {"ho3d": (ho3d.HO3DDataset, jax_ho3d.HO3DDataset),
            "dexycb": (dexycb.DexYCBDataset, jax_dexycb.DexYCBDataset),
            "mvhand": (mvhand.MVHandDataset, jax_mvhand.MVHandDataset)}
SIZES = {"val": 4, "test": 6}  # the shards' sample counts below


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """HO3D's layout in full: 9 train shards (val reads the first and the
    last), 3 test shards, 2 samples each. The train family has coherent
    geometry (a hand drawn where the labels put it), the test family random
    boxes and joints (some off their crops)."""
    d = tmp_path_factory.mktemp("ho3d")
    jax_write_shards(d, num_shards=9, samples_per_shard=2, split="train",
                     consistent_geometry=True)
    jax_write_shards(d, num_shards=3, samples_per_shard=2, split="test", seed=3)
    return d


def _data_cfgs(shard_dir, **kw):
    kw = {"dataset_dir": str(shard_dir), "split_size_overrides": SIZES, **kw}
    return DataConfig(**kw), JaxDataConfig(**kw)


def _assert_same(ours, ref, where=""):
    """Exact equality of nested samples: arrays by value and dtype."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), where
        for k in ref:
            _assert_same(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert isinstance(ours, (np.ndarray, np.generic)), where
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, where
        np.testing.assert_array_equal(ours, ref, err_msg=where)
    else:
        assert ours == ref, where


# ------------------------------------------------------------------ readers --

@pytest.mark.parametrize("url", [
    "data/HO3D_mv_train-{000000..00008}.tar", "DexYCB_mv_test-{000000..000019}.tar",
    "a-{0..2}-{08..10}.tar", "plain.tar", "x-{5..5}.tar"])
def test_brace_expand_matches_jax(url):
    assert webdataset.brace_expand(url) == jax_wds.brace_expand(url)


@pytest.mark.parametrize("name", sorted(DATASETS))
@pytest.mark.parametrize("add_val", [False, True], ids=["train", "train+val"])
def test_split_urls_and_sizes_match_jax(tmp_path, name, add_val):
    ours_cls, ref_cls = DATASETS[name]
    for overrides in (None, {"val": 3, "test": 5}):
        cfg, jcfg = (dataclasses.replace(c, name=name, add_val_to_train=add_val,
                                         split_size_overrides=overrides)
                     for c in _data_cfgs(tmp_path))
        for split in ("val", "test"):
            ours, ref = ours_cls(cfg, split, device="cpu"), ref_cls(jcfg, split, use_native=False)
            assert ours.dataset.urls == ref.dataset.urls
            assert ours.num_samples() == ref.num_samples()
        for split in ("train", "val", "test"):  # the rules themselves, train's too
            assert ours._split_urls(split) == ref._split_urls(split)
        assert cfg.split_size("train") == ref_cls(jcfg, "train", use_native=False).num_samples()


@pytest.mark.parametrize("family", ["train", "test"])
def test_iter_tar_samples_matches_jax(shard_dir, family):
    """Every field of every sample of a shard, decoded (images bit-exact:
    both are cv2) and raw."""
    shard = shard_dir / f"HO3D_mv_{family}-000001.tar"
    for decode in (True, False):
        ours = list(webdataset.iter_tar_samples(shard, decode=decode))
        ref = list(jax_wds.iter_tar_samples(shard, decode=decode))
        assert len(ours) == len(ref) == 2
        _assert_same(ours, ref)
    assert ours[0]["image_0.jpg"][:2] == b"\xff\xd8"  # raw JPEG bytes


SPLITS = [  # (shards, split_index, split_count, shuffle_buffer[, shuffle_shards, resample])
    (9, 0, 1, 0), (9, 1, 3, 0), (9, 2, 4, 0),
    (2, 1, 3, 0), (2, 2, 5, 0),  # the sample-ordinal split
    (9, 0, 1, 5), (9, 1, 2, 7), (2, 0, 3, 3),
    (9, 0, 1, 0, True, False), (9, 2, 4, 0, True, False), (9, 1, 2, 7, True, False),
    (7, 0, 1, 0, False, True), (7, 0, 1, 500, True, True), (9, 1, 2, 7, True, True),
    (2, 2, 5, 0, False, True),  # resampled: a reader without shards draws from all
    (2, 0, 3, 3, True, True)]


def _split_id(case) -> str:
    flags = [name for name, on in zip(("shuffle", "resample"), case[4:]) if on]
    return "-".join(map(str, case[:4])) + "".join(f"-{f}" for f in flags)


@pytest.mark.parametrize("case", SPLITS, ids=_split_id)
def test_shard_dataset_matches_jax(shard_dir, case):
    """The same keys in the same order over two epochs (the shard draws and
    the reservoir shuffle draw from the same numpy stream)."""
    n, index, count, buffer, shuffle, resample = (*case, False, False)[:6]
    urls = sorted(str(p) for p in shard_dir.glob("HO3D_mv_train-*.tar"))[:n]
    kw = dict(preprocess=lambda s: s["__key__"], shuffle_buffer=buffer, split_index=index,
              split_count=count, shuffle_shards=shuffle, resample=resample)
    ours = webdataset.ShardDataset(urls, decode=False, **kw)
    ref = jax_wds.ShardDataset(urls, **kw)
    for _ in range(2):
        assert list(ours) == list(ref)


def test_sample_split_partitions_and_buffer_keeps_multiset(shard_dir):
    urls = sorted(str(p) for p in shard_dir.glob("HO3D_mv_train-*.tar"))
    key = {"preprocess": lambda s: s["__key__"], "decode": False}
    full = list(webdataset.ShardDataset(urls[:2], **key))
    parts = [list(webdataset.ShardDataset(urls[:2], split_index=i, split_count=3, **key))
             for i in range(3)]
    assert sorted(k for p in parts for k in p) == sorted(full)  # exact cover
    assert max(map(len, parts)) - min(map(len, parts)) <= 1
    plain = list(webdataset.ShardDataset(urls, **key))
    shuffled = list(webdataset.ShardDataset(urls, shuffle_buffer=5, **key))
    assert sorted(plain) == sorted(shuffled) and plain != shuffled


@pytest.mark.parametrize("views", [None, (0, 2), (1, 3, 4)], ids=["all", "0-2", "1-3-4"])
@pytest.mark.parametrize("root_idx", [0, 2])
@pytest.mark.parametrize("family", ["train", "test"])
def test_parse_multiview_labels_matches_jax(shard_dir, views, root_idx, family):
    raw = next(jax_wds.iter_tar_samples(shard_dir / f"HO3D_mv_{family}-000002.tar",
                                        decode=False))
    import pickle

    labels = pickle.loads(raw["label.pyd"])
    ours = ho3d.parse_multiview_labels(labels, root_idx, (480, 640), views)
    ref = jax_ho3d.parse_multiview_labels(labels, root_idx, (480, 640), views)
    _assert_same(ours, ref)


@pytest.mark.parametrize("split", ["val", "test"])
def test_dataset_samples_match_jax(shard_dir, split):
    """The CPU form (frames decoded, bit-exact) sample for sample, and the
    card form: the same labels with each view's JPEG bytes in full_jpeg."""
    cfg, jcfg = _data_cfgs(shard_dir, selected_views=(0, 1, 3))
    ref = list(jax_ho3d.HO3DDataset(jcfg, split, use_native=False))
    ours = list(ho3d.HO3DDataset(cfg, split, device="cpu"))
    assert len(ours) == len(ref) == SIZES[split]
    _assert_same(ours, ref)
    assert ours[0]["full_rgb"].shape == (3, 480, 640, 3)
    card = list(ho3d.HO3DDataset(cfg, split, device="cuda"))  # no card needed to read
    for c, r in zip(card, ref):
        frames = jpeg.decode_jpeg(c.pop("full_jpeg"), "cpu").numpy()
        np.testing.assert_array_equal(frames, r["full_rgb"])
        _assert_same(c, {k: v for k, v in r.items() if k != "full_rgb"})


@pytest.mark.parametrize("add_val", [False, True], ids=["train", "train+val"])
def test_train_split_order_matches_jax(shard_dir, add_val):
    """The train split, JAX's python reader against the port's card form
    (JPEG bytes) over two passes: the same samples (mv_sample_id) in the same
    order, from the resampled, shuffled shard stream and the 500-sample
    reservoir; the CPU form's first pass too, with equal samples."""
    cfg, jcfg = _data_cfgs(shard_dir, add_val_to_train=add_val)
    ref_ds = jax_ho3d.HO3DDataset(jcfg, "train", use_native=False)
    ours_ds = ho3d.HO3DDataset(cfg, "train", device="cuda")  # no card needed to read
    assert ours_ds.dataset.urls == ref_ds.dataset.urls
    assert len(ours_ds.dataset.urls) == (9 if add_val else 7)
    passes = []
    for _ in range(2):
        ref = [s["mv_sample_id"] for s in ref_ds]
        assert [s["mv_sample_id"] for s in ours_ds] == ref
        passes.append(ref)
    assert passes[0] != passes[1] and len(set(passes[0])) > 1  # a new draw every pass
    ref = list(jax_ho3d.HO3DDataset(jcfg, "train", use_native=False))
    _assert_same(list(ho3d.HO3DDataset(cfg, "train", device="cpu")), ref)


# ------------------------------------------------------------------- loader --

def _loaders(shard_dir, steps, **kw):
    cfg, jcfg = _data_cfgs(shard_dir)
    ours = loader.BatchLoader(ho3d.HO3DDataset(cfg, "test", device="cpu"), 4, steps, **kw)
    ref = jax_loader.BatchLoader(jax_ho3d.HO3DDataset(jcfg, "test", use_native=False), 4,
                                 steps)
    return ours, ref


def test_batches_match_jax_loader(shard_dir):
    """Collated batches key for key over two epochs of 2 steps, 16 samples
    out of a 6-sample split: the stream starts the split again mid-batch."""
    ours, ref = _loaders(shard_dir, 2)
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours) == 2
        _assert_same(got, want)
    assert got[0]["full_rgb"].shape == (4, 5, 480, 640, 3)
    samples = [s for _, s in zip(range(3), ho3d.HO3DDataset(_data_cfgs(shard_dir)[0], "test",
                                                            device="cuda"))]
    batch = loader.collate(samples)
    assert len(batch["full_jpeg"]) == 3 and len(batch["full_jpeg"][0]) == 5
    assert "full_rgb" not in batch and batch["joints_cam"].shape == (3, 21, 3)


def test_loader_early_exit_then_iterate_again(shard_dir):
    ours, _ = _loaders(shard_dir, 3)
    first = next(iter(ours))  # the epoch iterator is dropped mid-epoch
    assert first["joints_cam"].shape == (4, 21, 3)
    for _ in range(2):
        assert len(list(ours)) == 3


def test_loader_is_single_consumer(shard_dir):
    ours, _ = _loaders(shard_dir, 3)
    epoch = iter(ours)
    with pytest.raises(RuntimeError, match="single-consumer"):
        iter(ours)
    epoch.close()
    assert len(list(ours)) == 3


def test_loader_dead_after_prepare_error(shard_dir):
    def boom(batch):
        raise ValueError("prepare exploded")

    ours, _ = _loaders(shard_dir, 3, device_prepare=boom)
    with pytest.raises(ValueError, match="prepare exploded"):
        list(ours)
    with pytest.raises(RuntimeError, match="dead"):
        iter(ours)


def _tagging_prepare(calls: list | None = None):
    """A device_prepare that tags each batch with the thread it ran on and
    its call count (the threads also go to ``calls``)."""
    calls = [] if calls is None else calls

    def prepare(batch):
        calls.append(threading.get_ident())
        return {**batch, "n": len(calls), "thread": calls[-1]}

    return prepare


@pytest.mark.parametrize("device_prefetch", [True, False], ids=["preparer", "inline"])
def test_preparer_stage_keeps_order(shard_dir, device_prefetch):
    """With the preparer stage (on by default) or without it, the prepared
    batches are the JAX loader's with the same device_prepare, in order, over
    two epochs; the preparer stage runs it on a thread of its own, the
    inline path on the consumer's."""
    ours, _ = _loaders(shard_dir, 3, device_prepare=_tagging_prepare(),
                       device_prefetch=device_prefetch)
    cfg, jcfg = _data_cfgs(shard_dir)
    ref = jax_loader.BatchLoader(jax_ho3d.HO3DDataset(jcfg, "test", use_native=False), 4, 3,
                                 device_prepare=_tagging_prepare())
    for epoch in range(2):
        got, want = list(ours), list(ref)
        assert [b["n"] for b in got] == [b["n"] for b in want] == [3 * epoch + i for i in (1, 2, 3)]
        _assert_same([{k: v for k, v in b.items() if k != "thread"} for b in got],
                     [{k: v for k, v in b.items() if k != "thread"} for b in want])
        on_consumer = {b["thread"] == threading.get_ident() for b in got}
        assert on_consumer == {not device_prefetch}


@pytest.mark.parametrize("device_prefetch", [True, False], ids=["preparer", "inline"])
def test_preparer_stage_error_early_exit_and_single_consumer(shard_dir, device_prefetch):
    """The preparer stage keeps the loader's rules: one consumer at a time;
    an epoch dropped after one batch can be followed by full epochs, whose
    batches continue the sample stream; an error in device_prepare reaches
    the consumer and leaves the loader dead."""
    calls = []
    ours, _ = _loaders(shard_dir, 3, device_prepare=_tagging_prepare(calls),
                       device_prefetch=device_prefetch)
    epoch = iter(ours)
    first = next(epoch)
    with pytest.raises(RuntimeError, match="single-consumer"):
        iter(ours)
    epoch.close()
    assert first["n"] == 1 and first["full_rgb"].shape == (4, 5, 480, 640, 3)
    assert len(list(ours)) == 3
    assert len(calls) >= 4  # prefetched batches included

    def fail_on_second(batch, seen=[]):
        seen.append(batch)
        if len(seen) == 2:
            raise ValueError("prepare exploded")
        return batch

    bad, _ = _loaders(shard_dir, 3, device_prepare=fail_on_second,
                      device_prefetch=device_prefetch)
    batches = iter(bad)
    assert next(batches)["joints_cam"].shape == (4, 21, 3)
    with pytest.raises(ValueError, match="prepare exploded"):
        next(batches)
    with pytest.raises(RuntimeError, match="dead"):
        iter(bad)


def test_loader_dead_after_reader_error(tmp_path):
    with pytest.raises(RuntimeError, match="zero samples"):
        list(loader.BatchLoader([], 2, 1))
    bad = loader.BatchLoader(webdataset.ShardDataset([str(tmp_path / "missing.tar")]), 2, 1)
    with pytest.raises(FileNotFoundError):
        list(bad)
    with pytest.raises(RuntimeError, match="dead"):
        iter(bad)


# -------------------------------------------------------------------- JPEG --

def test_jpeg_fixture_is_cv2s_decode():
    """The shipped fixture: its pixels are cv2's decode of its JPEG, both
    files together under 200 KB, and the port's CPU decode gives them."""
    import cv2

    payload, ref = jpeg.jpeg_fixture()
    assert ref.shape == (480, 640, 3) and ref.dtype == np.uint8
    bgr = cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(ref, bgr[:, :, ::-1])
    np.testing.assert_array_equal(jpeg.decode_jpeg([payload] * 2, "cpu").numpy(),
                                  np.stack([ref, ref]))
    files = (jpeg.FIXTURE_DIR / "jpeg_fixture.jpg", jpeg.FIXTURE_DIR / "jpeg_fixture_rgb.xz")
    assert sum(f.stat().st_size for f in files) < 200_000
    # the stored form: row differences modulo 256, lzma-compressed
    diff = np.diff(ref, axis=1, prepend=np.zeros((480, 1, 3), np.uint8))
    assert lzma.decompress(files[1].read_bytes()) == diff.tobytes()


def test_cpu_codec_is_cv2_and_refuses_mixed_sizes():
    import cv2

    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, size=(2, 24, 40, 3), dtype=np.uint8)
    encoded = jpeg.encode_jpeg(torch.from_numpy(frames))
    for f, e in zip(frames, encoded):
        assert e == cv2.imencode(".jpg", f[:, :, ::-1])[1].tobytes()
    small = jpeg.encode_jpeg(torch.from_numpy(frames[:1, :8, :8]))[0]
    with pytest.raises(ValueError, match="differ in size"):
        jpeg.decode_jpeg([encoded[0], small], "cpu")
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(torch.zeros(1, 8, 8, 3))


def test_written_shards_match_jax(tmp_path):
    """The port's shard writer on the CPU: byte for byte the JAX package's
    shards; with coherent geometry the same labels (the drawn hands differ:
    numpy here, cv2 there)."""
    kw = dict(num_shards=2, samples_per_shard=2, num_views=2, seed=4)
    ours = write_synthetic_ho3d_shards(tmp_path / "ours", device="cpu", **kw)
    ref = jax_write_shards(tmp_path / "ref", **kw)
    assert all(filecmp.cmp(a, b, shallow=False) for a, b in zip(ours, ref))
    ours = write_synthetic_ho3d_shards(tmp_path / "ours_c", device="cpu", consistent_geometry=True,
                                       **kw)
    ref = jax_write_shards(tmp_path / "ref_c", consistent_geometry=True, **kw)
    for a, b in zip(ours, ref):
        for s, r in zip(webdataset.iter_tar_samples(a), webdataset.iter_tar_samples(b)):
            _assert_same(s["label.pyd"], r["label.pyd"])
            bright = s["image_1.jpg"] > 150  # the drawn skeleton
            assert 0.001 < bright.mean() < 0.05
            assert (r["image_1.jpg"][bright] > 100).mean() > 0.5


# ------------------------------------------------------------ preprocessing --

# frame 48 x 64; boxes xyxy: inside, across each edge, larger than the frame,
# smaller than the output (upsampling), and not square
BOXES = [(10, 8, 42, 40), (-9, 5, 23, 37), (3, -12, 35, 20), (40, 10, 72, 42),
         (20, 30, 52, 62), (-20, -30, 90, 70), (30, 20, 36, 26), (5, 2, 61, 30)]


def test_crop_resize_weights_match_jax():
    """atol 1e-7 (weights <= 1); measured 6.0e-8."""
    lo = np.asarray([b[0] for b in BOXES], np.int32)
    hi = np.asarray([b[2] for b in BOXES], np.int32)
    for size in (48, 64):
        for out in (16, 32):
            ours = resize.crop_resize_weights(torch.from_numpy(lo), torch.from_numpy(hi), size,
                                              out).numpy()
            ref = jax.vmap(lambda a, b: jax_resize._crop_resize_weights(a, b, size, out))(
                jnp.asarray(lo), jnp.asarray(hi))
            np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_crop_resize_normalize_matches_jax(masked):
    """fp32, crop_resize then mask_normalize, each box against JAX's
    crop_resize_normalize under vmap (with ``masked``,
    every other view black, as JAX's preprocess_views masks before it
    normalises): atol 1e-5 (values up to 2.64); measured 8.0e-7."""
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, size=(len(BOXES), 48, 64, 3), dtype=np.uint8)
    boxes = np.asarray(BOXES, np.float32)
    visible = np.arange(len(BOXES)) % 2 == 0 if masked else np.ones(len(BOXES), bool)
    crops = resize.crop_resize(torch.from_numpy(images), torch.from_numpy(boxes), 32)
    ours = resize.mask_normalize(crops, torch.from_numpy(visible) if masked else None).numpy()
    raw = jax.vmap(lambda i, b: jax_resize.crop_resize_normalize(i, b, 32, normalize=False))(
        jnp.asarray(images), jnp.asarray(boxes))
    mean = np.asarray(jax_resize.IMAGENET_MEAN, np.float32)
    std = np.asarray(jax_resize.IMAGENET_STD, np.float32)
    ref = (np.asarray(raw) * visible[:, None, None, None].astype(np.float32) - mean) / std
    for i in range(len(BOXES)):
        np.testing.assert_allclose(ours[i], ref[i], atol=1e-5, err_msg=str(BOXES[i]))
    # padding is zero: the part of box 1 left of the frame is normalised black
    np.testing.assert_array_equal(ours[1, :, :8], np.broadcast_to(-mean / std, (32, 8, 3)))


@pytest.mark.parametrize("full,out", [(256, 32), (64, 8)])
def test_render_gaussian_heatmaps_resized_matches_jax(full, out):
    """Points inside, on the edges and off the map (whose windows still
    reach it, or do not): atol 1e-7 (maps <= 1), measured 9.0e-8; and the
    port's render-then-resize composition, which it factors: atol 1e-6,
    measured 6.0e-8."""
    rng = np.random.default_rng(12)
    edges = np.resize([[-7.5, 3.0], [-6.2, 10.0], [full + 5.9, 2.0], [3.0, full + 6.5],
                       [-100.0, -100.0], [full - 0.5, full - 0.5]], (1, 21, 2))
    pts = np.concatenate([rng.uniform(0, full, size=(3, 21, 2)),
                          rng.uniform(-12, full + 12, size=(3, 21, 2)), edges]).astype(np.float32)
    ours = heatmap.render_gaussian_heatmaps_resized(torch.from_numpy(pts), full, out).numpy()
    ref = np.asarray(jax_heatmap.render_gaussian_heatmaps_resized(jnp.asarray(pts), full, out))
    assert ours.shape == ref.shape == (7, 21, out, out)
    np.testing.assert_allclose(ours, ref, atol=1e-7)
    composed = resize.resize_bilinear_antialias(
        heatmap.render_gaussian_heatmaps(torch.from_numpy(pts), full, full), (out, out)).numpy()
    np.testing.assert_allclose(ours, composed, atol=1e-6)
    assert (ours[-1].reshape(21, -1).max(axis=1) == 0).any()  # a point off the map


@pytest.fixture(scope="module")
def collated(shard_dir):
    """One collated batch of 4 samples from the JAX loader, view 2 of sample
    1 fully invisible (the black-image rule)."""
    _, jcfg = _data_cfgs(shard_dir)
    batch = next(iter(jax_loader.BatchLoader(
        jax_ho3d.HO3DDataset(jcfg, "val", use_native=False), 4, 1)))
    batch["joints_img_mask"][1, 2] = True
    return batch


def test_preprocess_views_matches_jax(collated):
    """fp32 at 256^2 crops and 32^2 heatmaps: rgb atol 1e-5 (normalised,
    |x| <= 2.7), measured 1.2e-6; heatmap atol 1e-6 (maps <= 0.25),
    measured 6.0e-8."""
    b = collated
    any_visible = ~np.all(b["joints_img_mask"], axis=-1)
    ours = preprocess_views(torch.from_numpy(b["full_rgb"]), torch.from_numpy(b["bboxes"]),
                            torch.from_numpy(b["joints_crop_img"]),
                            torch.from_numpy(any_visible))
    ref = jax_preprocess_views(jnp.asarray(b["full_rgb"]), jnp.asarray(b["bboxes"]),
                               jnp.asarray(b["joints_crop_img"]), jnp.asarray(any_visible))
    rgb, hm = (t.numpy() for t in ours)
    assert rgb.shape == (4, 5, 256, 256, 3) and hm.shape == (4, 5, 21, 32, 32)
    np.testing.assert_allclose(rgb, np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(hm, np.asarray(ref[1]), atol=1e-6)
    black = (0.0 - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])
    np.testing.assert_allclose(rgb[1, 2], np.broadcast_to(black, rgb[1, 2].shape), atol=1e-6)
    assert hm.max() > 0.1  # the coherent hand's joints land in their crops


def test_make_device_prepare_matches_jax(shard_dir, collated):
    """The data path as a whole on the CPU: the same keys as JAX's prepare,
    labels exact, rgb and heatmap within test_preprocess_views_matches_jax's
    tolerances."""
    cfg = Config.from_dict({"data": {"dataset_dir": str(shard_dir)}})
    jcfg = JaxConfig.from_dict({"data": {"dataset_dir": str(shard_dir)}})
    ours = train.make_device_prepare(cfg, "cpu")(dict(collated))
    ref = jax_make_device_prepare(jcfg, False)(dict(collated))
    assert set(ours) == set(ref)
    for key, value in ref.items():
        got, want = ours[key].numpy(), np.asarray(value)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        atol = {"rgb": 1e-5, "heatmap": 1e-6}.get(key, 0.0)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=key)


# ---------------------------------------------------------------- refusals --

def test_unported_options_raise_naming_their_roadmap_item(shard_dir):
    """The decode cache and the downscaled decode raise, on every split; the
    train split and augmentation are ported."""
    cfg, _ = _data_cfgs(shard_dir)
    for split in ("train", "val", "test"):
        with pytest.raises(NotImplementedError, match="queue 1 item 2"):
            ho3d.HO3DDataset(dataclasses.replace(cfg, cache_decoded=True), split, device="cpu")
        with pytest.raises(NotImplementedError, match="queue 1 item 3"):
            ho3d.HO3DDataset(dataclasses.replace(cfg, decode_scale_denom=2), split, device="cpu")
    assert ho3d.HO3DDataset(cfg, "train", device="cpu").dataset.resample
    train_loader, _ = train.build_dataloaders(Config(data=cfg), "cpu", splits=("train", "val"))
    assert len(train_loader) == cfg.split_size("train") // cfg.batch_size


def test_build_dataloaders_val_and_test(shard_dir):
    cfg = Config(data=_data_cfgs(shard_dir, batch_size=2)[0])
    val, test = train.build_dataloaders(cfg, "cpu")
    assert (len(val), len(test)) == (2, 3)  # split size // batch
    batch = next(iter(test))
    assert batch["rgb"].shape == (2, 5, 256, 256, 3) and batch["rgb"].dtype == torch.float32
    assert batch["heatmap"].shape == (2, 5, 21, 32, 32)
    assert not set(batch) & set(train.HOST_ONLY)


@pytest.mark.parametrize("augment", [True, False], ids=["augment", "no-augment"])
def test_build_dataloaders_train_split(shard_dir, augment):
    """The train loader: the split's size // batch steps, and each batch the
    train stream's samples prepared as make_device_prepare prepares them,
    with augmentation as the config asks (the n-th batch from seed 42 + n)."""
    cfg = Config(data=_data_cfgs(shard_dir, batch_size=2, augment=augment,
                                 split_size_overrides={"train": 14, "val": 4})[0])
    (loader_,) = train.build_dataloaders(cfg, "cpu", splits=("train",))
    assert len(loader_) == 7 and loader_.device_prefetch
    raw = loader.BatchLoader(ho3d.HO3DDataset(cfg.data, "train", device="cpu"), 2, 3)
    prepare = train.make_device_prepare(cfg, "cpu", augment=augment)
    for got, batch in zip(loader_, raw):
        want = prepare(batch)
        assert set(got) == set(want)
        for key, value in want.items():
            assert torch.equal(got[key], value), key
    plain = train.make_device_prepare(cfg, "cpu")(next(iter(raw)))
    assert plain["rgb"].shape == (2, 5, 256, 256, 3)
