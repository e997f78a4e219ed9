"""Port parity, the train split's augmentation: handmvnet_tpu_torch's
data/augment.py against handmvnet_tpu/data/augment.py on the CPU, sub-op by
sub-op at fixed factors, as a whole chain at the draws JAX's own key gives,
and by distribution; preprocess_views(augment=True) against JAX's at the same
draws; make_device_prepare's seeding rule.

Tolerances:
  * pointwise sub-ops, the Gaussian, sharpness, posterize and occlusion:
    1e-6 max abs (images in [0, 1]; the same float32 ops in the same order,
    up to an ulp of the colour sums and of sin/cos);
  * box blur: 4 S eps / w, the cumsum's rounding: a window's sum is the
    difference of two cumsums of up to S values in [0, 1], and the packages
    sum them in other orders (eps = 2^-23);
  * the chain: 1e-5 max abs but for posterize flips: where the chain's
    inputs to posterize differ by an ulp across a multiple of 4/255, the
    level flips. Each flip must be exactly 4/255, and flips at most 1e-4 of
    the elements.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handmvnet_tpu.data import augment as jax_augment
from handmvnet_tpu.data.pipeline import preprocess_views as jax_preprocess_views
from handmvnet_tpu_torch import train
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data import augment
from handmvnet_tpu_torch.data.pipeline import preprocess_views

EPS = 2.0 ** -23
FLIP = 4.0 / 255.0
N, S = 6, 64  # images and their side for the sub-op checks


def _images(seed: int, n: int = N, side: int = S) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(n, side, side, 3)).astype(np.float32)


def _vmapped(fn, *args) -> np.ndarray:
    return np.asarray(jax.vmap(fn)(*(jnp.asarray(a) for a in args)))


def _max_err(ours: torch.Tensor, ref: np.ndarray) -> float:
    return float(np.abs(ours.numpy() - ref).max())


# ------------------------------------------------------------------ sub-ops --

def test_brightness_and_saturation_match_jax():
    img = _images(0)
    factors = np.random.default_rng(1).uniform(0.8, 1.2, N).astype(np.float32)
    t, f = torch.from_numpy(img), torch.from_numpy(factors).reshape(-1, 1, 1, 1)
    assert _max_err(t * f, _vmapped(jax_augment._adjust_brightness, img, factors)) <= 1e-6
    for sat in (factors, np.zeros(N, np.float32), np.ones(N, np.float32)):
        ours = augment._adjust_saturation(t, torch.from_numpy(sat).reshape(-1, 1, 1, 1))
        assert _max_err(ours, _vmapped(jax_augment._adjust_saturation, img, sat)) <= 1e-6


def test_hue_matches_jax():
    img = _images(2)
    deltas = np.random.default_rng(3).uniform(-0.005, 0.005, N).astype(np.float32)
    deltas[0] = 0.25  # far outside the draw's range: the rotation itself
    ours = augment._adjust_hue(torch.from_numpy(img), torch.from_numpy(deltas))
    assert _max_err(ours, _vmapped(jax_augment._adjust_hue, img, deltas)) <= 1e-6


@pytest.mark.parametrize("width", [0, 1, 2, 3, 5, 10, 21, 40, 200])
def test_box_blur_matches_jax(width):
    """Each image at its own width around ``width`` (0 acts as 1; 200 spans
    the image), within the cumsum's rounding."""
    img = _images(4)
    widths = np.maximum(width + np.arange(N) % 2, 0).astype(np.int32)
    ours = augment._box_blur(torch.from_numpy(img), torch.from_numpy(widths).long())
    ref = _vmapped(jax_augment._box_blur_dynamic, img, widths)
    tol = 4 * S * EPS / max(width, 1)
    assert _max_err(ours, ref) <= tol


def test_gaussian_blur_matches_jax():
    """sigma and support in raster px over the crop scales the draws give
    (k in {3, 5, 7} and sigma in {1, 2, 3} crop px, scales 0.4-4)."""
    rng = np.random.default_rng(5)
    img = _images(6)
    sigma = rng.uniform(0.4, 12.0, N).astype(np.float32)
    support = rng.uniform(0.6, 14.0, N).astype(np.float32)
    support[0] = 0.5  # one tap: the identity
    ours = augment._gaussian_blur(torch.from_numpy(img), torch.from_numpy(sigma),
                                  torch.from_numpy(support))
    ref = _vmapped(jax_augment._gaussian_blur_dynamic, img, sigma, support)
    assert _max_err(ours, ref) <= 1e-6
    np.testing.assert_allclose(ours[0].numpy(), img[0], atol=1e-7)


@pytest.mark.parametrize("factor", [1.0, 2.0])
def test_sharpness_matches_jax(factor):
    img = _images(7)
    ours = augment._sharpness(torch.from_numpy(img), factor)
    ref = _vmapped(lambda x: jax_augment._sharpness(x, factor), img)
    assert _max_err(ours, ref) <= 1e-6


def test_posterize_matches_jax():
    img = _images(8)
    img[0, :4, :4, :] = np.arange(48, dtype=np.float32).reshape(4, 4, 3) * 4 / 255.0  # on levels
    ours = augment._posterize(torch.from_numpy(img), 6)
    assert _max_err(ours, _vmapped(lambda x: jax_augment._posterize(x, 6), img)) <= 1e-6


@pytest.mark.parametrize("crop_scale", [0.5, 1.0, 256.0 / 130.0, 4.0])
def test_occlusion_matches_jax_at_a_fixed_size_and_cell(crop_scale):
    """JAX's _occlude at a key, and the port's at the size and cell that key
    draws (the cell given as the centre of its uniform interval)."""
    img = _images(9, n=1, side=256)[0]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax_augment._occlude(jnp.asarray(img), key, jnp.float32(crop_scale)))
        size, row_u, col_u = _jax_occlusion_draw(key, np.float32(crop_scale), 256, 256)
        ours = augment._occlude(torch.from_numpy(img)[None], torch.tensor([size]),
                                torch.tensor([row_u]), torch.tensor([col_u]),
                                torch.tensor([crop_scale], dtype=torch.float32))[0]
        assert _max_err(ours, ref) <= 1e-6
        assert (ref == 0).all(axis=-1).any()


# ------------------------------------------------------------- whole chain --

def _jax_occlusion_draw(key, crop_scale, h, w):
    """(size in crop px, row and column uniforms) of _occlude at ``key``."""
    k_size, k_r, k_c = jax.random.split(key, 3)
    size = jax.random.randint(k_size, (), 8, 65).astype(jnp.float32)
    rows = int(jnp.maximum((h / jnp.float32(crop_scale) / size).astype(jnp.int32), 1))
    cols = int(jnp.maximum((w / jnp.float32(crop_scale) / size).astype(jnp.int32), 1))
    r = int(jax.random.randint(k_r, (), 0, rows))
    c = int(jax.random.randint(k_c, (), 0, cols))
    return float(size), (r + 0.5) / rows, (c + 0.5) / cols


def jax_draws(rng, crop_scales, h: int, w: int) -> dict:
    """The factors augment_batch draws from ``rng``: the key split per image,
    then each image's 12 keys used as augment_image uses them, in the port's
    draw_augmentation layout."""
    cols = {k: [] for k in ("brightness", "saturation", "hue", "blur", "gauss", "blur_k",
                            "sigma", "sharpen", "posterize", "occlude", "occ_size", "occ_row",
                            "occ_col")}
    for key, scale in zip(jax.random.split(rng, len(crop_scales)), crop_scales):
        k = jax.random.split(key, 12)
        uniform = {name: float(jax.random.uniform(k[i], (), minval=lo, maxval=hi))
                   for name, i, lo, hi in (("brightness", 0, 0.8, 1.2),
                                           ("saturation", 1, 0.9, 1.1),
                                           ("hue", 2, -0.005, 0.005))}
        for name, value in uniform.items():
            cols[name].append(value)
        for name, i, p in (("blur", 3, 0.4), ("sharpen", 6, 0.3), ("posterize", 7, 0.3),
                           ("occlude", 8, 0.3)):
            cols[name].append(bool(jax.random.uniform(k[i]) < p))
        cols["gauss"].append(int(jax.random.randint(k[4], (), 0, 3)) == 2)
        cols["blur_k"].append((3.0, 5.0, 7.0)[int(jax.random.randint(k[5], (), 0, 3))])
        cols["sigma"].append((1.0, 2.0, 3.0)[int(jax.random.randint(k[10], (), 0, 3))])
        size, row_u, col_u = _jax_occlusion_draw(k[9], scale, h, w)
        cols["occ_size"].append(size)
        cols["occ_row"].append(row_u)
        cols["occ_col"].append(col_u)
    return {name: torch.tensor(v, dtype=torch.bool if isinstance(v[0], bool) else torch.float32)
            for name, v in cols.items()}


def assert_equal_up_to_posterize_flips(ours: np.ndarray, ref: np.ndarray) -> int:
    """The module docstring's chain rule; returns the flips."""
    diff = np.abs(ours - ref)
    flips = diff > 1e-5
    assert diff[~flips].max(initial=0.0) <= 1e-5
    np.testing.assert_allclose(diff[flips], FLIP, atol=1e-6)
    assert flips.mean() <= 1e-4, flips.mean()
    return int(flips.sum())


def test_chain_matches_jax_at_its_own_draws():
    """96 crops of 64^2 at crop scales 0.4-3 through JAX's augment_batch and
    through apply_augmentation at the draws JAX's key gives; every branch
    is taken by some image."""
    rng = np.random.default_rng(10)
    img = _images(11, n=96)
    scales = rng.uniform(0.4, 3.0, 96).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_augment.augment_batch(jnp.asarray(img), key, jnp.asarray(scales)))
    draws = jax_draws(key, scales, S, S)
    for name in ("blur", "gauss", "sharpen", "posterize", "occlude"):
        assert draws[name].any() and not draws[name].all(), name
    blurred = draws["blur"]
    assert (draws["gauss"] & blurred).any() and (~draws["gauss"] & blurred).any()
    ours = augment.apply_augmentation(torch.from_numpy(img), draws, torch.from_numpy(scales))
    assert ours.dtype == torch.float32
    assert_equal_up_to_posterize_flips(ours.numpy(), ref)


# ------------------------------------------------------------ distributions --

def _binomial_ok(hits: torch.Tensor, p: float) -> bool:
    n = hits.numel()
    return abs(float(hits.float().mean()) - p) <= 5.0 * np.sqrt(p * (1 - p) / n)


def test_draws_match_jax_rates_and_ranges():
    """4000 images' draws: each rate within 5 binomial sigmas of JAX's, each
    factor inside its range and spread over it, each choice's values equally
    likely."""
    n = 4000
    d = augment.draw_augmentation(n, torch.Generator().manual_seed(0), "cpu")
    assert all(v.shape == (n,) for v in d.values())
    for name, p in (("blur", 0.4), ("sharpen", 0.3), ("posterize", 0.3), ("occlude", 0.3),
                    ("gauss", 1 / 3)):
        assert d[name].dtype == torch.bool and _binomial_ok(d[name], p), name
    for name, lo, hi in (("brightness", 0.8, 1.2), ("saturation", 0.9, 1.1),
                         ("hue", -0.005, 0.005), ("occ_row", 0.0, 1.0), ("occ_col", 0.0, 1.0)):
        x = d[name]
        assert float(x.min()) >= lo and float(x.max()) < hi, name
        width = hi - lo
        assert float(x.min()) < lo + 0.01 * width and float(x.max()) > hi - 0.01 * width, name
        sigma = width / np.sqrt(12 * n)
        assert abs(float(x.mean()) - (lo + hi) / 2) <= 5 * sigma, name
    for name, values in (("blur_k", (3.0, 5.0, 7.0)), ("sigma", (1.0, 2.0, 3.0)),
                         ("occ_size", tuple(float(s) for s in range(8, 65)))):
        assert set(d[name].tolist()) == set(values), name
        for value in values[:3]:
            assert _binomial_ok(d[name] == value, 1 / len(values)), (name, value)


def test_same_generator_seed_same_draws():
    a = augment.draw_augmentation(5, torch.Generator().manual_seed(43), "cpu")
    b = augment.draw_augmentation(5, torch.Generator().manual_seed(43), "cpu")
    c = augment.draw_augmentation(5, torch.Generator().manual_seed(44), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["brightness"], c["brightness"])


def test_occlusion_area_matches_reference_distribution():
    """tests/test_augment_ops.py's check on the port: a patch of s ~ U{8..64}
    crop px on a crop of side D = 128 at crop scale 256 / D covers (s/D)^2
    of the raster on average, within 15%, and more than a raster-space
    64 px patch could."""
    n, side = 200, 128.0
    d = augment.draw_augmentation(n, torch.Generator().manual_seed(1), "cpu")
    out = augment._occlude(torch.ones(n, 256, 256, 3), d["occ_size"], d["occ_row"],
                           d["occ_col"], torch.full((n,), 256.0 / side))
    fracs = (out == 0).all(dim=-1).float().mean(dim=(1, 2)).numpy()
    s = np.arange(8, 65, dtype=np.float64)
    expect = np.mean((s / side) ** 2)
    assert abs(fracs.mean() - expect) / expect < 0.15, (fracs.mean(), expect)
    assert fracs.max() > (64.0 / 256.0) ** 2 * 1.5


def test_blur_energy_matches_crop_space_reference():
    """tests/test_augment_ops.py's check on the port: box blur k = 5 on the
    native 128^2 crop, then a 2x upscale, against the port's box blur of
    width 10 on the upscaled raster: correlation > 0.95 and std within 15%
    away from the borders."""
    import cv2

    crop = np.random.default_rng(3).uniform(size=(128, 128, 3)).astype(np.float32)
    ref = cv2.resize(cv2.blur(crop, (5, 5)), (256, 256), interpolation=cv2.INTER_LINEAR)
    up = cv2.resize(crop, (256, 256), interpolation=cv2.INTER_LINEAR)
    ours = augment._box_blur(torch.from_numpy(up)[None], torch.tensor([10]))[0].numpy()
    a, b = ref[16:-16, 16:-16], ours[16:-16, 16:-16]
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.95
    assert abs(a.std() - b.std()) / a.std() < 0.15


# ---------------------------------------------------------------- pipeline --

# frames of 48 x 64; boxes of sides 32, 32, 110 and 6 px (magnifications 2,
# 2, 0.58 and 10.7 at 64^2 crops), partly off the frame
BOXES = [(10, 8, 42, 40), (-9, 5, 23, 37), (-20, -30, 90, 80), (30, 20, 36, 26)]


def test_preprocess_views_augment_matches_jax(monkeypatch):
    """2 samples x 2 views through JAX's preprocess_views(augment=True) and
    the port's, whose draws are replaced by those JAX's key gives at the
    same crop scales (image_size / box side); view 1 of sample 0 is black.
    Compared in [0, 1] units (x std + mean) under the chain's rule;
    heatmaps as tests/test_torch_data.py holds them (1e-6)."""
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, size=(2, 2, 48, 64, 3), dtype=np.uint8)
    boxes = np.asarray(BOXES, np.float32).reshape(2, 2, 4)
    joints = rng.uniform(0, 64, size=(2, 2, 21, 2)).astype(np.float32)
    visible = np.array([[True, False], [True, True]])
    key = jax.random.PRNGKey(5)
    ref_rgb, ref_hm = jax_preprocess_views(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(joints), jnp.asarray(visible), key,
        image_size=64, heatmap_size=8, augment=True)
    sides = np.maximum(boxes.reshape(-1, 4)[:, 2] - boxes.reshape(-1, 4)[:, 0], 1.0)
    draws = jax_draws(key, (64.0 / sides).astype(np.float32), 64, 64)
    seen = []

    def fake_draw(n, generator, device):
        seen.append((n, generator))
        return draws

    monkeypatch.setattr(augment, "draw_augmentation", fake_draw)
    gen = torch.Generator().manual_seed(0)
    rgb, hm = preprocess_views(torch.from_numpy(frames), torch.from_numpy(boxes),
                               torch.from_numpy(joints), torch.from_numpy(visible),
                               image_size=64, heatmap_size=8, augment=True, generator=gen)
    assert seen == [(4, gen)]
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    assert_equal_up_to_posterize_flips(rgb.numpy() * std + mean, np.asarray(ref_rgb) * std + mean)
    np.testing.assert_allclose(hm.numpy(), np.asarray(ref_hm), atol=1e-6)
    np.testing.assert_allclose(rgb[0, 1].numpy(), np.broadcast_to(-mean / std, (64, 64, 3)),
                               atol=1e-6)


def test_preprocess_views_augment_needs_a_generator():
    x = torch.zeros(1, 1, 8, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="generator"):
        preprocess_views(x, torch.tensor([[[0.0, 0.0, 8.0, 8.0]]]), torch.zeros(1, 1, 21, 2),
                         torch.ones(1, 1, dtype=torch.bool), image_size=8, heatmap_size=2,
                         augment=True)


def test_make_device_prepare_seeds_the_nth_batch_42_plus_n():
    """JAX's PRNGKey(seed + counter) rule with torch's draws: the n-th batch
    a prepare function makes (from 1) augments from a generator seeded
    42 + n, whatever the batch; a second prepare function starts again."""
    rng = np.random.default_rng(13)
    batch = {
        "full_rgb": rng.integers(0, 256, size=(1, 2, 48, 64, 3), dtype=np.uint8),
        "bboxes": np.asarray(BOXES[:2], np.float32)[None],
        "joints_crop_img": rng.uniform(0, 64, size=(1, 2, 21, 2)).astype(np.float32),
        "joints_img_mask": np.zeros((1, 2, 21), bool),
    }
    cfg = Config.from_dict({"data": {"image_size": 64, "heatmap_size": 8}})
    prepare = train.make_device_prepare(cfg, "cpu", augment=True)
    first, second = prepare(dict(batch)), prepare(dict(batch))
    again = train.make_device_prepare(cfg, "cpu", augment=True)(dict(batch))
    plain = train.make_device_prepare(cfg, "cpu")(dict(batch))
    for n, out in ((1, first), (2, second)):
        want, _ = preprocess_views(
            torch.from_numpy(batch["full_rgb"]), torch.from_numpy(batch["bboxes"]),
            torch.from_numpy(batch["joints_crop_img"]), torch.ones(1, 2, dtype=torch.bool),
            image_size=64, heatmap_size=8, augment=True,
            generator=torch.Generator().manual_seed(42 + n))
        assert torch.equal(out["rgb"], want), n
    assert torch.equal(again["rgb"], first["rgb"])
    assert not torch.equal(first["rgb"], second["rgb"])
    assert not torch.equal(first["rgb"], plain["rgb"])
    assert torch.equal(first["heatmap"], plain["heatmap"])
