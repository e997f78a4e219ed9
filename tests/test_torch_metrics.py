"""Port parity, the pose metrics and their assembly: handmvnet_tpu_torch's
metrics, engine.pose_metrics_device (with and without the mesh stage and the
invisible-joint mask) and labels_in_meters against the JAX package's, fp32 on
the CPU, plus the port's eval_fps protocol with its mesh stage.

Tolerances are absolute, with the largest error measured on the CPU beside
each. Shares of points (PCK) get 1e-6: their means round differently by an
ulp, while one point counted otherwise would move a share by >= 1/168.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handmvnet_tpu import engine as jax_engine
from handmvnet_tpu import metrics as jax_metrics
from handmvnet_tpu.models.joints_to_vertices import joints_to_vertices_fn as jax_j2v
from handmvnet_tpu.models.mano import ManoLayer as JaxManoLayer
from handmvnet_tpu.models.mano import synthetic_mano_model as jax_synthetic_mano_model
from handmvnet_tpu.ops import geometry as jax_geometry
from handmvnet_tpu_torch import engine, metrics
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.eval_fps import build_mesh_stage, run_protocol
from handmvnet_tpu_torch.ops import geometry

ROOT = Path(__file__).resolve().parents[1]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _pair(rng, shape, scale, noise):
    labels = rng.normal(size=shape) * scale
    preds = labels + rng.normal(size=shape) * noise
    return preds.astype(np.float32), labels.astype(np.float32)


@pytest.mark.parametrize("name", ["mpjpe", "pa_mpjpe", "n_mpjpe", "weighted_mpjpe", "mka"])
def test_error_metrics_match(name):
    """Meters: 21 joints per sample, errors of ~1 cm (n_mpjpe and mka take
    [B, T, J, 3] sequences)."""
    rng = np.random.default_rng(30)
    shape = (4, 5, 21, 3) if name in ("n_mpjpe", "mka") else (6, 21, 3)
    preds, labels = _pair(rng, shape, 0.05, 0.01)
    args = {"mka": (preds,), "weighted_mpjpe": (preds, labels, rng.uniform(size=shape[:-1]))}
    args = args.get(name, (preds, labels))
    ours = getattr(metrics, name)(*map(_t, args)).numpy()
    ref = np.asarray(getattr(jax_metrics, name)(*map(jnp.asarray, args)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-7)  # meters; measured 3.0e-8


@pytest.mark.parametrize("with_reference_len", [False, True])
def test_pck_and_auc_match(with_reference_len):
    rng = np.random.default_rng(31)
    preds, labels = _pair(rng, (8, 21, 3), 0.05, 0.01)
    ref_len = rng.uniform(0.5, 1.5, size=8).astype(np.float32) if with_reference_len else None
    kw = {} if ref_len is None else {"reference_len": ref_len}
    tkw = {} if ref_len is None else {"reference_len": _t(ref_len)}

    ours = metrics.pck(_t(preds), _t(labels), 0.01, **tkw)
    ref = jax_metrics.pck(jnp.asarray(preds), jnp.asarray(labels), 0.01, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)  # measured 1.5e-8

    ours = metrics.pck_auc(_t(preds), _t(labels), 0.0, 0.05, steps=20, **tkw)
    ref = jax_metrics.pck_auc(jnp.asarray(preds), jnp.asarray(labels), 0.0, 0.05, steps=20, **kw)
    # measured 3.7e-9, an ulp at 0.05
    np.testing.assert_allclose(ours.thresholds.numpy(), np.asarray(ref.thresholds), atol=1e-8)
    np.testing.assert_allclose(ours.pck_values.numpy(), np.asarray(ref.pck_values),
                               atol=1e-6)  # measured 3.0e-8
    np.testing.assert_allclose(ours.auc.numpy(), np.asarray(ref.auc), atol=1e-8)  # measured 0
    np.testing.assert_allclose(ours.norm_auc.numpy(), np.asarray(ref.norm_auc), atol=1e-6)


def test_mask_joints_matches():
    rng = np.random.default_rng(32)
    joints = rng.normal(size=(2, 3, 21, 2)).astype(np.float32)
    mask = rng.uniform(size=(2, 3, 21)) < 0.3
    ours = geometry.mask_joints(_t(joints), torch.from_numpy(mask)).numpy()
    ref = np.asarray(jax_geometry.mask_joints(jnp.asarray(joints), jnp.asarray(mask)))
    np.testing.assert_array_equal(ours, ref)


def _batch(rng, b: int = 3, v: int = 2, with_vertices: bool = True, template=None):
    """A batch as the loaders give it (numpy, mm), and model outputs (m)."""
    joints_mm = (template[None] + rng.normal(size=(b, 21, 3)) * 5.0).astype(np.float32)
    batch = {
        "joints_cam": joints_mm,
        "root_joint": rng.normal(size=(b, 1, 3)).astype(np.float32) * 100.0,
        "joints_crop_img": rng.uniform(0, 256, size=(b, v, 21, 2)).astype(np.float32),
        "joints_img_mask": rng.uniform(size=(b, v, 21)) < 0.2,
    }
    if with_vertices:
        batch["vertices"] = (rng.normal(size=(b, 778, 3)) * 40.0).astype(np.float32)
    out = {
        "joints_cam": (joints_mm + rng.normal(size=joints_mm.shape) * 8.0) / 1000.0,
        "joints_crop_img": batch["joints_crop_img"] + rng.normal(size=(b, v, 21, 2)) * 3.0,
        "root_joint": batch["root_joint"] / 1000.0 + 0.002,
    }
    return batch, {k: np.asarray(x, np.float32) for k, x in out.items()}


def test_labels_in_meters_matches():
    batch, _ = _batch(np.random.default_rng(33), template=np.zeros((21, 3), np.float32))
    ours = engine.labels_in_meters(batch, device="cpu")
    ref = jax_engine.labels_in_meters(batch)
    assert set(ours) == set(ref)
    for key in ("joints_cam", "root_joint", "vertices"):
        assert ours[key].dtype == torch.float32 and ours[key].device.type == "cpu"
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=1e-9)
    np.testing.assert_array_equal(ours["joints_crop_img"], ref["joints_crop_img"])


# vertex metrics ride on the mesh stage, whose fp32 rounding differs between
# the packages by up to ~6e-3 mm (tests/test_torch_mesh.py): mpvpe and
# pa_mpvpe (mm) get 1e-3, the rest (mm, pixels, shares) 1e-5
METRIC_ATOL = {"mpvpe": 1e-3, "pa_mpvpe": 1e-3}


@pytest.mark.parametrize("mask_invisible", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("with_vertices", [True, False], ids=["vertices", "joints"])
@pytest.mark.parametrize("root_relative", [True, False], ids=["relative", "absolute"])
def test_pose_metrics_device_matches(with_vertices, mask_invisible, root_relative):
    """Measured: every joint metric within 1.9e-6, mpvpe and pa_mpvpe within
    7.7e-6 mm."""
    layer = JaxManoLayer(jax_synthetic_mano_model())
    batch, out = _batch(np.random.default_rng(34), template=layer.joints_template())
    kw = {"auc_thresholds": (0.0, 0.05), "mask_invisible": mask_invisible,
          "root_relative": root_relative}
    labels = engine.labels_in_meters(batch, device="cpu")
    labels = {k: torch.as_tensor(v) for k, v in labels.items()}
    ours = engine.pose_metrics_device(
        {k: _t(x) for k, x in out.items()}, labels,
        vertices_fn=build_mesh_stage("cpu") if with_vertices else None, **kw)
    ref = jax_engine.pose_metrics_device(
        {k: jnp.asarray(x) for k, x in out.items()},
        {k: jnp.asarray(v) for k, v in jax_engine.labels_in_meters(batch).items()},
        vertices_fn=jax_j2v(layer) if with_vertices else None, **kw)
    assert set(ours) == set(ref)
    assert ("mpvpe" in ours) == with_vertices and ("w_mpjpe" in ours) == (not root_relative)
    for key, value in ref.items():
        got = ours[key].numpy()
        np.testing.assert_allclose(got, np.asarray(value), atol=METRIC_ATOL.get(key, 1e-5),
                                   err_msg=key)


def test_make_vertices_fn_without_mano_pkl(tmp_path, capsys):
    cfg = Config.from_yaml(ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            mano_models_dir=str(tmp_path)))
    assert engine.make_vertices_fn(cfg, device="cpu") is None
    assert "MANO model unavailable" in capsys.readouterr().out


def test_eval_fps_protocol_runs_the_mesh_stage_on_cpu():
    stats, out = run_protocol(Config.from_yaml(ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"),
                              views=2, image_size=32, warmup=1, iters=2, device="cpu")
    assert stats["with_vertices"] and stats["forwards"] == 5
    assert out["vertices"].shape == (1, 778, 3) and out["vertices"].dtype == torch.float32
    assert torch.isfinite(out["vertices"]).all()
    # the step's vertices are the mesh stage of its joints_cam, in mm
    np.testing.assert_array_equal(out["vertices"].numpy(),
                                  build_mesh_stage("cpu")(out["joints_cam"] * 1000.0).numpy())
