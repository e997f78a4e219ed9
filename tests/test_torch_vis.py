"""Port parity, the visualisation slice: handmvnet_tpu_torch.vis (the
visualizer and the z-buffer rasteriser), constants.close_mano_faces, the
trainer's per-epoch vis hook and its TensorBoard scalars, against the JAX
package's on identical numpy inputs, on the CPU.

Drawing is held bitwise: cv2 panels as arrays, matplotlib panels as decoded
PNG pixels. cv2 truncates coordinates to pixels, so the numbers that feed
the projection panels are held with a tolerance (the port projects on CPU
tensors, JAX through XLA, in other orders): within 1e-4 px of JAX's for
points in front of the cameras (measured 0). The random cameras of
tests/test_vis.py's batch put some points near a camera's plane, up to
15899 px off its 160 px frame, where the division by z turns float32
rounding into up to 4.9e-3 px: those are held to rel 2e-4 of their size
(measured 9.2e-5); they fall off the panels.
"""

import dataclasses
import json
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from handmvnet_tpu import constants as jax_constants
from handmvnet_tpu import train as jax_train
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.data.synthetic import synthetic_batch
from handmvnet_tpu.models.mano import synthetic_mano_model
from handmvnet_tpu.ops.camera import reproject_to_views as jax_reproject
from handmvnet_tpu.vis import mesh_render as jax_render
from handmvnet_tpu.vis import visualizer as jax_vis
from handmvnet_tpu_torch import constants, engine, train
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.vis import mesh_render, visualizer
from torch_parity import write_train_shards

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "release" / "HO3D_HandMvNet.yaml"
PX_TOL = 1e-4  # projected coordinates, pixels
POLE_RTOL = 2e-4  # ... of points near a camera's plane (random cameras)


def _batch(mesh: bool) -> dict:
    """tests/test_vis.py's batch: 3 views of 160 x 120 frames; with ``mesh``,
    its geometry made consistent (the template hand 300 mm in front of the
    root camera), else random cameras; masks and depths for their panels."""
    b = synthetic_batch(batch_size=1, num_views=3, seed=5)
    rng = np.random.default_rng(0)
    b["full_rgb"] = (rng.uniform(size=(1, 3, 120, 160, 3)) * 255).astype(np.uint8)
    b["joints_img"] = rng.uniform(10, 100, size=(1, 3, 21, 2)).astype(np.float32)
    b["mask"] = rng.uniform(size=(1, 3, 32, 32)).astype(np.float32)
    b["depth"] = rng.uniform(size=(1, 3, 1, 32, 32)).astype(np.float32)
    b["joints_img"][0, 1, 3] = np.nan  # a joint that is not drawn
    if mesh:
        m = synthetic_mano_model()
        b["vertices"] = ((m.v_template - m.v_template.mean(0)) * 1000.0)[None].astype(np.float32)
        b["intrinsic"] = np.tile(np.array([120.0, 120.0, 80.0, 60.0], np.float32), (1, 3, 1))
        b["extrinsic"] = np.tile(np.eye(4, dtype=np.float32), (1, 3, 1, 1))
        b["extrinsic"][0, 1, 0, 3] = 0.05  # view 1 moved 5 cm to the side
        b["root_joint"] = np.array([[[0.0, 0.0, 300.0]]], np.float32)
    return b


def _pair(mesh: bool):
    batch = _batch(mesh)
    return visualizer.HandPoseVisualizer(batch), jax_vis.HandPoseVisualizer(batch)


def test_constants_and_default_faces_match_jax():
    for name in ("HAND_EDGES", "HAND_EDGE_COLORS", "MANO_CLOSED_FIST_FACES"):
        assert getattr(constants, name) == getattr(jax_constants, name), name
    faces = synthetic_mano_model().faces
    closed = constants.close_mano_faces(faces)
    np.testing.assert_array_equal(closed, jax_constants.close_mano_faces(faces))
    assert closed.dtype == np.int32 and closed.shape == (len(faces) + 14, 3)
    ours, ref = _pair(mesh=False)
    np.testing.assert_array_equal(ours.faces, ref.faces)


def test_drawing_functions_bitwise():
    rng = np.random.default_rng(1)
    hwc = rng.normal(size=(24, 32, 3)).astype(np.float32)
    for img in (hwc, hwc.transpose(2, 0, 1)):
        np.testing.assert_array_equal(visualizer.reverse_transform(img),
                                      jax_vis.reverse_transform(img))
    assert [visualizer._edge_color_bgr(i) for i in range(20)] == \
        [jax_vis._edge_color_bgr(i) for i in range(20)]
    image = visualizer.reverse_transform(hwc)
    joints = rng.uniform(-4, 36, size=(21, 2)).astype(np.float32)
    joints[5] = np.inf
    for bones in (True, False):
        np.testing.assert_array_equal(visualizer.draw_joints_2d(image, joints, bones, 3),
                                      jax_vis.draw_joints_2d(image, joints, bones, 3))
    panels = [image, image[:20, :30], (image * 0.5).astype(np.uint8)]
    for cols in (None, 2):
        np.testing.assert_array_equal(visualizer._grid(panels, cols), jax_vis._grid(panels, cols))


def test_rasteriser_bitwise():
    batch = _batch(mesh=True)
    faces = constants.close_mano_faces(synthetic_mano_model().faces)
    verts = batch["vertices"][0] + batch["root_joint"][0]
    intr = batch["intrinsic"][0, 0]
    for args in ((verts, faces, intr, 120, 160), (verts, faces, intr, 64, 64, np.ones(3))):
        for got, want in zip(mesh_render.rasterize_mesh(*args), jax_render.rasterize_mesh(*args)):
            np.testing.assert_array_equal(got, want)
    background = batch["full_rgb"][0, 0]
    got = mesh_render.render_mesh_on_image(background, verts, faces, intr)
    want = jax_render.render_mesh_on_image(background, verts, faces, intr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] > 0).sum() > 100  # the hand covers pixels


ARRAY_PANELS = ["visualize_rgb_image", "visualize_full_rgb_image",
                "visualize_joints_2d_on_cropped_image", "visualize_joints_2d_on_full_image",
                "visualize_bboxes", "visualize_masks", "visualize_depths",
                "visualize_combined_heatmaps", "visualize_mesh_on_image",
                "visualize_projected_joints_2d_on_full_image",
                "visualize_projected_vertices_2d_on_full_image",
                "visualize_vertices_wireframe_on_full_image"]


@pytest.mark.parametrize("panel", ARRAY_PANELS)
def test_panels_bitwise(panel):
    """Every cv2 panel of HandPoseVisualizer on both batches. The projection
    panels agree bitwise here because their coordinates (held within
    PX_TOL below) truncate to the same pixels."""
    for mesh in (False, True):
        ours, ref = _pair(mesh)
        np.testing.assert_array_equal(getattr(ours, panel)(), getattr(ref, panel)(),
                                      err_msg=f"mesh={mesh}")


@pytest.mark.parametrize("key", ["joints_cam", "vertices"])
def test_projection_coordinates_match_jax(key):
    """The numbers the three projection panels draw: the root-relative
    points plus the root, projected into every view (JAX's expression of
    visualizer.py:213-260 and :337-366)."""
    for mesh in (False, True):
        batch = _batch(mesh)
        ours = visualizer.HandPoseVisualizer(batch)._project(batch[key][0], 0)
        points = batch[key][0] + batch["root_joint"][0]
        ref = np.asarray(jax_reproject(jnp.asarray(points[None] / 1000.0), 0,
                                       jnp.asarray(batch["intrinsic"][0][None]),
                                       jnp.asarray(batch["extrinsic"][0][None])))[0]
        assert ours.shape == ref.shape == (3, points.shape[0], 2)
        np.testing.assert_allclose(ours, ref, atol=PX_TOL, rtol=0 if mesh else POLE_RTOL)


def _png(path) -> np.ndarray:
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def test_matplotlib_panels_bitwise(tmp_path):
    """The 3D panels as decoded PNG pixels; the pred-vs-GT figure and the
    mesh card as the arrays they return."""
    ours, ref = _pair(mesh=True)
    batch = _batch(mesh=True)
    verts, faces = batch["vertices"][0], ours.faces
    for name, vis in (("port", ours), ("jax", ref)):
        vis.visualize_3d_joints(save_path=str(tmp_path / f"{name}_j3d.png"))
        vis.visualize_3d_vertices(save_path=str(tmp_path / f"{name}_v3d.png"))
        vis.render_mesh(verts, faces, save_path=str(tmp_path / f"{name}_mesh.png"))
    for panel in ("j3d", "v3d", "mesh"):
        got, want = _png(tmp_path / f"port_{panel}.png"), _png(tmp_path / f"jax_{panel}.png")
        assert got.shape == want.shape and got.size > 0, panel
        np.testing.assert_array_equal(got, want, err_msg=panel)
    pred = batch["joints_cam"][0]
    np.testing.assert_array_equal(ours.plot_joints_3d_predictions(pred, pred + 5.0),
                                  ref.plot_joints_3d_predictions(pred, pred + 5.0))
    for gt in (None, verts + 80.0):
        np.testing.assert_array_equal(ours.visualize_3d_mesh(verts, gt),
                                      ref.visualize_3d_mesh(verts, gt))


# ------------------------------------------------------------------ the trainer's hook


def _hook_case(tmp_path):
    """The HO3D release config at test size, a 2-sample batch and model
    outputs that put the predicted joints in front of every camera."""
    raw = yaml.safe_load(CONFIG.read_text())
    raw["data"].update(image_size=64, heatmap_size=8)
    raw["model"]["selected_views"] = [0, 1, 2]
    raw["train"]["vis_every_n_epochs"] = 1
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    batch = synthetic_batch(2, 3, 64, 8, seed=4, with_heatmaps=False)
    # three cameras side by side, 5 cm apart, all looking at the hand
    batch["extrinsic"] = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    batch["extrinsic"][:, :, 0, 3] = [0.0, 0.05, -0.05]
    rng = np.random.default_rng(6)
    out = {"joints_cam": (rng.normal(size=(2, 21, 3)) * 0.03).astype(np.float32),
           "joints_crop_img": rng.uniform(0, 64, size=(2, 3, 21, 2)).astype(np.float32)}
    return path, batch, out


def test_vis_hook_matches_jax(tmp_path, monkeypatch):
    """Both hooks on one batch and the same model outputs: joints2d_0.png
    the same pixels, and the projection into the crops within PX_TOL of
    JAX's project_crop (handmvnet_tpu/train.py:124-135); the port's
    projected panel is the drawing of its own projection."""
    path, batch, out = _hook_case(tmp_path)
    drawn = []
    real_plot = jax_vis.HandPoseVisualizer.plot_images_with_joints

    def record(images, joints, show=False):
        drawn.append(np.asarray(joints))
        return real_plot(images, joints)

    monkeypatch.setattr(jax_vis.HandPoseVisualizer, "plot_images_with_joints",
                        staticmethod(record))
    jax_hook = jax_train.make_vis_hook(JaxConfig.from_yaml(path),
                                       lambda state, b: {k: jnp.asarray(v) for k, v in out.items()},
                                       tmp_path / "jax")
    jax_hook(None, batch, 0, "train")

    cfg = Config.from_yaml(path)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    monkeypatch.setattr(train, "eval_step",
                        lambda model, b: {k: torch.from_numpy(v) for k, v in out.items()})
    train.make_vis_hook(cfg, tmp_path / "port")(None, tensors, 0, "train")

    ours = train.project_crop(cfg, torch.from_numpy(out["joints_cam"]), tensors).numpy()
    assert ours.shape == (2, 3, 21, 2)
    np.testing.assert_allclose(ours[0], drawn[1], atol=PX_TOL, rtol=0)
    port_dir, jax_dir = tmp_path / "port" / "vis" / "train", tmp_path / "jax" / "vis" / "train"
    np.testing.assert_array_equal(_png(port_dir / "joints2d_0.png"),
                                  _png(jax_dir / "joints2d_0.png"))
    np.testing.assert_array_equal(
        _png(port_dir / "projected_joints2d_0.png"),
        visualizer.HandPoseVisualizer.plot_images_with_joints(batch["rgb"][0], ours[0]))
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())

    every_2 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, vis_every_n_epochs=2))
    hook = train.make_vis_hook(every_2, tmp_path / "every_2")
    for epoch in (0, 1, 2):
        hook(None, tensors, epoch, "val")
    assert sorted(p.name for p in (tmp_path / "every_2" / "vis" / "val").iterdir()) == \
        ["joints2d_1.png", "projected_joints2d_1.png"]


@pytest.fixture(scope="module")
def shard_data(tmp_path_factory):
    return write_train_shards(tmp_path_factory.mktemp("shards"))


def _tiny_config(tmp_path, shard_data, **train_fields) -> str:
    raw = yaml.safe_load(CONFIG.read_text())
    raw["data"].update(image_size=64, heatmap_size=8, batch_size=2, **shard_data)
    raw["model"]["selected_views"] = [0, 1, 2]
    raw["train"].update(train_fields)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


def test_train_main_writes_vis_and_tensorboard(tmp_path, shard_data):
    """train.py with vis_every_n_epochs 1 (1 epoch x 2 steps on the shards)
    writes the JAX trainer's file set: the four PNGs of epoch 0, and tb/,
    whose scalars, read back with TensorBoard's EventAccumulator, are
    metrics.jsonl's numbers at step 0."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    out = tmp_path / "run"
    train.main(["--config", _tiny_config(tmp_path, shard_data, vis_every_n_epochs=1),
                "--epochs", "1", "--steps-per-epoch", "2", "--output-dir", str(out),
                "--device", "cpu"])
    for mode in ("train", "val"):
        for name in ("joints2d_0.png", "projected_joints2d_0.png"):
            image = _png(out / "vis" / mode / name)
            assert image is not None and image.shape == (64, 3 * 64, 3), (mode, name)
    (record,) = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    events = EventAccumulator(str(out / "tb"))
    events.Reload()
    numbers = {k: v for k, v in record.items()
               if isinstance(v, (int, float)) and k != "epoch"}
    assert set(events.Tags()["scalars"]) == set(numbers)
    for key, value in numbers.items():
        (scalar,) = events.Scalars(key)
        assert scalar.step == 0 and scalar.value == np.float32(value), key


def test_missing_cv2_fails_before_the_first_step(tmp_path, shard_data, monkeypatch):
    """A run whose hook will draw imports cv2 before step 1; one whose hook
    never fires does not need it."""
    steps = []
    monkeypatch.setattr(train, "train_step", lambda *a, **k: steps.append(1))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    argv = ["--epochs", "1", "--steps-per-epoch", "1", "--output-dir", str(tmp_path / "run"),
            "--device", "cpu", "--config"]
    with pytest.raises(ImportError):
        train.main(argv + [_tiny_config(tmp_path, shard_data, vis_every_n_epochs=1)])
    assert steps == []


def test_logger_without_tensorboard_warns_and_logs(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    logger = engine.JsonlLogger(tmp_path / "m.jsonl", echo=False, tensorboard_dir=tmp_path / "tb")
    logger.log({"epoch": 0, "loss": 1.5, "pck": [0.1, 0.2]})
    logger.close()
    assert capsys.readouterr().out.count("[warning] tensorboard unavailable") == 1
    assert json.loads((tmp_path / "m.jsonl").read_text()) == {"epoch": 0, "loss": 1.5,
                                                              "pck": [0.1, 0.2]}
    assert not (tmp_path / "tb").exists()
