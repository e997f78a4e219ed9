"""Port parity, view-parallel inference: handmvnet_tpu_torch.parallel's
view_parallel over gloo ranks (parallel.spawn_local_ranks, the rank side in
tests/torch_parallel_workers.py) against handmvnet_tpu.parallel's
make_view_parallel_forward on this process's virtual CPU devices, on the
same weights and inputs; the export's view-mesh bundle over the ranks and
``export.py --view-mesh --verify``; ``infer.py --view-mesh``; the refusals.

Sizes are tests/test_view_parallel.py's: the HO3D release model at full
width, views cut to 4, 32^2 images (4^2 heatmaps), batch 2; LeCun-scaled
random weights from a numpy seed (torch_parity.random_flax_variables). The
HR case is the HO3D HR release model at 2 views, 32^2, held against the
port's own forward (tests/test_torch_hrnet.py holds that against JAX).
Tolerances, each with the largest error measured on this CPU over both
grids:
  * against JAX's view-parallel forward at the same mesh,
    tests/test_torch_model.py's limits: heatmap 1e-4 (measured 3.9e-6),
    joints_crop_img 2e-2 px (2.2e-3), joints_cam 5e-4 (1.0e-5);
  * against the port's plain forward, JAX's own view-parallel limits
    (tests/test_view_parallel.py:52-62): heatmap 1e-5 (measured 0),
    joints_crop_img 1e-2 px (0), joints_cam 1e-4 (9.0e-6: the SampleNets'
    convs at another batch); the HR model 1.2e-7, 2.1e-4 px and 6.3e-8;
  * the replication check bitwise; the bundle's replay against the live
    view-parallel forward of the same ranks rel 1e-6 (measured 0).
"""

import json
import re
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.data.synthetic import synthetic_batch
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.parallel import make_inference_mesh as jax_make_inference_mesh
from handmvnet_tpu.parallel import make_view_parallel_forward as jax_make_view_parallel_forward
from handmvnet_tpu.parallel import view_data_sharding
from handmvnet_tpu_torch import infer
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.eval_fps import random_state_dict
from handmvnet_tpu_torch.export import export_view_parallel, load_bundle, save_bundle
from handmvnet_tpu_torch.export import main as export_main
from handmvnet_tpu_torch.infer import load_mesh_stage
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.parallel import (InferenceMesh, make_view_parallel_forward,
                                          spawn_local_ranks)
from torch_parallel_workers import cut_config, view_parallel_rank
from torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
HR_CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet_HR.yaml"
VIEWS, IMAGE, HEATMAP, BATCH = 4, 32, 4, 2
HR_VIEWS = 2
KEYS = ("rgb", "bboxes", "intrinsic")
AGAINST_JAX = {"heatmap": 1e-4, "joints_crop_img": 2e-2, "joints_cam": 5e-4}
AGAINST_PLAIN = {"heatmap": 1e-5, "joints_crop_img": 1e-2, "joints_cam": 1e-4}


def _jax_case():
    """The flax model, its variables and the batch (numpy)."""
    jcfg = cut_config(JaxConfig.from_yaml(CONFIG), VIEWS, IMAGE, HEATMAP, BATCH)
    batch = synthetic_batch(batch_size=BATCH, num_views=VIEWS, image_size=IMAGE,
                            heatmap_size=HEATMAP, with_heatmaps=False, seed=11)
    batch = {k: np.asarray(batch[k]) for k in KEYS}
    model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP)
    variables = random_flax_variables(model, 5, *(jnp.asarray(batch[k]) for k in KEYS))
    return model, variables, batch


def _port_model(config: Path, views: int, weights: dict) -> HandMvNet:
    cfg = cut_config(Config.from_yaml(config), views, IMAGE, HEATMAP, BATCH)
    model = HandMvNet(cfg.model, IMAGE, HEATMAP).eval()
    model.load_state_dict(weights)
    return model


def _plain(model: HandMvNet, batch: dict) -> dict:
    with torch.inference_mode():
        out = model(*(torch.from_numpy(batch[k]) for k in KEYS))
    return {k: v.numpy() for k, v in out.items()}


def _run_ranks(out: Path, inputs: dict, world: int, jax_work):
    """The ranks (view_parallel_rank) in a thread while ``jax_work()`` runs
    here; returns (every rank's record, jax_work's result)."""
    torch.save(inputs, out / "inputs.pt")
    failure = []

    def ranks():
        try:
            spawn_local_ranks(view_parallel_rank, (str(out),), world)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            failure.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    ref = jax_work()
    thread.join(timeout=600)
    assert not thread.is_alive(), f"the {world} ranks did not finish in 600 s"
    if failure:
        raise failure[0]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)], ref


def _jax_view_parallel(model, variables, batch, shape):
    """JAX's view-parallel forward at ``shape``."""
    mesh = jax_make_inference_mesh(*shape)
    args = [jax.device_put(jnp.asarray(batch[k]), view_data_sharding(mesh)) for k in KEYS]
    out = jax_make_view_parallel_forward(model, mesh)(variables, *args)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def one_by_two(tmp_path_factory):
    """A 1x2 grid of 2 gloo ranks: the forward, replication, bf16, and the
    replay of a 1x2 export bundle; JAX's 1x2 forward meanwhile."""
    out = tmp_path_factory.mktemp("view_1x2")
    model, variables, batch = _jax_case()
    weights = load_flax_variables(variables)
    port = _port_model(CONFIG, VIEWS, weights)
    cfg = cut_config(Config.from_yaml(CONFIG), VIEWS, IMAGE, HEATMAP, BATCH)
    mesh_stage = load_mesh_stage(cfg, "cpu")
    programs, shapes, mesh_meta = export_view_parallel(cfg, port, 1, 2, BATCH, "cpu",
                                                       mesh_stage=mesh_stage)
    save_bundle(out / "bundle", programs, cfg, shapes, "cpu", {"mesh": mesh_meta})
    inputs = {"mesh": (1, 2), "bundle": str(out / "bundle"), "models": {"resnet": {
        "config": str(CONFIG), "sizes": (VIEWS, IMAGE, HEATMAP, BATCH), "weights": weights,
        "batch": batch}}}
    ranks, ref = _run_ranks(out, inputs, 2,
                            lambda: _jax_view_parallel(model, variables, batch, (1, 2)))
    return {"ranks": ranks, "ref": ref, "plain": _plain(port, batch), "port": port,
            "batch": batch, "bundle": out / "bundle", "mesh_stage": mesh_stage}


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    """A 2x2 grid of 4 gloo ranks on the ResNet model and the HR model;
    JAX's 2x2 forward meanwhile."""
    out = tmp_path_factory.mktemp("view_2x2")
    model, variables, batch = _jax_case()
    weights = load_flax_variables(variables)
    hr_cfg = cut_config(Config.from_yaml(HR_CONFIG), HR_VIEWS, IMAGE, HEATMAP, BATCH)
    hr = HandMvNet(hr_cfg.model, IMAGE, HEATMAP).eval()
    hr.load_state_dict(random_state_dict(hr, 3))
    hr_batch = {k: v[:, :HR_VIEWS] for k, v in batch.items()}
    inputs = {"mesh": (2, 2), "models": {
        "resnet": {"config": str(CONFIG), "sizes": (VIEWS, IMAGE, HEATMAP, BATCH),
                   "weights": weights, "batch": batch},
        "hr": {"config": str(HR_CONFIG), "sizes": (HR_VIEWS, IMAGE, HEATMAP, BATCH),
               "weights": hr.state_dict(), "batch": hr_batch}}}
    ranks, ref = _run_ranks(out, inputs, 4,
                            lambda: _jax_view_parallel(model, variables, batch, (2, 2)))
    return {"ranks": ranks, "ref": ref,
            "plain": _plain(_port_model(CONFIG, VIEWS, weights), batch),
            "hr_plain": _plain(hr, hr_batch)}


@pytest.fixture(params=["1x2", "2x2"])
def grid(request, one_by_two, two_by_two):
    return {"1x2": one_by_two, "2x2": two_by_two}[request.param]


@pytest.mark.parametrize("key", sorted(AGAINST_JAX))
def test_view_parallel_matches_jax(grid, key):
    ref = grid["ref"][key]
    for seen in grid["ranks"]:  # gathered: every rank holds the whole batch
        got = seen["resnet"][key].numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=AGAINST_JAX[key], rtol=0, err_msg=key)


@pytest.mark.parametrize("key", sorted(AGAINST_PLAIN))
def test_view_parallel_matches_port_plain_forward(grid, key):
    got = grid["ranks"][0]["resnet"][key].numpy()
    np.testing.assert_allclose(got, grid["plain"][key], atol=AGAINST_PLAIN[key], rtol=1e-5,
                               err_msg=key)


def test_joints_cam_replicated_bitwise_across_view_columns(grid):
    """Each row's columns hold bitwise the same joints_cam, as JAX's
    make_replication_check asserts of its own (tests/test_view_parallel.py);
    it is the row's part of the gathered forward."""
    d = len(grid["ranks"]) // 2
    bd = BATCH // d
    for rank, seen in enumerate(grid["ranks"]):
        cols = seen["resnet replication"]
        assert cols.shape == (bd, 2, 21, 3)
        assert torch.equal(cols, cols[:, :1].expand_as(cols)), rank
        row = rank // 2
        assert torch.equal(cols[:, 0], seen["resnet"]["joints_cam"][row * bd:(row + 1) * bd])


def test_view_parallel_bf16_smoke(one_by_two):
    for seen in one_by_two["ranks"]:
        out = seen["resnet bf16"]
        assert out["joints_cam"].dtype == torch.float32
        assert out["joints_cam"].shape == (BATCH, 21, 3)
        assert all(torch.isfinite(v).all() for v in out.values())


def test_view_parallel_hrnet(two_by_two):
    """The HR model over the 2x2 grid against its plain forward."""
    for seen in two_by_two["ranks"]:
        for key, tol in AGAINST_PLAIN.items():
            np.testing.assert_allclose(seen["hr"][key].numpy(), two_by_two["hr_plain"][key],
                                       atol=tol, rtol=1e-5, err_msg=key)
        cols = seen["hr replication"]
        assert torch.equal(cols, cols[:, :1].expand_as(cols))


def test_view_mesh_bundle_replays_on_the_ranks(one_by_two):
    """tokens.pt2 on each rank's block, the all_gather, fuse.pt2: the live
    view-parallel forward's numbers, and the vertices of the mesh stage on
    the replay's joints_cam."""
    for seen in one_by_two["ranks"]:
        got, live = seen["resnet bundle"], seen["resnet"]
        assert set(got) == {"joints_cam", "joints_crop_img", "heatmap", "vertices"}
        for key in live:
            torch.testing.assert_close(got[key], live[key], rtol=1e-6, atol=0)
        with torch.inference_mode():
            want = one_by_two["mesh_stage"](got["joints_cam"] * 1000.0)
        assert got["vertices"].shape == (BATCH, 778, 3)
        torch.testing.assert_close(got["vertices"], want, rtol=1e-6, atol=1e-6)


def test_view_mesh_bundle_refuses_another_world_size(one_by_two):
    """JAX's device-count guard (tests/test_export.py:167-188): here the
    process has no process group, so a world of 1 against the bundle's 2."""
    with pytest.raises(RuntimeError, match=r"\[1, 2\] mesh \(2 ranks.*has 1"):
        load_bundle(one_by_two["bundle"], "cpu")


def test_refusals(one_by_two):
    """The JAX forward's refusals, with its messages: a view axis or a data
    axis that does not divide, and the absolute-root branch."""
    port, batch = one_by_two["port"], [torch.from_numpy(one_by_two["batch"][k]) for k in KEYS]
    with pytest.raises(ValueError, match=r"num_views=4 must divide over the view mesh axis \(3\)"):
        make_view_parallel_forward(port, InferenceMesh(1, 3, None, None, 0))(*batch)
    with pytest.raises(ValueError, match=r"batch=2 must divide over the data mesh axis \(3\)"):
        make_view_parallel_forward(port, InferenceMesh(3, 1, None, None, 0))(*batch)
    with pytest.raises(ValueError, match="root-relative"):
        make_view_parallel_forward(port, InferenceMesh(1, 2, None, None, 0), root_relative=False)


def _joints_printed(text: str) -> np.ndarray:
    (line,) = re.findall(r"joints_cam\[0,0\]: \[([^\]]*)\]", text)
    return np.array(line.split(), dtype=np.float64)


def _tiny_config(tmp_path) -> Path:
    """The HO3D release config at 2 views of 64^2."""
    raw = yaml.safe_load(CONFIG.read_text())
    raw["data"].update(image_size=64, heatmap_size=8, mano_models_dir=str(tmp_path / "no_mano"))
    raw["model"]["selected_views"] = [0, 1]
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    return cfg_path


def test_export_cli_view_mesh_bf16_verify(tmp_path, capfd):
    """``export.py --view-mesh 1x2 --compute-dtype bfloat16 --device cpu
    --verify``: the two programs and the manifest's mesh, then each of 2
    spawned ranks replays the bundle."""
    out = tmp_path / "bundle"
    export_main(["--config", str(_tiny_config(tmp_path)), "--out", str(out), "--device", "cpu",
                 "--view-mesh", "1x2", "--compute-dtype", "bfloat16", "--verify"])
    assert sorted(p.name for p in out.iterdir()) == ["fuse.pt2", "meta.json", "tokens.pt2"]
    meta = json.loads((out / "meta.json").read_text())
    assert meta["mesh"] == {"shape": [1, 2], "axis_names": ["data", "view"],
                            "compute_dtype": "bfloat16"}
    replayed = re.findall(r"replayed bundle: (.*)", capfd.readouterr().out)
    assert len(replayed) == 2 and all("'vertices': (1, 778, 3)" in r for r in replayed)


def test_infer_main_view_mesh(tmp_path, capfd):
    """``infer.py --view-mesh 1x2 --device cpu`` over 2 spawned ranks: rank
    0 draws the four panels, and its joints_cam is the one-process step's
    within JAX's view-parallel limit (1e-4)."""
    argv = ["--config", str(_tiny_config(tmp_path)), "--synthetic", "--device", "cpu"]
    assert infer.main(argv + ["--view-mesh", "1x2", "--output-dir", str(tmp_path / "vm")]) is None
    for name in infer.PANELS:
        assert (tmp_path / "vm" / name).stat().st_size > 0, name
    mesh_printed = _joints_printed(capfd.readouterr().out)
    one = infer.main(argv + ["--output-dir", str(tmp_path / "one")])
    np.testing.assert_allclose(mesh_printed, one["joints_cam"][0, 0].numpy(), atol=1e-4, rtol=0)


def test_infer_view_mesh_refuses_what_jax_refuses(tmp_path):
    """handmvnet_tpu/infer.py:102-116's check, before any rank starts."""
    with pytest.raises(SystemExit, match=r"--view-mesh 1x3 needs --batch-size divisible by 1 "
                                         r"\(got 1\) and the config's views divisible by 3 "
                                         r"\(got 5\)"):
        infer.main(["--config", str(CONFIG), "--synthetic", "--device", "cpu",
                    "--view-mesh", "1x3"])
    with pytest.raises(SystemExit, match="--batch-size divisible by 2 \\(got 1\\)"):
        infer.main(["--config", str(CONFIG), "--synthetic", "--device", "cpu",
                    "--view-mesh", "2x1"])
