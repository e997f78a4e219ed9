"""The port's dataset-sanity checks (handmvnet_tpu_torch/sanity.py) on the
CPU (``--device cpu``), as tests/test_sanity.py holds the JAX package's:
GT triangulation reproduces GT 3D on geometry-consistent shards and fails
loudly on random ones, the extrinsics scan, the GT-overlay panels, the CLI,
and the synthetic dataset written where the config's directory has none;
and the triangulation check against the JAX package's on the same shards.

Shards: the HO3D release layout (9 train, 3 test) of 2 samples of 5 views,
written by the port's writer (cv2 on the CPU: the JAX package's labels).

Tolerances: MPJPE < 0.1 mm on consistent shards and > 10 mm on random ones
(tests/test_sanity.py's); the port's per-batch MPJPE within 1e-3 mm of the
JAX package's on the same samples (measured 3.7e-5 mm: both fp32, the DLT's
SVDs differ in their last bits, on errors of ~2e-4 mm).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from handmvnet_tpu import sanity as jax_sanity
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu_torch import sanity
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"


def _write_config(root: Path, shard_dir: Path) -> Path:
    text, n = re.subn(r"(?m)^  dataset_dir: .*$", f"  dataset_dir: {shard_dir}",
                      CONFIG.read_text())
    assert n == 1
    path = root / "cfg.yaml"
    path.write_text(text)
    return path


def _make(root: Path, consistent: bool) -> tuple[Config, Path]:
    for split, n, seed in (("train", 9, 0), ("test", 3, 7)):
        write_synthetic_ho3d_shards(root, num_shards=n, samples_per_shard=2, num_views=5,
                                    split=split, seed=seed, consistent_geometry=consistent,
                                    device="cpu")
    path = _write_config(root, root)
    return Config.from_yaml(path), path


@pytest.fixture(scope="module")
def consistent(tmp_path_factory):
    return _make(tmp_path_factory.mktemp("sanity_ok"), consistent=True)


def test_gt_triangulation_reproduces_gt_3d(consistent):
    cfg, _ = consistent
    res = sanity.gt_triangulation_check(cfg, num_batches=2, batch_size=2, device="cpu")
    assert res["num_samples"] == 4 and len(res["per_batch_mm"]) == 2
    assert res["mpjpe_mm"] < 0.1  # the labels are true pinhole projections


def test_triangulation_check_matches_jax_on_the_same_shards(consistent):
    cfg, path = consistent
    ours = sanity.gt_triangulation_check(cfg, num_batches=3, batch_size=2, device="cpu")
    ref = jax_sanity.gt_triangulation_check(JaxConfig.from_yaml(str(path)), num_batches=3,
                                            batch_size=2)
    assert ours["num_samples"] == ref["num_samples"] == 6
    np.testing.assert_allclose(ours["per_batch_mm"], ref["per_batch_mm"], atol=1e-3, rtol=0)


def test_triangulation_check_has_teeth(tmp_path):
    cfg, path = _make(tmp_path, consistent=False)  # 2D labels unrelated to the 3D ones
    res = sanity.gt_triangulation_check(cfg, num_batches=1, batch_size=2, device="cpu")
    assert res["mpjpe_mm"] > 10.0
    with pytest.raises(SystemExit, match="does not reproduce GT 3D"):
        sanity.main(["--config", str(path), "--device", "cpu"])


def test_extrinsics_consistent(consistent):
    cfg, _ = consistent
    res = sanity.extrinsics_consistency_check(cfg, num_samples=4, device="cpu")
    assert res == {"consistent": True, "max_abs_drift": 0.0, "num_samples": 4}


def test_gt_overlay_panels(consistent, tmp_path):
    cfg, _ = consistent
    panels = sanity.gt_overlay_panels(cfg, out_dir=tmp_path, device="cpu")
    assert set(panels) == set(sanity.CANVASES)
    for name, canvas in panels.items():
        assert canvas.ndim == 3 and canvas.shape[-1] == 3 and canvas.dtype == np.uint8, name
        assert float(canvas.std()) > 1.0, f"{name} rendered blank"
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(sanity.PANELS)
    assert sanity.PANELS["joints3d.png"] == "matplotlib"
    # a machine without matplotlib names the cv2 panels alone
    only = tmp_path / "cv2_only"
    cv2_panels = tuple(n for n, lib in sanity.PANELS.items() if lib == "cv2")
    sanity.gt_overlay_panels(cfg, out_dir=only, device="cpu", names=cv2_panels)
    assert sorted(p.name for p in only.iterdir()) == sorted(cv2_panels)
    with pytest.raises(ValueError, match="no panels"):
        sanity.gt_overlay_panels(cfg, out_dir=only, device="cpu", names=("joints.png",))


def test_cli_passes_on_consistent_data(consistent, capsys, tmp_path):
    _, path = consistent
    summary = sanity.main(["--config", str(path), "--device", "cpu", "--out-dir",
                           str(tmp_path)])
    out = capsys.readouterr().out
    assert "OK: triangulation MPJPE" in out
    assert summary["extrinsics"]["consistent"] and summary["device"] == "cpu"
    assert summary["panels"] == sorted(sanity.CANVASES)
    assert (tmp_path / "joints3d.png").is_file()


def test_cli_needs_a_card_unless_told_cpu(consistent, monkeypatch):
    _, path = consistent
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        sanity.main(["--config", str(path)])


def test_ensure_dataset_writes_consistent_shards(tmp_path, monkeypatch):
    """A config whose dataset_dir has no shards gets every shard of the
    release layout under SANITY_DATA, and the checks pass on them."""
    monkeypatch.setattr(sanity, "SANITY_DATA", tmp_path / "sanity_data")
    cfg = Config.from_yaml(_write_config(tmp_path, tmp_path / "empty"))
    where = Path(sanity.ensure_dataset(cfg, device="cpu"))
    assert where == tmp_path / "sanity_data" / "ho3d"
    assert len(list(where.glob("HO3D_mv_train-*.tar"))) == 9
    assert len(list(where.glob("HO3D_mv_test-*.tar"))) == 3
    res = sanity.gt_triangulation_check(cfg, num_batches=1, batch_size=2, device="cpu")
    assert res["mpjpe_mm"] < 0.1


def test_sanity_at_denom_2_matches_jax(consistent, monkeypatch):
    """decode_scale_denom 2 (frames of 240 x 320, crop boxes halved): the
    triangulation check within 1e-3 mm of JAX's, the extrinsics scan equal,
    and the GT-overlay panels against JAX's python reader's (cv2 INTER_AREA;
    its native loader, which this test switches off, scales in libjpeg's
    DCT): the full-frame canvases bitwise, the crop canvas within one
    level (its crops are fp32 within 1e-5 of JAX's, rounded to uint8)."""
    import dataclasses

    from handmvnet_tpu.data import native_loader

    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    cfg, path = consistent
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, decode_scale_denom=2))
    jcfg = JaxConfig.from_yaml(str(path))
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, decode_scale_denom=2))
    ours = sanity.gt_triangulation_check(cfg, num_batches=2, batch_size=2, device="cpu")
    ref = jax_sanity.gt_triangulation_check(jcfg, num_batches=2, batch_size=2)
    assert ours["num_samples"] == ref["num_samples"] == 4
    np.testing.assert_allclose(ours["per_batch_mm"], ref["per_batch_mm"], atol=1e-3, rtol=0)
    assert sanity.extrinsics_consistency_check(cfg, num_samples=4, device="cpu") == \
        jax_sanity.extrinsics_consistency_check(jcfg, num_samples=4)
    ours = sanity.gt_overlay_panels(cfg, device="cpu")
    ref = jax_sanity.gt_overlay_panels(jcfg)
    assert set(ref) == set(ours)
    for name, canvas in ref.items():
        assert ours[name].shape == canvas.shape and ours[name].dtype == canvas.dtype, name
        diff = np.abs(ours[name].astype(int) - canvas.astype(int))
        assert diff.max() <= (1 if name == "joints2d_crop" else 0), (name, diff.max())
    assert ref["joints2d_full"].shape[0] == 240
