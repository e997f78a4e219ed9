"""The harness on the CPU: every entry of BENCHMARK.json and of the reserved
fragments resolves to its files, both keep to the benchmark's contract, a
cell added as data files only is found, and the inputs depend on the seed
alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from hmvbench import harness, inputs
from hmvbench.tests.conftest import RESERVE, full_benchmark

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
FULL = full_benchmark()
ALL_CELLS = [w["name"] for w in FULL["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hmvbench"] and BENCH["command"] == ["python3", "hmvbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("bench", [BENCH, FULL], ids=["benchmark", "with_reserve"])
def test_names_units_and_keys(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    cells = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names)) and len(cells) == len(set(cells))
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell, FULL)
    kind = harness.traffic_kind(c.traffic["kind"])
    for fn in ("setup", "window", "traced_slice", "check", "compare", "release", "k1_calls",
               "stem_images", "flops"):
        assert callable(getattr(kind, fn))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(harness.metric_reader(m["name"]))
    assert set(c.limits) == set(kind.NUMBERS)  # a limit for each number compared
    config = next(x for x in FULL["configs"] if x["name"] == FULL["workloads"][
        ALL_CELLS.index(cell)]["config"])
    assert (REPO / config["file"]).is_file() and config["file"].startswith("hmvbench/")
    assert c.config["precision"] == "float32" and c.config["reduced"] == config["reduced"] == []


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"]:
        assert any(harness.applies(m, cell) for cell in CELLS)
    for m in BENCH["per_layer"]:
        assert any(m in harness.load_cell(cell).per_layer for cell in CELLS)


@pytest.mark.parametrize("path", sorted(RESERVE.glob("*.json")), ids=lambda p: p.stem)
def test_a_reserved_fragment_adds_its_cell_alone(path):
    """A fragment holds one cell that BENCHMARK.json lacks, and metrics that
    only it reports, so that adding the cell is pasting the fragment."""
    fragment = json.loads(path.read_text())
    assert set(fragment) == {"workloads", "end_to_end", "per_layer"}
    assert [w["name"] for w in fragment["workloads"]] == [path.stem]
    assert path.stem not in CELLS
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for m in fragment["end_to_end"] + fragment["per_layer"]:
        assert m["name"] not in names and m["workloads"] == [path.stem]


def test_a_cell_added_as_data_files_is_found(tmp_path):
    """A new cell is one BENCHMARK.json entry and one limits file; a new
    traffic mix one JSON file; nothing that is there is edited."""
    shutil.copytree(REPO / "hmvbench", tmp_path / "hmvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(FULL))
    mix = {"kind": "serve_closed_loop", "views": 4, "pool": 8, "warmup_frames": 2,
           "check_frames": 4, "reference_block": 4, "trace_frames": 4}
    (tmp_path / "hmvbench" / "traffic" / "serve_b1v4.json").write_text(json.dumps(mix))
    (tmp_path / "hmvbench" / "workloads" / "r50.serve.b1v4.json").write_text(
        json.dumps({"limits": {"heatmap_rel": 1.0, "crop_px": 1.0, "joints_mm": 1.0,
                               "vertices_mm": 1.0}}))
    bench["workloads"].append({"name": "r50.serve.b1v4", "config": "r50_paper",
                               "traffic": "serve_b1v4", "chips": 1, "why": "four cameras"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "r50.serve.b1v8" in m.get("workloads", ()):
            m["workloads"].append("r50.serve.b1v4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("r50.serve.b1v4", root=tmp_path / "hmvbench")
    assert cell.traffic["views"] == 4 and cell.limits["crop_px"] == 1.0
    assert {m["name"] for m in cell.end_to_end} == {"frame_p95_ms", "setup_s"}
    assert "k2_roofline.serve" in {m["name"] for m in cell.per_layer}


def test_a_metric_without_a_list_follows_what_it_moves():
    m = {"name": "x", "moves": "frame_p95_ms"}
    assert harness.applies(m, "any", {"frame_p95_ms", "setup_s"})
    assert not harness.applies(m, "any", {"train_samples_per_s", "setup_s"})


@pytest.mark.parametrize("labels", [False, True])
def test_inputs_depend_on_the_seed_alone(labels):
    a = inputs.make_frames(3, 2, 64, 8, 2**33 + 5, "cpu", labels)
    b = inputs.make_frames(3, 2, 64, 8, 2**33 + 5, "cpu", labels)
    c = inputs.make_frames(3, 2, 64, 8, 2**33 + 6, "cpu", labels)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert a[k].shape == c[k].shape and a[k].dtype == c[k].dtype
    assert not torch.equal(a["rgb"], c["rgb"])


def test_weights_and_mano_depend_on_the_seed_alone():
    from hmvbench import models
    cell = harness.load_cell("r50.train.b16v5")
    with torch.device("cpu"):
        w1 = models.weights(cell.config, 2, 7, "cpu")
        w2 = models.weights(cell.config, 2, 7, "cpu")
        w3 = models.weights(cell.config, 2, 8, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert any(not torch.equal(w1[k], w3[k]) for k in w1)
    m1, m2 = inputs.make_mano(7, "cpu"), inputs.make_mano(7, "cpu")
    assert all((m1[k] == m2[k]).all() for k in m1)


def test_frames_project_in_front_of_every_camera():
    f = inputs.make_frames(8, 5, 256, 32, 11, "cpu", labels=True)
    crop = f["joints_crop_img"]
    assert crop.min() > 0 and crop.max() < 256  # inside the crop
    assert torch.isfinite(f["heatmap"]).all() and f["heatmap"].amax() <= 1.0
