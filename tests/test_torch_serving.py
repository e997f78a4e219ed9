"""Port parity, the serving structure: the model's "tokens" and "fuse"
stages against flax's ``model.apply(..., stage=...)``, the kernels' custom
ops (``hmv::fused_attention``, ``hmv::stem_conv``) under
``torch.library.opcheck``, and the export bundle (handmvnet_tpu_torch.export)
against the live port step and against JAX's serving step
(``jax.jit(make_serving_step(...))``), on the CPU.

The model is the HO3D release config's at full width, views cut to 2, 64^2
crops (8^2 heatmaps), batch 2, LeCun-scaled random weights from a numpy seed
with the last GCN layer fitted so that the model predicts posed hands
(tests/test_torch_infer.py's ``_fit_hand_head``: on random joints the mesh
stage's IK is ill-conditioned). Tolerances, each with the largest error
measured on this CPU:
  * stages against flax: heatmap 1e-4 (measured 4.2e-6) and joints_cam 5e-4
    (3.9e-6, the fuse stages on flax's own tokens), tests/test_torch_model.py's
    limits; joints_crop_img 5e-2 px (measured 2.7e-2 px, above that file's
    2e-2: the x1000 soft-argmax amplifies logit noise of 4e-6 into hundredths
    of a pixel), chip_smoke.py's serving limit; the tokens 1e-2 (measured
    3.4e-3: the pos2d coordinates are joints_crop_img / 8, and the features
    sampled at them moved 2.6e-3);
  * the bundle's replay against the live port step rel 1e-6 (measured 0);
  * the bundle against JAX's serving step: the forward at the limits above
    (joints_cam measured 5.0e-5), the vertices 2e-2 mm against JAX's mesh
    stage on the replay's joints (measured 2.6e-3 mm) and 1e-1 mm against
    JAX's whole step, whose joints differ by the forward's 5.0e-5 m
    (measured 5.2e-2 mm on vertices of up to 127 mm).
"""

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_infer as infer_case
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.data.synthetic import synthetic_batch
from handmvnet_tpu.export import make_serving_step as jax_make_serving_step
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.models.joints_to_vertices import joints_to_vertices_fn as jax_j2v
from handmvnet_tpu.models.mano import ManoLayer as JaxManoLayer
from handmvnet_tpu.models.mano import synthetic_mano_model
from handmvnet_tpu_torch import export
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.infer import load_mesh_stage
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.ops.attention import attention_plain, fused_attention
from handmvnet_tpu_torch.ops.stem import stem_conv_nchw, stem_conv_plain
from torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
VIEWS, IMAGE, HEATMAP, BATCH = 2, infer_case.IMAGE, infer_case.HEATMAP, 2
KEYS = ("rgb", "bboxes", "intrinsic")
FORWARD_ATOL = {"heatmap": 1e-4, "joints_crop_img": 5e-2, "joints_cam": 5e-4, "tokens": 1e-2}
REPLAY_RTOL = 1e-6
VERTICES_SAME_JOINTS_ATOL, VERTICES_JAX_STEP_ATOL = infer_case.VERTICES_ATOL, 1e-1
# handmvnet_tpu/export.py:save_bundle's meta.json keys
JAX_META_KEYS = {"format", "platforms", "backbone", "num_views", "image_size", "inputs",
                 "input_dtype", "outputs", "jax_version"}
# the attention core's einsums (ops/attention.py::attention_plain)
ATTENTION_EQUATIONS = {"bhid,bhjd->bhij", "bhij,bhjd->bhid"}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Shared weights (flax variables, the port's model), the batch, the
    config file, and an export bundle of the port's serving step."""
    root = tmp_path_factory.mktemp("serving")
    raw = yaml.safe_load(CONFIG.read_text())
    raw["data"].update(image_size=IMAGE, heatmap_size=HEATMAP,
                       mano_models_dir=str(root / "no_mano"))
    raw["model"]["selected_views"] = list(range(VIEWS))
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cfg, jcfg = Config.from_yaml(cfg_path), JaxConfig.from_yaml(cfg_path)

    data = synthetic_batch(batch_size=BATCH, num_views=VIEWS, image_size=IMAGE,
                           heatmap_size=HEATMAP, seed=0, with_heatmaps=False)
    args = tuple(jnp.asarray(data[k]) for k in KEYS)
    flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP)
    variables = random_flax_variables(flax_model, 23, *args)
    infer_case._fit_hand_head(variables, cfg, data)
    port = HandMvNet(cfg.model, IMAGE, HEATMAP).eval()
    port.load_state_dict(load_flax_variables(variables))

    mesh_stage = load_mesh_stage(cfg, "cpu")
    program, shapes = export.export_serving(cfg, port, BATCH, "cpu", mesh_stage)
    export.save_bundle(root / "bundle", program, cfg, shapes, "cpu")
    batch = {k: torch.from_numpy(data[k]) for k in KEYS}
    fn, meta = export.load_bundle(root / "bundle", "cpu")
    return {"root": root, "cfg_path": cfg_path, "cfg": cfg, "data": data, "args": args,
            "batch": batch, "flax_model": flax_model, "variables": variables, "port": port,
            "mesh_stage": mesh_stage, "program": program, "meta": meta,
            "replay": fn(*(batch[k] for k in KEYS))}


# ------------------------------------------------------------------ stages


@pytest.mark.parametrize("key", ["tokens", "joints_crop_img", "heatmap"])
def test_tokens_stage_matches_flax(case, key):
    ref = jax.jit(lambda v, *a: case["flax_model"].apply(v, *a, stage="tokens"))(
        case["variables"], *case["args"])
    with torch.inference_mode():
        ours = case["port"](*(case["batch"][k] for k in KEYS), stage="tokens")
    assert set(ours) == set(ref)
    assert ours["tokens"].shape == (BATCH, VIEWS * 21, 524)
    np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=FORWARD_ATOL[key],
                               rtol=0, err_msg=key)


def test_fuse_stage_matches_flax(case):
    """Both fuse stages on flax's own tokens."""
    flax_model, variables = case["flax_model"], case["variables"]
    tokens = jax.jit(lambda v, *a: flax_model.apply(v, *a, stage="tokens"))(
        variables, *case["args"])["tokens"]
    ref = np.asarray(jax.jit(lambda v, t: flax_model.apply(v, t, stage="fuse"))(variables, tokens))
    with torch.inference_mode():
        ours = case["port"](torch.from_numpy(np.asarray(tokens)), stage="fuse")
    assert ours.shape == ref.shape == (BATCH, 21, 3)
    np.testing.assert_allclose(ours.numpy(), ref, atol=FORWARD_ATOL["joints_cam"], rtol=0)


def test_stages_compose_to_the_full_forward(case):
    """fuse(tokens(x)) is the full forward bitwise; the trunk of a subset of
    views gives those views' tokens."""
    port, batch = case["port"], [case["batch"][k] for k in KEYS]
    with torch.inference_mode():
        full = port(*batch)
        tk = port(*batch, stage="tokens")
        torch.testing.assert_close(port(tk["tokens"], stage="fuse"), full["joints_cam"],
                                   rtol=0, atol=0)
        for key in ("joints_crop_img", "heatmap"):
            torch.testing.assert_close(tk[key], full[key], rtol=0, atol=0)
        last = port(*(t[:, 1:] for t in batch), stage="tokens")
    torch.testing.assert_close(last["tokens"], tk["tokens"][:, 21:], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="stage 'trunk'"):
        port(*batch, stage="trunk")


# ------------------------------------------------------------------ the ops


def _attention_args(requires_grad: bool) -> tuple:
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, n, 8, 128, generator=gen).transpose(1, 2).requires_grad_(
        requires_grad) for n in (21, 84, 84))
    return q, k, v, 128 ** -0.5


def _stem_args(requires_grad: bool) -> tuple:
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 33, 31, 3, generator=gen).permute(0, 3, 1, 2).requires_grad_(
        requires_grad)
    return x, (torch.randn(64, 3, 7, 7, generator=gen) * 0.05).requires_grad_(requires_grad)


@pytest.mark.parametrize("requires_grad", [False, True], ids=["forward", "autograd"])
@pytest.mark.parametrize("op,make_args", [(torch.ops.hmv.fused_attention.default, _attention_args),
                                          (torch.ops.hmv.stem_conv.default, _stem_args)],
                         ids=["fused_attention", "stem_conv"])
def test_opcheck(op, make_args, requires_grad):
    """Schema, autograd registration, fake against real (shapes, dtypes and
    strides) and AOT dispatch, on the CPU implementation."""
    torch.library.opcheck(op, make_args(requires_grad))


def test_ops_cpu_implementations_are_the_plain_versions_in_the_kernels_layout():
    """On CPU tensors each op computes its plain version, in the layout its
    CUDA kernel writes: attention [B, Nq, H, D] seen as [B, H, Nq, D], the
    stem contiguous NCHW (from a channels-last view of the images)."""
    q, k, v, scale = _attention_args(False)
    out = fused_attention(q, k, v, scale)
    torch.testing.assert_close(out, attention_plain(q, k, v, scale), rtol=0, atol=0)
    assert out.stride() == torch.empty(2, 21, 8, 128).transpose(1, 2).stride()
    x, weight = _stem_args(False)
    out = stem_conv_nchw(x, weight)
    torch.testing.assert_close(out, stem_conv_plain(x, weight), rtol=0, atol=0)
    assert out.is_contiguous() and out.shape == (2, 64, 17, 16)


# ------------------------------------------------------------------ the export


def test_bundle_replay_matches_the_live_step(case):
    step = export.make_serving_step(case["port"], case["mesh_stage"])
    with torch.inference_mode():
        live = step(*(case["batch"][k] for k in KEYS))
    assert set(case["replay"]) == set(live) == {"joints_cam", "joints_crop_img", "heatmap",
                                                "vertices"}
    for key, want in live.items():
        torch.testing.assert_close(case["replay"][key], want, rtol=REPLAY_RTOL, atol=0,
                                   msg=key)


def test_bundle_matches_jax_serving_step(case):
    mesh_stage = jax.jit(jax_j2v(JaxManoLayer(synthetic_mano_model())))
    step = jax_make_serving_step(case["flax_model"], mesh_stage)
    ref = {k: np.asarray(v) for k, v in jax.jit(step)(case["variables"], *case["args"]).items()}
    got = {k: v.numpy() for k, v in case["replay"].items()}
    assert set(got) == set(ref)
    np.testing.assert_allclose(ref["joints_cam"], infer_case.hand_joints(BATCH), atol=1e-4)
    for key in ("heatmap", "joints_crop_img", "joints_cam"):
        np.testing.assert_allclose(got[key], ref[key], atol=FORWARD_ATOL[key], rtol=0,
                                   err_msg=key)
    same_joints = np.asarray(mesh_stage(jnp.asarray(got["joints_cam"]) * 1000.0))
    np.testing.assert_allclose(got["vertices"], same_joints, atol=VERTICES_SAME_JOINTS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["vertices"], ref["vertices"], atol=VERTICES_JAX_STEP_ATOL,
                               rtol=0)


def _calls(program) -> Counter:
    return Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")


def test_exported_graph_holds_the_kernels_as_ops(case):
    """One hmv::fused_attention node a fusion block and one hmv::stem_conv,
    never the plain attention's einsums or a conv of the stem's weight."""
    program = case["program"]
    calls = _calls(program)
    assert calls["hmv.fused_attention.default"] == case["cfg"].model.fusion_layers == 5
    assert calls["hmv.stem_conv.default"] == 1
    assert not any("attention" in name for name in calls if not name.startswith("hmv."))
    equations = {n.args[0] for n in program.graph.nodes if n.op == "call_function"
                 and str(n.target) == "aten.einsum.default"}
    assert equations and not equations & ATTENTION_EQUATIONS
    stem_weight = program.graph_signature.inputs_to_parameters
    (placeholder,) = [n for n in program.graph.nodes
                      if stem_weight.get(n.name) == "model.backbone.conv1.weight"]
    assert [str(u.target) for u in placeholder.users] == ["hmv.stem_conv.default"]


def test_bundle_meta_has_jax_keys(case):
    meta = case["meta"]
    assert set(meta) == JAX_META_KEYS - {"platforms", "jax_version"} | {"device",
                                                                          "torch_version"}
    assert meta["format"] == "handmvnet_tpu_torch.export/1" and meta["device"] == "cpu"
    assert meta["inputs"]["rgb"] == [BATCH, VIEWS, IMAGE, IMAGE, 3]
    assert sorted(p.name for p in (case["root"] / "bundle").iterdir()) == [
        "exported.pt2", "meta.json"]


def test_load_bundle_imports_no_model_code(case, tmp_path):
    """A fresh process loads and replays the bundle with torch and the op
    registrations alone: no model, config or YAML module is imported."""
    torch.save(case["batch"], tmp_path / "batch.pt")
    code = (
        "import json, sys, torch\n"
        "from handmvnet_tpu_torch.export import load_bundle\n"
        "fn, meta = load_bundle(sys.argv[1], 'cpu')\n"
        "b = torch.load(sys.argv[2])\n"
        "torch.save(fn(b['rgb'], b['bboxes'], b['intrinsic']), sys.argv[3])\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith('handmvnet'))))\n")
    done = subprocess.run([sys.executable, "-c", code, str(case["root"] / "bundle"),
                           str(tmp_path / "batch.pt"), str(tmp_path / "out.pt")],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert done.returncode == 0, done.stderr
    loaded = json.loads(done.stdout.strip().splitlines()[-1])
    assert "handmvnet_tpu_torch.ops.attention" in loaded
    assert not [m for m in loaded if m.startswith(("handmvnet_tpu_torch.models",
                                                   "handmvnet_tpu_torch.config"))], loaded
    out = torch.load(tmp_path / "out.pt")
    for key, want in case["replay"].items():
        torch.testing.assert_close(out[key], want, rtol=0, atol=0)


def test_load_bundle_onto_a_missing_card_raises(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_bundle(case["root"] / "bundle", "cuda")


def test_export_cli_cpu_verify(case, tmp_path, capsys):
    """``python -m handmvnet_tpu_torch.export --device cpu --verify``: the
    bundle's files, the kernels' nodes (5 and 1) and the replay's shapes."""
    out = tmp_path / "bundle"
    export.main(["--config", str(case["cfg_path"]), "--out", str(out), "--device", "cpu",
                 "--verify"])
    assert (out / "exported.pt2").stat().st_size > 0
    assert json.loads((out / "meta.json").read_text())["inputs"]["rgb"] == [
        1, VIEWS, IMAGE, IMAGE, 3]
    calls = _calls(torch.export.load(out / "exported.pt2"))
    assert (calls["hmv.fused_attention.default"], calls["hmv.stem_conv.default"]) == (5, 1)
    printed = capsys.readouterr().out
    assert "no checkpoint given" in printed
    assert "'vertices': (1, 778, 3)" in printed and "'joints_cam': (1, 21, 3)" in printed
