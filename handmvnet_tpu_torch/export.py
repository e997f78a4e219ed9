"""Serving export: the whole inference step as a ``torch.export`` bundle
(counterpart of handmvnet_tpu/export.py).

``python -m handmvnet_tpu_torch.export --config CFG [--checkpoint FILE] --out DIR``
``[--batch-size 1] [--device cuda] [--view-mesh DxV] [--compute-dtype float32] [--verify]``

Exports the step that infer.py and eval_fps run, the HandMvNet forward and
then the mesh stage (SVD alignment, IK, MANO LBS) on ``joints_cam * 1000``,
as one ExportedProgram, and writes it with its manifest:

    <bundle>/
        exported.pt2   torch.export.save of the program, the weights inside
        meta.json      input schema, device, backbone, versions

The two kernels stay kernels in the program: they are the custom ops
``hmv::fused_attention`` and ``hmv::stem_conv`` (ops/attention.py,
ops/stem.py), nodes of the graph that launch csrc/'s kernels on the card.
So ``load_bundle`` needs torch and the port's op registrations, and no
model code, config or YAML. A bundle exported for one device runs on
another: ``load_bundle`` moves the program (``move_to_device_pass``), so a
bundle built on a CPU host serves on the card.

Where the JAX bundle differs: its program takes the weights as call
arguments beside an orbax ``params/``, where this one holds them; and
``--view-mesh DxV`` writes two programs in place of JAX's one sharded
artifact, since an ExportedProgram holds no collective across ranks:
tokens.pt2, the "tokens" trunk on one rank's [b/D, v/V] block, and
fuse.pt2, the "fuse" stage and the mesh stage on the row's gathered tokens
[b/D, v*21, feat]. ``load_bundle`` runs the trunk, the tokens' all_gather
over the row (parallel/view_parallel.py) and the head on each of D x V ranks.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
from torch import nn

from handmvnet_tpu_torch.ops import attention as _attention_op  # noqa: F401  hmv:: ops
from handmvnet_tpu_torch.ops import stem as _stem_op  # noqa: F401
from handmvnet_tpu_torch.parallel.mesh import start_local_ranks
from handmvnet_tpu_torch.parallel.view_parallel import (DATA_AXIS, VIEW_AXIS, make_inference_mesh,
                                                        stage_runner, view_parallel_forward)

ARTIFACT_NAME = "exported.pt2"
VIEW_MESH_PROGRAMS = {"tokens": "tokens.pt2", "fuse": "fuse.pt2"}
META_NAME = "meta.json"
FORMAT = "handmvnet_tpu_torch.export/1"
INPUTS = ("rgb", "bboxes", "intrinsic")


class _ServingStep(nn.Module):
    def __init__(self, model: nn.Module, mesh_stage: nn.Module | None, stage: str,
                 compute_dtype: str):
        super().__init__()
        self.model, self.mesh_stage = model, mesh_stage
        self.stage, self.compute_dtype = stage, compute_dtype

    def forward(self, x, *args):
        out = stage_runner(self.model, self.compute_dtype)(x, *args, stage=self.stage)
        if self.stage == "tokens":
            return out
        if self.stage == "fuse":
            out = {"joints_cam": out.to(torch.promote_types(out.dtype, torch.float32))}
        out["vertices"] = self.mesh_stage(out["joints_cam"] * 1000.0)
        return out


def make_serving_step(model: nn.Module, mesh_stage: nn.Module | None, stage: str = "full",
                      compute_dtype: str = "float32") -> nn.Module:
    """The serving program (handmvnet_tpu/export.py:48-57) as a module, in
    the compute dtype: the forward, then the mesh stage on joints_cam (m ->
    mm): joints_cam, joints_crop_img, heatmap and vertices [b, 778, 3] mm.
    With ``stage`` one program of the view-parallel step: "tokens" (rgb,
    bboxes, intrinsic -> tokens, joints_crop_img, heatmap; no mesh stage) or
    "fuse" (tokens -> joints_cam, vertices)."""
    return _ServingStep(model, mesh_stage, stage, compute_dtype)


def input_shapes(cfg, batch_size: int) -> dict[str, tuple[int, ...]]:
    v, s = cfg.model.num_views, cfg.data.image_size
    return {"rgb": (batch_size, v, s, s, 3), "bboxes": (batch_size, v, 4),
            "intrinsic": (batch_size, v, 4)}


def _export(module: nn.Module, args: tuple) -> torch.export.ExportedProgram:
    """Non-strict export of ``module`` in eval mode."""
    return torch.export.export(module.eval(), args, strict=False)


def export_serving(cfg, model: nn.Module, batch_size: int = 1, device: str = "cuda",
                   mesh_stage: nn.Module | None = None
                   ) -> tuple[torch.export.ExportedProgram, dict]:
    """The serving step of ``model`` (the config's) on ``device``, exported
    at the config's fp32 inputs [b, v, s, s, 3] / [b, v, 4] / [b, v, 4].
    ``mesh_stage`` defaults to the config's MANO model (infer.load_mesh_stage).
    Returns (program, input shapes)."""
    from handmvnet_tpu_torch.infer import load_mesh_stage

    mesh_stage = mesh_stage if mesh_stage is not None else load_mesh_stage(cfg, device)
    step = make_serving_step(model, mesh_stage).to(device)
    shapes = input_shapes(cfg, batch_size)
    return _export(step, tuple(torch.zeros(shapes[k], device=device) for k in INPUTS)), shapes


def export_view_parallel(cfg, model: nn.Module, data: int = 1, view: int = 2,
                         batch_size: int = 1, device: str = "cuda",
                         compute_dtype: str = "float32", mesh_stage: nn.Module | None = None
                         ) -> tuple[dict, dict, dict]:
    """The two programs of the (data x view) step (module docstring), each
    exported on ``device`` at one rank's shapes. Returns ({"tokens": program,
    "fuse": program}, the global input shapes, meta["mesh"])."""
    from handmvnet_tpu_torch.infer import load_mesh_stage

    shapes = input_shapes(cfg, batch_size)
    b, v = shapes["rgb"][:2]
    if b % data or v % view:
        raise ValueError(f"a {data}x{view} mesh needs the batch divisible by {data} (got {b}) "
                         f"and the views by {view} (got {v})")
    mesh_stage = mesh_stage if mesh_stage is not None else load_mesh_stage(cfg, device)
    model = model.to(device)
    block = tuple(torch.zeros((b // data, v // view, *shapes[k][2:]), device=device)
                  for k in INPUTS)
    feat = model.joints_late_fusion.attn_fusion[0].to_q.in_features
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    tokens = torch.zeros((b // data, v * cfg.model.num_joints, feat), device=device, dtype=dtype)
    programs = {
        "tokens": _export(make_serving_step(model, None, "tokens", compute_dtype), block),
        "fuse": _export(make_serving_step(model, mesh_stage.to(device), "fuse", compute_dtype),
                        (tokens,)),
    }
    mesh_meta = {"shape": [data, view], "axis_names": [DATA_AXIS, VIEW_AXIS],
                 "compute_dtype": compute_dtype}
    return programs, shapes, mesh_meta


def save_bundle(out_dir, exported, cfg, in_shapes: dict, device: str,
                extra_meta: dict | None = None) -> None:
    """Write ``exported`` (a program, or the view-mesh {"tokens", "fuse"}
    pair) and meta.json, whose keys are the JAX bundle's (:185-214) with
    ``device`` for ``platforms`` and ``torch_version``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    programs = exported if isinstance(exported, dict) else {None: exported}
    for stage, program in programs.items():
        torch.export.save(program, out / VIEW_MESH_PROGRAMS.get(stage, ARTIFACT_NAME))
    meta = {
        "format": FORMAT,
        "device": str(_device(device)),
        "backbone": cfg.model.backbone,
        "num_views": cfg.model.num_views,
        "image_size": cfg.data.image_size,
        "inputs": {k: list(v) for k, v in in_shapes.items()},
        "input_dtype": "float32",
        "outputs": "dict: heatmap, joints_crop_img, joints_cam, vertices",
        "torch_version": torch.__version__,
    }
    meta.update(extra_meta or {})
    (out / META_NAME).write_text(json.dumps(meta, indent=2) + "\n")


def _device(device: str | torch.device) -> torch.device:
    """``device`` with the current card's index where it names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _load_program(path: Path, exported_on: str, device: torch.device) -> nn.Module:
    program = torch.export.load(path)
    if torch.device(exported_on) != device:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return program.module()


def load_bundle(bundle_dir, device: str | torch.device = "cuda"):
    """Load a bundle onto ``device``: returns ``(fn, meta)``, where
    ``fn(rgb, bboxes, intrinsic) -> dict`` runs the program on the device
    (inputs: tensors or arrays, anywhere). Needs torch and the port's op
    registrations only. On ``cuda`` without a card it raises. fp32 is full
    fp32, as in infer.py: it switches TF32 off for matmuls and cuDNN convs.

    A view-mesh bundle runs on each rank of the initialised process group,
    which must have D x V ranks; ``fn`` takes the global batch and returns
    this rank's per-view entries and its row's joints_cam and vertices."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_bundle: no CUDA device; pass device='cpu' to serve on the CPU")
    device = _device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = Path(bundle_dir)
    meta = json.loads((bundle / META_NAME).read_text())

    def as_input(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(device)

    if "mesh" not in meta:
        step = _load_program(bundle / ARTIFACT_NAME, meta["device"], device)

        def fn(rgb, bboxes, intrinsic):
            with torch.inference_mode():
                return step(*(as_input(x) for x in (rgb, bboxes, intrinsic)))

        return fn, meta

    import torch.distributed as dist

    shape = meta["mesh"]["shape"]
    need = shape[0] * shape[1]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(f"bundle was exported over a {shape} mesh ({need} ranks, one a "
                           f"device); this process group has {world}")
    forward = view_parallel_forward(make_inference_mesh(*shape), *(
        _load_program(bundle / VIEW_MESH_PROGRAMS[s], meta["device"], device)
        for s in ("tokens", "fuse")))

    def fn(rgb, bboxes, intrinsic):
        return forward(*(as_input(x) for x in (rgb, bboxes, intrinsic)))

    return fn, meta


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default="",
                        help="a .pt, .ckpt or .pth file; omit for random weights")
    parser.add_argument("--out", required=True, help="bundle directory")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="the device the programs are exported on (load_bundle moves them)")
    parser.add_argument("--view-mesh", default="",
                        help="DxV: export the view-parallel step's two programs for D x V ranks")
    parser.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                        help="--view-mesh only: the ranks' compute dtype")
    parser.add_argument("--verify", action="store_true",
                        help="reload the bundle and replay it on a synthetic batch")
    args = parser.parse_args(argv)

    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.infer import prepare

    cfg = Config.from_yaml(args.config)
    device = torch.device(args.device)
    infer_args = argparse.Namespace(config=args.config, checkpoint=args.checkpoint,
                                    synthetic=True, batch_size=args.batch_size)
    model, batch, mesh_stage = prepare(infer_args, device)
    extra_meta = None
    if args.view_mesh:
        d, v = (int(t) for t in args.view_mesh.lower().split("x"))
        exported, in_shapes, mesh_meta = export_view_parallel(
            cfg, model, d, v, args.batch_size, device, args.compute_dtype, mesh_stage)
        extra_meta = {"mesh": mesh_meta}
    else:
        exported, in_shapes = export_serving(cfg, model, args.batch_size, device, mesh_stage)
    save_bundle(args.out, exported, cfg, in_shapes, device, extra_meta)
    out = Path(args.out)
    sizes = {p.name: p.stat().st_size for p in sorted(out.iterdir())}
    print(f"wrote {out}: {sizes} bytes, exported on {device}", flush=True)

    if args.verify:
        if args.view_mesh:
            host_batch = {k: t.cpu() for k, t in batch.items()}
            start_local_ranks(_verify_rank, (str(out), device.type, host_batch), d * v,
                              device.type)
        else:
            _verify(out, device, batch)


def _verify(bundle: Path, device: torch.device, batch: dict) -> None:
    fn, _ = load_bundle(bundle, device)
    out = fn(batch["rgb"], batch["bboxes"], batch["intrinsic"])
    print("replayed bundle:", {k: tuple(v.shape) for k, v in out.items()}, flush=True)


def _verify_rank(spec: tuple) -> None:
    """--verify of a view-mesh bundle on one of its ranks; ``spec`` is
    (bundle, device type, the batch on the host)."""
    import torch.distributed as dist

    from handmvnet_tpu_torch.parallel import init_data_parallel

    bundle, device_type, batch = spec
    device, _ = init_data_parallel(device_type)
    try:
        _verify(Path(bundle), device, batch)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
