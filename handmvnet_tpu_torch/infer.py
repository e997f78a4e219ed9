"""End-to-end inference and its panels:
``python -m handmvnet_tpu_torch.infer --config configs/release/HO3D_HandMvNet.yaml``
``[--checkpoint FILE] [--synthetic] [--output-dir outputs/infer] [--batch-size 1]``
``[--device cuda] [--view-mesh DxV]``

The counterpart of handmvnet_tpu/infer.py (the reference's infer_vis
notebook): the config's model with a checkpoint's weights (a ``.pt``,
``.ckpt`` or ``.pth``, as eval.py loads them; random weights, with a
warning, without one), one forward on a batch (a synthetic one with
``--synthetic``, else the first batch of the config's test split), the mesh
stage on its ``joints_cam * 1000`` with the config's MANO model (the
synthetic stand-in, with a warning, where the assets are absent), and four
panels in ``--output-dir``: joints2d.png (the predicted 2D joints on the
crops), heatmaps.png, joints3d.png and mesh.png. Runs on the card unless
``--device cpu``; fp32 is full fp32 (TF32 off). ``prepare``, ``infer_step``
and ``write_panels`` are the steps of ``main``, for callers that hold the
numbers apart from the drawing.

``--view-mesh DxV`` runs the step view-parallel over D x V ranks, one a
device (parallel/view_parallel.py): under torchrun with D x V ranks, or
started here on this host's devices as ``train.py --num-devices`` starts
them. Each rank runs its block of the batch; rank 0 gathers the per-view
entries and joints_cam, runs the mesh stage per sample and draws.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from handmvnet_tpu_torch.checkpoint import load_torch_checkpoint
from handmvnet_tpu_torch.config import Config, refuse_absolute_root
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.eval_fps import build_model
from handmvnet_tpu_torch.models.joints_to_vertices import joints_to_vertices_fn
from handmvnet_tpu_torch.models.mano import ManoLayer, load_mano_model, synthetic_mano_model
from handmvnet_tpu_torch.export import make_serving_step
from handmvnet_tpu_torch.parallel import (gather_outputs, init_data_parallel, is_main, launched,
                                          make_inference_mesh, make_view_parallel_forward,
                                          start_local_ranks)
from handmvnet_tpu_torch.train import build_dataloaders
from handmvnet_tpu_torch.train_step import batch_to_device

# each panel and the library that draws it
PANELS = {"joints2d.png": "cv2", "heatmaps.png": "cv2", "joints3d.png": "matplotlib",
          "mesh.png": "matplotlib"}
CHECKPOINT_SUFFIXES = (".pt", ".ckpt", ".pth")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default="",
                        help="a .pt, .ckpt or .pth file; omit for random weights")
    parser.add_argument("--synthetic", action="store_true",
                        help="use a synthetic batch instead of the dataset")
    parser.add_argument("--output-dir", default="outputs/infer")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--view-mesh", default="",
                        help="DxV: run view-parallel over D x V ranks, one a device")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def view_mesh_shape(args: argparse.Namespace, cfg: Config) -> tuple[int, int]:
    """(D, V) of ``--view-mesh DxV``, checked against the batch and the
    config's views as handmvnet_tpu/infer.py:102-116 checks them."""
    d, v = (int(t) for t in args.view_mesh.lower().split("x"))
    views = cfg.model.num_views
    if args.batch_size % d or views % v:
        raise SystemExit(f"--view-mesh {d}x{v} needs --batch-size divisible by {d} (got "
                         f"{args.batch_size}) and the config's views divisible by {v} (got "
                         f"{views})")
    return d, v


def prepare(args: argparse.Namespace, device: torch.device | None = None
            ) -> tuple[torch.nn.Module, dict, torch.nn.Module]:
    """The model with its weights, the batch (tensors on the device) and the
    mesh stage, all on ``device`` (default ``args.device``)."""
    device = torch.device(device or args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    ckpt = Path(args.checkpoint) if args.checkpoint else None
    if ckpt is not None and ckpt.suffix not in CHECKPOINT_SUFFIXES:
        raise ValueError(f"{ckpt}: the port loads {', '.join(CHECKPOINT_SUFFIXES)} checkpoint "
                         "files (checkpoint.load_torch_checkpoint), not the JAX package's "
                         "orbax directories")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = Config.from_yaml(args.config)
    refuse_absolute_root(cfg, "infer.py")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            batch_size=args.batch_size))
    model = build_model(cfg, views=cfg.model.num_views, image_size=cfg.data.image_size,
                        device="cpu")
    if ckpt is None:
        print("[warning] no checkpoint given: running with random weights", flush=True)
    else:
        load_torch_checkpoint(ckpt, model)
    model = model.to(device)

    if args.synthetic:
        batch = batch_to_device(synthetic_batch(
            args.batch_size, cfg.model.num_views, cfg.data.image_size, cfg.data.heatmap_size,
            with_heatmaps=False), device)
    else:
        (loader,) = build_dataloaders(cfg, device, ("test",))
        batches = iter(loader)
        try:
            batch = next(batches)
        finally:
            batches.close()

    return model, batch, load_mesh_stage(cfg, device)


def load_mesh_stage(cfg: Config, device: torch.device | str) -> torch.nn.Module:
    """The mesh stage over the config's MANO model, or over the synthetic
    stand-in, with a warning, where the assets are absent."""
    try:
        mano = ManoLayer(load_mano_model(cfg.data.mano_models_dir))
    except (FileNotFoundError, OSError):
        print("[warning] MANO assets unavailable; using the synthetic MANO stand-in",
              flush=True)
        mano = ManoLayer(synthetic_mano_model())
    return joints_to_vertices_fn(mano.to(device))


def infer_step(model: torch.nn.Module, mesh_stage: torch.nn.Module,
               batch: dict) -> dict[str, torch.Tensor]:
    """The forward on the batch, then the mesh stage on its joints_cam (m ->
    mm): joints_cam, joints_crop_img, heatmap and vertices [b, 778, 3] mm."""
    with torch.inference_mode():
        return make_serving_step(model, mesh_stage)(batch["rgb"], batch["bboxes"],
                                                    batch["intrinsic"])


def write_panels(out_dir: Path, batch: dict, out: dict, faces,
                 names=tuple(PANELS)) -> list[Path]:
    """Draw the panels ``names`` (of PANELS) of batch element 0 into
    ``out_dir``, as handmvnet_tpu/infer.py draws them; returns their paths."""
    from handmvnet_tpu_torch.vis.visualizer import HandPoseVisualizer

    host = {k: v.cpu().numpy() for k, v in batch.items() if isinstance(v, torch.Tensor)}
    pred = {k: v.cpu().numpy() for k, v in out.items()}
    vis = HandPoseVisualizer({**host, "joints_crop_img": pred["joints_crop_img"],
                              "heatmap": pred["heatmap"]}, faces)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name in names:
        path = out_dir / name
        if name == "joints3d.png":
            HandPoseVisualizer({"joints_cam": pred["joints_cam"]}, faces).visualize_3d_joints(
                0, save_path=str(path))
        elif name == "mesh.png":
            vis.render_mesh(pred["vertices"][0], faces, save_path=str(path))
        else:
            import cv2

            cv2.imwrite(str(path), vis.visualize_joints_2d_on_cropped_image()
                        if name == "joints2d.png" else vis.visualize_combined_heatmaps())
        paths.append(path)
    return paths


def view_parallel_step(args: argparse.Namespace, d: int, v: int, device: torch.device,
                       group: dist.ProcessGroup) -> tuple[dict, dict | None, torch.nn.Module]:
    """One rank's part of ``--view-mesh DxV``: (the batch, the step's
    global outputs on rank 0 and None elsewhere, the mesh stage)."""
    cfg = Config.from_yaml(args.config)
    model, batch, mesh_stage = prepare(args, device)
    mesh = make_inference_mesh(d, v, group)
    forward = make_view_parallel_forward(model, mesh, root_relative=cfg.train.root_relative)
    out = gather_outputs(mesh, forward(batch["rgb"], batch["bboxes"], batch["intrinsic"]))
    if not is_main(group):
        return batch, None, mesh_stage
    with torch.inference_mode():  # per sample, no collective
        out["vertices"] = mesh_stage(out["joints_cam"] * 1000.0)
    return batch, out, mesh_stage


def main(argv=None) -> dict[str, torch.Tensor] | None:
    """Run and draw; returns the step's outputs (None in a process that
    only started the ranks of ``--view-mesh``, and on the ranks but 0)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if not args.view_mesh:
        model, batch, mesh_stage = prepare(args)
        out = infer_step(model, mesh_stage, batch)
    else:
        d, v = view_mesh_shape(args, Config.from_yaml(args.config))
        device_type = torch.device(args.device).type
        if device_type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
        if not launched():
            start_local_ranks(main, argv, d * v, device_type)
            return None
        device, group = init_data_parallel(device_type)
        try:
            batch, out, mesh_stage = view_parallel_step(args, d, v, device, group)
        finally:
            dist.destroy_process_group()
        if out is None:
            return None
    print("joints_cam[0,0]:", out["joints_cam"][0, 0].cpu().numpy(), "(m, root-relative)")
    out_dir = Path(args.output_dir)
    write_panels(out_dir, batch, out, mesh_stage.mano.model.faces)
    print(f"wrote {out_dir}/{' '.join(PANELS)}", flush=True)
    return out


if __name__ == "__main__":
    main()
