"""Evaluation of a checkpoint on a config's val and test shards:
``python -m handmvnet_tpu_torch.eval --config configs/release/HO3D_HandMvNet.yaml``
``--checkpoint FILE [--no-vertices] [--batch-size 16] [--device cuda] [--num-devices N]``

The counterpart of handmvnet_tpu/eval.py (reference src/eval.py:55-110):
batch 16, as the reference forces; the config's model with the checkpoint's
weights (``checkpoint.load_torch_checkpoint``: the port's own ``.pt``, a
reference Lightning ``.ckpt`` or a ``.pth`` state_dict); one pass of the
val loader, then of the test loader, over the config's shards
(``train.build_dataloaders``: JPEG decode on the card, crops and heatmaps
there, on the loader's preparer thread), each scored by ``engine.evaluate``
with the vertex metrics unless ``--no-vertices``; ``val.json`` and
``test.json`` beside the checkpoint.
fp32 is full fp32 (TF32 off). Runs on the card unless ``--device cpu``.

Over N ranks, one a device: under ``torchrun --nproc-per-node N -m
handmvnet_tpu_torch.eval ...``, or N ranks that it starts on this host, N
being ``--num-devices``, else every card of the host (1 with ``--device
cpu``), as the JAX driver takes every device. The batch is divided over
them by the JAX driver's divisor rule (``eval_ranks``): each rank reads
batch // N samples a step, the split's samples dealt out by ordinal
(``build_dataloaders(..., by_sample=True)``), so that the ranks' batches of
a step are the batch one process reads, and a pass scores each sample that
one process scores, once (``check_dealt_out`` refuses a split that this
cannot hold for). ``evaluate`` gives every rank the metrics of the union;
rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from handmvnet_tpu_torch.checkpoint import load_torch_checkpoint
from handmvnet_tpu_torch.config import Config, refuse_absolute_root
from handmvnet_tpu_torch.data.loader import BatchLoader
from handmvnet_tpu_torch.engine import evaluate, make_vertices_fn, write_results_json
from handmvnet_tpu_torch.eval_fps import build_model
from handmvnet_tpu_torch.parallel import (
    init_data_parallel,
    is_main,
    launched,
    rank_and_world,
    start_local_ranks,
    warmup_collectives,
)
from handmvnet_tpu_torch.train import build_dataloaders, local_devices


def eval_ranks(batch_size: int, requested: int) -> int:
    """The ranks that evaluate a batch of ``batch_size`` when ``requested``
    are asked for: the most, up to both, that divide the batch
    (handmvnet_tpu/eval.py:51-55)."""
    usable = max(1, min(requested, batch_size))
    while batch_size % usable:
        usable -= 1
    return usable


def check_dealt_out(loader: BatchLoader, world: int) -> None:
    """Raise unless ``world`` ranks, each reading its share of the split
    through a loader like ``loader`` (one rank's), read together, once each,
    the samples of one process's pass: the split's shards must hold them
    all. Else one process's stream starts again within the pass and scores
    some samples twice, which the ranks' shares do not repeat."""
    need = len(loader) * loader.batch_size * world
    held = loader.dataset.count_samples()
    if held < need:
        split = loader.dataset.split
        raise ValueError(
            f"the {split} split cannot be dealt out over {world} ranks: its shards hold {held} "
            f"samples, fewer than the {need} of a pass ({len(loader)} batches of "
            f"{loader.batch_size * world}), so one process scores {need - held} of them twice "
            f"and {world} ranks would not; evaluate on one rank, or make "
            f"split_size_overrides.{split} the shards' count")


def main(argv=None) -> dict:
    """Evaluate; returns {"val": metrics, "test": metrics}."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--no-vertices", action="store_true")
    parser.add_argument("--batch-size", type=int, default=16,
                        help="reference eval.py:56 forces 16")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="evaluate over N ranks of this host, one a device (default: "
                             "every card; not under torchrun, which starts the ranks itself)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    device_type = torch.device(args.device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to evaluate on the CPU")
    if not launched():
        requested = args.num_devices or local_devices(device_type)
        ranks = eval_ranks(args.batch_size, requested)
        if ranks != requested:
            print(f"[warning] evaluating on {ranks} of {requested} ranks, so that each "
                  f"rank's share divides batch_size={args.batch_size}", flush=True)
        if ranks == 1:
            return _evaluate(args, torch.device(args.device))
        start_local_ranks(main, argv, ranks, device_type)
        out = Path(args.checkpoint).parent
        return {mode: json.loads((out / f"{mode}.json").read_text())[0]
                for mode in ("val", "test")}
    device, group = init_data_parallel(device_type)
    try:
        world = dist.get_world_size(group)
        if eval_ranks(args.batch_size, world) != world:
            raise ValueError(f"a batch of {args.batch_size} is not divided over {world} ranks: "
                             f"start {eval_ranks(args.batch_size, world)}")
        warmup_collectives(group, device)
        return _evaluate(args, device, group)
    finally:
        dist.destroy_process_group()


def _evaluate(args, device: torch.device, group: dist.ProcessGroup | None = None) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = rank_and_world(group)
    main_rank = is_main(group)

    cfg = Config.from_yaml(args.config)
    refuse_absolute_root(cfg, "eval.py")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=args.batch_size // world))
    ckpt_path = Path(args.checkpoint)
    model = build_model(cfg, views=cfg.model.num_views, image_size=cfg.data.image_size,
                        device="cpu")
    kind = load_torch_checkpoint(ckpt_path, model)
    model = model.to(device)
    if main_rank:
        ranks = f" ({cfg.data.batch_size} on each of {world} ranks)" if group is not None else ""
        print(f"loaded {kind} checkpoint {ckpt_path}; batch {args.batch_size}{ranks} x "
              f"{cfg.data.num_views} views, device {device}", flush=True)
    vertices_fn = None if args.no_vertices else make_vertices_fn(cfg, str(device))
    loaders = build_dataloaders(cfg, device, ("val", "test"), rank, world, by_sample=True)
    if world > 1:
        for loader in loaders:
            check_dealt_out(loader, world)

    results = {}
    for mode, loader in zip(("val", "test"), loaders):
        results[mode] = evaluate(model, loader, cfg, mode=mode, vertices_fn=vertices_fn,
                                 group=group)
        if main_rank:
            write_results_json(ckpt_path.parent / f"{mode}.json", results[mode])
            print(f"{mode}:", {k: v for k, v in results[mode].items() if "pck" not in k},
                  flush=True)
    return results


if __name__ == "__main__":
    main()
