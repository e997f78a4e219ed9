"""Evaluation of a checkpoint on a config's val and test shards:
``python -m handmvnet_tpu_torch.eval --config configs/release/HO3D_HandMvNet.yaml``
``--checkpoint FILE [--no-vertices] [--batch-size 16] [--device cuda]``

The counterpart of handmvnet_tpu/eval.py (reference src/eval.py:55-110):
batch 16, as the reference forces; the config's model with the checkpoint's
weights (``checkpoint.load_torch_checkpoint``: the port's own ``.pt``, a
reference Lightning ``.ckpt`` or a ``.pth`` state_dict); one pass of the
val loader, then of the test loader, over the config's shards
(``train.build_dataloaders``: JPEG decode on the card, crops and heatmaps
there, on the loader's preparer thread), each scored by ``engine.evaluate`` with the vertex metrics unless
``--no-vertices``; ``val.json`` and ``test.json`` beside the checkpoint.
fp32 is full fp32 (TF32 off). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch

from handmvnet_tpu_torch.checkpoint import load_torch_checkpoint
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.engine import evaluate, make_vertices_fn, write_results_json
from handmvnet_tpu_torch.eval_fps import build_model
from handmvnet_tpu_torch.train import build_dataloaders


def main(argv=None) -> dict:
    """Evaluate; returns {"val": metrics, "test": metrics}."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--no-vertices", action="store_true")
    parser.add_argument("--batch-size", type=int, default=16,
                        help="reference eval.py:56 forces 16")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to evaluate on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = Config.from_yaml(args.config)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            batch_size=args.batch_size))
    ckpt_path = Path(args.checkpoint)
    model = build_model(cfg, views=cfg.model.num_views, image_size=cfg.data.image_size,
                        device="cpu")
    kind = load_torch_checkpoint(ckpt_path, model)
    model = model.to(device)
    print(f"loaded {kind} checkpoint {ckpt_path}; batch {args.batch_size} x "
          f"{cfg.data.num_views} views, device {device}", flush=True)
    vertices_fn = None if args.no_vertices else make_vertices_fn(cfg, str(device))
    val_loader, test_loader = build_dataloaders(cfg, device)

    results = {}
    for mode, loader in (("val", val_loader), ("test", test_loader)):
        results[mode] = evaluate(model, loader, cfg, mode=mode, vertices_fn=vertices_fn)
        write_results_json(ckpt_path.parent / f"{mode}.json", results[mode])
        print(f"{mode}:", {k: v for k, v in results[mode].items() if "pck" not in k},
              flush=True)
    return results


if __name__ == "__main__":
    main()
