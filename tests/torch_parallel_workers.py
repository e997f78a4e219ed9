"""Rank processes of tests/test_torch_parallel.py, started by
handmvnet_tpu_torch.parallel.spawn_local_ranks: each joins the env://
rendezvous on the CPU (gloo), does its part and writes what it saw to
``<out>/rank<r>.pt``. This module imports torch and the port only, so that
each new process starts quickly."""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import torch
import torch.distributed as dist

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.engine import evaluate
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.parallel import (StopSignal, broadcast_module_, init_data_parallel,
                                          rank_and_world)
from handmvnet_tpu_torch.train_step import accumulate_grads, create_train_state, optimizer_step


def cut_config(cfg, views: int, image: int, heatmap: int, batch: int):
    """A config of either package at a test size."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=tuple(range(views))),
        data=dataclasses.replace(cfg.data, image_size=image, heatmap_size=heatmap,
                                 batch_size=batch))


def step_and_evaluate(out: str) -> None:
    """From ``<out>/inputs.pt``: rank 0 loads the float64 weights and rank 1
    keeps PyTorch's initialisation, which the broadcast replaces; then one
    optimizer step on this rank's half of the batch (accumulation 2, dropout
    0), and evaluate on this rank's half of each eval batch from the given
    weights."""
    inputs = torch.load(Path(out) / "inputs.pt", weights_only=False)
    device, group = init_data_parallel("cpu")
    rank, world = rank_and_world(group)
    try:
        cfg = cut_config(Config.from_yaml(inputs["config"]), *inputs["sizes"])
        image, heatmap = cfg.data.image_size, cfg.data.heatmap_size

        def model_from_weights():
            model = HandMvNet(cfg.model, image, heatmap, dropout=0.0).double()
            model.load_state_dict(inputs["weights"])
            return model

        model = HandMvNet(cfg.model, image, heatmap, dropout=0.0).double()
        if rank == 0:
            model = model_from_weights()
        broadcast_module_(model, group)
        received = {k: v.clone() for k, v in model.state_dict().items()}

        def mine(batch):
            b = len(batch["rgb"]) // world
            return {k: torch.from_numpy(v[rank * b:(rank + 1) * b]) for k, v in batch.items()}

        state = create_train_state(model, cfg, steps_per_epoch=10)
        losses = accumulate_grads(state, cfg, mine(inputs["batch"]), None, 2, group)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        optimizer_step(state, cfg)
        metrics = evaluate(model_from_weights(), [mine(b) for b in inputs["eval_batches"]], cfg,
                           group=group)
        torch.save({"received": received, "losses": losses, "grads": grads,
                    "after": model.state_dict(), "metrics": metrics},
                   Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def train_and_record(argv: list, out: str) -> None:
    """train.main(argv) on this rank, recording the model's state after its
    last optimizer step and every file write of the checkpoints, the log,
    the TensorBoard directory, the vis hook's PNGs and val.json."""
    import cv2

    from handmvnet_tpu_torch import engine, train

    seen: dict = {"writes": []}
    real_step, real_save = train.train_step, engine.save_checkpoint
    real_log, real_results = engine.JsonlLogger.log, train.write_results_json
    real_logger, real_imwrite = engine.JsonlLogger.__init__, cv2.imwrite

    def step(state, *args, **kwargs):
        losses = real_step(state, *args, **kwargs)
        seen["after"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        return losses

    def save(path, state):
        seen["writes"].append(str(path))
        real_save(path, state)

    def log(self, record):
        seen["writes"].append(str(self.path))
        real_log(self, record)

    def results(path, values):
        seen["writes"].append(str(path))
        real_results(path, values)

    def logger(self, path, echo=True, tensorboard_dir=None):
        if tensorboard_dir is not None:
            seen["writes"].append(str(tensorboard_dir))
        real_logger(self, path, echo, tensorboard_dir)

    def imwrite(path, image):
        seen["writes"].append(str(path))
        return real_imwrite(path, image)

    train.train_step, engine.save_checkpoint = step, save
    engine.JsonlLogger.log, train.write_results_json = log, results
    engine.JsonlLogger.__init__, cv2.imwrite = logger, imwrite
    train.main(argv)
    torch.save(seen, Path(out) / f"rank{os.environ['RANK']}.pt")


def fail_on_rank_1() -> None:
    """Rank 1 raises; rank 0 waits for it in an all-reduce."""
    device, group = init_data_parallel("cpu")
    if dist.get_rank(group) == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1), group=group)


def stop_when_rank_1_asks(out: str) -> None:
    """Ten steps' StopSignal polls; rank 1 asks to stop at step 2. Writes the
    step at which this rank stopped."""
    device, group = init_data_parallel("cpu")
    rank = dist.get_rank(group)
    stop = StopSignal(device, group)
    try:
        for step in range(10):
            if rank == 1 and step == 2:
                stop.requested = True
            if stop.poll():
                break
        torch.save(step, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def view_parallel_rank(out: str) -> None:
    """One rank of tests/test_torch_view_parallel.py, from ``<out>/inputs.pt``:
    the (D, V) grid over the gloo ranks, then for each model of ``models``
    (config, sizes, weights) the view-parallel forward on the global batch,
    gathered, and its replication check; for the first model also the bf16
    forward and, where the inputs name one, the replay of a view-mesh
    export bundle. Writes {name: outputs} to ``<out>/rank<r>.pt``."""
    from handmvnet_tpu_torch.export import load_bundle
    from handmvnet_tpu_torch.parallel import (gather_outputs, make_inference_mesh,
                                              make_replication_check,
                                              make_view_parallel_forward)

    inputs = torch.load(Path(out) / "inputs.pt", weights_only=False)
    device, group = init_data_parallel("cpu")
    rank, _ = rank_and_world(group)
    try:
        mesh = make_inference_mesh(*inputs["mesh"], group)
        seen = {}
        for i, (name, case) in enumerate(inputs["models"].items()):
            cfg = cut_config(Config.from_yaml(case["config"]), *case["sizes"])
            model = HandMvNet(cfg.model, cfg.data.image_size, cfg.data.heatmap_size).eval()
            model.load_state_dict(case["weights"])
            batch = [torch.from_numpy(case["batch"][k]) for k in ("rgb", "bboxes", "intrinsic")]
            seen[name] = gather_outputs(mesh, make_view_parallel_forward(model, mesh)(*batch))
            seen[f"{name} replication"] = make_replication_check(model, mesh)(*batch)
            if i == 0:
                seen[f"{name} bf16"] = gather_outputs(
                    mesh, make_view_parallel_forward(model, mesh, "bfloat16")(*batch))
                if inputs.get("bundle"):
                    fn, _ = load_bundle(inputs["bundle"], "cpu")
                    seen[f"{name} bundle"] = gather_outputs(mesh, fn(*batch))
        torch.save(seen, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
