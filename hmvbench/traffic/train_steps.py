"""Training steps back to back: the program's ``train_step`` on one
``TrainState`` (its model, AdamW and MultiStepLR), batch after batch from a
pool of ``pool`` distinct synthetic batches made on the device from the
seed, with gradient accumulation over microbatches and dropout masks from
one seeded generator. The data path (shards, decode, augmentation) is not
run.

Set-up drives the state through its first three steps on the pool's first
three batches, records what the reference is held to (each step's loss
terms; each leaf's first gradient, as AdamW's first moment holds it; each
leaf's change after the first step and after the three; the BatchNorm
statistics), and hands the same state to the window. The window's rate counts the samples of every
step it enqueued, over the time until the last one finished.

Parameters (``traffic/<mix>.json``): batch, views, accumulate, pool,
trace_steps.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field

import torch

from hmvbench import counts, inputs, models, trace
from hmvbench.reference import train as ref_train

CHECKED_STEPS = 3
NUMBERS = ("loss1_rel", "grad_leaf", "change1_leaf", "change_median", "bn1_leaf")  # compared, each with its limit
# leaves whose first gradient in the reference is under this share of the
# median leaf's (a bias feeding a batch-statistic BatchNorm: nought up to
# rounding) move under AdamW by rounding alone: their change is not judged
STILL_LEAF = 1e-3


@dataclass
class State:
    cfg: object
    train_state: object
    pool: dict
    order: list
    generator: torch.Generator
    record: dict = field(default_factory=dict)


def _batch(state: State, p: dict, i: int) -> dict:
    b = p["batch"]
    return {k: v[i * b:(i + 1) * b] for k, v in state.pool.items()}


def _bn_stats(model) -> dict:
    return {n: t.detach().clone() for n, t in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in tensors.items()}


def step_fn():
    """The program's step, looked up at each call."""
    from handmvnet_tpu_torch import train_step
    return train_step.train_step


def setup(run) -> State:
    p, config = run.cell.traffic, run.cell.config
    models.set_precision(run.precision)
    cfg = models.program_config(config, p["views"], p["batch"])
    from handmvnet_tpu_torch.train_step import create_train_state
    weights = models.weights(config, p["views"], run.seed, run.device)
    run.mark("weights")
    model = models.program_model(cfg, config, weights, run.device)
    run.mark("model")
    # one HO3D epoch of steps: the LR's first milestone lies far past any run
    train_state = create_train_state(model, cfg, steps_per_epoch=config["steps_per_epoch"])
    run.mark("optimizer")
    pool = inputs.make_frames(p["pool"] * p["batch"], p["views"], cfg.data.image_size,
                              cfg.data.heatmap_size, run.seed, run.device, labels=True)
    order = random.Random(inputs.sub_seed(run.seed, "order")).sample(range(p["pool"]), p["pool"])
    state = State(cfg, train_state, pool, order, inputs.generator(run.seed, "dropout", run.device))
    run.mark("batches")
    start = {n: w for n, w in weights.items() if n in dict(model.named_parameters())}
    beta1 = train_state.optimizer.param_groups[0]["betas"][0]
    losses = []
    for i in range(CHECKED_STEPS):  # the window's own call on the pool's first batches
        out = step_fn()(train_state, cfg, _batch(state, p, i), state.generator, p["accumulate"])
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            # an optimizer that did not step holds no moments: no gradient reached it
            moments = train_state.optimizer.state
            state.record["grad"] = _norms({
                n: moments[q]["exp_avg"] / (1.0 - beta1) if "exp_avg" in moments.get(q, {})
                else torch.zeros(()) for n, q in model.named_parameters()})
            state.record["change1"] = _norms({n: q.detach() - start[n]
                                              for n, q in model.named_parameters()})
            state.record["bn1"] = _norms({n: t - weights[n] for n, t in _bn_stats(model).items()})
    state.record.update(
        losses=losses,
        change=_norms({n: q.detach() - start[n] for n, q in model.named_parameters()}),
        bn=_norms({n: t - weights[n] for n, t in _bn_stats(model).items()}))
    return state


def _steps(run, state: State, count: int | None, deadline: float | None) -> int:
    """Enqueue steps on the pool in the seeded order, after the checked ones,
    until ``count`` steps or the deadline; return how many."""
    p, n = run.cell.traffic, 0
    while (count is None or n < count) and (deadline is None or time.perf_counter() < deadline):
        k = state.order[(CHECKED_STEPS + state.record.setdefault("steps", 0)) % p["pool"]]
        out = step_fn()(state.train_state, state.cfg, _batch(state, p, k), state.generator,
                        p["accumulate"])
        state.record["finite"] = state.record.get("finite", 0) + torch.isfinite(out["loss"]).int()
        state.record["steps"] += 1
        n += 1
    return n


def window(run, state: State) -> None:
    p = run.cell.traffic
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    steps = _steps(run, state, None, start + run.seconds)
    if run.device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    finite = int(state.record.pop("finite", 0))
    run.window.update(attempted=steps, failed=steps - finite, seconds=elapsed, units=steps,
                      peak_bytes=torch.cuda.max_memory_allocated() if run.device == "cuda" else 0)
    run.values.update(train_samples_per_s=steps * p["batch"] / elapsed)


def traced_slice(run, state: State) -> None:
    """``trace_steps`` steps traced twice: the device alone, then with the
    host's calls, a range around each step, the backbone's forwards (module
    hooks) and the optimizer's steps (the global optimizer hooks)."""
    from torch.optim.optimizer import (
        register_optimizer_step_post_hook,
        register_optimizer_step_pre_hook,
    )
    from torch.profiler import record_function
    n, out = run.cell.traffic["trace_steps"], []
    with trace.traced(out, n, host=False):
        _steps(run, state, n, None)
    open_ranges = []

    def opener(name):
        return lambda *_: open_ranges.append(record_function(f"hmvbench::{name}").__enter__())

    def closer(*_):
        open_ranges.pop().__exit__(None, None, None)

    backbone = state.train_state.model.backbone
    hooks = [backbone.register_forward_pre_hook(opener("backbone")),
             backbone.register_forward_hook(closer),
             register_optimizer_step_pre_hook(opener("optimizer")),
             register_optimizer_step_post_hook(closer)]
    try:
        with trace.traced(out, n, host=True):
            for _ in range(n):
                with record_function("hmvbench::step"):
                    _steps(run, state, 1, None)
    finally:
        for h in hooks:
            h.remove()
    state.record.pop("finite", None)
    run.summary, run.host_summary = out


def k1_calls(run) -> list:
    """K1's forward calls in an optimizer step: every microbatch's five."""
    p = run.cell.traffic
    return counts.k1_calls(run.cell.config["model"], p["batch"] // p["accumulate"],
                           p["views"]) * p["accumulate"]


def stem_images(run) -> list[int]:
    """The images of each forward stem conv a step runs: one a microbatch."""
    p = run.cell.traffic
    return [p["batch"] // p["accumulate"] * p["views"]] * p["accumulate"]


def flops(run) -> float:
    """An optimizer step's forward and backward operations, counted on the
    frozen reference."""
    p = run.cell.traffic
    return counts.train_step_flops(run.cell.config, p["batch"], p["views"], p["accumulate"])


def reference_record(run, state: State, tf32: bool = False) -> dict:
    """The reference's three steps from the same weights, on the same
    batches, with a generator in the same state for the dropout masks."""
    p, config = run.cell.traffic, run.cell.config
    models.set_precision(run.precision, tf32)
    weights = models.weights(config, p["views"], run.seed, run.device)
    model = models.reference_model(config, p["views"], run.device)
    model.load_state_dict(weights)
    params = dict(model.named_parameters())
    opt = ref_train.AdamW(params.values(), config["train"]["lr"],
                          config["train"]["weight_decay"])
    gen = inputs.generator(run.seed, "dropout", run.device)
    train = dict(config["train"])
    record = {"losses": []}
    for i in range(CHECKED_STEPS):
        out = ref_train.train_step(model, opt, _batch(state, p, i), train,
                                   float(config["data"]["image_size"]), p["accumulate"], gen)
        record["losses"].append({k: float(v) for k, v in out.items()})
        if i == 0:
            record["grad"] = _norms({n: m / (1.0 - opt.betas[0])
                                     for n, m in zip(params, opt.m)})
            record["change1"] = _norms({n: q.detach() - weights[n] for n, q in params.items()})
            record["bn1"] = _norms({n: t - weights[n] for n, t in _bn_stats(model).items()})
    record["change"] = _norms({n: q.detach() - weights[n] for n, q in params.items()})
    record["bn"] = _norms({n: t - weights[n] for n, t in _bn_stats(model).items()})
    models.set_precision(run.precision)
    return record


def _leaf_gaps(got: dict, want: dict, names) -> list[float]:
    """Each leaf's gap between the two sides' norms, over the larger of the
    reference's norm of that leaf and of the median leaf; infinite where a
    side is not finite."""
    median = sorted(want.values())[len(want) // 2]
    gaps = [abs(got[n] - want[n]) / max(want[n], median) for n in names]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def _moving(want: dict) -> list[str]:
    """The leaves whose first gradient in the reference is not still."""
    median = sorted(want["grad"].values())[len(want["grad"]) // 2]
    return [n for n, g in want["grad"].items() if g >= STILL_LEAF * median]


def _loss_gap(got: dict, want: dict) -> float:
    gap = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    return gap if math.isfinite(gap) else math.inf


def compare(got: dict, want: dict) -> dict:
    """The numbers judged: the first step's worst relative gap of a loss
    term; the worst leaf's gap of the first gradient, of its change after
    the first step (both sides step from the same weights: a leaf left
    unmoved or moved twice reads about 1) and of the BatchNorm statistics'
    change after the first step; the median leaf's gap of the change after
    the three steps. Leaves whose reference gradient is still are left out
    of both changes. The later steps' losses and the worst leaf's change
    after three are not judged: AdamW's first steps move each element by
    about the learning rate whatever the size of its gradient, so an element
    whose gradient is rounding on either side moves by either sign, and
    those readings swing from seed to seed as much in sound runs as in the
    control (``diagnostics``)."""
    moving = _moving(want)
    change = sorted(_leaf_gaps(got["change"], want["change"], moving))
    return {"loss1_rel": _loss_gap(got["losses"][0], want["losses"][0]),
            "grad_leaf": max(_leaf_gaps(got["grad"], want["grad"], want["grad"])),
            "change1_leaf": max(_leaf_gaps(got["change1"], want["change1"], moving)),
            "change_median": change[len(change) // 2],
            "bn1_leaf": max(_leaf_gaps(got["bn1"], want["bn1"], want["bn1"]))}


def diagnostics(got: dict, want: dict) -> dict:
    """Readings that are reported by ``calibrate.py`` and not judged: each
    step's worst loss gap, the worst leaf's change and BatchNorm gaps after
    the three steps, the leaves of the three worst first-gradient gaps."""
    grads = dict(zip(want["grad"], _leaf_gaps(got["grad"], want["grad"], want["grad"])))
    return {"loss_rel_by_step": [_loss_gap(g, w) for g, w in zip(got["losses"], want["losses"])],
            "change_leaf": max(_leaf_gaps(got["change"], want["change"], _moving(want))),
            "bn_leaf": max(_leaf_gaps(got["bn"], want["bn"], want["bn"])),
            "grad_worst_leaves": sorted(grads, key=grads.get)[-3:]}


def release(state: State) -> None:
    state.train_state = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run, state: State) -> dict:
    release(state)
    numbers = compare(state.record, reference_record(run, state))
    return {k: {"value": v, "limit": run.cell.limits[k]} for k, v in numbers.items()}
