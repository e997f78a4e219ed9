"""Port parity, the data-parallel slice: handmvnet_tpu_torch.parallel, the
train step and evaluate over the ranks of a process group, each rank's
loaders and train.py over several ranks, against the JAX package's
parallel/ layer and trainer on the same numpy inputs, on the CPU: two
processes joined by gloo (parallel.spawn_local_ranks), against JAX on a
2-device mesh of this process's virtual CPU devices.

Sizes are test_torch_train.py's step_case: the HO3D release model at full
width with its views cut to 3, 64^2 images (8^2 heatmaps), batch 4 a rank,
float64 weights with the heads scaled (torch_parity.scaled_random_variables),
dropout 0. Tolerances are step_case's, each with the largest error measured
on this CPU:
  * the step of two ranks at accumulation 2 against make_train_step on 2
    devices over the 8 samples: loss terms rel 1e-9 (measured 2.1e-14);
    BatchNorm running statistics 1e-9 of each one's max (measured 1.7e-14);
    parameters within 2 lr everywhere (measured 7.0e-9 lr) and 1e-2 lr
    where |g| > 1e-3 max|g| of the leaf (measured 4.4e-11 lr);
  * the all-reduced gradients against one process accumulating the same 4
    microbatches: every leaf 1e-7 of its max (measured 3.1e-10 on
    pose_net.3.bias, the leaf whose gradient is a small remainder of terms
    that cancel), the two conv biases before a train-mode BatchNorm, whose
    exact gradient is 0, below 1e-9 of the largest gradient (measured
    1.4e-19); loss terms rel 1e-9 (measured 2.8e-15); both ranks bitwise
    equal;
  * evaluate over 2 ranks against JAX's evaluate on the 2-device mesh over
    the concatenated batches, whose halves hide different numbers of joints:
    rel 1e-6 (measured 9.1e-8: the port's labels and PCK thresholds are fp32,
    JAX's float64 here).
"""

import json
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from handmvnet_tpu import train as jax_train
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.data import ho3d as jax_ho3d
from handmvnet_tpu.engine import evaluate as jax_evaluate
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.parallel import make_eval_step, make_mesh, make_train_step
from handmvnet_tpu.parallel import make_optimizer as jax_make_optimizer
from handmvnet_tpu.parallel.train_step import TrainState as JaxTrainState
from handmvnet_tpu_torch import train
from handmvnet_tpu_torch.checkpoint import load_flax_variables
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.models.layers import Dropout
from handmvnet_tpu_torch.parallel import (StopSignal, check_device_count, init_data_parallel,
                                          spawn_local_ranks)
from handmvnet_tpu_torch.train_step import accumulate_grads, batch_to_device, create_train_state
from torch_parallel_workers import (cut_config, fail_on_rank_1, step_and_evaluate,
                                    stop_when_rank_1_asks, train_and_record)
from torch_parity import scaled_random_variables, write_train_shards

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
VIEWS, BATCH, IMAGE, HEATMAP = 3, 4, 64, 8  # BATCH: a rank's
WORLD = 2
EVAL_BATCH = 2  # a rank's, in each of two eval batches
# conv biases followed by a train-mode BatchNorm: their exact gradient is 0
ZERO_GRAD_LEAVES = ("pose_net.0.bias", "sample_nets.0.conv.0.bias")


def _eval_batches() -> list[dict]:
    """Two global eval batches of WORLD x EVAL_BATCH samples in float64; in
    each, rank 0's half hides ~half of its joints and rank 1's ~a tenth."""
    rng = np.random.default_rng(5)
    batches = []
    for seed in (11, 12):
        data = synthetic_batch(WORLD * EVAL_BATCH, VIEWS, IMAGE, HEATMAP, seed=seed,
                               with_heatmaps=False)
        batch = {k: data[k].astype(np.float64) for k in (
            "rgb", "bboxes", "intrinsic", "joints_crop_img", "joints_cam", "root_joint")}
        share = np.repeat([0.5, 0.1], EVAL_BATCH)[:, None, None]
        batch["joints_img_mask"] = rng.uniform(size=data["joints_img_mask"].shape) < share
        batches.append(batch)
    return batches


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One optimizer step and one evaluate pass of two gloo ranks (each on
    its half), and of JAX on a 2-device mesh (the whole), from the same
    float64 weights; the ranks run while JAX compiles."""
    out = tmp_path_factory.mktemp("two_ranks")
    cfg = cut_config(Config.from_yaml(CONFIG), VIEWS, IMAGE, HEATMAP, BATCH)
    jcfg = cut_config(JaxConfig.from_yaml(CONFIG), VIEWS, IMAGE, HEATMAP, BATCH)
    data = synthetic_batch(WORLD * BATCH, VIEWS, IMAGE, HEATMAP, seed=7)
    data = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in data.items()}
    eval_batches = _eval_batches()
    with jax.enable_x64(True):
        flax_model = FlaxHandMvNet(cfg=jcfg.model, image_size=IMAGE, heatmap_size=HEATMAP,
                                   dropout=0.0)
        jbatch = {k: jnp.asarray(v) for k, v in data.items()}
        variables = scaled_random_variables(
            flax_model, [jbatch[k] for k in ("rgb", "bboxes", "intrinsic")])
    weights = load_flax_variables(variables)
    torch.save({"config": str(CONFIG), "sizes": (VIEWS, IMAGE, HEATMAP, BATCH),
                "weights": weights, "batch": data, "eval_batches": eval_batches},
               out / "inputs.pt")
    failure = []

    def ranks():
        try:
            spawn_local_ranks(step_and_evaluate, (str(out),), WORLD)
        except BaseException as e:  # noqa: BLE001 -- re-raised in the fixture's thread
            failure.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()

    with jax.enable_x64(True):
        mesh = make_mesh(num_devices=WORLD)

        def state():
            tx = jax_make_optimizer(jcfg, steps_per_epoch=10)
            params = jax.tree.map(jnp.asarray, variables["params"])
            return tx, JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                     batch_stats=jax.tree.map(jnp.asarray,
                                                              variables["batch_stats"]),
                                     opt_state=tx.init(params))

        ref_metrics = jax_evaluate(make_eval_step(flax_model, jcfg, mesh), state()[1],
                                   eval_batches, jcfg, mode="val")
        tx, start = state()
        step = make_train_step(flax_model, jcfg, tx, mesh, accum_steps=2)
        new_state, ref_losses = step(start, jbatch, jax.random.PRNGKey(0))
        ref_after = load_flax_variables({
            "params": jax.tree.map(np.asarray, new_state.params),
            "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)})
        ref_losses = {k: float(v) for k, v in ref_losses.items()}

    # one process accumulating the same 4 microbatches: the gradient's oracle
    model = HandMvNet(cfg.model, IMAGE, HEATMAP, dropout=0.0).double()
    model.load_state_dict(weights)
    oracle = create_train_state(model, cfg, steps_per_epoch=10)
    oracle_losses = accumulate_grads(oracle, cfg, batch_to_device(data, "cpu"), None, 4)
    oracle_grads = {n: p.grad for n, p in model.named_parameters()}

    thread.join(timeout=600)
    assert not thread.is_alive(), "the two ranks did not finish in 600 s"
    if failure:
        raise failure[0]
    ranks_seen = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks_seen, "weights": weights, "ref_losses": ref_losses,
            "ref_after": ref_after, "ref_metrics": ref_metrics,
            "oracle_losses": {k: float(v) for k, v in oracle_losses.items()},
            "oracle_grads": oracle_grads, "lr": cfg.train.lr}


def test_broadcast_gives_every_rank_rank_0s_weights(two_ranks):
    for rank in two_ranks["ranks"]:
        for key, value in two_ranks["weights"].items():
            got = rank["received"][key]
            assert torch.equal(got, value.to(got.dtype).view_as(got)), key


def test_two_rank_step_loss_terms_match_jax(two_ranks):
    ref = two_ranks["ref_losses"]
    first, second = ({k: float(v) for k, v in r["losses"].items()} for r in two_ranks["ranks"])
    assert first == second and set(first) == set(ref)
    for key in ref:
        assert first[key] == pytest.approx(ref[key], rel=1e-9), key
        assert first[key] == pytest.approx(two_ranks["oracle_losses"][key], rel=1e-9), key


def test_two_rank_gradients_match_one_process(two_ranks):
    """The all-reduced gradients are the mean of the 4 microbatches', as one
    process accumulating them finds, and bitwise the same on both ranks."""
    first, second = (r["grads"] for r in two_ranks["ranks"])
    oracle = two_ranks["oracle_grads"]
    assert set(first) == set(oracle)
    top = max(float(g.abs().max()) for g in oracle.values())
    for name, ref in oracle.items():
        assert torch.equal(first[name], second[name]), name
        if name in ZERO_GRAD_LEAVES:
            assert float(first[name].abs().max()) < 1e-9 * top, name
        else:
            err = float((first[name] - ref).abs().max())
            assert err <= 1e-7 * float(ref.abs().max()), (name, err)


def test_two_rank_parameters_and_statistics_match_jax(two_ranks):
    """After the step both ranks hold bitwise the same parameters and
    BatchNorm statistics: within step_case's limits of JAX's pmean'd step."""
    first, second = (r["after"] for r in two_ranks["ranks"])
    ref, lr = two_ranks["ref_after"], two_ranks["lr"]
    grads = two_ranks["ranks"][0]["grads"]
    stats = [k for k in first if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 45
    for key, value in first.items():
        assert torch.equal(value, second[key]), key
    for key in stats:
        err = float((first[key] - ref[key]).abs().max())
        assert err <= 1e-9 * float(ref[key].abs().max()), (key, err)
    for name, g in grads.items():
        diff = (first[name] - ref[name]).abs()
        assert float(diff.max()) <= 2 * lr, name
        big = g.abs() > 1e-3 * g.abs().max()
        if big.any():
            assert float(diff[big].max()) <= 1e-2 * lr, name


def test_evaluate_over_two_ranks_matches_jax_global_batch(two_ranks):
    """Every rank gets JAX's metrics of the global batches, though the
    ranks' halves hide different numbers of joints."""
    first, second = (r["metrics"] for r in two_ranks["ranks"])
    ref = two_ranks["ref_metrics"]
    assert first == second and set(first) == set(ref)
    assert {"val_mpjpe2d", "val_mpjpe", "val_pa_mpjpe", "val_pck_j"} <= set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(first[key], value, rtol=1e-6, atol=0, err_msg=key)


# ------------------------------------------------------------------ loaders and rules


@pytest.fixture(scope="module")
def shard_data(tmp_path_factory):
    return write_train_shards(tmp_path_factory.mktemp("shards"))


def _jax_samples(ds, count: int) -> list[np.ndarray]:
    """joints_cam of the first ``count`` samples of passes of ``ds`` one after
    another, as the loaders' sample streams read them."""
    out = []
    while len(out) < count:
        out += [s["joints_cam"] for s in ds]
    return out[:count]


@pytest.mark.parametrize("world", [2, 3], ids=["2-ranks", "3-ranks"])
def test_rank_loaders_match_jax_split(shard_data, world):
    """Each rank's train and val loaders over two epochs: JAX's per-process
    dataset (split_index=rank, split_count=world) sample for sample, and
    JAX's step count (train.py:100-101), the same on every rank. At 3 ranks
    the val split's 2 shards are split by sample."""
    raw = {"dataset_dir": shard_data["dataset_dir"],
           "split_size_overrides": shard_data["split_size_overrides"],
           "batch_size": 2, "image_size": IMAGE, "heatmap_size": HEATMAP, "augment": False}
    cfg = Config.from_dict({"data": raw})
    jcfg = JaxConfig.from_dict({"data": raw})
    bs = cfg.data.batch_size
    for rank in range(world):
        loaders = train.build_dataloaders(cfg, "cpu", ("train", "val"), rank, world)
        for split, loader in zip(("train", "val"), loaders):
            ref_ds = jax_ho3d.HO3DDataset(jcfg.data, split, split_index=rank,
                                          split_count=world, use_native=False)
            steps = max(1, ref_ds.num_samples() // (bs * world))
            assert len(loader) == steps, (split, rank)
            got = [b["joints_cam"].numpy() for _ in range(2) for b in loader]
            want = _jax_samples(ref_ds, 2 * steps * bs)
            np.testing.assert_array_equal(np.concatenate(got), np.stack(want),
                                          err_msg=f"{split} rank {rank}")


@pytest.mark.parametrize("batch", [2, 16, 64])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_accumulation_rule_matches_jax(world, batch):
    """accumulation(cfg, world) against the expression of
    handmvnet_tpu/train.py:269, read from its source, at n_dev = world."""
    import inspect
    import re

    (expr,) = re.findall(r"accum = (cfg\.train\.accumulate_batch or .*)",
                         inspect.getsource(jax_train.main))
    for accumulate in (0, 3):
        raw = {"data": {"batch_size": batch}, "train": {"accumulate_batch": accumulate}}
        want = eval(expr, {"cfg": JaxConfig.from_dict(raw), "n_dev": world})
        assert train.accumulation(Config.from_dict(raw), world) == want


def test_dropout_masks_differ_across_ranks_and_repeat():
    drop = Dropout(0.1).train()
    x = torch.ones(4096)

    def mask(step, rank, world=WORLD):
        return drop(x, torch.Generator().manual_seed(train.dropout_seed(42, step, rank, world)))

    assert not torch.equal(mask(3, 0), mask(3, 1))
    assert torch.equal(mask(3, 1), mask(3, 1))
    assert not torch.equal(mask(3, 0), mask(4, 0))
    assert train.dropout_seed(42, 3) == 42 * 1_000_003 + 3  # one rank: the step's seed


# ------------------------------------------------------------------ train.py over ranks


def _tiny_config(tmp_path, shard_data, **train_fields) -> str:
    raw = yaml.safe_load(CONFIG.read_text())
    raw["data"].update(image_size=IMAGE, heatmap_size=HEATMAP, batch_size=2, **shard_data)
    raw["model"]["selected_views"] = list(range(VIEWS))
    raw["train"].update(train_fields)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


def _records(out) -> list[dict]:
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def _finite(record: dict) -> bool:
    return all(np.isfinite(v) for v in record.values() if isinstance(v, float))


def test_train_main_over_two_ranks_then_resume(tmp_path, shard_data):
    """Two ranks started as torchrun starts them (env://), 1 epoch x 2 steps
    on the shards (augmented stream, dropout on, accumulation 2, the vis
    hook every epoch): rank 0 alone writes, vis/ and tb/ included, every
    logged value is finite, and the ranks end the epoch with bitwise equal
    weights and statistics. Then ``--num-devices 2 --resume`` (train.py
    starting the ranks itself) continues to epoch 1."""
    out = tmp_path / "run"
    argv = ["--config", _tiny_config(tmp_path, shard_data, vis_every_n_epochs=1),
            "--steps-per-epoch", "2", "--output-dir", str(out), "--device", "cpu"]
    spawn_local_ranks(train_and_record, (argv + ["--epochs", "1"], str(tmp_path)), WORLD)
    first, second = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
                     for r in range(WORLD))
    assert second["writes"] == []
    assert {Path(p).name for p in first["writes"]} >= {
        "last.pt", "metrics.jsonl", "val.json", "tb", "joints2d_0.png", "projected_joints2d_0.png"}
    assert {str(out / "vis" / mode / "joints2d_0.png") for mode in ("train", "val")} <= \
        set(first["writes"])
    assert any((out / "tb").iterdir())
    assert first["after"].keys() == second["after"].keys()
    for key, value in first["after"].items():
        assert torch.equal(value, second["after"][key]), key
    (record,) = _records(out)
    assert record["epoch"] == 0 and _finite(record) and "train/loss" in record
    (val,) = json.loads((out / "val.json").read_text())
    assert _finite(val)
    assert torch.load(out / "checkpoints" / "last.pt", weights_only=True)["step"] == 2

    train.main(argv + ["--epochs", "2", "--resume", "--num-devices", str(WORLD)])
    records = _records(out)
    assert [r["epoch"] for r in records] == [0, 1] and all(map(_finite, records))
    assert torch.load(out / "checkpoints" / "last.pt", weights_only=True)["step"] == 4


def test_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks asked for on this host, which has 1"):
        train.main(["--config", str(CONFIG), "--num-devices", "2"])
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one rank a card"):
        init_data_parallel("cuda")
    check_device_count(4, "cpu")  # CPU ranks share the host


def test_a_failing_rank_ends_the_run(tmp_path):
    """A rank that raises while the other waits for it in a collective ends
    the run, nonzero, without a hang; so does train.main when its ranks
    fail."""
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match=r"rank \d of 2 failed"):
        spawn_local_ranks(fail_on_rank_1, (), 2)
    assert time.monotonic() - t0 < 120
    with pytest.raises(SystemExit, match=r"rank \d of 2 failed"):
        train.main(["--config", str(tmp_path / "missing.yaml"), "--num-devices", "2",
                    "--device", "cpu"])


def test_stop_signal_stops_every_rank_at_one_step(tmp_path):
    """A request taken on rank 1 at step 2 stops both ranks at step 3 (each
    poll reads the flags of the one before); alone, a request stops at once."""
    spawn_local_ranks(stop_when_rank_1_asks, (str(tmp_path),), 2)
    assert [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)] == [3, 3]
    alone = StopSignal(torch.device("cpu"))
    assert not alone.poll()
    alone.requested = True
    assert alone.poll()
