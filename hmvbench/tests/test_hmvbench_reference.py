"""The frozen reference held to the program at small sizes on the CPU, where
the program's kernels run their plain versions: the forward in eval and in
train mode (the same dropout masks from a generator in the same state), the
mesh stage, the loss and one optimizer step. fp32 on both sides; the
tolerances are fp32 rounding through the depth of each model."""

from __future__ import annotations

import pytest
import torch

from hmvbench import inputs, models
from hmvbench.reference import train as ref_train
from hmvbench.reference.mesh import MeshStage
from hmvbench.tests.conftest import small_cell

CONFIGS = {"r50_paper": "r50.serve.b1v8", "hrnet_w40": "hr40.train.b16v5"}


def both(config_name: str, views: int = 2, batch: int = 2, seed: int = 5):
    cell = small_cell(CONFIGS[config_name])
    config = cell.config
    cfg = models.program_config(config, views, batch)
    weights = models.weights(config, views, seed, "cpu")
    program = models.program_model(cfg, config, weights, "cpu")
    reference = models.reference_model(config, views, "cpu")
    reference.load_state_dict(weights)
    frames = inputs.make_frames(batch, views, 64, 8, seed, "cpu", labels=True)
    return cfg, config, program, reference, frames


def close(a: torch.Tensor, b: torch.Tensor, rel: float) -> bool:
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.mark.parametrize("config_name", list(CONFIGS))
@pytest.mark.parametrize("train", [False, True])
def test_forward(config_name, train):
    _, _, program, reference, f = both(config_name)
    program.train(train)
    reference.train(train)
    args = (f["rgb"], f["bboxes"], f["intrinsic"])
    with torch.no_grad():
        got = program(*args, generator=torch.Generator().manual_seed(3))
        want = reference(*args, torch.Generator().manual_seed(3))
    for name in ("heatmap", "joints_crop_img", "joints_cam"):
        assert close(got[name], want[name], 1e-4), name


def test_mesh_stage():
    from handmvnet_tpu_torch.models.joints_to_vertices import joints_to_vertices_fn
    mano = inputs.make_mano(9, "cpu")
    joints = inputs.make_frames(4, 1, 64, 8, 9, "cpu", labels=True)["joints_cam"]
    got = joints_to_vertices_fn(models.mano_layer(mano, "cpu"))(joints)
    want = MeshStage(mano)(joints)
    assert float((got - want).abs().max()) < 1e-3  # mm, on hands ~100 mm across


def test_loss_terms():
    from handmvnet_tpu_torch.train_step import forward_loss
    cfg, config, program, _, f = both("r50_paper")
    program.train()
    with torch.no_grad():
        got, out = forward_loss(program, cfg, f, torch.Generator().manual_seed(1))
    want = ref_train.loss_terms(out, f, config["train"], 64.0)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k


def test_one_optimizer_step():
    from handmvnet_tpu_torch.train_step import create_train_state, train_step
    cfg, config, program, reference, f = both("r50_paper", batch=4)
    state = create_train_state(program, cfg, steps_per_epoch=567)
    got = train_step(state, cfg, f, torch.Generator().manual_seed(2), 2)
    opt = ref_train.AdamW(reference.parameters(), config["train"]["lr"],
                          config["train"]["weight_decay"])
    want = ref_train.train_step(reference, opt, f, config["train"], 64.0, 2,
                                torch.Generator().manual_seed(2))
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * float(want["loss"])
    start = models.weights(config, 2, 5, "cpu")
    ref_params = dict(reference.named_parameters())
    for n, p in program.named_parameters():
        moved = (ref_params[n].detach() - start[n]).norm()
        # an element whose gradient is rounding alone moves by the full step
        # under AdamW on either side, by either sign: compare the norms
        got_moved = float((p.detach() - start[n]).norm())
        assert abs(got_moved - float(moved)) <= 0.05 * float(moved) + 1e-7, n

