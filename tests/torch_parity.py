"""Shared helpers of the port's parity tests (tests/test_torch_*.py): random
flax variables from a numpy seed, carried into the port by
handmvnet_tpu_torch.checkpoint.load_flax_variables; exact equality of
nested samples; the release shard layout at test size."""

from __future__ import annotations

import math

import jax
import numpy as np


def random_flax_variables(module, seed: int, *args, **kwargs) -> dict:
    """Variables of ``module.init(key, *args)`` as nested numpy dicts, drawn
    from ``np.random.default_rng(seed)`` without running the init.

    Kernels get LeCun-scaled normals so activations stay O(1) through deep
    stacks; norm scales 1 + 0.1 N, biases and means 0.1 N, variances
    U(0.5, 1.5), so every affine term is exercised."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    rng = np.random.default_rng(seed)

    def make(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = math.prod(shape[:-1]) if name == "kernel" else shape[-2]
        return (rng.standard_normal(shape) * math.sqrt(1.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


def scaled_random_variables(flax_model, args) -> dict:
    """Random flax variables (seed 17) in float64, with the heatmap head
    scaled by 1e-3 and the last GCN layer by 1e-2, so that the soft-argmax
    (at x1000) is not saturated and the predicted joints lie tens of mm from
    the root, in front of every camera, as a trained model's do: else those
    paths carry almost no gradient, or sit near the projection's pole."""
    variables = random_flax_variables(flax_model, 17, *args)
    params = variables["params"]
    for name in ("kernel", "bias"):
        params["pose_net_3"][name] = params["pose_net_3"][name] * 1e-3
    for name in ("weight", "bias"):
        params["joints_decoder"]["joints_gcn3"][name] = (
            params["joints_decoder"]["joints_gcn3"][name] * 1e-2)
    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def rel_max_err(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| / max |ref|."""
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def write_train_shards(out_dir) -> dict:
    """HO3D's release shard layout at test size, written by the port on the
    CPU: 9 train shards of 2 samples (the val split reads the first and the
    last, the train split the 7 between, or all 9 with add_val_to_train),
    5 views of 480 x 640 with a coherent hand. Returns the config's data
    fields that point at them and size their epochs."""
    from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards

    write_synthetic_ho3d_shards(out_dir, num_shards=9, samples_per_shard=2, split="train",
                                consistent_geometry=True, device="cpu")
    return {"dataset_dir": str(out_dir),
            "split_size_overrides": {"train": 14, "train+val": 18, "val": 4}}


def assert_same(ours, ref, where=""):
    """Exact equality of nested samples: arrays by value, dtype and shape."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), where
        for k in ref:
            assert_same(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert isinstance(ours, (np.ndarray, np.generic)), where
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, where
        np.testing.assert_array_equal(ours, ref, err_msg=where)
    else:
        assert ours == ref, where
