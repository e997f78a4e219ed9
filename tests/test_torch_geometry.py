"""Port parity, geometry and tooling: the rest of ops/camera.py and
ops/heatmap.py, ops/triangulation.py, utils/ (misc, profiling) and
``train.py --detect-anomaly``, against the JAX package on the same numpy
inputs, on the CPU.

Sizes: 2 x 3 x 21 points for the camera ops; heatmaps [2, 3, 4, 5, 6]
(3D) and [2, 3, 5, 7] (2D); triangulation scenes of B 2 x 5 views x 21
joints (the JAX package's tests/test_triangulation.py rig).

Tolerances, with the largest error measured on this CPU:
  * camera ops, fp32: 1e-6 of the largest coordinate (measured 2.4e-7 on
    coordinates up to 1.47: the same products, other summation orders;
    unproject_points 0);
  * soft_argmax_3d, fp32: 1e-5 voxels (measured 4.8e-7);
  * hard_argmax_2d: bitwise, the first of tied maxima included;
  * triangulations in float64 on both sides: 1e-6 m on points ~0.7 m out
    (measured 1.6e-7). The point is v[:3] / (v[3] + 1e-7) of the null
    vector v, whose sign each SVD picks for itself: the 1e-7 makes the
    point depend on that sign by rel 2e-7 / |v[3]| (~2.4e-7 here), and
    where the two SVDs' signs agree the packages agree to ~1e-15. In fp32
    the DLT within 1e-5 m of JAX's;
  * param_count/param_size and rotate_y: equal; log_compile_stats: the
    FLOPs of a matmul equal to XLA's count (a convolution's differ: torch's
    counter counts the padded taps, XLA's does not).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handmvnet_tpu import utils as jax_utils
from handmvnet_tpu.config import Config as JaxConfig
from handmvnet_tpu.models import HandMvNet as FlaxHandMvNet
from handmvnet_tpu.ops import camera as jax_camera
from handmvnet_tpu.ops import heatmap as jax_heatmap
from handmvnet_tpu.ops import triangulation as jax_tri
from handmvnet_tpu.utils.misc import rotate_y as jax_rotate_y
from handmvnet_tpu.utils.profiling import StepTimer as JaxStepTimer
from handmvnet_tpu.utils.profiling import log_compile_stats as jax_log_compile_stats
from handmvnet_tpu_torch import train as train_driver
from handmvnet_tpu_torch import utils
from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.models import HandMvNet
from handmvnet_tpu_torch.ops import camera, heatmap
from handmvnet_tpu_torch.ops import triangulation as tri
from handmvnet_tpu_torch.utils.misc import rotate_y
from handmvnet_tpu_torch.utils.profiling import Span, log_compile_stats

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "release" / "HO3D_HandMvNet.yaml"
TRI_ATOL = 1e-6  # float64; the null vector's sign through the 1e-7 (module docstring)


def _rigid(rng, n):
    """n random camera -> world rigid transforms [n, 4, 4]."""
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    t = np.tile(np.eye(4), (n, 1, 1))
    t[:, :3, :3] = q * np.sign(np.linalg.det(q))[:, None, None]
    t[:, :3, 3] = rng.normal(size=(n, 3)) * 0.5
    return t


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- camera


def test_camera_frame_changes_match_jax():
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(2, 3, 21, 3)) * 0.1 + [0, 0, 0.6]).astype(np.float32)
    src = _rigid(rng, 6).reshape(2, 3, 4, 4).astype(np.float32)
    dst = _rigid(rng, 6).reshape(2, 3, 4, 4).astype(np.float32)
    cases = {
        "cam_to_world": (camera.cam_to_world(torch.from_numpy(pts), torch.from_numpy(src)),
                         jax_camera.cam_to_world(pts, src)),
        "world_to_cam": (camera.world_to_cam(torch.from_numpy(pts), torch.from_numpy(src)),
                         jax_camera.world_to_cam(pts, src)),
        "transform_between_cameras": (
            camera.transform_between_cameras(torch.from_numpy(pts), torch.from_numpy(src),
                                             torch.from_numpy(dst)),
            jax_camera.transform_between_cameras(pts, src, dst)),
    }
    for name, (ours, ref) in cases.items():
        ref = _np(ref)
        assert ours.dtype == torch.float32 and ours.shape == ref.shape, name
        assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max(), name
    # a round trip returns the points
    back = camera.cam_to_world(camera.world_to_cam(torch.from_numpy(pts), torch.from_numpy(src)),
                               torch.from_numpy(src))
    assert np.abs(back.numpy() - pts).max() < 1e-5


def test_unproject_inverts_project_and_matches_jax():
    rng = np.random.default_rng(1)
    intr = np.array([[600.0, 610.0, 320.0, 240.0]] * 3, np.float32)[None].repeat(2, 0)
    pts = (rng.normal(size=(2, 3, 21, 3)) * 0.1 + [0, 0, 0.6]).astype(np.float32)
    uvd = camera.project_points(torch.from_numpy(pts), torch.from_numpy(intr), epsilon=0.0)
    ours = camera.unproject_points(uvd, torch.from_numpy(intr))
    ref = _np(jax_camera.unproject_points(uvd.numpy(), intr))
    assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(ours.numpy() - pts).max() < 1e-5


# ---------------------------------------------------------------- heatmaps


def test_soft_argmax_3d_matches_jax():
    hm = np.random.default_rng(2).normal(size=(2, 3, 4, 5, 6)).astype(np.float32) * 1e-2
    ours = heatmap.soft_argmax_3d(torch.from_numpy(hm))
    ref = _np(jax_heatmap.soft_argmax_3d(hm))
    assert ours.shape == (2, 3, 3) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


def test_hard_argmax_2d_bitwise_equals_jax_with_ties_and_the_zero_rule():
    hm = np.random.default_rng(3).normal(size=(2, 3, 5, 7)).astype(np.float32)
    hm[0, 0] = 0.0
    hm[0, 0, 1, 4] = hm[0, 0, 3, 2] = 2.0  # a tie: the first in row-major order wins
    hm[0, 1] = -np.abs(hm[0, 1]) - 0.1  # every value <= 0: (0, 0)
    hm[1, 2] = 0.0  # a zero maximum: (0, 0)
    ours = heatmap.hard_argmax_2d(torch.from_numpy(hm))
    ref = _np(jax_heatmap.hard_argmax_2d(hm))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ours[0, 0].tolist() == [5.0, 2.0]  # 1-indexed (x, y) of (row 1, column 4)
    assert ours[0, 1].tolist() == [0.0, 0.0] and ours[1, 2].tolist() == [0.0, 0.0]


# ---------------------------------------------------------------- triangulation


def _scene(rng, b=2, n=5, j=21):
    """tests/test_triangulation.py's rig: points 0.6 m out, n cameras
    rotated 0.3 rad apart; world -> camera extrinsics, float64."""
    pts3d = rng.normal(size=(b, j, 3)) * 0.1 + [0, 0, 0.6]
    ks = np.tile(np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]]), (b, n, 1, 1))
    extrs = np.tile(np.eye(4), (b, n, 1, 1))
    for i in range(n):
        a = 0.3 * i
        extrs[:, i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        extrs[:, i, :3, 3] = [0.05 * i, 0.02 * i, 0.1 * i]
    hom = np.concatenate([pts3d, np.ones((b, j, 1))], axis=-1)
    uv = np.einsum("bnik,bnjk->bnji", ks, np.einsum("bnik,bjk->bnji", extrs[..., :3, :], hom))
    kp2d = uv[..., :2] / uv[..., 2:3] + rng.normal(size=uv[..., :2].shape) * 0.3
    return pts3d, kp2d, ks, extrs


def _both_f64(ours_fn, jax_fn, *arrays):
    """(the port's result, JAX's) on float64 copies of ``arrays``."""
    ours = ours_fn(*(torch.from_numpy(np.asarray(a, np.float64)) for a in arrays))
    with jax.enable_x64(True):
        ref = _np(jax_fn(*(jnp.asarray(a, jnp.float64) for a in arrays)))
    assert ours.dtype == torch.float64
    return ours.numpy(), ref


def test_dlt_matches_jax():
    pts3d, kp2d, ks, extrs = _scene(np.random.default_rng(4))
    ours, ref = _both_f64(tri.batch_triangulate_dlt, jax_tri.batch_triangulate_dlt,
                          kp2d, ks, extrs)
    np.testing.assert_allclose(ours, ref, atol=TRI_ATOL, rtol=0)
    np.testing.assert_allclose(ours, pts3d, atol=5e-3)  # 0.3 px of noise
    f32 = tri.batch_triangulate_dlt(*(torch.from_numpy(a.astype(np.float32))
                                      for a in (kp2d, ks, extrs)))
    ref32 = _np(jax_tri.batch_triangulate_dlt(*(a.astype(np.float32) for a in (kp2d, ks, extrs))))
    np.testing.assert_allclose(f32.numpy(), ref32, atol=1e-5, rtol=0)


def test_reprojection_errors_match_jax():
    pts3d, kp2d, ks, extrs = _scene(np.random.default_rng(5))
    mmat = np.einsum("bnik,bnkl->bnil", ks, extrs[..., :3, :])
    ours, ref = _both_f64(tri.reprojection_errors, jax_tri.reprojection_errors,
                          pts3d, kp2d, mmat)
    assert ours.shape == (2, 5, 21)
    np.testing.assert_allclose(ours, ref, atol=TRI_ATOL, rtol=0)


@pytest.mark.parametrize("n_iterations", [100, 4])
def test_ransac_matches_jax_with_outliers(n_iterations):
    """One camera thrown 300 px off and scattered outliers; n_iterations 4
    keeps the first 4 of the 10 combinations, in itertools order."""
    rng = np.random.default_rng(6)
    pts3d, kp2d, ks, extrs = _scene(rng)
    kp2d[:, 1] += 300.0
    kp2d[rng.uniform(size=kp2d.shape[:3]) < 0.1] += 250.0

    def ours_fn(*a):
        return tri.batch_triangulate_dlt_ransac(*a, n_cams=3, n_iterations=n_iterations,
                                                reprojection_threshold=5.0)

    def jax_fn(*a):
        return jax_tri.batch_triangulate_dlt_ransac(*a, n_cams=3, n_iterations=n_iterations,
                                                    reprojection_threshold=5.0)

    ours, ref = _both_f64(ours_fn, jax_fn, kp2d, ks, extrs)
    np.testing.assert_allclose(ours, ref, atol=TRI_ATOL, rtol=0)
    if n_iterations == 100:
        assert np.median(np.abs(ours - pts3d)) < 2e-3


def test_ransac_joint_without_inliers_is_zero():
    """A joint whose 2D points are noise in every view gives no hypothesis an
    inlier at 1 px: (0, 0, 0), as in the reference and JAX."""
    rng = np.random.default_rng(7)
    _, kp2d, ks, extrs = _scene(rng)
    kp2d[0, :, 3] = rng.uniform(-300, 900, size=(5, 2))

    def ours_fn(*a):
        return tri.batch_triangulate_dlt_ransac(*a, reprojection_threshold=1.0)

    def jax_fn(*a):
        return jax_tri.batch_triangulate_dlt_ransac(*a, reprojection_threshold=1.0)

    ours, ref = _both_f64(ours_fn, jax_fn, kp2d, ks, extrs)
    assert np.all(ours[0, 3] == 0.0) and np.all(ref[0, 3] == 0.0)
    np.testing.assert_allclose(ours, ref, atol=TRI_ATOL, rtol=0)


def test_confident_dlt_matches_jax_and_falls_back_to_every_view():
    """Views under the threshold drop out of a joint; a joint with fewer
    than two confident views uses every view."""
    rng = np.random.default_rng(8)
    _, kp2d, ks, extrs = _scene(rng, b=1)
    pts, ks1, extrs1 = kp2d[0].copy(), ks[0], extrs[0]
    pts[2] += 200.0  # camera 2 is wrong ...
    confis = np.ones((5, 21))
    confis[2] = 0.1  # ... and says so
    confis[:, 7] = [0.9, 0.2, 0.1, 0.3, 0.4]  # joint 7: one confident view
    ours, ref = _both_f64(tri.triangulate_dlt_confident, jax_tri.triangulate_dlt_confident,
                          pts, confis, ks1, extrs1)
    assert ours.shape == (21, 3)
    np.testing.assert_allclose(ours, ref, atol=TRI_ATOL, rtol=0)
    every_view, _ = _both_f64(tri.triangulate_dlt_confident, jax_tri.triangulate_dlt_confident,
                              pts, np.ones((5, 21)), ks1, extrs1)
    np.testing.assert_allclose(ours[7], every_view[7], atol=1e-12, rtol=0)


# ---------------------------------------------------------------- utils


def test_param_count_and_size_match_jax_on_the_model():
    """The port's HandMvNet and the flax model's params tree (shapes only):
    the same count in millions and fp32 MB, from the module and from a
    state_dict-like dict of its parameters."""
    views = 3
    mcfg = dataclasses.replace(Config.from_yaml(CONFIG).model,
                               selected_views=tuple(range(views)))
    jmcfg = dataclasses.replace(JaxConfig.from_yaml(CONFIG).model,
                                selected_views=tuple(range(views)))
    with torch.device("meta"):
        model = HandMvNet(mcfg, 64, 8)
    shapes = jax.eval_shape(FlaxHandMvNet(cfg=jmcfg, image_size=64, heatmap_size=8).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, views, 64, 64, 3)),
                            jnp.zeros((1, views, 4)), jnp.zeros((1, views, 4)))
    want = jax_utils.param_count(shapes["params"]), jax_utils.param_size(shapes["params"])
    assert (utils.param_count(model), utils.param_size(model)) == want
    named = dict(model.named_parameters())
    assert (utils.param_count(named), utils.param_size(named)) == want


def test_rotate_y_equals_jax():
    pts = np.random.default_rng(9).normal(size=(21, 3))
    np.testing.assert_array_equal(rotate_y(pts, 0.7), jax_rotate_y(pts, 0.7))


def test_step_timer_summary_equals_jax():
    ours, ref = utils.StepTimer(), JaxStepTimer()
    for name in ("data", "step"):
        with ours.phase(name):
            pass
    assert set(ours.summary()) == {"data", "step"}
    times = {"data": [0.010, 0.030, 0.020], "step": [0.1]}
    ours.reset()
    ref.reset()
    for name, ts in times.items():
        ref._times[name].extend(ts)
        ours.recorder.spans += [Span(name, None, None, 0, 0, round(t * 1e9)) for t in ts]
    assert ours.summary() == ref.summary()


def test_log_compile_stats_counts_flops_as_xla_on_a_matmul():
    a, b = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    ref = jax_log_compile_stats(jax.jit(jnp.matmul).lower(a, b).compile())
    ours = log_compile_stats(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert ours == {"flops": 2 * 8 * 16 * 4, "bytes_accessed": None}
    assert ours["flops"] == ref["flops"]


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with utils.trace(tmp_path):
        torch.ones(8).add_(1)
    (trace,) = tmp_path.glob("*.pt.trace.json")
    assert "aten::add_" in trace.read_text()


# ---------------------------------------------------------------- --detect-anomaly


def test_detect_anomaly_raises_on_a_nan_in_the_backward(monkeypatch):
    """train.py's --detect-anomaly runs the fit under autograd's anomaly
    mode with check_nan: a backward that makes a NaN raises, naming the
    forward op; without the flag the same fit goes on. The fit is replaced
    by one backward through sqrt at 0 (gradient 0 * inf = NaN)."""
    seen = []

    def fit(args, device, group=None):
        seen.append(torch.is_anomaly_enabled())
        x = torch.zeros(3, requires_grad=True)
        (torch.sqrt(x) * 0.0).sum().backward()
        seen.append(bool(torch.isnan(x.grad).all()))

    monkeypatch.setattr(train_driver, "_fit", fit)
    argv = ["--config", str(CONFIG), "--device", "cpu"]
    train_driver.main(argv)
    assert seen == [False, True]
    with pytest.raises(RuntimeError, match="SqrtBackward0.* returned nan"):
        train_driver.main(argv + ["--detect-anomaly"])
    assert seen[2] is True
    assert not torch.is_anomaly_enabled()  # the mode ends with the run
