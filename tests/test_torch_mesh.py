"""Port parity, the mesh stage: handmvnet_tpu_torch's small linear algebra,
closed-form 3x3 SVD, Procrustes, adaptive IK, MANO layer and joints ->
vertices against the JAX package's, fp32 on the CPU, on the same numpy
inputs and the same (synthetic) MANO arrays.

Tolerances are absolute, with the largest error measured on the CPU beside
each. Vertices are held to 2e-2 mm: the fp32 mesh stage differs from float64
by up to ~5e-3 mm on hand-like inputs, and the two packages round in
different orders.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from handmvnet_tpu import constants as jax_constants
from handmvnet_tpu.models import ik as jax_ik
from handmvnet_tpu.models import mano as jax_mano
from handmvnet_tpu.models.joints_to_vertices import joints_to_vertices_fn as jax_j2v
from handmvnet_tpu.ops import procrustes as jax_procrustes
from handmvnet_tpu.ops import small_linalg as jax_sl
from handmvnet_tpu.ops import svd3 as jax_svd3
from handmvnet_tpu_torch import constants
from handmvnet_tpu_torch.models import ik, mano
from handmvnet_tpu_torch.models.joints_to_vertices import joints_to_vertices_fn
from handmvnet_tpu_torch.ops import procrustes, small_linalg, svd3

VERTS_ATOL_MM = 2e-2


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _j(x: np.ndarray) -> jax.Array:
    return jnp.asarray(np.asarray(x, np.float32))


def _rotations(rng, n: int) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _hand_like_joints(rng, template, jitter=3.0):
    """Plausible hand: template joints + small noise (mm), as in
    tests/test_mano_ik.py."""
    noise = rng.normal(size=template.shape) * jitter
    noise[0] = 0
    return (template + noise).astype(np.float32)


def _hand_joints(template: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Hand-like joints under a random rigid transform each, so the
    alignment is not trivial."""
    rng = np.random.default_rng(seed)
    joints = np.stack([_hand_like_joints(rng, template, jitter=3.0) for _ in range(n)])
    joints = joints @ np.swapaxes(_rotations(rng, n), -1, -2) + rng.normal(size=(n, 1, 3)) * 30.0
    return joints.astype(np.float32)


@pytest.fixture(scope="module")
def layers():
    model = mano.synthetic_mano_model()
    return mano.ManoLayer(model), jax_mano.ManoLayer(jax_mano.synthetic_mano_model())


def test_constants_match():
    assert constants.NUM_MANO_VERTS == jax_constants.NUM_MANO_VERTS
    assert constants.ID2ROT == jax_constants.ID2ROT
    assert constants.MANO_TIP_VERT_IDS == jax_constants.MANO_TIP_VERT_IDS
    assert constants.MANO_TO_MEDIAPIPE == jax_constants.MANO_TO_MEDIAPIPE
    assert constants.MEAN_HAND_POSE == jax_constants.MEAN_HAND_POSE
    assert mano.MANO_PARENTS == jax_mano.MANO_PARENTS


def _assert_models_equal(ours, ref):
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        assert a.dtype == b.dtype, field.name
        np.testing.assert_array_equal(a, b, err_msg=field.name)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mano_model_matches(seed):
    _assert_models_equal(mano.synthetic_mano_model(seed), jax_mano.synthetic_mano_model(seed))


@pytest.mark.parametrize("fmt", ["npz", "pkl"])
def test_load_mano_model_matches(tmp_path, fmt):
    """An .npz export, and a MANO_RIGHT.pkl whose J_regressor is a
    scipy.sparse.csc_matrix (as the released file's is), load alike."""
    m = mano.synthetic_mano_model(5)
    rng = np.random.default_rng(5)
    data = {"v_template": m.v_template.astype(np.float64), "shapedirs": m.shapedirs,
            "posedirs": m.posedirs, "weights": m.lbs_weights, "f": m.faces.astype(np.uint32),
            "hands_mean": rng.normal(size=45)}
    if fmt == "npz":
        path = tmp_path / "mano.npz"
        np.savez(path, J_regressor=m.j_regressor, **data)
    else:
        path = tmp_path / "MANO_RIGHT.pkl"
        data["J_regressor"] = scipy.sparse.csc_matrix(m.j_regressor.astype(np.float64))
        path.write_bytes(pickle.dumps(data, protocol=2))
        path = tmp_path  # a directory resolves to its MANO_RIGHT.pkl
    ours, ref = mano.load_mano_model(path), jax_mano.load_mano_model(path)
    _assert_models_equal(ours, ref)
    np.testing.assert_array_equal(ours.j_regressor, m.j_regressor)


@pytest.mark.parametrize("name,shapes", [
    ("mm", [(4, 5, 3, 3), (4, 5, 3, 3)]), ("mm", [(2, 5, 4, 4), (2, 5, 4, 4)]),
    ("mtm", [(6, 3, 3), (6, 3, 3)]), ("mmt", [(6, 3, 5), (6, 3, 5)]),
    ("mv", [(4, 5, 3, 3), (4, 5, 3)]), ("mtv", [(4, 5, 3, 3), (4, 5, 3)]),
    ("det3", [(7, 3, 3)]),
])
def test_small_linalg_matches(name, shapes):
    rng = np.random.default_rng(len(name) + len(shapes[0]))
    args = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ours = getattr(small_linalg, name)(*map(_t, args)).numpy()
    ref = np.asarray(getattr(jax_sl, name)(*map(_j, args)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)  # measured 0: the same products


def _svd_case(name: str) -> np.ndarray:
    """The inputs of tests/test_svd3.py."""
    rng = np.random.default_rng(11)
    if name == "random":
        return rng.normal(size=(64, 3, 3))
    if name == "near_rank_deficient":
        return rng.normal(size=(8, 3, 1)) @ rng.normal(size=(8, 1, 3)) + 1e-4 * rng.normal(
            size=(8, 3, 3))
    if name == "zero":
        return np.zeros((2, 3, 3))
    if name == "rank1":
        a = np.array([1.0, 2.0, 3.0])
        return (a[:, None] * a[None, :])[None]
    if name == "identity":
        return np.eye(3)[None]
    if name == "scaled_rotation":
        return 0.37 * _rotations(np.random.default_rng(3), 1)
    return np.diag([2.0, 2.0, 0.5])[None]  # two equal singular values


SVD_CASES = ["random", "near_rank_deficient", "zero", "rank1", "identity", "scaled_rotation",
             "two_equal"]


@pytest.mark.parametrize("polish", [0, 2])
@pytest.mark.parametrize("case", SVD_CASES)
def test_svd3x3_matches(case, polish):
    """Reconstruction and singular values on every case; u and vt themselves
    where the singular values are distinct (elsewhere the basis of a repeated
    singular value is arbitrary and the polish rotates it by roundoff)."""
    h = _svd_case(case).astype(np.float32)
    ours = [x.numpy() for x in svd3.svd3x3(_t(h), polish_sweeps=polish)]
    ref = [np.asarray(x) for x in jax_svd3.svd3x3(_j(h), polish_sweeps=polish)]
    assert all(np.isfinite(x).all() for x in ours)

    def rec(u, s, vt):
        return np.einsum("...ij,...j,...jk->...ik", u, s, vt)

    # relative to |h|: measured 9.2e-4 at |h| = 9 (rank1, polish 2), 1.6e-4
    # near rank deficiency (polish 2), <= 3.8e-6 elsewhere
    atol = 2e-4 * max(1.0, float(np.abs(h).max()))
    np.testing.assert_allclose(rec(*ours), rec(*ref), atol=atol)
    np.testing.assert_allclose(ours[1], ref[1], atol=atol)
    if case == "random":
        np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)  # measured 2.1e-7
        np.testing.assert_allclose(ours[2], ref[2], atol=1e-5)  # measured 2.1e-7


@pytest.mark.parametrize("polish", [0, 2])
def test_symeig3x3_matches(polish):
    m = np.random.default_rng(12).normal(size=(16, 3, 3)).astype(np.float32)
    a = np.einsum("...ji,...jk->...ik", m, m)
    w, v = svd3.symeig3x3(_t(a), polish_sweeps=polish)
    w_ref, v_ref = jax_svd3.symeig3x3(_j(a), polish_sweeps=polish)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-5)  # measured 9.5e-7
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-5)  # measured 8.9e-8


# (R, t [mm]) tolerances of the alignment of the three anchor joints: three
# points make a rank-2 correlation, and without the polish the analytic
# eigenvectors keep fp32 cancellation (the JAX package against float64 on
# these inputs: 7.0e-4 on R, 1.1e-2 mm on t; 2.7e-7 and 2.0e-5 polished)
RIGID_ATOL = {0: (2e-3, 5e-2), 2: (1e-5, 1e-3)}


@pytest.mark.parametrize("polish", [0, 2])
def test_rigid_align_3pt_matches(layers, polish):
    """Hand-like anchors (wrist, middle and ring MCP) onto the template's, as
    the mesh stage aligns them; two samples mirrored, to take the reflection
    fix. Measured: polish 0 R 2.8e-4, t 9.1e-3 mm; polish 2 2.4e-7, 1.7e-5."""
    template = layers[0].joints_template()
    joints = _hand_joints(template, 16, seed=13)
    joints[:2, :, 0] *= -1.0
    a = np.swapaxes(joints[:, [0, 9, 13]], -1, -2)
    b = np.broadcast_to(template[[0, 9, 13]].T, a.shape)
    r, t = procrustes.rigid_align_3pt(_t(a), _t(b), polish_sweeps=polish)
    r_ref, t_ref = jax_procrustes.rigid_align_3pt(_j(a), _j(b), polish_sweeps=polish)
    r_tol, t_tol = RIGID_ATOL[polish]
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=r_tol)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=t_tol)


def test_similarity_align_matches():
    rng = np.random.default_rng(14)
    s2 = rng.normal(size=(8, 21, 3)).astype(np.float32) * 0.05
    s1 = 1.3 * s2 @ np.swapaxes(_rotations(rng, 8), -1, -2) + 0.2 + rng.normal(size=s2.shape) * 0.005
    s1[0] = 0.1  # all points at one location: zero variance
    ours = procrustes.similarity_align(_t(s1), _t(s2)).numpy()
    ref = np.asarray(jax_procrustes.similarity_align(_j(s1), _j(s2)))
    assert np.isfinite(ours[1:]).all()
    np.testing.assert_allclose(ours, ref, atol=1e-6)  # meters; measured 6.7e-8


def test_rodrigues_matches():
    rng = np.random.default_rng(15)
    axis = rng.normal(size=(4, 5, 3)).astype(np.float32)
    angle = rng.uniform(0, np.pi, size=(4, 5)).astype(np.float32)
    angle[0, 0] = 0.0
    ours = ik.rodrigues(_t(axis), _t(angle)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_ik.rodrigues(_j(axis), _j(angle))), atol=1e-6)


@pytest.mark.parametrize("with_r0", [False, True], ids=["svd", "given_r0"])
@pytest.mark.parametrize("polish", [0, 2])
def test_adaptive_ik_matches(layers, polish, with_r0):
    template = layers[0].joints_template()
    targets = np.stack([_hand_like_joints(np.random.default_rng(i), template)
                        for i in range(6)])
    targets[0] = template  # the template itself: identity pose
    r0 = _rotations(np.random.default_rng(16), 6).astype(np.float32) if with_r0 else None
    ours = ik.adaptive_ik(_t(template), _t(targets), polish_sweeps=polish,
                          r0=None if r0 is None else _t(r0)).numpy()
    ref = np.asarray(jax_ik.adaptive_ik(template, _j(targets), polish_sweeps=polish,
                                        r0=None if r0 is None else _j(r0)))
    assert ours.shape == (6, 16, 3, 3)
    # the template itself has nearly coplanar root bones (a flat hand): its
    # third singular direction is set by roundoff, so R0 agrees to 7.0e-4
    # (tests/test_mano_ik.py holds its identity pose to 1e-3); the other
    # samples to 6e-6, and every rotation to 2.5e-6 given R0
    np.testing.assert_allclose(ours[1:], ref[1:], atol=1e-5)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5 if with_r0 else 1e-3)


def _poses(rng, n: int, scale: float) -> np.ndarray:
    return (rng.normal(size=(n, 48)) * scale).astype(np.float32)


@pytest.mark.parametrize("pose,betas", [("identity", False), ("random", False),
                                        ("random", True)])
def test_mano_layer_matches(layers, pose, betas):
    ours_layer, ref_layer = layers
    rng = np.random.default_rng(17)
    if pose == "identity":
        rot = np.broadcast_to(np.eye(3, dtype=np.float32), (3, 16, 3, 3)).copy()
    else:
        rot = _rotations(rng, 48).reshape(3, 16, 3, 3).astype(np.float32)
    b = rng.normal(size=(3, 10)).astype(np.float32) if betas else None
    verts, joints = ours_layer(_t(rot), None if b is None else _t(b))
    verts_ref, joints_ref = ref_layer(_j(rot), None if b is None else _j(b))
    assert verts.shape == (3, 778, 3) and joints.shape == (3, 21, 3)
    # mm; measured 1.5e-5 and 0
    np.testing.assert_allclose(verts.numpy(), np.asarray(verts_ref), atol=1e-3)
    np.testing.assert_allclose(joints.numpy(), np.asarray(joints_ref), atol=1e-3)


@pytest.mark.parametrize("flat_hand_mean", [True, False])
def test_mano_from_axis_angle_matches(flat_hand_mean):
    """With a nonzero hands_mean, where the two conventions differ."""
    rng = np.random.default_rng(18)
    model = dataclasses.replace(mano.synthetic_mano_model(),
                                hands_mean=(rng.normal(size=45) * 0.2).astype(np.float32))
    pose, betas = _poses(rng, 2, 0.3), rng.normal(size=(2, 10)).astype(np.float32)
    verts, joints = mano.ManoLayer(model).from_axis_angle(_t(pose), _t(betas), flat_hand_mean)
    ref = jax_mano.ManoLayer(model).from_axis_angle(_j(pose), _j(betas), flat_hand_mean)
    # mm; measured 3.1e-5 and 1.5e-5
    np.testing.assert_allclose(verts.numpy(), np.asarray(ref[0]), atol=1e-3)
    np.testing.assert_allclose(joints.numpy(), np.asarray(ref[1]), atol=1e-3)


@pytest.mark.parametrize("side,pose", [("right", "axis_angle"), ("left", "axis_angle"),
                                       ("left", "rotmats")])
def test_mano_decoder_matches(side, pose):
    rng = np.random.default_rng(19)
    p = _poses(rng, 2, 0.3)
    if pose == "rotmats":
        p = _rotations(rng, 32).reshape(2, 16, 3, 3).astype(np.float32)
    verts, joints = mano.ManoDecoder().decode(_t(p), side=side)
    ref = jax_mano.ManoDecoder().decode(_j(p), side=side)
    # mm; measured 1.5e-5 and 1.5e-5
    np.testing.assert_allclose(verts.numpy(), np.asarray(ref[0]), atol=1e-3)
    np.testing.assert_allclose(joints.numpy(), np.asarray(ref[1]), atol=1e-3)


def test_joints_template_matches(layers):
    np.testing.assert_array_equal(layers[0].joints_template(), layers[1].joints_template())


@pytest.mark.parametrize("fused_svd", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("fast_svd", [True, False], ids=["fast", "polished"])
def test_joints_to_vertices_matches(layers, fast_svd, fused_svd):
    """Measured max |port - JAX| over 64 hands: fast fused 5.9e-3 mm, fast
    unfused 2.4e-3, polished fused 1.9e-4, polished unfused 3.5e-4."""
    ours_layer, ref_layer = layers
    joints = _hand_joints(ours_layer.joints_template(), 64, seed=20)
    ours = joints_to_vertices_fn(ours_layer, fast_svd, fused_svd)(_t(joints)).numpy()
    ref = np.asarray(jax.jit(jax_j2v(ref_layer, fast_svd, fused_svd))(_j(joints)))
    assert ours.shape == (64, 778, 3) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=VERTS_ATOL_MM)


def test_joints_to_vertices_under_inference_mode(layers):
    """No update writes into a view of an input: inference tensors in, the
    same vertices out."""
    joints = _t(_hand_joints(layers[0].joints_template(), 4, seed=21))
    j2v = joints_to_vertices_fn(layers[0])
    with torch.no_grad():
        ref = j2v(joints)
    with torch.inference_mode():
        ours = j2v(joints.clone())
    np.testing.assert_array_equal(ours.numpy(), ref.numpy())
