"""The frozen reference of the mesh stage: joints (mm) -> MANO mesh, in
plain PyTorch, float32 (the serving cells' ``vertices``).

  1. rigid alignment of {wrist, middle_mcp, ring_mcp} onto the flat-hand
     template and the global orientation of the five root bones, from one
     batched closed-form 3x3 SVD (the analytic eigensolver, no polish);
  2. analytical IK with zero twist -> 16 rotation matrices;
  3. MANO linear blend skinning -> 778 vertices;
  4. the inverse rigid transform back to the prediction's frame.

The formulas are those of the program's mesh stage as it stood when the
benchmark was written (``fast_svd`` and ``fused_svd`` on), frozen here so
that a later change to the program is judged against them. A MANO model is
a dict of float32 arrays: v_template [778, 3], shapedirs [778, 3, 10],
posedirs [778, 3, 135], j_regressor [16, 778], lbs_weights [778, 16].
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from hmvbench.reference.constants import ID2ROT, MANO_TIP_VERT_IDS, MANO_TO_MEDIAPIPE


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., n, k] @ [..., k, m]."""
    return a @ b


def mtm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b over trailing dims: [..., k, n]^T @ [..., k, m]."""
    return a.transpose(-1, -2) @ b


def mmt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T over trailing dims: [..., n, k] @ [..., m, k]^T."""
    return a @ b.transpose(-1, -2)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matvec over trailing dims: [..., n, k] @ [..., k]."""
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def mtv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a^T @ v over trailing dims: [..., k, n]^T @ [..., k]."""
    return (v.unsqueeze(-2) @ a).squeeze(-2)


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] in closed form (``torch.linalg.det`` on
    CUDA runs a batched LU through a solver library for each call)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    return (
        a00 * (a11 * a22 - a12 * a21)
        - a01 * (a10 * a22 - a12 * a20)
        + a02 * (a10 * a21 - a11 * a20)
    )


def scale_last(x: torch.Tensor, factor: torch.Tensor, dim: int) -> torch.Tensor:
    """x with its last column (``dim=-1``) or last row (``dim=-2``) of each
    trailing 3x3 multiplied by ``factor`` [...]: the out-of-place form of the
    JAX package's ``x.at[..., :, 2].multiply(f)`` / ``x.at[..., 2, :]``."""
    keep, last = x.split((2, 1), dim=dim)
    return torch.cat([keep, last * factor[..., None, None]], dim=dim)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1, keepdim=True)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _axis(like: torch.Tensor, i: int) -> torch.Tensor:
    """The unit vector e_i broadcast to ``like``'s shape [..., 3]."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[i].expand_as(like)


def _eigvals_sym3x3(a: torch.Tensor) -> torch.Tensor:
    """Analytic eigenvalues of symmetric [..., 3, 3], descending (Smith's
    trigonometric method)."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    # det((A - qI) / p) / 2
    b00, b11, b22 = d0 / p, d1 / p, d2 / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    degenerate = p2 < 1e-20  # scalar matrix: all eigenvalues q
    return torch.where(
        degenerate[..., None],
        torch.stack([q, q, q], dim=-1),
        torch.stack([e1, e2, e3], dim=-1),
    )


def _eigvec_for(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric A for eigenvalue lam via row cross products
    of (A - lam I): the nullspace direction (the largest of the three
    candidate cross products wins for robustness)."""
    m = a - lam[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = _dot(c01, c01)
    n02 = _dot(c02, c02)
    n12 = _dot(c12, c12)
    best = torch.where(n01 >= n02, c01, c02)
    best_n = torch.maximum(n01, n02)
    best = torch.where(best_n >= n12, best, c12)
    norm = _norm(best)
    # fully degenerate: any unit vector is an eigenvector
    return torch.where(norm > 1e-20, best / torch.clamp(norm, min=1e-30), _axis(best, 0))


def symeig3x3(a: torch.Tensor):
    """Eigendecomposition of symmetric [..., 3, 3]: (eigvals descending,
    eigvecs as columns), the analytic closed form without a polish."""
    w = _eigvals_sym3x3(a)
    v0 = _eigvec_for(a, w[..., 0])
    v2 = _eigvec_for(a, w[..., 2])
    # middle eigenvector: orthogonal completion (exact for symmetric A)
    v2 = v2 - _dot(v2, v0) * v0
    n2 = _norm(v2)
    # repeated eigenvalues: complete a basis from the axis least aligned with v0
    alt = torch.where(v0[..., 0:1].abs() < 0.9, _axis(v0, 0), _axis(v0, 1))
    alt = alt - _dot(alt, v0) * v0
    alt = alt / torch.clamp(_norm(alt), min=1e-30)
    degenerate = n2 <= 1e-3
    safe_n2 = torch.where(degenerate, 1.0, n2)
    v2 = torch.where(degenerate, alt, v2 / safe_n2)
    v1 = _cross(v2, v0)
    return w, torch.stack([v0, v1, v2], dim=-1)


def svd3x3(h: torch.Tensor):
    """SVD of [..., 3, 3]: returns (u, s, vt) with s descending,
    h = u @ diag(s) @ vt, in the JAX package's sign gauge."""
    w, v = symeig3x3(mtm(h, h))  # H^T H
    s = torch.sqrt(torch.clamp(w, min=0.0))
    u_raw = mm(h, v)  # H V = U S

    def unit(x, fallback):
        # safe normalisation: a (near-)zero column (H itself ~0, e.g. all
        # points collapsed to one location) must yield an arbitrary
        # orthonormal completion like numpy's SVD, not 0/0 = NaN
        n = _norm(x)
        ok = n > 1e-20
        return torch.where(ok, x / torch.where(ok, n, 1.0), fallback)

    # normalize columns; Gram-Schmidt, since close singular values leave
    # H V / s columns a few ulps off orthogonal in fp32
    u0 = u_raw[..., :, 0] / torch.clamp(s[..., 0:1], min=1e-12)
    u0 = unit(u0, _axis(u0, 0))
    u1 = u_raw[..., :, 1] / torch.clamp(s[..., 1:2], min=1e-12)
    u1 = u1 - _dot(u1, u0) * u0
    # fallback orthogonal to u0: cross with the axis least aligned with it
    alt = torch.where(u0[..., 2:3].abs() > 0.9, _axis(u0, 1), _axis(u0, 2))
    u1_fb = _cross(u0, alt)
    u1 = unit(u1, u1_fb / _norm(u1_fb))
    u2_cross = _cross(u0, u1)
    u2_raw = u_raw[..., :, 2] / torch.clamp(s[..., 2:3], min=1e-12)
    # keep the raw column's orientation; use the cross product's direction
    sign = torch.where(_dot(u2_cross, u2_raw) < 0, -1.0, 1.0)
    degenerate = (s[..., 2] < 1e-7 * torch.clamp(s[..., 0], min=1e-30))[..., None]
    u2 = torch.where(degenerate, u2_cross, u2_cross * sign)
    u = torch.stack([u0, u1, u2], dim=-1)
    return u, s, v.transpose(-1, -2)


FINGER_ROOTS = slice(1, 18, 4)  # joints 1, 5, 9, 13, 17


# chain levels: joints at depth 1..3 below the finger roots
LEVELS = (slice(2, 19, 4), slice(3, 20, 4), slice(4, 21, 4))


# ID2ROT gives each finger three consecutive pose slots, root to tip; this is
# the fingers' order in the slots (index, middle, little, ring, thumb)
FINGER_SLOT_ORDER = tuple(sorted(range(5), key=lambda f: ID2ROT[2 + 4 * f]))


def rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> rotation matrix (the axis is normalized here).

    axis: [..., 3]; angle: [...]. Returns [..., 3, 3].
    """
    n = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-12)
    x, y, z = n.unbind(-1)
    c = torch.cos(angle)
    s = torch.sin(angle)
    C = 1.0 - c
    row0 = torch.stack([x * x * C + c, x * y * C - z * s, x * z * C + y * s], dim=-1)
    row1 = torch.stack([y * x * C + z * s, y * y * C + c, y * z * C - x * s], dim=-1)
    row2 = torch.stack([z * x * C - y * s, z * y * C + x * s, z * z * C + c], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def global_orientation_rule(u: torch.Tensor, s: torch.Tensor,
                            vt: torch.Tensor) -> torch.Tensor:
    """R0 = V U^T from the root-bone SVD, with the reference's near-reflection
    rule: only if det ~ -1 AND some singular value ~ 0, flip V[:, 2]."""
    v = vt.transpose(-1, -2)
    det = det3(mmt(v, u))
    tiny_sv = (s.abs() < 1e-4).any(dim=-1)
    flip = ((det + 1.0).abs() < 1e-6) & tiny_sv
    return mmt(scale_last(v, torch.where(flip, -1.0, 1.0), dim=-1), u)


def root_bones(joints: torch.Tensor) -> torch.Tensor:
    """The five wrist -> finger-root bones as columns: [..., 21, 3] ->
    [..., 3, 5]."""
    return (joints[..., FINGER_ROOTS, :] - joints[..., :1, :]).transpose(-1, -2)


def adaptive_ik(template: torch.Tensor, target: torch.Tensor, r0: torch.Tensor) -> torch.Tensor:
    """MANO pose rotations from a joint template and predictions.

    Args:
      template: [21, 3] flat-hand template joints (same units as target), on
        target's device.
      target: [B, 21, 3] predicted joints, already rigidly aligned to the
        template frame.
      r0: the global orientation [B, 3, 3] from the batched SVD.

    Returns:
      [B, 16, 3, 3] pose rotations (slot 0 = global orientation, slots 1-15
      per ID2ROT).
    """
    b = target.shape[0]
    template = template.to(target.dtype)

    # per-finger chain state, vectorized over (B, 5)
    r_pa = r0[:, None].expand(b, 5, 3, 3)  # R of the parent joint
    q_pa_pa = template[0].expand(b, 5, 3)  # q of the grandparent (the wrist)
    t_pa_pa = template[0:1]  # template of the grandparent, broadcast over fingers
    t_pa = template[FINGER_ROOTS]  # [5, 3]

    locals_per_level = []
    for level in LEVELS:
        t_k = template[level]
        # q[pa] = R[pa] @ (T[pa] - T[pa_pa]) + q[pa_pa]
        q_pa = mv(r_pa, (t_pa - t_pa_pa).expand(b, 5, 3)) + q_pa_pa
        # delta in the parent's local frame (orthonormal: inverse == transpose)
        delta_p = mtv(r_pa, target[:, level] - q_pa)
        delta_t = t_k - t_pa  # [5, 3]
        axis = torch.linalg.cross(delta_t.expand_as(delta_p), delta_p, dim=-1)
        norm_t = torch.linalg.vector_norm(delta_t, dim=-1) + 1e-8  # [5]
        norm_p = torch.linalg.vector_norm(delta_p, dim=-1) + 1e-8  # [B, 5]
        cos_a = (delta_t * delta_p).sum(dim=-1) / (norm_t * norm_p)
        alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
        d_sw = rodrigues(axis, alpha)  # [B, 5, 3, 3]; twist = 0
        locals_per_level.append(d_sw)
        r_pa = mm(r_pa, d_sw)
        q_pa_pa = q_pa
        t_pa_pa, t_pa = t_pa, t_k

    # the 16 MANO pose slots: each finger's three levels in a row, the
    # fingers in slot order; views and one concatenation, no index list
    chains = torch.stack(locals_per_level, dim=2)  # [B, 5 fingers, 3 levels, 3, 3]
    return torch.cat([r0[:, None]] + [chains[:, f] for f in FINGER_SLOT_ORDER], dim=1)


# MANO's kinematic tree: the parent of each of its 16 joints
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
# forward-kinematics levels: finger f's joint at depth l is 1 + 3 f + l
_FK_LEVELS = (slice(1, 16, 3), slice(2, 16, 3), slice(3, 16, 3))
_ALIGN_JOINTS = (0, 9, 13)  # wrist, middle_mcp, ring_mcp


def mano_joints_template(mano: dict) -> np.ndarray:
    """The flat-hand 21-joint template in mm: the rest-pose joint
    regression and the five tip vertices, in the 21-joint order."""
    joints16 = mano["j_regressor"] @ mano["v_template"]  # float32, as MANO's own
    tips = mano["v_template"][np.asarray(MANO_TIP_VERT_IDS)]
    j21 = np.concatenate([joints16, tips], axis=0)[np.asarray(MANO_TO_MEDIAPIPE)]
    return (j21 * 1000.0).astype(np.float32)


class Mano(nn.Module):
    """MANO's forward at zero shape: pose rotations [B, 16, 3, 3] ->
    vertices [B, 778, 3] in mm."""

    def __init__(self, mano: dict):
        super().__init__()
        f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
        n = mano["v_template"].shape[0]
        self.register_buffer("v_template", f32(mano["v_template"]))
        self.register_buffer("posedirs", f32(mano["posedirs"].reshape(n * 3, -1).T))
        self.register_buffer("j_regressor", f32(mano["j_regressor"]))
        self.register_buffer("lbs_weights", f32(mano["lbs_weights"]))
        self.register_buffer("pose_identity", f32(np.tile(np.eye(3).ravel(), 15)))
        self.register_buffer("parents", torch.tensor(MANO_PARENTS[1:], dtype=torch.long))

    def forward(self, pose_rotmats: torch.Tensor) -> torch.Tensor:
        b = pose_rotmats.shape[0]
        v_shaped = self.v_template.expand(b, *self.v_template.shape)
        joints = self.j_regressor @ v_shaped  # [B, 16, 3]
        pose_feat = pose_rotmats[:, 1:].reshape(b, 135) - self.pose_identity
        v_posed = v_shaped + (pose_feat @ self.posedirs).reshape(b, -1, 3)
        rel = torch.cat([joints[:, :1], joints[:, 1:] - joints.index_select(1, self.parents)], 1)
        top = torch.cat([pose_rotmats, rel[..., None]], dim=-1)  # [B, 16, 3, 4]
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=top.device).expand(b, 16, 1, 4)
        locals_tf = torch.cat([top, bottom], dim=-2)
        parent_tf = locals_tf[:, 0:1].expand(b, 5, 4, 4)
        level_tfs = []
        for level in _FK_LEVELS:
            parent_tf = parent_tf @ locals_tf[:, level]
            level_tfs.append(parent_tf)
        chains = torch.stack(level_tfs, dim=2).reshape(b, 15, 4, 4)
        world = torch.cat([locals_tf[:, :1], chains], dim=1)  # [B, 16, 4, 4]
        posed_joints = world[:, :, :3, 3]
        rot = world[:, :, :3, :3]
        world_adj = torch.cat([rot, (posed_joints - mv(rot, joints))[..., None]], dim=-1)
        vert_tf = (self.lbs_weights @ world_adj.reshape(b, 16, 12)).reshape(b, -1, 3, 4)
        return (mv(vert_tf[..., :3], v_posed) + vert_tf[..., 3]) * 1000.0


class MeshStage(nn.Module):
    """joints [B, 21, 3] mm -> vertices [B, 778, 3] mm (steps 1-4 above)."""

    def __init__(self, mano: dict):
        super().__init__()
        self.mano = Mano(mano)
        self.register_buffer("template", torch.from_numpy(mano_joints_template(mano)))
        self.register_buffer("align_ids", torch.tensor(_ALIGN_JOINTS, dtype=torch.long))

    def forward(self, joints: torch.Tensor) -> torch.Tensor:
        template = self.template
        a_pts = joints.index_select(1, self.align_ids).transpose(-1, -2)  # [B, 3, 3]
        b_pts = template.index_select(0, self.align_ids).T.expand_as(a_pts)
        ca = a_pts.mean(dim=-1, keepdim=True)
        cb = b_pts.mean(dim=-1, keepdim=True)
        h_align = mmt(a_pts - ca, b_pts - cb)
        h_orient = mmt(root_bones(template), root_bones(joints))
        u, s, vt = svd3x3(torch.stack([h_align, h_orient], dim=1))  # [B, 2, 3, 3]
        ua, vta = u[:, 0], vt[:, 0]
        det_a = det3(mmt(vta.transpose(-1, -2), ua))
        vta = scale_last(vta, torch.where(det_a < 0, -1.0, 1.0), dim=-2)
        r = mmt(vta.transpose(-1, -2), ua)
        t = -mm(r, ca) + cb  # [B, 3, 1]
        r0 = mm(r, global_orientation_rule(u[:, 1], s[:, 1], vt[:, 1]))
        t_row = t[..., 0][:, None]
        aligned = joints @ r.transpose(-1, -2) + t_row
        verts = self.mano(adaptive_ik(template, aligned, r0))
        return (verts - t_row) @ r
