"""Analytical inverse kinematics: 21 joints -> 16 MANO rotation matrices,
batched (counterpart of handmvnet_tpu/models/ik.py).

  * the global orientation comes from one batched closed-form 3x3 SVD over
    the five root bones;
  * the five finger chains are independent given the global orientation, so
    the 15 per-joint steps are three sequential levels, each vectorized over
    (batch, 5 fingers): closed-form swing rotations with zero twist.

The finger roots and each chain level are every fourth joint of the 21-joint
layout, so they are strided views here, not gathers.
"""

from __future__ import annotations

import torch

from handmvnet_tpu_torch.constants import ID2ROT
from handmvnet_tpu_torch.ops.small_linalg import det3, mm, mmt, mtv, mv, scale_last
from handmvnet_tpu_torch.ops.svd3 import svd3x3

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


def _global_orientation(template: torch.Tensor, target: torch.Tensor,
                        polish_sweeps: int = 2) -> torch.Tensor:
    """R0 aligning the template's five root bones to the target's.

    template: [21, 3]; target: [B, 21, 3]. Returns [B, 3, 3].
    """
    h = mmt(root_bones(template), root_bones(target))  # T_0 @ P_0^T
    return global_orientation_rule(*svd3x3(h, polish_sweeps=polish_sweeps))


def adaptive_ik(template: torch.Tensor, target: torch.Tensor, polish_sweeps: int = 2,
                r0: torch.Tensor | None = None) -> torch.Tensor:
    """MANO pose rotations from a joint template and predictions.

    Args:
      template: [21, 3] flat-hand template joints (same units as target), on
        target's device.
      target: [B, 21, 3] predicted joints, already rigidly aligned to the
        template frame.
      r0: optional precomputed global orientation [B, 3, 3] (the fused
        joints -> vertices path passes the one its batched SVD gave).

    Returns:
      [B, 16, 3, 3] pose rotations (slot 0 = global orientation, slots 1-15
      per ID2ROT).
    """
    b = target.shape[0]
    template = template.to(target.dtype)
    if r0 is None:
        r0 = _global_orientation(template, target, polish_sweeps)

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
