"""Joints (mm) -> MANO mesh, batched on the device (counterpart of
handmvnet_tpu/models/joints_to_vertices.py):
  1. rigid SVD alignment of {wrist, middle_mcp, ring_mcp} onto the flat-hand
     MANO template,
  2. analytical IK -> 16 rotation matrices,
  3. MANO LBS forward -> 778 vertices,
  4. inverse rigid transform back to the prediction frame.

``fused_svd`` batches the alignment SVD and the IK's global-orientation SVD
into one 3x3 decomposition: global rotations factor out of the bone
correlation (H_aligned = H_raw @ R_align^T implies R0(aligned) = R_align @
R0(raw)), which halves the sequential depth of the chain of small ops.
"""

from __future__ import annotations

import torch
from torch import nn

from handmvnet_tpu_torch.models.ik import adaptive_ik, global_orientation_rule, root_bones
from handmvnet_tpu_torch.models.mano import ManoLayer
from handmvnet_tpu_torch.ops.procrustes import rigid_align_3pt
from handmvnet_tpu_torch.ops.small_linalg import det3, mm, mmt, scale_last
from handmvnet_tpu_torch.ops.svd3 import svd3x3

_ALIGN_JOINTS = (0, 9, 13)  # wrist, middle_mcp, ring_mcp


class _JointsToVertices(nn.Module):
    """joints [B, 21, 3] (mm) -> verts [B, 778, 3] (mm). The template and the
    anchor-joint ids are buffers on the MANO layer's device; runs in the
    joints' dtype (fp32 on the main path, in both serving dtypes)."""

    def __init__(self, mano: ManoLayer, fast_svd: bool = True, fused_svd: bool = True):
        super().__init__()
        self.mano = mano
        self.polish = 0 if fast_svd else 2
        self.fused_svd = fused_svd
        device = mano.v_template.device
        self.register_buffer("template", torch.from_numpy(mano.joints_template()).to(device))
        self.register_buffer("align_ids", torch.tensor(_ALIGN_JOINTS, device=device))

    def forward(self, joints: torch.Tensor) -> torch.Tensor:
        template = self.template.to(joints.dtype)
        a_pts = joints.index_select(1, self.align_ids).transpose(-1, -2)  # [B, 3, 3] columns
        b_pts = template.index_select(0, self.align_ids).T.expand_as(a_pts)
        if self.fused_svd:
            r, t, r0 = self._align_fused(joints, template, a_pts, b_pts)
        else:
            r, t = rigid_align_3pt(a_pts, b_pts, polish_sweeps=self.polish)
            r0 = None
        t_row = t[..., 0][:, None]  # [B, 1, 3]
        aligned = joints @ r.transpose(-1, -2) + t_row
        verts, _ = self.mano(adaptive_ik(template, aligned, polish_sweeps=self.polish, r0=r0))
        # v' = R^-1 (v - t); R orthonormal so inverse == transpose
        return (verts - t_row) @ r

    def _align_fused(self, joints, template, a_pts, b_pts):
        """(R_align, t_align, R0 in the aligned frame) from one batched SVD of
        both correlation matrices."""
        # (a) rigid alignment on the 3 anchor joints (as columns), centered
        ca = a_pts.mean(dim=-1, keepdim=True)
        cb = b_pts.mean(dim=-1, keepdim=True)
        h_align = mmt(a_pts - ca, b_pts - cb)  # Am @ Bm^T
        # (b) global orientation on the raw (unaligned) root bones
        h_orient = mmt(root_bones(template), root_bones(joints))  # T_0 @ P_0^T
        u, s, vt = svd3x3(torch.stack([h_align, h_orient], dim=1),
                          polish_sweeps=self.polish)  # [B, 2, 3, 3]

        # alignment rotation (reflection fix: flip the last right-singular
        # row when det < 0)
        ua, vta = u[:, 0], vt[:, 0]
        det_a = det3(mmt(vta.transpose(-1, -2), ua))  # det(V U^T)
        vta = scale_last(vta, torch.where(det_a < 0, -1.0, 1.0), dim=-2)
        r_a = mmt(vta.transpose(-1, -2), ua)
        t_a = -mm(r_a, ca) + cb  # [B, 3, 1]
        # raw global orientation with the reference's near-reflection rule,
        # composed: R0(aligned) = R_a @ R0(raw)
        r0 = mm(r_a, global_orientation_rule(u[:, 1], s[:, 1], vt[:, 1]))
        return r_a, t_a, r0


def joints_to_vertices_fn(mano: ManoLayer, fast_svd: bool = True,
                          fused_svd: bool = True) -> nn.Module:
    """The mesh stage as a callable module: joints [B, 21, 3] (mm) -> verts
    [B, 778, 3] (mm), on the device of ``mano``'s buffers.

    fast_svd=True uses the analytic 3x3 eigensolver without the Jacobi
    polish; fused_svd=True batches the alignment and orientation
    decompositions into one call.
    """
    return _JointsToVertices(mano, fast_svd=fast_svd, fused_svd=fused_svd)
