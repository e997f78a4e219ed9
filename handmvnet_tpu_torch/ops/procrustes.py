"""Procrustes / rigid alignment, batched (counterpart of
handmvnet_tpu/ops/procrustes.py).

  * similarity_align: the similarity (scale + R + t) transform of PA-MPJPE;
  * rigid_align_3pt: the rigid (R, t) between two 3 x N point sets that
    places predicted joints onto the MANO template frame.
"""

from __future__ import annotations

import torch

from handmvnet_tpu_torch.ops.small_linalg import det3, mm, mmt, mtm, scale_last
from handmvnet_tpu_torch.ops.svd3 import svd3x3


def similarity_align(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Align s1 to s2 with the optimal similarity transform.

    s1, s2: [B, N, 3]. Returns transformed s1, [B, N, 3].
    """
    x1 = s1.transpose(-1, -2)  # [B, 3, N]
    x2 = s2.transpose(-1, -2)
    mu1 = x1.mean(dim=-1, keepdim=True)
    mu2 = x2.mean(dim=-1, keepdim=True)
    x1c = x1 - mu1
    x2c = x2 - mu2
    var1 = (x1c ** 2).sum(dim=(-1, -2))

    k = mmt(x1c, x2c)  # [B, 3, 3]
    u, _, vt = svd3x3(k)
    v = vt.transpose(-1, -2)
    # det(U V^T) is +-1 and only its sign is used: the closed form gives the
    # same sign as torch.linalg.det, which on CUDA would run a batched LU
    # through a solver library for a 3x3
    r = mmt(scale_last(v, torch.sign(det3(mmt(u, v))), dim=-1), u)  # V Z U^T

    trace = (r * k.transpose(-1, -2)).sum(dim=(-1, -2))
    scale = (trace / var1)[..., None, None]
    t = mu2 - scale * mm(r, mu1)
    s1_hat = scale * mm(r, x1c + mu1) + t
    return s1_hat.transpose(-1, -2)


def rigid_align_3pt(a: torch.Tensor, b: torch.Tensor,
                    polish_sweeps: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal rigid (R, t) mapping column point-set a onto b.

    a, b: [..., 3, N] (points as columns). Returns (R [..., 3, 3],
    t [..., 3, 1]) with the reflection fix applied by flipping the last
    right-singular row when det < 0.
    """
    ca = a.mean(dim=-1, keepdim=True)
    cb = b.mean(dim=-1, keepdim=True)
    h = mmt(a - ca, b - cb)  # Am @ Bm^T over point columns
    u, _, vt = svd3x3(h, polish_sweeps=polish_sweeps)
    det = det3(mtm(vt, u.transpose(-1, -2)))  # det(Vt^T U^T)
    vt_fixed = scale_last(vt, torch.where(det < 0, -1.0, 1.0), dim=-2)
    r = mtm(vt_fixed, u.transpose(-1, -2))
    t = -mm(r, ca) + cb
    return r, t
