"""MANO layer: linear blend skinning, batched on the device (counterpart of
handmvnet_tpu/models/mano.py).

Semantics follow the MANO model (rotmat mode, flat_hand_mean, no PCA):
  v_shaped = v_template + shapedirs . betas
  J        = J_regressor @ v_shaped                       (16 joints)
  v_posed  = v_shaped + posedirs . vec(R_{1..15} - I)
  world[k] = world[parent] @ [R_k | J_k - J_parent]
  verts    = sum_k w_k * world'[k] @ v_posed              (LBS)
  joints   = 16 skeletal + 5 fingertip vertices, reordered to the 21-joint
             Mediapipe layout, scaled to millimeters (manopth convention).

``ManoLayer`` holds the model's arrays and its index constants as buffers,
so ``.to(device)`` moves them once and a forward copies nothing from the
host. Model data loads from the official MANO_RIGHT.pkl (chumpy arrays are
unpickled through a numpy shim; the file is licensed and not shipped), an
.npz export, or a deterministic synthetic model for tests and benchmarks.
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn

from handmvnet_tpu_torch import constants
from handmvnet_tpu_torch.models.ik import rodrigues
from handmvnet_tpu_torch.ops.small_linalg import mv

# MANO skeletal joint parents (wrist, then index/middle/pinky/ring/thumb chains)
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
# forward-kinematics levels: joints 1 + 3 f + l (finger f, depth l) are a
# stride-3 view each, and the fingers' chains are consecutive in MANO order
_FK_LEVELS = (slice(1, 16, 3), slice(2, 16, 3), slice(3, 16, 3))


@dataclass(frozen=True)
class ManoModel:
    v_template: np.ndarray  # [778, 3]
    shapedirs: np.ndarray  # [778, 3, 10]
    posedirs: np.ndarray  # [778, 3, 135]
    j_regressor: np.ndarray  # [16, 778]
    lbs_weights: np.ndarray  # [778, 16]
    faces: np.ndarray  # [F, 3] int32
    hands_mean: np.ndarray  # [45]


class _ChumpyShim(pickle.Unpickler):
    """Unpickle MANO pkl files without chumpy installed: chumpy arrays are
    reconstructed as plain numpy arrays."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            class _Ch(np.ndarray):
                pass

            return _Ch
        if module == "scipy.sparse.csc" or module == "scipy.sparse._csc":
            import scipy.sparse

            return getattr(scipy.sparse, name, scipy.sparse.csc_matrix)
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray(), dtype=np.float64)
    return np.asarray(x, dtype=np.float64)


def load_mano_model(path: str | Path) -> ManoModel:
    """Load MANO_RIGHT.pkl (or an .npz export with the same field names)."""
    path = Path(path)
    if path.is_dir():
        path = path / "MANO_RIGHT.pkl"
    if path.suffix == ".npz":
        data = dict(np.load(path))
    else:
        with open(path, "rb") as f:
            data = _ChumpyShim(io.BytesIO(f.read()), encoding="latin1").load()
    return ManoModel(
        v_template=_to_np(data["v_template"]).astype(np.float32),
        shapedirs=_to_np(data["shapedirs"]).astype(np.float32),
        posedirs=_to_np(data["posedirs"]).astype(np.float32),
        j_regressor=_to_np(data["J_regressor"]).astype(np.float32),
        lbs_weights=_to_np(data["weights"]).astype(np.float32),
        faces=np.asarray(data["f"], dtype=np.int32),
        hands_mean=_to_np(data.get("hands_mean", np.zeros(45))).astype(np.float32),
    )


def synthetic_mano_model(seed: int = 0) -> ManoModel:
    """Deterministic stand-in with a plausible flat-hand skeleton, used when
    the licensed MANO assets are unavailable (tests, synthetic benchmarks).
    The JAX package's, draw for draw: one seed gives both the same arrays.

    The 16 skeletal joints and 5 fingertips sit at a flat-hand layout derived
    from the dataset's mean hand pose; the J_regressor one-hot-selects
    dedicated vertices placed at those locations so that
    joints(identity pose) reproduces the layout exactly.
    """
    rng = np.random.default_rng(seed)
    mean_pose = np.asarray(constants.MEAN_HAND_POSE, dtype=np.float32) / 1000.0  # m
    # 21-joint layout -> the 16 MANO skeletal joints are the non-tip ones
    # (tips are vertices). MANO order: wrist, index(5,6,7), middle(9,10,11),
    # pinky(17,18,19), ring(13,14,15), thumb(1,2,3).
    mano_joint_of_21 = (0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3)
    joints16 = mean_pose[list(mano_joint_of_21)]
    tips21 = (4, 8, 12, 16, 20)
    tip_pos = mean_pose[list(tips21)]

    n_verts = constants.NUM_MANO_VERTS
    v_template = (rng.normal(size=(n_verts, 3)) * 0.004).astype(np.float32)
    # scatter vertices around the skeleton so LBS is non-degenerate
    anchor = rng.integers(0, 16, size=n_verts)
    v_template += joints16[anchor]

    # dedicate vertices: joint markers + the canonical tip vertex ids
    joint_vert_ids = np.arange(16) * 37  # arbitrary distinct ids
    v_template[joint_vert_ids] = joints16
    tip_ids = np.asarray(constants.MANO_TIP_VERT_IDS)
    v_template[tip_ids] = tip_pos
    anchor[tip_ids] = [15, 3, 6, 12, 9]  # tip follows its finger's last joint

    j_regressor = np.zeros((16, n_verts), dtype=np.float32)
    j_regressor[np.arange(16), joint_vert_ids] = 1.0

    lbs_weights = np.zeros((n_verts, 16), dtype=np.float32)
    lbs_weights[np.arange(n_verts), anchor] = 1.0
    lbs_weights[joint_vert_ids] = 0.0
    lbs_weights[joint_vert_ids, np.arange(16)] = 1.0

    shapedirs = (rng.normal(size=(n_verts, 3, 10)) * 1e-3).astype(np.float32)
    posedirs = (rng.normal(size=(n_verts, 3, 135)) * 1e-4).astype(np.float32)
    # keep marker vertices exactly on joints under shape/pose blendshapes
    shapedirs[joint_vert_ids] = 0.0
    posedirs[joint_vert_ids] = 0.0
    shapedirs[tip_ids] = 0.0
    posedirs[tip_ids] = 0.0

    faces = np.stack(
        [np.arange(n_verts - 2), np.arange(1, n_verts - 1), np.arange(2, n_verts)], axis=1
    ).astype(np.int32)
    return ManoModel(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        lbs_weights=lbs_weights,
        faces=faces,
        hands_mean=np.zeros(45, dtype=np.float32),
    )


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _long(ids) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.long)


class ManoLayer(nn.Module):
    """Batched MANO forward. The model's arrays are float32 buffers (cast to
    the pose's dtype in a forward); move the layer with ``.to(device)``."""

    def __init__(self, model: ManoModel):
        super().__init__()
        self.model = model  # the host arrays, for joints_template()
        n = model.v_template.shape[0]
        self.register_buffer("v_template", _f32(model.v_template))  # [778, 3]
        # blend shapes as [K, 778 * 3], so each one is a single [B, K] GEMM
        self.register_buffer("shapedirs", _f32(model.shapedirs.reshape(n * 3, -1).T))
        self.register_buffer("posedirs", _f32(model.posedirs.reshape(n * 3, -1).T))
        self.register_buffer("j_regressor", _f32(model.j_regressor))  # [16, 778]
        self.register_buffer("lbs_weights", _f32(model.lbs_weights))  # [778, 16]
        # vec(I) of each of the 15 articulated joints, subtracted from vec(R)
        self.register_buffer("pose_identity", _f32(np.tile(np.eye(3).ravel(), 15)))
        self.register_buffer("pose_mean", _f32(np.concatenate([np.zeros(3), model.hands_mean])))
        self.register_buffer("tf_bottom", _f32([[0.0, 0.0, 0.0, 1.0]]))
        self.register_buffer("parents", _long(MANO_PARENTS[1:]))
        self.register_buffer("tip_ids", _long(constants.MANO_TIP_VERT_IDS))
        self.register_buffer("to_mediapipe", _long(constants.MANO_TO_MEDIAPIPE))

    def forward(self, pose_rotmats: torch.Tensor, betas: torch.Tensor | None = None):
        """pose_rotmats: [B, 16, 3, 3] (slot 0 = global orientation).
        betas: [B, 10] or None (zeros). Returns (verts [B, 778, 3] mm,
        joints21 [B, 21, 3] mm)."""
        b = pose_rotmats.shape[0]
        dtype = pose_rotmats.dtype
        v_template = self.v_template.to(dtype)
        if betas is None:
            v_shaped = v_template.expand(b, *v_template.shape)
        else:
            v_shaped = v_template + (betas @ self.shapedirs.to(dtype)).reshape(b, -1, 3)
        joints = self.j_regressor.to(dtype) @ v_shaped  # [B, 16, 3]

        pose_feat = pose_rotmats[:, 1:].reshape(b, 135) - self.pose_identity.to(dtype)
        v_posed = v_shaped + (pose_feat @ self.posedirs.to(dtype)).reshape(b, -1, 3)

        # forward kinematics: the MANO tree is depth 3 below the wrist with
        # five independent finger chains, so the 15 per-joint steps are three
        # levels batched over (B, 5 fingers), as in the IK solver (models/ik.py)
        rel = torch.cat([joints[:, :1], joints[:, 1:] - joints.index_select(1, self.parents)], 1)
        top = torch.cat([pose_rotmats, rel[..., None]], dim=-1)  # [B, 16, 3, 4]
        locals_tf = torch.cat([top, self.tf_bottom.to(dtype).expand(b, 16, 1, 4)], dim=-2)
        parent_tf = locals_tf[:, 0:1].expand(b, 5, 4, 4)
        level_tfs = []
        for level in _FK_LEVELS:
            parent_tf = parent_tf @ locals_tf[:, level]
            level_tfs.append(parent_tf)
        # stacked as [B, finger, depth]: each finger's chain in a row, which
        # is MANO's joint order, so no gather
        chains = torch.stack(level_tfs, dim=2).reshape(b, 15, 4, 4)
        world = torch.cat([locals_tf[:, :1], chains], dim=1)  # [B, 16, 4, 4]

        posed_joints = world[:, :, :3, 3]
        # remove the rest-pose joint offset so LBS maps rest verts correctly
        rot = world[:, :, :3, :3]
        world_adj = torch.cat([rot, (posed_joints - mv(rot, joints))[..., None]], dim=-1)
        # only the top three rows of each blended 4x4 reach the vertices
        vert_tf = (self.lbs_weights.to(dtype) @ world_adj.reshape(b, 16, 12)).reshape(b, -1, 3, 4)
        verts = mv(vert_tf[..., :3], v_posed) + vert_tf[..., 3]

        tips = verts.index_select(1, self.tip_ids)
        joints21 = torch.cat([posed_joints, tips], dim=1).index_select(1, self.to_mediapipe)
        return verts * 1000.0, joints21 * 1000.0  # millimeters (manopth convention)

    def from_axis_angle(self, pose: torch.Tensor, betas: torch.Tensor | None = None,
                        flat_hand_mean: bool = True):
        """Axis-angle pose [B, 48] (3 global + 45 articulation) -> forward.

        flat_hand_mean=False adds the model's hands_mean to the articulation
        part, as manopth's flat_hand_mean=False (full_pose = input +
        hands_mean), which the reference's decoder uses.
        """
        if not flat_hand_mean:
            pose = pose + self.pose_mean.to(pose.dtype)
        aa = pose.reshape(pose.shape[0], 16, 3)
        rotmats = rodrigues(aa, torch.linalg.vector_norm(aa, dim=-1))
        return self(rotmats, betas)

    def joints_template(self) -> np.ndarray:
        """Flat-hand 21-joint template in mm (identity pose, zero shape), in
        numpy: at identity pose the forward collapses to rest-pose joint
        regression plus the tip vertices."""
        m = self.model
        joints16 = m.j_regressor @ m.v_template  # [16, 3]
        tips = m.v_template[np.asarray(constants.MANO_TIP_VERT_IDS)]
        j21 = np.concatenate([joints16, tips], axis=0)
        j21 = j21[np.asarray(constants.MANO_TO_MEDIAPIPE)]
        return (j21 * 1000.0).astype(np.float32)


class ManoDecoder(nn.Module):
    """Left/right-hand wrapper: decode(pose, shape, side) -> verts, joints in
    mm. Loads MANO_{RIGHT,LEFT}.pkl from ``mano_dir`` when present;
    otherwise the synthetic stand-in (left = mirrored right)."""

    def __init__(self, mano_dir: str | Path | None = None):
        super().__init__()
        self.layers = nn.ModuleDict()
        for side in ("right", "left"):
            model = None
            if mano_dir is not None:
                path = Path(mano_dir) / f"MANO_{side.upper()}.pkl"
                if path.exists():
                    model = load_mano_model(path)
            if model is None:
                model = synthetic_mano_model()
                if side == "left":
                    model = ManoModel(
                        v_template=model.v_template * np.array([-1.0, 1.0, 1.0], np.float32),
                        shapedirs=model.shapedirs,
                        posedirs=model.posedirs,
                        j_regressor=model.j_regressor,
                        lbs_weights=model.lbs_weights,
                        faces=model.faces,
                        hands_mean=model.hands_mean,
                    )
            self.layers[side] = ManoLayer(model)

    def decode(self, pose: torch.Tensor, shape: torch.Tensor | None = None,
               side: str = "right"):
        """pose: [B, 48] axis-angle or [B, 16, 3, 3] rotmats; shape: [B, 10].

        Axis-angle input follows the reference decoder's manopth settings
        (flat_hand_mean=False): the articulation part is an offset from
        hands_mean, so pose=0 gives the mean-pose hand, not a flat hand."""
        layer = self.layers[side]
        if pose.dim() == 2:
            return layer.from_axis_angle(pose, shape, flat_hand_mean=False)
        return layer(pose, shape)
