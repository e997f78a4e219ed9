"""Visualization of multi-view hand batches (CPU: cv2 + matplotlib), the
counterpart of handmvnet_tpu/vis/visualizer.py: the same panels from the
same numpy inputs, pixel for pixel; the projections go through the port's
ops/camera.reproject_to_views on CPU tensors.

Capability surface of the reference HandPoseVisualizer
(src/vis/visualizer.py:17-710): RGB/crop grids, 2D joints+bones overlays
with the per-finger color table, bbox overlays, combined heatmaps, projected
joints/vertices on full frames, 3D joint/vertex scatter plots, and the
static helper used by the training hook
(plot_images_with_joints; reference handmvnet.py:425-441).

Mesh rendering: pyrender/trimesh are not part of this stack; a matplotlib
trisurf fallback renders MANO meshes offline.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

import torch

from handmvnet_tpu_torch.constants import HAND_EDGE_COLORS, HAND_EDGES
from handmvnet_tpu_torch.ops.camera import reproject_to_views

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def reverse_transform(img: np.ndarray) -> np.ndarray:
    """Undo ImageNet normalization -> uint8 RGB. img: [H, W, 3] (or [3, H, W];
    reference vis/utils.py:4-20)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] == 3 and img.shape[-1] != 3:
        img = np.transpose(img, (1, 2, 0))
    out = (img * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def _edge_color_bgr(i: int) -> tuple[int, int, int]:
    r, g, b = HAND_EDGE_COLORS[i + 1]  # index 0 is the wrist/root color
    return int(b * 255), int(g * 255), int(r * 255)


def draw_joints_2d(
    image: np.ndarray,
    joints: np.ndarray,
    draw_bones: bool = True,
    radius: int = 2,
) -> np.ndarray:
    """Draw 21 joints (+ colored bones) on an RGB uint8 image (returns BGR
    like the reference, which feeds cv2.imwrite directly)."""
    import cv2

    canvas = np.ascontiguousarray(image[:, :, ::-1]).copy()  # RGB -> BGR
    pts = np.asarray(joints)
    if draw_bones:
        for i, (a, b) in enumerate(HAND_EDGES):
            pa, pb = pts[a], pts[b]
            if np.isfinite(pa).all() and np.isfinite(pb).all():
                cv2.line(canvas, tuple(pa.astype(int)), tuple(pb.astype(int)),
                         _edge_color_bgr(i), 1, cv2.LINE_AA)
    for p in pts:
        if np.isfinite(p).all():
            cv2.circle(canvas, tuple(p.astype(int)), radius, (0, 0, 255), -1, cv2.LINE_AA)
    return canvas


def _grid(images: Sequence[np.ndarray], cols: int | None = None) -> np.ndarray:
    import cv2

    n = len(images)
    cols = cols or n
    rows = (n + cols - 1) // cols
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    canvas = np.zeros((rows * h, cols * w, 3), dtype=np.uint8)
    for i, im in enumerate(images):
        if im.shape[:2] != (h, w):
            im = cv2.resize(im, (w, h))
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return canvas


class HandPoseVisualizer:
    """Batch-dict-driven visualizer. Accepts the flat batch schema of this
    framework ({rgb, full_rgb, joints_crop_img, heatmap, bboxes, ...}); all
    methods operate on sample `idx` and return BGR uint8 canvases."""

    def __init__(self, batch: Mapping[str, np.ndarray], faces: np.ndarray | None = None):
        self.batch = {k: np.asarray(v) for k, v in batch.items()
                      if not isinstance(v, (list, str))}
        if faces is None:
            # MANO topology (wrist-closed, reference vis/utils.py:23-46);
            # the synthetic stand-in shares the real vertex count
            from handmvnet_tpu_torch.constants import close_mano_faces
            from handmvnet_tpu_torch.models.mano import synthetic_mano_model

            faces = close_mano_faces(synthetic_mano_model().faces)
        self.faces = np.asarray(faces, np.int32)

    def _root_idx(self, idx: int) -> int:
        """The view whose camera frame the 3D labels/predictions live in
        (HO3D 0, DexYCB 2, MVHand 3 — reference per-dataset root_idx).
        Hardcoding 0 mis-projects every non-HO3D overlay."""
        r = self.batch.get("root_idx")
        if r is None:
            return 0
        r = np.asarray(r)
        return int(r.flat[min(idx, r.size - 1)])

    def _project(self, points_mm: np.ndarray, idx: int) -> np.ndarray:
        """Root-relative points [N, 3] in mm (plus the sample's root joint)
        -> pixels [V, N, 2] in every view of sample ``idx``."""
        points = (points_mm + self.batch["root_joint"][idx])[None] / 1000.0
        return reproject_to_views(
            torch.as_tensor(points), self._root_idx(idx),
            torch.as_tensor(self.batch["intrinsic"][idx][None]),
            torch.as_tensor(self.batch["extrinsic"][idx][None]),
        )[0].numpy()

    # ------------------------------------------------------------- images
    def _views(self, key: str, idx: int) -> np.ndarray:
        arr = self.batch[key][idx]
        if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
            arr = np.transpose(arr, (0, 2, 3, 1))
        return arr

    def visualize_rgb_image(self, idx: int = 0) -> np.ndarray:
        views = self._views("rgb", idx)
        return _grid([reverse_transform(v)[:, :, ::-1] for v in views])

    def visualize_full_rgb_image(self, idx: int = 0) -> np.ndarray:
        views = self._views("full_rgb", idx)
        if views.dtype != np.uint8:
            views = np.stack([reverse_transform(v) for v in views])
        return _grid([v[:, :, ::-1] for v in views])

    # ------------------------------------------------------------- joints
    @staticmethod
    def plot_images_with_joints(images, joints, show: bool = False) -> np.ndarray:
        """Per-view 2D joints on normalized crop images — the training-hook
        helper (reference handmvnet.py:432-441)."""
        images = np.asarray(images)
        if images.ndim == 4 and images.shape[1] == 3 and images.shape[-1] != 3:
            images = np.transpose(images, (0, 2, 3, 1))
        joints = np.asarray(joints)
        panels = [
            draw_joints_2d(reverse_transform(img), j2d)
            for img, j2d in zip(images, joints)
        ]
        canvas = _grid(panels)
        if show:  # pragma: no cover
            import matplotlib.pyplot as plt

            plt.imshow(canvas[:, :, ::-1])
            plt.axis("off")
            plt.show()
        return canvas

    def visualize_joints_2d_on_cropped_image(self, idx: int = 0) -> np.ndarray:
        return self.plot_images_with_joints(
            self.batch["rgb"][idx], self.batch["joints_crop_img"][idx]
        )

    def visualize_joints_2d_on_full_image(self, idx: int = 0) -> np.ndarray:
        views = self._views("full_rgb", idx)
        joints = self.batch["joints_img"][idx]
        return _grid([draw_joints_2d(v, j) for v, j in zip(views, joints)])

    def visualize_bboxes(self, idx: int = 0) -> np.ndarray:
        import cv2

        views = self._views("full_rgb", idx)
        boxes = self.batch["bboxes"][idx].astype(int)
        panels = []
        for v, b in zip(views, boxes):
            canvas = np.ascontiguousarray(v[:, :, ::-1]).copy()
            cv2.rectangle(canvas, (b[0], b[1]), (b[2], b[3]), (0, 255, 0), 2)
            panels.append(canvas)
        return _grid(panels)

    def visualize_masks(self, idx: int = 0) -> np.ndarray:
        """Per-view binary/soft mask grid (reference visualizer's mask
        stream; shown when a 'mask' key is present in the batch)."""
        import cv2

        masks = self.batch["mask"][idx]  # [V, h, w] or [V, 1, h, w]
        if masks.ndim == 4:
            masks = masks[:, 0] if masks.shape[1] == 1 else masks[..., 0]
        panels = []
        for m in masks:
            norm = (m - m.min()) / (np.ptp(m) + 1e-8)
            img = (norm * 255).astype(np.uint8)
            panels.append(cv2.cvtColor(cv2.resize(img, (256, 256)), cv2.COLOR_GRAY2BGR))
        return _grid(panels)

    def visualize_depths(self, idx: int = 0) -> np.ndarray:
        """Per-view depth grid with a turbo colormap."""
        import cv2

        depths = self.batch["depth"][idx]
        if depths.ndim == 4:
            depths = depths[:, 0] if depths.shape[1] == 1 else depths[..., 0]
        panels = []
        for d in depths:
            norm = (d - d.min()) / (np.ptp(d) + 1e-8)
            img = cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_TURBO)
            panels.append(cv2.resize(img, (256, 256)))
        return _grid(panels)

    # ----------------------------------------------------------- heatmaps
    def visualize_combined_heatmaps(self, idx: int = 0) -> np.ndarray:
        import cv2

        hms = self.batch["heatmap"][idx]  # [V, J, h, h]
        panels = []
        for v in range(hms.shape[0]):
            combined = hms[v].max(axis=0)
            norm = (combined - combined.min()) / (np.ptp(combined) + 1e-8)
            img = cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_JET)
            panels.append(cv2.resize(img, (256, 256), interpolation=cv2.INTER_NEAREST))
        return _grid(panels)

    # ------------------------------------------------------- projections
    def visualize_projected_joints_2d_on_full_image(self, idx: int = 0) -> np.ndarray:
        projected = self._project(self.batch["joints_cam"][idx], idx)
        views = self._views("full_rgb", idx)
        return _grid([draw_joints_2d(v, j) for v, j in zip(views, projected)])

    def visualize_projected_vertices_2d_on_full_image(
        self, idx: int = 0, stride: int = 8
    ) -> np.ndarray:
        """Project the GT/pred mesh vertices into every view (subsampled by
        ``stride`` for drawing speed)."""
        import cv2

        projected = self._project(self.batch["vertices"][idx], idx)[:, ::stride]
        views = self._views("full_rgb", idx)
        panels = []
        for v, pts in zip(views, projected):
            canvas = np.ascontiguousarray(v[:, :, ::-1]).copy()
            for p in pts:
                if np.isfinite(p).all():
                    cv2.circle(canvas, tuple(p.astype(int)), 1, (255, 128, 0), -1)
            panels.append(canvas)
        return _grid(panels)

    # -------------------------------------------------------------- 3D
    def visualize_3d_joints(self, idx: int = 0, save_path: str | None = None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        joints = self.batch["joints_cam"][idx]
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        for i, (a, b) in enumerate(HAND_EDGES):
            seg = joints[[a, b]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c=HAND_EDGE_COLORS[i + 1])
        ax.scatter(joints[:, 0], joints[:, 1], joints[:, 2], c="red", s=12)
        ax.set_box_aspect((1, 1, 1))
        if save_path:
            fig.savefig(save_path, dpi=100, bbox_inches="tight")
            plt.close(fig)
            return save_path
        return fig

    def visualize_3d_vertices(self, idx: int = 0, save_path: str | None = None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        verts = self.batch["vertices"][idx]
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(verts[:, 0], verts[:, 1], verts[:, 2], s=1, c="steelblue")
        ax.set_box_aspect((1, 1, 1))
        if save_path:
            fig.savefig(save_path, dpi=100, bbox_inches="tight")
            plt.close(fig)
            return save_path
        return fig

    def _verts_in_view_mm(self, idx: int) -> np.ndarray:
        """Absolute mesh vertices per view in camera space, millimeters:
        root-frame (vertices + root) moved through inv(T_v) @ T_root."""
        verts = (self.batch["vertices"][idx] + self.batch["root_joint"][idx]) / 1000.0
        extr = self.batch["extrinsic"][idx]  # [V, 4, 4] cam->world
        rel = np.linalg.inv(extr) @ extr[self._root_idx(idx)]
        ph = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=-1)
        return np.einsum("vij,nj->vni", rel, ph)[..., :3] * 1000.0

    def visualize_mesh_on_image(self, idx: int = 0) -> np.ndarray:
        """Shaded MANO mesh composited over every camera frame (the
        reference's pyrender path, visualizer.py:602-710, rebuilt on the
        first-party z-buffer rasterizer)."""
        from handmvnet_tpu_torch.vis.mesh_render import render_mesh_on_image

        views = self._views("full_rgb", idx)
        verts_mm = self._verts_in_view_mm(idx)
        intr = self.batch["intrinsic"][idx]
        panels = []
        for v in range(views.shape[0]):
            bg = np.ascontiguousarray(views[v][:, :, ::-1])
            blended, _ = render_mesh_on_image(bg, verts_mm[v], self.faces, intr[v])
            panels.append(blended)
        return _grid(panels)

    @staticmethod
    def draw_vertices_wireframe(image_bgr: np.ndarray, vertices2d: np.ndarray,
                                faces: np.ndarray) -> np.ndarray:
        """White face-edge wireframe on an image (reference
        _draw_vertices_on_image, visualizer.py:318-327)."""
        import cv2

        canvas = np.ascontiguousarray(image_bgr).copy()
        pts = np.asarray(vertices2d)
        polys = pts[np.asarray(faces)].astype(np.int32)  # [F, 3, 2]
        finite = np.isfinite(pts[np.asarray(faces)]).all(axis=(1, 2))
        cv2.polylines(canvas, list(polys[finite]), isClosed=True,
                      color=(255, 255, 255), thickness=1)
        return canvas

    def visualize_vertices_wireframe_on_full_image(
        self, idx: int = 0, with_bboxes: bool = True
    ) -> np.ndarray:
        """Darkened frames + projected-mesh wireframe + bounding boxes
        (reference plot_full_images_with_vertices_and_bboxes,
        visualizer.py:457-489)."""
        import cv2

        v2d = self._project(self.batch["vertices"][idx], idx)
        views = self._views("full_rgb", idx)
        boxes = self.batch["bboxes"][idx].astype(int)
        panels = []
        for v in range(views.shape[0]):
            img = (views[v][:, :, ::-1] * 0.5).astype(np.uint8)  # dark_factor
            img = self.draw_vertices_wireframe(img, v2d[v], self.faces)
            if with_bboxes:
                cv2.rectangle(img, (boxes[v][0], boxes[v][1]),
                              (boxes[v][2], boxes[v][3]), (255, 0, 0), 2)
            panels.append(img)
        return _grid(panels)

    @staticmethod
    def plot_joints_3d_predictions(points_pred: np.ndarray,
                                   points_gt: np.ndarray) -> np.ndarray:
        """Pred (solid blue) vs GT (dashed green) 3D skeletons in one axes
        (reference visualizer.py:525-573); returns an RGBA ndarray."""
        import io

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
        for a, b in HAND_EDGES:
            seg = np.asarray(points_pred)[[a, b]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="blue")
        for a, b in HAND_EDGES:
            seg = np.asarray(points_gt)[[a, b]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], linestyle="dashed",
                    color="green")
        ax.set_xticklabels([])
        ax.set_yticklabels([])
        ax.set_zticklabels([])
        buf = io.BytesIO()
        fig.savefig(buf, format="png")
        plt.close(fig)
        buf.seek(0)
        import matplotlib.image as mpimg

        return (mpimg.imread(buf) * 255).astype(np.uint8)

    def visualize_3d_mesh(self, vertices_pred: np.ndarray,
                          vertices_gt: np.ndarray | None = None,
                          size: int = 256) -> np.ndarray:
        """Standalone 256^2 mesh card (reference visualize_3d_mesh,
        visualizer.py:602-641, built on plotly). plotly isn't available
        here, so the first-party rasterizer renders the same composition:
        pred in blue over an optional gray GT, orbit camera at -z."""
        from handmvnet_tpu_torch.vis.mesh_render import rasterize_mesh

        # one shared normalization over BOTH layers so their relative
        # placement survives (the reference draws both meshes in the same
        # plotly scene)
        all_v = np.asarray(vertices_pred, np.float64)
        if vertices_gt is not None:
            all_v = np.concatenate([all_v, np.asarray(vertices_gt, np.float64)])
        center = all_v.mean(axis=0)
        scale = np.abs(all_v - center).max() + 1e-9

        def card(verts, color):
            v = (np.asarray(verts, np.float64) - center) / scale
            # camera at -z looking at the mesh centered at z=2.5 (the
            # reference's default plotly eye distance), f fills the frame
            v = v * np.array([1.0, -1.0, -1.0]) + np.array([0.0, 0.0, 2.5])
            f = size * 1.0
            return rasterize_mesh(
                v, self.faces, np.array([f, f, size / 2, size / 2]),
                size, size, color=color,
            )

        canvas = np.full((size, size, 3), 255, np.uint8)
        if vertices_gt is not None:
            rgb, depth = card(vertices_gt, np.array([0.6, 0.6, 0.6]))
            canvas = np.where((depth > 0)[..., None], rgb[..., ::-1], canvas)
        rgb, depth = card(vertices_pred, np.array([0.25, 0.35, 0.9]))
        canvas = np.where((depth > 0)[..., None], rgb[..., ::-1], canvas)
        return canvas.astype(np.uint8)

    def render_mesh(self, vertices: np.ndarray, faces: np.ndarray,
                    save_path: str | None = None):
        """Offline MANO mesh render via matplotlib trisurf (pyrender-free)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        ax.plot_trisurf(
            vertices[:, 0], vertices[:, 1], vertices[:, 2],
            triangles=faces, color=(0.8, 0.7, 0.6), edgecolor="none",
        )
        ax.set_box_aspect((1, 1, 1))
        if save_path:
            fig.savefig(save_path, dpi=100, bbox_inches="tight")
            plt.close(fig)
            return save_path
        return fig
