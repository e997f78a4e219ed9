"""Offscreen MANO mesh rendering without pyrender/OpenGL (a copy of
handmvnet_tpu/vis/mesh_render.py: the port imports nothing of the JAX
package).

The reference composites the hand mesh onto camera frames with
trimesh + pyrender + a 3-point light rig (src/vis/visualizer.py:602-710).
pyrender needs an OpenGL context this environment doesn't have, so this is a
first-party z-buffer rasterizer: ~1550 triangles at camera-frame resolution
is comfortably a numpy job (a few ms per view), and visualization is off the
hot path by construction.

Pipeline: camera-space vertices -> pinhole projection -> per-face flat
Lambert shading (ambient + 3 directional lights, mirroring the reference's
spot + 3 point lights) -> per-face z-buffered barycentric fill -> alpha-less
depth-mask blend over the background (reference :703-710).
"""

from __future__ import annotations

import numpy as np

# default skin tone + lights follow the reference rig ("light_blue" vertex
# color, intensity-10 key + three fill lights; visualizer.py:607-676)
MESH_COLOR = np.array([0.96, 0.74, 0.65], np.float32)
AMBIENT = 0.35
# directional approximations of the reference's point-light positions
LIGHT_DIRS = np.array(
    [[0.0, 0.0, -1.0], [0.5, -0.5, -0.7], [-0.6, 0.3, -0.7]], np.float32
)
LIGHT_WEIGHTS = np.array([0.55, 0.25, 0.2], np.float32)


def _normalize(v: np.ndarray, axis: int = -1) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-9)


def rasterize_mesh(
    vertices_cam: np.ndarray,
    faces: np.ndarray,
    intrinsic: np.ndarray,
    height: int,
    width: int,
    color: np.ndarray = MESH_COLOR,
) -> tuple[np.ndarray, np.ndarray]:
    """Render a triangle mesh seen from a pinhole camera.

    Args:
      vertices_cam: [N, 3] camera-space vertices (any metric unit, +z forward).
      faces: [F, 3] int vertex indices.
      intrinsic: [4] (fx, fy, cx, cy) — the framework's vector convention.
      height, width: output raster size.
      color: base RGB in [0, 1].

    Returns:
      (rgb uint8 [H, W, 3], depth float32 [H, W]; depth == 0 where no mesh).
    """
    verts = np.asarray(vertices_cam, np.float64)
    faces = np.asarray(faces, np.int64)
    fx, fy, cx, cy = [float(x) for x in np.asarray(intrinsic).reshape(-1)[:4]]

    z = verts[:, 2]
    u = verts[:, 0] * fx / np.maximum(z, 1e-9) + cx
    v = verts[:, 1] * fy / np.maximum(z, 1e-9) + cy
    uv = np.stack([u, v], axis=-1)

    # flat shading per face (two-sided: MANO winding is consistent but the
    # camera may see the palm or the back)
    tri = verts[faces]  # [F, 3, 3]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = _normalize(n)
    lambert = np.abs(n @ _normalize(LIGHT_DIRS).T)  # [F, L]
    intensity = np.clip(AMBIENT + lambert @ LIGHT_WEIGHTS, 0.0, 1.0)
    face_rgb = (np.asarray(color, np.float64)[None] * intensity[:, None] * 255.0)

    depth = np.full((height, width), np.inf, np.float64)
    rgb = np.zeros((height, width, 3), np.float64)

    tri_uv = uv[faces]  # [F, 3, 2]
    tri_z = z[faces]  # [F, 3]
    # skip triangles behind the camera or fully off-raster
    ok = (tri_z > 1e-6).all(axis=1)
    ok &= (tri_uv[..., 0].max(axis=1) >= 0) & (tri_uv[..., 0].min(axis=1) < width)
    ok &= (tri_uv[..., 1].max(axis=1) >= 0) & (tri_uv[..., 1].min(axis=1) < height)

    for f in np.nonzero(ok)[0]:
        (x0, y0), (x1, y1), (x2, y2) = tri_uv[f]
        xmin = max(int(np.floor(min(x0, x1, x2))), 0)
        xmax = min(int(np.ceil(max(x0, x1, x2))) + 1, width)
        ymin = max(int(np.floor(min(y0, y1, y2))), 0)
        ymax = min(int(np.ceil(max(y0, y1, y2))) + 1, height)
        if xmin >= xmax or ymin >= ymax:
            continue
        xs, ys = np.meshgrid(
            np.arange(xmin, xmax) + 0.5, np.arange(ymin, ymax) + 0.5
        )
        # barycentric coordinates over the pixel grid
        d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(d) < 1e-12:
            continue
        w0 = ((y1 - y2) * (xs - x2) + (x2 - x1) * (ys - y2)) / d
        w1 = ((y2 - y0) * (xs - x2) + (x0 - x2) * (ys - y2)) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z
        zi = 1.0 / (
            w0 / tri_z[f, 0] + w1 / tri_z[f, 1] + w2 / tri_z[f, 2]
        )
        tile = depth[ymin:ymax, xmin:xmax]
        win = inside & (zi < tile)
        tile[win] = zi[win]
        rgb[ymin:ymax, xmin:xmax][win] = face_rgb[f]

    depth[~np.isfinite(depth)] = 0.0
    return rgb.astype(np.uint8), depth.astype(np.float32)


def render_mesh_on_image(
    background_bgr: np.ndarray,
    vertices_cam: np.ndarray,
    faces: np.ndarray,
    intrinsic: np.ndarray,
    color: np.ndarray = MESH_COLOR,
) -> tuple[np.ndarray, np.ndarray]:
    """Composite the rendered mesh over a BGR frame where depth > 0
    (reference generate_mesh_from_verts, visualizer.py:644-710).

    vertices_cam in the frame's camera space (same unit as intrinsics
    expect — the framework uses millimeters on this path).
    Returns (blended BGR uint8, depth map).
    """
    h, w = background_bgr.shape[:2]
    rgb, depth = rasterize_mesh(vertices_cam, faces, intrinsic, h, w, color)
    mask = depth > 0
    blended = np.where(mask[..., None], rgb[..., ::-1], background_bgr)
    return blended.astype(np.uint8), depth
