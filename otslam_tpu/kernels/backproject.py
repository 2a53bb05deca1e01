"""RGB-D back-projection and depth filtering.

Reference behavior being reproduced (not translated):
  * Open3D ``RGBDImage.create_from_color_and_depth(depth_scale=1000, depth_trunc,
    convert_rgb_to_intensity=False)`` — depth/1000, returns > trunc zeroed
    (reconstruct_rgbd.py:99-104).
  * Open3D ``PointCloud.create_from_rgbd_image`` — pinhole back-projection
    (check_one_frame.py:22-30).
  * scanner_node capture clipping — NaN -> 0, > 5 m -> 0 (scanner_node.cpp:277-281).

Whole-image fused elementwise ops; the (H, W, 3) ray grid is
precomputed once per intrinsics and the per-frame work is one multiply.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.core.pointcloud import PointCloud
from functools import partial


@partial(jax.jit, static_argnames=("depth_trunc",))
def filter_depth(depth_m: jnp.ndarray, depth_trunc: float = 3.0) -> jnp.ndarray:
    """Zero out invalid returns: NaN/inf, non-positive, beyond depth_trunc."""
    d = jnp.nan_to_num(depth_m, nan=0.0, posinf=0.0, neginf=0.0)
    return jnp.where((d > 0.0) & (d <= depth_trunc), d, 0.0)


def backproject_depth(depth_m: jnp.ndarray, rays: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """depth (H, W) x rays (H, W, 3) -> points (H, W, 3), valid (H, W)."""
    pts = depth_m[..., None] * rays
    return pts, depth_m > 0.0


@partial(jax.jit, static_argnames=("intr", "depth_trunc"))
def backproject_pointcloud(depth_m: jnp.ndarray, color_rgb: jnp.ndarray | None,
                           intr: PinholeIntrinsics,
                           depth_trunc: float = 3.0,
                           extrinsic_inv: jnp.ndarray | None = None) -> PointCloud:
    """One RGB-D frame -> padded camera-frame (or world-frame) point cloud.

    color_rgb: (H, W, 3) uint8 or float [0,1] or None.
    extrinsic_inv: optional camera->world 4x4 to place points in world frame.
    """
    d = filter_depth(depth_m, depth_trunc)
    pts, valid = backproject_depth(d, intr.pixel_rays(dtype=d.dtype))
    pts = pts.reshape(-1, 3)
    mask = valid.reshape(-1)
    cols = None
    if color_rgb is not None:
        cols = color_rgb.reshape(-1, 3)
        if cols.dtype == jnp.uint8:
            cols = cols.astype(jnp.float32) / 255.0
    if extrinsic_inv is not None:
        R = extrinsic_inv[:3, :3].astype(pts.dtype)
        t = extrinsic_inv[:3, 3].astype(pts.dtype)
        pts = pts @ R.T + t
    return PointCloud(pts, cols, mask)
