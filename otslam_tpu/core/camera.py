"""Pinhole camera model.

Reference semantics: Open3D `PinholeCameraIntrinsic(width, height, fx, fy, cx, cy)`
as configured in /root/reference/3d_model/reconstruct_rgbd.py:12-15 (fx = fy =
565.6009, cx = 320.5, cy = 240.5, 640x480).

Design: the intrinsics are a tiny frozen dataclass (static under
jit); the per-pixel back-projection directions are generated once as a dense
(H, W, 3) array so every downstream op is a fused elementwise kernel over the
whole image, never a per-pixel loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from otslam_tpu.config import CameraConfig


@dataclass(frozen=True)
class PinholeIntrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_config(cls, cfg: CameraConfig) -> "PinholeIntrinsics":
        return cls(cfg.width, cfg.height, cfg.fx, cfg.fy, cfg.cx, cfg.cy)

    @property
    def K(self) -> np.ndarray:
        """3x3 intrinsics matrix."""
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    def pixel_rays_np(self, dtype=np.float32) -> np.ndarray:
        """(H, W, 3) camera-frame ray directions with unit z, HOST numpy.

        point = depth * ray  reproduces Open3D's back-projection
        x = (u - cx) * z / fx, y = (v - cy) * z / fy (pixel centers at integer
        coordinates, matching Open3D's convention).

        Setup-time geometry stays on the host (no device compiles or
        fetches before real work). f32 numpy arithmetic (python scalars are
        weak under NEP 50) is bit-identical to an eager-jnp f32
        formulation; f64 computes in f64.
        """
        u = np.arange(self.width, dtype=dtype)
        v = np.arange(self.height, dtype=dtype)
        uu, vv = np.meshgrid(u, v)  # (H, W)
        x = (uu - self.cx) / self.fx
        y = (vv - self.cy) / self.fy
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    def pixel_rays(self, dtype=jnp.float32) -> jnp.ndarray:
        """Device copy of pixel_rays_np, computed at the requested precision
        when it is a numpy float type (f32/f64), else computed in f32 and
        cast once (e.g. bfloat16)."""
        try:
            np_dt = np.dtype(jnp.dtype(dtype).name)
            if np_dt.kind != "f" or np_dt.itemsize < 4:
                np_dt = np.dtype(np.float32)
        except TypeError:
            np_dt = np.dtype(np.float32)
        return jnp.asarray(self.pixel_rays_np(np_dt)).astype(dtype)

    def project(self, pts_cam: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Project camera-frame points (..., 3) to pixel coords.

        Returns (u, v, z) each shaped (...,). Callers mask on z > 0 and bounds.
        """
        x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
        zsafe = jnp.where(z != 0, z, 1.0)
        u = self.fx * x / zsafe + self.cx
        v = self.fy * y / zsafe + self.cy
        return u, v, z
