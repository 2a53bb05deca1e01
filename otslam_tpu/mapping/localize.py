"""2D scan-to-map localization.

The reference obtains map-frame poses from slam_toolbox's TF (external).
This module closes that gap natively: a LiDAR scan registers against the
occupancy map's occupied cells with planar ICP (the same NN correspondence
kernel as the eval path), refining an odometry prior into a map-frame pose.

Planar trick: scan returns and map cell centers embed at z=0 and run through
the 3D point-to-point ICP; the solved transform is then projected back to
(x, y, yaw). Works for the small per-step corrections of a localization loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from otslam_tpu.core.grid import OccupancyGrid2D
from otslam_tpu.kernels.icp import icp_point_to_point
from otslam_tpu.kernels.nn import auto_nn_window, nn_window_bounds


@dataclass
class LocalizationResult:
    x: float
    y: float
    yaw: float
    fitness: float
    inlier_rmse: float


class ScanLocalizer:
    def __init__(self, grid: OccupancyGrid2D, max_map_points: int = 20000,
                 threshold: float = 0.3, max_correction: float = 1.0,
                 max_yaw_correction: float = 0.5):
        # occupied_world_points returns cell *origins* (the hybrid-map pixel
        # convention); registration wants cell centers
        pts2 = grid.occupied_world_points() + grid.resolution / 2.0
        if len(pts2) > max_map_points:
            sel = np.random.default_rng(0).choice(len(pts2), max_map_points,
                                                  replace=False)
            pts2 = pts2[sel]
        self._map_np = np.concatenate(
            [pts2, np.zeros((len(pts2), 1))], -1).astype(np.float32)
        self._map3 = jnp.asarray(self._map_np)
        # dst side of the window sizing is map-invariant: sort + chunk
        # bounds once here, only the cheap src-side searchsorted runs per
        # localize() call (nn.nn_window_bounds)
        self._map_bounds = (nn_window_bounds(self._map_np)
                            if len(self._map_np) else None)
        self.threshold = threshold
        # localization refines small odometry drift; a correction larger
        # than this is a wrong-basin fit by construction (e.g. a degenerate
        # scan in a symmetric room converging far away at high fitness —
        # observed when a robot ended up against geometry) and the prior
        # is returned instead
        self.max_correction = max_correction
        self.max_yaw_correction = max_yaw_correction

    def localize(self, ranges, angles, prior_pose,
                 max_iterations: int = 20) -> LocalizationResult:
        """Refine (x, y, yaw) so the scan aligns with the map.

        prior_pose: odometry estimate (x, y, yaw); the scan transforms into
        the map frame with it, ICP solves the residual correction. An empty
        map or a scan with no finite returns yields the prior unchanged at
        fitness 0 (the degraded-result contract a perception loop needs —
        never an exception).
        """
        r = np.asarray(ranges)
        a = np.asarray(angles)
        ok = np.isfinite(r) & (r > 0)
        x0, y0, yaw0 = (float(v) for v in prior_pose)
        if self._map_bounds is None or not ok.any():
            return LocalizationResult(x0, y0, yaw0, 0.0, float("inf"))
        c, s = np.cos(yaw0), np.sin(yaw0)
        lx = np.where(ok, r, 0.0) * np.cos(a)
        ly = np.where(ok, r, 0.0) * np.sin(a)
        wx = x0 + lx * c - ly * s
        wy = y0 + lx * s + ly * c
        src = np.stack([wx, wy, np.zeros_like(wx)], -1).astype(np.float32)
        # fixed-shape scan cloud: invalid beams keep their slot (masked),
        # parked at a valid return's position so they never widen the NN
        # window or break a tile's sort coherence — beam count is static
        # per scanner, so every tick shares one jit cache entry
        first = int(np.argmax(ok))
        src[~ok] = src[first]
        # windowed correspondence search against the (fixed) map cloud;
        # round_to=4 collapses near-identical windows onto one jit entry
        nn_w, nn_ax = auto_nn_window(src, self._map_np, self.threshold,
                                     round_to=4, dst_bounds=self._map_bounds)
        res = icp_point_to_point(jnp.asarray(src), self._map3,
                                 threshold=self.threshold,
                                 src_mask=jnp.asarray(ok),
                                 max_iterations=max_iterations, chunk=2048,
                                 nn_window=nn_w, nn_axis=nn_ax)
        T = np.asarray(res.transformation)
        dyaw = float(np.arctan2(T[1, 0], T[0, 0]))
        # corrected pose: T acts on map-frame points, so compose planar parts
        cx, sx = np.cos(dyaw), np.sin(dyaw)
        nx = T[0, 3] + cx * x0 - sx * y0
        ny = T[1, 3] + sx * x0 + cx * y0
        if (not np.isfinite([nx, ny, dyaw]).all()
                or np.hypot(nx - x0, ny - y0) > self.max_correction
                or abs(dyaw) > self.max_yaw_correction):
            # wrong-basin / degenerate fit: keep the odometry prior
            return LocalizationResult(x0, y0, yaw0, 0.0, float("inf"))
        return LocalizationResult(float(nx), float(ny), yaw0 + dyaw,
                                  float(res.fitness), float(res.inlier_rmse))
