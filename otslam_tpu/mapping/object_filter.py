"""Object-vs-wall proximity filter (the launch-variant-2 gate).

Equivalent of the object_filter node (object_filter.cpp:40-160): the virtual
scan converts to map-frame wall points; any candidate object point within
``proximity_threshold`` (default 0.5 m) of a wall point is dropped. The C++
brute-force O(N*M) scan becomes the tiled NN distance search.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from otslam_tpu.kernels.nn import nn_distance


class WallProximityFilter:
    def __init__(self, proximity_threshold: float = 0.5):
        self.proximity_threshold = proximity_threshold
        self._walls: jnp.ndarray | None = None   # (M, 2) map frame

    def on_virtual_scan(self, ranges: jnp.ndarray, angles: jnp.ndarray,
                        robot_pose) -> None:
        """Cache the latest wall points (finite virtual returns, map frame)."""
        r = np.asarray(ranges)
        a = np.asarray(angles)
        ok = np.isfinite(r)
        if not ok.any():
            self._walls = None
            return
        x0, y0, yaw = robot_pose
        lx = r[ok] * np.cos(a[ok])
        ly = r[ok] * np.sin(a[ok])
        c, s = np.cos(yaw), np.sin(yaw)
        wx = x0 + lx * c - ly * s
        wy = y0 + lx * s + ly * c
        self._walls = jnp.asarray(np.stack([wx, wy], -1).astype(np.float32))

    def filter(self, object_points: np.ndarray) -> np.ndarray:
        """Drop object points near walls. No wall data yet -> empty output
        (the node returns without publishing, object_filter.cpp:93)."""
        pts = np.asarray(object_points, np.float32).reshape(-1, 2)
        if self._walls is None:
            return pts[:0]
        if len(pts) == 0:
            return pts
        src = jnp.asarray(np.concatenate(
            [pts, np.zeros((len(pts), 1), np.float32)], -1))
        dst = jnp.concatenate(
            [self._walls, jnp.zeros((self._walls.shape[0], 1))], -1)
        d = np.asarray(nn_distance(src, dst, chunk=2048))
        return pts[d >= self.proximity_threshold]


class StaticWallFilter:
    """Map-structure gate for the REMOVED-evidence stream.

    A removed-object candidate is, by definition, a map-occupied region the
    live scan no longer confirms — so it cannot be distance-gated against
    all occupied cells (that would erase true removals). But residual pose
    error during long transits makes WALL cells flicker as "removed"
    (corner smears pass the selector's bbox thin test, which is the only
    gate the reference has: 3_multi_object_goal_selector.cpp:205-212). The
    distinction is structure: walls belong to LARGE connected components of
    the saved map, removable objects to small ones. This filter labels the
    map's occupied components once, keeps components whose bbox extent
    exceeds ``wall_extent_m`` as walls, dilates them by ``margin_m``, and
    drops evidence points inside the dilated wall mask. Host-side and
    O(1) per point (one precomputed boolean grid lookup).
    """

    def __init__(self, grid, wall_extent_m: float = 2.0,
                 margin_m: float = 0.3):
        from scipy import ndimage

        data = np.asarray(grid.data)
        res = float(grid.resolution)
        occ = data == 100
        labels, num = ndimage.label(occ)
        wall = np.zeros_like(occ)
        for k, sl in enumerate(ndimage.find_objects(labels), start=1):
            if sl is None:
                continue
            h = (sl[0].stop - sl[0].start) * res
            w = (sl[1].stop - sl[1].start) * res
            if max(h, w) >= wall_extent_m:
                # only this component's cells — the wall RING's bbox spans
                # the whole map and would otherwise swallow every object
                wall[sl] |= labels[sl] == k
        it = max(1, int(np.ceil(margin_m / res)))
        self._mask = ndimage.binary_dilation(wall, iterations=it)
        self._res = res
        self._ox = float(grid.origin[0])
        self._oy = float(grid.origin[1])

    def filter(self, points: np.ndarray) -> np.ndarray:
        """Drop map-frame (N, 2) points that fall inside dilated wall
        structure; points outside the grid pass through unchanged."""
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        if len(pts) == 0:
            return pts
        j = np.floor((pts[:, 0] - self._ox) / self._res).astype(int)
        i = np.floor((pts[:, 1] - self._oy) / self._res).astype(int)
        h, w = self._mask.shape
        inside = (i >= 0) & (i < h) & (j >= 0) & (j < w)
        hit = np.zeros(len(pts), bool)
        hit[inside] = self._mask[i[inside], j[inside]]
        return pts[~hit]
