"""Virtual scan generation: what the saved 2D map *should* look like.

Equivalent of the virtual_scan_node (virtual_scan_node.cpp:176-298): given a
latched occupancy map and the robot's map-frame pose, synthesize a LaserScan
by ray casting, copying the template scan's angular configuration.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from otslam_tpu.config import LidarConfig
from otslam_tpu.core.grid import OccupancyGrid2D
from otslam_tpu.kernels.raycast import raycast_grid


class VirtualScanner:
    """Host-side wrapper owning the latched map (the 'map_callback' state)."""

    def __init__(self, lidar: LidarConfig | None = None):
        self.lidar = lidar or LidarConfig()
        self._map: OccupancyGrid2D | None = None
        self._angles = None

    def set_map(self, grid: OccupancyGrid2D) -> None:
        """Latched /virtual_map subscription equivalent."""
        self._map = grid

    @property
    def has_map(self) -> bool:
        return self._map is not None

    def angles(self) -> jnp.ndarray:
        if self._angles is None:
            n = self.lidar.num_beams
            inc = (self.lidar.angle_max - self.lidar.angle_min) / n
            self._angles = jnp.asarray(
                self.lidar.angle_min + np.arange(n) * inc, dtype=jnp.float32)
        return self._angles

    def scan(self, robot_x: float, robot_y: float, robot_yaw: float) -> jnp.ndarray:
        """Ranges (num_beams,) f32, +inf = no hit. Requires a latched map."""
        if self._map is None:
            raise RuntimeError("no map latched; call set_map first")
        g = self._map
        return raycast_grid(
            g.data, float(g.resolution), float(g.origin[0]), float(g.origin[1]),
            jnp.float32(robot_x), jnp.float32(robot_y), jnp.float32(robot_yaw),
            self.angles(), float(self.lidar.range_max))
