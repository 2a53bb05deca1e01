"""2D occupancy-grid mapping from LiDAR scans (log-odds).

The reference delegates 2D map building to slam_toolbox (README.md:70,
external). This module provides the capability natively for the
known-pose case (simulation ground truth or an external localizer): each
scan's beams clear free space up to the return and mark the hit cell, as
log-odds updates on a dense grid; the result exports to the same PGM+YAML
format the rest of the stack consumes.

Shape: all beams x all ray steps are evaluated at once (same
stepping pattern as the virtual-scan kernel); free/hit evidence lands in the
grid with two scatter-max/adds per scan, batched over whole trajectories
with ``lax.scan`` in a single dispatch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from otslam_tpu.config import LidarConfig
from otslam_tpu.core.grid import OccupancyGrid2D

L_FREE = -0.4     # log-odds decrement for traversed cells
L_OCC = 0.85      # log-odds increment for hit cells
L_MIN, L_MAX = -4.0, 4.0
OCC_THRESH = 0.7  # p(occupied) above this -> occupied
FREE_THRESH = 0.3


@partial(jax.jit, static_argnames=("resolution", "range_max", "gh", "gw"))
def _scan_update(logodds: jnp.ndarray, ranges: jnp.ndarray,
                 angles: jnp.ndarray, pose: jnp.ndarray,
                 origin_x: float, origin_y: float,
                 resolution: float, range_max: float, gh: int, gw: int):
    x0, y0, yaw = pose[0], pose[1], pose[2]
    ga = yaw + angles
    r = jnp.nan_to_num(ranges, nan=0.0, posinf=0.0)
    has_hit = (r > 0) & (r <= range_max)
    # trace to the return (or range_max when no return)
    trace_r = jnp.where(has_hit, r, range_max)

    num_steps = int(range_max / resolution) + 1
    steps = (jnp.arange(num_steps, dtype=jnp.float32) + 0.5) * resolution
    px = x0 + steps[None, :] * jnp.cos(ga)[:, None]      # (B, S)
    py = y0 + steps[None, :] * jnp.sin(ga)[:, None]
    gx = jnp.floor((px - origin_x) / resolution).astype(jnp.int32)
    gy = jnp.floor((py - origin_y) / resolution).astype(jnp.int32)
    inb = (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)

    free = inb & (steps[None, :] < trace_r[:, None] - resolution)
    flat_all = jnp.where(inb, gy * gw + gx, gh * gw)

    # free-space clearing: a cell is decremented once per scan if ANY beam
    # traversed it (scatter-max of a bool, then one fused update)
    free_mask = jnp.zeros(gh * gw + 1, bool).at[
        jnp.where(free, flat_all, gh * gw)].set(True, mode="drop")[:-1]

    # hit cells: one increment per scan per cell
    hx = x0 + trace_r * jnp.cos(ga)
    hy = y0 + trace_r * jnp.sin(ga)
    hgx = jnp.floor((hx - origin_x) / resolution).astype(jnp.int32)
    hgy = jnp.floor((hy - origin_y) / resolution).astype(jnp.int32)
    hinb = has_hit & (hgx >= 0) & (hgx < gw) & (hgy >= 0) & (hgy < gh)
    hit_mask = jnp.zeros(gh * gw + 1, bool).at[
        jnp.where(hinb, hgy * gw + hgx, gh * gw)].set(True, mode="drop")[:-1]

    delta = (jnp.where(hit_mask, L_OCC, 0.0)
             + jnp.where(free_mask & ~hit_mask, L_FREE, 0.0))
    return jnp.clip(logodds + delta.reshape(gh, gw), L_MIN, L_MAX)


class GridMapper:
    """Accumulates scans (with known poses) into an occupancy grid."""

    def __init__(self, extent=(-6.0, 6.0, -6.0, 6.0), resolution: float = 0.05,
                 lidar: LidarConfig | None = None):
        self.lidar = lidar or LidarConfig()
        xmin, xmax, ymin, ymax = extent
        self.resolution = float(resolution)
        self.origin = (float(xmin), float(ymin))
        self.gw = int(np.ceil((xmax - xmin) / resolution))
        self.gh = int(np.ceil((ymax - ymin) / resolution))
        self.logodds = jnp.zeros((self.gh, self.gw), jnp.float32)

    def add_scan(self, ranges, angles, pose) -> None:
        self.logodds = _scan_update(
            self.logodds, jnp.asarray(ranges), jnp.asarray(angles),
            jnp.asarray(pose, dtype=jnp.float32),
            self.origin[0], self.origin[1], self.resolution,
            float(self.lidar.range_max), self.gh, self.gw)

    def add_trajectory(self, ranges_batch, angles, poses) -> None:
        """Whole trajectory in one dispatch (N scans stacked)."""
        res, rmax = self.resolution, float(self.lidar.range_max)
        ox, oy = self.origin
        gh, gw = self.gh, self.gw

        @jax.jit
        def run(lo, rb, ps):
            def step(carry, frame):
                r, p = frame
                return _scan_update(carry, r, jnp.asarray(angles), p,
                                    ox, oy, res, rmax, gh, gw), None
            out, _ = jax.lax.scan(step, lo, (rb, ps))
            return out

        self.logodds = run(self.logodds,
                           jnp.asarray(ranges_batch),
                           jnp.asarray(poses, dtype=jnp.float32))

    def to_grid(self) -> OccupancyGrid2D:
        p = 1.0 - 1.0 / (1.0 + jnp.exp(self.logodds))
        data = jnp.where(p > OCC_THRESH, 100,
                         jnp.where(p < FREE_THRESH, 0, -1)).astype(jnp.int8)
        return OccupancyGrid2D(data, self.resolution, self.origin)

    def save(self, pgm_path: str, yaml_path: str) -> None:
        from otslam_tpu.core import io as tio
        import os
        grid = self.to_grid()
        tio.write_pgm(pgm_path, grid.to_pgm())
        tio.write_map_yaml(yaml_path, os.path.basename(pgm_path),
                           self.resolution,
                           (self.origin[0], self.origin[1], 0.0))
