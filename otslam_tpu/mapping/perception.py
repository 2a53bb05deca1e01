"""Device-resident batched perception: K ticks per dispatch.

The reference's online loop runs at 5 Hz with each stage a separate ROS
node (virtual_scan_node.cpp:258-287 ray-cast, diff_node.cpp:102-185 diff +
evidence). This module fuses K whole perception ticks (ray-cast -> windowed
scan diff -> dwell/decay evidence update -> confident-cell compaction) into
ONE jitted lax.scan, so a mission pays one dispatch and one fetch per K
ticks. Per-tick confident cells come back compacted to a static capacity
(segmented top_k compaction), so the host-side tracker consumes exact
per-tick detections from a single fetch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from otslam_tpu.config import ChangeDetectConfig
from otslam_tpu.kernels.marching import _compact_ids_hier
from otslam_tpu.kernels.raycast import raycast_grid
from otslam_tpu.mapping.change_detect import _step as _change_step


class PerceptionBatch(NamedTuple):
    new_grid: jnp.ndarray       # (GH, GW) updated added-evidence dwell grid
    gone_grid: jnp.ndarray      # (GH, GW) updated removed-evidence grid
    virtual: jnp.ndarray        # (K, B) per-tick virtual scans
    added_pts: jnp.ndarray      # (K, P, 2) compacted confident added cells
    added_cnt: jnp.ndarray      # (K,) valid counts
    removed_pts: jnp.ndarray    # (K, P, 2)
    removed_cnt: jnp.ndarray    # (K,)


def _compact_confident(dwell, resolution: float, time_threshold: float,
                       max_points: int):
    """Confident cell centers compacted to a static capacity so K ticks of
    detections move host-ward in one small fetch. Cell-center coordinates
    follow evidence_points (the single source of the diff_node.cpp:213-214
    convention: center = signed key * res + res/2, tested for parity).

    Compaction is the segmented top_k of kernels/marching.py: instead of a
    stable argsort over the full (GH*GW,) grid, the hierarchical top_k
    touches the full grid once and sorts only ~max_points segments."""
    GH, GW = dwell.shape
    conf = (dwell > time_threshold).reshape(-1)
    n = GH * GW
    ids = _compact_ids_hier(conf, max_points)       # ascending, padded n
    cnt = jnp.minimum(jnp.sum(conf, dtype=jnp.int32), max_points)
    idc = jnp.minimum(ids, n - 1)
    ky = idc // GW - GH // 2
    kx = idc % GW - GW // 2
    out = jnp.stack([kx.astype(jnp.float32) * resolution + resolution / 2.0,
                     ky.astype(jnp.float32) * resolution + resolution / 2.0],
                    axis=-1)
    mask = (jnp.arange(max_points) < cnt)[:, None]
    return jnp.where(mask, out, 0.0), cnt


@partial(jax.jit, static_argnames=("resolution", "origin_x", "origin_y",
                                   "cfg", "range_max", "max_points"))
def perception_ticks(grid_data: jnp.ndarray, resolution: float,
                     origin_x: float, origin_y: float,
                     new_grid: jnp.ndarray, gone_grid: jnp.ndarray,
                     reals: jnp.ndarray, poses: jnp.ndarray,
                     dts: jnp.ndarray, angles: jnp.ndarray,
                     cfg: ChangeDetectConfig, range_max: float,
                     max_points: int = 256) -> PerceptionBatch:
    """Run K full perception ticks in one dispatch.

    grid_data: (H, W) int8 saved occupancy map; reals: (K, B) real scans;
    poses: (K, 3) believed (x, y, yaw) per tick; dts: (K,) evidence time
    steps; angles: (B,) beam angles. Behavior per tick is identical to
    VirtualScanner.scan + ChangeDetector.on_scan (tested for parity).
    """

    def tick(carry, inp):
        ng, gg = carry
        real, pose, dt = inp
        virt = raycast_grid(grid_data, resolution, origin_x, origin_y,
                            pose[0], pose[1], pose[2], angles, range_max)
        ng, gg = _change_step(ng, gg, real, virt, angles, pose, dt,
                              cfg, range_max)
        apts, acnt = _compact_confident(ng, cfg.grid_resolution,
                                        cfg.time_threshold, max_points)
        rpts, rcnt = _compact_confident(gg, cfg.grid_resolution,
                                        cfg.time_threshold, max_points)
        return (ng, gg), (virt, apts, acnt, rpts, rcnt)

    (ng, gg), (virt, apts, acnt, rpts, rcnt) = jax.lax.scan(
        tick, (new_grid, gone_grid), (reals, poses, dts))
    return PerceptionBatch(ng, gg, virt, apts, acnt, rpts, rcnt)
