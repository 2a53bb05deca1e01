"""Voxel-grid downsampling (Open3D ``voxel_down_sample`` semantics).

Reference usage: check_one_frame.py:28 (0.01 m). Open3D buckets points by
``floor((p - min_bound) / voxel)`` and emits the centroid (and mean color) of
each occupied voxel.

Design: no hash maps. Points are keyed by voxel index, sorted by
key (one XLA sort), segment boundaries found by
key inequality, and per-voxel means computed with ``segment_sum`` at static
capacity N (the input size). Output is padded: (N, 3) + mask of the unique
voxels. Fully jittable, deterministic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=())
def voxel_downsample(points: jnp.ndarray, voxel_size: jnp.ndarray | float,
                     mask: jnp.ndarray | None = None,
                     colors: jnp.ndarray | None = None):
    """Downsample a padded point cloud onto a voxel grid.

    Args:
      points: (N, 3) float32.
      voxel_size: scalar voxel edge.
      mask: (N,) bool validity; None = all valid.
      colors: optional (N, 3) float32 averaged alongside.

    Returns:
      (ds_points, ds_colors_or_None, ds_mask): (N, 3), (N, 3)?, (N,) padded.
    """
    n = points.shape[0]
    if mask is None:
        mask = jnp.ones(n, dtype=bool)
    mask = mask & jnp.all(jnp.isfinite(points), axis=-1)

    # min bound over valid points only
    big = jnp.float32(3.0e38)
    pts_for_min = jnp.where(mask[:, None], points, big)
    min_bound = jnp.min(pts_for_min, axis=0)

    idx3 = jnp.floor((points - min_bound) / voxel_size).astype(jnp.int32)
    # Two-part sort key (int64 may be unavailable without jax_enable_x64):
    # after the min-bound shift all indices are >= 0; grids up to 65536 cells
    # per axis (655 m at 1 cm) pack losslessly into (kx, ky*2^16 + kz).
    k_hi = idx3[:, 0]
    k_lo = idx3[:, 1] * (1 << 16) + idx3[:, 2]
    imax = jnp.iinfo(jnp.int32).max
    k_hi = jnp.where(mask, k_hi, imax)  # invalid sorts last
    k_lo = jnp.where(mask, k_lo, imax)

    order = jnp.lexsort((k_lo, k_hi))  # primary key = k_hi
    hi_s = k_hi[order]
    lo_s = k_lo[order]
    pts_s = points[order]
    mask_s = mask[order]

    head = jnp.concatenate(
        [jnp.ones(1, dtype=bool),
         (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])])
    head = head & mask_s
    seg = jnp.cumsum(head.astype(jnp.int32)) - 1  # segment id per point
    seg = jnp.where(mask_s, seg, n - 1)           # park invalid in last bucket

    ones = mask_s.astype(jnp.float32)
    counts = jax.ops.segment_sum(ones, seg, num_segments=n)
    sums = jax.ops.segment_sum(pts_s * ones[:, None], seg, num_segments=n)
    denom = jnp.maximum(counts, 1.0)[:, None]
    ds_pts = sums / denom

    n_unique = jnp.sum(head.astype(jnp.int32))
    out_mask = jnp.arange(n) < n_unique

    ds_cols = None
    if colors is not None:
        cols_s = colors[order]
        csums = jax.ops.segment_sum(cols_s * ones[:, None], seg, num_segments=n)
        ds_cols = csums / denom
    return ds_pts, ds_cols, out_mask
