"""1-D LiDAR gap clustering, PCA linearity, and wall/object classification.

Behavioral contracts:
* Gap clustering: consecutive points further apart than ``gap_threshold``
  start a new cluster (lidar_cluster_publisher.cpp:151-183,
  3_multi_object_goal_selector.cpp:178-190). The scan's wrap-around pair
  (last beam -> first beam) merges the first and last clusters
  (lidar_cluster_publisher.cpp:186-199).
* Per cluster: point count, bbox, centroid, bbox-diagonal "length"
  (lidar_cluster_publisher.cpp:113-127) and PCA linearity
  lambda_min / (lambda_max + 1e-6) from the 2x2 covariance with n-1
  normalization (lidar_cluster_publisher.cpp:129-148).
* Classification (lidar_cluster_publisher.cpp:243-256): WALL if
  linearity < wal_lin_max and length > wal_len_min and n > wal_nmp_min;
  else OBJECT if length < obj_len_max and n > obj_nmp_min; else UNKNOWN.

Shape: segment ids from a cumsum over gap flags; every per-cluster
statistic is a ``segment_sum`` into a static ``max_clusters`` capacity; the
2x2 eigenvalues are closed-form. No per-point host loops.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from otslam_tpu.config import ClusterConfig

WALL, OBJECT, UNKNOWN, INVALID = 0, 1, 2, 3


class ClusterStats(NamedTuple):
    count: jnp.ndarray      # (C,) i32
    min_xy: jnp.ndarray     # (C, 2)
    max_xy: jnp.ndarray     # (C, 2)
    centroid: jnp.ndarray   # (C, 2) mean of member points
    length: jnp.ndarray     # (C,) bbox diagonal
    linearity: jnp.ndarray  # (C,) PCA ratio (near 0 = line)
    valid: jnp.ndarray      # (C,) bool
    labels: jnp.ndarray     # (N,) per-point cluster id (C = invalid)
    classes: jnp.ndarray    # (C,) WALL / OBJECT / UNKNOWN / INVALID


@partial(jax.jit, static_argnames=("max_clusters", "merge_wraparound"))
def cluster_scan_points(points: jnp.ndarray, mask: jnp.ndarray,
                        gap_threshold: float, max_clusters: int = 64,
                        merge_wraparound: bool = True) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Assign consecutive-gap cluster labels.

    points (N,2) in scan order; mask (N,) valid beams. Invalid beams break
    adjacency exactly like the reference (points outside range are simply
    absent from its vector). Returns (labels (N,) i32 in [0, C], num_clusters)
    where label == max_clusters marks invalid points.
    """
    n = points.shape[0]
    # previous *valid* point for each valid point: do a masked shift — the
    # reference's vector simply skips invalid beams, so adjacency is between
    # consecutive valid points.
    idx = jnp.arange(n)
    prev_valid_idx = jnp.maximum(jax.lax.cummax(jnp.where(mask, idx, -1)[:-1]),
                                 -1)
    prev_idx_full = jnp.concatenate([jnp.array([-1]), prev_valid_idx])
    has_prev = mask & (prev_idx_full >= 0)
    prev_pts = jnp.take(points, jnp.clip(prev_idx_full, 0, n - 1), axis=0)
    gap = jnp.where(
        has_prev,
        jnp.hypot(points[:, 0] - prev_pts[:, 0],
                  points[:, 1] - prev_pts[:, 1]) > gap_threshold,
        mask)  # the first valid point starts cluster 0 (gap flag then -1)
    seg = jnp.cumsum(gap.astype(jnp.int32)) - 1
    seg = jnp.where(mask, jnp.clip(seg, 0, max_clusters - 1), max_clusters)
    num = jnp.minimum(jnp.sum(gap.astype(jnp.int32)), max_clusters)

    if merge_wraparound:
        # wrap-around: if the last valid point is close to the first valid
        # point, the last cluster becomes cluster 0
        first_i = jnp.argmax(mask)
        last_i = n - 1 - jnp.argmax(mask[::-1])
        close = (jnp.sum(mask) > 1) & (
            jnp.hypot(points[first_i, 0] - points[last_i, 0],
                      points[first_i, 1] - points[last_i, 1]) <= gap_threshold)
        last_label = seg[last_i]
        do_merge = close & (last_label > 0)
        seg = jnp.where(do_merge & (seg == last_label), 0, seg)
        num = jnp.where(do_merge, num - 1, num)
    return seg, num


def cluster_points_host(pts, gap_threshold: float, max_clusters: int = 64):
    """Host numpy mirror of ``cluster_scan_points`` for all-valid points
    without wrap-around merging — the control plane's case
    (3_multi_object_goal_selector.cpp:178-190 clusters tiny per-tick change
    clouds). Identical labels/num to the kernel (parity-tested); runs in
    microseconds with no device dispatch — the tracker runs twice per
    perception tick on a handful of points.
    """
    import numpy as _np

    pts = _np.asarray(pts, _np.float32).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return _np.zeros(0, _np.int32), 0
    d = _np.hypot(pts[1:, 0] - pts[:-1, 0], pts[1:, 1] - pts[:-1, 1])
    # compare in f32 like the device kernel (jax weak-types the Python
    # float down to f32; a float64 compare here could flip the ulp
    # boundary case and break the documented label parity)
    gap = _np.concatenate([[True], d > _np.float32(gap_threshold)])
    labels = _np.minimum(_np.cumsum(gap) - 1,
                         max_clusters - 1).astype(_np.int32)
    return labels, min(int(gap.sum()), max_clusters)


def cluster_points_spatial_host(pts, distance_threshold: float,
                                max_clusters: int = 64):
    """Order-independent single-linkage clustering: points within
    ``distance_threshold`` of each other (transitively) share a label.

    The reference's goal selector gap-clusters the change-cell cloud in
    *received order* (3_multi_object_goal_selector.cpp:178-190), but that
    cloud is an unordered_map dump (diff_node.cpp:188-204) — with cells
    from two distant objects interleaved (our evidence-grid compaction
    emits row-major order), consecutive-pair clustering shatters each
    object into per-row fragments that the wall-thickness filter then
    rejects. Single-linkage implements the selector's documented intent
    ("merge change clouds closer than the threshold into one object")
    independent of cloud order; on scan-ordered input with separated
    objects it produces the same partition as ``cluster_points_host``.

    Labels are renumbered by first occurrence (matching the sequential
    labeling on well-ordered input) and clamped to ``max_clusters`` like
    the kernel. Host-side: the tracker clusters <= a few hundred cells.
    """
    import numpy as _np

    pts = _np.asarray(pts, _np.float32).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return _np.zeros(0, _np.int32), 0
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    adj = d2 <= _np.float32(distance_threshold) ** 2      # includes self
    # connected components by iterative min-label propagation
    labels = _np.arange(n)
    while True:
        nxt = _np.where(adj, labels[None, :], n).min(axis=1)
        if _np.array_equal(nxt, labels):
            break
        labels = nxt
    # renumber by first occurrence, clamp overflow like the kernel
    _, first_idx, inv = _np.unique(labels, return_index=True,
                                   return_inverse=True)
    order = _np.argsort(_np.argsort(first_idx))
    labels = _np.minimum(order[inv], max_clusters - 1).astype(_np.int32)
    return labels, min(len(first_idx), max_clusters)


@partial(jax.jit, static_argnames=("cfg",))
def analyze_clusters(points: jnp.ndarray, labels: jnp.ndarray,
                     cfg: ClusterConfig) -> ClusterStats:
    """Per-cluster statistics + classification at static capacity."""
    C = cfg.max_clusters
    n = points.shape[0]
    valid_pt = labels < C
    w = valid_pt.astype(jnp.float32)
    seg = jnp.where(valid_pt, labels, C)

    ns = C + 1
    count = jax.ops.segment_sum(w, seg, num_segments=ns)
    sx = jax.ops.segment_sum(points[:, 0] * w, seg, num_segments=ns)
    sy = jax.ops.segment_sum(points[:, 1] * w, seg, num_segments=ns)
    sxx = jax.ops.segment_sum(points[:, 0] ** 2 * w, seg, num_segments=ns)
    syy = jax.ops.segment_sum(points[:, 1] ** 2 * w, seg, num_segments=ns)
    sxy = jax.ops.segment_sum(points[:, 0] * points[:, 1] * w, seg,
                              num_segments=ns)
    big = jnp.float32(3.0e38)
    minx = -jax.ops.segment_max(jnp.where(valid_pt, -points[:, 0], -big), seg,
                                num_segments=ns)
    miny = -jax.ops.segment_max(jnp.where(valid_pt, -points[:, 1], -big), seg,
                                num_segments=ns)
    maxx = jax.ops.segment_max(jnp.where(valid_pt, points[:, 0], -big), seg,
                               num_segments=ns)
    maxy = jax.ops.segment_max(jnp.where(valid_pt, points[:, 1], -big), seg,
                               num_segments=ns)

    count = count[:C]
    cnt_safe = jnp.maximum(count, 1.0)
    cx = sx[:C] / cnt_safe
    cy = sy[:C] / cnt_safe
    # covariance with n-1 divisor (Eigen code divides by size()-1)
    nm1 = jnp.maximum(count - 1.0, 1.0)
    cov_xx = (sxx[:C] - count * cx * cx) / nm1
    cov_yy = (syy[:C] - count * cy * cy) / nm1
    cov_xy = (sxy[:C] - count * cx * cy) / nm1
    tr2 = (cov_xx + cov_yy) / 2.0
    det_term = jnp.sqrt(jnp.maximum(((cov_xx - cov_yy) / 2.0) ** 2
                                    + cov_xy ** 2, 0.0))
    lam_min = tr2 - det_term
    lam_max = tr2 + det_term
    linearity = jnp.where(
        (count >= 3) & (lam_min + lam_max >= 1e-6),
        lam_min / (lam_max + 1e-6), 0.0)

    dx = maxx[:C] - minx[:C]
    dy = maxy[:C] - miny[:C]
    length = jnp.sqrt(dx * dx + dy * dy)
    valid = count > 0

    is_wall = ((linearity < cfg.wal_lin_max) & (length > cfg.wal_len_min)
               & (count > cfg.wal_nmp_min))
    is_obj = (length < cfg.obj_len_max) & (count > cfg.obj_nmp_min)
    classes = jnp.where(~valid, INVALID,
                        jnp.where(is_wall, WALL,
                                  jnp.where(is_obj, OBJECT, UNKNOWN)))

    return ClusterStats(
        count=count.astype(jnp.int32),
        min_xy=jnp.stack([minx[:C], miny[:C]], axis=-1),
        max_xy=jnp.stack([maxx[:C], maxy[:C]], axis=-1),
        centroid=jnp.stack([cx, cy], axis=-1),
        length=jnp.where(valid, length, 0.0),
        linearity=linearity,
        valid=valid,
        labels=labels,
        classes=classes.astype(jnp.int32),
    )


def scan_to_points(ranges: jnp.ndarray, angles: jnp.ndarray,
                   range_max: float, max_range_ratio: float = 0.9):
    """Polar scan -> (N,2) points + validity (lidar_cluster_publisher
    uses returns below range_max * max_range_ratio)."""
    valid = jnp.isfinite(ranges) & (ranges > 0) & (
        ranges < range_max * max_range_ratio)
    x = ranges * jnp.cos(angles)
    y = ranges * jnp.sin(angles)
    pts = jnp.stack([jnp.where(valid, x, 0.0), jnp.where(valid, y, 0.0)],
                    axis=-1)
    return pts, valid
