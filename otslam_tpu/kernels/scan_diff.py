"""Real-vs-virtual scan differencing (change detection core).

Behavioral contract from diff_node.cpp:102-158:

* NEW: a real return (finite, <= range_max) with no virtual return within
  ``distance_threshold`` (Euclidean, in the sensor frame) inside a +/- 20
  beam window.
* REMOVED: a virtual return (finite) with no real return within the window.

The C++ double loop (2 x 1440 beams x 40-beam window at 5 Hz) becomes a
stack of 2W statically-shifted beam arrays (padded contiguous slices
instead of ~6 x 57.6k gathered elements per tick) + one fused elementwise
reduction. Window
semantics mirror the reference exactly: j in [max(0, i-W), min(N, i+W))
— note the right edge excludes i+W itself.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _beam_xy(ranges, angles):
    return ranges * jnp.cos(angles), ranges * jnp.sin(angles)


@partial(jax.jit, static_argnames=("search_window",))
def scan_diff(real_ranges: jnp.ndarray, virtual_ranges: jnp.ndarray,
              angles: jnp.ndarray, range_max: float,
              distance_threshold: float = 0.5,
              search_window: int = 20):
    """Returns (new_mask, removed_mask), each (N,) bool over beams."""
    n = real_ranges.shape[0]
    W = search_window

    real_finite = jnp.isfinite(real_ranges) & (real_ranges <= range_max)
    virt_finite = jnp.isfinite(virtual_ranges)

    rx, ry = _beam_xy(real_ranges, angles)
    vx, vy = _beam_xy(virtual_ranges, angles)

    def shifted(q, fill):
        """(2W, N) where row o holds q[i + o - W] (fill beyond the edges):
        2W static padded slices — no gathers."""
        qp = jnp.pad(q, (W, W), constant_values=fill)
        return jnp.stack([qp[o:o + n] for o in range(2 * W)], axis=0)

    def near_in_window(px, py, qx, qy, qvalid):
        """For each beam i: any valid q within threshold of p_i in its
        window [i-W, i+W). Out-of-range window slots carry qvalid=False
        via the padding, reproducing the C++ edge clamping."""
        qxw = shifted(qx, 0.0)
        qyw = shifted(qy, 0.0)
        qvw = shifted(qvalid, False)
        d2 = (px[None, :] - qxw) ** 2 + (py[None, :] - qyw) ** 2
        hit = qvw & (d2 < distance_threshold * distance_threshold)
        return jnp.any(hit, axis=0)

    near_wall = near_in_window(rx, ry, vx, vy, virt_finite)
    new_mask = real_finite & ~near_wall

    wall_alive = near_in_window(vx, vy, rx, ry, real_finite)
    removed_mask = virt_finite & ~wall_alive
    return new_mask, removed_mask
