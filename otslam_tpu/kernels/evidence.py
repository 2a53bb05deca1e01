"""Temporal evidence grids with dwell accumulation and decay.

Behavioral contract from diff_node.cpp:169-185 (``updateGrid``): cells hit
this scan accumulate dt of dwell (saturating at 1.5 x time_threshold); cells
not hit decay by decay_rate x dt and are erased at <= 0. Cells with dwell
above time_threshold are emitted as points at the cell centers
(key * res + res/2), where key = trunc(coord / res) toward zero
(diff_node.cpp:126, C integer-cast semantics).

Shape: the C++ hash map becomes a dense (GH, GW) grid centered on
the world origin; hits are a boolean scatter, the dwell update is one fused
elementwise pass. Point extraction stays on device as a mask.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def world_to_key(x: jnp.ndarray, y: jnp.ndarray, resolution: float):
    """Truncating cell keys, matching the C++ ``(int)(p.x / res)`` cast."""
    kx = (x / resolution).astype(jnp.int32)   # f32->i32 cast truncates to zero
    ky = (y / resolution).astype(jnp.int32)
    return kx, ky


@partial(jax.jit, static_argnames=())
def scatter_hits(grid_shape_ref: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray,
                 mask: jnp.ndarray, resolution: float) -> jnp.ndarray:
    """Boolean hit grid from world points. grid_shape_ref: (GH, GW) array
    whose shape defines the grid; cell (0,0) of the world maps to the center."""
    GH, GW = grid_shape_ref.shape
    kx, ky = world_to_key(xs, ys, resolution)
    gx = kx + GW // 2
    gy = ky + GH // 2
    inb = mask & (gx >= 0) & (gx < GW) & (gy >= 0) & (gy < GH)
    flat = jnp.where(inb, gy * GW + gx, GH * GW)  # out-of-range -> dead slot
    hits = jnp.zeros(GH * GW + 1, bool).at[flat].set(True, mode="drop")
    return hits[:-1].reshape(GH, GW)


@partial(jax.jit, static_argnames=())
def update_evidence(dwell: jnp.ndarray, hits: jnp.ndarray, dt: jnp.ndarray,
                    time_threshold: float, decay_rate: float) -> jnp.ndarray:
    """One dwell/decay step (diff_node.cpp:169-185)."""
    grown = jnp.minimum(dwell + dt, 1.5 * time_threshold)
    decayed = jnp.maximum(dwell - decay_rate * dt, 0.0)
    return jnp.where(hits, grown, jnp.where(dwell > 0, decayed, 0.0))


@partial(jax.jit, static_argnames=())
def evidence_points(dwell: jnp.ndarray, resolution: float,
                    time_threshold: float):
    """Cell-center world coordinates of confident cells.

    Returns (points (GH*GW, 2), mask): points padded, compacted by mask.
    Center = key * res + res/2 with the signed key (diff_node.cpp:213-214).
    """
    GH, GW = dwell.shape
    conf = dwell > time_threshold
    ky = jnp.arange(GH)[:, None] - GH // 2
    kx = jnp.arange(GW)[None, :] - GW // 2
    cx = kx.astype(jnp.float32) * resolution + resolution / 2.0
    cy = ky.astype(jnp.float32) * resolution + resolution / 2.0
    pts = jnp.stack([jnp.broadcast_to(cx, (GH, GW)).reshape(-1),
                     jnp.broadcast_to(cy, (GH, GW)).reshape(-1)], axis=-1)
    return pts, conf.reshape(-1)
