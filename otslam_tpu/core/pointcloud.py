"""Fixed-capacity point cloud container.

Static-shape idiom: clouds are (capacity, 3) arrays plus a validity mask so every
kernel sees static shapes. `count` is the number of valid points; invalid rows
are padding. Host-side helpers compact to dense numpy for IO.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class PointCloud:
    """Padded point cloud: points (N,3) f32, colors (N,3) f32 in [0,1], mask (N,) bool."""

    points: jnp.ndarray
    colors: Optional[jnp.ndarray] = None
    mask: Optional[jnp.ndarray] = None

    def tree_flatten(self):
        return (self.points, self.colors, self.mask), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def valid_mask(self) -> jnp.ndarray:
        if self.mask is None:
            return jnp.ones(self.points.shape[0], dtype=bool)
        return self.mask

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid_mask())

    @classmethod
    def from_numpy(cls, points: np.ndarray, colors: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None) -> "PointCloud":
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        n = points.shape[0]
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        pts = np.zeros((cap, 3), dtype=np.float32)
        pts[:n] = points
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True
        cols = None
        if colors is not None:
            colors = np.asarray(colors, dtype=np.float32).reshape(-1, 3)
            cols = np.zeros((cap, 3), dtype=np.float32)
            cols[: colors.shape[0]] = colors
        return cls(jnp.asarray(pts), None if cols is None else jnp.asarray(cols),
                   jnp.asarray(mask))

    def to_numpy(self) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Compact to dense (n,3) arrays of the valid points (host transfer)."""
        mask = np.asarray(self.valid_mask())
        pts = np.asarray(self.points)[mask]
        cols = None if self.colors is None else np.asarray(self.colors)[mask]
        return pts, cols

    def transformed(self, T) -> "PointCloud":
        R = jnp.asarray(T[:3, :3], dtype=self.points.dtype)
        t = jnp.asarray(T[:3, 3], dtype=self.points.dtype)
        return PointCloud(self.points @ R.T + t, self.colors, self.mask)

    def painted(self, rgb) -> "PointCloud":
        col = jnp.broadcast_to(jnp.asarray(rgb, dtype=jnp.float32),
                               self.points.shape)
        return PointCloud(self.points, col, self.mask)


def concatenate(clouds: list[PointCloud]) -> PointCloud:
    """Concatenate padded clouds (capacity = sum of capacities)."""
    pts = jnp.concatenate([c.points for c in clouds], axis=0)
    masks = jnp.concatenate([c.valid_mask() for c in clouds], axis=0)
    if all(c.colors is not None for c in clouds):
        cols = jnp.concatenate([c.colors for c in clouds], axis=0)
    else:
        cols = None
    return PointCloud(pts, cols, masks)
