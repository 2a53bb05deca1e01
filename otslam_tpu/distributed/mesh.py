"""Device-mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """Build a Mesh over the available devices.

    shape=None uses all devices on a 1-D 'data' axis. For 2-D meshes pass
    e.g. shape=(4, 2), axis_names=("data", "model") — the data axis shards
    frames (embarrassingly parallel TSDF partial sums, one all-reduce to
    merge), the model axis shards the voxel grid (slab decomposition, no
    communication at integrate time).
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devices)}")
    if len(shape) != len(axis_names):
        raise ValueError("shape and axis_names rank mismatch")
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))
