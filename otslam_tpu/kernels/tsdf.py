"""Dense TSDF fusion (the semantic reference of the block-sparse path).

Reproduces the behavior of Open3D's ``ScalableTSDFVolume(voxel_length=0.01,
sdf_trunc=0.04, RGB8)`` + ``integrate`` + ``extract_triangle_mesh`` pipeline
used at /root/reference/3d_model/reconstruct_rgbd.py:79-118, re-designed for
an accelerator rather than translated:

* The volume is a fixed-extent **dense voxel grid in device memory** (objects
  are at most a few meters across; 256^3 at 1 cm is a 2.56 m cube), not a
  spatially-hashed block volume. Dense grids map onto XLA as fused
  broadcast/elementwise/gather ops with static shapes.
* Integration is **voxel projection** (gather), not point splatting (scatter):
  every voxel center is projected into the frame, samples the depth image at
  its pixel, and updates a running weighted mean. One frame = one fused
  elementwise kernel over the whole grid + one image gather. No atomics, no
  ordering — integration is commutative.
* Multi-frame fusion is a ``lax.scan`` of that update (single compiled step,
  double-buffered by XLA), and the commutativity gives the multi-chip path:
  frames shard over a device mesh, each chip computes partial weighted sums,
  and one ``psum`` merges them (see otslam_tpu/distributed/).
* Surface extraction is TSDF zero-crossing interpolation along the three grid
  axes (downstream consumers only ever use sampled point clouds —
  reconstruct_rgbd_filter.py:123 samples the mesh to 100k points immediately).
  Triangle meshes via marching cubes live in kernels/marching_cubes.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from otslam_tpu.config import TSDFConfig
from otslam_tpu.core.camera import PinholeIntrinsics


@jax.tree_util.register_pytree_node_class
@dataclass
class TSDFVolume:
    """tsdf/weight: (X, Y, Z) f32; color: (3, X, Y, Z) f32 running-mean RGB [0,255]."""

    tsdf: jnp.ndarray
    weight: jnp.ndarray
    color: jnp.ndarray
    origin: Tuple[float, float, float]
    voxel_size: float
    sdf_trunc: float

    def tree_flatten(self):
        return (self.tsdf, self.weight, self.color), (
            self.origin, self.voxel_size, self.sdf_trunc)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux[0], aux[1], aux[2])

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.tsdf.shape)  # type: ignore[return-value]


def make_volume(cfg: TSDFConfig, dtype=jnp.float32) -> TSDFVolume:
    X, Y, Z = cfg.dims
    return TSDFVolume(
        tsdf=jnp.zeros((X, Y, Z), dtype),
        weight=jnp.zeros((X, Y, Z), dtype),
        color=jnp.zeros((3, X, Y, Z), dtype),
        origin=tuple(float(o) for o in cfg.origin),
        voxel_size=float(cfg.voxel_size),
        sdf_trunc=float(cfg.sdf_trunc),
    )


def _axis_coords(n: int, origin: float, voxel: float, dtype) -> jnp.ndarray:
    """Voxel *center* world coordinates along one axis."""
    return origin + (jnp.arange(n, dtype=dtype) + 0.5) * voxel


def _observe_frame(vol: TSDFVolume, depth: jnp.ndarray, color: jnp.ndarray,
                   extrinsic: jnp.ndarray, intr: PinholeIntrinsics):
    """Project every voxel into one frame.

    Args:
      depth: (H, W) f32 meters, 0 = invalid (already truncated/filtered).
      color: (H, W, 3) f32 RGB in [0, 255].
      extrinsic: (4, 4) world->camera.

    Returns (tsdf_obs, w_obs, col_obs): per-voxel observation and 0/1 weight.
    """
    X, Y, Z = vol.dims
    dt = vol.tsdf.dtype
    f32 = jnp.float32
    xs = _axis_coords(X, vol.origin[0], vol.voxel_size, f32)[:, None, None]
    ys = _axis_coords(Y, vol.origin[1], vol.voxel_size, f32)[None, :, None]
    zs = _axis_coords(Z, vol.origin[2], vol.voxel_size, f32)[None, None, :]

    E = extrinsic.astype(f32)
    # camera coords of every voxel center — three fused broadcast FMAs each
    px = E[0, 0] * xs + E[0, 1] * ys + E[0, 2] * zs + E[0, 3]
    py = E[1, 0] * xs + E[1, 1] * ys + E[1, 2] * zs + E[1, 3]
    pz = E[2, 0] * xs + E[2, 1] * ys + E[2, 2] * zs + E[2, 3]

    in_front = pz > 0
    zsafe = jnp.where(in_front, pz, 1.0)
    u = jnp.round(intr.fx * px / zsafe + intr.cx).astype(jnp.int32)
    v = jnp.round(intr.fy * py / zsafe + intr.cy).astype(jnp.int32)
    inb = in_front & (u >= 0) & (u < intr.width) & (v >= 0) & (v < intr.height)

    flat = (jnp.clip(v, 0, intr.height - 1) * intr.width
            + jnp.clip(u, 0, intr.width - 1))
    d = jnp.take(depth.reshape(-1), flat)

    sdf = d - pz
    valid = inb & (d > 0) & (sdf >= -vol.sdf_trunc)
    tsdf_obs = jnp.minimum(sdf / vol.sdf_trunc, 1.0).astype(dt)
    w_obs = valid.astype(dt)
    tsdf_obs = jnp.where(valid, tsdf_obs, 0.0)

    cflat = color.reshape(-1, 3)
    col_obs = jnp.stack([jnp.take(cflat[:, c], flat) for c in range(3)]).astype(dt)
    col_obs = col_obs * w_obs[None]
    return tsdf_obs, w_obs, col_obs


@partial(jax.jit, static_argnames=("intr",), donate_argnums=(0,))
def integrate_frame(vol: TSDFVolume, depth: jnp.ndarray, color: jnp.ndarray,
                    extrinsic: jnp.ndarray, intr: PinholeIntrinsics) -> TSDFVolume:
    """Fuse one frame into the volume (running weighted mean, weight 1/frame)."""
    tsdf_obs, w_obs, col_obs = _observe_frame(vol, depth, color, extrinsic, intr)
    w_new = vol.weight + w_obs
    denom = jnp.maximum(w_new, 1.0)
    tsdf = (vol.tsdf * vol.weight + tsdf_obs * w_obs) / denom
    color_new = (vol.color * vol.weight[None] + col_obs) / denom[None]
    return TSDFVolume(tsdf, w_new, color_new, vol.origin, vol.voxel_size,
                      vol.sdf_trunc)


@partial(jax.jit, static_argnames=("intr",), donate_argnums=(0,))
def integrate_frames(vol: TSDFVolume, depths: jnp.ndarray, colors: jnp.ndarray,
                     extrinsics: jnp.ndarray, intr: PinholeIntrinsics) -> TSDFVolume:
    """Fuse a batch of frames: depths (N,H,W), colors (N,H,W,3), extr (N,4,4).

    lax.scan keeps a single compiled frame-update; XLA overlaps the gather of
    frame i+1 with the elementwise update of frame i.
    """
    def step(carry, frame):
        depth, color, extrinsic = frame
        return integrate_frame(carry, depth, color, extrinsic, intr), None

    vol, _ = jax.lax.scan(step, vol, (depths, colors, extrinsics))
    return vol


@partial(jax.jit, static_argnames=("intr", "cfg"))
def partial_integrate(depths: jnp.ndarray, colors: jnp.ndarray,
                      extrinsics: jnp.ndarray, intr: PinholeIntrinsics,
                      cfg: TSDFConfig):
    """Order-independent partial sums for a shard of frames.

    Returns (sum_tw, sum_w, sum_cw); partial shards combine by addition
    (psum over the data axis of a device mesh), then ``merge_partials``
    folds them into a volume. Matches integrate_frames bit-for-bit up to
    floating-point reassociation.
    """
    vol = make_volume(cfg)

    def step(carry, frame):
        sum_tw, sum_w, sum_cw = carry
        depth, color, extrinsic = frame
        tsdf_obs, w_obs, col_obs = _observe_frame(vol, depth, color, extrinsic, intr)
        return (sum_tw + tsdf_obs * w_obs, sum_w + w_obs, sum_cw + col_obs), None

    # the carry must inherit the inputs' device-varying type so this scan
    # works unchanged inside shard_map (zero * input = zeros, but varying)
    zvar = jnp.zeros((), depths.dtype) * depths.reshape(-1)[0]
    init = (jnp.zeros_like(vol.tsdf) + zvar, jnp.zeros_like(vol.weight) + zvar,
            jnp.zeros_like(vol.color) + zvar)
    (sum_tw, sum_w, sum_cw), _ = jax.lax.scan(step, init, (depths, colors, extrinsics))
    return sum_tw, sum_w, sum_cw


@partial(jax.jit, static_argnames=("cfg",))
def merge_partials(sum_tw: jnp.ndarray, sum_w: jnp.ndarray, sum_cw: jnp.ndarray,
                   cfg: TSDFConfig) -> TSDFVolume:
    denom = jnp.maximum(sum_w, 1.0)
    return TSDFVolume(sum_tw / denom, sum_w, sum_cw / denom[None],
                      tuple(float(o) for o in cfg.origin),
                      float(cfg.voxel_size), float(cfg.sdf_trunc))


@partial(jax.jit, static_argnames=("capacity", "with_normals"))
def extract_surface_points(vol: TSDFVolume, capacity: int = 1_000_000,
                           with_normals: bool = False):
    """TSDF zero-crossing surface point extraction.

    Finds sign changes of the TSDF between voxel neighbors along +x/+y/+z
    (both voxels observed), linearly interpolates the crossing, and returns a
    padded point set.

    Returns (points (C,3), colors (C,3) in [0,1], mask (C,), [normals (C,3)]).
    """
    X, Y, Z = vol.dims
    t = vol.tsdf
    w = vol.weight

    def axis_mask(axis: int):
        a = t
        b = jnp.roll(t, -1, axis=axis)
        wa, wb = w, jnp.roll(w, -1, axis=axis)
        m = (wa > 0) & (wb > 0) & (a * b < 0)
        # zero out the wrap-around boundary slice
        n = t.shape[axis]
        idx = jnp.arange(n) < n - 1
        shape = [1, 1, 1]
        shape[axis] = n
        return m & idx.reshape(shape)

    masks = jnp.stack([axis_mask(0), axis_mask(1), axis_mask(2)])  # (3,X,Y,Z)
    flat_mask = masks.reshape(-1)
    count = jnp.sum(flat_mask, dtype=jnp.int32)
    # stable argsort compaction: same ascending index order and 0-fill
    # semantics as nonzero(size=...)
    sel = jnp.argsort(~flat_mask, stable=True)[:capacity]
    if sel.shape[0] < capacity:  # capacity exceeds the grid's crossing slots
        sel = jnp.pad(sel, (0, capacity - sel.shape[0]))
    out_mask = jnp.arange(capacity) < count
    sel = jnp.where(out_mask, sel, 0)

    vol_sz = X * Y * Z
    axis = sel // vol_sz
    vox = sel % vol_sz
    ix = vox // (Y * Z)
    iy = (vox // Z) % Y
    iz = vox % Z

    strides = jnp.array([Y * Z, Z, 1], dtype=sel.dtype)
    nbr = vox + strides[axis]
    nbr = jnp.clip(nbr, 0, vol_sz - 1)

    tf = t.reshape(-1)
    a = jnp.take(tf, vox)
    b = jnp.take(tf, nbr)
    denom = a - b
    frac = a / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    frac = jnp.clip(frac, 0.0, 1.0)

    base = jnp.stack([
        vol.origin[0] + (ix.astype(jnp.float32) + 0.5) * vol.voxel_size,
        vol.origin[1] + (iy.astype(jnp.float32) + 0.5) * vol.voxel_size,
        vol.origin[2] + (iz.astype(jnp.float32) + 0.5) * vol.voxel_size,
    ], axis=-1)
    offset = jax.nn.one_hot(axis, 3, dtype=jnp.float32) * (frac * vol.voxel_size)[:, None]
    points = base + offset

    cf = vol.color.reshape(3, -1)
    ca = jnp.stack([jnp.take(cf[c], vox) for c in range(3)], axis=-1)
    cb = jnp.stack([jnp.take(cf[c], nbr) for c in range(3)], axis=-1)
    colors = (ca * (1.0 - frac[:, None]) + cb * frac[:, None]) / 255.0
    colors = jnp.clip(colors, 0.0, 1.0)

    if not with_normals:
        return points, colors, out_mask

    # normals from the TSDF gradient (central differences at the base voxel)
    def grad_axis(axis_id: int, stride: int, n: int, idx):
        up = jnp.clip(vox + jnp.where(idx < n - 1, stride, 0), 0, vol_sz - 1)
        dn = jnp.clip(vox - jnp.where(idx > 0, stride, 0), 0, vol_sz - 1)
        return jnp.take(tf, up) - jnp.take(tf, dn)

    g = jnp.stack([
        grad_axis(0, Y * Z, X, ix),
        grad_axis(1, Z, Y, iy),
        grad_axis(2, 1, Z, iz),
    ], axis=-1)
    norm = jnp.linalg.norm(g, axis=-1, keepdims=True)
    normals = g / jnp.where(norm > 1e-12, norm, 1.0)
    return points, colors, out_mask, normals
