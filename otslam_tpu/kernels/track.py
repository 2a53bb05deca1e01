"""Direct frame-to-model tracking against the TSDF (projective alignment).

KinectFusion-style camera tracking, device-shaped: instead of extracting the
model surface and running NN-correspondence ICP (two large dispatches per
iteration), each Gauss-Newton iteration trilinearly samples the signed
distance field AT the frame's transformed points and steps the pose down the
SDF's own gradient:

    minimize_T   sum_p  w_p * ( sdf( T . p ) )^2

The residual IS the (approximate) point-to-surface distance and the SDF
gradient IS the surface normal, so no correspondence search exists at all —
the whole tracker is one jitted dispatch of ~10 fori_loop iterations over a
few thousand points (8 corner gathers each; ~100k gathered elements).

The reference has no pose refinement (it trusts TF: scanner_node.cpp:227-236);
this is the "beat the reference" capability from SURVEY §7 / BASELINE
config 3, built on the same block volume the fusion kernels maintain.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from otslam_tpu.kernels.pose_graph import exp_se3
from otslam_tpu.kernels.tsdf_block import BLOCK, BLOCK_VOXELS, BlockTSDFVolume


def sample_tsdf_trilinear(vol: BlockTSDFVolume, pts: jnp.ndarray):
    """Trilinear TSDF sample + analytic gradient at world points.

    pts: (P, 3) world coordinates. Returns (sdf (P,), grad (P, 3), valid (P,)):
    sdf in normalized units (stored tsdf, [-1, 1]); grad is d(sdf)/d(world);
    valid requires all 8 interpolation corners observed (weight > 0) and
    in-bounds. Corner lookup crosses block boundaries via flat
    (block_row, voxel) indexing into the (NB+1, 512) block-major arrays.
    """
    bx, by, bz = vol.grid_blocks
    nb = bx * by * bz
    dims = (bx * BLOCK, by * BLOCK, bz * BLOCK)
    origin = jnp.asarray(vol.origin, jnp.float32)

    # continuous voxel-center coordinates
    g = (pts - origin) / vol.voxel_size - 0.5            # (P, 3)
    i0 = jnp.floor(g).astype(jnp.int32)
    f = g - i0.astype(jnp.float32)                        # (P, 3) in [0, 1)

    tsdf_flat = vol.tsdf[:nb].reshape(-1)
    w_flat = vol.weight[:nb].reshape(-1)

    def corner(dx, dy, dz):
        v = i0 + jnp.array([dx, dy, dz], jnp.int32)       # (P, 3)
        inb = ((v[:, 0] >= 0) & (v[:, 0] < dims[0])
               & (v[:, 1] >= 0) & (v[:, 1] < dims[1])
               & (v[:, 2] >= 0) & (v[:, 2] < dims[2]))
        vc = jnp.clip(v, 0, jnp.array(dims, jnp.int32) - 1)
        bid = ((vc[:, 0] // BLOCK) * (by * bz)
               + (vc[:, 1] // BLOCK) * bz + (vc[:, 2] // BLOCK))
        loc = ((vc[:, 0] % BLOCK) * (BLOCK * BLOCK)
               + (vc[:, 1] % BLOCK) * BLOCK + (vc[:, 2] % BLOCK))
        flat = bid * BLOCK_VOXELS + loc
        s = jnp.take(tsdf_flat, flat)
        w = jnp.take(w_flat, flat)
        return s, (w > 0) & inb

    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    sdf = jnp.zeros(pts.shape[0], jnp.float32)
    gx = jnp.zeros_like(sdf)
    gy = jnp.zeros_like(sdf)
    gz = jnp.zeros_like(sdf)
    valid = jnp.ones(pts.shape[0], bool)
    for dx in (0, 1):
        wx_ = fx if dx else 1.0 - fx
        dwx = 1.0 if dx else -1.0
        for dy in (0, 1):
            wy_ = fy if dy else 1.0 - fy
            dwy = 1.0 if dy else -1.0
            for dz in (0, 1):
                wz_ = fz if dz else 1.0 - fz
                dwz = 1.0 if dz else -1.0
                s, ok = corner(dx, dy, dz)
                valid &= ok
                sdf = sdf + s * (wx_ * wy_ * wz_)
                gx = gx + s * (dwx * wy_ * wz_)
                gy = gy + s * (wx_ * dwy * wz_)
                gz = gz + s * (wx_ * wy_ * dwz)
    grad = jnp.stack([gx, gy, gz], axis=-1) / vol.voxel_size
    return sdf, grad, valid


class TrackResult(NamedTuple):
    transformation: jnp.ndarray   # (4, 4) camera -> world
    rmse: jnp.ndarray             # final inlier |sdf| RMSE, meters
    inlier_fraction: jnp.ndarray  # valid & in-band fraction of frame points


@partial(jax.jit, static_argnames=("max_iterations",))
def track_frame_to_tsdf(vol: BlockTSDFVolume, pts_cam: jnp.ndarray,
                        pts_valid: jnp.ndarray, T_init: jnp.ndarray,
                        max_iterations: int = 12,
                        damping: float = 1e-3,
                        max_step_rot: float = 0.1,
                        max_step_tr: float = 0.1) -> TrackResult:
    """Align a frame's camera-space points onto the TSDF zero set.

    pts_cam: (P, 3) camera-frame points (padded; pts_valid masks), T_init:
    (4, 4) camera->world prior. Each iteration samples sdf+gradient at the
    transformed points, solves the damped 6x6 normal equations of the
    level-set distance r = sdf / |grad sdf| with J = [q x n | n] (world-frame
    left perturbation), and updates T <- exp_se3(step) @ T.

    Points sampling the far side of the truncation band (sdf <= -0.95) or
    unobserved space are dropped per-iteration; a Huber weight (delta = one
    voxel) tames outliers at occlusion boundaries.
    """
    trunc = vol.sdf_trunc
    huber = vol.voxel_size

    def body(_, T):
        q = pts_cam @ T[:3, :3].T + T[:3, 3]
        s, g, ok = sample_tsdf_trilinear(vol, q)
        gn = jnp.linalg.norm(g, axis=-1)
        n = g / jnp.maximum(gn, 1e-9)[:, None]
        # level-set distance estimate: the fused field is a PROJECTIVE
        # distance whose slope exceeds 1 (each frame writes d - pz along its
        # own ray; grazing views inflate d(sdf)/d(world) by 1/cos). s/|g| is
        # the first-order true distance along the gradient — using s*trunc
        # directly overshoots by that slope factor and stalls convergence.
        r = s / jnp.maximum(gn, 1e-9)
        w = (pts_valid & ok & (s > -0.95) & (s < 0.95)
             & (gn > 0.1 / trunc)).astype(jnp.float32)
        w = w * jnp.minimum(1.0, huber / jnp.maximum(jnp.abs(r), 1e-9))
        c = jnp.cross(q, n)
        J = jnp.concatenate([c, n], axis=-1)              # (P, 6)
        hi = jax.lax.Precision.HIGHEST
        Jw = J * w[:, None]
        A = jax.lax.dot_general(Jw, J, (((0,), (0,)), ((), ())), precision=hi)
        A = A + (damping * jnp.trace(A) / 6.0 + 1e-9) * jnp.eye(6)
        b = -jax.lax.dot_general(Jw, r, (((0,), (0,)), ((), ())), precision=hi)
        x = jnp.linalg.solve(A, b)
        rot_n = jnp.linalg.norm(x[:3])
        tr_n = jnp.linalg.norm(x[3:])
        scale = jnp.minimum(1.0, jnp.minimum(
            max_step_rot / jnp.maximum(rot_n, 1e-9),
            max_step_tr / jnp.maximum(tr_n, 1e-9)))
        return (exp_se3(x * scale) @ T).astype(jnp.float32)

    T = jax.lax.fori_loop(0, max_iterations, body, T_init.astype(jnp.float32))

    q = pts_cam @ T[:3, :3].T + T[:3, 3]
    s, g, ok = sample_tsdf_trilinear(vol, q)
    dist = s / jnp.maximum(jnp.linalg.norm(g, axis=-1), 1e-9)
    inband = pts_valid & ok & (jnp.abs(s) < 0.95)
    nin = jnp.maximum(jnp.sum(inband), 1)
    rmse = jnp.sqrt(jnp.sum(jnp.where(inband, dist * dist, 0.0)) / nin)
    frac = jnp.sum(inband) / jnp.maximum(jnp.sum(pts_valid), 1)
    return TrackResult(T, rmse, frac)
