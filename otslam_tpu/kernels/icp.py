"""Iterative Closest Point registration.

Mirrors Open3D ``registration_icp`` with ``TransformationEstimationPointToPoint``
as used by the eval scripts (eval_table_chair.py:90-104: threshold 0.05,
identity init, max 2000 iterations), plus a point-to-plane variant for pose
refinement (BASELINE.json north_star).

Correspondences come from the tiled NN search (kernels/nn.py); each
iteration is one fused device step inside ``lax.while_loop`` with Open3D's
convergence criteria (relative fitness and relative RMSE below 1e-6). The
3x3 SVD / 6x6 solve at the end of each iteration is tiny and stays
on-device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from otslam_tpu.kernels.nn import auto_nn_window, nn_distance, \
    nn_distance_radius


class ICPResult(NamedTuple):
    transformation: jnp.ndarray  # (4, 4) src -> dst
    fitness: jnp.ndarray         # inlier fraction
    inlier_rmse: jnp.ndarray
    iterations: jnp.ndarray


def _umeyama_rt(src_pts, dst_pts, weights):
    """Weighted rigid alignment (Kabsch/Umeyama, no scaling): R, t minimizing
    sum w |R p + t - q|^2."""
    wsum = jnp.maximum(jnp.sum(weights), 1e-9)
    cp = jnp.sum(src_pts * weights[:, None], axis=0) / wsum
    cq = jnp.sum(dst_pts * weights[:, None], axis=0) / wsum
    sp = src_pts - cp
    sq = dst_pts - cq
    # full precision: a reduced-precision (bf16/TF32) product floors the
    # achievable alignment at ~3e-3 rad
    H = jax.lax.dot_general((sp * weights[:, None]), sq,
                            (((0,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST)  # (3,3)
    U, S, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, d]))
    R = Vt.T @ D @ U.T
    t = cq - R @ cp
    return R, t


def _sorted_for_window(src, dst, smask, dmask, T0, nn_axis: int):
    """Sort dst (and src, by its initially-transformed coordinate) on the
    window axis. ICP's outputs are permutation-invariant — correspondences
    are gathered per-row and the solve reduces weighted sums — up to float
    reassociation in those sums (~1e-7 relative)."""
    od = jnp.argsort(dst[:, nn_axis])
    dst = jnp.take(dst, od, axis=0)
    dmask = None if dmask is None else jnp.take(dmask, od)
    p0 = src @ T0[:3, :3].T + T0[:3, 3]
    osrc = jnp.argsort(p0[:, nn_axis])
    src = jnp.take(src, osrc, axis=0)
    smask = jnp.take(smask, osrc)
    return src, dst, smask, dmask, od


@partial(jax.jit, static_argnames=("max_iterations", "chunk", "nn_window",
                                   "nn_axis", "nn_impl"))
def icp_point_to_point(src: jnp.ndarray, dst: jnp.ndarray,
                       threshold: float = 0.05,
                       init: jnp.ndarray | None = None,
                       src_mask: jnp.ndarray | None = None,
                       dst_mask: jnp.ndarray | None = None,
                       max_iterations: int = 30,
                       relative_fitness: float = 1e-6,
                       relative_rmse: float = 1e-6,
                       chunk: int = 4096,
                       nn_window: int = 0, nn_axis: int = 2,
                       nn_impl: str = "auto") -> ICPResult:
    """Point-to-point ICP aligning src onto dst.

    nn_window > 0 enables the radius-limited windowed NN kernel (see
    nn_distance_radius): both clouds are sorted once on coordinate nn_axis
    and each iteration's correspondence search scans only ~nn_window dst
    chunks per source tile. Exact for every inlier (the radius is the
    inlier threshold, so out-of-radius correspondences carry zero weight
    either way); size with auto_nn_window. A traced fit flag falls back to
    the full scan whenever the window assumption breaks, so results never
    depend on it. nn_impl picks the NN implementation (nn._resolve_impl)."""
    n = src.shape[0]
    smask = jnp.ones(n, bool) if src_mask is None else src_mask
    T0 = jnp.eye(4, dtype=jnp.float32) if init is None else init.astype(jnp.float32)
    dmask = dst_mask
    if nn_window > 0:
        src, dst, smask, dmask, _ = _sorted_for_window(
            src, dst, smask, dmask, T0, nn_axis)

    def nn(p):
        if nn_window > 0:
            return nn_distance_radius(
                p, dst, threshold, smask, dmask, window_chunks=nn_window,
                axis=nn_axis, with_index=True, impl=nn_impl)
        return nn_distance(p, dst, smask, dmask, chunk=chunk,
                           with_index=True, impl=nn_impl)

    def metrics(T):
        p = src @ T[:3, :3].T + T[:3, 3]
        d, idx = nn(p)
        inlier = smask & (d < threshold)
        nin = jnp.sum(inlier)
        fitness = nin / jnp.maximum(jnp.sum(smask), 1)
        rmse = jnp.sqrt(jnp.sum(jnp.where(inlier, d * d, 0.0))
                        / jnp.maximum(nin, 1))
        return d, idx, inlier, fitness, rmse

    def cond(state):
        T, idx, inlier, fit, rmse, prev_fit, prev_rmse, it = state
        keep = ((jnp.abs(prev_fit - fit) > relative_fitness)
                | (jnp.abs(prev_rmse - rmse) > relative_rmse))
        return (it < max_iterations) & ((it < 2) | keep)

    def body(state):
        # one NN pass per iteration: solve with the carried correspondences,
        # then evaluate the new pose (whose correspondences carry forward)
        T, idx, inlier, fit, rmse, _, _, it = state
        p = src @ T[:3, :3].T + T[:3, 3]
        q = jnp.take(dst, idx, axis=0)
        w = inlier.astype(jnp.float32)
        R, t = _umeyama_rt(p, q, w)
        dT = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)
        T_new = (dT @ T).astype(jnp.float32)
        _, idx_new, inl_new, fit_new, rmse_new = metrics(T_new)
        return (T_new, idx_new, inl_new, fit_new, rmse_new, fit, rmse, it + 1)

    _, idx0, inl0, fit0, rmse0 = metrics(T0)
    state = (T0, idx0, inl0, fit0, rmse0, jnp.float32(-1.0),
             jnp.float32(-1.0), jnp.int32(0))
    T, _, _, fit, rmse, _, _, it = jax.lax.while_loop(cond, body, state)
    return ICPResult(T, fit, rmse, it)


@partial(jax.jit, static_argnames=("max_iterations", "chunk", "nn_window",
                                   "nn_axis", "nn_impl"))
def icp_point_to_plane(src: jnp.ndarray, dst: jnp.ndarray,
                       dst_normals: jnp.ndarray,
                       threshold: float = 0.05,
                       init: jnp.ndarray | None = None,
                       src_mask: jnp.ndarray | None = None,
                       dst_mask: jnp.ndarray | None = None,
                       max_iterations: int = 30,
                       relative_fitness: float = 1e-6,
                       relative_rmse: float = 1e-6,
                       chunk: int = 4096,
                       nn_window: int = 0, nn_axis: int = 2,
                       nn_impl: str = "auto") -> ICPResult:
    """Point-to-plane ICP (linearized small-angle 6x6 solve per iteration).

    nn_window, nn_impl: see icp_point_to_point."""
    n = src.shape[0]
    smask = jnp.ones(n, bool) if src_mask is None else src_mask
    T0 = jnp.eye(4, dtype=jnp.float32) if init is None else init.astype(jnp.float32)
    dmask = dst_mask
    if nn_window > 0:
        src, dst, smask, dmask, od = _sorted_for_window(
            src, dst, smask, dmask, T0, nn_axis)
        dst_normals = jnp.take(dst_normals, od, axis=0)

    def nn(p):
        if nn_window > 0:
            return nn_distance_radius(
                p, dst, threshold, smask, dmask, window_chunks=nn_window,
                axis=nn_axis, with_index=True, impl=nn_impl)
        return nn_distance(p, dst, smask, dmask, chunk=chunk,
                           with_index=True, impl=nn_impl)

    def metrics(T):
        p = src @ T[:3, :3].T + T[:3, 3]
        d, idx = nn(p)
        inlier = smask & (d < threshold)
        nin = jnp.sum(inlier)
        fitness = nin / jnp.maximum(jnp.sum(smask), 1)
        rmse = jnp.sqrt(jnp.sum(jnp.where(inlier, d * d, 0.0))
                        / jnp.maximum(nin, 1))
        return p, idx, inlier, fitness, rmse

    def solve(p, q, nrm, w):
        r = jnp.sum((p - q) * nrm, axis=-1)          # signed plane residual
        c = jnp.cross(p, nrm)                        # rotation jacobian
        J = jnp.concatenate([c, nrm], axis=-1)       # (N, 6)
        hi = jax.lax.Precision.HIGHEST
        Jw = J * w[:, None]
        A = jax.lax.dot_general(Jw, J, (((0,), (0,)), ((), ())),
                                precision=hi)
        # relative Tikhonov damping: under-constrained motion modes (e.g.
        # floor-only views leave x/y/yaw free) must yield ~zero step, not a
        # noise-driven walk; the bias on well-constrained modes is ~1e-3
        A = A + (1e-3 * jnp.trace(A) / 6.0 + 1e-9) * jnp.eye(6)
        b = -jax.lax.dot_general(Jw, r, (((0,), (0,)), ((), ())),
                                 precision=hi)
        x = jnp.linalg.solve(A, b)                   # (wx, wy, wz, tx, ty, tz)
        # clamp the step: the linearization is only valid for small motions,
        # and a near-degenerate normal set (e.g. floor-dominated views) can
        # otherwise launch a runaway iterate
        rot_n = jnp.linalg.norm(x[:3])
        tr_n = jnp.linalg.norm(x[3:])
        scale = jnp.minimum(1.0, jnp.minimum(0.15 / jnp.maximum(rot_n, 1e-9),
                                             0.15 / jnp.maximum(tr_n, 1e-9)))
        x = x * scale
        wx, wy, wz, tx, ty, tz = x
        R = jnp.array([
            [1.0, -wz, wy],
            [wz, 1.0, -wx],
            [-wy, wx, 1.0],
        ])
        # re-orthonormalize the small-angle rotation via SVD projection
        U, _, Vt = jnp.linalg.svd(R)
        Rn = U @ Vt
        Rn = Rn * jnp.sign(jnp.linalg.det(Rn))
        return jnp.eye(4).at[:3, :3].set(Rn).at[:3, 3].set(
            jnp.array([tx, ty, tz]))

    def cond(state):
        (T, idx, inlier, fit, rmse, prev_fit, prev_rmse, it, *_rest) = state
        keep = ((jnp.abs(prev_fit - fit) > relative_fitness)
                | (jnp.abs(prev_rmse - rmse) > relative_rmse))
        return (it < max_iterations) & ((it < 2) | keep)

    def body(state):
        (T, idx, inlier, fit, rmse, _, _, it,
         best_T, best_fit, best_rmse) = state
        p = src @ T[:3, :3].T + T[:3, 3]
        q = jnp.take(dst, idx, axis=0)
        nrm = jnp.take(dst_normals, idx, axis=0)
        dT = solve(p, q, nrm, inlier.astype(jnp.float32))
        T_new = (dT @ T).astype(jnp.float32)
        p2, idx_new, inl_new, fit_new, rmse_new = metrics(T_new)
        # fallback tracking by inlier RMSE only: under partial overlap,
        # fitness can *increase* for wrong poses (density sliding), so the
        # last iterate is authoritative unless it collapsed (fitness ~ 0)
        better = rmse_new < best_rmse
        best_T = jnp.where(better, T_new, best_T)
        best_fit = jnp.where(better, fit_new, best_fit)
        best_rmse = jnp.where(better, rmse_new, best_rmse)
        return (T_new, idx_new, inl_new, fit_new, rmse_new, fit, rmse,
                it + 1, best_T, best_fit, best_rmse)

    p0, idx0, inl0, fit0, rmse0 = metrics(T0)
    state = (T0, idx0, inl0, fit0, rmse0, jnp.float32(-1.0),
             jnp.float32(-1.0), jnp.int32(0), T0, fit0, rmse0)
    out = jax.lax.while_loop(cond, body, state)
    T, _, _, fit, rmse, _, _, it, best_T, best_fit, best_rmse = out
    # last iterate unless it collapsed (lost nearly all correspondences)
    use_best = fit < 0.05
    T = jnp.where(use_best, best_T, T)
    fit = jnp.where(use_best, best_fit, fit)
    rmse = jnp.where(use_best, best_rmse, rmse)
    return ICPResult(T, fit, rmse, it)
