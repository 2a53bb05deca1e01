"""SE(3) pose-graph optimization on device (loop closure backend).

The reference trusts TF for capture poses (scanner_node.cpp:227-236 looks up
map->camera at capture time) and has no global trajectory correction; this is
a "beat the reference" capability: odometry/ICP relative-pose edges plus loop
closure edges over the capture circle (scanner_node.cpp:164-258 — viewpoints
ring each object, so first/last frames overlap) are jointly optimized with
Gauss-Newton over a right-multiplicative se(3) retraction.

Shape: the whole solve is one jitted function — residuals for all
edges are batched (vmap), the Jacobian of the stacked residual comes from
jacfwd (6E x 6N, tiny for mission-scale N), and the damped normal equations
solve on-device. Static shapes throughout: edge arrays are padded and masked
by weight=0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def _hat(w):
    """so(3) hat map: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], -1),
        jnp.stack([wz, z, -wx], -1),
        jnp.stack([-wy, wx, z], -1),
    ], -2)


def exp_se3(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exponential. xi = (wx, wy, wz, tx, ty, tz) -> (4, 4).

    Rotation block via Rodrigues; translation through the left Jacobian V.
    Small-angle branches use the Taylor series (exact to O(theta^4)), chosen
    with jnp.where on a smooth cutoff so the function is jacfwd-safe at 0.
    """
    w = xi[..., :3]
    v = xi[..., 3:]
    th2 = jnp.sum(w * w, axis=-1)[..., None, None]
    small = th2 < 1e-8
    # jacfwd-safe: sqrt'(0) = inf would poison BOTH where-branches through
    # the shared th, so the sqrt argument itself is branch-guarded
    th2s = jnp.where(small, 1.0, th2)
    th = jnp.sqrt(th2s)
    W = _hat(w)
    W2 = W @ W
    A = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    B = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / th2s)
    C = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (th - jnp.sin(th)) / (th2s * th))
    eye = jnp.eye(3, dtype=xi.dtype)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = (V @ v[..., None])[..., 0]
    T = jnp.zeros(xi.shape[:-1] + (4, 4), xi.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def log_se3(T: jnp.ndarray) -> jnp.ndarray:
    """se(3) logarithm. (4, 4) -> (wx, wy, wz, tx, ty, tz).

    Valid for rotation angles < pi (pose-graph residuals are small by
    construction); small-angle branches mirror exp_se3.
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    cos = jnp.clip((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5,
                   -1.0, 1.0)[..., None, None]
    # threshold must be representable in f32 (1 - 5e-9 rounds to 1.0 and the
    # branch would never trigger); 1e-6 puts the cutover at th ~ 1.4e-3 where
    # the Taylor branch is still exact to ~1e-12
    small = cos > 1.0 - 1e-6
    # jacfwd-safe: arccos'(1) = inf would poison both branches through the
    # shared th, so the arccos argument itself is branch-guarded; the Taylor
    # branch uses th^2 ~= 2(1 - cos) which is differentiable at identity
    th = jnp.arccos(jnp.where(small, 0.0, cos))
    th2_taylor = 2.0 * (1.0 - cos)
    th2 = jnp.where(small, th2_taylor, th * th)
    # w from the skew part: vee((R - R^T) * th / (2 sin th))
    k = jnp.where(small, 0.5 + th2_taylor / 12.0, th / (2.0 * jnp.sin(th)))
    S = (R - jnp.swapaxes(R, -1, -2)) * k
    w = jnp.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], -1)
    W = _hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + coef * W^2
    coef = jnp.where(small, 1.0 / 12.0 + th2_taylor / 720.0,
                     (1.0 - (th * jnp.cos(th * 0.5))
                      / jnp.where(small, 1.0, 2.0 * jnp.sin(th * 0.5)))
                     / jnp.where(small, 1.0, th2))
    Vinv = jnp.eye(3, dtype=T.dtype) - 0.5 * W + coef * W2
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


class PoseGraphResult(NamedTuple):
    poses: jnp.ndarray       # (N, 4, 4) optimized camera->world
    residual_rmse: jnp.ndarray  # final edge residual RMSE (se3 norm)
    initial_rmse: jnp.ndarray


@partial(jax.jit, static_argnames=("num_iters",))
def optimize_pose_graph(poses: jnp.ndarray, edges_i: jnp.ndarray,
                        edges_j: jnp.ndarray, edges_z: jnp.ndarray,
                        weights: jnp.ndarray, num_iters: int = 12,
                        damping: float = 1e-4,
                        anchor_weight: float = 1e3) -> PoseGraphResult:
    """Gauss-Newton pose-graph solve.

    poses: (N, 4, 4) initial camera->world transforms T_k.
    edges_*: (E,) int32 endpoints, edges_z (E, 4, 4) measured relative
    transforms Z_e ~= inv(T_i) @ T_j, weights (E,) f32 (0 disables an edge —
    use for padding). Node 0 is gauge-fixed by a strong prior.

    Residual per edge: log_se3(inv(Z) @ inv(T_i) @ T_j) with the current
    estimates perturbed as T_k <- T_k @ exp_se3(delta_k); one GN step solves
    the damped normal equations for all deltas jointly.
    """
    N = poses.shape[0]
    E = edges_i.shape[0]
    f = jnp.float64 if poses.dtype == jnp.float64 else jnp.float32
    poses = poses.astype(f)
    edges_z = edges_z.astype(f)
    # weight-0 padding may carry an arbitrary (even all-zero, singular) Z;
    # substitute identity before inverting so the padded residual is a
    # finite 0 * w rather than NaN poisoning the whole stacked system
    live = (weights > 0)[:, None, None]
    edges_z = jnp.where(live, edges_z, jnp.eye(4, dtype=f))
    z_inv = jnp.linalg.inv(edges_z)
    w_sqrt = jnp.sqrt(jnp.maximum(weights.astype(f), 0.0))

    def residuals(deltas, T_all):
        T_pert = T_all @ exp_se3(deltas)                 # (N, 4, 4)
        Ti = jnp.take(T_pert, edges_i, axis=0)
        Tj = jnp.take(T_pert, edges_j, axis=0)
        rel = jnp.linalg.inv(Ti) @ Tj
        r = log_se3(z_inv @ rel)                         # (E, 6)
        return (r * w_sqrt[:, None]).reshape(-1)         # (6E,)

    def rmse(T_all):
        r = residuals(jnp.zeros((N, 6), f), T_all).reshape(E, 6)
        wsum = jnp.maximum(jnp.sum(weights > 0), 1)
        return jnp.sqrt(jnp.sum(r * r) / (6.0 * wsum))

    init_rmse = rmse(poses)

    def step(T_all, _):
        zero = jnp.zeros((N, 6), f)
        r = residuals(zero, T_all)                       # (6E,)
        J = jax.jacfwd(residuals)(zero, T_all).reshape(r.shape[0], N * 6)
        hi = jax.lax.Precision.HIGHEST
        JtJ = jax.lax.dot_general(J, J, (((0,), (0,)), ((), ())), precision=hi)
        Jtr = jax.lax.dot_general(J, r, (((0,), (0,)), ((), ())), precision=hi)
        # gauge fix: strong-but-bounded prior on node 0's delta — it must
        # dominate edge information (O(sum weights)) without wrecking the f32
        # condition number (an 1e8 anchor made every solve step garbage)
        diag_prior = jnp.concatenate(
            [jnp.full((6,), anchor_weight, f), jnp.zeros((N - 1) * 6, f)])
        # Levenberg-Marquardt scale-invariant damping on the diagonal
        A = JtJ + jnp.diag(diag_prior + damping * jnp.diagonal(JtJ) + 1e-9)
        delta = -jnp.linalg.solve(A, Jtr).reshape(N, 6)
        # accept the best of {full step, quarter step, no step}: plain GN can
        # overshoot on strong nonlinearity; this is a cheap dogleg guard
        cur = rmse(T_all)
        T_full = T_all @ exp_se3(delta)
        T_quarter = T_all @ exp_se3(0.25 * delta)
        r_full = rmse(T_full)
        r_quarter = rmse(T_quarter)
        take_full = (r_full <= r_quarter) & (r_full < cur)
        take_quarter = (~take_full) & (r_quarter < cur)
        T_next = jnp.where(take_full, T_full,
                           jnp.where(take_quarter, T_quarter, T_all))
        return T_next, None

    T_opt, _ = jax.lax.scan(step, poses, None, length=num_iters)
    return PoseGraphResult(T_opt.astype(poses.dtype), rmse(T_opt), init_rmse)
