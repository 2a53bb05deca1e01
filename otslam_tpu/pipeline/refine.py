"""Pose refinement: frame-to-model ICP tracking (KinectFusion-style).

BASELINE config 3 — "point-to-plane ICP pose refinement + trajectory eval vs
GT": capture poses from odometry/TF drift; before fusing, each frame
registers against the surface extracted from the volume built so far, and
its extrinsic is corrected. The reference has no equivalent (it trusts TF);
this is the upgrade path for real-robot data.

Loop shape: host iterates frames (each step is a handful of fused device
dispatches: backproject + sparse model extraction + point-to-plane ICP +
block integration).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from otslam_tpu.config import ReconstructionConfig
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.core.se3 import invert_se3
from otslam_tpu.kernels.icp import icp_point_to_plane, icp_point_to_point
from otslam_tpu.kernels.nn import auto_nn_window
from otslam_tpu.kernels.pose_graph import optimize_pose_graph
from otslam_tpu.kernels.track import track_frame_to_tsdf
from otslam_tpu.kernels.tsdf_block import (
    extract_surface_points_sparse, integrate_frames_sparse,
    make_block_volume)


@dataclass
class RefineResult:
    extrinsics: np.ndarray               # (N, 4, 4) corrected world->camera
    volume: object                       # final BlockTSDFVolume
    fitness: List[float] = field(default_factory=list)
    rmse: List[float] = field(default_factory=list)


def _frame_points(depth, intr: PinholeIntrinsics, stride: int = 4,
                  max_points: int = 8192, max_depth: float = 4.0):
    """Subsampled camera-frame points of a depth frame (padded + mask)."""
    d = depth[::stride, ::stride]
    H, W = d.shape
    us = (jnp.arange(W) * stride).astype(jnp.float32)
    vs = (jnp.arange(H) * stride).astype(jnp.float32)
    uu, vv = jnp.meshgrid(us, vs)
    x = (uu - intr.cx) / intr.fx * d
    y = (vv - intr.cy) / intr.fy * d
    pts = jnp.stack([x, y, d], -1).reshape(-1, 3)
    mask = ((d > 0) & (d < max_depth)).reshape(-1)
    if pts.shape[0] > max_points:
        # uniform every-kth subsample of the flattened strided grid: keeps
        # whole-image support (a [:max_points] truncation would feed only
        # the top rows of the frame into tracking — at VGA/stride 4 that
        # was the top ~43% of the image)
        step = -(-pts.shape[0] // max_points)
        pts = pts[::step]
        mask = mask[::step]
    return pts, mask


def _frame_points_normals(depth, intr: PinholeIntrinsics, stride: int = 4,
                          max_depth: float = 4.0):
    """Camera-frame points + normals from depth-image gradients.

    Normal = normalize(cross(dP/du, dP/dv)); exact for planar surfaces,
    invalid across depth discontinuities (masked by a gradient gate).
    """
    d = depth[::stride, ::stride]
    H, W = d.shape
    us = (jnp.arange(W) * stride).astype(jnp.float32)
    vs = (jnp.arange(H) * stride).astype(jnp.float32)
    uu, vv = jnp.meshgrid(us, vs)
    P = jnp.stack([(uu - intr.cx) / intr.fx * d,
                   (vv - intr.cy) / intr.fy * d, d], -1)   # (H, W, 3)
    du = jnp.roll(P, -1, axis=1) - P
    dv = jnp.roll(P, -1, axis=0) - P
    n = jnp.cross(du, dv)
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.where(ln > 1e-12, ln, 1.0)
    smooth = (jnp.linalg.norm(du, axis=-1) < 0.1) & (
        jnp.linalg.norm(dv, axis=-1) < 0.1)
    valid = (d > 0) & (d < max_depth) & smooth
    # zero the wrap-around borders
    valid = valid.at[-1, :].set(False).at[:, -1].set(False)
    return (P.reshape(-1, 3), n.reshape(-1, 3), valid.reshape(-1))


def _pair_nn_window(pts_a, pts_b, radius) -> tuple[int, int]:
    """(nn_window, nn_axis) for frame-pair ICP, sized once per chain from
    concrete clouds (invalid rows included — they sort into the window too)
    and rounded to a multiple of 2 so successive pairs share one jit cache
    entry. Undersizing only triggers the kernel's full-scan fallback."""
    return auto_nn_window(np.asarray(pts_a), np.asarray(pts_b), radius,
                          round_to=2)


def refine_trajectory(depths, colors, extrinsics, intr: PinholeIntrinsics,
                      cfg: ReconstructionConfig, max_active: int = 2048,
                      thresholds=(0.1, 0.05, 0.02), stride: int = 4,
                      trust_translation: float = 0.15, trust_rot: float = 0.15
                      ) -> RefineResult:
    """Frame-to-frame point-to-plane tracking, then fusion with the
    corrected poses.

    Each frame registers against its predecessor (both full-frustum views —
    large overlap, no volume cropping) using normals from the predecessor's
    depth gradients. The correspondence threshold anneals coarse-to-fine:
    partially-overlapping view pairs bias wide-threshold ICP, so each stage
    re-solves with a tighter gate starting from the previous stage's pose.
    Relative corrections compose along the chain; frame 0 anchors it.

    depths (N,H,W) f32 meters, colors (N,H,W,3) [0,255], extrinsics (N,4,4)
    world->camera priors (e.g. drifting odometry).
    """
    n = depths.shape[0]
    out_ext = [np.asarray(extrinsics[0], np.float64)]
    fitness, rmses = [], []

    prev_pts, prev_nrm, prev_valid = _frame_points_normals(
        jnp.asarray(depths[0]), intr, stride)
    for i in range(1, n):
        cur_pts, cur_nrm, cur_valid = _frame_points_normals(
            jnp.asarray(depths[i]), intr, stride)
        # per-pair window, sized at the widest annealing threshold so
        # every stage's radius is covered (round_to=2 collapses the
        # near-identical windows of consecutive pairs onto one jit entry;
        # the host fetch is one small transfer per pair, in a loop that
        # already syncs per pair for fitness/rmse)
        nn_w, nn_ax = _pair_nn_window(cur_pts, prev_pts, max(thresholds))
        # prior relative transform camera_i -> camera_{i-1}
        E_prev = np.asarray(extrinsics[i - 1], np.float64)
        E_cur = np.asarray(extrinsics[i], np.float64)
        Tr_prior = E_prev @ invert_se3(E_cur)
        src = cur_pts @ jnp.asarray(Tr_prior[:3, :3].T, jnp.float32) \
            + jnp.asarray(Tr_prior[:3, 3], jnp.float32)
        T_acc = jnp.eye(4, dtype=jnp.float32)
        res = None
        for thr in thresholds:
            res = icp_point_to_plane(src, prev_pts, prev_nrm, threshold=thr,
                                     init=T_acc,
                                     src_mask=cur_valid, dst_mask=prev_valid,
                                     max_iterations=15, chunk=2048,
                                     nn_window=nn_w, nn_axis=nn_ax)
            T_acc = res.transformation
        dT = np.asarray(T_acc, np.float64)
        # trust region around the odometry prior: low-overlap pairs can score
        # a *wrong* pose higher (density sliding); corrections beyond
        # plausible per-step drift keep the prior instead of a confident lie
        d_rot = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
        d_tr = np.linalg.norm(dT[:3, 3])
        if d_rot > trust_rot or d_tr > trust_translation:
            dT = np.eye(4)
        Tr = dT @ Tr_prior
        # E_i = Tr^{-1} E_{i-1}, chained through the corrected predecessor
        corrected = invert_se3(Tr) @ out_ext[-1]
        out_ext.append(corrected)
        fitness.append(float(res.fitness))
        rmses.append(float(res.inlier_rmse))
        prev_pts, prev_nrm, prev_valid = cur_pts, cur_nrm, cur_valid

    ext = np.stack(out_ext).astype(np.float32)
    vol = integrate_frames_sparse(
        make_block_volume(cfg.tsdf), jnp.asarray(depths),
        jnp.asarray(colors), jnp.asarray(ext), intr, max_active=max_active)
    return RefineResult(ext, vol, fitness, rmses)


def refine_trajectory_f2m(depths, colors, extrinsics, intr: PinholeIntrinsics,
                          cfg: ReconstructionConfig, max_active: int = 2048,
                          stride: int = 4, max_iterations: int = 15,
                          trust_translation: float = 0.2,
                          trust_rot: float = 0.2) -> RefineResult:
    """Frame-to-MODEL tracking: direct projective alignment against the TSDF.

    Each frame's pose is solved by Gauss-Newton on the signed distance field
    accumulated so far (kernels/track.py) — no extraction, no correspondence
    search — then the frame fuses at the corrected pose. Registering against
    the global model means per-frame errors do NOT compound along the chain:
    drift stays bounded by the model's accuracy instead of growing O(N), and
    the reference's capture-circle geometry (scanner_node.cpp:164-258) brings
    the camera back over mapped surface, closing the loop implicitly.

    Same I/O contract as refine_trajectory. The frame's odometry INCREMENT
    (not its absolute pose) seeds the solve, so odometry that has drifted far
    from the world frame still provides a good relative prior.
    """
    n = depths.shape[0]
    out_ext = [np.asarray(extrinsics[0], np.float64)]
    fitness, rmses = [], []

    vol = integrate_frames_sparse(
        make_block_volume(cfg.tsdf), jnp.asarray(depths[:1]),
        jnp.asarray(colors[:1]), jnp.asarray(extrinsics[:1]), intr,
        max_active=max_active)

    for i in range(1, n):
        # odometry increment composed onto the corrected predecessor
        E_prev_odo = np.asarray(extrinsics[i - 1], np.float64)
        E_cur_odo = np.asarray(extrinsics[i], np.float64)
        E_prior = (E_cur_odo @ invert_se3(E_prev_odo)) @ out_ext[-1]

        pts, mask = _frame_points(jnp.asarray(depths[i]), intr, stride)
        res = track_frame_to_tsdf(vol, pts, mask,
                                  jnp.asarray(invert_se3(E_prior),
                                              jnp.float32),
                                  max_iterations=max_iterations)
        T = np.asarray(res.transformation, np.float64)
        dT = T @ E_prior                        # camera->world correction
        d_rot = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
        d_tr = np.linalg.norm(dT[:3, 3])
        if d_rot > trust_rot or d_tr > trust_translation:
            corrected = E_prior
        else:
            corrected = invert_se3(T)
        out_ext.append(corrected)
        fitness.append(float(res.inlier_fraction))
        rmses.append(float(res.rmse))
        vol = integrate_frames_sparse(
            vol, jnp.asarray(depths[i:i + 1]), jnp.asarray(colors[i:i + 1]),
            jnp.asarray(corrected.astype(np.float32))[None], intr,
            max_active=max_active)

    ext = np.stack(out_ext).astype(np.float32)
    return RefineResult(ext, vol, fitness, rmses)


def _register_pair(pts_i, nrm_i, valid_i, pts_j, valid_j, prior_rel,
                   thresholds=(0.1, 0.05, 0.02)):
    """Annealed point-to-plane registration of frame j onto frame i.

    pts/nrm are camera-frame arrays from _frame_points_normals; prior_rel is
    the prior camera_j -> camera_i transform. Returns (M, fitness, rmse)
    with M the measured camera_j -> camera_i transform.
    """
    src = pts_j @ jnp.asarray(prior_rel[:3, :3].T, jnp.float32) \
        + jnp.asarray(prior_rel[:3, 3], jnp.float32)
    nn_w, nn_ax = _pair_nn_window(src, pts_i, max(thresholds))
    T_acc = jnp.eye(4, dtype=jnp.float32)
    res = None
    for thr in thresholds:
        res = icp_point_to_plane(src, pts_i, nrm_i, threshold=thr, init=T_acc,
                                 src_mask=valid_j, dst_mask=valid_i,
                                 max_iterations=15, chunk=2048,
                                 nn_window=nn_w, nn_axis=nn_ax)
        T_acc = res.transformation
    M = np.asarray(T_acc, np.float64) @ np.asarray(prior_rel, np.float64)
    return M, float(res.fitness), float(res.inlier_rmse)


def detect_loop_closures(depths, extrinsics, intr: PinholeIntrinsics,
                         stride: int = 4, min_gap: int = 8,
                         radius: float = 0.8, max_pairs: int = 6,
                         min_fitness: float = 0.5):
    """Propose + verify loop-closure edges over a trajectory.

    Candidates: frame pairs (i, j) with |i - j| >= min_gap whose estimated
    camera centers are within `radius` (the capture circle brings the end of
    a loop back near its start). Each candidate is verified by annealed
    point-to-plane ICP; pairs below `min_fitness` are rejected. Greedy
    farthest-in-index-first selection caps the count at max_pairs.

    Returns a list of (i, j, Z, fitness) with Z the measured camera_j ->
    camera_i transform (== inv(T_i) @ T_j for camera->world T).
    """
    n = depths.shape[0]
    ext = np.asarray(extrinsics, np.float64)
    centers = np.stack([invert_se3(e)[:3, 3] for e in ext])
    cand = []
    for i in range(n):
        for j in range(i + min_gap, n):
            d = np.linalg.norm(centers[i] - centers[j])
            if d < radius:
                cand.append((j - i, d, i, j))
    # prefer the longest loops (largest index gap), then the closest centers
    cand.sort(key=lambda c: (-c[0], c[1]))
    used = set()
    edges = []
    cache = {}

    def frame(k):
        if k not in cache:
            cache[k] = _frame_points_normals(jnp.asarray(depths[k]), intr,
                                             stride)
        return cache[k]

    for gap, d, i, j in cand:
        if len(edges) >= max_pairs:
            break
        if i in used or j in used:
            continue
        pi, ni, vi = frame(i)
        pj, _, vj = frame(j)
        prior_rel = ext[i] @ invert_se3(ext[j])
        M, fit, rmse = _register_pair(pi, ni, vi, pj, vj, prior_rel)
        if fit >= min_fitness:
            edges.append((i, j, M, fit))
            used.add(i)
            used.add(j)
    return edges


def refine_trajectory_pgo(depths, colors, extrinsics, intr: PinholeIntrinsics,
                          cfg: ReconstructionConfig, max_active: int = 2048,
                          stride: int = 4, min_gap: int = 8,
                          loop_radius: float = 0.8, max_loop_pairs: int = 6,
                          num_iters: int = 12,
                          front_end: str = "f2m") -> RefineResult:
    """Pose-graph refinement: tracked odometry chain + loop-closure edges,
    jointly optimized with Gauss-Newton (kernels/pose_graph.py), then fused.

    Whereas refine_trajectory chains per-pair corrections (drift O(N)) and
    refine_trajectory_f2m bounds drift with the model, this variant closes
    loops GLOBALLY: the residual drift accumulated along the chain
    redistributes over all poses when loop edges pin revisits together.

    front_end selects the chain tracker: "f2m" (direct TSDF tracking — the
    default; its drift is already bounded, so PGO only has to spread the
    small loop residual) or "icp" (frame-to-frame point-to-plane pairs —
    no volume needed, works on bare point sets).
    """
    n = depths.shape[0]
    ei, ej, Zs, ws = [], [], [], []
    fitness, rmses = [], []

    if front_end == "f2m":
        fe = refine_trajectory_f2m(depths, colors, extrinsics, intr, cfg,
                                   max_active=max_active, stride=stride)
        ext_chain = fe.extrinsics.astype(np.float64)
        fitness, rmses = fe.fitness, fe.rmse
        for i in range(n - 1):
            # Z_e = inv(T_i) @ T_j = E_i @ inv(E_j): camera_j -> camera_i
            ei.append(i)
            ej.append(i + 1)
            Zs.append(ext_chain[i] @ invert_se3(ext_chain[i + 1]))
            ws.append(1.0)
    elif front_end == "icp":
        ext = np.asarray(extrinsics, np.float64)
        frames = [_frame_points_normals(jnp.asarray(depths[k]), intr, stride)
                  for k in range(n)]
        chain = [invert_se3(ext[0])]
        for i in range(n - 1):
            pi, ni, vi = frames[i]
            pj, _, vj = frames[i + 1]
            prior_rel = ext[i] @ invert_se3(ext[i + 1])
            M, fit, rmse = _register_pair(pi, ni, vi, pj, vj, prior_rel)
            # trust region: keep the odometry prior on failed registrations
            dT = M @ invert_se3(prior_rel)
            d_rot = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
            if (d_rot > 0.2 or np.linalg.norm(dT[:3, 3]) > 0.2 or fit < 0.3):
                M = prior_rel
            ei.append(i)
            ej.append(i + 1)
            Zs.append(M)
            ws.append(1.0)
            fitness.append(fit)
            rmses.append(rmse)
            chain.append(chain[-1] @ M)
        ext_chain = np.stack([invert_se3(t) for t in chain])
    else:
        raise ValueError(f"unknown front_end {front_end!r}")

    loops = detect_loop_closures(depths, ext_chain, intr, stride=stride,
                                 min_gap=min_gap, radius=loop_radius,
                                 max_pairs=max_loop_pairs)
    for i, j, M, fit in loops:
        ei.append(i)
        ej.append(j)
        Zs.append(M)
        ws.append(2.0)      # loop edges weigh more: they carry global truth

    poses0 = jnp.asarray(
        np.stack([invert_se3(e) for e in ext_chain]).astype(np.float32))
    # pad edges to a bucketed capacity (weight-0 identity edges are inert)
    # so varying loop-closure counts don't retrigger a solver recompile
    ei, ej = np.array(ei, np.int32), np.array(ej, np.int32)
    Zs, ws = np.stack(Zs).astype(np.float32), np.array(ws, np.float32)
    cap = -(-len(ws) // 64) * 64
    pad = cap - len(ws)
    if pad:
        ei = np.concatenate([ei, np.zeros(pad, np.int32)])
        ej = np.concatenate([ej, np.zeros(pad, np.int32)])
        Zs = np.concatenate([Zs, np.tile(np.eye(4, dtype=np.float32)[None],
                                         (pad, 1, 1))])
        ws = np.concatenate([ws, np.zeros(pad, np.float32)])
    res = optimize_pose_graph(
        poses0, jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(Zs),
        jnp.asarray(ws), num_iters=num_iters)
    T_opt = np.asarray(res.poses, np.float64)
    ext_out = np.stack([invert_se3(t) for t in T_opt]).astype(np.float32)

    vol = integrate_frames_sparse(
        make_block_volume(cfg.tsdf), jnp.asarray(depths),
        jnp.asarray(colors), jnp.asarray(ext_out), intr,
        max_active=max_active)
    return RefineResult(ext_out, vol, fitness, rmses)


def trajectory_error(ext_est, ext_gt):
    """(translation RMSE m, rotation RMSE rad) of camera poses given
    world->camera extrinsics (trajectory eval vs GT, BASELINE config 3)."""
    t_err, r_err = [], []
    for a, b in zip(np.asarray(ext_est), np.asarray(ext_gt)):
        Ta = invert_se3(a)
        Tb = invert_se3(b)
        t_err.append(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) ** 2)
        dR = Ta[:3, :3].T @ Tb[:3, :3]
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        r_err.append(ang ** 2)
    return float(np.sqrt(np.mean(t_err))), float(np.sqrt(np.mean(r_err)))
