"""Per-object 3D reconstruction pipelines.

Equivalents of the 3d_model/ scripts, batched and device-resident:

* ``reconstruct_object``  — reconstruct_rgbd.py / reconstruct_rgbd_filter.py:
  TSDF-fuse all frames of one object, extract the surface, optionally sample
  N points and remove the floor (Z < 0.03 m), save a PLY.
* ``reconstruct_range``   — multi_reconstruct_rgbd_filter.py: explicit frame
  ranges per object.
* ``reconstruct_all``     — main() loop over every object in a dataset.

The fusion backend is selectable: 'sparse' (block-sparse, the fast path and
the default) or 'dense' (the simple reference path).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from otslam_tpu.config import ReconstructionConfig
from otslam_tpu.core import io as tio
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.kernels.sampling import resample_points
from otslam_tpu.kernels.tsdf import (
    extract_surface_points, integrate_frames, make_volume)
from otslam_tpu.kernels.tsdf_block import (
    auto_max_active, block_to_dense, integrate_frames_sparse,
    make_block_volume)
from otslam_tpu.pipeline.dataset import CaptureDataset


def _observed_world_points(batch, intr: PinholeIntrinsics,
                           stride: int = 8) -> np.ndarray:
    """(P, 3) world points from a sparse pixel subset of every frame."""
    import numpy as _np
    pts = []
    for i in range(batch.depths.shape[0]):
        d = batch.depths[i, ::stride, ::stride]
        ok = d > 0
        if not ok.any():
            continue
        ys, xs = _np.nonzero(ok)
        z = d[ys, xs]
        u = xs * stride
        v = ys * stride
        x = (u - intr.cx) / intr.fx * z
        y = (v - intr.cy) / intr.fy * z
        cam = _np.stack([x, y, z, _np.ones_like(z)])
        world = _np.linalg.inv(batch.extrinsics[i].astype(_np.float64)) @ cam
        pts.append(world[:3].T)
    return _np.concatenate(pts) if pts else _np.zeros((0, 3))


def auto_volume_origin(batch, intr: PinholeIntrinsics,
                       cfg: ReconstructionConfig) -> tuple:
    """Center the object volume on the observed geometry.

    Open3D's ScalableTSDFVolume is extent-free (hash map); our dense block
    grid needs an origin. Estimate the object center by back-projecting a
    sparse pixel subset of every frame into world space and averaging, then
    place the grid so the center sits mid-volume (z aligned to start just
    below the floor).
    """
    import numpy as _np
    pts = _observed_world_points(batch, intr)
    c = _np.mean(pts, axis=0)
    X, Y, Z = cfg.tsdf.dims
    vs = cfg.tsdf.voxel_size
    origin = (float(c[0] - X * vs / 2), float(c[1] - Y * vs / 2),
              float(min(c[2] - Z * vs / 2, -0.02)))
    return origin


def auto_volume_config(batch, intr: PinholeIntrinsics,
                       cfg: ReconstructionConfig,
                       near_radius: float = 4.0,
                       max_dim: int = 512) -> ReconstructionConfig:
    """cfg with the volume origin AND dims fitted to the observed object.

    Open3D's ScalableTSDFVolume grows unbounded (reconstruct_rgbd.py:79-83);
    the dense block grid must size up-front, and a tracked GROUP (e.g. the
    full_room table + chairs merged by the tuned 4 m cluster radius) can
    exceed the default extent — frames then fuse into a volume that clips
    the group's outer members. Extent comes from the 2nd/98th percentile of
    floor-filtered observed points within the capture circle's own radius
    of the ray-converged target center (captures also see floor, walls and
    far background; the circle bounds the target by construction —
    `near_radius` caps the crop), padded by 8 cells and bucketed to
    64-cell multiples (bounds jit-cache variants) between the configured
    dims and `max_dim`.
    """
    import dataclasses as _dc

    import numpy as _np

    pts = _observed_world_points(batch, intr)
    if not len(pts):
        return _dc.replace(cfg, tsdf=_dc.replace(
            cfg.tsdf, origin=auto_volume_origin(batch, intr, cfg)))
    # the captures see the floor across the whole frustum; measure the
    # OBJECT's extent above the z-filter plane (the same floor cut the
    # output cloud applies, reconstruct_rgbd_filter.py:22,128)
    above = pts[pts[:, 2] >= cfg.z_filter_threshold]
    if len(above) >= 50:
        pts = above
    # target center = least-squares intersection of the capture circle's
    # optical axes (every viewpoint faces the object,
    # 3_multi_object_goal_selector.cpp:275-308 yaw=angle+pi); the circle's
    # radius then bounds the object — background geometry (walls, other
    # objects) beyond the cameras must not inflate the volume
    E = _np.asarray(batch.extrinsics, _np.float64)
    cams = -_np.einsum("nij,ni->nj", E[:, :3, :3], E[:, :3, 3])
    axes = E[:, 2, :3]                     # optical +z rows of world->cam
    A = _np.zeros((3, 3))
    b = _np.zeros(3)
    for ci, di in zip(cams, axes):
        P = _np.eye(3) - _np.outer(di, di)
        A += P
        b += P @ ci
    try:
        c = _np.linalg.solve(A + 1e-9 * _np.eye(3), b)
    except _np.linalg.LinAlgError:
        c = _np.median(pts, axis=0)
    cam_r = float(_np.median(
        _np.linalg.norm(cams[:, :2] - c[None, :2], axis=1)))
    # the circle stands off the object by the visiting buffer + lock margin
    # (~0.7 m tuned): the object proper ends well inside cam_r, while walls
    # behind it can sit just outside the circle — crop strictly inside
    crop_r = min(max(cam_r - 0.5, 0.5), near_radius)
    near = pts[_np.linalg.norm(pts[:, :2] - c[None, :2], axis=1) < crop_r]
    if len(near) < 50:
        near = pts
    lo = _np.percentile(near, 2, axis=0)
    hi = _np.percentile(near, 98, axis=0)
    vs = cfg.tsdf.voxel_size
    margin = 8 * vs
    need = hi - lo + 2 * margin
    dims = []
    for k, base in enumerate(cfg.tsdf.dims):
        cells = int(_np.ceil(need[k] / vs / 64.0)) * 64
        dims.append(int(min(max(cells, base), max_dim)))
    cx, cy = (lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2
    origin = (float(cx - dims[0] * vs / 2), float(cy - dims[1] * vs / 2),
              float(min(lo[2] - margin, -0.02)))
    return _dc.replace(cfg, tsdf=_dc.replace(
        cfg.tsdf, dims=tuple(dims), origin=origin))


@dataclass
class ReconstructionResult:
    points: np.ndarray          # (M, 3) surface points (filtered, sampled)
    colors: np.ndarray          # (M, 3) float [0,1]
    normals: np.ndarray | None  # (M, 3) or None
    num_frames: int
    raw_surface_count: int


def fuse_frames(depths, colors, extrinsics, intr: PinholeIntrinsics,
                cfg: ReconstructionConfig, backend: str = "sparse",
                max_active: int | None = None, densify: bool = True):
    """Fuse a stacked frame batch into a TSDF volume.

    max_active=None sizes the active-block capacity to the batch (exact
    bound from the activity precompute, bucketed to limit recompiles).
    densify=False keeps sparse backends in block form (extraction can run
    directly on blocks — much faster for large grids).
    """
    depths = jnp.asarray(depths)
    colors = jnp.asarray(colors)
    extrinsics = jnp.asarray(extrinsics)
    if backend == "dense":
        dtype = jnp.bfloat16 if cfg.tsdf.use_bfloat16 else jnp.float32
        return integrate_frames(make_volume(cfg.tsdf, dtype), depths, colors,
                                extrinsics, intr)
    if backend != "sparse":
        raise ValueError(f"unknown backend {backend!r}: use sparse or dense")
    start = make_block_volume(cfg.tsdf)
    if max_active is None:
        max_active = auto_max_active(start, depths, extrinsics, intr)
    vol = integrate_frames_sparse(start, depths, colors, extrinsics, intr,
                                  max_active=max_active)
    return block_to_dense(vol) if densify else vol


def extract_filtered_cloud(vol, cfg: ReconstructionConfig,
                           seed: int = 0, capacity: int = 2_000_000,
                           z_filter: bool = True,
                           with_normals: bool = True) -> ReconstructionResult:
    """Surface extraction + uniform sampling + floor filter
    (reconstruct_rgbd_filter.py:119-134). Accepts dense or block volumes;
    block volumes extract sparsely (created blocks only)."""
    from otslam_tpu.kernels.marching import _pow2_bucket
    from otslam_tpu.kernels.tsdf_block import (
        BlockTSDFVolume, extract_surface_points_sparse)
    if isinstance(vol, BlockTSDFVolume):
        # size the block capacity to the volume: the 8192 default silently
        # truncates extraction block-major (= an x-cut through the cloud)
        # once the created set outgrows it — observed on an auto-sized
        # full_room table-group volume whose frustum sweep created ~20k
        # blocks
        nbk = max(int(jnp.sum(vol.created[:vol.num_blocks],
                              dtype=jnp.int32)), 1)
        out = extract_surface_points_sparse(
            vol, capacity=capacity, with_normals=with_normals,
            max_blocks=_pow2_bucket(nbk, 8192, 131072))
    else:
        out = extract_surface_points(vol, capacity=capacity,
                                     with_normals=with_normals)
    if with_normals:
        pts, cols, mask, normals = out
    else:
        pts, cols, mask = out
        normals = None
    raw_count = int(jnp.sum(mask))
    key = jax.random.PRNGKey(seed)
    sampled = resample_points(key, pts, mask, cfg.surface_samples,
                              colors=cols, normals=normals)
    s_pts, s_cols, s_nrm = sampled
    p = np.asarray(s_pts)
    c = np.asarray(s_cols)
    nrm = None if s_nrm is None else np.asarray(s_nrm)
    if z_filter:
        keep = p[:, 2] >= cfg.z_filter_threshold
        p, c = p[keep], c[keep]
        if nrm is not None:
            nrm = nrm[keep]
    return ReconstructionResult(p, c, nrm, 0, raw_count)


def reconstruct_object(ds: CaptureDataset, obj_name: str,
                       cfg: ReconstructionConfig | None = None,
                       backend: str = "sparse", save_dir: str | None = None,
                       z_filter: bool = True, seed: int = 0,
                       frame_numbers: Sequence[int] | None = None,
                       output: str = "cloud",
                       auto_origin: bool = False,
                       refine: str = "none",
                       auto_dims: bool | None = None) -> ReconstructionResult:
    """Full per-object pipeline; writes <save_dir>/<obj_name>.ply if asked.

    output='cloud': filtered sampled point cloud (reconstruct_rgbd_filter.py);
    output='mesh': welded triangle mesh with vertex normals
    (reconstruct_rgbd.py's extract_triangle_mesh + compute_vertex_normals).
    auto_origin=True centers the volume on the observed geometry per object.
    refine: trajectory refinement before fusing — 'none' trusts the dataset
    poses (the reference trusts TF), 'icp' chains frame-to-frame ICP
    corrections, 'f2m' tracks each frame against the accumulated TSDF, and
    'pgo' adds loop-closure edges with a pose-graph solve (the drift-robust
    default for long capture circles).
    """
    cfg = cfg or ReconstructionConfig()
    vol, batch = _fuse_object(ds, obj_name, cfg, backend, frame_numbers,
                              auto_origin, refine, auto_dims)
    if output == "mesh":
        from otslam_tpu.kernels.marching import extract_mesh
        verts, faces, cols, normals = extract_mesh(vol)
        res = ReconstructionResult(verts, cols, normals, len(batch.names),
                                   len(verts))
        if save_dir is not None:
            tio.write_ply(os.path.join(save_dir, f"{obj_name}.ply"),
                          verts, colors=cols, normals=normals, faces=faces)
        return res
    res = extract_filtered_cloud(vol, cfg, seed=seed, z_filter=z_filter)
    res.num_frames = len(batch.names)
    if save_dir is not None:
        tio.write_ply(os.path.join(save_dir, f"{obj_name}.ply"),
                      res.points, colors=res.colors, normals=res.normals)
    return res


def _fuse_object(ds: CaptureDataset, obj_name: str,
                 cfg: ReconstructionConfig, backend: str,
                 frame_numbers=None, auto_origin: bool = False,
                 refine: str = "none", auto_dims: bool | None = None):
    """Load + (optionally) refine + fuse one object; returns (vol, batch).
    Sparse backends stay in block form (extraction runs directly on created
    blocks)."""
    import dataclasses as _dc

    batch = ds.load_object(obj_name, frame_numbers)
    intr = PinholeIntrinsics.from_config(ds.camera)
    if auto_origin:
        import dataclasses as _dc

        if auto_dims is None or auto_dims:
            # also auto-sizes dims up to the observed extent (a merged
            # object group can exceed the configured volume — see
            # auto_volume_config); auto_dims=False pins the configured
            # dims (the sharded reconstruct paths' static-shape contract)
            cfg = auto_volume_config(batch, intr, cfg)
        else:
            cfg = _dc.replace(cfg, tsdf=_dc.replace(
                cfg.tsdf, origin=auto_volume_origin(batch, intr, cfg)))
    if refine != "none":
        from otslam_tpu.pipeline.refine import (
            refine_trajectory, refine_trajectory_f2m, refine_trajectory_pgo)
        fn = {"icp": refine_trajectory, "f2m": refine_trajectory_f2m,
              "pgo": refine_trajectory_pgo}[refine]
        refined = fn(batch.depths, batch.colors, batch.extrinsics, intr, cfg)
        batch = _dc.replace(batch, extrinsics=refined.extrinsics)
    vol = fuse_frames(batch.depths, batch.colors, batch.extrinsics, intr,
                      cfg, backend, densify=False)
    return vol, batch


def reconstruct_range(ds: CaptureDataset,
                      object_ranges: Mapping[str, tuple],
                      cfg: ReconstructionConfig | None = None,
                      backend: str = "sparse", save_dir: str | None = None,
                      **kw) -> dict:
    """Explicit frame ranges per object: {"Object_0": (1, 16), ...}
    (multi_reconstruct_rgbd_filter.py:23-32; ranges inclusive)."""
    out = {}
    for name, (lo, hi) in object_ranges.items():
        out[name] = reconstruct_object(
            ds, name, cfg, backend, save_dir,
            frame_numbers=range(lo, hi + 1), **kw)
    return out


def reconstruct_all(ds: CaptureDataset, cfg: ReconstructionConfig | None = None,
                    backend: str = "sparse", save_dir: str | None = None,
                    **kw) -> dict:
    """Reconstruct every object found in the dataset (main() loop).

    Multi-object mesh output on the block backend routes through ONE
    batched extraction dispatch (marching.extract_meshes_block): welding
    fetches every soup to the host anyway, so one dispatch and one fetch
    replace one per object."""
    names = ds.object_names()
    if (kw.get("output") == "mesh" and len(names) > 1
            and backend == "sparse"):
        return _reconstruct_all_mesh_batched(ds, names, cfg, backend,
                                             save_dir, **kw)
    return {name: reconstruct_object(ds, name, cfg, backend, save_dir, **kw)
            for name in ds.object_names()}


def _reconstruct_all_mesh_batched(ds, names, cfg, backend, save_dir,
                                  output="mesh", seed: int = 0,
                                  z_filter: bool = True,
                                  frame_numbers=None,
                                  auto_origin: bool = False,
                                  refine: str = "none",
                                  auto_dims: bool | None = None) -> dict:
    """Fuse each object, then extract every mesh in one batched dispatch.

    Triangles are bit-identical to the per-object path (extract_meshes_block
    contract; capacities are the max of the per-volume autos, and welding is
    capacity-independent)."""
    from otslam_tpu.kernels.marching import _weld_mesh, extract_meshes_block

    cfg = cfg or ReconstructionConfig()
    vols, batches = [], []
    for name in names:
        vol, batch = _fuse_object(ds, name, cfg, backend, frame_numbers,
                                  auto_origin, refine, auto_dims)
        vols.append(vol)
        batches.append(batch)
    out = {}
    # one batched dispatch per volume SHAPE (auto_volume_config can size
    # dims per object; batched extraction needs same-shape volumes)
    by_shape: dict = {}
    for i, v in enumerate(vols):
        by_shape.setdefault(v.grid_blocks, []).append(i)
    for idxs in by_shape.values():
        verts_b, cols_b, masks_b = extract_meshes_block(
            [vols[i] for i in idxs])
        for j, i in enumerate(idxs):
            name = names[i]
            verts, faces, cols, normals = _weld_mesh(verts_b[j], cols_b[j],
                                                     masks_b[j])
            res = ReconstructionResult(verts, cols, normals,
                                       len(batches[i].names), len(verts))
            if save_dir is not None:
                tio.write_ply(os.path.join(save_dir, f"{name}.ply"),
                              verts, colors=cols, normals=normals,
                              faces=faces)
            out[name] = res
    return out
