"""Multi-device sharding of the fusion and eval workloads.

TSDF integration is an order-independent weighted sum (SURVEY.md §2.4), which
fixes the parallel decomposition:

* **data axis** — frames shard across devices; each device computes partial
  sums (sum_tw, sum_w, sum_cw) over its shard with the same scan kernel as
  single-device, and one ``psum`` merges them. Scaling is
  embarrassingly parallel; the all-reduce volume is the voxel grid, paid
  once per batch (not per frame).
* **model axis** — the voxel grid shards as X-slabs; every device integrates
  all its frames into its own slab (per-shard volume origin offset), with
  **zero** integrate-time communication. Combine with the data axis for a
  2-D (data x model) mesh: psum over 'data' only.

Everything uses ``shard_map`` over an explicit Mesh; collectives are XLA
psums, which XLA hands to NCCL on GPUs (NVLink between the cards of a
host).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from otslam_tpu.config import TSDFConfig
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.kernels.tsdf import TSDFVolume, merge_partials, partial_integrate
from otslam_tpu.kernels.nn import nn_distance


def fuse_frames_data_parallel(depths: jnp.ndarray, colors: jnp.ndarray,
                              extrinsics: jnp.ndarray,
                              intr: PinholeIntrinsics, cfg: TSDFConfig,
                              mesh: Mesh, data_axis: str = "data"
                              ) -> TSDFVolume:
    """Frame-sharded fusion: N frames split over the data axis, one psum.

    N must divide by the data-axis size. Bit-identical to the single-chip
    partial-sum path up to float reassociation of the reduce.
    """
    nd = mesh.shape[data_axis]
    n = depths.shape[0]
    if n % nd:
        raise ValueError(f"{n} frames not divisible by {nd} devices")

    def shard_fn(d, c, e):
        sum_tw, sum_w, sum_cw = partial_integrate(d, c, e, intr, cfg)
        sum_tw = jax.lax.psum(sum_tw, data_axis)
        sum_w = jax.lax.psum(sum_w, data_axis)
        sum_cw = jax.lax.psum(sum_cw, data_axis)
        return sum_tw, sum_w, sum_cw

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(data_axis), P(data_axis), P(data_axis)),
        out_specs=(P(), P(), P()))
    sum_tw, sum_w, sum_cw = jax.jit(mapped)(depths, colors, extrinsics)
    return merge_partials(sum_tw, sum_w, sum_cw, cfg)


def fuse_frames_2d_sharded(depths: jnp.ndarray, colors: jnp.ndarray,
                           extrinsics: jnp.ndarray,
                           intr: PinholeIntrinsics, cfg: TSDFConfig,
                           mesh: Mesh, data_axis: str = "data",
                           model_axis: str = "model") -> TSDFVolume:
    """2-D sharding: frames over 'data', voxel-grid X-slabs over 'model'.

    Each (data, model) device integrates its frame shard into its X-slab
    (slab-local volume origin), psums partials over 'data' only, and the
    full volume is reassembled from the slabs.
    """
    nd = mesh.shape[data_axis]
    nm = mesh.shape[model_axis]
    X, Y, Z = cfg.dims
    if X % nm:
        raise ValueError(f"X dim {X} not divisible by model axis {nm}")
    if depths.shape[0] % nd:
        raise ValueError("frames not divisible by data axis")
    slab_x = X // nm

    def shard_fn(d, c, e):
        m = jax.lax.axis_index(model_axis)
        # slab-local volume: same grid, origin shifted along X
        ox = cfg.origin[0] + m.astype(jnp.float32) * slab_x * cfg.voxel_size
        slab_cfg = dataclasses.replace(
            cfg, dims=(slab_x, Y, Z), origin=(0.0, cfg.origin[1], cfg.origin[2]))
        # partial_integrate needs a static origin; shift the *extrinsic*
        # instead: world' = world + (ox, 0, 0) => extrinsic' = E @ T(+ox)
        shift = jnp.eye(4, dtype=e.dtype).at[0, 3].set(ox)
        e_shift = jnp.einsum("nij,jk->nik", e, shift)
        d = d + jnp.zeros((), d.dtype) * ox  # make inputs model-varying too
        sum_tw, sum_w, sum_cw = partial_integrate(d, c, e_shift, intr, slab_cfg)
        sum_tw = jax.lax.psum(sum_tw, data_axis)
        sum_w = jax.lax.psum(sum_w, data_axis)
        sum_cw = jax.lax.psum(sum_cw, data_axis)
        return sum_tw, sum_w, sum_cw

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(data_axis), P(data_axis), P(data_axis)),
        out_specs=(P(model_axis), P(model_axis), P(None, model_axis)))
    sum_tw, sum_w, sum_cw = jax.jit(mapped)(depths, colors, extrinsics)
    return merge_partials(sum_tw, sum_w, sum_cw, cfg)


def fuse_frames_hierarchical(depths: jnp.ndarray, colors: jnp.ndarray,
                             extrinsics: jnp.ndarray,
                             intr: PinholeIntrinsics, cfg: TSDFConfig,
                             mesh: Mesh, dcn_axis: str = "dcn",
                             ici_axis: str = "ici") -> TSDFVolume:
    """Multi-host data parallelism over a 2-level (dcn, ici) mesh.

    Frames shard over BOTH axes (flat data parallelism); the partial-volume
    reduction is HIERARCHICAL: psum over the inner (``ici_axis``) axis
    first (cards within a host, NVLink), then over the outer (``dcn_axis``)
    one — so the slower cross-host network carries one already-reduced
    volume per host instead of one per card. On a multi-host cluster build
    the mesh with jax.experimental.mesh_utils.create_hybrid_device_mesh so
    the inner axis maps to intra-host links; the virtual-CPU tests exercise
    the same program structure.
    """
    ntotal = mesh.shape[dcn_axis] * mesh.shape[ici_axis]
    if depths.shape[0] % ntotal:
        raise ValueError(
            f"{depths.shape[0]} frames not divisible by {ntotal} devices")

    def shard_fn(d, c, e):
        p = partial_integrate(d, c, e, intr, cfg)
        p = jax.tree.map(lambda x: jax.lax.psum(x, ici_axis), p)
        p = jax.tree.map(lambda x: jax.lax.psum(x, dcn_axis), p)
        return p

    spec = P((dcn_axis, ici_axis))
    mapped = jax.shard_map(shard_fn, mesh=mesh,
                           in_specs=(spec, spec, spec),
                           out_specs=(P(), P(), P()))
    sum_tw, sum_w, sum_cw = jax.jit(mapped)(depths, colors, extrinsics)
    return merge_partials(sum_tw, sum_w, sum_cw, cfg)


def fuse_objects_parallel(depths: jnp.ndarray, colors: jnp.ndarray,
                          extrinsics: jnp.ndarray, origins: jnp.ndarray,
                          intr: PinholeIntrinsics, cfg: TSDFConfig,
                          mesh: Mesh, axis: str = "data"):
    """OBJECT-axis parallel fusion (SURVEY §2.4: frame- and object-parallel).

    depths (O, N, H, W), colors (O, N, H, W, 3), extrinsics (O, N, 4, 4),
    origins (O, 3): each device fuses the frames of its object shard into
    its own volume — embarrassingly parallel, ZERO integrate-time
    communication. Per-object volume placement uses the traced ``origins``
    via an extrinsic shift (the grid itself keeps cfg's static shape), so
    one compiled program serves every object.

    Returns (tsdf (O, X, Y, Z), weight (O, X, Y, Z), color (O, 3, X, Y, Z)),
    object-sharded over `axis`.
    """
    nd = mesh.shape[axis]
    if depths.shape[0] % nd:
        raise ValueError(
            f"{depths.shape[0]} objects not divisible by {nd} devices")
    base = jnp.asarray(cfg.origin, jnp.float32)

    def per_object(d, c, e, o):
        # world' = world - (o - base): voxel at cfg.origin + idx*vs in
        # world' sits at o + idx*vs in the true world
        shift = jnp.eye(4, dtype=e.dtype).at[:3, 3].set(
            (o - base).astype(e.dtype))
        e_shift = jnp.einsum("nij,jk->nik", e, shift)
        sum_tw, sum_w, sum_cw = partial_integrate(d, c, e_shift, intr, cfg)
        denom = jnp.maximum(sum_w, 1.0)
        return sum_tw / denom, sum_w, sum_cw / denom[None]

    def shard_fn(d, c, e, o):
        return jax.vmap(per_object)(d, c, e, o)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)))
    return jax.jit(mapped)(depths, colors, extrinsics, origins)


def reconstruct_all_sharded(ds, cfg, mesh: Mesh, axis: str = "data",
                            auto_origin: bool = True, **extract_kw) -> dict:
    """Object-sharded reconstruct_all: every object's fusion runs on its own
    device (one jitted dispatch for the whole dataset), then extraction +
    filtering runs per object exactly like pipeline.reconstruct_object.

    Frame counts pad to the dataset max with empty (depth 0) frames, which
    contribute nothing to the weighted sums — the fused VOLUMES match the
    serial dense path up to float reassociation of the partial-sum merge
    (asserted at atol 1e-4 in tests); the extracted clouds are then
    geometrically identical up to crossing-interpolation noise (tests
    assert max NN distance < 2 mm and surface-count within 1%; exact
    equality is not guaranteed because reassociation-level tsdf diffs can
    flip boundary crossings). The object list pads to the device count by
    repeating the last object (dropped on return).
    """
    import numpy as np

    from otslam_tpu.kernels.tsdf import TSDFVolume
    from otslam_tpu.pipeline.reconstruct import (auto_volume_origin,
                                                 extract_filtered_cloud)

    names = ds.object_names()
    if not names:
        return {}
    intr = PinholeIntrinsics.from_config(ds.camera)
    batches = {n: ds.load_object(n) for n in names}
    max_frames = max(b.depths.shape[0] for b in batches.values())
    nd = mesh.shape[axis]

    ds_list, cs_list, es_list, os_list = [], [], [], []
    for n in names:
        b = batches[n]
        k = b.depths.shape[0]
        pad = max_frames - k
        d = np.concatenate(
            [b.depths, np.zeros((pad,) + b.depths.shape[1:], np.float32)])
        c = np.concatenate(
            [b.colors, np.zeros((pad,) + b.colors.shape[1:], np.float32)])
        e = np.concatenate(
            [b.extrinsics,
             np.tile(np.eye(4, dtype=np.float32)[None], (pad, 1, 1))])
        origin = (auto_volume_origin(b, intr, cfg) if auto_origin
                  else cfg.tsdf.origin)
        ds_list.append(d)
        cs_list.append(c)
        es_list.append(e)
        os_list.append(origin)
    # pad the object axis to the device count (repeat last, drop on return)
    while len(ds_list) % nd:
        ds_list.append(ds_list[-1])
        cs_list.append(cs_list[-1])
        es_list.append(es_list[-1])
        os_list.append(os_list[-1])

    tsdf, weight, color = fuse_objects_parallel(
        jnp.asarray(np.stack(ds_list)), jnp.asarray(np.stack(cs_list)),
        jnp.asarray(np.stack(es_list)), jnp.asarray(np.stack(os_list),
                                                    jnp.float32),
        intr, cfg.tsdf, mesh, axis)

    out = {}
    for i, n in enumerate(names):
        vol = TSDFVolume(tsdf[i], weight[i], color[i],
                         tuple(float(x) for x in os_list[i]),
                         float(cfg.tsdf.voxel_size),
                         float(cfg.tsdf.sdf_trunc))
        res = extract_filtered_cloud(vol, cfg, **extract_kw)
        res.num_frames = int(batches[n].depths.shape[0])
        out[n] = res
    return out


def chamfer_data_parallel(src: jnp.ndarray, dst: jnp.ndarray, mesh: Mesh,
                          data_axis: str = "data", chunk: int = 2048):
    """Source points shard over devices; each finds NNs in the (replicated)
    target; mean distance reduced with one psum. src length must divide."""
    nd = mesh.shape[data_axis]
    if src.shape[0] % nd:
        raise ValueError("src points not divisible by data axis size")

    def shard_fn(s, d):
        dist = nn_distance(s, d, chunk=chunk)
        return jax.lax.psum(jnp.sum(dist), data_axis), jax.lax.psum(
            jnp.asarray(s.shape[0], jnp.float32), data_axis)

    mapped = jax.shard_map(shard_fn, mesh=mesh,
                           in_specs=(P(data_axis), P()), out_specs=(P(), P()))
    total, count = jax.jit(mapped)(src, dst)
    return total / count
