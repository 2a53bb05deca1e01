"""Nearest-neighbor distances between point clouds (chamfer-style).

Reproduces Open3D ``compute_point_cloud_distance`` (used by the eval
protocol, eval_table_chair.py:106-119) as a tiled brute-force search: the
distance matrix is never materialized. Source points form tiles of
``_SRC_TILE`` rows; each tile scans a contiguous range of ``_DST_CHUNK``-row
target chunks, computing ``dx^2 + dy^2 + dz^2`` directly in f32 and
carrying a running (min, argmin) with ties to the lowest index. A full scan
gives every tile all chunks; the radius-limited search (ICP's
correspondences) gives each tile only the chunks of the sorted target that
lie within the radius of its span.

Two implementations share that contract:

* ``_nn_min_plain`` — jax.numpy; the reference and the path off the GPU.
* ``_nn_min_triton`` — one Pallas kernel through Triton that keeps the
  distances and a per-(row, lane) running minimum in registers (the plain
  form writes each distance tile to device memory and reads it back).

``_resolve_impl`` is the one place that picks between them.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(3.0e38)
# masked target rows move here: their squared distance overflows to +inf,
# so they never win a min (and an all-masked target reports _BIG)
_FAR = 1.0e20

_SRC_TILE = 64     # source rows per tile (one kernel program)
_DST_CHUNK = 512   # target rows per window chunk
_KERNEL_BLOCK = 128  # target rows per kernel loop step

_IMPLS = ("auto", "plain", "triton", "interpret")


def _resolve_impl(impl: str) -> str:
    """The implementation that runs: "auto" takes the Triton kernel on a
    GPU and the plain search elsewhere. "triton" off the GPU is an error
    (nothing quietly interprets); "interpret" runs the kernel under the
    Pallas interpreter and exists for tests."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown NN impl {impl!r}: use one of {_IMPLS}")
    on_gpu = jax.default_backend() == "gpu"
    if impl == "auto":
        return "triton" if on_gpu else "plain"
    if impl == "triton" and not on_gpu:
        raise ValueError("the Triton NN kernel needs a GPU backend "
                         f"(have {jax.default_backend()!r}); use impl='plain'")
    return impl


def _pad_rows(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Pad (k, 3) to (n, 3) by repeating the last row: keeps a sorted
    coordinate monotone, so padded rows never widen a window."""
    return jnp.concatenate(
        [x, jnp.broadcast_to(x[-1:], (n - x.shape[0], 3))], axis=0)


def _nn_min_plain(srcp, dstp, starts, counts, chunk: int):
    """(best_d2, best_i) per padded source row. srcp (ntiles*_SRC_TILE, 3),
    dstp (nchunks*chunk, 3) with masked rows at _FAR; tile t scans chunks
    [starts[t], starts[t] + counts[t])."""
    ntiles = srcp.shape[0] // _SRC_TILE
    nchunks = dstp.shape[0] // chunk
    src_t = srcp.reshape(ntiles, _SRC_TILE, 3)
    dst_c = dstp.reshape(nchunks, chunk, 3)

    def body(j, carry):
        best_d, best_i = carry
        c = jnp.minimum(starts + j, nchunks - 1)               # (ntiles,)
        blk = jnp.take(dst_c, c, axis=0)                       # (T, C, 3)
        ex = src_t[:, :, None, 0] - blk[:, None, :, 0]
        ey = src_t[:, :, None, 1] - blk[:, None, :, 1]
        ez = src_t[:, :, None, 2] - blk[:, None, :, 2]
        d2 = ex * ex + ey * ey + ez * ez                       # (T, S, C)
        cmin = jnp.min(d2, axis=2)
        carg = jnp.argmin(d2, axis=2).astype(jnp.int32) + (c * chunk)[:, None]
        take = (j < counts)[:, None] & (cmin < best_d)
        return (jnp.where(take, cmin, best_d),
                jnp.where(take, carg, best_i))

    # the carry inherits the inputs' device-varying type (shard_map)
    zero = jnp.zeros((), jnp.float32) * srcp[0, 0] * dstp[0, 0]
    init = (jnp.full((ntiles, _SRC_TILE), jnp.inf) + zero,
            jnp.zeros((ntiles, _SRC_TILE), jnp.int32) + zero.astype(jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, jnp.max(counts), body, init)
    return best_d.reshape(-1), best_i.reshape(-1)


def _nn_kernel(start_ref, count_ref, sx_ref, sy_ref, sz_ref,
               dx_ref, dy_ref, dz_ref, bd_ref, bi_ref):
    """One source tile: loop over its target blocks with the running
    (min, block) kept per (row, lane) in registers — elementwise work only
    inside the loop; the lane reduction runs once at the end. K=3 is too
    thin for the tensor cores, and direct differences need no
    |a|^2+|b|^2-2ab cancellation fix, so the arithmetic runs on the CUDA
    cores in f32. Ties: a lane keeps its earliest block (strict <), and the
    final reduction takes the lowest index among the lanes at the min."""
    from jax.experimental import pallas as pl

    steps = _DST_CHUNK // _KERNEL_BLOCK
    b0 = start_ref[()] * steps
    sx, sy, sz = sx_ref[...], sy_ref[...], sz_ref[...]
    lane = jnp.arange(_KERNEL_BLOCK, dtype=jnp.int32)

    def body(k, carry):
        best_d, best_b = carry
        blk = b0 + k
        sl = pl.ds(pl.multiple_of(blk * _KERNEL_BLOCK, _KERNEL_BLOCK),
                   _KERNEL_BLOCK)
        ex = sx[:, None] - dx_ref[sl][None, :]
        ey = sy[:, None] - dy_ref[sl][None, :]
        ez = sz[:, None] - dz_ref[sl][None, :]
        d2 = ex * ex + ey * ey + ez * ez             # (_SRC_TILE, block)
        take = d2 < best_d
        return jnp.where(take, d2, best_d), jnp.where(take, blk, best_b)

    shape = (_SRC_TILE, _KERNEL_BLOCK)
    init = (jnp.full(shape, jnp.inf, jnp.float32),
            jnp.zeros(shape, jnp.int32))
    best_d, best_b = jax.lax.fori_loop(0, count_ref[()] * steps, body, init)
    cmin = jnp.min(best_d, axis=1)
    idx = best_b * _KERNEL_BLOCK + lane[None, :]
    bd_ref[...] = cmin
    bi_ref[...] = jnp.min(jnp.where(best_d == cmin[:, None], idx,
                                    jnp.iinfo(jnp.int32).max), axis=1)


def _nn_min_triton(srcp, dstp, starts, counts, interpret: bool = False):
    """The Pallas-Triton form of _nn_min_plain (chunk = _DST_CHUNK)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    npad, mpad = srcp.shape[0], dstp.shape[0]
    # outputs vary over the mesh axes the inputs vary over (shard_map)
    vma = frozenset().union(*(jax.typeof(x).vma
                              for x in (srcp, dstp, starts, counts)))
    tile = pl.BlockSpec((_SRC_TILE,), lambda i: (i,))
    scalar = pl.BlockSpec((None,), lambda i: (i,))
    whole = pl.BlockSpec((mpad,), lambda i: (0,))
    bd, bi = pl.pallas_call(
        _nn_kernel,
        grid=(npad // _SRC_TILE,),
        in_specs=[scalar, scalar, tile, tile, tile, whole, whole, whole],
        out_specs=[tile, tile],
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32, vma=vma),
                   jax.ShapeDtypeStruct((npad,), jnp.int32, vma=vma)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=8, num_stages=2),
        interpret=interpret,
        name="nn_min",
    )(starts, counts, srcp[:, 0], srcp[:, 1], srcp[:, 2],
      dstp[:, 0], dstp[:, 1], dstp[:, 2])
    return bd, bi


def _nn_search(src, dst, src_mask, dst_mask, with_index: bool, chunk: int,
               impl: str, window=None):
    """Shared front end: pad, place masked target rows out of reach, build
    the per-tile chunk ranges (all chunks, or `window` =
    (radius, window_chunks, axis) for the radius-limited search), run the
    chosen implementation, and mask the result."""
    impl = _resolve_impl(impl)
    n, m = src.shape[0], dst.shape[0]
    smask = jnp.ones(n, bool) if src_mask is None else src_mask
    if m == 0:
        # no dst at all: the same sentinel an all-masked dst produces
        dists = jnp.where(smask, jnp.sqrt(_BIG), 0.0)
        return (dists, jnp.zeros(n, jnp.int32)) if with_index else dists
    if impl != "plain":
        chunk = _DST_CHUNK
    dmask = jnp.ones(m, bool) if dst_mask is None else dst_mask
    mpad = -(-m // chunk) * chunk
    npad = -(-n // _SRC_TILE) * _SRC_TILE
    srcp = _pad_rows(src.astype(jnp.float32), npad)
    dstp = _pad_rows(dst.astype(jnp.float32), mpad)
    dvalid = jnp.arange(mpad) < m
    dvalid = dvalid & jnp.pad(dmask, (0, mpad - m))
    ntiles, nchunks = npad // _SRC_TILE, mpad // chunk

    starts = jnp.zeros(ntiles, jnp.int32)
    counts = jnp.full(ntiles, nchunks, jnp.int32)
    if window is not None:
        radius, n_win, axis = window
        # chunk ranges from the sort coordinate (before masking moves rows)
        sz = srcp[:, axis].reshape(ntiles, _SRC_TILE)
        dz = dstp[:, axis]
        c0 = jnp.searchsorted(dz[chunk - 1::chunk], jnp.min(sz, 1) - radius,
                              side="left")
        c1 = jnp.searchsorted(dz[::chunk], jnp.max(sz, 1) + radius,
                              side="right")
        # an unsorted target, or a tile needing more than window_chunks,
        # takes the full scan: results never depend on the window
        fit = jnp.all(dz[1:] >= dz[:-1]) & jnp.all(c1 - c0 <= n_win)
        starts = jnp.where(fit, c0, starts).astype(jnp.int32)
        counts = jnp.where(fit, jnp.maximum(c1 - c0, 0), counts)
        counts = counts.astype(jnp.int32)
    dstp = jnp.where(dvalid[:, None], dstp, _FAR)

    if impl == "plain":
        best_d, best_i = _nn_min_plain(srcp, dstp, starts, counts, chunk)
    else:
        best_d, best_i = _nn_min_triton(srcp, dstp, starts, counts,
                                        interpret=impl == "interpret")
    best_d, best_i = best_d[:n], best_i[:n]
    best_d = jnp.where(best_d >= 0.5 * _BIG, _BIG, best_d)
    dists = jnp.sqrt(jnp.where(smask, best_d, 0.0))
    if with_index:
        return dists, jnp.where(smask, best_i, 0)
    return dists


@partial(jax.jit, static_argnames=("chunk", "with_index", "impl"))
def nn_distance(src: jnp.ndarray, dst: jnp.ndarray,
                src_mask: jnp.ndarray | None = None,
                dst_mask: jnp.ndarray | None = None,
                chunk: int = 4096, with_index: bool = False,
                impl: str = "auto"):
    """For each src point, distance to (and optionally index of) the nearest
    dst point.

    src (N,3), dst (M,3); masks select valid rows (padded clouds). Invalid
    src rows get distance 0 and index 0 (mask them downstream); with no
    valid dst a point reports sqrt(3e38). Returns dists (N,) [, indices
    (N,)]. chunk: target rows per step of the plain search (the kernel uses
    its own blocks; results do not depend on it). impl: see _resolve_impl.
    """
    return _nn_search(src, dst, src_mask, dst_mask, with_index, chunk, impl)


@partial(jax.jit, static_argnames=("window_chunks", "axis", "with_index",
                                   "impl"))
def nn_distance_radius(src: jnp.ndarray, dst: jnp.ndarray, radius,
                       src_mask: jnp.ndarray | None = None,
                       dst_mask: jnp.ndarray | None = None,
                       window_chunks: int = 8, axis: int = 2,
                       with_index: bool = False, impl: str = "auto"):
    """nn_distance exact only within `radius`: for src points whose true NN
    is farther than radius, the returned distance is merely guaranteed
    >= the true distance (hence >= radius) and the index is that of some
    scanned point. This is the contract ICP needs — correspondences beyond
    the inlier threshold carry zero weight — and it lets each source tile
    scan only the dst chunks within the radius of its span instead of all
    of them.

    dst should be sorted ascending on coordinate `axis` and src at least
    tile-coherent on it (e.g. also sorted); neither is required for
    correctness — a traced fit flag takes the full scan whenever dst is
    unsorted or some tile's window exceeds window_chunks. Window chunks
    are _DST_CHUNK rows (auto_nn_window sizes in those units)."""
    return _nn_search(src, dst, src_mask, dst_mask, with_index, _DST_CHUNK,
                      impl, window=(jnp.asarray(radius, jnp.float32),
                                    window_chunks, axis))


def nn_window_bounds(dst, axis: int | None = None):
    """Host-side dst precompute for auto_nn_window: (axis, chunk_lo,
    chunk_hi, nchunks) of the sorted dst's per-chunk sort-coordinate
    bounds. Callers registering many scans against one FIXED cloud (e.g.
    ScanLocalizer) compute this once and pass it as dst_bounds."""
    d = np.asarray(dst, np.float32)
    if axis is None:
        axis = int(np.argmax(d.max(axis=0) - d.min(axis=0)))
    dc = _DST_CHUNK
    m = d.shape[0]
    zd = np.sort(d[:, axis])
    zd = np.pad(zd, (0, (-m) % dc), mode="edge")
    return axis, zd[::dc], zd[dc - 1::dc], -(-m // dc)


def auto_nn_window(src, dst, radius, axis: int | None = None,
                   margin: int = 1, round_to: int = 1,
                   dst_bounds=None) -> tuple[int, int]:
    """Host-side (window_chunks, axis) sizing for nn_distance_radius /
    icp(..., nn_window=...): picks the widest-spread dst coordinate and
    computes the exact per-tile chunk-window requirement for these concrete
    clouds (both sorted on that axis), plus a safety margin for the small
    pose motion ICP applies between iterations. The traced fit flag still
    guards the result, so an undersized window costs performance, never
    correctness. round_to > 1 rounds the window up to that multiple —
    callers issuing many similar ICP solves (frame chains, localization
    ticks) use it to collapse near-identical windows onto one jit cache
    entry (nn_window is a static argument). dst_bounds: precomputed
    nn_window_bounds(dst) for fixed target clouds (skips re-sorting dst
    per call); both clouds must be non-empty."""
    s = np.asarray(src, np.float32)
    if dst_bounds is None:
        dst_bounds = nn_window_bounds(dst, axis)
    axis, chunk_lo, chunk_hi, nchunks = dst_bounds
    ts = _SRC_TILE
    n = s.shape[0]
    zs = np.sort(s[:, axis])
    zs = np.pad(zs, (0, (-n) % ts), mode="edge").reshape(-1, ts)
    r = float(radius)
    c0 = np.searchsorted(chunk_hi, zs[:, 0] - r, side="left")
    c1 = np.searchsorted(chunk_lo, zs[:, -1] + r, side="right")
    need = int((c1 - c0).max()) if len(c0) else nchunks
    need = -(-(need + margin) // round_to) * round_to
    return min(need, nchunks), axis


@partial(jax.jit, static_argnames=("chunk",))
def chamfer_metrics(map_pts: jnp.ndarray, gt_pts: jnp.ndarray,
                    map_mask: jnp.ndarray | None = None,
                    gt_mask: jnp.ndarray | None = None,
                    chunk: int = 4096):
    """(accuracy, completeness) in meters: mean NN distance map->gt and
    gt->map over valid points (eval_table_chair.py:106-119; x100 for cm)."""
    d_mg = nn_distance(map_pts, gt_pts, map_mask, gt_mask, chunk=chunk)
    d_gm = nn_distance(gt_pts, map_pts, gt_mask, map_mask, chunk=chunk)
    mm = jnp.ones(map_pts.shape[0], bool) if map_mask is None else map_mask
    gm = jnp.ones(gt_pts.shape[0], bool) if gt_mask is None else gt_mask
    acc = jnp.sum(d_mg * mm) / jnp.maximum(jnp.sum(mm), 1)
    comp = jnp.sum(d_gm * gm) / jnp.maximum(jnp.sum(gm), 1)
    return acc, comp
