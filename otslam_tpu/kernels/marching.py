"""Triangle-mesh extraction from TSDF volumes (marching tetrahedra).

Open3D's ``extract_triangle_mesh`` (used at reconstruct_rgbd.py:112) runs
marching cubes in C++. This rebuild uses **marching tetrahedra**:
each surface cell splits into 6 tetrahedra whose 16 sign cases are derived
*programmatically* at import (no 256-entry lookup tables), and every case
emits 0-2 triangles with outward orientation. Downstream consumers only ever
use point clouds sampled from the mesh (reconstruct_rgbd_filter.py:123), so
the triangulation difference is irrelevant at the metric level while the
vertex set still lies exactly on the TSDF zero surface.

Shape: active cells (all 8 corners observed, mixed signs) are compacted
to a static capacity; per-cell work is fully vectorized one-hot selections +
lerps laid out cell-LAST (the cell axis rides the 128-lane dim — small-minor
layouts like (C, 6, 2, 3, 8) pay a 16x lane-padding tax in HBM); the
triangle soup is padded + masked, rows (T, 9) vertex-major. Vertex welding
happens host-side at save time (numpy unique on quantized vertices).
"""

from __future__ import annotations

from functools import partial
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np

from otslam_tpu.kernels.tsdf import TSDFVolume
from otslam_tpu.kernels.tsdf_block import (_corner_fields, _row_sets,
                                           compact_ids)


def _compact_ids_hier(active: jnp.ndarray, max_ids: int,
                      seg: int = 128) -> jnp.ndarray:
    """Two-level compact_ids for very long masks (the 16.6M-cell dense
    classification): top_k over per-`seg`-segment activity first, then over
    only the selected segments' cells. Same contract as ``compact_ids``
    (ascending active ids, padded with n); keeps the smallest ``max_ids``
    ids on overflow, exactly like the flat version (the smallest ids live
    in the smallest segments). A flat top_k over 16.6M keys costs ~39 ms
    on-chip; the segmented pass reduces the second top_k to
    min(max_ids, n/seg) * seg keys (~8x less at mesh-extraction sizes)."""
    n = active.shape[0]
    n_pad = -(-n // seg) * seg
    a2 = jnp.pad(active, (0, n_pad - n)).reshape(-1, seg)
    n_segs = a2.shape[0]
    if n_segs <= max_ids:          # degenerate: hierarchy cannot shrink it
        return compact_ids(active, max_ids, n)
    seg_ids = compact_ids(jnp.any(a2, axis=1), max_ids, n_segs)
    rows = jnp.take(a2, jnp.minimum(seg_ids, n_segs - 1), axis=0)
    rows = rows & (seg_ids < n_segs)[:, None]
    gids = (seg_ids[:, None] * seg
            + jnp.arange(seg, dtype=jnp.int32)[None, :])
    keys = jnp.where(rows, gids, n).reshape(-1)
    k = min(max_ids, keys.shape[0])
    out = -jax.lax.top_k(-keys, k)[0]
    if k < max_ids:
        out = jnp.pad(out, (0, max_ids - k), constant_values=n)
    # padded-tail gids can exceed n; remap every pad to exactly n
    return jnp.minimum(out, n).astype(jnp.int32)

# cube corner offsets (x, y, z), index = x*4? no — bit i: (x_i, y_i, z_i)
_CORNERS = np.array(list(product((0, 1), repeat=3)), np.int32)  # (8, 3), z fastest

# 6-tetrahedra decomposition of the cube sharing the main diagonal 0-7
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], np.int32)


def _build_tet_table():
    """For each of 16 inside/outside sign cases of a tetrahedron, the
    triangles as edge pairs: table (16, 2, 3, 2), -1 padded.

    A tet vertex is "inside" when tsdf < 0. Crossing edges connect inside
    to outside vertices; 1 or 3 inside vertices give one triangle, 2 give
    two (a quad). Winding is fixed afterwards using the TSDF gradient, so
    the table only records connectivity.
    """
    table = -np.ones((16, 2, 3, 2), np.int32)
    edges = [(a, b) for a in range(4) for b in range(a + 1, 4)]
    for case in range(16):
        inside = [v for v in range(4) if case & (1 << v)]
        outside = [v for v in range(4) if v not in inside]
        cross = [(a, b) for (a, b) in edges
                 if (a in inside) != (b in inside)]
        if len(inside) in (1, 3):
            # single triangle around the lone vertex
            lone = inside[0] if len(inside) == 1 else outside[0]
            tri = [e for e in cross if lone in e]
            assert len(tri) == 3
            table[case, 0] = np.array(tri)
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            # quad vertices in cyclic order: (a,c), (a,d), (b,d), (b,c)
            q = [tuple(sorted(e)) for e in
                 [(a, c), (a, d), (b, d), (b, c)]]
            table[case, 0] = np.array([q[0], q[1], q[2]])
            table[case, 1] = np.array([q[0], q[2], q[3]])
    return table


_TET_TABLE = _build_tet_table()  # (16, 2, 3, 2)


def _build_sel_onehot():
    """Static one-hot corner-selection tables for the per-cell phase.

    SEL[e][case, tet, tri, vtx, corner] = 1 where `corner` (cube corner
    0-7) is endpoint `e` of the crossing edge that produces triangle
    vertex (tet, tri, vtx) under sign case `case`. PRESENT[case, tri] = 1
    where the case emits that triangle. Selecting corner VALUES then
    becomes two einsums with 0/1 weights instead of per-cell
    take_along_axis chains (the gather formulation needed ~4M element
    gathers per 8k-cell extraction; the einsum contraction is a few
    hundred MFLOPs). Exact: every sum has at most one nonzero term.
    """
    sel = np.zeros((2, 16, 6, 2, 3, 8), np.float32)
    present = (_TET_TABLE[:, :, 0, 0] >= 0).astype(np.float32)  # (16, 2)
    for case in range(16):
        for s in range(6):
            for t in range(2):
                if _TET_TABLE[case, t, 0, 0] < 0:
                    continue
                for k in range(3):
                    for e in range(2):
                        tet_vtx = _TET_TABLE[case, t, k, e]
                        corner = _TETS[s, tet_vtx]
                        sel[e, case, s, t, k, corner] = 1.0
    return sel[0], sel[1], present


_SEL_A, _SEL_B, _TRI_PRESENT = _build_sel_onehot()


def _build_sel2():
    """Flattened cell-LAST variants of the selection tables, shaped for one
    (288, 96) @ (96, C) matmul per endpoint: row ((s*2+t)*3+k)*8+a,
    column s*16+n. Small minor dims on a (cells, ...)-major tensor pad out
    in tiled device layouts; keeping the cell axis
    last makes every per-cell tensor (small, C) — lane-dim C tiles
    perfectly."""
    sel2a = np.zeros((288, 96), np.float32)
    sel2b = np.zeros((288, 96), np.float32)
    pres2 = np.zeros((12, 96), np.float32)
    for s in range(6):
        for n in range(16):
            col = s * 16 + n
            for t in range(2):
                pres2[s * 2 + t, col] = _TRI_PRESENT[n, t]
                for k in range(3):
                    for a in range(8):
                        row = ((s * 2 + t) * 3 + k) * 8 + a
                        sel2a[row, col] = _SEL_A[n, s, t, k, a]
                        sel2b[row, col] = _SEL_B[n, s, t, k, a]
    return sel2a, sel2b, pres2


_SEL2_A, _SEL2_B, _PRES2 = _build_sel2()
# TSDF-gradient weights for winding: g_f = sum_v tv_v * (2*offset_vf - 1)/4
_GRAD_W = ((2.0 * _CORNERS - 1.0) / 4.0).astype(np.float32)   # (8, 3)


@partial(jax.jit, static_argnames=("max_cells",))
def extract_mesh_soup(vol: TSDFVolume, max_cells: int = 131072):
    """Marching-tetrahedra triangle soup.

    Returns (verts (T, 9), cols (T, 9), tri_mask (T,)) with
    T = max_cells * 12 (6 tets x up to 2 triangles) and rows vertex-major
    ([v0x v0y v0z v1x ... v2z]; reshape(-1, 3, 3) recovers triangles).
    Degenerate/absent triangles are masked out. Triangle winding: outward
    (toward tsdf > 0).
    """
    X, Y, Z = vol.dims
    t = vol.tsdf
    w = vol.weight

    # active cells: all 8 corners observed and not all on one side
    def corner(arr, dx, dy, dz):
        return arr[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]

    t_c = jnp.stack([corner(t, *c) for c in _CORNERS])    # (8, X-1, Y-1, Z-1)
    w_c = jnp.stack([corner(w, *c) for c in _CORNERS])
    observed = jnp.all(w_c > 0, axis=0)
    neg = t_c < 0
    mixed = jnp.any(neg, axis=0) & ~jnp.all(neg, axis=0)
    active = (observed & mixed).reshape(-1)
    # segmented top_k compaction: ascending active cell indices, then
    # sentinel pads remapped to 0 — same semantics as
    # nonzero(size=..., fill=0), touching the full mask once
    n_all = active.shape[0]
    cells = _compact_ids_hier(active, max_cells)
    cell_mask = jnp.arange(max_cells) < jnp.sum(active)
    cells = jnp.where(cell_mask, cells, 0)

    # decode cell -> corner voxel indices
    cy = (Y - 1)
    cz = (Z - 1)
    ci = cells // (cy * cz)
    cj = (cells // cz) % cy
    ck = cells % cz

    # per-cell corner tsdf/color and world positions, built cell-LAST
    # (see _soup_from_corners for the layout rationale)
    flat = t.reshape(-1)
    corner_flat = ((_CORNERS[:, None, 0] + ci[None, :]) * (Y * Z)
                   + (_CORNERS[:, None, 1] + cj[None, :]) * Z
                   + (_CORNERS[:, None, 2] + ck[None, :]))      # (8, C)
    tvT = jnp.take(flat, corner_flat)                           # (8, C)
    cf = vol.color.reshape(3, -1)
    cvT = jnp.stack([jnp.take(cf[c], corner_flat) for c in range(3)],
                    axis=1)                                     # (8, 3, C)
    baseT = jnp.stack([ci, cj, ck], axis=0).astype(jnp.float32)  # (3, C)
    posT = ((baseT[None, :, :] + _CORNERS.astype(np.float32)[:, :, None]
             + 0.5) * vol.voxel_size
            + jnp.asarray(vol.origin, jnp.float32)[None, :, None])  # (8,3,C)

    return _soup_from_corners(tvT, posT, cvT, cell_mask)


def _soup_from_corners(tvT, posT, cvT, cell_mask):
    """Per-cell marching-tetrahedra phase, shared by the dense and block
    paths. Inputs are cell-LAST: corner tsdf (8, C), world positions
    (8, 3, C), colors (8, 3, C); output is the masked triangle soup
    (verts (T, 9), cols (T, 9), tri_mask (T,)) with T = C*12 and rows laid
    out vertex-major ([v0x v0y v0z v1x ... v2z], triangle t = cell*12 +
    tet*2 + tri).

    Layout rationale: a cells-major (C, 6, 2, 3, 8) intermediate has an
    8-wide minor dim that tiled device layouts pad out. With the cell axis
    last every intermediate is (small, C), and the corner
    selection collapses to one (288, 96) @ (96, C) matmul per edge
    endpoint. The selections are exact (one-hot 0/1 weights, at most one
    nonzero term per sum), so results are bit-identical to gathers."""
    C = tvT.shape[1]
    tet_t = tvT[np.asarray(_TETS)]                              # (6, 4, C)
    bits = (tet_t < 0).astype(jnp.int32)
    case = (bits[:, 0] + bits[:, 1] * 2 + bits[:, 2] * 4
            + bits[:, 3] * 8)                                   # (6, C)

    # one-hot over (tet, case) rows -> (96, C); selection tables contract
    # it as a matmul (0/1 values are exact at any matmul precision)
    oh2 = (case[:, None, :]
           == jnp.arange(16, dtype=case.dtype)[None, :, None])  # (6, 16, C)
    oh2 = oh2.astype(jnp.float32).reshape(96, C)
    hi = jax.lax.Precision.HIGHEST
    wa = jnp.dot(jnp.asarray(_SEL2_A), oh2, precision=hi)       # (288, C)
    wb = jnp.dot(jnp.asarray(_SEL2_B), oh2, precision=hi)
    present = jnp.dot(jnp.asarray(_PRES2), oh2, precision=hi) > 0.5  # (12, C)

    # all per-corner channels in one stack: tsdf, world position, color;
    # endpoint values select with exactly one nonzero weight per (row, c),
    # so HIGHEST precision keeps them bit-exact f32 (a reduced-precision
    # product would round the value operand)
    vals = jnp.concatenate([tvT[:, None, :], posT, cvT], axis=1)  # (8, 7, C)
    va = jnp.einsum("wac,afc->wfc", wa.reshape(36, 8, C), vals,
                    precision=hi)                               # (36, 7, C)
    vb = jnp.einsum("wac,afc->wfc", wb.reshape(36, 8, C), vals,
                    precision=hi)
    ta, pa, ca = va[:, 0], va[:, 1:4], va[:, 4:7]
    tb, pb, cb = vb[:, 0], vb[:, 1:4], vb[:, 4:7]

    denom = ta - tb                                             # (36, C)
    frac = ta / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    frac = jnp.clip(frac, 0.0, 1.0)[:, None, :]                 # (36, 1, C)
    verts = pa + (pb - pa) * frac                               # (36, 3, C)
    cols = jnp.clip((ca + (cb - ca) * frac) / 255.0, 0.0, 1.0)

    # fix winding so normals point toward positive tsdf (outward): compare
    # each triangle's geometric normal with the cell's trilinear TSDF
    # gradient, g_f = sum_v tv_v * (2*offset_vf - 1) / 4
    vK = verts.reshape(12, 3, 3, C)                             # (st, vtx, f, C)
    cK = cols.reshape(12, 3, 3, C)
    n_geom = jnp.cross(vK[:, 1] - vK[:, 0], vK[:, 2] - vK[:, 0],
                       axis=1)                                  # (12, 3, C)
    gdir = jnp.einsum("vc,vf->fc", tvT, jnp.asarray(_GRAD_W),
                      precision=hi)                             # (3, C)
    flip = jnp.einsum("sfc,fc->sc", n_geom, gdir,
                      precision=hi) < 0                         # (12, C)
    swap = np.asarray([0, 2, 1])
    v1 = jnp.where(flip[:, None, None, :], vK[:, swap], vK)
    c1 = jnp.where(flip[:, None, None, :], cK[:, swap], cK)

    tri_mask = (present & cell_mask[None, :]).T.reshape(-1)     # (C*12,)
    v_out = v1.reshape(12, 9, C).transpose(2, 0, 1).reshape(-1, 9)
    c_out = c1.reshape(12, 9, C).transpose(2, 0, 1).reshape(-1, 9)
    return (v_out, c_out, tri_mask)


@jax.jit
def _count_active_cells(vol: TSDFVolume):
    """Number of surface cells (all 8 corners observed, mixed signs) — the
    exact required extract_mesh_soup capacity."""
    X, Y, Z = vol.dims
    t = vol.tsdf
    w = vol.weight

    def corner(arr, dx, dy, dz):
        return arr[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]

    t_c = jnp.stack([corner(t, *c) for c in _CORNERS])
    w_c = jnp.stack([corner(w, *c) for c in _CORNERS])
    observed = jnp.all(w_c > 0, axis=0)
    neg = t_c < 0
    mixed = jnp.any(neg, axis=0) & ~jnp.all(neg, axis=0)
    return jnp.sum(observed & mixed, dtype=jnp.int32)


def auto_max_cells(vol: TSDFVolume, cap: int = 131072) -> int:
    """Exact surface-cell capacity rounded up to a power of two (few
    recompiles across volumes). The per-cell phase (corner gathers, lerps,
    winding) and the host-ward soup transfer scale with the STATIC capacity,
    not the active count — a 256^3 scan-circle volume has ~6-10k surface
    cells, so the 131072 default wastes ~20x device time and ~100 MB of
    fetch (measured 0.45 s of a 0.52 s extraction)."""
    n = max(int(_count_active_cells(vol)), 1)
    b = 1024
    while b < n:
        b *= 2
    return min(b, cap)


# --- block-sparse marching tetrahedra --------------------------------------
# Mesh extraction directly from a BlockTSDFVolume: touches only created
# blocks (plus halo rows from their +axis/+diagonal neighbors), so cost
# scales with the surface, not the grid — the 256^3 dense sweep classifies
# 16.6M cells where a scan-circle object has ~2k created blocks (~1M cells).
# Bit-identical triangles to extract_mesh_soup(block_to_dense(vol)) up to
# soup order (cells compact block-major here, x-major there); tested.

_BLK_OFFS = tuple((ox, oy, oz) for ox in (0, 1) for oy in (0, 1)
                  for oz in (0, 1) if (ox, oy, oz) != (0, 0, 0))


def _block_halo_ids(grid_blocks, nb, ids):
    """Per +offset combination, the neighbor block id of each compacted id
    (the dead row nb at grid boundaries and for padding ids)."""
    bx, by, bz = grid_blocks
    ix = ids // (by * bz)
    iy = (ids // bz) % by
    iz = ids % bz
    ok0 = ids < nb
    out = {}
    for (ox, oy, oz) in _BLK_OFFS:
        ok = ok0 & (ix + ox < bx) & (iy + oy < by) & (iz + oz < bz)
        out[(ox, oy, oz)] = jnp.where(ok, ids + ox * by * bz + oy * bz + oz,
                                      nb)
    return out


def _block_active_cells(vol, max_blocks: int):
    """Compacted created-block ids, their halo ids, the (8, M, 512) tsdf
    corner fields, and the flat (M*512,) active-cell mask."""
    nb = vol.num_blocks
    ids = compact_ids(vol.created[:nb], max_blocks, nb)
    halo = _block_halo_ids(vol.grid_blocks, nb, ids)
    t8 = _corner_fields(_row_sets(vol.tsdf, ids, halo))
    w8 = _corner_fields(_row_sets(vol.weight, ids, halo))
    # padding entries alias the dead row; keep self-contained even if a
    # caller dirtied it (mirrors extract_surface_points_sparse)
    valid = (ids < nb)[:, None]
    observed = jnp.all(w8 > 0, axis=0) & valid
    neg = t8 < 0
    mixed = jnp.any(neg, axis=0) & ~jnp.all(neg, axis=0)
    return ids, halo, t8, (observed & mixed).reshape(-1)


def _cell_values(field8, mi, oh):
    """(8, C) per-cell corner values: row-gather each corner field at the
    cells' block rows, then select the intra-block lane with a shared
    one-hot multiply-reduce (exact: 0/1 weights, one nonzero per sum).
    field8 (8, M, 512); mi (C,) compacted-block row per cell; oh (C, 512)
    one-hot of the cell's intra-block voxel index.

    Per-corner loop: one (C, 512) gather + fused reduce per corner beat
    both the bulk (8*M, 512)-row gather (6.95 vs 5.32 ms/extract on-chip
    at the cv stage) and flat element gathers (5.94) — smaller gathers
    pipeline against the reduction."""
    hi = jax.lax.Precision.HIGHEST
    outs = [jnp.einsum("cl,cl->c", jnp.take(field8[k], mi, axis=0), oh,
                       precision=hi)
            for k in range(field8.shape[0])]
    return jnp.stack(outs)


@partial(jax.jit, static_argnames=("max_blocks", "max_cells"))
def extract_mesh_soup_block(vol, max_blocks: int = 4096,
                            max_cells: int = 32768, origin=None):
    """Marching-tetrahedra triangle soup from a BlockTSDFVolume.

    Same contract as ``extract_mesh_soup`` (verts (T, 9), cols (T, 9),
    tri_mask (T,), T = max_cells * 12, rows vertex-major); triangles are
    identical to the densified path's as a set (soup order is
    block-major).

    origin: optional traced (3,) world origin overriding ``vol.origin`` —
    lets the batched path vmap over per-volume origins while keeping the
    arithmetic (and thus the output bits) identical to the single path."""
    from otslam_tpu.kernels.tsdf_block import BLOCK, BLOCK_VOXELS

    bx, by, bz = vol.grid_blocks
    V = BLOCK_VOXELS
    ids, halo, t8, active = _block_active_cells(vol, max_blocks)

    # seg=32: at block-path sizes (M*512 ~ 1M cells, max_cells ~ 8k) the
    # default seg=128 leaves n_segs <= max_ids, degenerating to a flat
    # argsort over the full million keys; 32 keeps the hierarchy engaged
    cells = _compact_ids_hier(active, max_cells, seg=32)
    cell_mask = jnp.arange(max_cells) < jnp.sum(active)
    cells = jnp.where(cell_mask, cells, 0)

    # decode cell -> global base voxel (cell-last layout throughout)
    mi = cells // V
    l = cells % V
    lx = l // (BLOCK * BLOCK)
    ly = (l // BLOCK) % BLOCK
    lz = l % BLOCK
    bid = jnp.take(ids, mi)                 # padded cells decode row 0: masked
    ix = bid // (by * bz)
    iy = (bid // bz) % by
    iz = bid % bz
    baseT = jnp.stack([ix * BLOCK + lx, iy * BLOCK + ly, iz * BLOCK + lz],
                      axis=0).astype(jnp.float32)               # (3, C)
    org = (jnp.asarray(vol.origin, jnp.float32) if origin is None
           else jnp.asarray(origin, jnp.float32))
    posT = ((baseT[None, :, :] + _CORNERS.astype(np.float32)[:, :, None]
             + 0.5) * vol.voxel_size + org[None, :, None])      # (8, 3, C)

    oh = jax.nn.one_hot(l, V, dtype=jnp.float32)                # (C, 512)
    tvT = _cell_values(t8, mi, oh)                              # (8, C)
    cvT = jnp.stack(
        [_cell_values(_corner_fields(_row_sets(
            vol.color[:, c * V:(c + 1) * V], ids, halo)), mi, oh)
         for c in range(3)], axis=1)                            # (8, 3, C)
    return _soup_from_corners(tvT, posT, cvT, cell_mask)


@partial(jax.jit, static_argnames=("grid_blocks", "voxel_size",
                                   "max_blocks", "max_cells"))
def _extract_meshes_flat(tsdf, weight, color, created, origins,
                         grid_blocks, voxel_size,
                         max_blocks: int, max_cells: int):
    """Batched extraction of B same-shape volumes as ONE flat problem.

    The volumes' block rows concatenate into a global row space (each
    volume keeps its own dead row), so every heavy stage — corner fields,
    cell gathers, soup math — runs UNBATCHED over B*max_blocks rows /
    B*max_cells cells. vmapping the single-volume path instead lowers the
    gathers and contractions to batched variants that measured 2.1x
    slower per volume on-chip (12.54 vs 5.92 ms at B=8, 256^3 volumes).
    Only the per-volume compactions stay vmapped (sub-ms). Bit-identical
    per volume to extract_mesh_soup_block: same compacted cells, same
    arithmetic — the global row offset cancels in every decode."""
    from otslam_tpu.kernels.tsdf_block import BLOCK, BLOCK_VOXELS

    bx, by, bz = grid_blocks
    V = BLOCK_VOXELS
    B, rows_per = tsdf.shape[0], tsdf.shape[1]
    nb = rows_per - 1
    mb, mc = max_blocks, max_cells

    ids = jax.vmap(lambda m: compact_ids(m[:nb], mb, nb))(created)  # (B, mb)
    halo = _block_halo_ids(grid_blocks, nb, ids)   # elementwise: (B, mb) each
    off = (jnp.arange(B, dtype=ids.dtype) * rows_per)[:, None]
    gids = (ids + off).reshape(-1)                 # volume b's dead row stays
    ghalo = {k: (v + off).reshape(-1) for k, v in halo.items()}  # b's own

    tf = tsdf.reshape(B * rows_per, V)
    wf = weight.reshape(B * rows_per, V)
    t8 = _corner_fields(_row_sets(tf, gids, ghalo))   # (8, B*mb, 512)
    w8 = _corner_fields(_row_sets(wf, gids, ghalo))
    valid = (ids < nb).reshape(-1)[:, None]
    observed = jnp.all(w8 > 0, axis=0) & valid
    neg = t8 < 0
    mixed = jnp.any(neg, axis=0) & ~jnp.all(neg, axis=0)
    active = (observed & mixed).reshape(B, mb * V)

    counts = jnp.sum(active, axis=1)
    cells = jax.vmap(lambda a: _compact_ids_hier(a, mc, seg=32))(active)
    cmask = jnp.arange(mc)[None, :] < counts[:, None]             # (B, mc)
    cells = jnp.where(cmask, cells, 0)
    gcells = (cells
              + (jnp.arange(B, dtype=cells.dtype) * (mb * V))[:, None]
              ).reshape(-1)                                       # (B*mc,)

    mi = gcells // V                  # global compacted-row index [0, B*mb)
    l = gcells % V
    lx = l // (BLOCK * BLOCK)
    ly = (l // BLOCK) % BLOCK
    lz = l % BLOCK
    vidx = mi // mb
    bid = jnp.take(gids, mi) - vidx * rows_per        # volume-local block id
    ix = bid // (by * bz)
    iy = (bid // bz) % by
    iz = bid % bz
    baseT = jnp.stack([ix * BLOCK + lx, iy * BLOCK + ly, iz * BLOCK + lz],
                      axis=0).astype(jnp.float32)                 # (3, C)
    orgT = jnp.take(jnp.asarray(origins, jnp.float32), vidx, axis=0).T
    posT = ((baseT[None, :, :] + _CORNERS.astype(np.float32)[:, :, None]
             + 0.5) * voxel_size + orgT[None, :, :])              # (8, 3, C)

    oh = jax.nn.one_hot(l, V, dtype=jnp.float32)
    tvT = _cell_values(t8, mi, oh)
    cf = color.reshape(B * rows_per, 3 * V)
    cvT = jnp.stack(
        [_cell_values(_corner_fields(_row_sets(
            cf[:, c * V:(c + 1) * V], gids, ghalo)), mi, oh)
         for c in range(3)], axis=1)
    verts, cols, mask = _soup_from_corners(tvT, posT, cvT,
                                           cmask.reshape(-1))
    T = mc * 12
    return (verts.reshape(B, T, 9), cols.reshape(B, T, 9),
            mask.reshape(B, T))


@partial(jax.jit, static_argnames=("grid_blocks", "voxel_size",
                                   "max_blocks", "max_cells"))
def _extract_meshes_lists(tsdfs, weights, colors, createds, origins,
                          grid_blocks, voxel_size,
                          max_blocks: int, max_cells: int):
    """One-dispatch batched extraction from per-volume arrays.

    Keeps the whole call ONE dispatch WITHOUT stacking the full volumes
    in-graph: stacking tsdf/weight/color into (B, rows, V) first is, at
    256^3 x B=8, ~2.7 GB of pure device-memory copy before the row gathers
    touch only ~mb rows per volume — the reason the batched path lost to
    back-to-back
    single dispatches (41/s vs 55-60/s on-chip). Here each volume's
    compacted row sets gather from its OWN arrays and only those (B*mb,
    512) row sets concatenate into the flat problem; the decode below is
    _extract_meshes_flat's, so triangles stay bit-identical to
    extract_mesh_soup_block per volume."""
    from otslam_tpu.kernels.tsdf_block import BLOCK, BLOCK_VOXELS

    bx, by, bz = grid_blocks
    V = BLOCK_VOXELS
    B = len(tsdfs)
    rows_per = tsdfs[0].shape[0]
    nb = rows_per - 1
    mb, mc = max_blocks, max_cells

    ids_list, rows_t, rows_w, rows_c = [], [], [], []
    for b in range(B):
        ids_b = compact_ids(createds[b][:nb], mb, nb)
        halo_b = _block_halo_ids(grid_blocks, nb, ids_b)
        ids_list.append(ids_b)
        rows_t.append(_row_sets(tsdfs[b], ids_b, halo_b))
        rows_w.append(_row_sets(weights[b], ids_b, halo_b))
        rows_c.append([_row_sets(colors[b][:, c * V:(c + 1) * V], ids_b,
                                 halo_b) for c in range(3)])

    def cat(dicts):
        return {k: jnp.concatenate([d[k] for d in dicts])
                for k in dicts[0]}

    ids = jnp.stack(ids_list)                                  # (B, mb)
    t8 = _corner_fields(cat(rows_t))                           # (8, B*mb, 512)
    w8 = _corner_fields(cat(rows_w))
    valid = (ids < nb).reshape(-1)[:, None]
    observed = jnp.all(w8 > 0, axis=0) & valid
    neg = t8 < 0
    mixed = jnp.any(neg, axis=0) & ~jnp.all(neg, axis=0)
    active = (observed & mixed).reshape(B, mb * V)

    counts = jnp.sum(active, axis=1)
    cells = jax.vmap(lambda a: _compact_ids_hier(a, mc, seg=32))(active)
    cmask = jnp.arange(mc)[None, :] < counts[:, None]          # (B, mc)
    cells = jnp.where(cmask, cells, 0)
    gcells = (cells
              + (jnp.arange(B, dtype=cells.dtype) * (mb * V))[:, None]
              ).reshape(-1)                                    # (B*mc,)

    mi = gcells // V                  # global compacted-row index [0, B*mb)
    l = gcells % V
    lx = l // (BLOCK * BLOCK)
    ly = (l // BLOCK) % BLOCK
    lz = l % BLOCK
    vidx = mi // mb
    bid = jnp.take(ids.reshape(-1), mi)               # volume-local block id
    ix = bid // (by * bz)
    iy = (bid // bz) % by
    iz = bid % bz
    baseT = jnp.stack([ix * BLOCK + lx, iy * BLOCK + ly, iz * BLOCK + lz],
                      axis=0).astype(jnp.float32)              # (3, C)
    orgT = jnp.take(jnp.asarray(origins, jnp.float32), vidx, axis=0).T
    posT = ((baseT[None, :, :] + _CORNERS.astype(np.float32)[:, :, None]
             + 0.5) * voxel_size + orgT[None, :, :])           # (8, 3, C)

    oh = jax.nn.one_hot(l, V, dtype=jnp.float32)
    tvT = _cell_values(t8, mi, oh)
    cvT = jnp.stack(
        [_cell_values(_corner_fields(cat([rc[c] for rc in rows_c])), mi, oh)
         for c in range(3)], axis=1)
    verts, cols, mask = _soup_from_corners(tvT, posT, cvT,
                                           cmask.reshape(-1))
    T = mc * 12
    return (verts.reshape(B, T, 9), cols.reshape(B, T, 9),
            mask.reshape(B, T))


@partial(jax.jit, static_argnames=("max_blocks",))
def _count_active_cells_block(vol, max_blocks: int):
    return jnp.sum(_block_active_cells(vol, max_blocks)[3], dtype=jnp.int32)


def _pow2_bucket(n: int, lo: int, cap: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, cap)


def auto_mesh_block_config(vol, blocks_cap: int = 32768,
                           cells_cap: int = 131072,
                           max_cells: int | None = None):
    """(max_blocks, max_cells) sized to the volume (exact counts, bucketed
    to powers of two to limit recompiles) — the block-path analog of
    auto_max_cells."""
    nbk = max(int(jnp.sum(vol.created[:vol.num_blocks], dtype=jnp.int32)), 1)
    mb = _pow2_bucket(nbk, 256, blocks_cap)
    if max_cells is None:
        n = max(int(_count_active_cells_block(vol, mb)), 1)
        max_cells = _pow2_bucket(n, 1024, cells_cap)
    return mb, max_cells


def _validate_batch(vols, max_blocks=None, max_cells=None):
    """Shared checks for batched/sharded block extraction: the B volumes
    must be same-shape; capacities default to the max of the per-volume
    auto configs. Returns (max_blocks, max_cells)."""
    v0 = vols[0]
    for v in vols[1:]:
        if (v.grid_blocks != v0.grid_blocks
                or v.voxel_size != v0.voxel_size
                or v.sdf_trunc != v0.sdf_trunc):
            raise ValueError("batched extraction needs same-shape volumes")
    if max_blocks is None or max_cells is None:
        cfgs = [auto_mesh_block_config(v) for v in vols]
        max_blocks = max_blocks or max(mb for mb, _ in cfgs)
        max_cells = max_cells or max(mc for _, mc in cfgs)
    return max_blocks, max_cells


def batched_extract_setup(vols, max_blocks: int | None = None,
                          max_cells: int | None = None):
    """Shared setup for SHARDED block extraction (pre-staged stacks for
    shard_map): validates that the B volumes are same-shape, defaults
    capacities to the max of the per-volume auto configs, and returns
    ``(stacks, one, max_blocks, max_cells)`` where stacks = (tsdf (B,...),
    weight, color, created, origins (B,3)) and ``one(t, w, c, cr, o)``
    extracts a single volume's soup (vmap/shard over the leading axis).
    Single-dispatch batched callers should use ``extract_meshes_block``,
    which stacks in-graph instead."""
    from otslam_tpu.kernels.tsdf_block import BlockTSDFVolume

    v0 = vols[0]
    max_blocks, max_cells = _validate_batch(vols, max_blocks, max_cells)

    stacks = (jnp.stack([v.tsdf for v in vols]),
              jnp.stack([v.weight for v in vols]),
              jnp.stack([v.color for v in vols]),
              jnp.stack([v.created for v in vols]),
              jnp.asarray([v.origin for v in vols], jnp.float32))

    def one(t_, w_, c_, cr_, o_):
        vol = BlockTSDFVolume(t_, w_, c_, cr_, (0.0, 0.0, 0.0),
                              v0.voxel_size, v0.sdf_trunc, v0.grid_blocks)
        return extract_mesh_soup_block(vol, max_blocks, max_cells, origin=o_)

    return stacks, one, max_blocks, max_cells


def extract_meshes_block(vols, max_blocks: int | None = None,
                         max_cells: int | None = None):
    """Batched triangle soups for B same-shape BlockTSDFVolumes in ONE
    dispatch: (verts (B,T,9), cols (B,T,9), masks (B,T)).

    One dispatch and one fetch replace one per volume. The volumes run as
    ONE flat problem (see _extract_meshes_flat — faster per volume than
    vmapping the single path), and the B volumes' arrays are stacked
    IN-GRAPH so the whole call really is one dispatch. Volumes may have
    different
    origins (traced per cell — bit-identical to the single path); grid
    shape / voxel size / truncation must match. Capacities default to
    the max of the per-volume auto configs."""
    mb, mc = _validate_batch(vols, max_blocks, max_cells)
    v0 = vols[0]
    origins = np.asarray([v.origin for v in vols], np.float32)
    return _extract_meshes_lists(
        tuple(v.tsdf for v in vols), tuple(v.weight for v in vols),
        tuple(v.color for v in vols), tuple(v.created for v in vols),
        origins, grid_blocks=v0.grid_blocks, voxel_size=v0.voxel_size,
        max_blocks=mb, max_cells=mc)


def extract_mesh(vol, max_cells: int | None = None):
    """Host-side welded mesh: (vertices (V,3), faces (F,3), colors (V,3),
    normals (V,3)). Vertices quantized to 1e-5 m for welding.

    Accepts a dense TSDFVolume or a BlockTSDFVolume (extracted sparsely,
    created blocks only). max_cells None = auto (exact active-cell count,
    bucketed)."""
    if hasattr(vol, "grid_blocks"):         # block volume (duck-typed)
        mb, mc = auto_mesh_block_config(vol, max_cells=max_cells)
        verts, cols, mask = extract_mesh_soup_block(vol, mb, mc)
        return _weld_mesh(verts, cols, mask)
    if max_cells is None:
        max_cells = auto_max_cells(vol)
    verts, cols, mask = extract_mesh_soup(vol, max_cells)
    return _weld_mesh(verts, cols, mask)


def _weld_mesh(verts, cols, mask):
    """Host-side vertex welding of a masked (T, 9) triangle soup (1e-5 m
    quantization) into (vertices, faces, colors, normals)."""
    v = np.asarray(verts)[np.asarray(mask)].reshape(-1, 3)
    c = np.asarray(cols)[np.asarray(mask)].reshape(-1, 3)
    if len(v) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    key = np.round(v / 1e-5).astype(np.int64)
    uniq, index, inverse = np.unique(key, axis=0, return_index=True,
                                     return_inverse=True)
    vertices = v[index]
    colors = c[index]
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces (repeated welded vertices)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]
    # area-weighted vertex normals
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(normals, faces[:, k], n)
    ln = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(ln > 1e-12, ln, 1.0)
    return (vertices.astype(np.float32), faces, colors.astype(np.float32),
            normals.astype(np.float32))
