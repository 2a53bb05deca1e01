"""Block-sparse TSDF path vs the dense reference path."""

import jax.numpy as jnp
import numpy as np
import pytest

from otslam_tpu.config import TSDFConfig
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.kernels.tsdf import make_volume, integrate_frames, extract_surface_points
from otslam_tpu.kernels.tsdf_block import (
    make_block_volume, integrate_frames_sparse, block_to_dense, dense_to_block,
    BLOCK,
)

INTR = PinholeIntrinsics(width=64, height=48, fx=56.0, fy=56.0, cx=32.0, cy=24.0)
CFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 64),
                 origin=(-0.64, -0.64, -0.64))


def make_wall_frames(n=3):
    # depths chosen off the voxel grid so no voxel lands exactly on the
    # sdf == -trunc knife edge (where fma-fusion differences flip validity)
    depths, colors, exts = [], [], []
    for i in range(n):
        depths.append(np.full((48, 64), 0.4503 + 0.0301 * i, np.float32))
        colors.append(np.full((48, 64, 3), 100.0 + 10 * i, np.float32))
        exts.append(np.eye(4, dtype=np.float32))
    return (jnp.asarray(np.stack(depths)), jnp.asarray(np.stack(colors)),
            jnp.asarray(np.stack(exts)))


class TestBlockRoundtrip:
    def test_dense_block_dense(self):
        depths, colors, exts = make_wall_frames()
        dense = integrate_frames(make_volume(CFG), depths, colors, exts, INTR)
        block = dense_to_block(dense, CFG)
        back = block_to_dense(block)
        np.testing.assert_allclose(np.asarray(back.tsdf), np.asarray(dense.tsdf))
        np.testing.assert_allclose(np.asarray(back.weight), np.asarray(dense.weight))
        np.testing.assert_allclose(np.asarray(back.color), np.asarray(dense.color))


class TestSparseIntegration:
    def test_matches_dense_on_created_blocks(self):
        depths, colors, exts = make_wall_frames()
        dense = integrate_frames(make_volume(CFG), depths, colors, exts, INTR)
        sparse = integrate_frames_sparse(make_block_volume(CFG), depths, colors,
                                         exts, INTR, max_active=512)
        sd = block_to_dense(sparse)
        # wherever the sparse volume integrated, values must match dense exactly
        w_s = np.asarray(sd.weight)
        w_d = np.asarray(dense.weight)
        touched = w_s > 0
        assert touched.sum() > 1000
        np.testing.assert_allclose(np.asarray(sd.tsdf)[touched],
                                   np.asarray(dense.tsdf)[touched], atol=1e-5)
        np.testing.assert_array_equal(w_s[touched], w_d[touched])
        # every dense voxel in the truncation band must be covered by sparse
        t_d = np.asarray(dense.tsdf)
        band = (w_d > 0) & (np.abs(t_d) < 0.999)
        assert (w_s[band] > 0).all()

    def test_surface_extraction_agrees_with_dense(self):
        depths, colors, exts = make_wall_frames()
        dense = integrate_frames(make_volume(CFG), depths, colors, exts, INTR)
        sparse = integrate_frames_sparse(make_block_volume(CFG), depths, colors,
                                         exts, INTR, max_active=512)
        pts_d, _, m_d = extract_surface_points(dense, capacity=100_000)
        pts_s, _, m_s = extract_surface_points(block_to_dense(sparse),
                                               capacity=100_000)
        pd = np.asarray(pts_d)[np.asarray(m_d)]
        ps = np.asarray(pts_s)[np.asarray(m_s)]
        # same surface: identical point sets (order-independent)
        assert len(pd) == len(ps)
        pd_sorted = pd[np.lexsort(pd.T)]
        ps_sorted = ps[np.lexsort(ps.T)]
        np.testing.assert_allclose(pd_sorted, ps_sorted, atol=1e-5)

    def test_created_mask_is_sparse(self):
        depths, colors, exts = make_wall_frames()
        sparse = integrate_frames_sparse(make_block_volume(CFG), depths, colors,
                                         exts, INTR, max_active=512)
        frac = float(np.asarray(sparse.created[:-1]).mean())
        assert 0 < frac < 0.5  # far fewer blocks created than the full grid

    def test_dead_row_untouched(self):
        depths, colors, exts = make_wall_frames()
        sparse = integrate_frames_sparse(make_block_volume(CFG), depths, colors,
                                         exts, INTR, max_active=512)
        # compact_ids pads with the dead-row id, so integration scatters into
        # row nb mid-scan; the public result must restore it to zero (the
        # extraction/neighbor-read invariant) and never mark it created
        assert not bool(np.asarray(sparse.created[-1]))
        assert float(np.abs(np.asarray(sparse.tsdf[-1])).max()) == 0.0
        assert float(np.abs(np.asarray(sparse.weight[-1])).max()) == 0.0

    def test_dead_row_garbage_regression(self):
        """Regression: the dead row's phantom world coords (block index one
        past the +x grid edge) land on valid depth here, so pre-fix the
        padding entries scattered nonzero garbage into row nb and sparse
        extraction reported ~64 phantom crossings per padding entry."""
        from otslam_tpu.kernels.tsdf_block import extract_surface_points_sparse
        cfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(16, 16, 16),
                         origin=(-0.16, -0.16, 0.25))
        depths = jnp.full((2, 48, 64), 0.3503, jnp.float32)
        colors = jnp.full((2, 48, 64, 3), 128.0, jnp.float32)
        exts = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (2, 4, 4))
        sparse = integrate_frames_sparse(make_block_volume(cfg), depths,
                                         colors, exts, INTR, max_active=64)
        assert float(np.abs(np.asarray(sparse.weight[-1])).max()) == 0.0
        pts_d, _, m_d = extract_surface_points(block_to_dense(sparse),
                                               capacity=50_000)
        pts_s, _, m_s = extract_surface_points_sparse(
            sparse, capacity=50_000, max_blocks=64)
        assert int(np.asarray(m_d).sum()) == int(np.asarray(m_s).sum())


class TestSparseExtraction:
    def test_matches_dense_extraction(self):
        from otslam_tpu.kernels.tsdf_block import extract_surface_points_sparse
        depths, colors, exts = make_wall_frames()
        sparse = integrate_frames_sparse(make_block_volume(CFG), depths, colors,
                                         exts, INTR, max_active=512)
        pts_d, cols_d, m_d = extract_surface_points(block_to_dense(sparse),
                                                    capacity=100_000)
        pts_s, cols_s, m_s = extract_surface_points_sparse(
            sparse, capacity=100_000, max_blocks=512)
        pd = np.asarray(pts_d)[np.asarray(m_d)]
        ps = np.asarray(pts_s)[np.asarray(m_s)]
        assert len(pd) == len(ps)
        order_d = np.lexsort(pd.T)
        order_s = np.lexsort(ps.T)
        np.testing.assert_allclose(ps[order_s], pd[order_d], atol=1e-5)
        cd = np.asarray(cols_d)[np.asarray(m_d)][order_d]
        cs = np.asarray(cols_s)[np.asarray(m_s)][order_s]
        np.testing.assert_allclose(cs, cd, atol=1e-5)

    def test_normals_match_direction(self):
        from otslam_tpu.kernels.tsdf_block import extract_surface_points_sparse
        depths, colors, exts = make_wall_frames()
        sparse = integrate_frames_sparse(make_block_volume(CFG), depths, colors,
                                         exts, INTR, max_active=512)
        pts, cols, mask, normals = extract_surface_points_sparse(
            sparse, capacity=100_000, max_blocks=512, with_normals=True)
        nz = np.asarray(normals)[np.asarray(mask)][:, 2]
        assert np.mean(np.abs(nz) > 0.9) > 0.9


# ---------------------------------------------------------------------------
# block-sparse fusion vs the dense reference across fusion regimes
# ---------------------------------------------------------------------------

def _plane_scene(intr, depth, n=1):
    depths = np.full((n, intr.height, intr.width), depth, np.float32)
    colors = np.full((n, intr.height, intr.width, 3), 120.0, np.float32)
    exts = np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1))
    return depths, colors, exts


def _tilted_pair():
    th = 0.07
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                 [-np.sin(th), 0, np.cos(th)]]
    E[:3, 3] = [0.013, -0.021, 0.004]
    depths = np.stack([np.full((48, 64), 0.4503, np.float32),
                       np.full((48, 64), 0.5217, np.float32)])
    colors = np.stack([np.full((48, 64, 3), 100.0, np.float32),
                       np.full((48, 64, 3), 180.0, np.float32)])
    return depths, colors, np.stack([np.eye(4, dtype=np.float32), E])


def _circle_frames(intr, count, n=48):
    """Analytic 0.4 m cube seen from a capture circle (radius 1.2 m,
    z = 0.2): later poses see far-side blocks created by earlier ones at
    strong parallax — the skewed-block regime."""
    rays = np.asarray(intr.pixel_rays())
    lo, hi = np.array([-0.2, -0.2, 0.0]), np.array([0.2, 0.2, 0.4])
    depths, exts = [], []
    for i in range(count):
        ang = 2 * np.pi * i / n
        eye = np.array([1.2 * np.cos(ang), 1.2 * np.sin(ang), 0.2])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, 0.0, -1.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        dirs = rays @ R.T
        with np.errstate(divide="ignore", invalid="ignore"):
            t1, t2 = (lo - eye) / dirs, (hi - eye) / dirs
        tmin = np.minimum(t1, t2).max(-1)
        tmax = np.maximum(t1, t2).min(-1)
        depths.append(np.where((tmax > tmin) & (tmin > 0.1), tmin,
                               0.0).astype(np.float32))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, eye
        exts.append(np.linalg.inv(T).astype(np.float32))
    u = np.linspace(0, 255, intr.width, dtype=np.float32)
    colors = np.broadcast_to(u[None, None, :, None],
                             (count, intr.height, intr.width, 3)).copy()
    return np.stack(depths), colors, np.stack(exts)


def _random_batch(seed):
    """Smooth random depth fields with dropout holes, random colors and
    small random camera motion."""
    r = np.random.default_rng(seed)
    n = int(r.integers(3, 11))
    H, W = 48, 64
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    depths, exts = [], []
    for _ in range(n):
        fx, fy = r.uniform(1.0, 4.0, 2)
        ph = r.uniform(0, 2 * np.pi, 2)
        d = (0.5 + 0.08 * np.sin(2 * np.pi * fx * us / W + ph[0])
             * np.cos(2 * np.pi * fy * vs / H + ph[1])).astype(np.float32)
        d[r.random((H, W)) < 0.03] = 0.0
        depths.append(d)
        th = r.uniform(-0.12, 0.12)
        ax = r.integers(0, 3)
        i0, i1 = [k for k in range(3) if k != ax]
        E = np.eye(4, dtype=np.float32)
        E[i0, i0] = E[i1, i1] = np.cos(th)
        E[i0, i1], E[i1, i0] = -np.sin(th), np.sin(th)
        E[:3, 3] = r.uniform(-0.03, 0.03, 3)
        exts.append(E)
    colors = r.uniform(0, 255, (n, H, W, 3)).astype(np.float32)
    return np.stack(depths), colors, np.stack(exts)


_SMALL_CFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(32, 32, 32),
                        origin=(-0.32, -0.32, 0.2))


def _fusion_case(name):
    """(intr, cfg, depths, colors, extrinsics, resume_at) per regime;
    resume_at > 0 fuses the batch in two calls through one volume."""
    if name == "tilted_pair":
        return (INTR, _SMALL_CFG) + _tilted_pair() + (0,)
    if name == "gradient_color":
        d, c, e = _tilted_pair()
        c = np.broadcast_to(np.linspace(0, 255, 64, dtype=np.float32)
                            [None, None, :, None], c.shape).copy()
        return INTR, _SMALL_CFG, d, c, e, 0
    if name == "near_field":
        # depth plane at 0.3 m: the band creates blocks down to ~0.22 m,
        # each spanning ~145 rows of the 256-row image
        intr = PinholeIntrinsics(256, 256, 200.0, 200.0, 128.0, 128.0)
        cfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(32, 32, 32),
                         origin=(-0.32, -0.32, 0.1))
        return (intr, cfg) + _plane_scene(intr, 0.3) + (0,)
    if name == "width_320":
        intr = PinholeIntrinsics(320, 64, 280.0, 100.0, 160.5, 32.5)
        cfg = TSDFConfig(voxel_size=0.01, sdf_trunc=0.04, dims=(16, 16, 16),
                         origin=(0.06, -0.08, 0.40))
        d, c, e = _plane_scene(intr, 0.5)
        c = np.broadcast_to(np.linspace(0, 255, 320, dtype=np.float32)
                            [None, None, :, None], c.shape).copy()
        return intr, cfg, d, c, e, 0
    if name == "height_45":
        intr = PinholeIntrinsics(64, 45, 56.0, 56.0, 32.0, 22.5)
        return (intr, _SMALL_CFG) + _plane_scene(intr, 0.4503, 2) + (0,)
    if name in ("skewed_circle", "resume_circle"):
        intr = PinholeIntrinsics(160, 120, 141.4, 141.4, 80.5, 60.5)
        cfg = TSDFConfig(voxel_size=0.01, sdf_trunc=0.04, dims=(48, 48, 48),
                         origin=(-0.24, -0.24, -0.04))
        resume = 17 if name == "resume_circle" else 0
        return (intr, cfg) + _circle_frames(intr, 20) + (resume,)
    assert name.startswith("random")
    return (INTR, _SMALL_CFG) + _random_batch(int(name[6:])) + (0,)


def _created_voxels(vol):
    """(X, Y, Z) bool: voxels of created blocks."""
    bx, by, bz = vol.grid_blocks
    c = np.asarray(vol.created[:-1]).reshape(bx, by, bz)
    for ax in range(3):
        c = np.repeat(c, BLOCK, axis=ax)
    return c


class TestSparseVsDenseRegimes:
    """integrate_frames_sparse against the dense kernels/tsdf.py reference:
    every voxel of a created block carries exactly the dense weight, the
    same running-mean TSDF and colour, and every voxel in the dense
    truncation band lies in a created block. Colours are whole numbers, as
    8-bit images give them (the sparse path packs each pixel into 24
    bits)."""

    @pytest.mark.parametrize("name", [
        "tilted_pair", "gradient_color", "near_field", "width_320",
        "height_45", "skewed_circle", "resume_circle", "random11",
        "random23", "random47"])
    def test_matches_dense(self, name):
        from otslam_tpu.kernels.tsdf_block import auto_max_active
        intr, cfg, d, c, e, resume = _fusion_case(name)
        d, c, e = jnp.asarray(d), jnp.asarray(np.floor(c)), jnp.asarray(e)
        dense = integrate_frames(make_volume(cfg), d, c, e, intr)
        vol = make_block_volume(cfg)
        ma = auto_max_active(vol, d, e, intr, bucket=8)
        if resume:
            vol = integrate_frames_sparse(vol, d[:resume], c[:resume],
                                          e[:resume], intr, max_active=ma)
            d, c, e = d[resume:], c[resume:], e[resume:]
            ma = auto_max_active(vol, d, e, intr, bucket=8)
        sparse = integrate_frames_sparse(vol, d, c, e, intr, max_active=ma)
        sd = block_to_dense(sparse)
        cv = _created_voxels(sparse)
        w_s, w_d = np.asarray(sd.weight), np.asarray(dense.weight)
        assert (w_s[cv] > 0).sum() > 200, "regime must integrate real blocks"
        np.testing.assert_array_equal(w_s[cv], w_d[cv])
        seen = cv & (w_d > 0)
        np.testing.assert_allclose(np.asarray(sd.tsdf)[seen],
                                   np.asarray(dense.tsdf)[seen], atol=1e-5)
        np.testing.assert_allclose(np.asarray(sd.color)[:, seen],
                                   np.asarray(dense.color)[:, seen],
                                   atol=255e-5)
        band = (w_d > 0) & (np.abs(np.asarray(dense.tsdf)) < 0.999)
        assert cv[band].all()
        assert (w_s[~cv] == 0).all()


class TestCapacity:
    def test_auto_max_active_bounds_every_frame(self):
        import jax

        from otslam_tpu.kernels.tsdf_block import (_active_blocks,
                                                   auto_max_active)
        intr, cfg, d, c, e, _ = _fusion_case("skewed_circle")
        d, c, e = jnp.asarray(d), jnp.asarray(c), jnp.asarray(e)
        vol = make_block_volume(cfg)
        ma = auto_max_active(vol, d, e, intr, bucket=8)
        band, vis = jax.vmap(
            lambda dd, ee: _active_blocks(vol, dd, ee, intr))(d, e)
        created = jax.lax.associative_scan(jnp.logical_or, band, axis=0)
        per_frame = np.asarray(created & vis).sum(axis=1)
        assert ma >= per_frame.max() and ma % 8 == 0
        # a capacity that bounds every frame gives the same volume as one
        # covering the whole grid
        a = integrate_frames_sparse(make_block_volume(cfg), d, c, e, intr,
                                    max_active=ma)
        b = integrate_frames_sparse(make_block_volume(cfg), d, c, e, intr,
                                    max_active=vol.num_blocks)
        np.testing.assert_array_equal(np.asarray(a.weight),
                                      np.asarray(b.weight))
        np.testing.assert_array_equal(np.asarray(a.tsdf), np.asarray(b.tsdf))

    def test_cumulative_or_matches_scan(self):
        import jax

        from otslam_tpu.kernels.tsdf_block import _cumulative_or
        band = jnp.asarray(np.random.default_rng(3).random((37, 513)) < 0.1)
        ref = jax.lax.associative_scan(jnp.logical_or, band, axis=0)
        np.testing.assert_array_equal(np.asarray(_cumulative_or(band)),
                                      np.asarray(ref))
