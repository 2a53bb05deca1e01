"""NN-distance and ICP kernels."""

import numpy as np
import jax.numpy as jnp
import pytest

from otslam_tpu.core.se3 import euler_xyz_to_matrix, se3
from otslam_tpu.kernels import nn as nn_mod
from otslam_tpu.kernels.nn import (auto_nn_window, chamfer_metrics,
                                   nn_distance, nn_distance_radius)
from otslam_tpu.kernels.icp import icp_point_to_point, icp_point_to_plane


class TestNN:
    def test_matches_bruteforce(self, rng):
        a = rng.standard_normal((300, 3)).astype(np.float32)
        b = rng.standard_normal((500, 3)).astype(np.float32)
        d, i = nn_distance(jnp.asarray(a), jnp.asarray(b), chunk=128,
                           with_index=True)
        full = np.linalg.norm(a[:, None] - b[None], axis=-1)
        np.testing.assert_allclose(np.asarray(d), full.min(1), atol=1e-3)
        np.testing.assert_array_equal(np.asarray(i), full.argmin(1))

    def test_masks(self, rng):
        a = rng.standard_normal((64, 3)).astype(np.float32)
        b = np.concatenate([a, np.full((64, 3), 100.0)]).astype(np.float32)
        bmask = np.arange(128) < 64
        d = nn_distance(jnp.asarray(a), jnp.asarray(b),
                        dst_mask=jnp.asarray(bmask), chunk=64)
        np.testing.assert_allclose(np.asarray(d), 0.0, atol=1e-3)
        # masked-out dst (identical garbage excluded): with mask inverted,
        # distances are large
        d2 = nn_distance(jnp.asarray(a), jnp.asarray(b),
                         dst_mask=jnp.asarray(~bmask), chunk=64)
        assert float(np.asarray(d2).min()) > 50

    def test_chamfer_symmetry(self, rng):
        a = rng.standard_normal((200, 3)).astype(np.float32)
        acc, comp = chamfer_metrics(jnp.asarray(a), jnp.asarray(a), chunk=64)
        assert float(acc) < 1e-3 and float(comp) < 1e-3


class TestICP:
    def test_point_to_point_recovers_pose(self, rng):
        src = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
        T_true = se3(euler_xyz_to_matrix(0.0, 0.0, 0.05), [0.03, -0.02, 0.01])
        dst = (src @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
        res = icp_point_to_point(jnp.asarray(src), jnp.asarray(dst),
                                 threshold=0.3, max_iterations=30, chunk=256)
        np.testing.assert_allclose(np.asarray(res.transformation), T_true,
                                   atol=2e-3)
        assert float(res.fitness) > 0.99
        assert float(res.inlier_rmse) < 5e-3

    def test_point_to_plane_recovers_pose(self, rng):
        # points on 3 orthogonal planes (well-constrained for p2plane)
        n_per = 400
        pts, nrms = [], []
        for axis in range(3):
            p = rng.uniform(-1, 1, (n_per, 3))
            p[:, axis] = 0.0
            nr = np.zeros((n_per, 3)); nr[:, axis] = 1.0
            pts.append(p); nrms.append(nr)
        dst = np.concatenate(pts).astype(np.float32)
        normals = np.concatenate(nrms).astype(np.float32)
        T_true = se3(euler_xyz_to_matrix(0.02, -0.01, 0.03), [0.02, 0.01, -0.03])
        src = ((dst - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
        res = icp_point_to_plane(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(normals), threshold=0.3,
                                 max_iterations=30, chunk=256)
        np.testing.assert_allclose(np.asarray(res.transformation), T_true,
                                   atol=5e-3)

    def test_identity_on_aligned(self, rng):
        src = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
        res = icp_point_to_point(jnp.asarray(src), jnp.asarray(src),
                                 threshold=0.1, max_iterations=10, chunk=256)
        np.testing.assert_allclose(np.asarray(res.transformation), np.eye(4),
                                   atol=1e-4)
        assert int(res.iterations) <= 3


class TestNNPallas:
    """The Pallas-Triton NN kernel (under the Pallas interpreter) against
    the plain XLA search: identical indices (ties to the lowest index) and
    distances."""

    def _pair(self, src, dst, **kw):
        got = nn_distance(jnp.asarray(src), jnp.asarray(dst), with_index=True,
                          impl="interpret", **kw)
        want = nn_distance(jnp.asarray(src), jnp.asarray(dst),
                           with_index=True, impl="plain", **kw)
        return [np.asarray(x) for x in got + want]

    def _full_scan_case(self, rng, n, m):
        src = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        dst = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
        d1, i1, d2, i2 = self._pair(src, dst)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, atol=1e-6)
        full = np.linalg.norm(src[:, None] - dst[None], axis=-1)
        np.testing.assert_array_equal(i1, full.argmin(1))

    def test_matches_xla_path(self, rng):
        self._full_scan_case(rng, 700, 900)

    @pytest.mark.parametrize("n,m", [(64, 1500), (130, 513)])
    def test_full_scan_matches_plain(self, rng, n, m):
        self._full_scan_case(rng, n, m)

    def test_masks_and_empty_dst(self, rng):
        src = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        dst = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
        dmask = jnp.asarray(np.arange(128) < 40)
        smask = jnp.asarray(rng.random(64) > 0.3)
        d1, i1, d2, i2 = self._pair(src, dst, dst_mask=dmask,
                                    src_mask=smask)
        np.testing.assert_array_equal(i1, i2)
        assert int(i1.max()) < 40
        np.testing.assert_allclose(d1, d2, atol=1e-6)
        assert (d1[~np.asarray(smask)] == 0).all()
        # fully-masked dst: the sentinel distance survives on both paths
        none = jnp.zeros(128, bool)
        d3, _, d4, _ = self._pair(src, dst, dst_mask=none)
        assert d3.min() > 1e18 and d4.min() > 1e18
        # no dst rows at all: the same sentinel, index 0
        empty = jnp.zeros((0, 3), jnp.float32)
        for impl in ("plain", "interpret"):
            d, i = nn_distance(jnp.asarray(src), empty, with_index=True,
                               impl=impl)
            assert np.asarray(d).min() > 1e18
            assert (np.asarray(i) == 0).all()

    def test_ties_pick_lowest_index(self):
        # the same point repeated across several kernel blocks and chunks:
        # the first copy must win everywhere
        src = np.zeros((8, 3), np.float32)
        dst = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (1200, 1))
        _, i1, _, i2 = self._pair(src, dst)
        np.testing.assert_array_equal(i1, np.zeros(8, np.int32))
        np.testing.assert_array_equal(i2, np.zeros(8, np.int32))

    def test_windowed_matches_plain(self, rng):
        src = rng.uniform(-2, 2, (1024, 3)).astype(np.float32)
        dst = rng.uniform(-2, 2, (6000, 3)).astype(np.float32)
        src, dst = src[np.argsort(src[:, 2])], dst[np.argsort(dst[:, 2])]
        W, axis = auto_nn_window(src, dst, 0.3, axis=2)
        assert W < -(-dst.shape[0] // nn_mod._DST_CHUNK)
        out = [np.asarray(x) for impl in ("interpret", "plain")
               for x in nn_distance_radius(
                   jnp.asarray(src), jnp.asarray(dst), 0.3,
                   window_chunks=W, axis=axis, with_index=True, impl=impl)]
        np.testing.assert_array_equal(out[1], out[3])
        np.testing.assert_allclose(out[0], out[2], atol=1e-6)

    def test_explicit_triton_off_gpu_raises(self, rng):
        src = jnp.asarray(rng.uniform(-1, 1, (8, 3)).astype(np.float32))
        with pytest.raises(ValueError, match="GPU"):
            nn_distance(src, src, impl="triton")
        with pytest.raises(ValueError, match="unknown NN impl"):
            nn_distance(src, src, impl="pallas")

    def test_auto_is_plain_on_cpu(self):
        assert nn_mod._resolve_impl("auto") == "plain"


class TestNNWindowed:
    """Radius-limited windowed NN search (nn_distance_radius) on both
    implementations: exact for every point with a neighbor within the
    radius, a lower-bounded estimate beyond it, and the full scan whenever
    the window assumption breaks."""

    RADIUS = 0.3

    def _clouds(self, rng, n=4096, m=16384, axis=2):
        src = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        dst = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
        return (src[np.argsort(src[:, axis])],
                dst[np.argsort(dst[:, axis])])

    def test_exact_within_radius_lower_bound_beyond(self, rng):
        self._exact_within_radius(rng, "plain")

    def test_exact_within_radius_kernel(self, rng):
        self._exact_within_radius(rng, "interpret")

    def _exact_within_radius(self, rng, impl):
        src, dst = self._clouds(rng)
        W, axis = auto_nn_window(src, dst, self.RADIUS, axis=2)
        assert W < -(-dst.shape[0] // nn_mod._DST_CHUNK), \
            "workload must exercise windows"
        d_ref, i_ref = nn_distance(jnp.asarray(src), jnp.asarray(dst),
                                   with_index=True)
        d_win, i_win = nn_distance_radius(
            jnp.asarray(src), jnp.asarray(dst), self.RADIUS,
            window_chunks=W, axis=axis, with_index=True, impl=impl)
        d_ref, d_win = np.asarray(d_ref), np.asarray(d_win)
        inl = d_ref < self.RADIUS
        assert inl.any()
        np.testing.assert_allclose(d_win[inl], d_ref[inl], atol=1e-6)
        np.testing.assert_array_equal(np.asarray(i_win)[inl],
                                      np.asarray(i_ref)[inl])
        out = ~inl
        assert (d_win[out] >= d_ref[out] - 1e-6).all()
        assert (d_win[out] >= self.RADIUS - 1e-6).all()

    def test_fallback_on_unsorted_and_undersized(self, rng):
        self._fallback(rng, "plain")

    def test_fallback_kernel(self, rng):
        self._fallback(rng, "interpret")

    def _fallback(self, rng, impl):
        src, dst = self._clouds(rng, n=1024, m=4096)
        d_ref = np.asarray(nn_distance(jnp.asarray(src), jnp.asarray(dst)))
        # unsorted dst: the fit flag must take the full scan (exact
        # everywhere, not just within the radius)
        perm = rng.permutation(dst.shape[0])
        d_ref_p = np.asarray(nn_distance(jnp.asarray(src),
                                         jnp.asarray(dst[perm])))
        d_u = np.asarray(nn_distance_radius(
            jnp.asarray(src), jnp.asarray(dst[perm]), self.RADIUS,
            window_chunks=2, axis=2, impl=impl))
        np.testing.assert_allclose(d_u, d_ref_p, atol=1e-6)
        # sorted but window too small for the tile spans: same fallback
        d_s = np.asarray(nn_distance_radius(
            jnp.asarray(src), jnp.asarray(dst), self.RADIUS,
            window_chunks=1, axis=2, impl=impl))
        np.testing.assert_allclose(d_s, d_ref, atol=1e-6)

    def test_masks(self, rng):
        src, dst = self._clouds(rng, n=2048, m=8192)
        sm = rng.random(src.shape[0]) > 0.2
        dm = rng.random(dst.shape[0]) > 0.2
        W, axis = auto_nn_window(src, dst, self.RADIUS, axis=2)
        d_ref = np.asarray(nn_distance(jnp.asarray(src), jnp.asarray(dst),
                                       jnp.asarray(sm), jnp.asarray(dm)))
        d_win = np.asarray(nn_distance_radius(
            jnp.asarray(src), jnp.asarray(dst), self.RADIUS,
            jnp.asarray(sm), jnp.asarray(dm), window_chunks=W, axis=axis))
        inl = (d_ref < self.RADIUS) & sm
        np.testing.assert_allclose(d_win[inl], d_ref[inl], atol=1e-6)
        assert (d_win[~sm] == 0).all()

    def test_small_dst_uses_exact_path(self, rng):
        # a window covering the whole cloud is the full scan
        src, dst = self._clouds(rng, n=256, m=1500)
        d_ref = np.asarray(nn_distance(jnp.asarray(src), jnp.asarray(dst)))
        d_win = np.asarray(nn_distance_radius(
            jnp.asarray(src), jnp.asarray(dst), self.RADIUS,
            window_chunks=8, axis=2))
        np.testing.assert_allclose(d_win, d_ref, atol=1e-6)

    def test_src_far_from_every_chunk(self, rng):
        # tiles whose span +- radius meets no dst chunk scan nothing and
        # report a distance >= radius (here: the no-neighbour sentinel)
        src, dst = self._clouds(rng, n=512, m=3037)
        src = src.copy()
        src[:, 2] += 10.0
        d = np.asarray(nn_distance_radius(
            jnp.asarray(src), jnp.asarray(dst), self.RADIUS,
            window_chunks=2, axis=2))
        assert (d >= self.RADIUS).all()


@pytest.mark.slow
class TestICPWindowed:
    """ICP with the windowed NN kernel (under the interpreter) matches the
    full-scan plain ICP."""

    def test_point_to_point_parity(self, rng):
        n = 12000
        src = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        th = 0.02
        T_true = se3(euler_xyz_to_matrix(0.0, 0.0, th), [0.01, -0.02, 0.005])
        dst = (src @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
        W, axis = auto_nn_window(src, dst, 0.3)
        assert W < -(-n // nn_mod._DST_CHUNK), \
            "workload must exercise windows"
        kw = dict(threshold=0.3, max_iterations=12, relative_fitness=0.0,
                  relative_rmse=0.0)
        ref = icp_point_to_point(jnp.asarray(src), jnp.asarray(dst), **kw)
        win = icp_point_to_point(jnp.asarray(src), jnp.asarray(dst),
                                 nn_window=W, nn_axis=axis,
                                 nn_impl="interpret", **kw)
        np.testing.assert_allclose(np.asarray(win.transformation),
                                   np.asarray(ref.transformation), atol=1e-5)
        np.testing.assert_allclose(np.asarray(win.transformation), T_true,
                                   atol=2e-3)
        assert float(win.fitness) > 0.99

    def test_point_to_plane_parity(self, rng):
        n_per = 4000
        pts, nrms = [], []
        for axis in range(3):
            p = rng.uniform(-1, 1, (n_per, 3))
            p[:, axis] = 0.0
            nr = np.zeros((n_per, 3))
            nr[:, axis] = 1.0
            pts.append(p)
            nrms.append(nr)
        dst = np.concatenate(pts).astype(np.float32)
        normals = np.concatenate(nrms).astype(np.float32)
        T_true = se3(euler_xyz_to_matrix(0.02, -0.01, 0.03),
                     [0.02, 0.01, -0.03])
        src = ((dst - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
        W, ax = auto_nn_window(src, dst, 0.3)
        res = icp_point_to_plane(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(normals), threshold=0.3,
                                 max_iterations=20, nn_window=W, nn_axis=ax,
                                 nn_impl="interpret")
        np.testing.assert_allclose(np.asarray(res.transformation), T_true,
                                   atol=5e-3)
