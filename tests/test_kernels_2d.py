"""2D perception kernels vs tiny NumPy oracles mirroring the C++ loops."""

import numpy as np
import pytest
import jax.numpy as jnp

from otslam_tpu.config import ClusterConfig
from otslam_tpu.kernels.raycast import raycast_grid
from otslam_tpu.kernels.scan_diff import scan_diff
from otslam_tpu.kernels.evidence import (
    scatter_hits, update_evidence, evidence_points, world_to_key)
from otslam_tpu.kernels.cluster import (
    cluster_scan_points, analyze_clusters, scan_to_points,
    WALL, OBJECT, UNKNOWN)


def raycast_oracle(grid, res, ox, oy, rx, ry, yaw, angles, range_max):
    """Direct transcription of virtual_scan_node.cpp:258-287 semantics."""
    H, W = grid.shape
    out = np.full(len(angles), np.inf, np.float32)
    for i, a in enumerate(angles):
        ga = yaw + a
        dist = 0.0
        while dist < range_max:
            dist += res
            x = rx + dist * np.cos(ga)
            y = ry + dist * np.sin(ga)
            gx = int((x - ox) / res)   # C cast: truncation toward zero
            gy = int((y - oy) / res)   # (virtual_scan_node.cpp:274-275)
            if gx < 0 or gx >= W or gy < 0 or gy >= H:
                break
            if grid[gy, gx] == 100:
                out[i] = dist
                break
    return out


class TestRaycast:
    def test_matches_oracle(self, rng):
        H, W = 40, 50
        grid = np.zeros((H, W), np.int8)
        grid[30, :] = 100          # wall row
        grid[:, 45] = 100          # wall column
        grid[10, 5] = 100
        res, ox, oy = 0.1, -2.0, -2.0
        rx, ry, yaw = 0.3, -0.2, 0.4
        angles = np.linspace(0, 2 * np.pi, 72, endpoint=False).astype(np.float32)
        got = np.asarray(raycast_grid(jnp.asarray(grid), res, ox, oy,
                                      rx, ry, yaw, jnp.asarray(angles), 5.0))
        want = raycast_oracle(grid, res, ox, oy, rx, ry, yaw, angles, 5.0)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_c_cast_boundary_semantics(self):
        """Sample points in (origin - res, origin) truncate to cell 0 (tested,
        like the C++ ``(int)`` cast) instead of flooring to -1 (ray end).
        Regression: a floor-based kernel returns inf here."""
        grid = np.zeros((20, 20), np.int8)
        grid[0, 0] = 100  # occupied cell at the grid corner
        res, ox, oy = 0.1, 0.0, 0.0
        # robot just inside the grid, ray pointing toward -x: first sample at
        # x = -0.05 -> (x-ox)/res = -0.5 -> C-cast cell 0 (occupied) -> hit
        got = np.asarray(raycast_grid(jnp.asarray(grid), res, ox, oy,
                                      0.05, 0.05, 0.0,
                                      jnp.asarray([np.pi], np.float32), 3.0))
        want = raycast_oracle(grid, res, ox, oy, 0.05, 0.05, 0.0,
                              np.asarray([np.pi]), 3.0)
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert np.isfinite(got[0]), "floor semantics would terminate the ray"

    def test_no_hit_is_inf(self):
        grid = np.zeros((20, 20), np.int8)
        got = np.asarray(raycast_grid(jnp.asarray(grid), 0.1, -1.0, -1.0,
                                      0.0, 0.0, 0.0,
                                      jnp.asarray([0.0, 1.5]), 3.0))
        assert np.isinf(got).all()


def _raycast_case(name, rng):
    """(grid, res, ox, oy, rx, ry, yaw, angles, range_max) for one regime."""
    if name == "walls":
        grid = np.zeros((40, 50), np.int8)
        grid[30, :] = 100
        grid[:, 45] = 100
        grid[10, 5] = 100
        angles = np.linspace(0, 2 * np.pi, 72, endpoint=False)
        return grid, 0.1, -2.0, -2.0, 0.3, -0.2, 0.4, angles, 5.0
    if name.startswith("random"):
        grid = (rng.random((64, 96)) < 0.03).astype(np.int8) * 100
        angles = np.linspace(-np.pi, np.pi, 40, endpoint=False)
        rx, ry = rng.uniform(-1, 6, 2)
        return (grid, 0.08, -1.0, -1.0, float(rx), float(ry),
                float(rng.uniform(0, 6)), angles, 4.0)
    if name == "c_cast_fan":
        grid = np.zeros((20, 20), np.int8)
        grid[0, 0] = 100
        return (grid, 0.1, 0.0, 0.0, 0.05, 0.05, 0.0,
                np.full(8, np.pi), 1.5)
    if name == "wild_angles":
        # 8 beams in wildly different directions over a map larger than
        # the ray extent along both axes
        grid = np.zeros((300, 300), np.int8)
        grid[220, :] = 100
        angles = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        return grid, 0.05, -7.5, -7.5, 0.0, 0.0, 0.0, angles, 3.5
    if name == "pose_outside_map":
        grid = (rng.random((300, 260)) < 0.02).astype(np.int8) * 100
        angles = rng.uniform(0, 2 * np.pi, 32)
        return grid, 0.05, -7.0, -6.0, 9.5, -8.5, 2.0, angles, 3.6
    assert name == "mission_geometry"
    # production lidar (1440 contiguous beams, 10 m) over a scene-sized map
    from otslam_tpu.config import LidarConfig
    lidar = LidarConfig()
    grid = np.zeros((208, 208), np.int8)
    grid[[0, -1], :] = 100
    grid[:, [0, -1]] = 100
    grid[100:110, 60:70] = 100
    inc = (lidar.angle_max - lidar.angle_min) / lidar.num_beams
    angles = lidar.angle_min + np.arange(lidar.num_beams) * inc
    return grid, 0.05, -5.2, -5.2, -1.0, 1.0, -1.5, angles, lidar.range_max


class TestRaycastOracleParity:
    """raycast_grid against the C-loop oracle in every regime the removed
    windowed kernel distinguished: walls, random grids, the C-cast
    boundary, non-contiguous beams, poses outside the map and the mission's
    lidar geometry. Same per-sample arithmetic, so ranges agree to f32
    rounding of the step distance."""

    @pytest.mark.parametrize("name", [
        "walls", "random0", "random1", "random2", "c_cast_fan",
        "wild_angles", "pose_outside_map", "mission_geometry"])
    def test_matches_oracle(self, name):
        rng = np.random.default_rng(sum(map(ord, name)))
        grid, res, ox, oy, rx, ry, yaw, angles, rmax = _raycast_case(
            name, rng)
        angles = np.asarray(angles, np.float32)
        got = np.asarray(raycast_grid(jnp.asarray(grid), res, ox, oy,
                                      rx, ry, yaw, jnp.asarray(angles),
                                      rmax))
        want = raycast_oracle(grid, res, ox, oy, rx, ry, yaw, angles, rmax)
        np.testing.assert_allclose(got, want, atol=1e-5)
        if name == "c_cast_fan":
            assert np.isfinite(got).all()


def diff_oracle(real, virt, angles, range_max, thr, W):
    """Transcription of diff_node.cpp:102-158."""
    n = len(real)
    new_m = np.zeros(n, bool)
    rem_m = np.zeros(n, bool)
    for i in range(n):
        r = real[i]
        if not (np.isfinite(r) and r <= range_max):
            pass
        else:
            rx, ry = r * np.cos(angles[i]), r * np.sin(angles[i])
            near = False
            for j in range(max(0, i - W), min(n, i + W)):
                v = virt[j]
                if np.isinf(v):
                    continue
                vx, vy = v * np.cos(angles[j]), v * np.sin(angles[j])
                if np.hypot(rx - vx, ry - vy) < thr:
                    near = True
                    break
            new_m[i] = not near
        v = virt[i]
        if np.isfinite(v):
            vx, vy = v * np.cos(angles[i]), v * np.sin(angles[i])
            alive = False
            for j in range(max(0, i - W), min(n, i + W)):
                r2 = real[j]
                if np.isinf(r2) or r2 > range_max:
                    continue
                rx2, ry2 = r2 * np.cos(angles[j]), r2 * np.sin(angles[j])
                if np.hypot(vx - rx2, vy - ry2) < thr:
                    alive = True
                    break
            rem_m[i] = not alive
    return new_m, rem_m


class TestScanDiff:
    def test_matches_oracle(self, rng):
        n = 180
        angles = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
        virt = np.full(n, 3.0, np.float32)
        virt[20:30] = np.inf                   # removed wall section
        real = np.full(n, 3.0, np.float32)
        real[50:60] = 1.0                      # new object in front of wall
        real[100:105] = np.inf                 # dropout
        got_new, got_rem = scan_diff(jnp.asarray(real), jnp.asarray(virt),
                                     jnp.asarray(angles), 10.0, 0.5, 20)
        want_new, want_rem = diff_oracle(real, virt, angles, 10.0, 0.5, 20)
        np.testing.assert_array_equal(np.asarray(got_new), want_new)
        np.testing.assert_array_equal(np.asarray(got_rem), want_rem)


class TestEvidence:
    def test_truncating_keys(self):
        kx, ky = world_to_key(jnp.asarray([0.27, -0.27]),
                              jnp.asarray([1.01, -1.01]), 0.1)
        # C-style trunc-toward-zero: 2.7 -> 2, -2.7 -> -2
        np.testing.assert_array_equal(np.asarray(kx), [2, -2])
        np.testing.assert_array_equal(np.asarray(ky), [10, -10])

    def test_dwell_saturation_decay_and_publish(self):
        grid = jnp.zeros((32, 32))
        res, tt, decay = 0.1, 2.0, 0.5
        xs = jnp.asarray([0.35]); ys = jnp.asarray([0.35])
        m = jnp.asarray([True])
        dwell = grid
        for _ in range(20):  # 20 x 0.2s hits -> saturates at 3.0
            hits = scatter_hits(grid, xs, ys, m, res)
            dwell = update_evidence(dwell, hits, jnp.asarray(0.2), tt, decay)
        assert np.isclose(float(dwell.max()), 3.0)
        pts, conf = evidence_points(dwell, res, tt)
        sel = np.asarray(pts)[np.asarray(conf)]
        assert len(sel) == 1
        np.testing.assert_allclose(sel[0], [0.35, 0.35], atol=1e-6)
        # decay without hits: 3.0 -> 0 after 30 x 0.2s at rate 0.5
        none = scatter_hits(grid, xs, ys, jnp.asarray([False]), res)
        for _ in range(31):
            dwell = update_evidence(dwell, none, jnp.asarray(0.2), tt, decay)
        assert float(dwell.max()) == 0.0


class TestCluster:
    def test_gap_clustering_and_stats(self):
        # two groups of points along x, separated by > threshold
        pts = np.array([[0.0, 0], [0.1, 0], [0.2, 0],
                        [2.0, 0], [2.1, 0.1], [2.2, 0]], np.float32)
        mask = np.ones(6, bool)
        labels, num = cluster_scan_points(jnp.asarray(pts), jnp.asarray(mask),
                                          gap_threshold=0.4,
                                          merge_wraparound=False)
        assert int(num) == 2
        np.testing.assert_array_equal(np.asarray(labels), [0, 0, 0, 1, 1, 1])
        cfg = ClusterConfig(max_clusters=8)
        st = analyze_clusters(jnp.asarray(pts), labels, cfg)
        assert int(st.count[0]) == 3 and int(st.count[1]) == 3
        np.testing.assert_allclose(np.asarray(st.centroid[0]), [0.1, 0.0],
                                   atol=1e-6)
        np.testing.assert_allclose(float(st.length[0]), 0.2, atol=1e-6)

    def test_host_mirror_matches_kernel(self, rng):
        """cluster_points_host (the control plane's zero-dispatch path) must
        produce identical labels/num to cluster_scan_points on all-valid
        points without wraparound — the tracker's exact configuration."""
        from otslam_tpu.kernels.cluster import cluster_points_host
        for n in (1, 2, 7, 64, 200):
            pts = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
            hl, hn = cluster_points_host(pts, 0.4)
            kl, kn = cluster_scan_points(
                jnp.asarray(pts), jnp.ones(n, bool), 0.4,
                merge_wraparound=False)
            assert hn == int(kn), n
            np.testing.assert_array_equal(hl, np.asarray(kl))
        assert cluster_points_host(np.zeros((0, 2)), 0.4)[1] == 0

    def test_invalid_points_break_adjacency(self):
        pts = np.array([[0.0, 0], [0.1, 0], [0.0, 0], [0.2, 0]], np.float32)
        mask = np.array([True, True, False, True])
        labels, num = cluster_scan_points(jnp.asarray(pts), jnp.asarray(mask),
                                          0.4, merge_wraparound=False)
        # the invalid point is skipped: points 0,1,3 all within gap -> one cluster
        assert int(num) == 1
        assert np.asarray(labels)[2] >= 60  # invalid label = max_clusters

    def test_wraparound_merge(self):
        # ring of points: first and last beams adjacent in space
        angles = np.linspace(0, 2 * np.pi, 60, endpoint=False)
        pts = np.stack([np.cos(angles), np.sin(angles)], -1).astype(np.float32)
        mask = np.ones(60, bool)
        labels, num = cluster_scan_points(jnp.asarray(pts), jnp.asarray(mask),
                                          gap_threshold=0.2,
                                          merge_wraparound=True)
        assert int(num) == 1
        assert (np.asarray(labels) == 0).all()

    def test_classification_wall_vs_object(self, rng):
        cfg = ClusterConfig()
        # WALL: 3m straight line with 60 points
        wall = np.stack([np.linspace(0, 3, 60), np.zeros(60)], -1)
        # OBJECT: tight blob of 15 points
        blob = rng.normal(0, 0.05, (15, 2)) + [5.0, 5.0]
        pts = np.concatenate([wall, blob]).astype(np.float32)
        labels = np.concatenate([np.zeros(60), np.ones(15)]).astype(np.int32)
        st = analyze_clusters(jnp.asarray(pts), jnp.asarray(labels), cfg)
        assert int(st.classes[0]) == WALL
        assert int(st.classes[1]) == OBJECT

    def test_scan_to_points_range_gate(self):
        r = jnp.asarray([1.0, 9.5, jnp.inf, 0.0])
        a = jnp.asarray([0.0, 0.1, 0.2, 0.3])
        pts, valid = scan_to_points(r, a, range_max=10.0, max_range_ratio=0.9)
        np.testing.assert_array_equal(np.asarray(valid),
                                      [True, False, False, False])
