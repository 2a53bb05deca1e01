"""Executable Open3D-parity contract (BASELINE: <= 1 mm RMSE).

The golden cross-check against a real open3d install
(test_mesh_gt.TestOpen3DGolden) skips where open3d is absent; these tests
assert the SAME contract against the NumPy transcription of Open3D's
documented ScalableTSDFVolume semantics (tests/oracle_open3d.py), at the
reference's exact parameters (voxel 0.01, sdf_trunc 0.04, RGB8, depth
handling of reconstruct_rgbd.py:79-118) — so the 1 mm bound is asserted by
a test that runs in every environment.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from otslam_tpu.config import CameraConfig, TSDFConfig
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.kernels.nn import nn_distance
from otslam_tpu.kernels.tsdf import (extract_surface_points, integrate_frames,
                                     make_volume)
from otslam_tpu.kernels.tsdf_block import (extract_surface_points_sparse,
                                           integrate_frames_sparse,
                                           make_block_volume)
from otslam_tpu.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu.sim.world import cardboard_room

from oracle_open3d import oracle_extract, oracle_integrate

CAM = CameraConfig(width=160, height=120, fx=141.4002, fy=141.4002,
                   cx=80.5, cy=60.5)
# reference parameters: voxel_length=0.01, sdf_trunc=0.04 (reconstruct_rgbd
# .py:79-83); depth_trunc=3.0 (":99-104")
CFG = TSDFConfig(voxel_size=0.01, sdf_trunc=0.04, dims=(128, 128, 64),
                 origin=(0.9, -0.1, -0.1))


@pytest.fixture(scope="module")
def capture():
    scene = cardboard_room()
    intr = PinholeIntrinsics.from_config(CAM)
    depths, colors, exts = [], [], []
    for i in range(6):
        a = 2 * np.pi * i / 6
        eye = np.array([1.5 + 1.1 * np.cos(a), 0.5 + 1.1 * np.sin(a), 0.5])
        pose = look_at_pose(eye, np.array([1.5, 0.5, 0.15]))
        d, c = render_rgbd(scene, pose, intr, far=5.0)
        depths.append(np.asarray(d))
        colors.append(np.asarray(c))
        exts.append(np.linalg.inv(pose).astype(np.float32))
    return (np.stack(depths), np.stack(colors), np.stack(exts), intr)


@pytest.fixture(scope="module")
def oracle_surface(capture):
    depths, colors, exts, intr = capture
    t, w, _ = oracle_integrate(
        depths, colors, exts, CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        CFG.origin, CFG.dims, CFG.voxel_size, CFG.sdf_trunc)
    pts = oracle_extract(t, w, CFG.origin, CFG.voxel_size)
    assert len(pts) > 3000
    return pts.astype(np.float32)


def rmse_mm(a, b):
    """Symmetric RMSE between two surface clouds, in millimeters."""
    d_ab = np.asarray(nn_distance(jnp.asarray(a), jnp.asarray(b), chunk=512))
    d_ba = np.asarray(nn_distance(jnp.asarray(b), jnp.asarray(a), chunk=512))
    return 1000.0 * max(float(np.sqrt(np.mean(d_ab ** 2))),
                        float(np.sqrt(np.mean(d_ba ** 2))))


class TestOracleSelfConsistency:
    def test_plane_surface_position(self):
        """A frontal wall at z=1.2 m must extract at 1.2 m (sub-interp
        error) — sanity of the oracle itself before it judges anything."""
        H, W = 60, 80
        depth = np.full((1, H, W), 1.2, np.float32)
        color = np.full((1, H, W, 3), 128.0, np.float32)
        ext = np.eye(4, dtype=np.float32)[None]
        dims = (64, 64, 32)
        t, w, _ = oracle_integrate(
            depth, color, ext, 70.0, 70.0, 40.0, 30.0,
            (-0.32, -0.32, 1.0), dims, 0.01, 0.04)
        pts = oracle_extract(t, w, (-0.32, -0.32, 1.0), 0.01)
        zpts = pts[np.abs(pts[:, 2] - 1.2) < 0.05]
        assert len(zpts) > 100
        assert float(np.abs(zpts[:, 2] - 1.2).max()) < 5e-4


class TestPathsVsOracle:
    """BASELINE bound: each fusion path's surface within 1 mm RMSE of the
    Open3D-semantics oracle at reference parameters."""

    def test_dense_path(self, capture, oracle_surface):
        depths, colors, exts, intr = capture
        vol = integrate_frames(make_volume(CFG), jnp.asarray(depths),
                               jnp.asarray(colors), jnp.asarray(exts), intr)
        pts, _, mask = extract_surface_points(vol, capacity=200000)
        ours = np.asarray(pts)[np.asarray(mask)]
        r = rmse_mm(ours, oracle_surface)
        assert r <= 1.0, f"dense RMSE {r:.3f} mm"

    @pytest.mark.slow
    def test_sparse_path(self, capture, oracle_surface):
        depths, colors, exts, intr = capture
        vol = integrate_frames_sparse(
            make_block_volume(CFG), jnp.asarray(depths), jnp.asarray(colors),
            jnp.asarray(exts), intr, max_active=2048)
        pts, _, mask = extract_surface_points_sparse(vol, capacity=200000,
                                                     max_blocks=8192)
        ours = np.asarray(pts)[np.asarray(mask)]
        r = rmse_mm(ours, oracle_surface)
        assert r <= 1.0, f"sparse RMSE {r:.3f} mm"
