"""Evaluation layer: GT sampling, metrics protocol, scenario parity,
and the debug probes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from otslam_tpu.config import (CameraConfig, ReconstructionConfig, TSDFConfig)
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.eval.metrics import evaluate_map
from otslam_tpu.eval.scenarios import (
    sample_object_surfaces, sample_scene_surface, scenario_gt)
from otslam_tpu.eval.report import print_summary_table, plot_results
from otslam_tpu.eval.metrics import EvalMetrics
from otslam_tpu.sim.world import Box, Cone, Cylinder, cardboard_room
from otslam_tpu.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu.utils.probes import depth_stats, depth_heat_image, trajectory_frames


class TestGTSampling:
    def test_box_samples_on_surface(self):
        b = Box((1.0, 2.0, 0.5), (0.4, 0.6, 1.0), 0.4)
        pts = sample_object_surfaces([b], 5000, seed=1)
        # transform back to local frame; every point on a face
        c, s = np.cos(-0.4), np.sin(-0.4)
        p = pts - np.array(b.center)
        local = np.stack([p[:, 0] * c - p[:, 1] * s,
                          p[:, 0] * s + p[:, 1] * c, p[:, 2]], -1)
        q = np.abs(local) - np.array(b.size) / 2
        assert np.abs(q.max(axis=1)).max() < 1e-6

    def test_cone_cylinder_on_surface(self):
        cyl = Cylinder((0, 0, 0), 0.3, 0.8)
        pts = sample_object_surfaces([cyl], 3000, seed=2)
        r = np.hypot(pts[:, 0], pts[:, 1])
        on_lat = np.isclose(r, 0.3, atol=1e-6)
        on_cap = np.isclose(pts[:, 2], 0.0, atol=1e-9) | np.isclose(
            pts[:, 2], 0.8, atol=1e-9)
        assert (on_lat | on_cap).all()

        cone = Cone((0, 0, 0), 0.2, 0.5)
        cpts = sample_object_surfaces([cone], 3000, seed=3)
        rc = np.hypot(cpts[:, 0], cpts[:, 1])
        on_base = np.isclose(cpts[:, 2], 0.0, atol=1e-9)
        # lateral surface: r = R * (1 - z/h)
        on_side = np.isclose(rc, 0.2 * (1 - cpts[:, 2] / 0.5), atol=1e-6)
        assert (on_base | on_side).all()

    def test_named_scenarios(self):
        for name in ("table_chair", "cone", "cardboard"):
            gt = scenario_gt(name, 2000, seed=0)
            assert len(gt) >= 2000 * 0.9
            assert np.isfinite(gt).all()


class TestMetrics:
    def test_identical_clouds_zero_error(self, rng):
        pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
        m = evaluate_map(pts, pts)
        assert m.accuracy_cm < 1e-3 and m.completeness_cm < 1e-3

    def test_known_offset(self, rng):
        pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
        shifted = pts + np.array([0.02, 0.0, 0.0], np.float32)
        m = evaluate_map(shifted, pts)
        # every NN distance <= 2 cm (near-surface points match closer)
        assert 0.3 < m.accuracy_cm <= 2.01

    def test_icp_refinement_removes_offset(self, rng):
        pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
        shifted = pts + np.array([0.03, -0.01, 0.02], np.float32)
        raw = evaluate_map(shifted, pts)
        refined = evaluate_map(shifted, pts, use_icp=True)
        assert refined.accuracy_cm < raw.accuracy_cm * 0.2


class TestScenarioParity:
    """Full offline-pipeline parity: render captures -> reconstruct ->
    evaluate vs GT. The acceptance analog of eval_cardboard (SURVEY.md §4.3)."""

    CAM = CameraConfig(width=160, height=120, fx=141.4002, fy=141.4002,
                       cx=80.5, cy=60.5)

    def captures(self, scene, center, n=10, radius=1.1, height=0.5):
        intr = PinholeIntrinsics.from_config(self.CAM)
        depths, colors, exts = [], [], []
        for i in range(n):
            a = 2 * np.pi * i / n
            eye = np.array([center[0] + radius * np.cos(a),
                            center[1] + radius * np.sin(a), height])
            pose = look_at_pose(eye, center)
            d, c = render_rgbd(scene, pose, intr, far=5.0)
            depths.append(np.asarray(d))
            colors.append(np.asarray(c))
            exts.append(np.linalg.inv(pose).astype(np.float32))
        return (np.stack(depths), np.stack(colors), np.stack(exts))

    @pytest.fixture(scope="class")
    def recon(self):
        from otslam_tpu.pipeline.reconstruct import (
            extract_filtered_cloud, fuse_frames)
        scene = cardboard_room()
        box = scene.objects[0]
        d, c, e = self.captures(scene, np.array([1.5, 0.5, 0.15]))
        cfg = ReconstructionConfig(
            camera=self.CAM,
            tsdf=TSDFConfig(dims=(128, 128, 64), origin=(0.9, -0.1, -0.1)),
            surface_samples=30000)
        intr = PinholeIntrinsics.from_config(self.CAM)
        out = {}
        for backend in ("dense", "sparse"):
            vol = fuse_frames(d, c, e, intr, cfg, backend)
            out[backend] = extract_filtered_cloud(vol, cfg, seed=0)
        return box, out

    def test_accuracy_beats_reference_number(self, recon):
        box, out = recon
        gt = sample_object_surfaces([box], 20000, seed=0)
        gt = gt[gt[:, 2] >= 0.03]  # same floor filter as the map
        m = evaluate_map(out["sparse"].points, gt)
        # reference cardboard accuracy: 4.15 cm (Gazebo). Clean analytic
        # captures at 1 cm voxels must land far below that.
        assert m.accuracy_cm < 1.5, m
        assert m.completeness_cm < 1.5, m

    def test_backend_parity_within_1mm(self, recon):
        _, out = recon
        a = out["dense"].points
        b = out["sparse"].points
        m = evaluate_map(a, b)
        assert m.accuracy_cm < 0.1 and m.completeness_cm < 0.1  # < 1 mm


class TestReport:
    def test_table_and_plot(self, tmp_path):
        res = {"Cardboard Box": EvalMetrics(0.5, 0.6)}
        txt = print_summary_table(res)
        assert "Cardboard Box" in txt
        p = plot_results(res, str(tmp_path / "out.png"))
        import os
        assert os.path.getsize(p) > 1000


class TestProbes:
    def test_depth_stats_and_heat(self):
        d = np.zeros((4, 6), np.float32)
        d[1, 1] = 2.0
        d[2, 2] = 4.0
        st = depth_stats(d)
        assert st["max"] == 4.0 and 0 < st["valid_fraction"] < 1
        heat = depth_heat_image(d)
        assert heat.dtype == np.uint8
        assert heat[1, 1] == 255  # nearest is brightest
        assert heat[0, 0] == 0

    def test_trajectory_frames(self):
        poses = [np.eye(4), np.eye(4)]
        pts, cols = trajectory_frames(poses)
        assert pts.shape == (8, 3) and cols.shape == (8, 3)


class TestNoiseRobustness:
    """Clean analytic scenes overstate accuracy; verify the pipeline holds up
    under realistic depth noise (RealSense-class ~0.5-1% of range)."""

    CAM = CameraConfig(width=160, height=120, fx=141.4002, fy=141.4002,
                       cx=80.5, cy=60.5)

    @pytest.mark.slow
    def test_cardboard_with_noisy_depth(self):
        from otslam_tpu.pipeline.reconstruct import (
            extract_filtered_cloud, fuse_frames)
        from otslam_tpu.eval.scenarios import sample_object_surfaces
        rng = np.random.default_rng(0)
        scene = cardboard_room()
        box = scene.objects[0]
        intr = PinholeIntrinsics.from_config(self.CAM)
        depths, colors, exts = [], [], []
        for i in range(12):
            a = 2 * np.pi * i / 12
            eye = np.array([1.5 + 1.1 * np.cos(a), 0.5 + 1.1 * np.sin(a), 0.5])
            pose = look_at_pose(eye, np.array([1.5, 0.5, 0.15]))
            d, c = render_rgbd(scene, pose, intr, far=5.0)
            d = np.asarray(d)
            noise = rng.normal(0.0, 0.005, d.shape).astype(np.float32)
            d = np.where(d > 0, np.maximum(d + noise, 0.01), 0.0)
            depths.append(d)
            colors.append(np.asarray(c))
            exts.append(np.linalg.inv(pose).astype(np.float32))
        cfg = ReconstructionConfig(
            camera=self.CAM,
            tsdf=TSDFConfig(dims=(128, 128, 64), origin=(0.9, -0.1, -0.1)),
            surface_samples=30000)
        vol = fuse_frames(np.stack(depths), np.stack(colors), np.stack(exts),
                          intr, cfg, "sparse", densify=False)
        res = extract_filtered_cloud(vol, cfg, seed=0)
        gt = sample_object_surfaces([box], 20000, seed=0)
        gt = gt[gt[:, 2] >= 0.03]
        m = evaluate_map(res.points, gt)
        # 5 mm Gaussian depth noise: TSDF averaging keeps accuracy well
        # below the published 4.15 cm
        assert m.accuracy_cm < 2.0, m
        assert m.completeness_cm < 2.0, m


class TestPallasBackendOnCPU:
    @pytest.mark.slow
    def test_reconstruct_pallas_backend_works_off_tpu(self):
        """The default CLI backend (block-sparse) must work on CPU."""
        from otslam_tpu.pipeline.reconstruct import (
            extract_filtered_cloud, fuse_frames)
        cam = CameraConfig(width=64, height=48, fx=56.0, fy=56.0,
                           cx=32.0, cy=24.0)
        intr = PinholeIntrinsics.from_config(cam)
        cfg = ReconstructionConfig(
            camera=cam,
            tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08,
                            dims=(64, 64, 64), origin=(-0.64, -0.64, 0.2)),
            surface_samples=5000)
        d = np.full((2, 48, 64), 0.4503, np.float32)
        c = np.full((2, 48, 64, 3), 90.0, np.float32)
        e = np.stack([np.eye(4, dtype=np.float32)] * 2)
        vol = fuse_frames(d, c, e, intr, cfg, densify=False)
        res = extract_filtered_cloud(vol, cfg, seed=0, z_filter=False)
        assert len(res.points) == 5000
