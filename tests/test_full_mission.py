"""Production-scale closed-loop mission on the 5-object-group scene.

The full_room scene mirrors the reference's flagship world
(cardboard_table_chairs_cones_room.world:249-378: table + 4 chairs +
cardboard box + 2 cones) and the mission runs with the production
estimated-pose stack: drifting odometry + scan-to-map localization
(slam_toolbox-localization equivalent) AND a removed object seeded in the
saved map so the removed-object check-point pipeline engages
(diff_node.cpp:131-158). The same deployment runs on the GPU in
chip_smoke.py phase (b).
"""

import dataclasses as dc

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from otslam_tpu.config import (CameraConfig, LidarConfig, OTSLAMConfig,
                               TrackerConfig)
from otslam_tpu.sim.runner import MissionRunner
from otslam_tpu.sim.world import Box, full_room

CAM = CameraConfig(width=160, height=120, fx=141.4002, fy=141.4002,
                   cx=80.5, cy=60.5)
# production beam count: the wall-thickness filter (tuned 0.3 m,
# 3_virtual_lidar_navigation.launch.py) rejects distant small objects at
# coarser angular resolution — the cones subtend ~4 beams at 360 beams
LIDAR = LidarConfig()
PHANTOM = Box((4.0, -4.0, 0.15), (0.5, 0.4, 0.3), 0.0, (0.7, 0.7, 0.7),
              "removed_box")


@pytest.fixture(scope="module")
def mission(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("full"))
    world = full_room()
    cfg = OTSLAMConfig(camera=CAM, lidar=LIDAR,
                       tracker=TrackerConfig.update_pipeline_profile())
    runner = MissionRunner(
        scene_map=dc.replace(world, objects=(PHANTOM,)),
        scene_world=world, workdir=work, cfg=cfg,
        # within detection reach of every object group at t=0: table 8.3 m,
        # box 5.7 m, cones 4.6 m, phantom 9.3 m (lidar range 10 m)
        start_pose=(0.5, 4.5, 0.0),
        odom_noise_per_m=0.01, use_localizer=True,
        perception_batch=5)
    # member sub-segmentation (round 5) turns the table group into 5 scan
    # sites with their own circles — 900 ticks only reached the first two
    # chairs; 1800 covers the table site too (full coverage is the chip
    # job of examples/production_mission.py)
    summary = runner.run(max_ticks=1800)
    return runner, summary, work


class TestFullRoomMission:
    def test_scene_has_eight_objects_in_room(self):
        world = full_room()
        assert len(world.objects) == 8
        xmin, xmax, ymin, ymax = world.room
        for o in world.objects:
            assert xmin < o.center[0] < xmax and ymin < o.center[1] < ymax

    def test_multiple_objects_scanned(self, mission):
        _, summary, _ = mission
        # the run visits several distinct object groups with estimated
        # poses (table group + at least one far-field object)
        assert summary.missions_completed >= 4
        assert len(summary.labels) >= 3
        assert summary.frames_captured >= len(summary.labels)

    def test_table_group_scans_per_member(self, mission):
        """The merged table+chairs group produces per-MEMBER capture sites:
        at least one captured label orbits a chair and one
        orbits the table itself, at member-scale radii (not the ~4 m group
        circle that reconstructed chairs at 25-30 cm)."""
        import glob

        runner, summary, work = mission
        g = max(runner.tracker.stable_objects, key=lambda s: len(s.members))
        assert len(g.members) >= 4   # table + >=3 chairs discovered
        orbits = {}
        for label in summary.labels:
            ps = [np.loadtxt(f) for f in sorted(
                glob.glob(f"{work}/dataset/poses/{label}_*.txt"))]
            c = np.mean([p[:2, 3] for p in ps], axis=0)
            orbits[label] = (c, np.mean([np.linalg.norm(p[:2, 3] - c)
                                         for p in ps]))
        def near(target, r_max):
            return any(np.linalg.norm(c - target) < 0.7 and r < r_max
                       for c, r in orbits.values())
        chairs = [(-1.71, -2.1), (-2.72, -2.1), (-1.68, -4.7), (-2.84, -4.7)]
        assert any(near(np.array(ch), 1.8) for ch in chairs)
        assert near(np.array([-2.23, -3.31]), 2.3)   # the table site

    def test_removed_check_point_visited(self, mission):
        runner, _, _ = mission
        # the phantom map object produced a removed-object check mission
        assert len(runner.sender.visited_removed_ids) >= 1
        removed = runner.removed_tracker.stable_objects
        assert any(np.hypot(s.cx - 4.0, s.cy + 4.0) < 1.0 for s in removed)

    def test_localizer_kept_pose_error_bounded(self, mission):
        runner, _, _ = mission
        ex, ey, _ = runner.pose_estimate
        assert np.hypot(ex - runner.x, ey - runner.y) < 0.25

    def test_dataset_reconstructs(self, mission):
        from otslam_tpu.config import ReconstructionConfig, TSDFConfig
        from otslam_tpu.pipeline.dataset import CaptureDataset
        from otslam_tpu.pipeline.reconstruct import reconstruct_object

        runner, summary, work = mission
        ds = CaptureDataset(work + "/dataset", CAM)
        label = summary.labels[0]
        cfg = ReconstructionConfig(
            camera=CAM, tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08,
                                        dims=(128, 128, 64)))
        res = reconstruct_object(ds, label, cfg=cfg, backend="sparse",
                                 auto_origin=True)
        assert len(res.points) > 200


class TestAutoVolumeConfig:
    """auto_volume_config sizes volume dims to the observed extent (a
    merged table+chairs group exceeded the default 2.56 m volume, clipping
    the outer chairs out of the reconstruction)."""

    def _batch_for(self, scene, center, radius, n=6):
        import types

        from otslam_tpu.core.camera import PinholeIntrinsics
        from otslam_tpu.sim.sensors import look_at_pose, render_rgbd

        intr = PinholeIntrinsics.from_config(CAM)
        ds_d, ds_e = [], []
        for i in range(n):
            a = 2 * np.pi * i / n
            eye = np.array([center[0] + radius * np.cos(a),
                            center[1] + radius * np.sin(a), 0.8])
            opt = look_at_pose(eye, np.array([center[0], center[1], 0.4]))
            d, c = render_rgbd(scene, opt, intr, far=5.0)
            ds_d.append(np.asarray(d))
            ds_e.append(np.linalg.inv(opt).astype(np.float32))
        return types.SimpleNamespace(
            depths=np.stack(ds_d), extrinsics=np.stack(ds_e),
            names=[str(i) for i in range(n)]), intr

    def test_wide_group_gets_bigger_volume(self):
        from otslam_tpu.config import ReconstructionConfig, TSDFConfig
        from otslam_tpu.pipeline.reconstruct import auto_volume_config
        from otslam_tpu.sim.world import Scene, full_room

        world = full_room()
        group = Scene(objects=tuple(
            o for o in world.objects if o.name.startswith(("table", "chair"))),
            room=world.room)
        batch, intr = self._batch_for(group, (-2.23, -3.31), 3.0)
        cfg = ReconstructionConfig(
            camera=CAM, tsdf=TSDFConfig(voxel_size=0.01, sdf_trunc=0.04,
                                        dims=(256, 256, 128)))
        fitted = auto_volume_config(batch, intr, cfg)
        X, Y, Z = fitted.tsdf.dims
        # the group spans ~3 m in y (chairs at -2.1 and -4.7): the fitted
        # volume must grow past the 2.56 m default on that axis
        assert Y > 256 and Y % 64 == 0
        assert X >= 256 and Z >= 128
        # the fitted volume covers every group object footprint
        ox, oy, _ = fitted.tsdf.origin
        for o in group.objects:
            assert ox < o.center[0] < ox + X * 0.01
            assert oy < o.center[1] < oy + Y * 0.01

    def test_small_object_keeps_default_dims(self):
        from otslam_tpu.config import ReconstructionConfig, TSDFConfig
        from otslam_tpu.pipeline.reconstruct import auto_volume_config
        from otslam_tpu.sim.world import cardboard_room

        scene = cardboard_room()
        batch, intr = self._batch_for(scene, (1.5, 0.5), 1.0)
        cfg = ReconstructionConfig(
            camera=CAM, tsdf=TSDFConfig(voxel_size=0.01, sdf_trunc=0.04,
                                        dims=(128, 128, 64)))
        fitted = auto_volume_config(batch, intr, cfg)
        assert fitted.tsdf.dims == (128, 128, 64)
