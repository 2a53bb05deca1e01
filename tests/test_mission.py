"""Mission layer: tracker, visiting points, goal queue, manager FSM, scanner."""

import numpy as np

from otslam_tpu.config import MissionConfig, TrackerConfig, CameraConfig
from otslam_tpu.mission.tracker import ObjectTracker, TrackedCluster
from otslam_tpu.mission.visiting import visiting_points, REMOVED_ID_BASE
from otslam_tpu.mission.goal_queue import GoalSender, TargetPoint, decode_marker_id
from otslam_tpu.mission.manager import SystemManager, ManagerState
from otslam_tpu.mission.scanner import ScannerNode, ScanObjectGoal
from otslam_tpu.pipeline.dataset import CaptureDataset


def blob(cx, cy, n=16, r=0.25, seed=0):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.6 * r, r, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1)


class TestTracker:
    def test_candidate_promotion_after_stability_time(self):
        tr = ObjectTracker(TrackerConfig())
        pts = blob(2.0, 1.0)
        t = 0.0
        for _ in range(18):  # 3.4 s at 5 Hz
            t += 0.2
            tr.update(pts, t)
        assert len(tr.stable_objects) == 1
        s = tr.stable_objects[0]
        assert np.hypot(s.cx - 2.0, s.cy - 1.0) < 0.2
        assert s.stable

    def test_candidate_pruned_when_unseen(self):
        tr = ObjectTracker(TrackerConfig())
        tr.update(blob(2.0, 1.0), 0.2)
        assert len(tr.candidates) == 1
        tr.update([], 1.0)  # 0.8 s unseen > 0.5 s threshold
        assert len(tr.candidates) == 0

    def test_freeze_ignores_updates(self):
        tr = ObjectTracker(TrackerConfig())
        tr.set_tracking_mode(False)
        for i in range(20):
            tr.update(blob(2.0, 1.0), 0.2 * (i + 1))
        assert len(tr.candidates) == 0 and len(tr.stable_objects) == 0

    def test_thin_clusters_rejected_as_walls(self):
        tr = ObjectTracker(TrackerConfig())
        line = np.stack([np.linspace(0, 1.0, 20), np.zeros(20)], -1)
        for i in range(20):
            tr.update(line, 0.2 * (i + 1))
        assert len(tr.stable_objects) == 0

    def test_stable_absorbs_nearby_observations(self):
        tr = ObjectTracker(TrackerConfig())
        t = 0.0
        for _ in range(18):
            t += 0.2
            tr.update(blob(2.0, 1.0), t)
        n_stable = len(tr.stable_objects)
        # slightly shifted observations fall inside the lock radius
        for _ in range(18):
            t += 0.2
            tr.update(blob(2.2, 1.1, seed=3), t)
        assert len(tr.stable_objects) == n_stable  # absorbed, no new object


class TestVisitingPoints:
    def test_uniform_spacing_count_and_orientation(self):
        cfg = TrackerConfig()
        c = TrackedCluster(0.0, 0.0, 0.5, 0.5, 1.0, 0, 0, True)
        vps = visiting_points([c], cfg)
        # radius 1.2, circumference 7.54 -> 8 points at 1.0 m interval
        assert len(vps) == 8
        for i, p in enumerate(vps):
            ang = 2 * np.pi * i / 8
            np.testing.assert_allclose([p.x, p.y],
                                       [1.2 * np.cos(ang), 1.2 * np.sin(ang)],
                                       atol=1e-6)
            assert np.isclose(p.yaw, ang + np.pi)
            assert p.unique_id == i and p.object_id == 0

    def test_min_scan_points_floor(self):
        cfg = TrackerConfig()
        c = TrackedCluster(0.0, 0.0, 0.1, 0.1, 0.1, 0, 0, True)
        assert len(visiting_points([c], cfg)) == cfg.min_scan_points

    def test_removed_interval_and_ids(self):
        cfg = TrackerConfig()
        c = TrackedCluster(0.0, 0.0, 0.5, 0.5, 1.0, 0, 0, True)
        vps = visiting_points([c], cfg, removed=True)
        assert len(vps) == cfg.min_scan_points  # 5 m interval -> floor of 4
        assert all(p.unique_id >= REMOVED_ID_BASE and p.is_removed
                   for p in vps)

    def test_marker_id_decode(self):
        assert decode_marker_id(237, False) == 2
        assert decode_marker_id(REMOVED_ID_BASE + 3, True) == 3


class TestGoalSender:
    def mk_points(self):
        c0 = TrackedCluster(0.0, 0.0, 0.5, 0.5, 1.0, 0, 0, True)
        c1 = TrackedCluster(5.0, 0.0, 0.5, 0.5, 1.0, 0, 0, True)
        return visiting_points([c0, c1], TrackerConfig())

    def test_greedy_picks_nearest_then_sticky_same_object(self):
        gs = GoalSender(MissionConfig())
        gs.on_added_points(self.mk_points())
        gs.on_odom(1.5, 0.1)
        g1 = gs.control_step()
        assert g1 is not None and g1.object_id == 0  # nearest is object 0
        # teleport to the goal -> visited; next goal stays on object 0
        gs.on_odom(g1.x, g1.y)
        g2 = gs.control_step()   # marks visited, picks next
        assert g2 is not None and g2.object_id == 0
        assert g2.unique_id != g1.unique_id

    def test_completes_object_before_moving_on(self):
        gs = GoalSender(MissionConfig())
        pts = self.mk_points()
        gs.on_added_points(pts)
        gs.on_odom(0.0, 0.0)
        seen_objects = []
        for _ in range(40):
            g = gs.control_step()
            if g is None:
                break
            seen_objects.append(g.object_id)
            gs.on_odom(g.x, g.y)  # teleport
            gs.on_added_points(pts)
        # all of object 0's points come before any of object 1's
        first_obj1 = seen_objects.index(1)
        assert all(o == 0 for o in seen_objects[:first_obj1])
        assert all(o == 1 for o in seen_objects[first_obj1:])
        assert gs.pending_count() == 0

    def test_republish_while_distant(self):
        gs = GoalSender(MissionConfig())
        gs.on_added_points(self.mk_points())
        gs.on_odom(0.0, 3.0)
        g1 = gs.control_step()
        g2 = gs.control_step()
        assert g2 is not None and g2.unique_id == g1.unique_id


class FakeNav:
    def __init__(self, fail_first=False):
        self.calls = []
        self.fail_first = fail_first

    def __call__(self, x, y, yaw):
        self.calls.append((x, y, yaw))
        if self.fail_first and len(self.calls) == 1:
            return False
        return True


class TestManager:
    def mk(self, fail_first=False):
        nav = FakeNav(fail_first)
        scans = []
        tracking = []
        mgr = SystemManager(nav, lambda *a: scans.append(a) or True,
                            tracking.append, MissionConfig())
        return mgr, nav, scans, tracking

    def test_full_mission_freeze_protocol(self):
        mgr, nav, scans, tracking = self.mk()
        assert tracking == [True]  # initial unfreeze
        t = TargetPoint(0, 0, 1.0, 2.0, 0.5, False)
        assert mgr.on_goal(t)
        # new id -> unfreeze; arrival -> freeze; scan fired with label
        assert tracking == [True, True, False]
        assert scans == [("Object_0", 1.0, 2.0, 1.0)]
        assert mgr.state == ManagerState.IDLE

    def test_same_object_stays_frozen(self):
        mgr, nav, scans, tracking = self.mk()
        mgr.on_goal(TargetPoint(0, 0, 1.0, 2.0, 0.0, False))
        n = len(tracking)
        mgr.on_goal(TargetPoint(1, 0, 3.0, 2.0, 0.0, False))
        # second goal, same object id: no unfreeze before nav (only the
        # arrival freeze is appended)
        assert tracking[n:] == [False]

    def test_goal_dedupe(self):
        mgr, nav, scans, tracking = self.mk()
        mgr.on_goal(TargetPoint(0, 0, 1.0, 2.0, 0.0, False))
        assert not mgr.on_goal(TargetPoint(1, 0, 1.02, 2.02, 0.0, False))
        assert len(scans) == 1

    def test_nav_failure_retries_same_point(self):
        mgr, nav, scans, tracking = self.mk(fail_first=True)
        t = TargetPoint(0, 0, 1.0, 2.0, 0.0, False)
        assert not mgr.on_goal(t)
        assert mgr.state == ManagerState.IDLE and not scans
        # retry same point succeeds (dedupe bypassed via first_goal_received)
        assert mgr.on_goal(t)
        assert len(scans) == 1


class TestScanner:
    def test_capture_roundtrip(self, tmp_path):
        ds = CaptureDataset(str(tmp_path), CameraConfig(width=8, height=6))
        color = np.full((6, 8, 3), 128, np.uint8)
        depth = np.full((6, 8), 1.5, np.float32)
        pose = np.eye(4)
        slept = []
        sc = ScannerNode(ds, lambda: (color, depth), lambda: pose,
                         sleep=slept.append)
        res = sc.execute(ScanObjectGoal("Object_0", 1.0, 2.0))
        assert res.success and res.frame_number == 1
        assert slept == [5.0, 5.0]  # stabilization + cool-down
        res2 = sc.execute(ScanObjectGoal("Object_0", 1.0, 2.0))
        assert res2.frame_number == 2
        batch = ds.load_object("Object_0")
        assert batch.depths.shape == (2, 6, 8)
        np.testing.assert_allclose(batch.depths[0], 1.5, atol=1e-3)

    def test_camera_timeout(self, tmp_path):
        ds = CaptureDataset(str(tmp_path))
        sc = ScannerNode(ds, lambda: None, lambda: np.eye(4))
        res = sc.execute(ScanObjectGoal("Object_0", 0, 0))
        assert not res.success and "Timeout" in res.message


class TestSpatialClustering:
    """cluster_points_spatial_host: the tracker's order-independent
    clustering (single-linkage) — the received-order gap chaining it
    replaces shattered interleaved distant objects into thin per-row
    fragments (round-4 full_room mission bug)."""

    def test_interleaved_rows_cluster_by_object(self):
        import numpy as np

        from otslam_tpu.kernels.cluster import cluster_points_spatial_host

        # two compact objects 10 m apart, cells interleaved row-major (the
        # evidence-grid compaction order)
        rows = []
        for y in (0.0, 0.1, 0.2):
            rows += [(-4.0, y), (-3.9, y), (6.0, y), (6.1, y)]
        pts = np.asarray(rows, np.float32)
        labels, num = cluster_points_spatial_host(pts, 4.0)
        assert num == 2
        left = labels[pts[:, 0] < 0]
        right = labels[pts[:, 0] > 0]
        assert len(set(left.tolist())) == 1
        assert len(set(right.tolist())) == 1
        assert left[0] != right[0]

    def test_matches_sequential_on_scan_ordered_input(self):
        import numpy as np

        from otslam_tpu.kernels.cluster import (cluster_points_host,
                                                cluster_points_spatial_host)

        rng = np.random.default_rng(0)
        # three well-separated objects, points in contiguous scan order
        pts = np.concatenate([
            rng.normal((0, 0), 0.1, (12, 2)),
            rng.normal((5, 0), 0.1, (9, 2)),
            rng.normal((0, 6), 0.1, (7, 2))]).astype(np.float32)
        l_seq, n_seq = cluster_points_host(pts, 1.0)
        l_sp, n_sp = cluster_points_spatial_host(pts, 1.0)
        assert n_seq == n_sp == 3
        np.testing.assert_array_equal(l_seq, l_sp)

    def test_empty(self):
        import numpy as np

        from otslam_tpu.kernels.cluster import cluster_points_spatial_host

        labels, num = cluster_points_spatial_host(
            np.zeros((0, 2), np.float32), 1.0)
        assert num == 0 and len(labels) == 0


class TestNavFailureSkip:
    """Unreachable goals must not livelock: the queue skips a target after
    cfg.max_nav_failures failed navigations (the reference retries forever,
    manager_node.cpp:202-207, leaning on Nav2 to eventually succeed)."""

    def test_skip_after_max_failures(self):
        from otslam_tpu.config import MissionConfig
        from otslam_tpu.mission.goal_queue import GoalSender, TargetPoint

        s = GoalSender(MissionConfig(max_nav_failures=3))
        t = TargetPoint(7, 0, 5.0, 5.0, 0.0, False)
        s.added_targets = [t]
        s.on_odom(0.0, 0.0)
        assert s.control_step() is t
        for _ in range(2):
            s.report_nav_failure(t)
        assert 7 not in s.visited_ids
        s.report_nav_failure(t)
        assert 7 in s.visited_ids and 7 in s.skipped_ids
        assert s.active_target is None
        assert s.control_step() is None

    def test_removed_target_skips_into_removed_set(self):
        from otslam_tpu.config import MissionConfig
        from otslam_tpu.mission.goal_queue import GoalSender, TargetPoint

        s = GoalSender(MissionConfig(max_nav_failures=1))
        t = TargetPoint(5003, 0, 5.0, 5.0, 0.0, True)
        s.report_nav_failure(t)
        assert 5003 in s.visited_removed_ids

    def test_manager_reports_failure(self):
        from otslam_tpu.config import MissionConfig
        from otslam_tpu.mission.goal_queue import TargetPoint
        from otslam_tpu.mission.manager import SystemManager

        failed = []
        m = SystemManager(lambda x, y, yaw: False, lambda *a: True,
                          lambda e: None, MissionConfig())
        m.nav_failure_cb = failed.append
        t = TargetPoint(1, 0, 1.0, 1.0, 0.0, False)
        assert m.on_goal(t) is False
        assert failed == [t]


class TestGoalCollision:
    """_navigate refuses goals inside world geometry or outside the room
    (Nav2-planner-failure equivalent): a teleport into a wall produced
    degenerate scans that broke localization (round-4 full_room bug)."""

    def test_goal_in_wall_fails_and_goal_in_free_space_succeeds(self, tmp_path):
        from otslam_tpu.config import OTSLAMConfig
        from otslam_tpu.sim.runner import MissionRunner
        from otslam_tpu.sim.world import Box, Scene

        scene = Scene(objects=(Box((1.0, 1.0, 0.2), (0.6, 0.6, 0.4), 0.0,
                                   (0.5, 0.5, 0.5), "b"),))
        r = MissionRunner(Scene(objects=()), scene, str(tmp_path),
                          OTSLAMConfig())
        assert r._navigate(0.0, -2.0, 0.0) is True
        assert r._navigate(5.6, 0.0, 0.0) is False      # inside east wall
        assert r._navigate(0.0, 8.0, 0.0) is False      # outside the room
        assert r._navigate(1.0, 1.0, 0.0) is False      # inside the box
        assert r.nav_failures == 3


def test_removed_check_label_distinct_from_added():
    """A removed-object check scan must not save under an added object's
    label (both trackers' indices start at 0; a collision would pollute
    the added object's reconstruction frames)."""
    from otslam_tpu.config import MissionConfig
    from otslam_tpu.mission.goal_queue import TargetPoint
    from otslam_tpu.mission.manager import SystemManager

    labels = []
    m = SystemManager(lambda x, y, yaw: True,
                      lambda label, x, y, r: labels.append(label) or True,
                      lambda e: None, MissionConfig())
    assert m.on_goal(TargetPoint(0, 0, 1.0, 1.0, 0.0, False))
    assert m.on_goal(TargetPoint(5000, 0, 3.0, 3.0, 0.0, True))
    assert labels == ["Object_0", "Removed_0"]


def test_thin_filter_tolerant_to_cell_center_ulps():
    """An object spanning exactly wall_thickness_threshold (3 grid cells =
    0.30 m) must survive the thin filter regardless of f32 ulp noise in
    the cell-center coordinates (observed: the same cells computed on an
    accelerator gave span 0.2999997 vs 0.30000019 on CPU, flipping
    detection)."""
    import numpy as np

    from otslam_tpu.config import TrackerConfig
    from otslam_tpu.mission.tracker import ObjectTracker

    cfg = TrackerConfig(cluster_distance_threshold=4.0, min_cluster_points=1,
                        wall_thickness_threshold=0.3)
    tr = ObjectTracker(cfg)
    ys = np.float32([-4.049999713897705, -3.8500001430511475, -3.75])
    pts = np.stack([np.float32([3.75, 3.95, 4.25]), ys], -1)
    assert float(pts[:, 1].max() - pts[:, 1].min()) < 0.3  # the ulp case
    obs = tr._cluster_observations(pts, 0.0)
    assert len(obs) == 1


class TestMemberSegmentation:
    """Merged-group member sub-segmentation: the tuned 4 m
    cluster radius merges table+chairs into one tracked group; with
    member_distance_threshold on, each body becomes its own capture site."""

    # footprint-grid evidence for a table (1.4x0.8 at (-2.23,-3.31)) and
    # two chairs (0.45 sq) at the full_room placements, 5 cm cells
    @staticmethod
    def _group_cells():
        def grid(cx, cy, w, h):
            xs = np.arange(cx - w / 2, cx + w / 2 + 1e-6, 0.05)
            ys = np.arange(cy - h / 2, cy + h / 2 + 1e-6, 0.05)
            return np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
        return np.concatenate([grid(-2.23, -3.31, 1.4, 0.8),
                               grid(-1.71, -2.1, 0.45, 0.45),
                               grid(-2.72, -2.1, 0.45, 0.45)])

    def test_group_tracks_as_one_with_three_members(self):
        cfg = TrackerConfig.update_pipeline_profile()
        tr = ObjectTracker(cfg)
        pts = self._group_cells()
        t = 0.0
        while not tr.stable_objects:
            tr.update(pts, t)
            t += 0.2
            assert t < 10
        # ONE tracked group (reference association semantics preserved)...
        assert len(tr.stable_objects) == 1
        g = tr.stable_objects[0]
        # ...carrying one member per physical body
        assert len(g.members) == 3
        centers = sorted((round(m.cx, 2), round(m.cy, 2)) for m in g.members)
        assert centers == [(-2.72, -2.1), (-2.23, -3.31), (-1.71, -2.1)]
        for m in g.members:
            assert not m.members  # members don't nest

    def test_visiting_points_per_member(self):
        from otslam_tpu.mission.visiting import scan_sites

        cfg = TrackerConfig.update_pipeline_profile()
        tr = ObjectTracker(cfg)
        pts = self._group_cells()
        t = 0.0
        while not tr.stable_objects:
            tr.update(pts, t)
            t += 0.2
        sites = scan_sites(tr.stable_objects)
        assert len(sites) == 3
        vps = visiting_points(tr.stable_objects, cfg)
        # three distinct object ids -> three scan labels/datasets
        assert {p.object_id for p in vps} == {0, 1, 2}
        assert len({p.unique_id for p in vps}) == len(vps)
        # each member circle faces ITS member, at the member-scale radius
        for p in vps:
            m = sites[p.object_id]
            r = np.hypot(p.x - m.cx, p.y - m.cy)
            assert np.isclose(
                r, np.hypot(m.width, m.height) / 2
                + cfg.member_lock_margin + cfg.visiting_point_buffer,
                rtol=1e-6)
            assert r < 2.0  # chair circles ~1.42 m, table ~1.91 m

    def test_disabled_by_default_keeps_group_behavior(self):
        cfg = TrackerConfig(cluster_distance_threshold=4.0,
                            min_cluster_points=1,
                            wall_thickness_threshold=0.3,
                            stability_time=1.0, lock_margin=1.5)
        assert cfg.member_distance_threshold == 0.0
        tr = ObjectTracker(cfg)
        pts = self._group_cells()
        t = 0.0
        while not tr.stable_objects:
            tr.update(pts, t)
            t += 0.2
        g = tr.stable_objects[0]
        assert g.members == ()
        vps = visiting_points(tr.stable_objects, cfg)
        assert {p.object_id for p in vps} == {0}

    def test_single_body_group_has_no_members(self):
        cfg = TrackerConfig.update_pipeline_profile()
        tr = ObjectTracker(cfg)
        pts = self._group_cells()[:15 * 29]  # table cells only
        t = 0.0
        while not tr.stable_objects:
            tr.update(pts, t)
            t += 0.2
        assert tr.stable_objects[0].members == ()

    def test_late_member_adoption_keeps_site_ids_stable(self):
        """stability_time promotes a group before the robot has seen every
        member; later evidence must ADD sites without shifting the ids of
        already-known ones (visited uids / capture labels stay valid)."""
        cfg = TrackerConfig.update_pipeline_profile()
        tr = ObjectTracker(cfg)
        cells = self._group_cells()
        north = cells[cells[:, 1] > -3.0]     # the two chairs only
        t = 0.0
        while not tr.stable_objects:
            tr.update(north, t)
            t += 0.2
        g = tr.stable_objects[0]
        first_ids = {(round(m.cx, 2), round(m.cy, 2)): m.site_id
                     for m in g.members}
        assert len(first_ids) == 2 and all(i >= 0 for i in first_ids.values())
        # full group evidence arrives while stable (frozen geometry)
        tr.update(cells, t)
        assert len(g.members) == 3
        for m in g.members:
            key = (round(m.cx, 2), round(m.cy, 2))
            if key in first_ids:
                assert m.site_id == first_ids[key]   # unchanged
            else:
                assert m.site_id >= 2                # fresh id, appended
        vps = visiting_points(tr.stable_objects, cfg)
        assert {p.object_id for p in vps} == {m.site_id for m in g.members}

    def test_memberless_stable_group_adopts_late_split(self):
        """A group that promoted as a single blob switches to per-member
        circles when later evidence reveals distinct bodies."""
        cfg = TrackerConfig.update_pipeline_profile()
        tr = ObjectTracker(cfg)
        cells = self._group_cells()
        table_only = cells[cells[:, 1] < -2.8]
        t = 0.0
        while not tr.stable_objects:
            tr.update(table_only, t)
            t += 0.2
        g = tr.stable_objects[0]
        assert g.members == () and g.site_id == 0
        tr.update(cells, t)
        assert len(g.members) == 3
        vps = visiting_points(tr.stable_objects, cfg)
        assert {p.object_id for p in vps} == {m.site_id for m in g.members}
        # members take fresh site ids: none reuses the group's own site
        member_ids = {m.site_id for m in g.members}
        assert len(member_ids) == len(g.members)
        assert g.site_id not in member_ids
