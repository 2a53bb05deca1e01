"""In-process pub-sub bus with the reference's topic/action names.

The reference's dataflow is ROS 2 DDS topics between processes (SURVEY.md
§2.4); the device pipeline is a host-side orchestration loop, but this
thin shim exposes the same topic names so reference-era tooling, logging, or
a future real ROS bridge can be dropped in without touching the core.

``OTSLAMSystem`` assembles the full online update pipeline on the bus:

    /scan, /virtual_scan            LaserScan-equivalent range arrays
    /added_objects, /removed_objects   change-detection cell clouds
    /object_visiting_points, /removed_object_visiting_points
    /manager/target_pose            selected goal
    set_tracking_mode               freeze service
    scan_object                     capture action
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List

from otslam_tpu.config import OTSLAMConfig
from otslam_tpu.mapping.change_detect import ChangeDetector
from otslam_tpu.mapping.virtual_scan import VirtualScanner
from otslam_tpu.mission.goal_queue import GoalSender
from otslam_tpu.mission.tracker import ObjectTracker
from otslam_tpu.mission.visiting import visiting_points


class Bus:
    """Synchronous topic bus (publish calls subscribers inline, in order)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        self._services: Dict[str, Callable] = {}
        self.last: Dict[str, Any] = {}

    def subscribe(self, topic: str, cb: Callable) -> None:
        self._subs[topic].append(cb)

    def publish(self, topic: str, msg: Any) -> None:
        self.last[topic] = msg
        for cb in self._subs[topic]:
            cb(msg)

    def advertise_service(self, name: str, handler: Callable) -> None:
        self._services[name] = handler

    def call(self, name: str, *args, **kw):
        return self._services[name](*args, **kw)


class OTSLAMSystem:
    """The online update pipeline assembled over reference topic names."""

    def __init__(self, cfg: OTSLAMConfig | None = None, bus: Bus | None = None):
        self.cfg = cfg or OTSLAMConfig()
        self.bus = bus or Bus()
        self.vscanner = VirtualScanner(self.cfg.lidar)
        self.detector = ChangeDetector(self.cfg.change_detect, self.cfg.lidar)
        self.tracker = ObjectTracker(self.cfg.tracker)
        self.removed_tracker = ObjectTracker(self.cfg.tracker)
        self.sender = GoalSender(self.cfg.mission)
        self._now = 0.0

        b = self.bus
        b.subscribe("/virtual_map", lambda g: self.vscanner.set_map(g))
        b.subscribe("/virtual_scan", lambda m: self.detector.on_virtual_scan(
            m["ranges"]))
        b.subscribe("/scan", self._on_scan)
        b.subscribe("/added_objects", lambda pts: (
            self.tracker.update(pts, self._now),
            b.publish("/object_visiting_points",
                      visiting_points(self.tracker.stable_objects,
                                      self.cfg.tracker))))
        b.subscribe("/removed_objects", lambda pts: (
            self.removed_tracker.update(pts, self._now),
            b.publish("/removed_object_visiting_points",
                      visiting_points(self.removed_tracker.stable_objects,
                                      self.cfg.tracker, removed=True))))
        b.subscribe("/object_visiting_points", self.sender.on_added_points)
        b.subscribe("/removed_object_visiting_points",
                    self.sender.on_removed_points)
        b.subscribe("/odom", lambda xy: self.sender.on_odom(*xy))
        b.advertise_service("set_tracking_mode", self._set_tracking)

    def _set_tracking(self, enabled: bool):
        self.tracker.set_tracking_mode(enabled)
        self.removed_tracker.set_tracking_mode(enabled)
        return {"success": True,
                "message": "Tracking Enabled" if enabled else "Tracking Frozen"}

    def _on_scan(self, msg: dict) -> None:
        """msg: {ranges, angles, pose (x,y,yaw), stamp}."""
        self._now = msg["stamp"]
        if self.vscanner.has_map:
            virt = self.vscanner.scan(*msg["pose"])
            self.bus.publish("/virtual_scan", {"ranges": virt})
        self.detector.on_scan(msg["ranges"], msg["angles"], msg["pose"],
                              msg["stamp"])
        self.bus.publish("/added_objects", self.detector.added_objects())
        self.bus.publish("/removed_objects", self.detector.removed_objects())

    def control_step(self):
        """One goal-selection tick; publishes /manager/target_pose."""
        goal = self.sender.control_step()
        if goal is not None:
            self.bus.publish("/manager/target_pose", goal)
        return goal
