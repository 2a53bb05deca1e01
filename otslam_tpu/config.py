"""Typed configuration tree for otslam_tpu.

One dataclass per subsystem, with the same parameter names and defaults as the
reference's ROS 2 parameter declarations / script CONFIG blocks, so tuned
reference configs translate 1:1. (Reference: ROS params declared per node,
e.g. lidar_cluster_publisher.cpp:72-87, 3_multi_object_goal_selector.cpp:40-55,
diff_node.cpp:30-39, scanner_node.cpp:102-109; offline constants at the top of
3d_model/*.py and fusion/*.py.)

All configs are plain frozen dataclasses: hashable, so they can be closed over
by jitted functions as static configuration.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole RGB-D camera (reference: reconstruct_rgbd.py:12-15, model.sdf:377-433)."""

    width: int = 640
    height: int = 480
    fx: float = 565.6009
    fy: float = 565.6009
    cx: float = 320.5
    cy: float = 240.5
    depth_scale: float = 1000.0  # stored uint16 mm -> meters
    depth_trunc: float = 3.0     # meters; deeper returns ignored during fusion
    depth_max: float = 5.0       # capture-side far clip (scanner_node.cpp:279)


@dataclass(frozen=True)
class TSDFConfig:
    """Dense per-object TSDF volume (reference: reconstruct_rgbd.py:79-83)."""

    voxel_size: float = 0.01
    sdf_trunc: float = 0.04
    # Fixed-extent dense grid, HBM-resident. Objects are at most a few meters;
    # 256^3 @ 1 cm = 2.56 m cube. Dims are multiples of the 8^3 block.
    dims: Tuple[int, int, int] = (256, 256, 256)
    origin: Tuple[float, float, float] = (-1.28, -1.28, -0.28)
    max_weight: float = 10000.0  # weight saturation (keeps running mean stable)
    use_bfloat16: bool = False   # store tsdf/color in bf16 to halve HBM traffic


@dataclass(frozen=True)
class ReconstructionConfig:
    """Offline per-object reconstruction (reference: reconstruct_rgbd_filter.py:20-34)."""

    z_filter_threshold: float = 0.03   # floor removal: keep Z >= this
    surface_samples: int = 100_000     # points sampled from the extracted surface
    camera: CameraConfig = field(default_factory=CameraConfig)
    tsdf: TSDFConfig = field(default_factory=TSDFConfig)


@dataclass(frozen=True)
class LidarConfig:
    """2D LiDAR model (reference: turtlebot3_waffle/model.sdf:132-150)."""

    num_beams: int = 1440
    angle_min: float = 0.0
    angle_max: float = 6.28318530718  # 2*pi
    range_min: float = 0.3
    range_max: float = 10.0
    rate_hz: float = 5.0


@dataclass(frozen=True)
class ClusterConfig:
    """LiDAR cluster classifier (reference: lidar_cluster_publisher.cpp:72-102)."""

    gap_threshold: float = 0.2      # consecutive-point gap that splits clusters
    max_range_ratio: float = 0.9    # use returns below range_max * ratio
    wal_len_min: float = 2.0        # WALL: bbox diagonal > this
    obj_len_max: float = 1.0        # OBJECT: bbox diagonal < this
    wal_lin_max: float = 0.001      # WALL: PCA linearity ratio < this
    obj_nmp_min: int = 10           # OBJECT: min points
    wal_nmp_min: int = 20           # WALL: min points
    max_clusters: int = 64          # static capacity for padded cluster arrays

    @classmethod
    def initial_mapping_profile(cls) -> "ClusterConfig":
        """Tuned values from lidar_navigation.launch.py:15-28 (first mapping
        session, raw 1440-beam scans)."""
        return cls(gap_threshold=0.2, max_range_ratio=1.0, wal_len_min=2.0,
                   obj_len_max=1.0, wal_lin_max=0.001, obj_nmp_min=1,
                   wal_nmp_min=150)


@dataclass(frozen=True)
class ChangeDetectConfig:
    """Scan-diff change detector (reference: diff_node.cpp:30-39)."""

    distance_threshold: float = 0.5
    time_threshold: float = 2.0
    grid_resolution: float = 0.1
    decay_rate: float = 0.5
    search_window: int = 20          # +/- beams when matching real vs virtual
    # static extent of the dense evidence grid, in cells, centered on origin
    grid_cells: Tuple[int, int] = (512, 512)


@dataclass(frozen=True)
class TrackerConfig:
    """Object tracker & visiting points (reference: 3_multi_object_goal_selector.cpp:40-55).

    Defaults are the node's declared defaults; ``update_pipeline_profile``
    is the tuned configuration from the canonical launch file.
    """

    cluster_distance_threshold: float = 0.4
    min_cluster_points: int = 10
    wall_thickness_threshold: float = 0.2
    stability_time: float = 3.0
    lock_margin: float = 0.5
    smoothing_factor: float = 1.0
    visiting_point_buffer: float = 0.2
    scan_point_interval: float = 1.0
    scan_point_interval_removed: float = 5.0
    min_scan_points: int = 4
    unseen_prune_time: float = 0.5   # candidates pruned if unseen this long
    # Visiting-point placement strategy. "uniform-distance" is the current
    # design (3_multi_object_goal_selector.cpp:275-308); the two legacy modes
    # reproduce the superseded selector iterations kept in the reference tree:
    #   "adaptive-count": fixed 6/8 points by bbox diagonal, ids obj*10+i
    #                     (object_goal_selector.cpp:236-268)
    #   "degree-step":    ceil(360/degree) points at fixed angular step,
    #                     ids obj*100+i (multi_object_goal_selector.cpp:243-270)
    visiting_mode: str = "uniform-distance"
    scan_step_threshold: float = 1.0     # diagonal (m) switching 6 -> 8 points
    points_count_normal: int = 6         # adaptive-count: small objects
    points_count_big: int = 8            # adaptive-count: big objects
    degree_visiting_points: float = 10.0  # degree-step: angular interval (deg)
    # Group member sub-segmentation (0.0 = off). The tuned 4 m cluster
    # radius deliberately merges e.g. table + 4 chairs into ONE tracked
    # object (the reference's association behavior) — but a single capture
    # circle around the merged group reconstructs outer members from far
    # oblique views (25-30 cm accuracy vs the published 2.63 cm). With a
    # positive threshold, each group's evidence cells are single-linkage
    # sub-clustered at this (smaller) distance and every member gets its
    # own capture circle + scan label, reproducing the reference's
    # per-object eval-scan geometry while keeping group-level tracking.
    member_distance_threshold: float = 0.0
    # circle sizing for member scans: members use this margin instead of
    # lock_margin. 1.0 m puts a 0.45 m chair's camera at ~1.42 m — the
    # closest distance from which a 0.3 m-high camera still sees a 0.9 m
    # object top inside the VGA vertical half-FOV (atan(cy/fy) ~ 23 deg:
    # 0.3 + 0.425 * 1.42 = 0.90 m); the tuned 1.5 m group margin would
    # push it past 1.9 m for no completeness gain
    member_lock_margin: float = 1.0

    @classmethod
    def update_pipeline_profile(cls) -> "TrackerConfig":
        """Tuned values wired by 3_virtual_lidar_navigation.launch.py:46-60
        (grid-cell inputs from the change detector, not raw scan points)."""
        return cls(
            cluster_distance_threshold=4.0,
            min_cluster_points=1,
            wall_thickness_threshold=0.3,
            stability_time=1.0,
            lock_margin=1.5,
            smoothing_factor=1.0,
            visiting_point_buffer=0.1,
            # per-member capture circles inside merged groups: 0.35 m
            # separates the full_room table/chair footprints (smallest
            # inter-member CELL-CENTER gap is ~0.46 m once the 0.1 m
            # evidence-grid discretization eats up to a cell from the
            # 0.56 m footprint gap) while staying far above the 0.14 m
            # diagonal spacing of cells inside one body
            member_distance_threshold=0.35,
        )

    @classmethod
    def initial_mapping_profile(cls) -> "TrackerConfig":
        """Tuned values from lidar_navigation.launch.py:36-44 (raw scan-point
        clusters from the classifier)."""
        return cls(
            cluster_distance_threshold=4.0,
            min_cluster_points=8,
            wall_thickness_threshold=0.3,
            lock_margin=1.5,
            visiting_point_buffer=0.1,
        )


@dataclass(frozen=True)
class MissionConfig:
    """Goal queue + manager FSM (reference: 3_multi_send_goal_node.cpp:38-39, manager_node.cpp:158-161)."""

    reach_threshold: float = 0.60
    goal_dedupe_distance: float = 0.05
    control_rate_hz: float = 5.0
    scan_radius: float = 1.0         # ScanObject goal radius (manager_node.cpp:227)
    wait_time: float = 5.0           # camera stabilization wait (scanner_node.cpp:107)
    # The reference retries a failed navigation goal forever
    # (manager_node.cpp:202-207) and relies on Nav2 eventually succeeding;
    # a goal that is physically unreachable (e.g. a visiting point inside a
    # wall) would livelock the mission. Skip it after this many failures.
    max_nav_failures: int = 3


@dataclass(frozen=True)
class MapConfig:
    """2D occupancy map conventions (slam_toolbox PGM+YAML, hybrid_map.py:31-59)."""

    occupied_threshold: int = 100    # pgm pixel < this  => occupied
    unknown_value: int = 205         # pgm unknown gray
    unknown_band: int = 5            # +/- band treated as unknown in merges
    occupied_cell_value: int = 100   # occupancy-grid cell value for "occupied"


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation protocol (reference: eval_table_chair.py:90-119)."""

    gt_samples: int = 50_000
    icp_threshold: float = 0.05
    icp_max_iterations: int = 2000
    chamfer_tile: int = 2048         # tile size for the distance kernel


@dataclass(frozen=True)
class DistributedConfig:
    """Device-mesh scaling of fusion/eval workloads."""

    data_axis: str = "data"          # frames sharded over this axis
    model_axis: str = "model"        # voxel grid sharded over this axis


@dataclass(frozen=True)
class OTSLAMConfig:
    """Root configuration tree."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    tsdf: TSDFConfig = field(default_factory=TSDFConfig)
    reconstruction: ReconstructionConfig = field(default_factory=ReconstructionConfig)
    lidar: LidarConfig = field(default_factory=LidarConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    change_detect: ChangeDetectConfig = field(default_factory=ChangeDetectConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    mission: MissionConfig = field(default_factory=MissionConfig)
    map: MapConfig = field(default_factory=MapConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "OTSLAMConfig":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "OTSLAMConfig":
        return cls.from_dict(json.loads(s))


def _from_dict(cls: type, d: dict) -> Any:
    """Recursively build a (possibly nested) frozen dataclass from a dict."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        # f.type may be a string (PEP 563); recover nested dataclass types from
        # the default_factory, which is always set for nested configs here.
        sub = f.default_factory if f.default_factory is not dataclasses.MISSING else None
        if sub is not None and dataclasses.is_dataclass(sub) and isinstance(v, dict):
            kwargs[f.name] = _from_dict(sub, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
