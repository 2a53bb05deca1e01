from otslam_tpu.kernels.backproject import (  # noqa: F401
    filter_depth,
    backproject_depth,
    backproject_pointcloud,
)
from otslam_tpu.kernels.voxel import voxel_downsample  # noqa: F401
from otslam_tpu.kernels.tsdf import (  # noqa: F401
    TSDFVolume,
    make_volume,
    integrate_frame,
    integrate_frames,
    partial_integrate,
    merge_partials,
    extract_surface_points,
)
from otslam_tpu.kernels.tsdf_block import (  # noqa: F401
    BlockTSDFVolume,
    make_block_volume,
    integrate_frames_sparse,
    auto_max_active,
    extract_surface_points_sparse,
    block_to_dense,
    dense_to_block,
)
from otslam_tpu.kernels.marching import extract_mesh, extract_mesh_soup  # noqa: F401
from otslam_tpu.kernels.nn import (  # noqa: F401
    nn_distance,
    nn_distance_radius,
    auto_nn_window,
    nn_window_bounds,
    chamfer_metrics,
)
from otslam_tpu.kernels.icp import (  # noqa: F401
    icp_point_to_point,
    icp_point_to_plane,
    ICPResult,
)
from otslam_tpu.kernels.raycast import raycast_grid  # noqa: F401
from otslam_tpu.kernels.scan_diff import scan_diff  # noqa: F401
from otslam_tpu.kernels.evidence import (  # noqa: F401
    scatter_hits,
    update_evidence,
    evidence_points,
)
from otslam_tpu.kernels.cluster import (  # noqa: F401
    cluster_scan_points,
    analyze_clusters,
    scan_to_points,
    ClusterStats,
)
from otslam_tpu.kernels.sampling import resample_points  # noqa: F401
from otslam_tpu.kernels.pose_graph import (  # noqa: F401
    exp_se3,
    log_se3,
    optimize_pose_graph,
    PoseGraphResult,
)
from otslam_tpu.kernels.track import (  # noqa: F401
    sample_tsdf_trilinear,
    track_frame_to_tsdf,
    TrackResult,
)
