"""End-to-end headline claim: selective hybrid mapping vs dense mapping.

Automates the reference's flagship result — 99.0% map-data-size reduction
with accuracy better than the dense baseline (README.md:60,
eval/result_plot.py:8-18) — over the analytic simulator.
"""

import pytest

from otslam_tpu.eval.headline import headline_report

pytestmark = pytest.mark.slow


def test_headline_size_reduction_and_accuracy(tmp_path):
    rep = headline_report(str(tmp_path), frames_per_object=8, room_frames=12,
                          object_samples=20_000)
    # the flagship claim: >= 99.0% smaller than the dense map
    assert rep["size_reduction_percent"] >= rep["reference_claim_percent"]
    assert rep["dense_bytes"] > 100 * rep["hybrid_bytes"]
    # robust to the baseline-representation objection: even against a
    # 1 cm voxel-downsampled dense map the selective map is >=90% smaller
    assert rep["size_reduction_downsampled_percent"] >= 90.0
    # symmetric framing: both maps voxel-filtered at the reconstruction
    # voxel size (the per-member capture clouds of round 5 overlap, so the
    # raw selective bytes double-store shared surfaces)
    assert rep["size_reduction_voxel_percent"] >= 90.0
    assert rep["selective_downsampled_bytes"] < rep["hybrid_bytes"]
    m = rep["objects"]["Object_0"]
    # beats the published cardboard-box accuracy (4.15 cm,
    # eval/result_plot.py:9-10) by a wide margin
    assert m["proposal_accuracy_cm"] < 1.5
    assert m["proposal_completeness_cm"] < 1.5
    # report includes the dense-side metrics for the published-table shape
    assert "dense_accuracy_cm" in m and "dense_completeness_cm" in m
    assert rep["combined_accuracy_cm"] < 1.5


def test_headline_multi_object_table_chair(tmp_path):
    """Whole-scene headline on the 5-object table & chair room: the
    selective map stays >= 99% smaller AND beats the published combined
    accuracy (2.63 cm, eval/result_plot.py:9-10)."""
    from otslam_tpu.sim.world import table_chair_room
    # the dense sweep needs enough keyframes to stand in for a real dense
    # map (RTAB-Map's published 169 MB): 40 VGA keyframes ~ 120 MB vs
    # ~1 MB of sampled object clouds + PGM
    rep = headline_report(str(tmp_path), scene_fn=table_chair_room,
                          frames_per_object=8, room_frames=40,
                          object_samples=6_000)
    assert len(rep["objects"]) == 5
    assert rep["size_reduction_percent"] >= rep["reference_claim_percent"]
    assert rep["combined_accuracy_cm"] < 2.63


def test_headline_from_mission_objects_dir(tmp_path):
    """objects_dir mode: the report computes from pre-reconstructed PLYs
    (the mission-captured-data path) — clouds associate to
    scene objects by centroid, and the size story still holds."""
    import numpy as np

    from otslam_tpu.core import io as tio
    from otslam_tpu.eval.scenarios import sample_object_surfaces
    from otslam_tpu.sim.world import cardboard_room

    scene = cardboard_room()
    objdir = tmp_path / "recon"
    objdir.mkdir()
    # stand-in for a mission reconstruction: exact sampled surface points
    pts = sample_object_surfaces([scene.objects[0]], 5000, seed=1)
    pts = pts[pts[:, 2] >= 0.03]
    tio.write_ply(str(objdir / "Object_3.ply"), pts,
                  colors=np.full_like(pts, 0.5))
    rep = headline_report(str(tmp_path / "work"), room_frames=8,
                          objects_dir=str(objdir))
    m = rep["objects"]["cardboard_box"]
    assert m["cloud"] == "Object_3"          # centroid association
    assert m["proposal_accuracy_cm"] < 1.0   # exact surface points
    assert rep["size_reduction_percent"] > 99.0
    assert rep["hybrid_map_path"]


def test_headline_objects_dir_unscanned_objects(tmp_path):
    """Scene objects with no nearby reconstructed cloud report
    scanned=False instead of mis-associating a distant cloud."""
    import numpy as np

    from otslam_tpu.core import io as tio
    from otslam_tpu.eval.scenarios import sample_object_surfaces
    from otslam_tpu.sim.world import cone_room

    scene = cone_room()
    objdir = tmp_path / "recon"
    objdir.mkdir()
    pts = sample_object_surfaces([scene.objects[0]], 3000, seed=1)
    pts = pts[pts[:, 2] >= 0.03]
    tio.write_ply(str(objdir / "Object_0.ply"), pts,
                  colors=np.full_like(pts, 0.5))
    rep = headline_report(str(tmp_path / "work"), scene_fn=cone_room,
                          room_frames=8, objects_dir=str(objdir))
    assert rep["objects"]["cone_1"]["cloud"] == "Object_0"
    assert rep["objects"]["cone_2"] == {"scanned": False}
