"""Production-scale mission workflow as a script.

The full 5-object-group scene (table + 4 chairs + cardboard box + 2 cones,
the reference's cardboard_table_chairs_cones_room.world placements) run
closed-loop with the production estimated-pose stack:

1. mission with drifting odometry + scan-to-map localization AND a
   removed object seeded in the saved map (removed-check missions run
   alongside the added-object scans);
2. reconstruct the mission's own captured dataset (volumes auto-sized to
   each tracked group's capture-circle geometry);
3. headline report computed from that mission-captured data: per-object
   accuracy/completeness vs the analytic GT and the selective-vs-dense
   map-size reduction.

Run:  python examples/production_mission.py [workdir]

It runs on the default JAX device (set JAX_PLATFORMS=cpu for the CPU).
"""

import dataclasses as dc
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
    jax.config.update("jax_platforms", "cpu")

from otslam_tpu.config import OTSLAMConfig, TrackerConfig
from otslam_tpu.eval.headline import headline_report
from otslam_tpu.pipeline.dataset import CaptureDataset
from otslam_tpu.pipeline.reconstruct import reconstruct_all
from otslam_tpu.sim.runner import MissionRunner
from otslam_tpu.sim.world import Box, full_room


def main(workdir: str) -> dict:
    world = full_room()
    cfg = OTSLAMConfig(tracker=TrackerConfig.update_pipeline_profile())

    # 1. closed-loop mission: estimated poses + a removed-object check
    # (the saved map carries a box reality no longer has)
    phantom = Box((4.0, -4.0, 0.15), (0.5, 0.4, 0.3), 0.0,
                  (0.7, 0.7, 0.7), "removed_box")
    runner = MissionRunner(
        scene_map=dc.replace(world, objects=(phantom,)),
        scene_world=world, workdir=workdir, cfg=cfg,
        start_pose=(0.5, 4.5, 0.0),
        odom_noise_per_m=0.01, use_localizer=True,
        perception_batch=8)
    summary = runner.run(max_ticks=24000)
    print(f"mission: {summary.missions_completed} missions, labels "
          f"{summary.labels}, removed checks visited "
          f"{sorted(runner.sender.visited_removed_ids)}")

    # 2. reconstruct the captured dataset (per-object auto-sized volumes)
    ds = CaptureDataset(os.path.join(workdir, "dataset"), cfg.camera)
    objdir = os.path.join(workdir, "dataset", "3d_reconst")
    out = reconstruct_all(ds, cfg.reconstruction, backend="sparse",
                          save_dir=objdir, auto_origin=True)
    for name, res in out.items():
        print(f"  {name}: {len(res.points)} pts from {res.num_frames} frames")

    # 3. headline from the mission's own captures
    rep = headline_report(os.path.join(workdir, "headline"),
                          scene_fn=full_room, objects_dir=objdir)
    print(json.dumps({k: v for k, v in rep.items() if k != "objects"},
                     indent=1))
    return rep


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/otslam_production")
