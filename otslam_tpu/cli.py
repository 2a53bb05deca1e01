"""Command-line interface.

One ``otslam`` command with subcommands covering every reference script's
entry point (the reference uses per-script hardcoded CONFIG blocks; here
everything is flags over the same typed config tree):

  reconstruct   3d_model/reconstruct_rgbd[_filter|_gt].py, multi_reconstruct
  check-frame   3d_model/check_one_frame.py
  probe-depth   3d_model/depth_scale.py + depth_visual.py
  trajectory    3d_model/visualize_trajectory.py
  hybrid-map    fusion/hybrid_map.py (+ manual alignment offsets)
  merge-2d      fusion/2d_selective_merge.py (explicit regions, headless)
  eval          eval/eval_*. py (analytic GT scenarios or a GT ply)
  mission       closed-loop simulated mission (the Gazebo-equivalent run)
  bench         the headline throughput benchmark
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _add_reconstruct(sub):
    p = sub.add_parser("reconstruct", help="TSDF-reconstruct objects from a "
                       "capture dataset")
    p.add_argument("--dataset", required=True)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--object", default=None, help="single object name")
    p.add_argument("--backend", default="sparse",
                   choices=["sparse", "dense"],
                   help="TSDF fusion: block-sparse (default) or the dense "
                        "reference grid")
    p.add_argument("--mesh", action="store_true",
                   help="save triangle meshes instead of filtered clouds")
    p.add_argument("--no-z-filter", action="store_true")
    p.add_argument("--gt-poses", action="store_true",
                   help="dataset captured with ground-truth body poses "
                        "(reconstruct_rgbd_gt.py T_fix variant)")
    p.add_argument("--ranges", default=None,
                   help='explicit frame ranges, e.g. "Object_0:1-16,Object_1:2-9"')
    p.add_argument("--auto-origin", action="store_true",
                   help="center each object's volume on its observed geometry")
    p.add_argument("--refine", default="none",
                   choices=["none", "icp", "f2m", "pgo"],
                   help="trajectory refinement before fusing: frame-to-frame "
                        "ICP, frame-to-model TSDF tracking, or pose-graph "
                        "loop closure (drift-robust for capture circles)")
    p.add_argument("--config", default=None, help="config JSON file")


def _cmd_reconstruct(args):
    from otslam_tpu.config import OTSLAMConfig
    from otslam_tpu.core.se3 import T_FIX_GT, T_FIX_OPTICAL
    from otslam_tpu.pipeline.dataset import CaptureDataset
    from otslam_tpu.pipeline.reconstruct import (
        reconstruct_all, reconstruct_object, reconstruct_range)

    cfg = _load_cfg(args)
    ds = CaptureDataset(args.dataset, cfg.camera,
                        t_fix=T_FIX_GT if args.gt_poses else T_FIX_OPTICAL)
    save_dir = args.save_dir or os.path.join(args.dataset, "3d_reconst")
    kw = dict(cfg=cfg.reconstruction, backend=args.backend,
              save_dir=save_dir, z_filter=not args.no_z_filter,
              output="mesh" if args.mesh else "cloud",
              auto_origin=args.auto_origin, refine=args.refine)
    if args.ranges:
        ranges = {}
        for part in args.ranges.split(","):
            name, span = part.split(":")
            lo, hi = span.split("-")
            ranges[name] = (int(lo), int(hi))
        out = reconstruct_range(ds, ranges, **kw)
    elif args.object:
        out = {args.object: reconstruct_object(ds, args.object, **kw)}
    else:
        out = reconstruct_all(ds, **kw)
    for name, res in out.items():
        print(f"{name}: {len(res.points)} points from {res.num_frames} frames "
              f"-> {os.path.join(save_dir, name + '.ply')}")


def _cmd_check_frame(args):
    import jax.numpy as jnp

    from otslam_tpu.config import OTSLAMConfig
    from otslam_tpu.core import io as tio
    from otslam_tpu.core.camera import PinholeIntrinsics
    from otslam_tpu.kernels.backproject import backproject_pointcloud
    from otslam_tpu.kernels.voxel import voxel_downsample

    cfg = _load_cfg(args)
    intr = PinholeIntrinsics.from_config(cfg.camera)
    depth = tio.read_depth_png(args.depth, cfg.camera.depth_scale)
    color = tio.read_color(args.color) if args.color else None
    pc = backproject_pointcloud(
        jnp.asarray(depth),
        None if color is None else jnp.asarray(color),
        intr, depth_trunc=args.trunc)
    pts, cols = pc.to_numpy()
    if args.voxel > 0:
        dpts, dcols, mask = voxel_downsample(
            jnp.asarray(pts), args.voxel,
            colors=None if cols is None else jnp.asarray(cols))
        m = np.asarray(mask)
        pts = np.asarray(dpts)[m]
        cols = None if dcols is None else np.asarray(dcols)[m]
    tio.write_ply(args.out, pts, colors=cols)
    print(f"{len(pts)} points -> {args.out}")


def _cmd_probe_depth(args):
    from otslam_tpu.core import io as tio
    from otslam_tpu.utils.probes import depth_heat_image, depth_stats

    raw = tio.read_png(args.path)
    print(json.dumps(depth_stats(raw), indent=2))
    if args.heat:
        tio.write_color(args.heat,
                        np.stack([depth_heat_image(raw)] * 3, axis=-1))
        print(f"heat image -> {args.heat}")


def _cmd_trajectory(args):
    import glob

    from otslam_tpu.core import io as tio
    from otslam_tpu.core.se3 import T_FIX_GT, T_FIX_OPTICAL
    from otslam_tpu.utils.probes import trajectory_frames

    poses = [tio.read_pose_txt(f)
             for f in sorted(glob.glob(os.path.join(args.poses, "*.txt")))]
    pts, cols = trajectory_frames(
        poses, T_FIX_GT if args.gt_poses else T_FIX_OPTICAL)
    tio.write_ply(args.out, pts, colors=cols)
    print(f"{len(poses)} poses -> {args.out}")


def _cmd_hybrid_map(args):
    from otslam_tpu.mapping.hybrid import hybrid_map_from_files

    pts, cols = hybrid_map_from_files(args.map_yaml, args.map_pgm,
                                      args.objects, args.out)
    print(f"hybrid map: {len(pts)} points -> {args.out}")


def _cmd_merge_2d(args):
    from otslam_tpu.core import io as tio
    from otslam_tpu.mapping.merge import selective_merge

    old = tio.read_pgm(args.old)
    new = tio.read_pgm(args.new)
    regions = []
    for part in args.regions.split(";"):
        x, y, w, h = (int(v) for v in part.split(","))
        regions.append((x, y, w, h))
    out = selective_merge(old, new, regions)
    tio.write_pgm(args.out, out)
    print(f"merged {len(regions)} regions -> {args.out}")


def _cmd_eval(args):
    from otslam_tpu.core import io as tio
    from otslam_tpu.eval.metrics import evaluate_map
    from otslam_tpu.eval.scenarios import scenario_gt

    map_pts = tio.read_ply(args.map)["points"]
    if args.gt:
        gt = tio.read_ply(args.gt)["points"]
    else:
        gt = scenario_gt(args.scenario, args.gt_samples)
    m = evaluate_map(map_pts, gt, use_icp=args.icp)
    print(json.dumps({"accuracy_cm": round(m.accuracy_cm, 3),
                      "completeness_cm": round(m.completeness_cm, 3),
                      "icp_fitness": round(m.icp_fitness, 4)}))


def _cmd_mission(args):
    import dataclasses as _dc

    import jax

    from otslam_tpu.config import OTSLAMConfig, TrackerConfig
    from otslam_tpu.sim.runner import MissionRunner
    from otslam_tpu.sim.world import (
        Box, Scene, cardboard_room, cone_room, full_room, table_chair_room)

    scenes = {"cardboard": cardboard_room, "cone": cone_room,
              "table_chair": table_chair_room, "full": full_room}
    world = scenes[args.scenario]()
    # --removed: the saved 2D map knows an object reality no longer has —
    # the diff pipeline then reports REMOVED cells and the mission visits
    # the removed-object check points (diff_node.cpp:131-158 semantics)
    map_objects = ()
    if args.removed:
        map_objects = (Box((4.0, -4.0, 0.15), (0.5, 0.4, 0.3), 0.0,
                           (0.7, 0.7, 0.7), "removed_box"),)
    scene_map = _dc.replace(world, objects=map_objects)
    cfg = OTSLAMConfig(tracker=TrackerConfig.update_pipeline_profile())
    if args.goal_list:
        # scripted mission (goal_list.hpp equivalent): no perception loop,
        # the static targets run through the same queue -> FSM -> scanner
        from otslam_tpu.mission.goal_list import load_goal_list
        goals = load_goal_list(args.goal_list)
        runner = MissionRunner(
            scene_map=scene_map, scene_world=world,
            workdir=args.workdir, cfg=cfg,
            start_pose=tuple(float(v) for v in args.start.split(",")))
        s = runner.run_static(goals)
        print(json.dumps({
            "missions": s.missions_completed, "frames": s.frames_captured,
            "labels": s.labels, "sim_time_s": round(s.sim_time, 1),
            "dataset": os.path.join(args.workdir, "dataset")}))
        return
    runs = []
    for rep in range(max(1, args.repeat)):
        # fresh runner per repeat (identical mission); repeats share the
        # in-process jit cache, so run 2+ measures steady-state throughput
        # without the one-time compile of the fused perception program
        wd = args.workdir if rep == 0 else f"{args.workdir}_r{rep}"
        runner = MissionRunner(
            scene_map=scene_map, scene_world=world,
            workdir=wd, cfg=cfg,
            start_pose=tuple(float(v) for v in args.start.split(",")),
            perception_batch=args.perception_batch,
            odom_noise_per_m=args.odom_noise,
            use_localizer=args.localizer)
        t0 = time.time()
        s = runner.run(max_ticks=args.max_ticks)
        wall = time.time() - t0
        ticks = len(runner.trace)
        runs.append({
            "missions": s.missions_completed, "frames": s.frames_captured,
            "stable_objects": s.stable_objects,
            "sim_time_s": round(s.sim_time, 1), "labels": s.labels,
            "ticks": ticks, "wall_s": round(wall, 2),
            "ticks_per_sec": round(ticks / wall, 1) if wall > 0 else None,
        })
    out = dict(runs[-1])
    out.update({
        # wd survives the loop = the LAST repeat's workdir (the run whose
        # stats are reported above)
        "dataset": os.path.join(wd, "dataset"),
        "platform": jax.default_backend(),
        "perception_batch": args.perception_batch,
        "removed_checks_visited": sorted(runner.sender.visited_removed_ids),
        "use_localizer": args.localizer,
        "odom_noise_per_m": args.odom_noise,
    })
    if len(runs) > 1:
        out["runs"] = runs
    print(json.dumps(out))


def _cmd_capture(args):
    """Manual RGB-D capture (the rgbd_capture_node equivalent, headless):
    render one frame from an explicit pose in a named scenario and append it
    to a dataset."""
    from otslam_tpu.config import OTSLAMConfig
    from otslam_tpu.core.camera import PinholeIntrinsics
    from otslam_tpu.core.se3 import T_FIX_GT, se3
    from otslam_tpu.pipeline.dataset import CaptureDataset
    from otslam_tpu.core.se3 import T_FIX_OPTICAL
    from otslam_tpu.sim.sensors import render_rgbd
    from otslam_tpu.sim.world import (cardboard_room, cone_room, full_room,
                                      table_chair_room)

    scenes = {"cardboard": cardboard_room, "cone": cone_room,
              "table_chair": table_chair_room, "full": full_room}
    scene = scenes[args.scenario]()
    cfg = _load_cfg(args)
    intr = PinholeIntrinsics.from_config(cfg.camera)
    x, y, yaw = (float(v) for v in args.pose.split(","))
    R = np.eye(3)
    import numpy as _np
    c, s = _np.cos(yaw), _np.sin(yaw)
    R[:2, :2] = [[c, -s], [s, c]]
    body = se3(R, [x, y, args.height])
    optical = body @ T_FIX_GT
    depth, color = render_rgbd(scene, optical, intr,
                               far=cfg.camera.depth_max)
    ds = CaptureDataset(args.workdir, cfg.camera)
    pose_saved = optical @ T_FIX_OPTICAL.T
    n = ds.save_frame(args.label, np.asarray(color).astype(np.uint8),
                      np.asarray(depth), pose_saved)
    print(f"captured {args.label}_{n} at ({x:.2f},{y:.2f},{yaw:.2f})")


def _cmd_report(args):
    from otslam_tpu.eval.metrics import EvalMetrics
    from otslam_tpu.eval.report import (REFERENCE_RESULTS, plot_results,
                                        print_summary_table)

    results = {}
    for part in args.results.split(";"):
        name, acc, comp = part.split(",")
        results[name] = EvalMetrics(float(acc), float(comp))
    print_summary_table(results)
    if args.plot:
        plot_results(results, args.plot,
                     baseline=REFERENCE_RESULTS if args.vs_reference else None)
        print(f"plot -> {args.plot}")


def _cmd_bench(args):
    import bench
    raise SystemExit(bench.main())


def _cmd_headline(args):
    import json

    from otslam_tpu.eval.headline import headline_report
    from otslam_tpu.sim import world

    scene_fn = {"cardboard": world.cardboard_room,
                "cone": world.cone_room,
                "table_chair": world.table_chair_room,
                "full": world.full_room}[args.scenario]
    rep = headline_report(args.workdir, scene_fn=scene_fn,
                          frames_per_object=args.frames,
                          room_frames=args.room_frames,
                          objects_dir=args.objects_dir)
    print(json.dumps(rep, indent=2))


def _load_cfg(args):
    from otslam_tpu.config import OTSLAMConfig
    if getattr(args, "config", None):
        with open(args.config) as f:
            return OTSLAMConfig.from_json(f.read())
    return OTSLAMConfig()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="otslam", description="OTSLAM selective 3D mapping on JAX")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="force the JAX platform before any device query")
    sub = ap.add_subparsers(dest="cmd", required=True)

    _add_reconstruct(sub)

    p = sub.add_parser("check-frame", help="back-project one RGB-D frame")
    p.add_argument("--depth", required=True)
    p.add_argument("--color", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--voxel", type=float, default=0.01)
    p.add_argument("--trunc", type=float, default=5.0)
    p.add_argument("--config", default=None)

    p = sub.add_parser("probe-depth", help="depth format/stats probe")
    p.add_argument("path")
    p.add_argument("--heat", default=None)

    p = sub.add_parser("trajectory", help="camera trajectory markers")
    p.add_argument("--poses", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--gt-poses", action="store_true")

    p = sub.add_parser("hybrid-map", help="merge 2D map + 3D objects")
    p.add_argument("--map-yaml", required=True)
    p.add_argument("--map-pgm", required=True)
    p.add_argument("--objects", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("merge-2d", help="selective 2D map merge")
    p.add_argument("--old", required=True)
    p.add_argument("--new", required=True)
    p.add_argument("--regions", required=True, help='"x,y,w,h;x,y,w,h"')
    p.add_argument("--out", required=True)

    p = sub.add_parser("eval", help="accuracy/completeness vs GT")
    p.add_argument("--map", required=True)
    p.add_argument("--scenario", default="cardboard",
                   choices=["cardboard", "cone", "table_chair", "full"])
    p.add_argument("--gt", default=None, help="GT ply (overrides scenario)")
    p.add_argument("--gt-samples", type=int, default=50000)
    p.add_argument("--icp", action="store_true")

    p = sub.add_parser("mission", help="run a closed-loop simulated mission")
    p.add_argument("--scenario", default="cardboard",
                   choices=["cardboard", "cone", "table_chair", "full"])
    p.add_argument("--workdir", required=True)
    p.add_argument("--start", default="-2.0,-2.0,0.5")
    p.add_argument("--max-ticks", type=int, default=300)
    p.add_argument("--perception-batch", type=int, default=1,
                   help="fuse K stationary perception ticks into one device "
                        "dispatch")
    p.add_argument("--repeat", type=int, default=1,
                   help="run the mission N times in-process; run 2+ shares "
                        "the jit cache and measures steady-state ticks/s "
                        "without the one-time compile")
    p.add_argument("--goal-list", default=None, metavar="FILE",
                   help="run a scripted mission from a static goal list "
                        "('id, label, x, y, theta_deg' per line; the "
                        "goal_list.hpp equivalent) instead of the "
                        "detection-driven loop")
    p.add_argument("--localizer", action="store_true",
                   help="estimate the robot pose by scan-to-map ICP "
                        "(slam_toolbox-localization equivalent) instead of "
                        "trusting odometry")
    p.add_argument("--odom-noise", type=float, default=0.0, metavar="M",
                   help="odometry drift stddev per meter traveled "
                        "(captures then carry estimated poses, like TF on "
                        "the reference robot)")
    p.add_argument("--removed", action="store_true",
                   help="seed the saved 2D map with an object reality "
                        "lacks, engaging the removed-object check-point "
                        "pipeline (diff_node.cpp:131-158)")

    p = sub.add_parser("capture", help="manual RGB-D capture from a scenario")
    p.add_argument("--scenario", default="cardboard",
                   choices=["cardboard", "cone", "table_chair", "full"])
    p.add_argument("--workdir", required=True)
    p.add_argument("--label", default="Object_0")
    p.add_argument("--pose", required=True, help="x,y,yaw")
    p.add_argument("--height", type=float, default=0.3)
    p.add_argument("--config", default=None)

    p = sub.add_parser("report", help="summary table + bar charts")
    p.add_argument("--results", required=True,
                   help='"Name,acc_cm,comp_cm;Name2,acc,comp"')
    p.add_argument("--plot", default=None)
    p.add_argument("--vs-reference", action="store_true")

    sub.add_parser("bench", help="stage benchmark on one GPU (bench.py)")

    p = sub.add_parser("headline",
                       help="selective-vs-dense size/accuracy report")
    p.add_argument("--workdir", required=True)
    p.add_argument("--scenario", default="cardboard",
                   choices=["cardboard", "cone", "table_chair", "full"])
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--room-frames", type=int, default=48)
    p.add_argument("--objects-dir", default=None,
                   help="use these reconstructed object PLYs (e.g. a "
                        "mission dataset's 3d_reconst/) as the selective "
                        "map instead of synthesizing capture circles — "
                        "the report is then computed from mission-captured "
                        "data")

    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.platform:
        import jax

        from otslam_tpu._compile_cache import configure_compile_cache

        jax.config.update("jax_platforms", args.platform)
        # re-apply the cache policy for the forced platform: the import-time
        # decision keyed off the environment
        configure_compile_cache(args.platform)
    {
        "reconstruct": _cmd_reconstruct,
        "check-frame": _cmd_check_frame,
        "probe-depth": _cmd_probe_depth,
        "trajectory": _cmd_trajectory,
        "hybrid-map": _cmd_hybrid_map,
        "merge-2d": _cmd_merge_2d,
        "eval": _cmd_eval,
        "mission": _cmd_mission,
        "capture": _cmd_capture,
        "report": _cmd_report,
        "bench": _cmd_bench,
        "headline": _cmd_headline,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
