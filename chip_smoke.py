"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --multi   # four GPUs: the sharded paths only

One GPU, in order (any failure exits non-zero; the last line is printed
only when every phase passed):

(a) device: JAX must find a GPU; prints its kind, the device count and
    nvidia-smi's name and power limit.
(b) mission: the CLI's own entry points in-process — ``mission --scenario
    full --localizer --odom-noise 0.01 --removed --max-ticks 90``
    (1440-beam LiDAR, VGA camera from the default config), then
    ``reconstruct --auto-origin`` with the default (block-sparse) backend,
    then every scene object scored against the analytic ground truth with
    the headline report. Each object's accuracy and completeness must be at
    most the same run's CPU figure (CPU_REFERENCE_CM) plus 0.5 cm.
(c) parity at real widths, each device path against its plain reference
    run in this process on the host CPU device:
    fusion  — integrate_frames_sparse, 384 VGA frames into 256^3 at 1 cm,
              against dense kernels/tsdf.py;
    NN      — nearest neighbours at 50k x 50k, full and windowed;
    raycast — raycast_grid, 1440 beams on the full_room map and a 512^2
              grid.
(d) memory: compiled.memory_analysis() of each stage of (c) and the
    device's peak_bytes_in_use.
(e) last line: {"ok": true, "device": {"platform", "kind", "count"}}.

The package sets jax_default_matmul_precision="highest", so f32 products
on the GPU do not drop to TF32; the tolerances below assume that.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Per-object (accuracy_cm, completeness_cm) of phase (b)'s exact commands on
# the CPU backend (JAX_PLATFORMS=cpu); the GPU run may exceed neither by
# more than BOUND_SLACK_CM.
CPU_REFERENCE_CM = {
    "table_marble": (2.472, 7.692),
    "chair_1": (0.616, 11.569),
    "chair_2": (1.52, 2.568),
    "chair_3": (1.987, 3.343),
    "chair_4": (3.564, 4.392),
    "cardboard_box": (4.641, 4.993),
}
BOUND_SLACK_CM = 0.5
# 90 control ticks: 45 missions over 8 of the 9 capture sites. Later, at the
# cone site (~785 s of simulated time), the card's and the CPU's missions
# part: one localization sits at the edge of ICP's 0.3 m inlier radius and
# last-bit differences decide it, so the cone captures differ between the
# two runs and no bound holds there.
MISSION_TICKS = 90

# Tolerances of phase (c), each against the CPU reference:
# - fusion, dense reference: weights count valid observations. Blocks are
#   created lazily (a block integrates from the frame that creates it on,
#   as in Open3D's ScalableTSDFVolume), so the check fuses twice: the lazy
#   pass must cover every voxel of the dense truncation band and never
#   count more than dense; a second pass from a volume whose created set
#   is the first pass's final one must equal dense on every created voxel.
#   Every other voxel agrees in weight, and in TSDF and colour to 1e-5 of
#   their ranges (tests/test_tsdf_block.py's tolerance): they are running
#   means of the same f32 terms in the same order. The exception is
#   knife-edge voxels: a projection within an ulp of a pixel-rounding
#   boundary samples the neighbouring pixel in one compiled program and
#   not in the other (or an SDF within an ulp of -sdf_trunc counts once
#   and not twice), so its weight, TSDF or colour may differ — at most
#   FUSION_KNIFE_FRAC of observed voxels, each off by at most
#   FUSION_KNIFE_DW observations.
FUSION_KNIFE_FRAC = 5e-3
FUSION_KNIFE_DW = 2
FUSION_TSDF_ATOL = 1e-5
FUSION_COLOR_ATOL = 255e-5
# - NN: both sides compute dx^2+dy^2+dz^2 in f32, so distances agree to a
#   few ulps of a ~0.05 m distance; an index may differ only where the
#   nearest point is not unique by more than 1e-6 m.
NN_DIST_ATOL = 1e-6
NN_TIE_M = 1e-6
# - raycast: integer cell walks, exact.


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _cli(argv) -> str:
    """Run otslam's CLI main in-process; echo and return its stdout."""
    from otslam_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    return out


def mission_phase(workdir: str, max_ticks: int = MISSION_TICKS) -> dict:
    """Mission -> reconstruct -> per-object scores; returns
    {object: (accuracy_cm, completeness_cm) or None if unscanned}."""
    from otslam_tpu.eval.headline import headline_report
    from otslam_tpu.sim.world import full_room

    out = _cli(["mission", "--scenario", "full", "--localizer",
                "--odom-noise", "0.01", "--removed", "--workdir", workdir,
                "--max-ticks", str(max_ticks)])
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["missions"] >= 1 and summary["frames"] > 0, summary
    dataset = os.path.join(workdir, "dataset")
    _cli(["reconstruct", "--dataset", dataset, "--auto-origin"])
    rep = headline_report(os.path.join(workdir, "headline"),
                          scene_fn=full_room,
                          objects_dir=os.path.join(dataset, "3d_reconst"))
    scores = {}
    for name, entry in rep["objects"].items():
        if "proposal_accuracy_cm" in entry:
            scores[name] = (entry["proposal_accuracy_cm"],
                            entry["proposal_completeness_cm"])
        else:
            scores[name] = None
    return scores


def check_mission(scores: dict) -> None:
    bad = []
    for name, ref in sorted(CPU_REFERENCE_CM.items()):
        got = scores.get(name)
        if got is None:
            print(f"  {name}: not scanned (CPU: acc {ref[0]} comp {ref[1]})")
            bad.append(name)
            continue
        ok = all(g <= r + BOUND_SLACK_CM for g, r in zip(got, ref))
        print(f"  {name}: accuracy {got[0]} cm (CPU {ref[0]}), completeness "
              f"{got[1]} cm (CPU {ref[1]}) {'ok' if ok else 'OVER BOUND'}")
        if not ok:
            bad.append(name)
    for name in sorted(set(scores) - set(CPU_REFERENCE_CM)):
        print(f"  {name}: {scores[name]} (no CPU reference)")
    assert not bad, f"objects over the CPU + {BOUND_SLACK_CM} cm bound: {bad}"


def _memory(name: str, compiled) -> None:
    m = compiled.memory_analysis()
    print(f"  memory {name}: arguments {m.argument_size_in_bytes} B, "
          f"outputs {m.output_size_in_bytes} B, temp "
          f"{m.temp_size_in_bytes} B, code {m.generated_code_size_in_bytes} B")


def _block_voxels(vol) -> np.ndarray:
    """(X, Y, Z) bool: voxels of the volume's created blocks."""
    from otslam_tpu.kernels.tsdf_block import BLOCK

    bx, by, bz = vol.grid_blocks
    c = np.asarray(vol.created[:-1]).reshape(bx, by, bz)
    for ax in range(3):
        c = np.repeat(c, BLOCK, axis=ax)
    return c


def fusion_parity(cpu) -> None:
    import dataclasses

    import jax

    import bench
    from otslam_tpu.config import TSDFConfig
    from otslam_tpu.kernels.tsdf import integrate_frames, make_volume
    from otslam_tpu.kernels.tsdf_block import (
        auto_max_active, block_to_dense, integrate_frames_sparse,
        make_block_volume)

    intr = bench.vga_intrinsics()
    cfg = TSDFConfig()                       # 256^3 at 1 cm, 4 cm trunc
    n = 384
    depths, colors, exts = bench._make_frames(intr, n)
    max_active = auto_max_active(make_block_volume(cfg), depths, exts, intr)
    _memory("integrate_frames_sparse", integrate_frames_sparse.lower(
        make_block_volume(cfg), depths, colors, exts, intr=intr,
        max_active=max_active).compile())
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        vol = integrate_frames_sparse(make_block_volume(cfg), depths, colors,
                                      exts, intr, max_active=max_active)
        jax.block_until_ready(vol.weight)
        times.append(time.perf_counter() - t0)
    print(f"  fusion: {n} VGA frames into 256^3, max_active {max_active}: "
          f"{n / min(times[1:]):.1f} frames/s (best of {len(times) - 1} "
          f"after the first call, {times[0]:.2f} s with compile)")
    created = _block_voxels(vol)
    # second pass: every block of the final created set exists from frame 0
    # (a copy: the fusion donates its input volume)
    preset = dataclasses.replace(make_block_volume(cfg),
                                 created=jax.numpy.array(vol.created))
    pre = integrate_frames_sparse(
        preset, depths, colors, exts, intr,
        max_active=auto_max_active(preset, depths, exts, intr))

    t0 = time.perf_counter()
    with jax.default_device(cpu):
        dense = integrate_frames(make_volume(cfg), jax.device_put(depths, cpu),
                                 jax.device_put(colors, cpu),
                                 jax.device_put(exts, cpu), intr)
        w_d, t_d, c_d = (np.asarray(x) for x in (dense.weight, dense.tsdf,
                                                 dense.color))
    print(f"  dense CPU reference: {time.perf_counter() - t0:.1f} s")
    band = (w_d > 0) & (np.abs(t_d) < 0.999)
    uncovered = int(np.sum(band & ~created))
    observed = int(np.sum(created & (w_d > 0)))
    print(f"  fusion: {int(created.sum())} created voxels, {observed} "
          f"observed by dense; dense band voxels outside created blocks "
          f"{uncovered} (tol 0)")
    assert uncovered == 0
    for name, v in (("lazy", vol), ("preset", pre)):
        sd = block_to_dense(v)
        w_s, t_s, c_s = (np.asarray(x) for x in (sd.weight, sd.tsdf,
                                                 sd.color))
        dw = w_s - w_d
        dt = np.abs(t_s - t_d)
        dc = np.max(np.abs(c_s - c_d), axis=0)
        eq = created & (dw == 0) & (w_d > 0)
        # lazy blocks miss what came before their creation: only an excess
        # over dense is off there
        off = created & ((dw > 0) if name == "lazy" else (dw != 0))
        off |= eq & ((dt > FUSION_TSDF_ATOL) | (dc > FUSION_COLOR_ATOL))
        n_off = int(off.sum())
        max_dw = float(np.abs(dw[off]).max()) if n_off else 0.0
        good = eq & ~off
        print(f"  fusion {name} vs dense: knife-edge voxels {n_off} "
              f"({n_off / max(observed, 1):.2e} of observed, tol "
              f"{FUSION_KNIFE_FRAC}), max |dw| there {max_dw} (tol "
              f"{FUSION_KNIFE_DW}); below dense {int((created & (dw < 0)).sum())}"
              f"; on the other {int(good.sum())} observed voxels max |dtsdf| "
              f"{float(dt[good].max()):.2e}, max |dcolor| "
              f"{float(dc[good].max()):.2e}")
        assert n_off <= FUSION_KNIFE_FRAC * observed
        assert max_dw <= FUSION_KNIFE_DW


def _nn_check(name, src, dst, d_g, i_g, d_r, i_r, mask) -> None:
    d_g, i_g, d_r, i_r = (np.asarray(x) for x in (d_g, i_g, d_r, i_r))
    s = src[mask].astype(np.float64)
    gd = np.linalg.norm(s - dst[i_g[mask]].astype(np.float64), axis=1)
    rd = np.linalg.norm(s - dst[i_r[mask]].astype(np.float64), axis=1)
    diff_idx = i_g[mask] != i_r[mask]
    non_tie = diff_idx & (np.abs(gd - rd) > NN_TIE_M)
    dd = float(np.max(np.abs(d_g[mask] - d_r[mask])))
    print(f"  NN {name}: {int(mask.sum())} points checked, differing "
          f"indices {int(diff_idx.sum())} (all ties within {NN_TIE_M} m: "
          f"{not non_tie.any()}), max |ddist| {dd:.2e} m (tol "
          f"{NN_DIST_ATOL})")
    assert not non_tie.any() and dd <= NN_DIST_ATOL


def nn_parity(cpu) -> None:
    import jax
    import jax.numpy as jnp

    import bench_icp
    from otslam_tpu.kernels.nn import (_resolve_impl, auto_nn_window,
                                       nn_distance, nn_distance_radius)

    src, dst = bench_icp.clouds(50_000)
    impl = _resolve_impl("auto")
    print(f"  NN implementation on this device: {impl}")
    sg, dg = jnp.asarray(src), jnp.asarray(dst)
    _memory("nn_distance (full)", nn_distance.lower(
        sg, dg, with_index=True).compile())
    d_g, i_g = nn_distance(sg, dg, with_index=True)
    with jax.default_device(cpu):
        d_r, i_r = nn_distance(jax.device_put(src, cpu),
                               jax.device_put(dst, cpu), with_index=True,
                               impl="plain")
    _nn_check("full 50k x 50k", src, dst, d_g, i_g, d_r, i_r,
              np.ones(len(src), bool))

    radius = 0.3
    src_s = src[np.argsort(src[:, 2])]
    dst_s = dst[np.argsort(dst[:, 2])]
    window, axis = auto_nn_window(src_s, dst_s, radius, axis=2)
    sg, dg = jnp.asarray(src_s), jnp.asarray(dst_s)
    kw = dict(window_chunks=window, axis=axis, with_index=True)
    _memory("nn_distance_radius (windowed)", nn_distance_radius.lower(
        sg, dg, radius, **kw).compile())
    d_g, i_g = nn_distance_radius(sg, dg, radius, **kw)
    with jax.default_device(cpu):
        d_r, i_r = nn_distance_radius(jax.device_put(src_s, cpu),
                                      jax.device_put(dst_s, cpu), radius,
                                      impl="plain", **kw)
    inl = np.asarray(d_r) < radius
    _nn_check(f"windowed ({window} chunks, radius {radius} m)", src_s, dst_s,
              d_g, i_g, d_r, i_r, inl)
    assert (np.asarray(d_g)[~inl] >= radius - NN_DIST_ATOL).all()


def raycast_parity(cpu) -> None:
    import jax
    import jax.numpy as jnp

    from otslam_tpu.config import LidarConfig
    from otslam_tpu.kernels.raycast import raycast_grid
    from otslam_tpu.sim.world import full_room

    lidar = LidarConfig()
    nb = lidar.num_beams
    angles = (lidar.angle_min + np.arange(nb)
              * (lidar.angle_max - lidar.angle_min) / nb).astype(np.float32)
    room = full_room().occupancy_grid(0.05)
    rng = np.random.default_rng(0)
    big = (rng.random((512, 512)) < 0.02).astype(np.int8) * 100
    cases = [("full_room", np.asarray(room.data), float(room.resolution),
              float(room.origin[0]), float(room.origin[1]),
              [(0.5, 4.5, 0.0), (-2.0, -2.0, 1.2), (3.0, -3.5, -2.5)]),
             ("grid512", big, 0.05, -12.8, -12.8,
              [(0.0, 0.0, 0.3), (5.1, -7.3, 2.0), (-11.0, 11.0, -0.8)])]
    for name, grid, res, ox, oy, poses in cases:
        mism = 0
        for k, (x, y, yaw) in enumerate(poses):
            args = (res, ox, oy, np.float32(x), np.float32(y),
                    np.float32(yaw))
            if k == 0:
                _memory(f"raycast_grid ({name})", raycast_grid.lower(
                    jnp.asarray(grid), *args, jnp.asarray(angles),
                    lidar.range_max).compile())
            got = np.asarray(raycast_grid(jnp.asarray(grid), *args,
                                          jnp.asarray(angles),
                                          lidar.range_max))
            with jax.default_device(cpu):
                want = np.asarray(raycast_grid(
                    jax.device_put(grid, cpu), *args,
                    jax.device_put(angles, cpu), lidar.range_max))
            mism += int(np.sum(~((got == want)
                                 | (np.isinf(got) & np.isinf(want)))))
        print(f"  raycast {name} {grid.shape}: {nb} beams x {len(poses)} "
              f"poses, mismatching beams {mism} (tol 0)")
        assert mism == 0


def multi_phase(devices) -> None:
    import __graft_entry__
    import bench
    from otslam_tpu.config import TSDFConfig

    assert len(devices) == 4, f"--multi needs 4 GPUs, found {len(devices)}"
    cfg = TSDFConfig(dims=(128, 128, 128), origin=(-0.64, -0.64, 0.2))
    t0 = time.perf_counter()
    print(__graft_entry__.multichip_parity(
        devices, bench.vga_intrinsics(), cfg, n_frames=8, n_points=12_500))
    print(f"multi phase: {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    cache_events = {}

    def _on_event(event, **_kw):
        if "compilation_cache" in event:
            cache_events[event] = cache_events.get(event, 0) + 1

    jax.monitoring.register_event_listener(_on_event)

    # (a) device
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}",
              file=sys.stderr)
        sys.exit(1)
    print(f"device: {devs[0].device_kind}, count {len(devs)}")
    print(f"nvidia-smi: {_smi()}")
    cpu = jax.devices("cpu")[0]

    t_all = time.perf_counter()
    if args.multi:
        multi_phase(devs)
    else:
        t0 = time.perf_counter()
        print("(b) mission -> reconstruct -> score")
        with tempfile.TemporaryDirectory() as wd:
            scores = mission_phase(wd)
        check_mission(scores)
        print(f"(b) {time.perf_counter() - t0:.1f} s")
        for name, fn in (("fusion", fusion_parity), ("nn", nn_parity),
                         ("raycast", raycast_parity)):
            t0 = time.perf_counter()
            print(f"(c) {name} parity")
            fn(cpu)
            print(f"(c) {name} {time.perf_counter() - t0:.1f} s")
        peak = devs[0].memory_stats().get("peak_bytes_in_use")
        print(f"(d) peak_bytes_in_use {peak}")
    print(f"compile cache: {json.dumps(cache_events, sort_keys=True)}; "
          f"dir {jax.config.jax_compilation_cache_dir}")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
