"""Stage benchmark on one GPU: fusion, ICP, perception and mesh extraction.

Each stage runs in its own child process, one after another, so one process
at a time holds the card; the parent never imports JAX. Every printed line
is one JSON record naming the device (platform, device_kind, device count,
and the card's name and power limit from nvidia-smi). Without a GPU the
children fail and the parent exits non-zero.

Workloads:
  fusion      384 VGA frames of a capture circle around a 0.4 m cube into a
              256^3 volume at 1 cm (reconstruct_rgbd_filter.py:91-105
              configuration), block-sparse path
  icp         bench_icp.measure: 50k x 50k point-to-point ICP
  perception  K=64 fused ticks: raycast (1440 beams) -> scan diff ->
              evidence grids -> compaction (mapping/perception.py)
  mesh        marching tetrahedra over a dense 256^3 volume, over the
              created blocks of a block volume, and 8 block volumes batched

    python bench.py [--child STAGE]
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
STAGES = ("fusion", "icp", "perception", "mesh")


def _frame_poses(n):
    """Host-side capture-circle poses: per-frame (R, eye, extrinsic)."""
    Rs, eyes, exts = [], [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = np.array([1.2 * np.cos(ang), 1.2 * np.sin(ang), 0.2])
        fwd = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, -1.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = eye
        Rs.append(R.astype(np.float32))
        eyes.append(eye.astype(np.float32))
        exts.append(np.linalg.inv(T).astype(np.float32))
    return np.stack(Rs), np.stack(eyes), np.stack(exts)


def _make_frames(intr, n):
    """Synthetic cube-scan frames, rendered on the default device from the
    per-frame poses (an analytic ray-box render is a few jnp ops; uploading
    ~2 GB of rendered VGA frames instead would dominate set-up)."""
    import jax
    import jax.numpy as jnp

    Rs, eyes, exts = _frame_poses(n)
    rays = jnp.asarray(np.asarray(intr.pixel_rays()), jnp.float32)

    @jax.jit
    def render(Rs, eyes):
        lo = jnp.array([-0.2, -0.2, 0.0], jnp.float32)
        hi = jnp.array([0.2, 0.2, 0.4], jnp.float32)

        def one(R, eye):
            dirs = rays @ R.T                      # (H, W, 3)
            t1 = (lo - eye) / dirs
            t2 = (hi - eye) / dirs
            tmin = jnp.minimum(t1, t2).max(-1)
            tmax = jnp.maximum(t1, t2).min(-1)
            hit = (tmax > tmin) & (tmin > 0.1)
            return jnp.where(hit, tmin, 0.0).astype(jnp.float32)

        return jax.vmap(one)(Rs, eyes)

    depths = render(jnp.asarray(Rs), jnp.asarray(eyes))
    colors = jnp.full((n, intr.height, intr.width, 3), 128.0, jnp.float32)
    return depths, colors, jnp.asarray(exts)


def vga_intrinsics():
    from otslam_tpu.core.camera import PinholeIntrinsics

    return PinholeIntrinsics(width=640, height=480, fx=565.6009,
                             fy=565.6009, cx=320.5, cy=240.5)


def _best_of(fn, reps: int = 5) -> float:
    """Seconds of the fastest of `reps` calls; fn ends in a host fetch."""
    fn()                                          # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def measure_fusion(n: int = 384) -> dict:
    from otslam_tpu.config import TSDFConfig
    from otslam_tpu.kernels.tsdf_block import (auto_max_active,
                                               integrate_frames_sparse,
                                               make_block_volume)

    intr = vga_intrinsics()
    cfg = TSDFConfig()  # 256^3 @ 1 cm, trunc 4 cm (reference parameters)
    depths, colors, exts = _make_frames(intr, n)
    max_active = auto_max_active(make_block_volume(cfg), depths, exts, intr)

    def run():
        vol = integrate_frames_sparse(make_block_volume(cfg), depths, colors,
                                      exts, intr, max_active=max_active)
        np.asarray(vol.weight[:2, 0])

    return {"fusion_frames_per_s": n / _best_of(run), "frames": n,
            "max_active": max_active}


def measure_perception(k: int = 64) -> dict:
    import jax.numpy as jnp

    from otslam_tpu.config import ChangeDetectConfig, LidarConfig
    from otslam_tpu.mapping.perception import perception_ticks
    from otslam_tpu.sim.world import Box, Scene

    lidar = LidarConfig()
    cfg = ChangeDetectConfig()
    scene = Scene(objects=(Box((1.5, 0.5, 0.15), (0.5, 0.4, 0.3), 0.3,
                               (0.7, 0.6, 0.4), "box"),))
    grid = scene.occupancy_grid(0.05)
    n = lidar.num_beams
    inc = (lidar.angle_max - lidar.angle_min) / n
    angles = jnp.asarray(lidar.angle_min + np.arange(n) * inc, jnp.float32)
    rng = np.random.default_rng(0)
    reals = jnp.asarray(rng.uniform(0.5, 8.0, (k, n)).astype(np.float32))
    poses = jnp.asarray(
        np.stack([np.linspace(-1, 1, k), np.linspace(1, 0, k),
                  np.linspace(-1.5, -1.0, k)], axis=1).astype(np.float32))
    dts = jnp.full((k,), 0.2, jnp.float32)
    gh, gw = cfg.grid_cells
    new_g = jnp.zeros((gh, gw), jnp.float32)
    gone_g = jnp.zeros((gh, gw), jnp.float32)

    def run():
        b = perception_ticks(
            grid.data, float(grid.resolution), float(grid.origin[0]),
            float(grid.origin[1]), new_g, gone_g, reals, poses, dts,
            angles, cfg, float(lidar.range_max))
        np.asarray(b.added_cnt)

    return {"perception_ticks_per_s": k / _best_of(run, reps=3),
            "ticks_per_dispatch": k}


def measure_mesh(n_frames: int = 16, batch: int = 8) -> dict:
    from otslam_tpu.config import TSDFConfig
    from otslam_tpu.kernels.marching import (auto_max_cells,
                                             auto_mesh_block_config,
                                             extract_mesh_soup,
                                             extract_mesh_soup_block,
                                             extract_meshes_block)
    from otslam_tpu.kernels.tsdf import integrate_frames, make_volume
    from otslam_tpu.kernels.tsdf_block import (auto_max_active,
                                               integrate_frames_sparse,
                                               make_block_volume)

    intr = vga_intrinsics()
    cfg = TSDFConfig()
    d, c, e = _make_frames(intr, n_frames)
    dense = integrate_frames(make_volume(cfg), d, c, e, intr)
    mc = auto_max_cells(dense)
    t_dense = _best_of(
        lambda: np.asarray(extract_mesh_soup(dense, max_cells=mc)[2][:2]))

    vol0 = make_block_volume(cfg)
    ma = auto_max_active(vol0, d, e, intr)
    vol = integrate_frames_sparse(vol0, d, c, e, intr, max_active=ma)
    mb, mcb = auto_mesh_block_config(vol)
    t_block = _best_of(
        lambda: np.asarray(extract_mesh_soup_block(vol, mb, mcb)[2][:2]))
    t_batch = _best_of(lambda: np.asarray(
        extract_meshes_block([vol] * batch, mb, mcb)[2][:2, 0]))
    return {"mesh_dense_extractions_per_s": 1.0 / t_dense,
            "mesh_block_extractions_per_s": 1.0 / t_block,
            "mesh_batched_extractions_per_s": batch / t_batch}


def device_record() -> dict:
    """platform, device_kind, device count and nvidia-smi's name and power
    limit; raises SystemExit when JAX finds no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "nvidia_smi": smi}


def child(stage: str) -> None:
    rec = {"stage": stage, **device_record()}
    if stage == "fusion":
        rec.update(measure_fusion())
    elif stage == "icp":
        import bench_icp
        rec.update(bench_icp.measure())
    elif stage == "perception":
        rec.update(measure_perception())
    elif stage == "mesh":
        rec.update(measure_mesh())
    else:
        raise SystemExit(f"unknown stage {stage!r}")
    print(json.dumps(rec), flush=True)


def main() -> int:
    failed = []
    for stage in STAGES:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", stage],
            capture_output=True, text=True, cwd=_HERE)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode == 0 and lines:
            print(lines[-1], flush=True)
        else:
            failed.append(stage)
            err = (proc.stderr.strip().splitlines() or ["no output"])[-1]
            print(f"bench: stage {stage} failed: {err}", file=sys.stderr,
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        sys.exit(main())
