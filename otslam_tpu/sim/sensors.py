"""Analytic sensor renderers: RGB-D camera and 2D LiDAR.

The Gazebo sensors (RealSense R200 model.sdf:377-433, LDS LiDAR
model.sdf:132-150) become exact ray-primitive intersection kernels, fully
vectorized over (pixels|beams) x primitives in JAX. Deterministic, no mesh
assets, runs on any JAX backend.

Conventions: depth = z-coordinate in the optical frame (pinhole rays with
unit z, so depth = ray parameter t); LiDAR returns Euclidean range in the
sensor plane; both saturate to 0 / +inf outside [near, far].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.core.se3 import se3
from otslam_tpu.sim.world import Box, Cone, Cylinder, Scene

# host scalar, not jnp.float32(...): a module-level device array would
# initialize the backend at import time and be embedded as a device-array
# constant into every render jaxpr
_INF = np.float32(1e10)


def look_at_pose(eye, target, up=(0.0, 0.0, -1.0)) -> np.ndarray:
    """Camera->world pose (optical convention: +z forward, +y down) looking
    from eye to target."""
    eye = np.asarray(eye, float)
    fwd = np.asarray(target, float) - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, float)
    right = np.cross(upv, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-9:
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        nr = np.linalg.norm(right)
    right /= nr
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    return se3(R, eye)


# ---------------------------------------------------------------------------
# ray-primitive intersections (origins (..., 3), dirs (..., 3) -> t or inf)
# ---------------------------------------------------------------------------

def _ray_box(o, d, box: Box):
    c, s = np.cos(box.yaw), np.sin(box.yaw)
    R = jnp.asarray([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]],
                    dtype=o.dtype)  # world -> box local
    ol = (o - jnp.asarray(box.center, o.dtype)) @ R.T
    dl = d @ R.T
    half = jnp.asarray(box.size, o.dtype) / 2.0
    dsafe = jnp.where(jnp.abs(dl) > 1e-12, dl, 1e-12)
    t1 = (-half - ol) / dsafe
    t2 = (half - ol) / dsafe
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = jnp.where(tmin > 0, tmin, tmax)  # inside the box -> exit face
    return jnp.where(hit, t, _INF)


def _ray_cylinder(o, d, cyl: Cylinder):
    cx, cy, cz = cyl.center
    ox = o[..., 0] - cx
    oy = o[..., 1] - cy
    dx = d[..., 0]
    dy = d[..., 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    cq = ox * ox + oy * oy - cyl.radius ** 2
    disc = b * b - 4 * a * cq
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    asafe = jnp.where(jnp.abs(a) > 1e-12, a, 1e-12)
    t_lat1 = (-b - sq) / (2 * asafe)
    t_lat2 = (-b + sq) / (2 * asafe)

    def lat_ok(t):
        z = o[..., 2] + t * d[..., 2]
        return (disc >= 0) & (t > 0) & (z >= cz) & (z <= cz + cyl.height)

    t_lat = jnp.where(lat_ok(t_lat1), t_lat1,
                      jnp.where(lat_ok(t_lat2), t_lat2, _INF))

    # caps
    dz = jnp.where(jnp.abs(d[..., 2]) > 1e-12, d[..., 2], 1e-12)
    t_caps = _INF
    for zc in (cz, cz + cyl.height):
        t = (zc - o[..., 2]) / dz
        x = o[..., 0] + t * d[..., 0] - cx
        y = o[..., 1] + t * d[..., 1] - cy
        ok = (t > 0) & (x * x + y * y <= cyl.radius ** 2)
        t_caps = jnp.minimum(t_caps, jnp.where(ok, t, _INF))
    return jnp.minimum(t_lat, t_caps)


def _ray_cone(o, d, cone: Cone):
    """Finite cone, apex at base + height, opening downward to base circle."""
    cx, cy, cz = cone.center
    h = cone.height
    r = cone.radius
    ax, ay, az = cx, cy, cz + h  # apex
    k = r / h
    k2 = k * k
    ox = o[..., 0] - ax
    oy = o[..., 1] - ay
    oz = o[..., 2] - az
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy - k2 * dz * dz
    b = 2.0 * (ox * dx + oy * dy - k2 * oz * dz)
    cq = ox * ox + oy * oy - k2 * oz * oz
    disc = b * b - 4 * a * cq
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    asafe = jnp.where(jnp.abs(a) > 1e-12, a, 1e-12)
    t1 = (-b - sq) / (2 * asafe)
    t2 = (-b + sq) / (2 * asafe)

    def ok(t):
        z = o[..., 2] + t * d[..., 2]
        return (disc >= 0) & (t > 0) & (z >= cz) & (z <= cz + h)

    t_lat = jnp.where(ok(t1), t1, jnp.where(ok(t2), t2, _INF))

    dzs = jnp.where(jnp.abs(dz) > 1e-12, dz, 1e-12)
    t = (cz - o[..., 2]) / dzs
    x = o[..., 0] + t * d[..., 0] - cx
    y = o[..., 1] + t * d[..., 1] - cy
    okb = (t > 0) & (x * x + y * y <= r * r)
    return jnp.minimum(t_lat, jnp.where(okb, t, _INF))


def _ray_solid(o, d, solid):
    if isinstance(solid, Box):
        return _ray_box(o, d, solid)
    if isinstance(solid, Cylinder):
        return _ray_cylinder(o, d, solid)
    if isinstance(solid, Cone):
        return _ray_cone(o, d, solid)
    raise TypeError(type(solid))


# ---------------------------------------------------------------------------
# RGB-D camera
# ---------------------------------------------------------------------------

def _canonical_solids(solids):
    """Hashable copies of scene solids for the renderer caches: the render
    API is duck-typed (fields are only read), so tolerate list/ndarray
    fields by tuple-ifying them instead of crashing inside lru_cache."""
    import dataclasses

    out = []
    for s in solids:
        kw = {}
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            if isinstance(v, (list, np.ndarray)):
                v = tuple(float(x) for x in np.asarray(v).ravel())
            elif isinstance(v, (np.floating, np.integer)):
                v = float(v)
            kw[f.name] = v
        out.append(dataclasses.replace(s, **kw))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _rgbd_renderer(solids, intr: PinholeIntrinsics, near: float, far: float,
                   include_floor: bool):
    """One jitted render program per (scene solids, camera): see
    _lidar_renderer — a capture renders VGA rays over every solid in one
    program. The ray table is built host-side and passed as a call
    argument (uploaded once, NOT embedded as a per-program HLO
    constant — a closed-over device array would bloat every compile and
    the persistent cache by ~3.7 MB at VGA)."""
    rays_dev = jnp.asarray(intr.pixel_rays_np())

    @jax.jit
    def render(cam_pose_world, rays):
        R = cam_pose_world[:3, :3].astype(jnp.float32)
        t = cam_pose_world[:3, 3].astype(jnp.float32)
        dirs = rays @ R.T                 # (H, W, 3) world, unit z-cam
        o = jnp.broadcast_to(t, dirs.shape)

        ts = jnp.stack([_ray_solid(o, dirs, s) for s in solids])  # (K,H,W)
        if include_floor:
            dz = jnp.where(jnp.abs(dirs[..., 2]) > 1e-12, dirs[..., 2],
                           1e-12)
            t_floor = (0.0 - t[2]) / dz
            t_floor = jnp.where(t_floor > 0, t_floor, _INF)
            ts = jnp.concatenate([ts, t_floor[None]], axis=0)

        best = jnp.argmin(ts, axis=0)
        tmin = jnp.min(ts, axis=0)
        # depth = optical z = t (rays have unit z in camera frame)
        depth = jnp.where((tmin > near) & (tmin < far), tmin, 0.0)

        colors = [s.color for s in solids]
        if include_floor:
            colors.append((0.9, 0.9, 0.9))
        palette = jnp.asarray(colors, jnp.float32) * 255.0
        color = jnp.take(palette, best, axis=0)
        color = jnp.where((depth > 0)[..., None], color, 0.0)
        return depth, color

    return lambda pose: render(pose, rays_dev)


def render_rgbd(scene: Scene, cam_pose_world: np.ndarray,
                intr: PinholeIntrinsics, near: float = 0.05,
                far: float = 10.0, include_floor: bool | None = None):
    """Render depth (H, W) f32 meters (0 = no return) and color (H, W, 3)
    f32 in [0, 255] from an optical-frame camera pose."""
    if include_floor is None:
        include_floor = scene.floor
    render = _rgbd_renderer(_canonical_solids(scene.all_solids()), intr,
                            float(near), float(far), bool(include_floor))
    return render(jnp.asarray(cam_pose_world, jnp.float32))


def render_depth(scene: Scene, cam_pose_world: np.ndarray,
                 intr: PinholeIntrinsics, **kw) -> jnp.ndarray:
    return render_rgbd(scene, cam_pose_world, intr, **kw)[0]


# ---------------------------------------------------------------------------
# 2D LiDAR
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _lidar_renderer(solids, range_min: float, range_max: float,
                    sensor_z: float):
    """One jitted render program per (scene solids, lidar params): the
    mission loop renders a scan every control batch, so the whole render
    is one device program rather than a chain of eager ops. Solids are hashable frozen
    dataclasses, so they close over the trace as static geometry."""

    @jax.jit
    def render(robot_x, robot_y, robot_yaw, angles):
        ga = robot_yaw + angles
        dirs = jnp.stack(
            [jnp.cos(ga), jnp.sin(ga), jnp.zeros_like(ga)], axis=-1)
        o = jnp.stack(
            [jnp.broadcast_to(jnp.float32(robot_x), ga.shape),
             jnp.broadcast_to(jnp.float32(robot_y), ga.shape),
             jnp.full(ga.shape, sensor_z, jnp.float32)], axis=-1)
        ts = jnp.stack([_ray_solid(o, dirs, s) for s in solids])
        tmin = jnp.min(ts, axis=0)
        return jnp.where((tmin >= range_min) & (tmin <= range_max),
                         tmin, jnp.inf)

    return render


def render_lidar(scene: Scene, robot_x: float, robot_y: float,
                 robot_yaw: float, angles: jnp.ndarray,
                 range_min: float = 0.12, range_max: float = 10.0,
                 sensor_z: float = 0.17) -> jnp.ndarray:
    """Planar scan at height sensor_z; returns ranges (N,), +inf = no return."""
    render = _lidar_renderer(_canonical_solids(scene.all_solids()),
                             float(range_min), float(range_max),
                             float(sensor_z))
    return render(jnp.float32(robot_x), jnp.float32(robot_y),
                  jnp.float32(robot_yaw), jnp.asarray(angles))


@functools.lru_cache(maxsize=64)
def _lidar_path_renderer(solids, range_min: float, range_max: float,
                         sensor_z: float):
    """Vmapped-and-jitted variant of _lidar_renderer: K poses -> (K, B)
    scans in ONE device program (not K dispatches per navigation
    transit)."""
    render = _lidar_renderer(solids, range_min, range_max, sensor_z)
    return jax.jit(jax.vmap(render, in_axes=(0, 0, 0, None)))


def render_lidar_path(scene: Scene, xs, ys, yaws, angles: jnp.ndarray,
                      range_min: float = 0.12, range_max: float = 10.0,
                      sensor_z: float = 0.17) -> jnp.ndarray:
    """Scans along a path: (K,) pose arrays -> (K, B) ranges, one dispatch.
    Bit-identical per row to render_lidar at the same pose (same traced
    program under vmap)."""
    render = _lidar_path_renderer(_canonical_solids(scene.all_solids()),
                                  float(range_min), float(range_max),
                                  float(sensor_z))
    return render(jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32),
                  jnp.asarray(yaws, jnp.float32), jnp.asarray(angles))
