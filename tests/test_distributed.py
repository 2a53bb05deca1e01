"""Multi-chip sharding on the virtual 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8, per SURVEY.md §4(c))."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from otslam_tpu.config import TSDFConfig
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.distributed.mesh import make_mesh
from otslam_tpu.distributed.sharding import (
    fuse_frames_data_parallel, fuse_frames_2d_sharded, chamfer_data_parallel)
from otslam_tpu.kernels.nn import nn_distance
from otslam_tpu.kernels.tsdf import make_volume, integrate_frames

INTR = PinholeIntrinsics(64, 48, 56.0, 56.0, 32.0, 24.0)
CFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 64),
                 origin=(-0.64, -0.64, -0.64))


def frames(n=8):
    depths = np.stack([np.full((48, 64), 0.4503 + 0.013 * i, np.float32)
                       for i in range(n)])
    colors = np.stack([np.full((48, 64, 3), 90.0 + 10 * i, np.float32)
                       for i in range(n)])
    exts = np.stack([np.eye(4, dtype=np.float32)] * n)
    return jnp.asarray(depths), jnp.asarray(colors), jnp.asarray(exts)


@pytest.fixture(scope="module")
def eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()[:8]


class TestDataParallel:
    def test_matches_single_chip(self, eight_devices):
        mesh = make_mesh((8,), ("data",), eight_devices)
        d, c, e = frames(8)
        vol = fuse_frames_data_parallel(d, c, e, INTR, CFG, mesh)
        ref = integrate_frames(make_volume(CFG), d, c, e, INTR)
        np.testing.assert_allclose(np.asarray(vol.weight),
                                   np.asarray(ref.weight), atol=0)
        np.testing.assert_allclose(np.asarray(vol.tsdf),
                                   np.asarray(ref.tsdf), atol=1e-5)
        np.testing.assert_allclose(np.asarray(vol.color),
                                   np.asarray(ref.color), atol=1e-3)

    def test_rejects_indivisible(self, eight_devices):
        mesh = make_mesh((8,), ("data",), eight_devices)
        d, c, e = frames(6)
        with pytest.raises(ValueError):
            fuse_frames_data_parallel(d, c, e, INTR, CFG, mesh)


class TestTwoDSharded:
    def test_matches_single_chip(self, eight_devices):
        mesh = make_mesh((4, 2), ("data", "model"), eight_devices)
        d, c, e = frames(8)
        vol = fuse_frames_2d_sharded(d, c, e, INTR, CFG, mesh)
        ref = integrate_frames(make_volume(CFG), d, c, e, INTR)
        np.testing.assert_allclose(np.asarray(vol.weight),
                                   np.asarray(ref.weight), atol=0)
        np.testing.assert_allclose(np.asarray(vol.tsdf),
                                   np.asarray(ref.tsdf), atol=1e-4)


class TestChamferSharded:
    def test_matches_single_chip(self, eight_devices, rng):
        mesh = make_mesh((8,), ("data",), eight_devices)
        src = jnp.asarray(rng.standard_normal((1024, 3)).astype(np.float32))
        dst = jnp.asarray(rng.standard_normal((2048, 3)).astype(np.float32))
        got = chamfer_data_parallel(src, dst, mesh, chunk=256)
        want = jnp.mean(nn_distance(src, dst, chunk=256))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


class TestHierarchicalMesh:
    """2-level (dcn, ici) mesh: hierarchical psum (ici first, then dcn)."""

    def test_matches_single_chip(self, eight_devices):
        from otslam_tpu.distributed.sharding import fuse_frames_hierarchical
        mesh = make_mesh((4, 2), ("dcn", "ici"), eight_devices)
        d, c, e = frames(8)
        vol = fuse_frames_hierarchical(d, c, e, INTR, CFG, mesh)
        ref = integrate_frames(make_volume(CFG), d, c, e, INTR)
        np.testing.assert_allclose(np.asarray(vol.weight),
                                   np.asarray(ref.weight), atol=0)
        np.testing.assert_allclose(np.asarray(vol.tsdf),
                                   np.asarray(ref.tsdf), atol=1e-5)

    def test_2x4_shape(self, eight_devices):
        from otslam_tpu.distributed.sharding import fuse_frames_hierarchical
        mesh = make_mesh((2, 4), ("dcn", "ici"), eight_devices)
        d, c, e = frames(16)
        vol = fuse_frames_hierarchical(d, c, e, INTR, CFG, mesh)
        ref = integrate_frames(make_volume(CFG), d, c, e, INTR)
        np.testing.assert_allclose(np.asarray(vol.tsdf),
                                   np.asarray(ref.tsdf), atol=1e-5)


class TestObjectParallel:
    """Object-axis sharding: one object per device, zero collectives."""

    def test_matches_serial_per_object(self, eight_devices):
        from otslam_tpu.distributed.sharding import fuse_objects_parallel
        import dataclasses as dc
        mesh = make_mesh((8,), ("data",), eight_devices)
        rngs = np.random.default_rng(0)
        O, N = 8, 4
        depths = np.stack([
            np.full((N, 48, 64), 0.42 + 0.02 * o, np.float32)
            for o in range(O)])
        colors = np.full((O, N, 48, 64, 3), 120.0, np.float32)
        exts = np.tile(np.eye(4, dtype=np.float32)[None, None], (O, N, 1, 1))
        origins = np.asarray(
            [(-0.64 + 0.1 * o, -0.64, -0.64) for o in range(O)], np.float32)

        tsdf, weight, color = fuse_objects_parallel(
            jnp.asarray(depths), jnp.asarray(colors), jnp.asarray(exts),
            jnp.asarray(origins), INTR, CFG, mesh)
        for o in range(O):
            cfg_o = dc.replace(CFG, origin=tuple(map(float, origins[o])))
            ref = integrate_frames(make_volume(cfg_o), jnp.asarray(depths[o]),
                                   jnp.asarray(colors[o]),
                                   jnp.asarray(exts[o]), INTR)
            np.testing.assert_allclose(np.asarray(weight[o]),
                                       np.asarray(ref.weight), atol=0)
            np.testing.assert_allclose(np.asarray(tsdf[o]),
                                       np.asarray(ref.tsdf), atol=1e-4)

    def test_reconstruct_all_sharded_matches_serial(self, eight_devices,
                                                    tmp_path):
        """Dataset-level object sharding matches pipeline.reconstruct_object
        (dense backend) on every object."""
        from otslam_tpu.config import CameraConfig, ReconstructionConfig
        from otslam_tpu.distributed.sharding import reconstruct_all_sharded
        from otslam_tpu.pipeline.dataset import CaptureDataset
        from otslam_tpu.pipeline.reconstruct import reconstruct_object
        from otslam_tpu.core.se3 import T_FIX_OPTICAL, invert_se3
        from otslam_tpu.sim.sensors import look_at_pose, render_rgbd
        from otslam_tpu.sim.world import Box, Scene

        cam = CameraConfig(width=64, height=48, fx=56.0, fy=56.0,
                           cx=32.0, cy=24.0)
        cfg = ReconstructionConfig(
            camera=cam, tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08,
                                        dims=(64, 64, 32),
                                        origin=(0.0, 0.0, -0.1)),
            surface_samples=4000)
        scene = Scene(objects=(
            Box((1.0, 0.0, 0.15), (0.4, 0.4, 0.3), 0.0, (0.8, 0.4, 0.2),
                "a"),
            Box((-1.0, 1.0, 0.1), (0.3, 0.3, 0.2), 0.4, (0.2, 0.4, 0.8),
                "b")))
        ds = CaptureDataset(str(tmp_path / "ds"), cam)
        intr = PinholeIntrinsics.from_config(cam)
        import jax.numpy as jnp_
        for k, (center, n_frames) in enumerate(
                [((1.0, 0.0, 0.15), 4), ((-1.0, 1.0, 0.1), 3)]):
            for i in range(n_frames):
                a = 2 * np.pi * i / n_frames
                eye = np.array([center[0] + 0.9 * np.cos(a),
                                center[1] + 0.9 * np.sin(a), 0.45])
                pose = look_at_pose(eye, np.asarray(center))
                d, c = render_rgbd(scene, pose, intr, far=4.0)
                # dataset stores the BODY pose; the loader right-multiplies
                # T_FIX_OPTICAL and inverts to recover this optical extrinsic
                body = pose @ invert_se3(T_FIX_OPTICAL)
                ds.save_frame(f"Object_{k}", np.asarray(c).astype(np.uint8),
                              np.asarray(d), body)

        mesh = make_mesh((8,), ("data",), eight_devices)
        got = reconstruct_all_sharded(ds, cfg, mesh, seed=3)
        assert sorted(got) == ["Object_0", "Object_1"]
        for name, res in got.items():
            # auto_dims=False: the sharded path's static-shape contract
            ref = reconstruct_object(ds, name, cfg, backend="dense",
                                     auto_origin=True, auto_dims=False,
                                     seed=3)
            assert res.num_frames == ref.num_frames
            assert abs(res.raw_surface_count - ref.raw_surface_count) \
                <= 0.01 * ref.raw_surface_count + 5
            got_c = res.points.mean(axis=0)
            ref_c = ref.points.mean(axis=0)
            np.testing.assert_allclose(got_c, ref_c, atol=0.02)
            # fused volumes agree to reassociation level (asserted directly
            # in test_matches_serial_per_object); here assert the extracted
            # clouds are geometrically identical: every sharded point sits
            # on the serial surface (NN distance ~interp noise, not voxels)
            d_ab = np.asarray(nn_distance(
                jnp.asarray(res.points), jnp.asarray(ref.points), chunk=512))
            assert float(d_ab.max()) < 2e-3, float(d_ab.max())


def sparse_frames(n=16):
    """Frames whose surface recedes in big steps: blocks created by early
    frames leave later frames' creation bands but stay visible (free-space
    carving), so correctness REQUIRES the cross-device creation prefix —
    a shard integrating without the earlier shards' bands loses those
    carving updates."""
    depths = np.stack([np.full((48, 64), 0.45 + 0.09 * i, np.float32)
                       for i in range(n)])
    colors = np.stack([np.full((48, 64, 3), 60.0 + 10 * i, np.float32)
                       for i in range(n)])
    exts = np.stack([np.eye(4, dtype=np.float32)] * n)
    return depths, colors, exts


class TestSparseDataParallel:
    """Frame-sharded BLOCK-SPARSE fusion — the fast path's multi-device
    form. Workload contract: reconstruct_rgbd_filter.py:91-105."""

    def test_sharded_sparse_smoke(self, eight_devices):
        """Cheap fast-tier representative: 2 frames over 2 devices match
        the single-device path exactly (the full 8-frame parity +
        creation-prefix suites run in the slow tier)."""
        from otslam_tpu.distributed.sparse import (
            fuse_frames_sparse_data_parallel)
        from otslam_tpu.kernels.tsdf_block import make_block_volume
        from otslam_tpu.kernels.tsdf_block import integrate_frames_sparse

        mesh = make_mesh((2,), ("data",), eight_devices[:2])
        d, c, e = sparse_frames(2)
        got = fuse_frames_sparse_data_parallel(
            make_block_volume(CFG), d, c, e, INTR, mesh, max_active=128)
        ref = integrate_frames_sparse(
            make_block_volume(CFG), d, c, e, INTR, max_active=128)
        np.testing.assert_allclose(np.asarray(got.weight),
                                   np.asarray(ref.weight), atol=0)
        np.testing.assert_allclose(np.asarray(got.tsdf),
                                   np.asarray(ref.tsdf), atol=1e-4)

    @pytest.mark.slow
    def test_matches_single_device(self, eight_devices):
        from otslam_tpu.distributed.sparse import (
            fuse_frames_sparse_data_parallel)
        from otslam_tpu.kernels.tsdf_block import auto_max_active
        from otslam_tpu.kernels.tsdf_block import make_block_volume
        from otslam_tpu.kernels.tsdf_block import integrate_frames_sparse

        mesh = make_mesh((4,), ("data",), eight_devices[:4])
        d, c, e = sparse_frames(8)
        # max_active omitted: the default auto-sizes with auto_max_active
        # (parity holds for any sufficient capacity)
        got = fuse_frames_sparse_data_parallel(
            make_block_volume(CFG), d, c, e, INTR, mesh)
        vol0 = make_block_volume(CFG)
        ma = auto_max_active(vol0, d, e, INTR)
        ref = integrate_frames_sparse(
            make_block_volume(CFG), d, c, e, INTR,
            max_active=max(ma, 128))
        assert bool(jnp.all(got.created == ref.created))
        np.testing.assert_allclose(np.asarray(got.weight),
                                   np.asarray(ref.weight), atol=0)
        np.testing.assert_allclose(np.asarray(got.tsdf),
                                   np.asarray(ref.tsdf), atol=1e-4)
        np.testing.assert_allclose(np.asarray(got.color),
                                   np.asarray(ref.color), atol=1e-3)

    @pytest.mark.slow
    def test_creation_prefix_has_teeth(self, eight_devices):
        """The receding-surface workload genuinely depends on the creation
        prefix: shards fused independently (no earlier-device bands) lose
        carving weight vs the serial path."""
        from otslam_tpu.kernels.tsdf_block import make_block_volume
        from otslam_tpu.kernels.tsdf_block import integrate_frames_sparse

        d, c, e = sparse_frames(8)
        ref = integrate_frames_sparse(
            make_block_volume(CFG), d, c, e, INTR, max_active=1024)
        w_indep = 0.0
        for s in range(4):
            sl = slice(2 * s, 2 * s + 2)
            part = integrate_frames_sparse(
                make_block_volume(CFG), d[sl], c[sl], e[sl], INTR,
                max_active=1024)
            w_indep += float(jnp.sum(part.weight))
        assert w_indep < 0.98 * float(jnp.sum(ref.weight)), (
            "fixture does not exercise the creation prefix")

    @pytest.mark.slow
    def test_resumes_from_prior_volume(self, eight_devices):
        """Sharded fusion of the second half on top of a serially-fused
        first half equals the full serial run (prior running means merge
        through the partial-sum reduce)."""
        from otslam_tpu.distributed.sparse import (
            fuse_frames_sparse_data_parallel)
        from otslam_tpu.kernels.tsdf_block import auto_max_active
        from otslam_tpu.kernels.tsdf_block import make_block_volume
        from otslam_tpu.kernels.tsdf_block import integrate_frames_sparse

        mesh = make_mesh((4,), ("data",), eight_devices[:4])
        d, c, e = sparse_frames(8)
        ref = integrate_frames_sparse(
            make_block_volume(CFG), d, c, e, INTR, max_active=1024)
        half = integrate_frames_sparse(
            make_block_volume(CFG), d[:4], c[:4], e[:4], INTR,
            max_active=1024)
        ma = auto_max_active(half, d[4:], e[4:], INTR)
        got = fuse_frames_sparse_data_parallel(
            half, d[4:], c[4:], e[4:], INTR, mesh, max_active=ma)
        assert bool(jnp.all(got.created == ref.created))
        np.testing.assert_allclose(np.asarray(got.weight),
                                   np.asarray(ref.weight), atol=0)
        np.testing.assert_allclose(np.asarray(got.tsdf),
                                   np.asarray(ref.tsdf), atol=1e-4)

    def test_rejects_indivisible(self, eight_devices):
        from otslam_tpu.distributed.sparse import (
            fuse_frames_sparse_data_parallel)
        from otslam_tpu.kernels.tsdf_block import make_block_volume

        mesh = make_mesh((8,), ("data",), eight_devices)
        d, c, e = sparse_frames(6)
        with pytest.raises(ValueError):
            fuse_frames_sparse_data_parallel(
                make_block_volume(CFG), d, c, e, INTR, mesh)


class TestSparseObjectParallel:
    """Object-axis sharding of the block-sparse path: one BlockTSDFVolume
    per device, zero integrate-time collectives."""

    @pytest.mark.slow
    def test_matches_serial_per_object(self, eight_devices):
        import dataclasses as dc

        from otslam_tpu.distributed.sparse import fuse_objects_sparse_parallel
        from otslam_tpu.kernels.tsdf_block import make_block_volume
        from otslam_tpu.kernels.tsdf_block import integrate_frames_sparse

        mesh = make_mesh((2,), ("data",), eight_devices[:2])
        O, N = 2, 4
        depths = np.stack([
            np.full((N, 48, 64), 0.42 + 0.02 * o, np.float32)
            for o in range(O)])
        colors = np.full((O, N, 48, 64, 3), 120.0, np.float32)
        exts = np.tile(np.eye(4, dtype=np.float32)[None, None], (O, N, 1, 1))
        origins = np.asarray(
            [(-0.64 + 0.1 * o, -0.64, -0.64) for o in range(O)], np.float32)

        # max_active omitted: exercises the per-object auto-sizing default
        tsdf, weight, color, created = fuse_objects_sparse_parallel(
            depths, colors, exts, origins, INTR, CFG, mesh)
        for o in range(O):
            cfg_o = dc.replace(CFG, origin=tuple(map(float, origins[o])))
            ref = integrate_frames_sparse(
                make_block_volume(cfg_o), depths[o], colors[o], exts[o],
                INTR, max_active=256)
            assert bool(jnp.all(created[o] == ref.created))
            np.testing.assert_allclose(np.asarray(weight[o]),
                                       np.asarray(ref.weight), atol=0)
            np.testing.assert_allclose(np.asarray(tsdf[o]),
                                       np.asarray(ref.tsdf), atol=1e-4)
            np.testing.assert_allclose(np.asarray(color[o]),
                                       np.asarray(ref.color), atol=1e-3)

    @pytest.mark.slow
    def test_reconstruct_all_sharded_sparse_matches_serial(
            self, eight_devices, tmp_path):
        """Dataset-level sparse object sharding matches
        pipeline.reconstruct_object(backend='sparse') per object."""
        from otslam_tpu.config import CameraConfig, ReconstructionConfig
        from otslam_tpu.distributed.sparse import (
            reconstruct_all_sharded_sparse)
        from otslam_tpu.pipeline.dataset import CaptureDataset
        from otslam_tpu.pipeline.reconstruct import reconstruct_object
        from otslam_tpu.core.se3 import T_FIX_OPTICAL, invert_se3
        from otslam_tpu.sim.sensors import look_at_pose, render_rgbd
        from otslam_tpu.sim.world import Box, Scene

        cam = CameraConfig(width=64, height=48, fx=56.0, fy=56.0,
                           cx=32.0, cy=24.0)
        cfg = ReconstructionConfig(
            camera=cam, tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08,
                                        dims=(64, 64, 32),
                                        origin=(0.0, 0.0, -0.1)),
            surface_samples=4000)
        scene = Scene(objects=(
            Box((1.0, 0.0, 0.15), (0.4, 0.4, 0.3), 0.0, (0.8, 0.4, 0.2),
                "a"),
            Box((-1.0, 1.0, 0.1), (0.3, 0.3, 0.2), 0.4, (0.2, 0.4, 0.8),
                "b")))
        ds = CaptureDataset(str(tmp_path / "ds"), cam)
        intr = PinholeIntrinsics.from_config(cam)
        for k, (center, n_frames) in enumerate(
                [((1.0, 0.0, 0.15), 4), ((-1.0, 1.0, 0.1), 3)]):
            for i in range(n_frames):
                a = 2 * np.pi * i / n_frames
                eye = np.array([center[0] + 0.9 * np.cos(a),
                                center[1] + 0.9 * np.sin(a), 0.45])
                pose = look_at_pose(eye, np.asarray(center))
                d, c = render_rgbd(scene, pose, intr, far=4.0)
                body = pose @ invert_se3(T_FIX_OPTICAL)
                ds.save_frame(f"Object_{k}", np.asarray(c).astype(np.uint8),
                              np.asarray(d), body)

        mesh = make_mesh((8,), ("data",), eight_devices)
        got = reconstruct_all_sharded_sparse(ds, cfg, mesh, seed=3,
                                             max_active=512)
        assert sorted(got) == ["Object_0", "Object_1"]
        for name, res in got.items():
            # auto_dims=False: the sharded path's static-shape contract
            # (every device shares one volume shape; serial auto_origin
            # would otherwise fit dims per object)
            ref = reconstruct_object(ds, name, cfg, backend="sparse",
                                     auto_origin=True, auto_dims=False,
                                     seed=3)
            assert res.num_frames == ref.num_frames
            assert abs(res.raw_surface_count - ref.raw_surface_count) \
                <= 0.01 * ref.raw_surface_count + 5
            d_ab = np.asarray(nn_distance(
                jnp.asarray(res.points), jnp.asarray(ref.points), chunk=512))
            assert float(d_ab.max()) < 2e-3, float(d_ab.max())


class TestShardedExtraction:
    """Object-axis sharded mesh extraction: one sharded dispatch extracts
    every volume's soup, bit-identical per volume to the single path."""

    def _volumes(self):
        import dataclasses as dc

        from otslam_tpu.kernels.tsdf_block import (integrate_frames_sparse,
                                                   make_block_volume)

        d, c, e = frames(4)
        v1 = integrate_frames_sparse(make_block_volume(CFG), d, c, e, INTR)
        v2 = dc.replace(v1, tsdf=v1.tsdf * 0.8,
                        origin=(-0.24, -0.6, -0.63))
        v3 = dc.replace(v1, tsdf=-v1.tsdf)
        return [v1, v2, v3]

    @pytest.mark.slow
    def test_matches_single_path(self, eight_devices):
        from otslam_tpu.distributed.sparse import extract_meshes_sharded
        from otslam_tpu.kernels.marching import extract_mesh_soup_block

        vols = self._volumes()
        mesh = make_mesh((8,), ("data",), eight_devices)
        # 3 volumes on 8 devices: exercises the pad-to-device-multiple path
        verts, cols, masks = extract_meshes_sharded(vols, mesh,
                                                    max_blocks=256,
                                                    max_cells=8192)
        assert verts.shape[0] == len(vols)
        assert int(jnp.sum(masks[0])) > 100
        for b, v in enumerate(vols):
            sv, sc, sm = extract_mesh_soup_block(v, max_blocks=256,
                                                 max_cells=8192)
            np.testing.assert_array_equal(np.asarray(masks[b]),
                                          np.asarray(sm))
            m = np.asarray(sm)
            np.testing.assert_array_equal(np.asarray(verts[b])[m],
                                          np.asarray(sv)[m])
            np.testing.assert_array_equal(np.asarray(cols[b])[m],
                                          np.asarray(sc)[m])
