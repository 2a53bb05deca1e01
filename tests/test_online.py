"""Streaming fusion: sensor thread -> native ring -> block-sparse fusion loop."""

import threading

import numpy as np
import pytest

from otslam_tpu.config import ReconstructionConfig, TSDFConfig
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.pipeline.online import OnlineFusion

INTR = PinholeIntrinsics(64, 48, 56.0, 56.0, 32.0, 24.0)
CFG = ReconstructionConfig(
    tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 64),
                    origin=(-0.64, -0.64, -0.64)))


def frame(i):
    depth = np.full((48, 64), 0.4503 + 0.0051 * i, np.float32)
    color = np.full((48, 64, 3), 120, np.uint8)
    ext = np.eye(4, dtype=np.float32)
    return depth, color, ext


class TestOnlineFusion:
    @pytest.mark.slow
    def test_push_drain_extract(self):
        of = OnlineFusion(CFG, INTR, batch=4, max_active=512)
        for i in range(6):
            of.push(*frame(i))
        fused = of.drain()
        assert fused == 6  # full batch of 4 + padded tail of 2
        assert of.frames_fused == 6
        pts, cols, mask = of.extract(capacity=100_000, max_blocks=512)
        pts = np.asarray(pts)[np.asarray(mask)]
        assert len(pts) > 100
        # surface near the mean wall depth
        assert abs(np.median(pts[:, 2]) - 0.463) < 0.03
        # weights reflect all six frames at the wall band
        assert float(of.volume.weight.max()) == 6.0

    @pytest.mark.slow
    def test_threaded_producer(self):
        of = OnlineFusion(CFG, INTR, ring_capacity=32, batch=4,
                          max_active=512)
        n = 12

        def produce():
            for i in range(n):
                of.push(*frame(i))

        t = threading.Thread(target=produce)
        t.start()
        total = 0
        while t.is_alive() or len(of.ring):
            total += of.drain(max_batches=1)
        t.join()
        total += of.drain()
        assert total + of.dropped_frames == n
        assert of.frames_fused == total

    @pytest.mark.slow
    def test_incremental_equals_batch(self):
        """Streaming in two drains == one batch (order preserved)."""
        import jax.numpy as jnp
        from otslam_tpu.kernels.tsdf_block import make_block_volume
        from otslam_tpu.kernels.tsdf_block import integrate_frames_sparse

        of = OnlineFusion(CFG, INTR, batch=4, max_active=512)
        frames = [frame(i) for i in range(8)]
        for f in frames[:4]:
            of.push(*f)
        of.drain()
        for f in frames[4:]:
            of.push(*f)
        of.drain()

        depths = jnp.asarray(np.stack([f[0] for f in frames]))
        colors = jnp.asarray(np.stack([f[1] for f in frames]).astype(np.float32))
        exts = jnp.asarray(np.stack([f[2] for f in frames]))
        ref = integrate_frames_sparse(make_block_volume(CFG.tsdf), depths,
                                      colors, exts, INTR, max_active=512)
        np.testing.assert_allclose(np.asarray(of.volume.tsdf),
                                   np.asarray(ref.tsdf), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(of.volume.weight),
                                      np.asarray(ref.weight))


class TestOnlineFusionFast:
    def test_small_session_smoke(self):
        """Fast-tier representative: a 2-frame session fuses and extracts
        (the full batch-equality/threaded suites run in the slow tier)."""
        of = OnlineFusion(CFG, INTR, batch=2, max_active=256)
        for i in range(2):
            of.push(*frame(i))
        assert of.drain() == 2
        pts, cols, mask = of.extract(capacity=50_000, max_blocks=512)
        pts = np.asarray(pts)[np.asarray(mask)]
        assert len(pts) > 100
        assert float(of.volume.weight.max()) == 2.0
