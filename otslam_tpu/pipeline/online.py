"""Online (streaming) TSDF fusion.

Production serving shape: a sensor/capture thread pushes RGB-D frames into
the native SPSC ring buffer (adapters/native.FrameRing — drop-oldest QoS, no
GIL contention on the copy), and the fusion loop drains them in micro-batches
through the block-sparse path into a persistent volume. Poses ride a
parallel Python-side queue keyed by the frame stamp.

    of = OnlineFusion(cfg.reconstruction, intr)
    of.push(depth, color, pose)          # sensor side (any thread)
    of.drain()                           # fusion side: integrate pending
    pts, cols, mask = of.extract()       # anytime snapshot
"""

from __future__ import annotations

import threading
from typing import Optional

import jax.numpy as jnp
import numpy as np

from otslam_tpu.adapters.native import FrameRing
from otslam_tpu.config import ReconstructionConfig
from otslam_tpu.core.camera import PinholeIntrinsics
from otslam_tpu.kernels.tsdf_block import (
    BlockTSDFVolume, extract_surface_points_sparse, integrate_frames_sparse,
    make_block_volume)


class OnlineFusion:
    def __init__(self, cfg: ReconstructionConfig, intr: PinholeIntrinsics,
                 ring_capacity: int = 16, batch: int = 4,
                 max_active: int = 2048):
        self.cfg = cfg
        self.intr = intr
        self.batch = batch
        self.max_active = max_active
        self.ring = FrameRing(intr.height, intr.width, ring_capacity)
        self._poses: dict = {}
        self._pose_lock = threading.Lock()
        self._stamp = 0
        self.volume: BlockTSDFVolume = make_block_volume(cfg.tsdf)
        self.frames_fused = 0

    # --- producer side ------------------------------------------------------

    def push(self, depth_m: np.ndarray, color_rgb: np.ndarray,
             extrinsic: np.ndarray) -> int:
        """Enqueue one frame (world->camera extrinsic). Thread-safe SPSC:
        one producer thread, one consumer thread."""
        with self._pose_lock:
            self._stamp += 1
            stamp = self._stamp
            self._poses[stamp] = np.asarray(extrinsic, np.float32)
        self.ring.push(depth_m, color_rgb, stamp=float(stamp))
        return stamp

    # --- consumer side ------------------------------------------------------

    def drain(self, max_batches: Optional[int] = None) -> int:
        """Integrate everything pending (in arrival order); returns the
        number of frames fused this call."""
        fused = 0
        batches = 0
        while max_batches is None or batches < max_batches:
            frames = []
            while len(frames) < self.batch:
                item = self.ring.pop()
                if item is None:
                    break
                frames.append(item)
            if not frames:
                break
            depths = np.stack([f[0] for f in frames])
            colors = np.stack([f[1] for f in frames]).astype(np.float32)
            with self._pose_lock:
                exts = np.stack([self._poses.pop(int(f[2])) for f in frames])
            # pad the tail batch to the compiled batch size (repeating the
            # last frame with zeroed depth = no-op updates)
            if len(frames) < self.batch:
                pad = self.batch - len(frames)
                depths = np.concatenate(
                    [depths, np.zeros((pad,) + depths.shape[1:], np.float32)])
                colors = np.concatenate(
                    [colors, np.zeros((pad,) + colors.shape[1:], np.float32)])
                exts = np.concatenate(
                    [exts, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
            self.volume = integrate_frames_sparse(
                self.volume, jnp.asarray(depths), jnp.asarray(colors),
                jnp.asarray(exts), self.intr, max_active=self.max_active)
            fused += len(frames)
            batches += 1
        self.frames_fused += fused
        return fused

    def extract(self, capacity: int = 1_000_000, max_blocks: int = 8192,
                with_normals: bool = False):
        return extract_surface_points_sparse(
            self.volume, capacity=capacity, max_blocks=max_blocks,
            with_normals=with_normals)

    @property
    def dropped_frames(self) -> int:
        return self.ring.dropped
