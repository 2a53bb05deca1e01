"""otslam_tpu — a selective 3D mapping framework on JAX accelerators.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of OTSLAM
(object-triggered 3D SLAM, reference: TakiRyo/object-triggered-3D-SLAM):
a service robot keeps a lightweight 2D occupancy map, detects objects and
object-level *changes* with a 2D LiDAR, navigates to each object, triggers
targeted RGB-D captures, TSDF-fuses only those captures into per-object 3D
models, and merges the 2D map with the 3D object clouds into a hybrid map.

Layer map (mirrors SURVEY.md):
  core/         camera model, SE(3)/frames, occupancy-grid types, PLY/PGM/YAML io
  kernels/      JAX/Pallas compute kernels (backproject, TSDF, raycast, diff, ...)
  pipeline/     dataset reader + frame->TSDF->point-cloud reconstruction
  mapping/      virtual scan, change detection, selective merge, hybrid map
  mission/      tracker, visiting points, goal queue, manager FSM (host-side)
  sim/          analytic scene/sensor simulator (replaces Gazebo as the fixture)
  eval/         accuracy/completeness metrics, ICP, eval scenarios
  distributed/  device-mesh sharding of fusion/eval workloads
"""

__version__ = "0.1.0"

import jax as _jax

# Accelerators may run f32 matmuls at reduced input precision by default
# (TF32 on the GPU's tensor cores, bf16 elsewhere) — a ~1e-3 relative error
# that silently corrupts SE(3) compositions, point transforms and
# least-squares solves (a 3e-3 rad rotation floor in ICP). Geometry here is
# precision-critical and the small-K matmuls gain nothing from the
# reduced-precision paths, so default to full f32; code that wants bf16
# passes an explicit precision and is unaffected.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: policy and rationale in _compile_cache;
# the CLI's --platform and __graft_entry__ call the same helper.
import os as _os

from otslam_tpu._compile_cache import configure_compile_cache as _configure_cc

_configure_cc(getattr(_jax.config, "jax_platforms", None)
              or _os.environ.get("JAX_PLATFORMS", ""))

from otslam_tpu.config import OTSLAMConfig  # noqa: F401
