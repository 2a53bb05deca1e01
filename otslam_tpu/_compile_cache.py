"""Persistent-compilation-cache policy, in one place.

Every CLI invocation is a fresh process, so accelerator sessions keep JAX's
persistent compilation cache:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it natively and this module
  sets no other directory.
* Otherwise every session that is not explicitly CPU — including one with
  ``JAX_PLATFORMS`` unset, which is how a GPU machine starts — uses the
  fixed directory ``<repo>/.jax_cache/`` (gitignored). The path is part of
  the cache key, so it never depends on a temp name, a pid or the time.
* Explicit CPU sessions stay out of the cache: they compile locally in
  sub-seconds anyway, and XLA:CPU caches AOT machine code keyed without the
  host's CPU features, so an entry written on one machine can load on
  another that lacks them.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir_for(platform: str | None) -> str | None:
    """The directory this module sets for a session on `platform` ("cpu",
    "gpu", ..., or None/"" when unresolved): None when it sets none."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    plat = (platform or "").strip().lower()
    if plat.split(",")[0] == "cpu":
        return None
    return CACHE_DIR


def configure_compile_cache(platform: str | None) -> None:
    """Apply the cache policy for `platform`. Safe to call before or after
    backend init; idempotent."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir_for(platform))
