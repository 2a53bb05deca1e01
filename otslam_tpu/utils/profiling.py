"""Lightweight tracing/profiling helpers.

The reference has no tracing beyond throttled logs (SURVEY.md §5); here every
pipeline stage can be timed and annotated for the XLA profiler. Use:

    with StageTimer() as t:
        with t.stage("fuse"):
            vol = integrate_frames_sparse(...)
    print(t.report())

Stages nest inside ``jax.profiler.TraceAnnotation`` so device timelines carry
the same labels when a profiler trace is active.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import jax


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextmanager
    def stage(self, name: str, sync: bool = False):
        with jax.profiler.TraceAnnotation(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync:
                    # ensure device work attributed to this stage finished
                    jax.effects_barrier()
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> str:
        rows = [f"{'stage':<24} {'calls':>6} {'total_s':>9} {'mean_ms':>9}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            rows.append(f"{name:<24} {n:>6} {tot:>9.3f} {tot / n * 1e3:>9.2f}")
        return "\n".join(rows)

    def rates(self, name: str, items: int) -> float:
        """items/sec for a stage (e.g. frames fused per second)."""
        tot = self.totals.get(name, 0.0)
        return items / tot if tot > 0 else 0.0
