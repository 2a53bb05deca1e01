"""Robust marginal-rate estimation for benchmarks with a fixed per-call cost.

The round-4 ICP scoreboard entry was 45,000,000 iters/s of garbage: the
two-point slope ``(hi - lo) / max(t_hi - t_lo, 1e-6)`` converts a negative
timing delta (pure timer noise) into a 7-orders-of-magnitude lie, and
``max(windowed, full)`` promoted it to the headline. This module replaces
that with a pure estimator that is *incapable* of reporting a failed fit as
a rate:

* fit a least-squares line ``t = a + b * count`` over >=3 iteration counts;
* reject (never clamp) non-positive slopes, poor fits (relative residual),
  spans below timer resolution, and rates above a caller-supplied physical
  ceiling;
* callers retry with fresh measurements on rejection and fall back to the
  average rate (fixed cost included, physically bounded), clearly labeled.

Pure functions, no jax imports: unit-tested with injected timings
(tests/test_rate_estimate.py) so the failure modes are pinned on CPU.

Workload contract for the ICP benchmark that drives this:
/root/reference/eval/eval_table_chair/eval_table_chair.py:90-104.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class RateEstimate:
    """Result of one marginal-rate fit.

    ``ok`` is True only when the fit passed every plausibility gate; callers
    MUST NOT publish ``rate`` from a not-ok estimate (it is None there).
    """

    ok: bool
    rate: float | None          # units/s; None unless ok
    slope: float                # fitted seconds per unit
    intercept: float            # fitted fixed cost (dispatch), seconds
    residual_rel: float         # RMS residual / fitted time span
    reason: str                 # "ok" or the first failed gate
    counts: tuple[float, ...]
    times: tuple[float, ...]

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("rate", "slope", "intercept", "residual_rel"):
            v = d[k]
            if v is not None:
                d[k] = round(v, 6)
        return d


def fit_marginal_rate(
    counts: Sequence[float],
    times: Sequence[float],
    *,
    ceiling: float | None = None,
    max_residual_rel: float = 0.25,
    min_span_s: float = 0.02,
) -> RateEstimate:
    """Least-squares marginal rate from (iteration count, wall time) samples.

    The slope of time-vs-count is the device's per-iteration cost with the
    fixed dispatch cost (the intercept) removed — the two-point version
    of this is the "marginal rate" methodology in CLAUDE.md, hardened:

    * >=3 distinct counts required (two points cannot expose noise);
    * all times must be finite and positive;
    * the fitted span ``slope * (max-min count)`` must exceed ``min_span_s``
      (below that the timer noise IS the signal);
    * the slope must be positive and the residual small;
    * ``ceiling`` (units/s) is a physical upper bound from the workload's
      minimum HBM traffic — a rate above it is a measurement failure, not a
      fast kernel, and is rejected rather than clamped.
    """
    cs = tuple(float(c) for c in counts)
    ts = tuple(float(t) for t in times)

    def fail(reason: str, slope=0.0, intercept=0.0, resid=0.0):
        return RateEstimate(False, None, slope, intercept, resid, reason,
                            cs, ts)

    if len(cs) != len(ts) or len(set(cs)) < 3:
        return fail("need >=3 distinct counts")
    if any(not (t > 0.0) or t != t or t == float("inf") for t in ts):
        return fail("non-finite or non-positive time")

    n = len(cs)
    mc = sum(cs) / n
    mt = sum(ts) / n
    sxx = sum((c - mc) ** 2 for c in cs)
    sxy = sum((c - mc) * (t - mt) for c, t in zip(cs, ts))
    slope = sxy / sxx
    intercept = mt - slope * mc
    span = slope * (max(cs) - min(cs))
    resid_rms = (sum((t - (intercept + slope * c)) ** 2
                     for c, t in zip(cs, ts)) / n) ** 0.5
    resid_rel = resid_rms / abs(span) if span else float("inf")

    if slope <= 0.0:
        # negative timing delta: timer noise exceeded the marginal work —
        # the exact failure that manufactured 45M iters/s when clamped
        return fail("non-positive slope (timing noise > marginal work)",
                    slope, intercept, resid_rel)
    if span < min_span_s:
        return fail(f"fitted span {span:.4f}s below min_span {min_span_s}s",
                    slope, intercept, resid_rel)
    if resid_rel > max_residual_rel:
        return fail(f"residual {resid_rel:.3f} exceeds {max_residual_rel}",
                    slope, intercept, resid_rel)
    rate = 1.0 / slope
    if ceiling is not None and rate > ceiling:
        return fail(f"rate {rate:.1f}/s above physical ceiling "
                    f"{ceiling:.1f}/s", slope, intercept, resid_rel)
    return RateEstimate(True, rate, slope, intercept, resid_rel, "ok", cs, ts)


def measure_marginal_rate(
    timed_fn: Callable[[int], float],
    counts: Sequence[int],
    *,
    attempts: int = 3,
    ceiling: float | None = None,
    max_residual_rel: float = 0.25,
    min_span_s: float = 0.02,
) -> RateEstimate:
    """Measure-and-fit with retry: ``timed_fn(count) -> seconds`` is invoked
    for every count, the samples are fitted, and a rejected fit triggers a
    full re-measure (fresh timings — the rejection reasons are all transient
    transient noise or permanent workload misconfiguration; retrying
    distinguishes them) up to ``attempts`` times. Returns the first ok
    estimate, else the last failed one (ok=False) for the caller to handle —
    never a fabricated rate."""
    est = None
    for _ in range(max(1, attempts)):
        ts = [timed_fn(int(c)) for c in counts]
        est = fit_marginal_rate(counts, ts, ceiling=ceiling,
                                max_residual_rel=max_residual_rel,
                                min_span_s=min_span_s)
        if est.ok:
            return est
    return est


def average_rate_fallback(count: float, time_s: float,
                          ceiling: float | None = None) -> float | None:
    """Last-resort rate when every marginal fit failed: the plain average
    ``count / time`` of the largest run. Under-reports the device rate —
    it includes the fixed dispatch cost the marginal fit removes — but is
    physically bounded and honest. Returns None if even this
    is implausible."""
    if not (time_s > 0.0) or time_s != time_s:
        return None
    rate = count / time_s
    if ceiling is not None and rate > ceiling:
        return None
    return rate
