"""Unit tests pinning the marginal-rate estimator's failure modes.

The round-4 regression this guards against: a negative timing delta between
two iteration counts, clamped to 1e-6, manufactured 45,000,000 iters/s and
was promoted to the headline by max(). The estimator must reject such
samples (retry, then labeled fallback) — never fabricate a rate.
"""

import pytest

from otslam_tpu.utils.rate_estimate import (RateEstimate,
                                            average_rate_fallback,
                                            fit_marginal_rate,
                                            measure_marginal_rate)

COUNTS = (15, 30, 60)


def linear(counts, intercept=0.030, per_iter=0.00145):
    return [intercept + per_iter * c for c in counts]


def test_clean_fit_recovers_rate():
    est = fit_marginal_rate(COUNTS, linear(COUNTS), ceiling=700_000.0)
    assert est.ok and est.reason == "ok"
    assert est.rate == pytest.approx(1.0 / 0.00145, rel=1e-6)
    assert est.intercept == pytest.approx(0.030, abs=1e-9)
    assert est.residual_rel < 1e-9


def test_round4_negative_delta_is_rejected_not_45m():
    # the exact round-4 failure shape: the 60-iter run timed no slower than
    # the 15-iter run (timer noise), old code clamped the delta to 1e-6 and
    # reported 45/1e-6 = 45M iters/s
    times = [0.095, 0.093, 0.094]
    est = fit_marginal_rate(COUNTS, times, ceiling=700_000.0)
    assert not est.ok
    assert est.rate is None
    assert "slope" in est.reason or "span" in est.reason


def test_tiny_positive_slope_fails_span_gate():
    # a barely-positive slope from noise: rate would be absurd, and the
    # fitted span is below timer resolution — rejected by span, not clamped
    times = [0.0950, 0.0951, 0.0952]
    est = fit_marginal_rate(COUNTS, times, ceiling=700_000.0)
    assert not est.ok and est.rate is None


def test_physical_ceiling_rejects_superluminal_rates():
    # consistent but absurdly fast: 1e-7 s/iter = 10M iters/s > ceiling
    times = linear(COUNTS, intercept=0.030, per_iter=1e-7)
    est = fit_marginal_rate(COUNTS, times, ceiling=700_000.0, min_span_s=1e-9)
    assert not est.ok and "ceiling" in est.reason


def test_poor_fit_rejected_by_residual():
    times = [0.05, 0.30, 0.12]          # non-monotonic garbage
    est = fit_marginal_rate(COUNTS, times)
    assert not est.ok


def test_needs_three_distinct_counts():
    est = fit_marginal_rate((15, 60), (0.05, 0.12))
    assert not est.ok and "counts" in est.reason
    est = fit_marginal_rate((15, 15, 15), (0.05, 0.05, 0.05))
    assert not est.ok


def test_nonfinite_times_rejected():
    for bad in (float("nan"), float("inf"), 0.0, -1.0):
        est = fit_marginal_rate(COUNTS, [0.05, bad, 0.12])
        assert not est.ok


def test_measure_retries_then_succeeds():
    calls = {"n": 0}
    noisy = iter([[0.095, 0.093, 0.094], linear(COUNTS)])
    batches = []

    def timed(c):
        i = calls["n"] % 3
        if i == 0:
            batches.append(next(noisy))
        calls["n"] += 1
        return batches[-1][i]

    est = measure_marginal_rate(timed, COUNTS, attempts=3,
                                ceiling=700_000.0)
    assert est.ok
    assert est.rate == pytest.approx(1.0 / 0.00145, rel=1e-6)
    assert calls["n"] == 6                # one retry, not more


def test_measure_exhausts_attempts_and_reports_failure():
    calls = {"n": 0}

    def timed(c):
        calls["n"] += 1
        return 0.094                      # flat: never a valid slope

    est = measure_marginal_rate(timed, COUNTS, attempts=3)
    assert not est.ok and est.rate is None
    assert calls["n"] == 9


def test_average_fallback_is_bounded():
    assert average_rate_fallback(60, 0.5) == pytest.approx(120.0)
    assert average_rate_fallback(60, 0.5, ceiling=100.0) is None
    assert average_rate_fallback(60, float("nan")) is None
    assert average_rate_fallback(60, 0.0) is None


def test_to_json_roundtrips():
    est = fit_marginal_rate(COUNTS, linear(COUNTS))
    d = est.to_json()
    assert d["ok"] and isinstance(d["rate"], float)
    assert tuple(d["counts"]) == tuple(float(c) for c in COUNTS)
    assert isinstance(est, RateEstimate)
