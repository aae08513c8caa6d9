"""The port's ``obs/slo.py`` on the port's ``koordlet/metrics.py``
registry: the cases of the reference's ``tests/test_slo.py`` (the
estimator's edge cases — empty family, all mass in one bucket, all mass in
+Inf, a single observation, monotonicity across bucket boundaries — label
subset aggregation, verdicts and delta windows), and the port's estimates
and verdicts equal to the JAX package's on the same seeded observations."""

import math

import numpy as np
import pytest

from koordinator_tpu.koordlet.metrics import MetricsRegistry as RefRegistry
from koordinator_tpu.obs import slo as ref_slo

from koordinator_tpu_torch.koordlet.metrics import MetricsRegistry
from koordinator_tpu_torch.obs.slo import (
    SloSpec,
    SloWindow,
    aggregate_buckets,
    evaluate_slos,
    histogram_quantile,
    quantile_from_buckets,
    slos_pass,
)

BOUNDS = (1.0, 5.0, 10.0, 50.0, float("inf"))


def _registry(family="f", buckets=BOUNDS):
    reg = MetricsRegistry()
    reg.register(family, "histogram", "test family", buckets=buckets)
    return reg


class TestQuantileFromBuckets:
    def test_empty_series_is_none(self):
        assert quantile_from_buckets(BOUNDS, (0, 0, 0, 0, 0), 0.99) is None
        assert quantile_from_buckets((), (), 0.5) is None
        # ragged input never guesses
        assert quantile_from_buckets(BOUNDS, (1, 1), 0.5) is None

    def test_all_mass_in_one_bucket_interpolates_inside_it(self):
        # 10 observations, all in (5, 10]: every quantile lands inside
        # that bucket's bounds
        cum = (0, 0, 10, 10, 10)
        for q in (0.01, 0.5, 0.99, 1.0):
            est = quantile_from_buckets(BOUNDS, cum, q)
            assert 5.0 <= est <= 10.0
        assert quantile_from_buckets(BOUNDS, cum, 1.0) == pytest.approx(10.0)
        assert quantile_from_buckets(BOUNDS, cum, 0.5) == pytest.approx(7.5)

    def test_all_mass_in_inf_bucket_reports_last_finite_bound(self):
        # the estimator must never invent a number above what the
        # buckets can support (the Prometheus convention)
        cum = (0, 0, 0, 0, 7)
        assert quantile_from_buckets(BOUNDS, cum, 0.5) == 50.0
        assert quantile_from_buckets(BOUNDS, cum, 0.99) == 50.0
        # degenerate: a lone +Inf bucket has no finite bound to report
        assert quantile_from_buckets(
            (float("inf"),), (3,), 0.5
        ) is None

    def test_single_observation(self):
        cum = (0, 1, 1, 1, 1)  # one observation in (1, 5]
        for q in (0.01, 0.5, 0.99):
            est = quantile_from_buckets(BOUNDS, cum, q)
            assert 1.0 <= est <= 5.0
        assert quantile_from_buckets(BOUNDS, cum, 1.0) == pytest.approx(5.0)

    def test_monotone_across_bucket_boundaries(self):
        # mass spread over every bucket incl. +Inf: estimates must be
        # non-decreasing as q sweeps, with no discontinuity at any
        # bucket boundary crossing
        cum = (4, 9, 15, 23, 25)
        prev = 0.0
        for i in range(1, 101):
            est = quantile_from_buckets(BOUNDS, cum, i / 100.0)
            assert est is not None and est >= prev - 1e-12
            prev = est
        assert prev == 50.0  # the top 2 observations live in +Inf

    def test_first_bucket_interpolates_from_zero(self):
        cum = (10, 10, 10, 10, 10)
        assert quantile_from_buckets(BOUNDS, cum, 0.5) == pytest.approx(0.5)
        assert quantile_from_buckets(BOUNDS, cum, 1.0) == pytest.approx(1.0)

    def test_q_is_clamped(self):
        cum = (0, 10, 10, 10, 10)
        assert quantile_from_buckets(BOUNDS, cum, -1.0) is not None
        assert quantile_from_buckets(BOUNDS, cum, 2.0) == pytest.approx(5.0)


class TestRegistryQuantiles:
    def test_label_subset_aggregation(self):
        reg = _registry()
        for band in ("prod", "batch"):
            for v in (2.0, 3.0):
                reg.histogram_observe(
                    "f", v, {"band": band, "rpc": "cycle"}
                )
        reg.histogram_observe("f", 40.0, {"band": "prod", "rpc": "sync"})
        # full-family aggregate sees all 5 observations
        bounds, cum, count = aggregate_buckets(reg, "f")
        assert count == 5
        # band subset sums both rpc series of that band
        _, _, prod_count = aggregate_buckets(reg, "f", {"band": "prod"})
        assert prod_count == 3
        # one exact series
        _, _, one = aggregate_buckets(
            reg, "f", {"band": "prod", "rpc": "sync"}
        )
        assert one == 1
        q = histogram_quantile(reg, "f", 0.99, {"band": "batch"})
        assert 1.0 <= q <= 5.0
        # unknown family/labels: None, never a guess
        assert histogram_quantile(reg, "nope", 0.5) is None
        assert histogram_quantile(reg, "f", 0.5, {"band": "zzz"}) is None

    def test_histogram_series_read_seam(self):
        reg = _registry()
        reg.histogram_observe("f", 7.0, {"k": "v"})
        series = reg.histogram_series("f")
        assert len(series) == 1
        labels, bounds, cum, total, count = series[0]
        assert labels == {"k": "v"}
        assert math.isinf(bounds[-1])
        assert cum[-1] == count == 1
        assert total == 7.0
        # non-histogram families return nothing
        reg.counter_add("c", 1)
        assert reg.histogram_series("c") == []


class TestSloSpecs:
    def test_pass_fail_and_no_data(self):
        reg = _registry()
        for v in (2.0, 2.0, 3.0):
            reg.histogram_observe("f", v, {"rpc": "score"})
        ok_spec = SloSpec("score-p99", "f", 0.99, threshold_ms=100.0,
                          labels={"rpc": "score"})
        tight = SloSpec("score-tight", "f", 0.99, threshold_ms=0.5,
                        labels={"rpc": "score"})
        blind = SloSpec("assign-p99", "f", 0.99, threshold_ms=100.0,
                        labels={"rpc": "assign"})
        verdicts = evaluate_slos(reg, [ok_spec, tight, blind])
        by_name = {v.spec.name: v for v in verdicts}
        assert by_name["score-p99"].ok
        assert not by_name["score-tight"].ok
        assert "threshold" in by_name["score-tight"].reason
        # a gate that cannot see is a FAILED gate, never silently green
        assert not by_name["assign-p99"].ok
        assert "no data" in by_name["assign-p99"].reason
        assert not slos_pass(verdicts)
        assert slos_pass([by_name["score-p99"]])
        assert not slos_pass([])  # an empty spec set judges nothing

    def test_min_count_gates_thin_windows(self):
        reg = _registry()
        reg.histogram_observe("f", 1.0)
        spec = SloSpec("p99", "f", 0.99, threshold_ms=100.0, min_count=10)
        (v,) = evaluate_slos(reg, [spec])
        assert not v.ok and "no data" in v.reason

    def test_verdict_doc_shape(self):
        reg = _registry()
        reg.histogram_observe("f", 2.0)
        (v,) = evaluate_slos(
            reg, [SloSpec("p50", "f", 0.5, threshold_ms=9.0)]
        )
        doc = v.to_doc()
        assert doc["name"] == "p50" and doc["ok"] is True
        assert doc["quantile"] == 0.5 and doc["threshold_ms"] == 9.0
        assert isinstance(doc["observed_ms"], float)
        assert doc["count"] == 1

    def test_labels_mapping_normalized(self):
        a = SloSpec("x", "f", 0.5, 1.0, labels={"b": "2", "a": "1"})
        assert a.labels == (("a", "1"), ("b", "2"))
        assert a.labels_dict() == {"a": "1", "b": "2"}


class TestSloWindow:
    def test_windows_are_deltas_not_cumulative(self):
        reg = _registry()
        reg.histogram_observe("f", 2.0, {"rpc": "score"})
        reg.histogram_observe("f", 2.0, {"rpc": "score"})
        win = SloWindow(families=("f",))
        first = win.advance(reg)["f"]["rpc=score"]
        assert first["count"] == 2
        assert 1.0 <= first["p99"] <= 5.0
        # a quiet window: count 0, null quantiles — visible, not
        # invented from stale cumulative mass
        second = win.advance(reg)["f"]["rpc=score"]
        assert second["count"] == 0
        assert second["p50"] is None and second["p99"] is None
        # new observations land in the NEXT window only
        reg.histogram_observe("f", 40.0, {"rpc": "score"})
        third = win.advance(reg)["f"]["rpc=score"]
        assert third["count"] == 1
        assert 10.0 <= third["p99"] <= 50.0

    def test_empty_family_renders_nothing(self):
        reg = _registry()
        assert SloWindow(families=("f", "ghost")).advance(reg) == {}


def test_estimates_and_verdicts_equal_the_reference_s():
    rng = np.random.default_rng(12)
    regs = (_registry(), RefRegistry())
    regs[1].register("f", "histogram", "test family", buckets=BOUNDS)
    for _ in range(400):
        labels = {"band": str(rng.choice(["prod", "batch", "free"])),
                  "rpc": str(rng.choice(["sync", "score", "assign"]))}
        v = float(rng.exponential(8.0))
        for reg in regs:
            reg.histogram_observe("f", v, labels)
    subsets = ({}, {"band": "prod"}, {"rpc": "score"}, {"band": "free", "rpc": "sync"})
    for subset in subsets:
        assert aggregate_buckets(regs[0], "f", subset) == ref_slo.aggregate_buckets(
            regs[1], "f", subset)
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert histogram_quantile(regs[0], "f", q, subset) == ref_slo.histogram_quantile(
                regs[1], "f", q, subset)
    specs = [("p99", 0.99, 20.0, {"rpc": "score"}), ("p50", 0.5, 3.0, {}),
             ("thin", 0.99, 100.0, {"band": "zzz"})]
    got = evaluate_slos(regs[0], [SloSpec(n, "f", q, t, labels=lab) for n, q, t, lab in specs])
    want = ref_slo.evaluate_slos(
        regs[1], [ref_slo.SloSpec(n, "f", q, t, labels=lab) for n, q, t, lab in specs])
    assert [v.to_doc() for v in got] == [v.to_doc() for v in want]
    assert [v.reason for v in got] == [v.reason for v in want]
    win, ref_win = SloWindow(families=("f",)), ref_slo.SloWindow(families=("f",))
    assert win.advance(regs[0]) == ref_win.advance(regs[1])
