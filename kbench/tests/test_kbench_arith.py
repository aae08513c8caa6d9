"""The benchmark's arithmetic and the shape of a run's result."""

import json
import statistics

import pytest

from kbench import devtrace, run, stats
from kbench.roofline import cycle_bound_ms


def test_percentile_interpolates_between_ranks():
    values = list(range(1, 101))
    assert stats.percentile(values, 0.95) == pytest.approx(95.05)
    assert stats.percentile([4.0], 0.95) == 4.0
    assert stats.percentile([], 0.95) is None
    assert stats.percentile([3, 1, 2], 0.5) == 2


def test_rate_and_mean():
    assert stats.rate(300, 30.0) == 10.0
    assert stats.rate(3, 0.0) is None
    assert stats.mean([1.0, 2.0, 6.0]) == 3.0


def test_spread_is_the_interquartile_share_of_the_median():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / statistics.median(values))


def test_trace_digest_busy_idle_and_labels():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "kbench.sync", "ts": 0, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "kbench.assign", "ts": 400, "dur": 600},
        {"ph": "X", "cat": "kernel", "name": "cycle_kernel<int>(x)", "ts": 500, "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 700, "dur": 200},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 100, "dur": 50},
    ]}
    dig = devtrace.digest(doc)
    assert dig["window_s"] == pytest.approx(1e-3)
    assert dig["busy_s"] == pytest.approx(450e-6)
    assert dig["idle_by_host"]["kbench.sync"] == pytest.approx(450e-6)
    assert dig["idle_by_host"]["kbench.assign"] == pytest.approx(100e-6)
    assert devtrace.kernel_mean_ms(dig, lambda n: "cycle_kernel<int>" in n) == (1, pytest.approx(0.3))
    br = devtrace.breakdown(dig)
    assert br["device_ops"][0][0] == "cycle_kernel<int>(x)"
    assert len(br["device_ops"]) <= 10 and len(br["idle_gaps"]) <= 10


def test_roofline_bound_counts_operations_at_the_cell_size():
    from kbench import manifest, roofline
    from kbench.gen.cluster import build
    from kbench.reference.cycle import Semantics

    cell = manifest.load_cell("basic5k.bind")
    state = roofline.cycle_state(build(cell.config, 1), Semantics(cell.traffic["cycle"]))
    assert state == {"pods": 10000, "nodes": 5000, "quotas": 0, "requested": 3 * 10000,
                     "extras": False, "fit_weighted": 2, "la_weighted": 2}
    # 10k x 5k cells of 2*3 + 12 + 14 + 4 operations over 67 T/s
    assert cycle_bound_ms(state) == pytest.approx(10000 * 5000 * 36 / 67e12 * 1e3)


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys_and_checks_last(tiny_cell, monkeypatch, traced):
    monkeypatch.setattr(run, "TRACE_WINDOW_S", 0.5)
    cell = tiny_cell("basic5k.bind", nodes=16, pending=64, check_steps=3, warmup_steps=4,
                     running_band=0.5)
    result = run.run(cell, seed=5, seconds=1.5, traced=traced, device="cpu")
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True
    # on the CPU no kernel runs and nothing is rescored on a device
    want = ({m["name"] for m in cell.per_layer} - {"k2_ms", "k2_roofline", "device_idle_share",
                                                   "rescore_device_ms"}
            if traced else {"steps_per_s", "step_p95_ms", "setup_s"})
    assert want <= set(result["metrics"])
    json.dumps(result)
    for check in result["checks"].values():
        assert {"value", "op", "limit"} == set(check)


def test_sample_keeps_the_last_step_and_draws_the_rest_from_the_seed():
    def draw(seed, n, want=4):
        s = run.Sample(want, seed)
        for i in range(n):
            s.offer(i, i * 10)
        return s.steps()

    got = draw(7, 500)
    assert len(got) == 4 and 499 in got and all(v == k * 10 for k, v in got.items())
    assert draw(7, 500) == got
    assert draw(8, 500) != got
    assert sorted(draw(7, 2)) == [0, 1]
    # every step is equally likely to be compared
    hits = [0] * 10
    for seed in range(3000):
        for k in draw(seed, 11, want=3):
            if k < 10:
                hits[k] += 1
    assert max(hits) / min(hits) < 1.25
