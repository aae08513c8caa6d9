"""The ``run_pod_share`` reader (``metrics/run_pod_share.py``) on a
synthetic launch ledger: the window's ``run_pods`` over its pending pods,
and None where the program has no such counter (a parent without the run
path) or no pending pod; and its entry in ``BENCHMARK.json``."""

import pytest

from kbench import manifest

NAMES = ("placed", "unschedulable", "wait_gang", "run_pods")


def _row(total, n=20):
    return {"launches": n, "sampled": n, "device_us_total": float(total), "kind": "counter"}


def _run(counts):
    devprof = {"server.assign.finish": {"launches": 20, "sampled": 20,
                                        "device_us_total": 9000.0, "kind": "stage"}}
    devprof.update({f"server.assign.count.{name}": _row(v) for name, v in counts.items()})
    return {"devprof": devprof, "counts": {"scores": 20, "assigns": 20}}


def test_the_share_is_the_windows_run_pods_over_its_pending_pods():
    read = manifest.reader("run_pod_share")
    counts = {"placed": 150000, "unschedulable": 40000, "wait_gang": 10000, "run_pods": 199980}
    assert read(_run(counts)) == pytest.approx(99.99)
    assert read(_run(dict(counts, run_pods=0))) == 0.0


@pytest.mark.parametrize("missing", NAMES)
def test_none_without_a_counter(missing):
    read = manifest.reader("run_pod_share")
    counts = {name: 100 for name in NAMES}
    del counts[missing]
    assert read(_run(counts)) is None


def test_none_without_pending_pods_or_a_ledger():
    read = manifest.reader("run_pod_share")
    assert read(_run({name: 0 for name in NAMES})) is None
    assert read({"devprof": {}, "counts": {}}) is None


def test_the_metric_is_declared_for_the_per_pod_cells():
    entry = next(m for m in manifest.load_manifest()["per_layer"] if m["name"] == "run_pod_share")
    assert entry == {"name": "run_pod_share", "unit": "%", "better": "higher",
                     "source": "program_span", "layer": "Assign path", "moves": "steps_per_s",
                     "workloads": ["basic5k.bind", "coloc4k.bind"]}
