"""The readers of the per-layer metrics that read the program's stage rows
(``frame_ms``, ``score_reply_ms``, ``score_device_ms``, ``assign_host_ms``)
on synthetic ``run`` documents: None with a row missing or unsampled, the
right ms with the rows present."""

import pytest

from kbench import manifest

METRICS = ("frame_ms", "score_reply_ms", "score_device_ms", "assign_host_ms")
FRAME_ROWS = [f"server.{rpc}.{stage}" for rpc in ("sync", "score", "assign")
              for stage in ("recv", "decode", "encode", "send")]
ROWS = {
    "frame_ms": FRAME_ROWS,
    "score_reply_ms": ["server.score.reply_build"],
    "score_device_ms": ["server.score.device"],
    "assign_host_ms": ["server.assign.prepare", "server.assign.finish",
                       "server.assign.reply_build"],
}


def _row(us, n=20):
    return {"launches": n, "sampled": n, "device_us_total": us}


def _run(rows, steps=20):
    # launch rows and stage rows the metric does not read sit beside them
    devprof = {"solver.incremental.rescore_dirty": _row(1.9e6),
               "server.score.handler": _row(2.3e6),
               "server.assign.kernel_wait": _row(1.2e6)}
    devprof.update(rows)
    return {"devprof": devprof, "counts": {"scores": steps, "assigns": steps}}


def _full(metric, us=4000.0):
    return {name: _row(us) for name in ROWS[metric]}


@pytest.mark.parametrize("metric", METRICS)
def test_each_stage_metric_is_declared_with_its_reader(metric):
    entry = next(m for m in manifest.load_manifest()["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span" and entry["moves"] == "steps_per_s"
    assert entry["workloads"] == ["basic5k.bind", "basic5k.bind_wave"]
    assert callable(manifest.reader(metric))


@pytest.mark.parametrize("metric", METRICS)
def test_a_missing_row_reads_none(metric):
    read = manifest.reader(metric)
    assert read(_run({})) is None
    for name in ROWS[metric]:
        rows = _full(metric)
        del rows[name]
        assert read(_run(rows)) is None, name


@pytest.mark.parametrize("metric", METRICS)
def test_an_unsampled_row_reads_none(metric):
    read = manifest.reader(metric)
    for name in ROWS[metric]:
        rows = _full(metric)
        rows[name] = {"launches": 0, "sampled": 0, "device_us_total": 0.0}
        assert read(_run(rows)) is None, name
    assert read(_run(_full(metric), steps=0)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_the_rows_read_as_ms_a_step(metric):
    read = manifest.reader(metric)
    # each row 4,000 us over 20 steps: 0.2 ms a row a step
    assert read(_run(_full(metric))) == pytest.approx(0.2 * len(ROWS[metric]))
    rows = _full(metric)
    first = ROWS[metric][0]
    rows[first] = _row(14000.0)
    assert read(_run(rows)) == pytest.approx(0.2 * (len(ROWS[metric]) - 1) + 0.7)


def test_frame_ms_sums_the_framing_of_all_three_rpcs():
    read = manifest.reader("frame_ms")
    rows = {name: _row(1000.0 * (i + 1)) for i, name in enumerate(FRAME_ROWS)}
    # 1 + 2 + ... + 12 thousand us over 10 Scores
    assert read(_run(rows, steps=10)) == pytest.approx(78 * 1000.0 / 1e3 / 10)
