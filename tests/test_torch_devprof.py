"""The port's launch ledger (``koordinator_tpu_torch/obs/devprof.py``) and
warm-path guard (``analysis/retrace_guard.py``) on the CPU: registration,
``sample=0`` bit-inert (the same replies, no notes, no metric series),
``sample=1`` notes and ``koord_scorer_devprof_*`` series, only the
outermost boundary measured, a failing capture never failing its launch,
kernel builds recorded as build truth and counted by the guard, the span
attributes of a traced replay, the report CLI, and the profiler window."""

import json
import os
import time

import numpy as np
import pytest

from koordinator_tpu_torch import _build, solver
from koordinator_tpu_torch.analysis.retrace_guard import (
    RetraceBudgetExceeded,
    retrace_guard,
)
from koordinator_tpu_torch.bridge.server import ScorerServicer
from koordinator_tpu_torch.bridge.state import numpy_to_tensor
from koordinator_tpu_torch.config import CycleConfig
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.harness.trace import TraceConfig, TraceReplay, generate_trace
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.obs.assemble import assemble
from koordinator_tpu_torch.obs.scorer_metrics import (
    DEVPROF_COMPILE_MS,
    DEVPROF_COMPILES,
    DEVPROF_DEVICE_US,
    DEVPROF_RETRACE,
)
from koordinator_tpu_torch.solver import candidates, resident  # noqa: F401  (registers)
from koordinator_tpu_torch.bridge import wire

BOUNDARIES = (
    "parallel.shard_assign._assign_sharded",
    "parallel.shard_assign._assign_waves",
    "parallel.shard_assign._cycle_operands",
    "solver.candidates._build",
    "solver.candidates._build_sharded",
    "solver.candidates._count_blocks",
    "solver.candidates._count_blocks_sharded",
    "solver.candidates._refresh",
    "solver.candidates._refresh_sharded",
    "solver.candidates._score_sharded",
    "solver.candidates.score_candidates",
    "solver.dense.cycle_dense_cuda",
    "solver.greedy.score_cycle",
    "solver.greedy.score_cycle_sharded",
    "solver.incremental._rescore_sharded",
    "solver.incremental.rescore_dirty",
    "solver.resident._scatter_flat_sharded",
    "solver.resident.apply_flat_delta",
    "solver.terms.term_extras",
    "solver.topk.masked_top_k",
    "solver.wide.cycle_wide_cuda",
    "solver.wide.wave_cycle_cuda",
)


@pytest.fixture(autouse=True)
def fresh_ledger():
    devprof.reset()
    yield
    devprof.reset()


def _rpcs(sample, tmp_path=None):
    """Sync, Score (k = 3, flat), Assign, a warm delta Sync and a second
    Score on a CPU servicer built with ``devprof_sample=sample``: the
    replies' bytes, and the servicer."""
    nodes, pods, gangs, quotas = generators.quota_colocation(pods=24, nodes=6)
    req, _ = build_sync_request(nodes, pods, gangs, quotas)
    sv = ScorerServicer(device="cpu", trace_export=False, devprof_sample=sample,
                        state_dir=None if tmp_path is None else str(tmp_path))
    sv._epoch = sv.telemetry.spans.epoch = "devprof0"
    out = []
    sync = sv.sync(req)
    out.append(sync.SerializeToString())
    score = sv.score(wire.ScoreRequest(snapshot_id=sync.snapshot_id, top_k=3, flat=True))
    score.build_ms = 0.0
    out.append(score.SerializeToString())
    assign = sv.assign(wire.AssignRequest(snapshot_id=sync.snapshot_id, cycle_id="c1"))
    assign.cycle_ms = 0.0
    out.append(assign.SerializeToString())
    usage = np.frombuffer(req.nodes.usage.data, "<i8").reshape(tuple(req.nodes.usage.shape))
    moved = usage.copy()
    moved[0, 0] += 100
    delta = wire.SyncRequest()
    delta.nodes.usage.CopyFrom(numpy_to_tensor(moved, usage))
    assert delta.nodes.usage.delta_idx
    sync2 = sv.sync(delta)
    score2 = sv.score(wire.ScoreRequest(snapshot_id=sync2.snapshot_id, top_k=3, flat=True))
    score2.build_ms = 0.0
    out += [sync2.SerializeToString(), score2.SerializeToString()]
    sv.telemetry.close()
    return out, sv


def _series(registry, family):
    return [labels for labels, *_ in registry.histogram_series(family)]


def test_every_serving_boundary_is_registered():
    from koordinator_tpu_torch.parallel import shard_assign
    from koordinator_tpu_torch.solver import dense, greedy, incremental, terms, topk, wide

    assert set(BOUNDARIES) <= set(devprof.boundaries())
    modules = {"candidates": candidates, "dense": dense, "greedy": greedy,
               "incremental": incremental, "resident": resident, "terms": terms,
               "topk": topk, "wide": wide, "shard_assign": shard_assign}
    for name in BOUNDARIES:
        _, module, fn_name = name.split(".")
        fn = getattr(modules[module], fn_name)
        assert fn.devprof_boundary == name and fn.__wrapped__.__name__ == fn_name


def test_chip_smoke_maps_every_boundary_to_an_rpc():
    """The card's ledger pass splits the sampled spans by RPC through
    ``chip_smoke.py BOUNDARY_RPC``, which has no default: every registered
    boundary is listed, each under one RPC."""
    import importlib.util
    import pathlib

    from koordinator_tpu_torch import parallel  # noqa: F401
    from koordinator_tpu_torch.solver import dense, greedy, incremental, terms, topk, wide  # noqa: F401

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    port = {name for name in devprof.boundaries() if not name.startswith("test.")}
    assert set(chip_smoke.BOUNDARY_RPC) == port == set(BOUNDARIES)
    assert set(chip_smoke.BOUNDARY_RPC.values()) == {"sync", "score", "assign"}


def test_sample_zero_is_bit_inert():
    assert not devprof.enabled()
    off, sv_off = _rpcs(0)
    assert devprof.drain_notes() == []
    assert _series(sv_off.telemetry.registry, DEVPROF_DEVICE_US) == []
    assert sv_off.telemetry.registry.get(DEVPROF_COMPILES, {}) is None
    on, sv_on = _rpcs(1)
    # the ledger changes no byte of any reply
    assert on == off
    devprof.configure(sample=0)
    again, _ = _rpcs(0)
    assert again == off


def test_sample_one_records_notes_and_series(tmp_path):
    _, sv = _rpcs(1, tmp_path)
    summary = devprof.summary()
    b = summary["boundaries"]
    for name in ("solver.greedy.score_cycle", "solver.topk.masked_top_k",
                 "solver.terms.term_extras", "solver.resident.apply_flat_delta"):
        assert b[name]["launches"] >= 1 and b[name]["sampled"] == b[name]["launches"], name
        assert b[name]["device_us_total"] > 0 and b[name]["device_us_p99"] >= b[name]["device_us_p50"]
    assert summary["backend"] == "cpu"
    labels = _series(sv.telemetry.registry, DEVPROF_DEVICE_US)
    assert {"boundary": "solver.greedy.score_cycle"} in labels
    assert {"boundary": "solver.topk.masked_top_k"} in labels
    # every note was drained onto a span or discarded by the servicer
    assert devprof.drain_notes() == []
    # builds flush the ledger at once, samples every 32: dump the rest
    assert devprof.dump() == str(tmp_path / devprof.LEDGER_FILENAME)


def test_one_in_n_sampling():
    devprof.configure(sample=3)
    snap = generators.quota_colocation_snapshot(pods=24, nodes=6, device="cpu")[0]
    for _ in range(6):
        solver.score_cycle(snap, CycleConfig())
    st = devprof.summary()["boundaries"]["solver.greedy.score_cycle"]
    assert st["launches"] == 6 and st["sampled"] == 2
    notes = devprof.drain_notes()
    assert len(notes) == 2 and all(n["backend"] == "cpu" for n in notes)


@devprof.boundary("test.devprof.inner")
def _inner(x):
    return x + 1


@devprof.boundary("test.devprof.outer")
def _outer(x):
    return _inner(x) * 2


def test_only_the_outermost_boundary_is_measured():
    devprof.configure(sample=1)
    assert _outer(3) == 8
    b = devprof.summary()["boundaries"]
    assert b["test.devprof.outer"]["launches"] == 1
    assert b["test.devprof.inner"]["launches"] == 0
    assert [n["boundary"] for n in devprof.drain_notes()] == ["test.devprof.outer"]
    # the candidate build calls masked_top_k inside its own boundary
    snap = generators.quota_colocation_snapshot(pods=16, nodes=8, device="cpu")[0]
    solver.build_candidates(snap, CycleConfig(candidate_width=8))
    b = devprof.summary()["boundaries"]
    assert b["solver.topk.masked_top_k"]["launches"] == 0
    # and called alone it is outermost
    assert _inner(1) == 2
    assert devprof.summary()["boundaries"]["test.devprof.inner"]["launches"] == 1


def test_a_failing_capture_never_fails_the_launch(monkeypatch):
    devprof.configure(sample=1)

    def broken(*a, **k):
        raise RuntimeError("ledger broken")

    monkeypatch.setattr(devprof.LaunchLedger, "record_device_time", broken)
    assert _outer(3) == 8
    monkeypatch.setattr(devprof, "_Timer", broken)
    assert _outer(4) == 10
    monkeypatch.setattr(devprof.LaunchLedger, "note_launch", broken)
    assert _outer(5) == 12
    # the wrapped function's own error still surfaces
    with pytest.raises(TypeError):
        _outer("x")


@devprof.boundary("test.devprof.builds")
def _builds(n, seconds):
    """Stands in for a kernel wrapper whose launch builds ``n`` kernels:
    reports them to the build listeners as ``_build.build`` does."""
    for i in range(n):
        for cb in list(_build._BUILD_LISTENERS):
            cb(f"solver/k{i}.cu", ("VARIANT",), seconds)
    return n


def test_builds_are_build_truth_and_a_second_is_a_rebuild():
    metrics_sv = ScorerServicer(device="cpu", trace_export=False, devprof_sample=1)
    reg = metrics_sv.telemetry.registry
    assert _builds(1, 1.5) == 1
    (note,) = devprof.drain_notes()
    assert note["compiled"] and note["build_ms"] == 1500.0 and note["device_us"] is None
    (entry,) = devprof.summary()["entries"]
    assert entry["boundary"] == "test.devprof.builds" and entry["backend"] == "cuda"
    assert entry["compile_ms"] == 1500.0 and entry["source"] == "solver/k0.cu -DVARIANT"
    assert entry["flops"] is None
    labels = {"boundary": "test.devprof.builds", "backend": "cuda"}
    assert reg.get(DEVPROF_COMPILES, labels) == 1.0
    assert reg.get(DEVPROF_COMPILE_MS, labels) == 1500.0
    assert reg.get(DEVPROF_RETRACE, {"boundary": "test.devprof.builds"}) is None
    _builds(1, 0.0)  # a load of a library built before, after warm-up
    assert reg.get(DEVPROF_RETRACE, {"boundary": "test.devprof.builds"}) == 1.0
    assert len(devprof.summary()["retraces"]) == 1
    assert devprof.health_block()["compiles"] == 2
    metrics_sv.telemetry.close()


def test_retrace_guard_counts_builds_and_demotions():
    with retrace_guard(budget=0) as counter:
        pass
    assert (counter.traces, counter.compiles) == (0, 0)
    with pytest.raises(RetraceBudgetExceeded, match="1 kernel build"):
        with retrace_guard(budget=0):
            _builds(1, 0.1)
    bucket = ("test-devprof", 1, 2, False, 1, 1)
    try:
        with pytest.raises(RetraceBudgetExceeded, match="1 kernel demotion"):
            with retrace_guard(budget=0):
                solver._record_failure(bucket)
        with retrace_guard(budget=2) as counter:
            solver._record_failure(bucket)
            _builds(1, 0.1)
        assert (counter.traces, counter.compiles) == (1, 1)
    finally:
        solver._record_success(bucket)
    # the listeners are gone after the block
    n = len(_build._BUILD_LISTENERS)
    with retrace_guard(budget=5):
        assert len(_build._BUILD_LISTENERS) == n + 1
    assert len(_build._BUILD_LISTENERS) == n


def test_traced_replay_carries_device_time_on_its_spans(tmp_path):
    export = str(tmp_path / "spans")
    trace = generate_trace(TraceConfig(seed=7, nodes=8, pod_slots=48, tenants=2, gangs=4,
                                       gang_min_member=4, events=4))
    report = TraceReplay(trace, engine_kw={"devprof_sample": 1}, warmup=False,
                         oracle=False, trace_export=export, device="cpu",
                         transport="raw").run()
    assert report.events_replayed == 4
    assembly = assemble([export])
    assert len(assembly.traces) == 3 * 5 and not assembly.incomplete
    dev = {s["name"] for s in assembly.spans_by_id.values()
           if (s.get("attributes") or {}).get("device_us") is not None}
    assert {"assign", "score_launch"} <= dev
    b = devprof.summary()["boundaries"]
    assert b["solver.greedy.score_cycle"]["sampled"] >= 1


def test_report_cli_formats_a_dump(tmp_path, capsys):
    devprof.configure(sample=1)
    _outer(1)
    _builds(1, 0.25)
    assert devprof.dump(str(tmp_path)) == str(tmp_path / devprof.LEDGER_FILENAME)
    doc = json.loads((tmp_path / devprof.LEDGER_FILENAME).read_text())
    assert doc["boundaries"]["test.devprof.outer"]["sampled"] == 1
    assert devprof.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "devprof ledger — backend=cpu sample=1" in out
    assert "test.devprof.outer" in out and "solver/k0.cu -DVARIANT" in out
    assert devprof.main([str(tmp_path / "missing")]) == 2
    assert "no ledger" in capsys.readouterr().err


def test_profile_capture_returns_its_directory_and_writes_the_trace(tmp_path):
    out_dir = devprof.capture_profile(str(tmp_path), window_ms=50)
    assert os.path.isdir(out_dir) and out_dir.startswith(str(tmp_path))
    path = os.path.join(out_dir, devprof.PROFILE_TRACE)
    deadline = time.monotonic() + 60
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    doc = json.loads(open(path).read())
    assert "traceEvents" in doc
