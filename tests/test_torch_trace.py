"""The port's trace replay (``koordinator_tpu_torch/harness/trace.py``) on
the CPU.

The generator is held byte for byte against the JAX package's (digest and
export lines, the card's configurations and ``harness/anchor.py``'s
constants included).  The port's own engine-against-oracle replay is pinned
on the reference test's ``TINY`` config, with the default mix and with the
fused-term mix: parity after every event, no build or demotion in the
measured pass, the histogram per band and RPC, the flight-dump schema, the
SLO gate, and the injected slow stage failing the gate while parity holds.
Then the two packages are driven with one trace, event by event, over gRPC
and over the raw framing, and their reply arrays are compared after every
event.  Every comparison is exact."""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

from koordinator_tpu.bridge.client import ScorerClient as RefClient
from koordinator_tpu.bridge.server import ScorerServicer as RefServicer
from koordinator_tpu.bridge.server import make_server as ref_make_server
from koordinator_tpu.bridge.udsserver import RawUdsServer as RefRawUdsServer
from koordinator_tpu.harness import trace as ref_trace
from koordinator_tpu.solver.terms import default_term_config as ref_term_config

from koordinator_tpu_torch.bridge.client import ScorerClient
from koordinator_tpu_torch.bridge.server import ScorerServicer, make_server
from koordinator_tpu_torch.bridge.udsserver import RawUdsServer
from koordinator_tpu_torch.harness import anchor
from koordinator_tpu_torch.harness.trace import (
    BANDS,
    INFRA_BAND,
    TERM_MIX,
    ClusterModel,
    TraceConfig,
    TraceReplay,
    default_slo_specs,
    export_trace,
    generate_trace,
    import_trace,
    tensor_sync_events,
)
from koordinator_tpu_torch.obs import validate_flight_dump
from koordinator_tpu_torch.obs.scorer_metrics import SYNC_TOTAL
from koordinator_tpu_torch.obs.slo import evaluate_slos, slos_pass
from koordinator_tpu_torch.solver.terms import default_term_config

# tests/test_trace.py's TINY: gangs, four bands, quotas, every kind drawn
TINY = dict(seed=7, nodes=8, pod_slots=48, tenants=2, gangs=4,
            gang_min_member=4, events=14)
TERM = dict(mix=TERM_MIX, accel_types=3, workload_classes=4)
HEADROOM = {"cpu": 98, "memory": 98}

GENERATOR_CASES = {
    "tiny-seed0": {**TINY, "seed": 0},
    "tiny-seed7": TINY,
    "tiny-seed8": {**TINY, "seed": 8},
    "terms": TERM,
    "tiny-terms": {**TINY, **TERM},
    "card-main": anchor.TRACE_ANCHOR_CFG,
    "card-headline": anchor.TRACE_HEADLINE_CFG,
    "card-terms": {**anchor.TRACE_TERMS_CFG, "mix": TERM_MIX},
}


def ref_config(doc):
    doc = dict(doc)
    if "mix" in doc:
        doc["mix"] = ref_trace.TERM_MIX
    return ref_trace.TraceConfig(**doc)


@pytest.mark.parametrize("name", sorted(GENERATOR_CASES))
def test_generator_matches_the_reference(name):
    doc = GENERATOR_CASES[name]
    got, want = generate_trace(TraceConfig(**doc)), ref_trace.generate_trace(ref_config(doc))
    assert got.digest() == want.digest()
    if len(got.events) <= 100:
        assert export_trace(got) == ref_trace.export_trace(want)


@pytest.mark.parametrize("cfg,digest", [
    (anchor.TRACE_ANCHOR_CFG, anchor.TRACE_ANCHOR_SHA256),
    (anchor.TRACE_HEADLINE_CFG, anchor.TRACE_HEADLINE_SHA256),
    ({**anchor.TRACE_TERMS_CFG, "mix": TERM_MIX}, anchor.TRACE_TERMS_SHA256),
], ids=["main", "headline", "terms"])
def test_chip_smoke_trace_digests_are_the_reference_s(cfg, digest):
    assert ref_trace.generate_trace(ref_config(cfg)).digest() == digest


def test_audit_lines_round_trip_and_malformed_streams_raise():
    trace = generate_trace(TraceConfig(**TINY))
    lines = export_trace(trace)
    assert len(lines) == 1 + len(trace.events)
    rebuilt = import_trace(lines)
    assert rebuilt.digest() == trace.digest() and rebuilt.config == trace.config
    assert import_trace([json.loads(line) for line in lines]).digest() == trace.digest()
    m1, m2 = ClusterModel(trace.init), ClusterModel(rebuilt.init)
    for e1, e2 in zip(trace.events, rebuilt.events):
        assert m1.apply(e1) == m2.apply(e2)
    np.testing.assert_array_equal(m1.preq, m2.preq)
    for bad, match in (
        (lines[1:], "trace_header"),
        ([lines[0], lines[0]], "duplicate"),
        ([lines[0], json.dumps({"event": "mystery"})], "unknown event"),
        ([lines[0], json.dumps(["not", "an", "object"])], "not a JSON object"),
    ):
        with pytest.raises(ValueError, match=match):
            import_trace(bad)
    for e in trace.events:
        assert e.band in BANDS + (INFRA_BAND,)


# -- the port's own replay, engine against the serial oracle --

def _engine_kw(mix):
    if mix == "default":
        return {}
    cfg = default_term_config(packing_headroom=HEADROOM)
    # the terms on the wave cycle, as the ``trace`` line's ``terms_wave``
    # replay drives K3 on the card
    return {"cfg": dataclasses.replace(cfg, wave=32, top_m=4) if mix == "terms_wave" else cfg}


@pytest.fixture(scope="module", params=["default", "terms", "terms_wave"])
def tiny_report(request):
    """One measured raw-transport replay per mix (the terms on the per-pod
    and on the wave cycle), shared by the read-only assertions."""
    doc = TINY if request.param == "default" else {**TINY, **TERM}
    trace = generate_trace(TraceConfig(**doc))
    report = TraceReplay(trace, engine_kw=_engine_kw(request.param), device="cpu",
                         transport="raw").run()
    return trace, report


def test_replay_parity_without_builds_or_demotions(tiny_report):
    trace, report = tiny_report
    assert report.events_replayed == len(trace.events)
    # one parity check per event plus the cold step
    assert report.parity_checks == len(trace.events) + 1
    assert report.retraces == 0 and report.builds == 0
    assert report.wall_ms > 0


def test_every_tensor_change_reaches_the_engine_as_a_tensor_sync(tiny_report):
    """The warm path really runs: each event that changes a tensor column
    commits a Sync carrying a tensor (the cold Sync is the one full one),
    and deltas among them reach ``apply_flat_delta``.  The cold step's
    host time is reported by RPC apart from the histogram."""
    trace, report = tiny_report
    kinds = {kind: int(report.registry.get(SYNC_TOTAL, {"kind": kind}) or 0)
             for kind in ("full", "delta", "mixed", "scalar")}
    assert sum(kinds.values()) == 1 + len(trace.events)
    assert kinds["full"] + kinds["delta"] + kinds["mixed"] == 1 + tensor_sync_events(trace)
    assert kinds["delta"] + kinds["mixed"] > 0
    assert sorted(report.cold_ms) == ["assign", "score", "sync"]
    assert all(ms > 0 for ms in report.cold_ms.values())


def test_histogram_populates_per_band_and_rpc(tiny_report):
    trace, report = tiny_report
    for band in trace.bands():
        assert report.quantile(0.99, band=band) is not None, band
    for rpc in ("sync", "score", "assign", "cycle"):
        assert report.quantile(0.99, rpc=rpc) is not None, rpc


def test_timeline_is_flight_dump_schema_valid(tiny_report):
    trace, report = tiny_report
    doc = report.timeline_document()
    assert validate_flight_dump(doc) == []
    assert len(doc["cycles"]) == len(trace.events)
    for cyc in doc["cycles"]:
        assert cyc["notes"]["parity"] == "ok" and cyc["notes"]["event"]
        assert {s["name"] for s in cyc["spans"]} == {"sync", "score", "assign"}


def test_slo_gate_passes_on_clean_replay(tiny_report):
    trace, report = tiny_report
    specs = default_slo_specs(trace.bands(), cycle_p99_ms=60_000, rpc_p99_ms=60_000)
    verdicts = evaluate_slos(report.registry, specs)
    assert slos_pass(verdicts), [(v.spec.name, v.reason) for v in verdicts if not v.ok]


def test_injected_slow_stage_fails_the_gate_its_clean_twin_passes():
    """As the reference's: the thresholds come from the clean replay's own
    p99 plus half the injected delay, so the slow replay fails because of
    the injection, while its parity holds.  Each RPC's spec takes its own
    clean p99: on the CPU the port's Assign (the plain cycle) is slower
    than its Score, which the reference's one shared threshold assumes.
    The delay is 250 ms, not the reference's 60: the plain cycle's
    run-to-run noise on a loaded host reaches tens of ms."""
    trace = generate_trace(TraceConfig(**{**TINY, "events": 8}))
    clean = TraceReplay(trace, device="cpu", transport="raw").run()
    slow = TraceReplay(trace, device="cpu", transport="raw", slow_score_ms=250.0).run()
    assert slow.parity_checks == len(trace.events) + 1
    margin = 125.0
    specs = [
        dataclasses.replace(
            spec, threshold_ms=clean.quantile(0.99, rpc=spec.labels_dict()["rpc"]) + margin)
        if "band" not in spec.labels_dict() else spec
        for spec in default_slo_specs(trace.bands(), cycle_p99_ms=clean.quantile(0.99) + margin)
    ]
    clean_verdicts = evaluate_slos(clean.registry, specs)
    assert slos_pass(clean_verdicts), [(v.spec.name, v.reason) for v in clean_verdicts if not v.ok]
    slow_verdicts = evaluate_slos(slow.registry, specs)
    assert not slos_pass(slow_verdicts)
    failed = {v.spec.name for v in slow_verdicts if not v.ok}
    assert "score-p99" in failed
    assert any(name.endswith("-cycle-p99") for name in failed)


def test_replay_refuses_an_unknown_transport():
    with pytest.raises(ValueError, match="transport"):
        TraceReplay(generate_trace(TraceConfig(**TINY)), device="cpu", transport="http")


# -- both packages on one trace --

def _serve(kind, servicer, path):
    """Start ``servicer`` on ``path``: (client target, stop)."""
    if kind == "raw":
        cls = RawUdsServer if isinstance(servicer, ScorerServicer) else RefRawUdsServer
        server = cls(path, servicer=servicer).start()
        return f"raw://{path}", server.stop
    build = make_server if isinstance(servicer, ScorerServicer) else ref_make_server
    server = build(servicer=servicer)
    server.add_insecure_port(f"unix://{path}")
    server.start()
    return f"unix://{path}", lambda: server.stop(0)


@pytest.mark.parametrize("mix", ["default", "terms"])
@pytest.mark.parametrize("transport", ["grpc", "raw"])
def test_port_replies_equal_the_reference_after_every_event(transport, mix):
    """The reference's servicer and the port's (``device="cpu"``), each the
    full engine behind its own transport: over gRPC each with its own
    package's client, over the raw framing the reference's
    ``RawUdsServer`` and the port's, both driven by the port's raw client.
    The flat Score arrays and the Assign assignment and status are equal
    after every event (the reply ``path`` is each package's own label)."""
    doc = TINY if mix == "default" else {**TINY, **TERM}
    trace = generate_trace(TraceConfig(**doc))
    ref_kw = {} if mix == "default" else {"cfg": ref_term_config(packing_headroom=HEADROOM)}
    model = ClusterModel(trace.init)
    k = trace.config.top_k
    with tempfile.TemporaryDirectory() as tmp:
        port_sv = ScorerServicer(device="cpu", trace_export=False, **_engine_kw(mix))
        ref_sv = RefServicer(trace_export=False, **ref_kw)
        stops, clients = [], []
        try:
            for name, sv in (("port", port_sv), ("ref", ref_sv)):
                target, stop = _serve(transport, sv, os.path.join(tmp, f"{name}.sock"))
                stops.append(stop)
                ref_client = transport == "grpc" and name == "ref"
                clients.append((RefClient if ref_client else ScorerClient)(
                    target, trace_export=False))
            full = dict(
                node_allocatable=model.nalloc, node_requested=model.nreq,
                node_usage=model.nuse, metric_fresh=list(model.fresh),
                pod_requests=model.preq, pod_estimated=model.pest,
                priority=list(model.priority), gang_id=list(model.gang_id),
                quota_id=list(model.quota_id), gang_min_member=list(model.gang_min),
                quota_runtime=model.qrt, quota_used=model.quse, quota_limited=model.qlim,
            )
            if model.tput is not None:
                full.update(node_accel_type=list(model.accel),
                            workload_class=list(model.wclass),
                            pod_sensitivity=model.sens, throughput=model.tput)
            steps = [("cold", full)]
            for i, event in enumerate(trace.events):
                steps.append((f"step {i} ({event.kind})", None))
            event_iter = iter(trace.events)
            for label, kw in steps:
                if kw is None:
                    kw = TraceReplay._sync_kwargs(model, model.apply(next(event_iter)))
                replies = []
                for client in clients:
                    # copies: the reference's client keeps the arrays it is
                    # given as its acked baseline, so an array the model
                    # later mutates in place would turn its deltas empty
                    client.sync(**{key: v.copy() if isinstance(v, np.ndarray) else v
                                   for key, v in kw.items()})
                    flat = client.score_flat(top_k=k)
                    assignment, status, _ms, _path = client.assign()
                    replies.append((flat, assignment, status))
                (p_flat, p_a, p_s), (r_flat, r_a, r_s) = replies
                for got, want in zip(p_flat, r_flat):
                    np.testing.assert_array_equal(got, want, err_msg=label)
                    assert got.dtype == want.dtype, label
                np.testing.assert_array_equal(p_a, r_a, err_msg=label)
                np.testing.assert_array_equal(p_s, r_s, err_msg=label)
        finally:
            for client in clients:
                client.close()
            for stop in stops:
                stop()
            port_sv.telemetry.close()
            ref_sv.telemetry.close()
