"""The serving path's stage spans on the CPU (``obs/spans.py``,
``obs/devprof.py``): the rows ``server.<rpc>.<stage>`` a Sync → Score →
Assign over a real ``RawUdsServer`` gives with the launch ledger on, none
with it off, a launch boundary inside a stage still measured, one clock
for every span (Unix-epoch stamps from one anchor, measured starts kept),
and the Profile capture's host tracks."""

import json
import os
import socket
import struct
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.server import ScorerServicer
from koordinator_tpu_torch.bridge.state import numpy_to_tensor
from koordinator_tpu_torch.bridge.udsserver import (
    METHOD_ASSIGN,
    METHOD_SCORE,
    METHOD_SYNC,
    RawUdsServer,
)
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.obs import devprof, spans
from koordinator_tpu_torch.obs.spans import SpanRecorder, TraceSpan

FRAME = ("recv", "decode", "handler", "encode", "send")
# every host stage row a Sync -> Score -> Assign gives on the CPU; the wait
# on the kernel (``kernel_wait``) needs a card
ROWS = {
    "sync": FRAME + ("stage", "wait", "commit"),
    "score": FRAME + ("wait", "dispatch", "readback", "reply_build"),
    "assign": FRAME + ("wait", "prepare", "kernel", "finish", "readback", "reply_build"),
}
# the launch sections' spans on their device: the CPU's host wall here
DEVICE = ("server.score.device", "server.assign.device")


@pytest.fixture(autouse=True)
def fresh_ledger():
    devprof.reset()
    yield
    devprof.reset()


def _recv(conn, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        assert chunk, "the server closed the connection"
        buf.extend(chunk)
    return bytes(buf)


def _call(conn, method, req, reply_cls):
    payload = req.SerializeToString()
    conn.sendall(struct.pack(">BI", method, len(payload)) + payload)
    status, n = struct.unpack(">BI", _recv(conn, 5))
    body = _recv(conn, n)
    assert status == 0, body.decode()
    return reply_cls.FromString(body)


def _steps(sample, during=None):
    """A Sync, a flat Score and an Assign, then a warm delta Sync (one
    node's usage moved) and a second Score, over the raw framing to a CPU
    servicer made with ``devprof_sample=sample``.  ``during(server)`` runs
    after the server starts and before the first frame.  Returns the
    ledger's summary rows."""
    nodes, pods, gangs, quotas = generators.quota_colocation(pods=24, nodes=6)
    req, _ = build_sync_request(nodes, pods, gangs, quotas)
    sv = ScorerServicer(device="cpu", trace_export=False, devprof_sample=sample)
    with tempfile.TemporaryDirectory(prefix="kst-") as d:
        server = RawUdsServer(os.path.join(d, "s.sock"), servicer=sv).start()
        try:
            if during is not None:
                during(server)
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
                conn.connect(server.path)
                sync = _call(conn, METHOD_SYNC, req, wire.SyncReply)
                _call(conn, METHOD_SCORE, wire.ScoreRequest(
                    snapshot_id=sync.snapshot_id, top_k=3, flat=True), wire.ScoreReply)
                _call(conn, METHOD_ASSIGN, wire.AssignRequest(
                    snapshot_id=sync.snapshot_id), wire.AssignReply)
                usage = np.frombuffer(req.nodes.usage.data, "<i8").reshape(
                    tuple(req.nodes.usage.shape))
                moved = usage.copy()
                moved[0, 0] += 100
                delta = wire.SyncRequest()
                delta.nodes.usage.CopyFrom(numpy_to_tensor(moved, usage))
                sync2 = _call(conn, METHOD_SYNC, delta, wire.SyncReply)
                _call(conn, METHOD_SCORE, wire.ScoreRequest(
                    snapshot_id=sync2.snapshot_id, top_k=3, flat=True), wire.ScoreReply)
        finally:
            server.stop()
            sv.telemetry.close()
    return devprof.summary()["boundaries"]


def _stage_rows(rows):
    return {n: r for n, r in rows.items() if r.get("kind") == "stage"}


def test_the_ledger_on_gives_every_stage_row_of_each_rpc():
    stages = _stage_rows(_steps(1))
    want = {f"server.{rpc}.{s}" for rpc, names in ROWS.items() for s in names}
    assert set(stages) == want | set(DEVICE)
    for name, row in stages.items():
        assert row["backend"] == ("cpu" if name in DEVICE else "host"), name
        assert row["launches"] == row["sampled"] >= 1, name
        assert row["device_us_total"] >= 0.0, name
    assert "server.assign.kernel_wait" not in stages
    # a launch section's span lies inside its handler
    assert (stages["server.score.device"]["device_us_total"]
            <= stages["server.score.handler"]["device_us_total"])
    # two Syncs and two Scores, one Assign
    assert stages["server.sync.handler"]["sampled"] == 2
    assert stages["server.score.handler"]["sampled"] == 2
    assert stages["server.assign.handler"]["sampled"] == 1
    # the stages inside a handler take no more than its wall
    for rpc, names in ROWS.items():
        inner = sum(stages[f"server.{rpc}.{s}"]["device_us_total"]
                    for s in names if s not in FRAME)
        assert inner <= stages[f"server.{rpc}.handler"]["device_us_total"], rpc


def test_the_ledger_off_gives_no_stage_row():
    rows = _steps(0)
    assert _stage_rows(rows) == {}
    assert all(r["launches"] == 0 for r in rows.values())


def test_a_launch_boundary_inside_a_stage_is_still_measured():
    rows = _steps(1)
    # the warm Score's incremental rescore runs inside server.score.dispatch
    rescore = rows["solver.incremental.rescore_dirty"]
    assert rescore["launches"] == rescore["sampled"] >= 1
    assert rows["solver.greedy.score_cycle"]["sampled"] >= 1
    assert rows["solver.resident.apply_flat_delta"]["sampled"] >= 1
    # the stage rows stay out of the launch boundaries' registry
    assert not [n for n in devprof.boundaries() if n.startswith("server.")]
    health = devprof.health_block(top=50)
    assert {s["stage"] for s in health["stages"]} == set(_stage_rows(rows))
    assert {s["backend"] for s in health["stages"]} == {"host", "cpu"}
    assert not [t for t in health["top"] if t["boundary"].startswith("server.")]


def test_the_report_puts_the_stage_rows_under_their_own_heading(tmp_path):
    _steps(1)
    assert devprof.dump(str(tmp_path))
    text = devprof.format_report(json.loads((tmp_path / devprof.LEDGER_FILENAME).read_text()),
                                 top=50)
    launches, _, stages = text.partition("stage spans by RPC")
    assert "server." not in launches
    assert "solver.greedy.score_cycle" in launches
    assert "server.assign.kernel" in stages and "server.sync.commit" in stages


def test_every_span_carries_unix_stamps_from_the_one_anchor():
    devprof.configure(sample=1)
    rec = SpanRecorder(epoch="e")
    cap = spans.open_capture()
    try:
        before = time.time_ns()
        with rec.span("dispatch"), rec.rpc("score"), spans.stage("dispatch"):
            time.sleep(0.002)
        after = time.time_ns()
        trace = rec.start_trace_span("score", "t" * 32)
        time.sleep(0.002)
        trace.end()
        done = time.time_ns()
    finally:
        spans.close_capture(cap)
    (span,) = rec.commit()["spans"]
    assert before <= span["start_unix_ns"] < span["end_unix_ns"] <= after
    # this thread's: a server another test left running may close stages too
    ((name, start, end, _, _),) = [c for c in cap.spans if c[3] == threading.get_native_id()]
    assert name == "server.score.dispatch" and before <= start < end <= after
    otlp = trace.to_record()
    assert after <= otlp["startTimeUnixNano"] < otlp["endTimeUnixNano"] <= done


def test_measured_spans_keep_their_measured_start():
    rec = SpanRecorder()
    t0 = time.perf_counter_ns()
    time.sleep(0.002)
    t1 = time.perf_counter_ns()
    time.sleep(0.002)
    # the cycle is made after the stage it records
    rec.current()
    with rec.span("commit"):
        pass
    rec.add_measured("sync_decode", t0, t1)
    record = rec.commit()
    commit, decode = record["spans"]
    assert decode["start_unix_ns"] == rec.anchor.unix_ns_at(t0)
    assert decode["end_unix_ns"] == rec.anchor.unix_ns_at(t1)
    assert decode["dur_ms"] == round((t1 - t0) / 1e6, 3)
    # the record's origin is the earliest start, so no offset is negative
    assert decode["start_ms"] == 0.0 and commit["start_ms"] >= 2.0
    assert record["started_unix"] == rec.anchor.unix_ns_at(t0) / 1e9


def test_stages_outside_a_bound_rpc_record_nothing():
    devprof.configure(sample=1)
    with spans.stage("prepare"):
        pass
    spans.stage_at("wait", 0, 10)
    spans.stage_since_arrival("wait")
    assert spans.device_stage(torch.device("cpu")) is None
    # bound, with the ledger off: no device span either
    devprof.configure(sample=0)
    with SpanRecorder().rpc("score"):
        assert spans.device_stage(torch.device("cpu")) is None
    assert _stage_rows(devprof.summary()["boundaries"]) == {}
    # an untraced TraceSpan still lies on the process's anchored clock
    before = time.time_ns()
    span = TraceSpan("x", "t1", "s1")
    span.end()
    assert before <= span.to_record()["startTimeUnixNano"] <= time.time_ns()


def test_a_profile_capture_holds_the_stage_spans_on_per_thread_tracks(tmp_path):
    holder = {}

    def capture(server):
        holder["dir"] = devprof.capture_profile(str(tmp_path), window_ms=2000)
        time.sleep(0.2)

    # the ledger off: the open window alone records the stages
    rows = _steps(0, during=capture)
    assert _stage_rows(rows) == {}
    path = os.path.join(holder["dir"], devprof.PROFILE_TRACE)
    deadline = time.monotonic() + 60
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    doc = json.loads(open(path).read())
    events = doc["traceEvents"]
    stages = [e for e in events if e.get("cat") == "server_stage"]
    names = {e["name"] for e in stages}
    assert {f"server.{rpc}.handler" for rpc in ROWS} <= names
    assert {"server.assign.kernel", "server.sync.commit", "server.score.dispatch"} <= names
    assert all(e["ph"] == "X" and e["pid"] == os.getpid() and e["dur"] >= 0 for e in stages)
    tracks = {e["tid"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"
              and e["args"]["name"].startswith("server stages: ")}
    # one connection: one handler thread, one track
    assert {e["tid"] for e in stages} == tracks and len(tracks) == 1
    # on the trace's timeline, each frame's stages in order inside their handler;
    # ts and dur are float microseconds, so one stage's end and the next one's
    # start (one clock reading) may differ by a rounding of 1 ns
    (assign,) = [e for e in stages if e["name"] == "server.assign.handler"]
    kernel = next(e for e in stages if e["name"] == "server.assign.kernel")
    decode = next(e for e in stages if e["name"] == "server.assign.decode")
    ulp = 1e-3
    assert assign["ts"] - ulp <= kernel["ts"]
    assert kernel["ts"] + kernel["dur"] <= assign["ts"] + assign["dur"] + ulp
    assert decode["ts"] + decode["dur"] <= assign["ts"] + ulp
