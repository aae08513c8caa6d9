"""The port's ``ScorerClient`` (``koordinator_tpu_torch/bridge/client.py``)
on both of its channels, on the CPU: the relevant cases of the reference's
``tests/test_bridge.py``, ``tests/test_degrade.py`` and
``tests/test_replication.py`` (delta frames after the first full Sync, the
full re-sync after a stale snapshot, the baseline kept across a transient
outage, deadline and band stamping, the retry-after pacing, follower-target
parsing), the raw channel's error classification, and a traced RPC that
assembles into complete trees."""

import os
import socket
import tempfile
import threading
import time

import numpy as np
import pytest

from koordinator_tpu_torch.bridge.client import (
    RpcError,
    ScorerClient,
    _raw_code,
    parse_follower_target,
    parse_snapshot_id,
    retry_after_ms,
)
from koordinator_tpu_torch.bridge.coalesce import DeadlineExpired, SnapshotNotResident
from koordinator_tpu_torch.bridge.server import ScorerServicer, StatusCode, make_server
from koordinator_tpu_torch.bridge.udsserver import RawUdsServer
from koordinator_tpu_torch.obs.assemble import assemble
from koordinator_tpu_torch.replication.admission import BreakerOpen, ResourceExhausted
from koordinator_tpu_torch.replication.retry import BackoffPolicy
from koordinator_tpu_torch.solver import run_cycle
from koordinator_tpu_torch.harness import generators

FAST_RETRY = BackoffPolicy(base_ms=5, cap_ms=40, deadline_ms=1500)


class _Recording(ScorerServicer):
    """A CPU servicer that keeps every request it was handed."""

    def __init__(self, **kw):
        super().__init__(device="cpu", trace_export=False, **kw)
        self.requests = []

    def sync(self, req, ctx=None):
        self.requests.append(("sync", req))
        return super().sync(req, ctx)

    def score(self, req, ctx=None):
        self.requests.append(("score", req))
        return super().score(req, ctx)

    def assign(self, req, ctx=None):
        self.requests.append(("assign", req))
        return super().assign(req, ctx)


class _Served:
    """One servicer behind one transport on ``path``; ``start()`` after
    ``stop()`` binds a new server of the same servicer on the same path."""

    def __init__(self, transport, servicer, path):
        self.transport, self.servicer, self.path = transport, servicer, path
        self.target = (f"raw://{path}" if transport == "raw" else f"unix://{path}")
        self.start()

    def start(self):
        if self.transport == "raw":
            self.server = RawUdsServer(self.path, servicer=self.servicer).start()
            self.stop = self.server.stop
        else:
            self.server = make_server(servicer=self.servicer)
            self.server.add_insecure_port(f"unix://{self.path}")
            self.server.start()
            # stop(0) returns at once; wait until the server is gone, so a
            # call after stop() finds no server rather than a closing one
            self.stop = lambda: self.server.stop(0).wait(30)


@pytest.fixture(params=["raw", "grpc"])
def served(request):
    tmp = tempfile.mkdtemp()
    sv = _Recording()
    s = _Served(request.param, sv, os.path.join(tmp, "scorer.sock"))
    yield s
    s.stop()
    sv.telemetry.close()


def _tables(seed=3):
    """Seeded tensors of a small cluster: 6 nodes, 16 pods."""
    rng = np.random.default_rng(seed)
    R = 13
    nalloc = np.zeros((6, R), np.int64)
    nalloc[:, 0] = rng.choice([16000, 32000], 6)
    nalloc[:, 1] = nalloc[:, 0] * 4
    nalloc[:, 2] = 110
    nuse = nalloc * rng.integers(5, 40, (6, 1)) // 100
    preq = np.zeros((16, R), np.int64)
    preq[:, 0] = rng.choice([250, 500, 1000], 16)
    preq[:, 1] = rng.choice([256, 512], 16)
    preq[:, 2] = 1
    return dict(node_allocatable=nalloc, node_requested=np.zeros_like(nalloc),
                node_usage=nuse, pod_requests=preq, pod_estimated=preq,
                priority=list(rng.integers(0, 9000, 16)))


def _kinds(tensor):
    return ("delta" if tensor.delta_idx else "full" if tensor.data else "none")


def test_delta_frames_follow_the_first_full_sync(served):
    client = ScorerClient(served.target, retry_policy=FAST_RETRY)
    try:
        kw = _tables()
        first = client.sync(**kw)
        assert parse_snapshot_id(first.snapshot_id)[1] == 1
        nuse = kw["node_usage"].copy()
        nuse[0, 0] += 1000
        second = client.sync(node_usage=nuse)
        syncs = [r for kind, r in served.servicer.requests if kind == "sync"]
        assert _kinds(syncs[0].nodes.usage) == "full"
        assert _kinds(syncs[0].nodes.allocatable) == "full"
        assert _kinds(syncs[1].nodes.usage) == "delta"
        assert _kinds(syncs[1].nodes.allocatable) == "none"
        assert parse_snapshot_id(second.snapshot_id)[1] == 2
        assert client._generation == 2
        # the server's resident state is the client's view
        snap = served.servicer.state.snapshot()
        np.testing.assert_array_equal(snap.nodes.usage.numpy()[:6], nuse)
        assignment, status, ms, path = client.assign()
        assert path == "scan" and ms > 0
        want = run_cycle(snap)
        np.testing.assert_array_equal(assignment, want.assignment.numpy()[:16])
        np.testing.assert_array_equal(status, want.status.numpy()[:16])
    finally:
        client.close()


def test_stale_snapshot_invalidates_and_the_next_sync_is_full(served):
    a = ScorerClient(served.target, retry_policy=FAST_RETRY)
    b = ScorerClient(served.target, retry_policy=FAST_RETRY)
    try:
        kw = _tables()
        a.sync(**kw)
        b.sync(**kw)  # displaces a's generation
        with pytest.raises(RpcError) as err:
            a.score_flat(top_k=3)
        assert err.value.code() == StatusCode.FAILED_PRECONDITION
        assert "is not resident" in err.value.details()
        assert a.snapshot_id is None and a._generation is None and not a._prev
        n_before = len(served.servicer.requests)
        nuse = kw["node_usage"] + 1
        reply = a.sync(**dict(kw, node_usage=nuse))
        resent = [r for kind, r in served.servicer.requests[n_before:] if kind == "sync"]
        assert len(resent) == 1 and _kinds(resent[0].nodes.usage) == "full"
        assert reply.snapshot_id == served.servicer.snapshot_id()
        assert a.score_flat(top_k=3)[0].size == 16
        # a delta after another client's Sync fails the continuity check:
        # the client re-sends full state in the same call
        b.sync(node_usage=nuse + 1)
        n_before = len(served.servicer.requests)
        moved = nuse.copy()
        moved[1, 0] += 7
        a.sync(node_usage=moved)
        sent = [r for kind, r in served.servicer.requests[n_before:] if kind == "sync"]
        assert [_kinds(r.nodes.usage) for r in sent] == ["delta", "full"]
        assert a.snapshot_id == served.servicer.snapshot_id()
    finally:
        a.close()
        b.close()


def test_transient_outage_keeps_the_baseline_and_the_delta_resumes(served):
    client = ScorerClient(served.target, retry_policy=FAST_RETRY)
    try:
        kw = _tables()
        client.sync(**kw)
        gen, keys = client._generation, set(client._prev)
        served.stop()
        with pytest.raises(RpcError) as err:
            client.sync(node_usage=kw["node_usage"] + 1)
        assert err.value.code() == StatusCode.UNAVAILABLE
        assert client._generation == gen and set(client._prev) == keys
        served.start()
        # a wider budget for the reconnect: a gRPC channel backs off about
        # a second after a failed dial
        client._retry = BackoffPolicy(base_ms=20, cap_ms=200, deadline_ms=10_000)
        n_before = len(served.servicer.requests)
        moved = kw["node_usage"].copy()
        moved[2, 1] += 5
        reply = client.sync(node_usage=moved)
        assert client._generation == gen + 1
        assert reply.snapshot_id == served.servicer.snapshot_id()
        sent = [r for kind, r in served.servicer.requests[n_before:] if kind == "sync"]
        assert [_kinds(r.nodes.usage) for r in sent] == ["delta"]
    finally:
        client.close()


def test_a_retry_rides_out_a_restart_inside_the_budget(served):
    client = ScorerClient(served.target, retry_policy=BackoffPolicy(
        base_ms=20, cap_ms=100, deadline_ms=10_000))
    try:
        kw = _tables()
        client.sync(**kw)
        served.stop()
        timer = threading.Timer(0.3, served.start)
        timer.start()
        try:
            reply = client.sync(node_usage=kw["node_usage"] + 1)
        finally:
            timer.join(timeout=30)
        assert not timer.is_alive()
        assert reply.snapshot_id == served.servicer.snapshot_id()
        assert client.score_flat(top_k=2)[0].size == 16
    finally:
        client.close()


def test_deadline_and_band_are_stamped_on_the_wire(served):
    client = ScorerClient(served.target, band="koord-batch", deadline_ms=60_000,
                          retry_policy=FAST_RETRY)
    try:
        client.sync(**_tables())
        client.score_flat(top_k=3)
        client.assign()
        reqs = {kind: r for kind, r in served.servicer.requests}
        for kind in ("score", "assign"):
            assert reqs[kind].deadline_ms == 60_000 and reqs[kind].band == "koord-batch"
        assert client._timeout_s() == 60.0
        req = client._score_request(top_k=3, flat=True)
        assert (req.deadline_ms, req.band, req.top_k, req.flat) == (60_000, "koord-batch", 3, True)
    finally:
        client.close()


def test_raw_call_times_out_as_deadline_exceeded(tmp_path):
    """A peer that accepts and never answers: the transport deadline ends
    the call, and the error is the transient DEADLINE_EXCEEDED."""
    path = str(tmp_path / "mute.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(4)
    client = ScorerClient(f"raw://{path}", rpc_timeout_ms=100,
                          retry_policy=BackoffPolicy(base_ms=5, cap_ms=5, deadline_ms=30))
    try:
        t0 = time.perf_counter()
        with pytest.raises(RpcError) as err:
            client.sync(**_tables())
        assert err.value.code() == StatusCode.DEADLINE_EXCEEDED
        assert time.perf_counter() - t0 < 10
        assert client._generation is None
    finally:
        client.close()
        listener.close()


@pytest.mark.parametrize("exc,code", [
    (SnapshotNotResident("snapshot 's1-1' is not resident (current s1-2)"),
     StatusCode.FAILED_PRECONDITION),
    (ResourceExhausted("score", 9, 8, 42.0, "koord-free"), StatusCode.RESOURCE_EXHAUSTED),
    (BreakerOpen("assign", 250.0, "assign never serves stale"), StatusCode.UNAVAILABLE),
    (DeadlineExpired("score", "queue", 5.0), StatusCode.DEADLINE_EXCEEDED),
    (RuntimeError("cycle kernel failed"), StatusCode.UNKNOWN),
], ids=["stale", "shed", "breaker", "deadline", "other"])
def test_raw_error_frames_classify_as_the_go_shim_does(exc, code):
    assert _raw_code(str(exc)) == code


def test_shed_pause_uses_the_hint_not_both():
    c = ScorerClient.__new__(ScorerClient)
    c._retry = BackoffPolicy(base_ms=1000.0, cap_ms=1000.0, deadline_ms=60_000.0)
    shed = RpcError(StatusCode.RESOURCE_EXHAUSTED,
                    "RESOURCE_EXHAUSTED: score shed; retry_after_ms=42")
    assert retry_after_ms(shed) == 42.0
    assert retry_after_ms(ValueError("retry_after_ms=42")) is None
    delays = iter([999.0, 999.0])
    assert c._pause_ms(delays, shed) == 42.0
    assert c._pause_ms(delays, None) == 999.0
    assert c._pause_ms(iter([]), shed) is None
    capped = RpcError(StatusCode.UNAVAILABLE, "BREAKER_OPEN: x; retry_after_ms=30000")
    assert c._pause_ms(iter([1.0]), capped) == 1000.0


def test_follower_targets_and_snapshot_ids_parse():
    assert parse_follower_target("unix:///f.sock@2") == ("unix:///f.sock", 2)
    assert parse_follower_target("raw:///f.sock") == ("raw:///f.sock", 1)
    assert parse_follower_target("user@host:50051") == ("user@host:50051", 1)
    assert parse_follower_target("unix:///f.sock@-3")[1] == 1
    assert parse_snapshot_id("sab12-7") == ("ab12", 7)
    assert parse_snapshot_id("s7") == ("", 7)
    assert parse_snapshot_id("sx-y") == ("x", -1)


@pytest.mark.parametrize("transport", ["raw", "grpc"])
def test_traced_rpcs_assemble_into_complete_trees(tmp_path, transport):
    export = str(tmp_path / "spans")
    sv = ScorerServicer(device="cpu", trace_export=export)
    served = _Served(transport, sv, str(tmp_path / "scorer.sock"))
    client = ScorerClient(served.target, trace_export=export, retry_policy=FAST_RETRY)
    try:
        client.sync(**_tables())
        client.score_flat(top_k=3)
        client.assign()
    finally:
        client.close()
        served.stop()
        sv.telemetry.close()
    assembly = assemble([export])
    assert len(assembly.traces) == 3
    assert not assembly.incomplete and not assembly.orphan_spans
    kinds = {s["kind"] for s in assembly.spans_by_id.values()}
    assert {"client", "server"} <= kinds


def test_generators_cluster_round_trips_through_the_client(tmp_path):
    """A generator cluster synced through the raw client places as the
    in-process cycle does on the resident snapshot."""
    from koordinator_tpu_torch.harness.golden import build_sync_request

    nodes, pods, gangs, quotas = generators.quota_colocation(pods=24, nodes=6)
    req, _ = build_sync_request(nodes, pods, gangs, quotas)
    sv = ScorerServicer(device="cpu", trace_export=False)
    served = _Served("raw", sv, str(tmp_path / "scorer.sock"))
    client = ScorerClient(served.target, retry_policy=FAST_RETRY)

    def tensor(t):
        return np.frombuffer(t.data, "<i8").reshape(tuple(t.shape))

    try:
        client.sync(
            node_allocatable=tensor(req.nodes.allocatable),
            node_requested=tensor(req.nodes.requested),
            node_usage=tensor(req.nodes.usage),
            metric_fresh=list(req.nodes.metric_fresh),
            pod_requests=tensor(req.pods.requests),
            pod_estimated=tensor(req.pods.estimated),
            priority=list(req.pods.priority), gang_id=list(req.pods.gang_id),
            quota_id=list(req.pods.quota_id), gang_min_member=list(req.gangs.min_member),
            quota_runtime=tensor(req.quotas.runtime), quota_used=tensor(req.quotas.used),
            quota_limited=tensor(req.quotas.limited),
        )
        assignment, status, _ms, _path = client.assign()
        want = run_cycle(sv.state.snapshot())
        n = len(pods)
        np.testing.assert_array_equal(assignment, want.assignment.numpy()[:n])
        np.testing.assert_array_equal(status, want.status.numpy()[:n])
    finally:
        client.close()
        served.stop()
        sv.telemetry.close()


def test_arrays_mutated_in_place_still_ship_their_changes(served):
    """The acked baseline is the client's own copy: a caller that mutates
    its arrays in place between Syncs (the trace replay's ClusterModel
    does) still ships each change as a delta, and the server's resident
    state follows it."""
    client = ScorerClient(served.target, retry_policy=FAST_RETRY)
    try:
        kw = _tables()
        client.sync(**kw)
        usage = kw["node_usage"]
        usage[0, 0] += 1000  # in place: the array the first Sync was given
        n_before = len(served.servicer.requests)
        client.sync(node_usage=usage)
        (sent,) = [r for kind, r in served.servicer.requests[n_before:] if kind == "sync"]
        assert _kinds(sent.nodes.usage) == "delta"
        np.testing.assert_array_equal(
            served.servicer.state.snapshot().nodes.usage.numpy()[:6], usage)
    finally:
        client.close()


def test_the_reference_client_aliases_the_callers_arrays(tmp_path):
    """The fault the port's client repairs, pinned on the reference: its
    acked baseline IS the caller's array, so a change made in place never
    reaches the server (the reference's trace replay ships no tensor
    change after its first Sync)."""
    from koordinator_tpu.bridge.client import ScorerClient as RefClient
    from koordinator_tpu.bridge.server import ScorerServicer as RefServicer
    from koordinator_tpu.bridge.server import make_server as ref_make_server

    sv = RefServicer(trace_export=False)
    server = ref_make_server(servicer=sv)
    server.add_insecure_port(f"unix://{tmp_path}/ref.sock")
    server.start()
    client = RefClient(f"unix://{tmp_path}/ref.sock", trace_export=False)
    try:
        kw = _tables()
        client.sync(**kw)
        before = kw["node_usage"].copy()
        kw["node_usage"][0, 0] += 1000
        client.sync(node_usage=kw["node_usage"])
        np.testing.assert_array_equal(np.asarray(sv.state.node_usage), before)
        # nor does a fresh copy of the same values: the baseline holds them
        client.sync(node_usage=kw["node_usage"].copy())
        np.testing.assert_array_equal(np.asarray(sv.state.node_usage), before)
    finally:
        client.close()
        server.stop(0)
        sv.telemetry.close()
