"""The port's serving seam on the CPU: the ScorerServicer
(``koordinator_tpu_torch/bridge/server.py``), its raw-UDS transport
(``udsserver.py``), the Go plugin's executable spec (``plugin_sim.py``) and
the gRPC transport, against the golden fixtures, the reference's server and
the port's in-process calls.  Every compared value is an integer or a byte,
so every comparison is exact."""

import os
import random
import socket
import struct
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.coalesce import DeadlineExpired, SnapshotNotResident
from koordinator_tpu_torch.bridge.server import ScorerServicer
from koordinator_tpu_torch.bridge.state import numpy_to_tensor
from koordinator_tpu_torch.bridge.udsserver import (
    METHOD_ASSIGN, METHOD_SCORE, METHOD_SYNC, RawUdsServer,
)
from koordinator_tpu_torch.config import CycleConfig
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.solver import masked_top_k, run_cycle, score_cycle, score_upper_bound

TESTDATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "go", "scorerclient", "testdata",
)


def load(name: str) -> bytes:
    with open(os.path.join(TESTDATA, name), "rb") as f:
        return f.read()


def pinned_servicer(epoch: str, **kw) -> ScorerServicer:
    """A servicer with a pinned boot epoch, as go/gen_fixtures.py makes
    its: the epoch rides every snapshot id and span id."""
    sv = ScorerServicer(device="cpu", **kw)
    sv._epoch = epoch
    sv.telemetry.spans.epoch = epoch
    return sv


def golden_cluster(pods=32, nodes=8):
    node_list, pod_list, _, quotas = generators.quota_colocation(pods=pods, nodes=nodes)
    gangs = [{"name": "gang-0", "min_member": 2}]
    pod_list[0]["gang"] = "gang-0"
    pod_list[1]["gang"] = "gang-0"
    return node_list, pod_list, gangs, quotas


# -- the golden fixtures, regenerated byte for byte --

def test_regenerates_the_rpc_fixtures():
    """go/gen_fixtures.py's main recipe on the port's servicer."""
    nodes, pods, gangs, quotas = golden_cluster()
    req, _ = build_sync_request(nodes, pods, gangs, quotas, node_bucket=8, pod_bucket=32)
    req.trace_id = "ab" * 16
    req.parent_span = "1111222233334444"
    assert req.SerializeToString() == load("sync_request.bin")
    sv = pinned_servicer("0601den0")
    sync_reply = sv.sync(req)
    score_req = wire.ScoreRequest(
        snapshot_id=sync_reply.snapshot_id, top_k=4, flat=True,
        deadline_ms=1500, band="koord-batch",
        trace_id="cd" * 16, parent_span="5555666677778888",
    )
    assert score_req.SerializeToString() == load("score_request.bin")
    score_reply = sv.score(score_req)
    assign_req = wire.AssignRequest(
        snapshot_id=sync_reply.snapshot_id, cycle_id="golden-cycle-1",
        deadline_ms=2500, band="koord-prod",
        trace_id="ef" * 16, parent_span="9999aaaabbbbcccc",
    )
    assert assign_req.SerializeToString() == load("assign_request.bin")
    assign_reply = sv.assign(assign_req)
    assert assign_reply.path == "scan"
    score_reply.build_ms = 0.125
    assign_reply.cycle_ms = 1.5
    assert sync_reply.SerializeToString() == load("sync_reply.bin")
    assert score_reply.SerializeToString() == load("score_reply.bin")
    assert assign_reply.SerializeToString() == load("assign_reply.bin")


def test_regenerates_the_plugin_flow_fixtures():
    """go/gen_fixtures.py's plugin flow: a full single-pod sync, a delta
    sync against it, then a flat Score."""
    from koordinator_tpu_torch.bridge.plugin_sim import (
        NUM_AXES, ResidentMirror, build_sync, node_vectors,
    )

    def vec(cpu=0, mem=0, pods=0):
        v = [0] * NUM_AXES
        v[0], v[1], v[3] = cpu, mem, pods
        return v

    alloc = vec(cpu=8000, mem=16384, pods=110)
    nodes1 = [(f"plugin-node-{i}", alloc, vec(cpu=1000, mem=1024, pods=5))
              for i in range(4)]
    metrics = {"plugin-node-0": vec(cpu=500, mem=512)}
    pod_vec = vec(cpu=500, mem=512, pods=1)
    names, a1, r1, u1, f1 = node_vectors(nodes1, metrics)
    mirror = ResidentMirror()
    sync1 = build_sync(mirror, False, names, a1, r1, u1, f1, "plugin-pod-1", pod_vec, 0)
    assert sync1 == load("plugin_sync1_request.bin")
    sv = pinned_servicer("f1edf1ed")
    reply1 = sv.sync(wire.SyncRequest.FromString(sync1))
    mirror.names, mirror.alloc, mirror.requested, mirror.usage = names, a1, r1, u1
    mirror.gen, mirror.valid = 1, True
    nodes2 = list(nodes1)
    nodes2[2] = ("plugin-node-2", alloc, vec(cpu=1500, mem=1536, pods=6))
    names2, a2, r2, u2, f2 = node_vectors(nodes2, metrics)
    sync2 = build_sync(mirror, True, names2, a2, r2, u2, f2, "plugin-pod-2", pod_vec, 0)
    assert sync2 == load("plugin_sync2_request.bin")
    reply2 = sv.sync(wire.SyncRequest.FromString(sync2))
    assert sv.state.last_sync_path == "cold"  # nothing was resident yet
    score_req = wire.ScoreRequest(snapshot_id=reply2.snapshot_id, top_k=0, flat=True)
    assert score_req.SerializeToString() == load("plugin_score2_request.bin")
    score_reply = sv.score(score_req)
    score_reply.build_ms = 0.125
    assert reply1.SerializeToString() == load("plugin_sync1_reply.bin")
    assert reply2.SerializeToString() == load("plugin_sync2_reply.bin")
    assert score_reply.SerializeToString() == load("plugin_score2_reply.bin")


# -- the plugin seam scenarios, port against reference --

def _vec(cpu=0, mem=0, pods=0):
    v = [0] * 13
    v[0], v[1], v[3] = cpu, mem, pods
    return v


ALLOC = _vec(cpu=8000, mem=16384, pods=110)
REQ = _vec(cpu=1000, mem=1024, pods=5)
POD = _vec(cpu=500, mem=512, pods=1)
NODES = [("node-cold", ALLOC, REQ), ("node-hot", ALLOC, REQ)]


class Stack:
    """One side's raw-UDS server and plugin simulator."""

    def __init__(self, side):
        self.side = side
        self.path = os.path.join(tempfile.mkdtemp(), "scorer.sock")
        self.servers = []
        if side == "port":
            from koordinator_tpu_torch.bridge.plugin_sim import GoPluginSim

            self.sim_cls = GoPluginSim
        else:
            from koordinator_tpu.bridge.plugin_sim import GoPluginSim

            self.sim_cls = GoPluginSim
        self.start()

    def start(self):
        if self.side == "port":
            srv = RawUdsServer(self.path, device="cpu").start()
        else:
            from koordinator_tpu.bridge.udsserver import RawUdsServer as RefServer

            srv = RefServer(self.path).start()
        self.servers.append(srv)
        return srv

    def restart(self):
        self.servers[-1].stop()
        return self.start()

    def sim(self):
        return self.sim_cls(self.path)

    def stop(self):
        self.servers[-1].stop()


def _usage_feed(stack):
    out = []
    for metrics in ({"node-cold": _vec(cpu=500, mem=512), "node-hot": _vec(cpu=4800, mem=8192)},
                    {"node-cold": _vec(cpu=500, mem=512), "node-hot": _vec(cpu=7000, mem=14336)},
                    {}):
        sim = stack.sim()
        sim.metrics = metrics
        out.append(sim.pre_score(NODES, "pod-x", POD))
    return out


def _node_metric_feed(stack):
    from koordinator_tpu.koordlet import metriccache as mc
    from koordinator_tpu.koordlet.metriccache import MetricCache
    from koordinator_tpu.koordlet.statesinformer import NodeMetricReporter, StatesInformer

    def payload_for(cores_used):
        cache = MetricCache()
        for i in range(10):
            cache.append(mc.NODE_CPU_USAGE, cores_used, ts=float(i))
            cache.append(mc.NODE_MEMORY_USAGE, 2 * (1 << 30), ts=float(i))
        return NodeMetricReporter(cache, StatesInformer()).collect(10.0)

    sim = stack.sim()
    sim.update_node_metric("node-hot", payload_for(5.0))
    sim.update_node_metric("node-cold", payload_for(0.5))
    sim.update_node_metric("node-cold", {"nodeMetric": {}})
    return [sim.pre_score(NODES, "pod-x", POD), dict(sim.metrics)]


def _delta_sync(stack):
    many = [(f"node-{i}", ALLOC, REQ) for i in range(64)]
    sim = stack.sim()
    out = [sim.pre_score(many, "pod-x", POD)]
    nodes2 = list(many)
    nodes2[5] = ("node-5", ALLOC, _vec(cpu=1500, mem=1536, pods=6))
    out.append(sim.pre_score(nodes2, "pod-y", POD))
    out.append(stack.sim().pre_score(nodes2, "pod-y", POD))
    out.append(list(sim.sent_frames))
    assert sim.sent_frames[2][1] < sim.sent_frames[0][1] / 10
    return out


def _all_changed(stack):
    sim = stack.sim()
    sim.pre_score(NODES, "pod-x", POD)
    nodes2 = [("node-cold", [9000 + i for i in range(13)], [3000 + i for i in range(13)]),
              ("node-hot", [7000 + i for i in range(13)], [2000 + i for i in range(13)])]
    return [sim.pre_score(nodes2, "pod-y", POD), list(sim.sent_frames)]


def _fuzz(stack):
    rng = random.Random(17)
    n_nodes = 12
    reqs = {f"node-{i}": list(REQ) for i in range(n_nodes)}

    def view():
        return [(name, ALLOC, list(r)) for name, r in sorted(reqs.items())]

    sim, other = stack.sim(), stack.sim()
    out = []
    for cycle in range(12):
        action = rng.random()
        if action < 0.5:
            for _ in range(rng.randrange(1, 4)):
                r = reqs[f"node-{rng.randrange(n_nodes)}"]
                r[0] = rng.randrange(500, 4000)
                r[3] = rng.randrange(1, 50)
        elif action < 0.7:
            other.metrics = {}
            try:
                other.pre_score([(f"other-{i}", ALLOC, REQ) for i in range(3)],
                                f"foreign-{cycle}", POD)
            except Exception:
                other._drop_client()
        elif action < 0.8 and cycle > 0:
            stack.restart()
            other._drop_client()
            other.mirror.invalidate()
        try:
            got = sim.pre_score(view(), f"pod-{cycle}", POD)
        except Exception:
            assert not sim.mirror.valid
            got = sim.pre_score(view(), f"pod-{cycle}", POD)
        cold = stack.sim().pre_score(view(), f"pod-{cycle}", POD)
        assert cold == got, f"delta baseline drifted at cycle {cycle}"
        out.append(got)
    return out


def _displacement(stack):
    sim = stack.sim()
    sim.pre_score(NODES, "pod-x", POD)
    stack.sim().pre_score([("node-other", ALLOC, REQ), ("node-other2", ALLOC, REQ)],
                          "pod-foreign", POD)
    sim.sent_frames.clear()
    scores = sim.pre_score(NODES, "pod-y", POD)
    return [scores, [m for m, _ in sim.sent_frames]]


def _restart(stack):
    sim = stack.sim()
    sim.pre_score(NODES, "pod-x", POD)
    stack.restart()
    sim.sent_frames.clear()
    scores = sim.pre_score(NODES, "pod-y", POD)
    assert sim.mirror.valid
    return [scores, [m for m, _ in sim.sent_frames],
            sim.sent_frames[1][1] > sim.sent_frames[0][1]]


SCENARIOS = {
    "usage_feed": _usage_feed, "node_metric_feed": _node_metric_feed,
    "delta_sync": _delta_sync, "all_changed_falls_back_to_full": _all_changed,
    "fuzz_mutation_displacement_restart": _fuzz,
    "generation_displacement": _displacement, "sidecar_restart": _restart,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plugin_seam_scenario_matches_the_reference(name):
    results = {}
    for side in ("reference", "port"):
        stack = Stack(side)
        try:
            results[side] = SCENARIOS[name](stack)
        finally:
            stack.stop()
    assert results["port"] == results["reference"]


# -- Assign and Score through the transport against the in-process calls --

class Client:
    """A raw-UDS client with a timeout on every socket operation."""

    def __init__(self, path):
        self.conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.conn.settimeout(120)
        self.conn.connect(path)

    def call(self, method, msg, reply_cls):
        body = msg.SerializeToString()
        self.conn.sendall(struct.pack(">BI", method, len(body)) + body)
        status, length = struct.unpack(">BI", self._recv(5))
        payload = self._recv(length)
        if status != 0:
            raise RuntimeError(payload.decode())
        return reply_cls.FromString(payload)

    def _recv(self, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def close(self):
        self.conn.close()


@pytest.fixture()
def uds():
    """(path, server) of a started port RawUdsServer on the CPU."""
    made = []

    def start(**kw):
        path = os.path.join(tempfile.mkdtemp(), "scorer.sock")
        srv = RawUdsServer(path, servicer=ScorerServicer(device="cpu", **kw)).start()
        made.append(srv)
        return path, srv

    yield start
    for srv in made:
        srv.stop()


def _snapshot_of(nodes, pods, gangs, quotas, nb, pb):
    snap, _ = generators.encode_quota_lists(
        nodes, pods, gangs, quotas, node_bucket=nb, pod_bucket=pb, device="cpu")
    return snap


@pytest.mark.parametrize("cfg", [CycleConfig(), CycleConfig(wave=8, top_m=2)],
                         ids=["per_pod", "wave"])
def test_assign_over_uds_equals_in_process_run_cycle(uds, cfg):
    nodes, pods, gangs, quotas = golden_cluster(pods=48, nodes=12)
    path, srv = uds(cfg=cfg)
    client = Client(path)
    try:
        req, _ = build_sync_request(nodes, pods, gangs, quotas, node_bucket=16, pod_bucket=64)
        sync = client.call(METHOD_SYNC, req, wire.SyncReply)
        reply = client.call(METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sync.snapshot_id),
                            wire.AssignReply)
        want = run_cycle(_snapshot_of(nodes, pods, gangs, quotas, 16, 64), cfg)
        assert reply.path == want.path
        assert list(reply.assignment) == want.assignment[:48].tolist()
        assert list(reply.status) == want.status[:48].tolist()
        # a warm delta Sync (three nodes' cpu), then Assign again
        prev = np.frombuffer(req.nodes.requested.data, "<i8").reshape(12, 13).copy()
        nxt = prev.copy()
        nxt[:3, 0] += 500
        warm = wire.SyncRequest()
        warm.nodes.requested.CopyFrom(numpy_to_tensor(nxt, prev))
        sync = client.call(METHOD_SYNC, warm, wire.SyncReply)
        assert srv.servicer.state.last_sync_path == "warm"
        reply = client.call(METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sync.snapshot_id),
                            wire.AssignReply)
        for i in range(3):
            nodes[i]["requested"] = dict(nodes[i].get("requested", {}))
        snap = _snapshot_of(nodes, pods, gangs, quotas, 16, 64)
        snap.nodes.requested[:3, 0] += 500
        want = run_cycle(snap, cfg)
        assert list(reply.assignment) == want.assignment[:48].tolist()
        assert list(reply.status) == want.status[:48].tolist()
    finally:
        client.close()


def _score_reference(snap, cfg, k):
    """(top scores, top indices, ok) of the in-process Score path."""
    scores, feasible = score_cycle(snap, cfg)
    N = snap.nodes.capacity
    ts, ti = masked_top_k(scores, feasible, k=min(k, N) if k else N,
                          hi=score_upper_bound(cfg))
    ok = torch.gather(feasible, 1, ti.long())
    return ts.numpy(), ti.numpy(), ok.numpy()


def _flat_of(ts, ti, ok, P):
    valid = np.ones(P, bool)
    ok_v = ok[:P]
    return (np.flatnonzero(valid).astype("<i4").tobytes(),
            ok_v.sum(axis=1).astype("<i4").tobytes(),
            ti[:P][ok_v].astype("<i4").tobytes(),
            ts[:P][ok_v].astype("<i8").tobytes())


def test_score_over_uds_equals_in_process_score(uds):
    nodes, pods, gangs, quotas = golden_cluster(pods=40, nodes=16)
    path, srv = uds()
    client = Client(path)
    try:
        req, _ = build_sync_request(nodes, pods, gangs, quotas)
        sync = client.call(METHOD_SYNC, req, wire.SyncReply)
        snap = _snapshot_of(nodes, pods, gangs, quotas, 16, 64)
        for k in (4, 0):
            reply = client.call(METHOD_SCORE, wire.ScoreRequest(
                snapshot_id=sync.snapshot_id, top_k=k, flat=True), wire.ScoreReply)
            ts, ti, ok = _score_reference(snap, CycleConfig(), k)
            f = reply.flat
            assert (f.pod_index, f.counts, f.node_index, f.score) == _flat_of(ts, ti, ok, 40)
        # the per-pod layout carries the same entries
        reply = client.call(METHOD_SCORE, wire.ScoreRequest(
            snapshot_id=sync.snapshot_id, top_k=4), wire.ScoreReply)
        ts, ti, ok = _score_reference(snap, CycleConfig(), 4)
        assert len(reply.pods) == 40
        for p, entry in enumerate(reply.pods):
            assert list(entry.node_index) == ti[p][ok[p]].tolist()
            assert list(entry.score) == ts[p][ok[p]].tolist()
    finally:
        client.close()


def _sync_cluster(sv, pods=40, nodes=16):
    node_list, pod_list, gangs, quotas = golden_cluster(pods=pods, nodes=nodes)
    req, _ = build_sync_request(node_list, pod_list, gangs, quotas)
    return req, sv.sync(req).snapshot_id


def test_score_storm_coalesces_and_equals_serial():
    """8 threads x 6 Scores of mixed k against one snapshot, with the memo
    and the incremental engine off: every reply equals a serial servicer's,
    and the dispatcher ran fewer batches than requests."""
    sv = pinned_servicer("5701a5e1", score_memo=False, score_incr=False,
                         coalesce_window_ms=20.0)
    serial = pinned_servicer("5701a5e1", score_memo=False, score_incr=False)
    req, sid = _sync_cluster(sv)
    serial.sync(req)
    ks = [1, 2, 4, 8, 0, 3]
    want = {k: serial.score(wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=True))
            for k in ks}
    barrier = threading.Barrier(8)
    got, errors = [], []

    def worker(i):
        try:
            barrier.wait(timeout=60)
            for j in range(6):
                k = ks[(i + j) % len(ks)]
                got.append((k, sv.score(wire.ScoreRequest(snapshot_id=sid, top_k=k,
                                                          flat=True))))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors
    assert len(got) == 48
    for k, reply in got:
        reply.build_ms = want[k].build_ms = 0.0
        assert reply == want[k]
    stats = sv.dispatch.stats()
    assert stats["requests"] == 48
    assert stats["batches"] < stats["requests"]


def test_interleaved_score_storm_and_delta_syncs_equal_serial_replies():
    """Score threads storm while two Sync threads commit delta frames (in
    place into the resident tensors) and an Assign thread runs cycles.
    Every reply that named a snapshot id must equal what a serial servicer
    replies for that id: the in-place commit drains every batch that
    captured the tensors it writes."""
    sv = pinned_servicer("1a7e0001", coalesce_window_ms=5.0)
    req, sid0 = _sync_cluster(sv, pods=48, nodes=16)
    sv.state.snapshot()
    base = np.frombuffer(req.nodes.requested.data, "<i8").reshape(16, 13).copy()
    frames = {sid0: req.SerializeToString()}
    order = [sid0]
    lock = threading.Lock()
    mirror = [base]
    stop = threading.Event()
    scores, assigns, errors = [], [], []

    def syncer(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(6):
                with lock:
                    prev = mirror[0]
                    nxt = prev.copy()
                    rows = rng.choice(16, 2, replace=False)
                    nxt[rows, 0] += rng.randint(1, 400, 2)
                    msg = wire.SyncRequest()
                    msg.nodes.requested.CopyFrom(numpy_to_tensor(nxt, prev))
                    reply = sv.sync(msg)
                    mirror[0] = nxt
                    frames[reply.snapshot_id] = msg.SerializeToString()
                    order.append(reply.snapshot_id)
                    seen = len(scores)
                # let the storm reach the new generation before the next
                # commit (bounded wait)
                deadline = time.monotonic() + 5.0
                while len(scores) < seen + 4 and time.monotonic() < deadline:
                    time.sleep(0.002)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    def scorer(i):
        k = (1, 4, 0, 2)[i % 4]
        while not stop.is_set():
            sid = sv.snapshot_id()
            try:
                r = sv.score(wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=True))
            except SnapshotNotResident:
                continue
            except Exception as exc:  # surfaced below
                errors.append(exc)
                return
            scores.append((sid, k, r))

    def assigner():
        while not stop.is_set():
            sid = sv.snapshot_id()
            try:
                r = sv.assign(wire.AssignRequest(snapshot_id=sid))
            except SnapshotNotResident:
                continue
            except Exception as exc:  # surfaced below
                errors.append(exc)
                return
            assigns.append((sid, r))

    workers = [threading.Thread(target=scorer, args=(i,)) for i in range(6)]
    workers.append(threading.Thread(target=assigner))
    syncers = [threading.Thread(target=syncer, args=(s,)) for s in (1, 2)]
    for t in workers + syncers:
        t.start()
    for t in syncers:
        t.join(timeout=300)
        assert not t.is_alive()
    stop.set()
    for t in workers:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    assert len(order) == 13 and len(scores) >= 40

    # the serial servicer replays the Syncs in commit order
    serial = pinned_servicer("1a7e0001", score_memo=False, score_incr=False)
    want_scores, want_assign = {}, {}
    for sid in order:
        assert serial.sync(wire.SyncRequest.FromString(frames[sid])).snapshot_id == sid
        for k in (1, 4, 0, 2):
            want_scores[sid, k] = serial.score(
                wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=True))
        want_assign[sid] = serial.assign(wire.AssignRequest(snapshot_id=sid))
    for sid, k, r in scores:
        r.build_ms = want_scores[sid, k].build_ms = 0.0
        assert r == want_scores[sid, k], sid
    for sid, r in assigns:
        assert list(r.assignment) == list(want_assign[sid].assignment), sid
        assert list(r.status) == list(want_assign[sid].status), sid
    assert len({sid for sid, _, _ in scores}) > 1


def test_incremental_and_memo_scores_equal_full_rescores():
    sv = pinned_servicer("17c0ffee")
    full = pinned_servicer("17c0ffee", score_memo=False, score_incr=False)
    req, sid = _sync_cluster(sv)
    full.sync(req)
    prev = np.frombuffer(req.nodes.requested.data, "<i8").reshape(16, 13).copy()
    for step in range(4):
        for k in (4, 2, 8):  # 2 is a memo hit of the k=4 launch
            got = sv.score(wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=True))
            want = full.score(wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=True))
            got.build_ms = want.build_ms = 0.0
            assert got == want, (step, k)
        nxt = prev.copy()
        nxt[step * 3:step * 3 + 3, 1] += 100
        msg = wire.SyncRequest()
        msg.nodes.requested.CopyFrom(numpy_to_tensor(nxt, prev))
        sid = sv.sync(msg).snapshot_id
        assert full.sync(msg).snapshot_id == sid
        prev = nxt
    text = sv.telemetry.metrics.registry.render()
    assert 'result="incr"' in text and 'result="hit"' in text


def test_sparse_engine_scores_equal_dense():
    cfg = CycleConfig(candidate_width=16)
    sparse = pinned_servicer("5ba45e00", cfg=cfg)
    dense = pinned_servicer("5ba45e00")
    req, sid = _sync_cluster(sparse, nodes=16)
    dense.sync(req)
    for k in (4, 16):
        got = sparse.score(wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=True))
        want = dense.score(wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=True))
        got.build_ms = want.build_ms = 0.0
        assert got == want


def test_stale_snapshot_and_expired_deadline_are_refused():
    sv = ScorerServicer(device="cpu")
    _, sid = _sync_cluster(sv)
    with pytest.raises(SnapshotNotResident):
        sv.score(wire.ScoreRequest(snapshot_id="sdeadbeef-1", top_k=2))
    with pytest.raises(SnapshotNotResident):
        sv.assign(wire.AssignRequest(snapshot_id=sid + "0"))

    class Ctx:
        def __init__(self):
            self.aborted = []

        def abort(self, code, details):
            self.aborted.append(code.name)

        def time_remaining(self):
            return -1.0

    ctx = Ctx()
    with pytest.raises(DeadlineExpired):
        sv.score(wire.ScoreRequest(snapshot_id=sid, top_k=2), ctx)
    with pytest.raises(DeadlineExpired):
        sv.assign(wire.AssignRequest(snapshot_id=sid), ctx)
    assert ctx.aborted == ["DEADLINE_EXCEEDED", "DEADLINE_EXCEEDED"]


def test_open_breaker_serves_degraded_scores_and_refuses_assign():
    """With the breaker open, a Score is served from the brownout cache,
    flagged degraded: a narrower k as a prefix of the cached launch, a
    wider k ranked on the host from the cached full scores; an Assign is
    refused.  The replies equal a healthy servicer's but for the flag."""
    from koordinator_tpu_torch.replication.admission import BreakerOpen

    sv = pinned_servicer("b4ea4e40", breaker_threshold=1, breaker_cooldown_ms=60000)
    healthy = pinned_servicer("b4ea4e40")
    req, sid = _sync_cluster(sv)
    healthy.sync(req)
    sv.score(wire.ScoreRequest(snapshot_id=sid, top_k=4, flat=True))
    sv.breaker.record_failure()
    for k in (2, 8):
        for flat in (True, False):
            stale = sv.score(wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=flat))
            want = healthy.score(wire.ScoreRequest(snapshot_id=sid, top_k=k, flat=flat))
            assert stale.degraded and not want.degraded
            stale.degraded = False
            stale.build_ms = want.build_ms = 0.0
            assert stale == want, (k, flat)
    assert sv.degraded_replies == 4
    with pytest.raises(BreakerOpen):
        sv.assign(wire.AssignRequest(snapshot_id=sid))


def test_concurrent_assigns_share_one_cycle():
    sv = ScorerServicer(device="cpu")
    _, sid = _sync_cluster(sv)
    replies, errors = [], []
    barrier = threading.Barrier(4)

    def worker():
        try:
            barrier.wait(timeout=60)
            replies.append(sv.assign(wire.AssignRequest(snapshot_id=sid)))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors
    assert len({tuple(r.assignment) for r in replies}) == 1
    text = sv.telemetry.metrics.registry.render()
    assert 'koord_scorer_assign_memo_total{result="miss"} 1' in text


def test_read_back_is_one_transfer_of_every_dtype():
    from koordinator_tpu_torch.bridge.server import read_back

    a = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    b = torch.tensor([True, False, True])
    c = torch.tensor([-1, 7], dtype=torch.int32)
    d = torch.tensor(5)
    out = read_back(a, None, b, c, d, 3)
    assert out[1] is None and out[5] == 3
    for got, want in zip((out[0], out[2], out[3], out[4]), (a, b, c, d)):
        assert got.dtype == want.numpy().dtype and got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got, want.numpy())


def test_mesh_is_refused():
    class Mesh:
        size = 8

    # a mesh the port cannot shard over (not a parallel.mesh.Mesh)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ScorerServicer(mesh=Mesh(), device="cpu")


def test_grpc_transport_serves_the_three_rpcs():
    grpc = pytest.importorskip("grpc")
    from koordinator_tpu_torch.bridge.server import SERVICE, make_server

    path = os.path.join(tempfile.mkdtemp(), "scorer.sock")
    server = make_server(servicer=pinned_servicer("0601den0"))
    server.add_insecure_port(f"unix://{path}")
    server.start()
    channel = grpc.insecure_channel(f"unix://{path}")
    try:
        def rpc(name, msg, reply_cls):
            call = channel.unary_unary(
                f"/{SERVICE}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=reply_cls.FromString,
            )
            return call(msg, timeout=120)

        sync = rpc("Sync", wire.SyncRequest.FromString(load("sync_request.bin")),
                   wire.SyncReply)
        assert sync.SerializeToString() == load("sync_reply.bin")
        score = rpc("Score", wire.ScoreRequest.FromString(load("score_request.bin")),
                    wire.ScoreReply)
        score.build_ms = 0.125
        assert score.SerializeToString() == load("score_reply.bin")
        assign = rpc("Assign", wire.AssignRequest.FromString(load("assign_request.bin")),
                     wire.AssignReply)
        assign.cycle_ms = 1.5
        assert assign.SerializeToString() == load("assign_reply.bin")
        with pytest.raises(grpc.RpcError) as err:
            rpc("Assign", wire.AssignRequest(snapshot_id="s00000000-9"), wire.AssignReply)
        assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    finally:
        channel.close()
        server.stop(None)


def test_grpc_transport_without_grpc_raises_a_clear_error(monkeypatch):
    import sys

    from koordinator_tpu_torch.bridge import server as server_mod

    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(RuntimeError, match="raw UDS"):
        server_mod.make_server(servicer=ScorerServicer(device="cpu"))
