"""The port's replicated serving tier on the CPU, against the reference's:
the ``KRPL`` frame codec (``replication/codec.py``) and its independent
decoder (``bridge/wirecheck.py``) byte for byte on fuzzed frames, the
follower's continuity core (``ReplicaApplier``) under a lossy, reordering
channel with the follower's replies equal to the leader's and to the
reference leader's after every commit, the commit rule under a Score
storm, and the UDS stream both ways between the packages.  Every compared
value is an integer or a byte, so every comparison is exact; epochs are
pinned wherever reply bytes are compared."""

import dataclasses
import os
import socket
import tempfile
import threading
import time

import numpy as np
import pytest

import koordinator_tpu.obs  # noqa: F401  (before replication: import cycle)
from koordinator_tpu.bridge import wirecheck as ref_wirecheck
from koordinator_tpu.bridge.codegen import pb2
from koordinator_tpu.bridge.server import ScorerServicer as RefServicer
from koordinator_tpu.replication import codec as ref_codec
from koordinator_tpu.replication.follower import (
    FollowerServicer as RefFollower,
    ReplicaApplier as RefApplier,
    ReplicationSubscriber as RefSubscriber,
)
from koordinator_tpu.replication.leader import ReplicationPublisher as RefPublisher

from koordinator_tpu_torch.bridge import wire, wirecheck
from koordinator_tpu_torch.bridge.client import RpcError, ScorerClient, parse_snapshot_id
from koordinator_tpu_torch.bridge.coalesce import SnapshotNotResident
from koordinator_tpu_torch.bridge.server import ScorerServicer, StatusCode
from koordinator_tpu_torch.bridge.state import _DELTA_TENSORS, numpy_to_tensor
from koordinator_tpu_torch.bridge.udsserver import RawUdsServer
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.replication import codec
from koordinator_tpu_torch.replication.follower import (
    APPLIED,
    RESYNC,
    STALE,
    FollowerServicer,
    NotLeader,
    ReplicaApplier,
    ReplicationSubscriber,
)
from koordinator_tpu_torch.replication.leader import ReplicationPublisher, _Subscriber

WAIT_S = 30.0


def _wait_until(predicate, timeout_s=WAIT_S, interval_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def _tiny_sync(pods=48, nodes=12, seed=3):
    nodes_l, pods_l, gangs, quotas = generators.quota_colocation(
        seed=seed, pods=pods, nodes=nodes, tenants=2
    )
    req, _ = build_sync_request(nodes_l, pods_l, gangs, quotas)
    usage = np.asarray(
        [res.resource_vector(n.get("usage", {})) for n in nodes_l], dtype=np.int64
    )
    return req, usage


def _pin(sv, epoch):
    sv._epoch = epoch
    sv.telemetry.spans.epoch = epoch
    return sv


def _port(epoch=None, cls=ScorerServicer, **kw):
    sv = cls(device="cpu", score_memo=False, **kw)
    return _pin(sv, epoch) if epoch else sv


def _ref(epoch=None, cls=RefServicer, **kw):
    sv = cls(score_memo=False, **kw)
    return _pin(sv, epoch) if epoch else sv


def _to_pb(msg):
    return pb2.SyncRequest.FromString(msg.SerializeToString())


_MIRROR_KEYS = _DELTA_TENSORS + (
    "node_fresh", "pod_priority", "pod_priority_class", "pod_gang",
    "pod_quota", "gang_min",
)


def _assert_state_parity(leader, follower):
    """The follower's mirrors equal the leader's, and so does its id."""
    assert follower.snapshot_id() == leader.snapshot_id()
    a, b = leader.state, follower.state
    for key in _MIRROR_KEYS:
        va, vb = getattr(a, key), getattr(b, key)
        if va is None or vb is None:
            assert va is None and vb is None, key
        else:
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype and np.array_equal(va, vb), key
    assert (a.node_names, a.pod_names) == (b.node_names, b.pod_names)
    assert (a.node_bucket, a.pod_bucket) == (b.node_bucket, b.pod_bucket)


def _score_bytes(sv, sid, request_cls, top_k=8):
    reply = sv.score(request_cls(snapshot_id=sid, top_k=top_k, flat=True))
    reply.build_ms = 0.0
    return reply.SerializeToString()


def _assign_bytes(sv, sid, request_cls):
    reply = sv.assign(request_cls(snapshot_id=sid, cycle_id="pinned"))
    reply.cycle_ms = 0.0
    return reply.SerializeToString()


def _placements(sv, sid, request_cls):
    reply = sv.assign(request_cls(snapshot_id=sid, cycle_id="pinned"))
    return list(reply.assignment), list(reply.status)


def _capture_frames(leader, mod=codec):
    """A replication hook recording the frames a publisher would send."""
    frames = []

    def hook(req, snapshot_id, wire_bytes=None):
        epoch, gen = parse_snapshot_id(snapshot_id)
        frames.append(mod.Frame(
            kind=mod.KIND_DELTA, epoch=epoch, generation=gen, stamp_us=0,
            payload=wire_bytes if wire_bytes is not None else req.SerializeToString(),
        ))

    leader.replication_hook = hook
    return frames


def _full_frame(leader, mod=codec):
    epoch, gen, payload = leader.export_replication_snapshot()
    return mod.Frame(kind=mod.KIND_FULL, epoch=epoch, generation=gen, stamp_us=0,
                     payload=payload)


def _warm_usage(prev, bump):
    cur = prev.copy()
    cur.flat[bump % cur.size] += 1 + bump
    warm = wire.SyncRequest()
    warm.nodes.usage.CopyFrom(numpy_to_tensor(cur, prev))
    return warm, cur


# -- the frame codec, byte for byte --

def _fuzzed_frame(rng):
    kind = int(rng.choice([codec.KIND_DELTA, codec.KIND_FULL, codec.KIND_HELLO,
                           codec.KIND_FULL_Z]))
    epoch = "".join(rng.choice(list("0123456789abcdef"), 8))
    gen = int(rng.integers(0, 2**63))
    stamp = int(rng.integers(0, 2**63))
    payload = rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
    return kind, epoch, gen, stamp, payload


@pytest.mark.parametrize("seed", range(8))
def test_frames_are_byte_identical_and_each_decoder_reads_the_others(seed):
    rng = np.random.default_rng(seed)
    for _ in range(16):
        kind, epoch, gen, stamp, payload = _fuzzed_frame(rng)
        raw = codec.encode_frame(kind, epoch, gen, stamp, payload)
        assert raw == ref_codec.encode_frame(kind, epoch, gen, stamp, payload)
        want = (kind, epoch, gen, stamp, payload)
        for decode in (codec.decode_frame, ref_codec.decode_frame):
            f = decode(raw)
            assert (f.kind, f.epoch, f.generation, f.stamp_us, f.payload) == want
        doc = wirecheck.decode_replica_frame(raw)
        assert doc == ref_wirecheck.decode_replica_frame(raw)
        assert (doc["kind"], doc["epoch"], doc["generation"], doc["stamp_us"],
                doc["payload"]) == want
        assert wirecheck.encode_replica_frame(doc) == raw
        header, plen = codec.decode_header(raw[:codec.HEADER_LEN])
        assert plen == len(payload) and header.snapshot_id == f"s{epoch}-{gen}"
    blob = rng.integers(0, 4, 4096, dtype=np.uint8).tobytes()
    z = codec.compress_payload(blob)
    assert z == ref_codec.compress_payload(blob)
    assert codec.decompress_payload(z) == blob


def _mutations():
    good = codec.encode_frame(codec.KIND_DELTA, "abcdef01", 7, 9, b"payload")
    return {
        "bad_magic": b"\x00" + good[1:],
        "bad_version": good[:4] + b"\x09" + good[5:],
        "bad_kind": good[:5] + b"\x07" + good[6:],
        "short_header": good[:codec.HEADER_LEN - 1],
        "short_payload": good[:-1],
        "long_payload": good + b"x",
        "non_ascii_epoch": good[:6] + b"\xff" * 8 + good[14:],
        "oversized_len": good[:30] + (codec.MAX_PAYLOAD + 1).to_bytes(4, "big"),
    }


@pytest.mark.parametrize("name", sorted(_mutations()))
def test_every_decoder_refuses_what_the_reference_refuses(name):
    raw = _mutations()[name]
    with pytest.raises(codec.FrameError):
        codec.decode_frame(raw)
    with pytest.raises(ref_codec.FrameError):
        ref_codec.decode_frame(raw)
    with pytest.raises(ValueError):
        wirecheck.decode_replica_frame(raw)


@pytest.mark.parametrize("args", [
    (codec.KIND_DELTA, "short", 1), (9, "abcdef01", 1), (codec.KIND_DELTA, "abcdef01", -1),
], ids=["epoch_length", "kind", "negative_generation"])
def test_encode_refuses_what_the_reference_refuses(args):
    kind, epoch, gen = args
    with pytest.raises(codec.FrameError):
        codec.encode_frame(kind, epoch, gen, 0, b"")
    with pytest.raises(ref_codec.FrameError):
        ref_codec.encode_frame(kind, epoch, gen, 0, b"")


# -- the continuity core --

def _pair():
    req, usage = _tiny_sync()
    leader = _port("1eade401")
    frames = _capture_frames(leader)
    leader.sync(req)
    follower = _port(cls=FollowerServicer)
    applier = ReplicaApplier(follower)
    assert applier.offer(_full_frame(leader)) == APPLIED
    _assert_state_parity(leader, follower)
    return leader, frames, follower, applier, usage


def test_in_order_stream_applies_and_duplicates_are_stale():
    leader, frames, follower, applier, prev = _pair()
    for i in range(3):
        warm, prev = _warm_usage(prev, i)
        leader.sync(warm)
        assert applier.offer(frames[-1]) == APPLIED
        _assert_state_parity(leader, follower)
    sid = follower.snapshot_id()
    assert applier.offer(frames[-1]) == STALE
    assert follower.snapshot_id() == sid


@pytest.mark.parametrize("fault", ["gap", "epoch", "corrupt_payload"])
def test_a_discontinuity_resyncs_and_never_tears(fault):
    leader, frames, follower, applier, prev = _pair()
    warm, prev = _warm_usage(prev, 0)
    leader.sync(warm)
    if fault == "gap":
        warm, prev = _warm_usage(prev, 1)
        leader.sync(warm)
        bad = frames[-1]
    elif fault == "epoch":
        bad = dataclasses.replace(frames[-1], epoch="ffffffff")
    else:
        bad = dataclasses.replace(frames[-1], payload=b"\xff\xfe\xfd" + frames[-1].payload[:7])
    before_sid = follower.snapshot_id()
    before = _score_bytes(follower, before_sid, wire.ScoreRequest)
    assert applier.offer(bad) == RESYNC
    assert follower.snapshot_id() == before_sid
    assert _score_bytes(follower, before_sid, wire.ScoreRequest) == before
    assert applier.offer(_full_frame(leader)) == APPLIED
    _assert_state_parity(leader, follower)
    render = follower.telemetry.registry.render()
    reason = {"corrupt_payload": "apply"}.get(fault, fault)
    assert f'koord_scorer_replica_resyncs_total{{reason="{reason}"}} 1' in render


def test_no_change_sync_replicates_as_an_empty_delta():
    leader, frames, follower, applier, _ = _pair()
    leader.sync(wire.SyncRequest())
    assert frames[-1].payload == b""
    assert applier.offer(frames[-1]) == APPLIED
    _assert_state_parity(leader, follower)


def test_fresh_follower_resyncs_a_delta_before_its_first_full():
    req, _ = _tiny_sync()
    leader = _port()
    frames = _capture_frames(leader)
    leader.sync(req)
    assert ReplicaApplier(_port(cls=FollowerServicer)).offer(frames[-1]) == RESYNC


def test_export_equals_the_reference_export_and_reproduces_the_mirrors():
    """The full frame's payload is the reference's byte for byte, and
    either package's follower rebuilds the leader's state from it."""
    req, _ = _tiny_sync()
    leader, ref_leader = _port("e0e0e0e0"), _ref("e0e0e0e0")
    leader.sync(req)
    ref_leader.sync(_to_pb(req))
    ours, theirs = leader.export_replication_snapshot(), ref_leader.export_replication_snapshot()
    assert ours == theirs
    follower = _port(cls=FollowerServicer)
    assert ReplicaApplier(follower).offer(_full_frame(ref_leader, ref_codec)) == APPLIED
    _assert_state_parity(leader, follower)
    sid = leader.snapshot_id()
    assert _score_bytes(follower, sid, wire.ScoreRequest) == \
        _score_bytes(ref_leader, sid, pb2.ScoreRequest)
    assert _placements(follower, sid, wire.AssignRequest) == \
        _placements(ref_leader, sid, pb2.AssignRequest)
    empty = _port("00000000").export_replication_snapshot()
    assert empty == ("00000000", 0, b"")


def test_follower_refuses_a_client_sync_with_the_one_writer_text(tmp_path):
    """Directly and through the raw framing, where the port's client
    classifies the refusal by its text."""
    req, _ = _tiny_sync()
    follower = _port(cls=FollowerServicer, leader="ldr.repl")
    with pytest.raises(NotLeader, match="one writer"):
        follower.sync(req)
    path = tempfile.mktemp(prefix="kf", dir="/tmp")
    srv = RawUdsServer(path, servicer=follower).start()
    cli = ScorerClient(f"raw://{path}", rpc_timeout_ms=WAIT_S * 1000)
    try:
        with pytest.raises(RpcError) as ei:
            cli._sync(req, timeout=WAIT_S)
        assert ei.value.code() == StatusCode.FAILED_PRECONDITION
        assert "one writer" in ei.value.details()
    finally:
        cli.close()
        srv.stop()


class _FuzzChannel:
    """A lossy transport: every frame may be dropped, duplicated, or
    delayed behind the next one."""

    def __init__(self, rng):
        self.rng = rng
        self.delayed = []

    def send(self, frame):
        out = []
        roll = self.rng.random()
        if roll < 0.15:
            pass
        elif roll < 0.30:
            out += [frame, frame]
        elif roll < 0.50:
            self.delayed.append(frame)
        else:
            out.append(frame)
        if self.delayed and self.rng.random() < 0.6:
            out.append(self.delayed.pop(0))
        return out

    def flush(self):
        out, self.delayed = self.delayed, []
        return out


def test_lossy_channel_follower_replies_equal_the_leaders_and_the_references():
    """24 warm and scalar Syncs through a lossy, reordering, duplicating
    channel, with a leader restart (a new epoch) halfway: after every
    commit the follower — through the documented resync when the chain
    broke — has the leader's mirrors and id, and its Score and Assign
    reply bytes equal the leader's and the reference leader's."""
    rng = np.random.default_rng(7)
    req, prev = _tiny_sync()
    epochs = iter(["f0220001", "f0220002"])
    epoch = next(epochs)
    leader, ref_leader = _port(epoch), _ref(epoch)
    frames = _capture_frames(leader)
    follower = _port(cls=FollowerServicer)
    applier = ReplicaApplier(follower)
    chan = _FuzzChannel(rng)
    leader.sync(req)
    ref_leader.sync(_to_pb(req))
    resyncs = 0
    for step in range(24):
        if step == 12:
            # leader restart: new servicers on a fresh epoch, rebuilt
            # from a full client Sync of the same state
            full = leader.state.export_sync_request()
            epoch = next(epochs)
            leader, ref_leader = _port(epoch), _ref(epoch)
            frames = _capture_frames(leader)
            leader.sync(full)
            ref_leader.sync(_to_pb(full))
        elif step % 7 == 3:
            msg = wire.SyncRequest()
            msg.pods.priority.extend(
                int(v) for v in rng.integers(0, 9000, leader.state.pod_requests.shape[0]))
            leader.sync(msg)
            ref_leader.sync(_to_pb(msg))
        else:
            msg, prev = _warm_usage(prev, int(rng.integers(0, 64)))
            leader.sync(msg)
            ref_leader.sync(_to_pb(msg))
        need_resync = False
        for frame in (chan.send(frames[-1]) if frames else []) + chan.flush():
            if applier.offer(frame) == RESYNC:
                need_resync = True
        if need_resync or follower.snapshot_id() != leader.snapshot_id():
            resyncs += 1
            assert applier.offer(_full_frame(leader)) == APPLIED
        _assert_state_parity(leader, follower)
        sid = leader.snapshot_id()
        assert ref_leader.snapshot_id() == sid
        score = _score_bytes(follower, sid, wire.ScoreRequest)
        assert score == _score_bytes(leader, sid, wire.ScoreRequest)
        assert score == _score_bytes(ref_leader, sid, pb2.ScoreRequest)
        if step % 4 == 0:
            assign = _assign_bytes(follower, sid, wire.AssignRequest)
            assert assign == _assign_bytes(leader, sid, wire.AssignRequest)
            assert _placements(follower, sid, wire.AssignRequest) == \
                _placements(ref_leader, sid, pb2.AssignRequest)
    assert resyncs > 0 and applier.applied > 0


def test_score_storm_across_replica_deltas_equals_serial_replies():
    """The commit rule on a follower: delta frames write into the
    resident tensors while four threads Score; every Score that its
    snapshot id admits equals the serial reply at that generation."""
    req, prev = _tiny_sync()
    leader = _port("57042a01")
    frames = _capture_frames(leader)
    leader.sync(req)
    full = _full_frame(leader)
    serial = {leader.snapshot_id(): _score_bytes(leader, leader.snapshot_id(),
                                                  wire.ScoreRequest)}
    for i in range(10):
        warm, prev = _warm_usage(prev, 3 * i)
        leader.sync(warm)
        sid = leader.snapshot_id()
        serial[sid] = _score_bytes(leader, sid, wire.ScoreRequest)
    deltas = frames[1:]  # the full frame holds the first
    follower = FollowerServicer(device="cpu")  # memo and incremental rescore on
    applier = ReplicaApplier(follower)
    assert applier.offer(full) == APPLIED
    seen, errors = {}, []
    done = threading.Event()

    def reader():
        while not done.is_set():
            sid = follower.snapshot_id()
            try:
                got = _score_bytes(follower, sid, wire.ScoreRequest)
            except SnapshotNotResident:
                continue  # a delta committed between the id and the launch
            except Exception as exc:  # reported below
                errors.append(exc)
                return
            if got != serial[sid]:
                errors.append(AssertionError(f"reply at {sid} differs"))
            seen[sid] = seen.get(sid, 0) + 1

    threads = [threading.Thread(target=reader, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for frame in deltas:
            time.sleep(0.02)
            assert applier.offer(frame) == APPLIED
        assert _wait_until(lambda: seen.get(follower.snapshot_id(), 0) > 0)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=WAIT_S)
    assert not errors, errors[:3]
    assert len(seen) >= 3 and follower.snapshot_id() == leader.snapshot_id()


# -- the UDS stream --

def _short_dir():
    return tempfile.mkdtemp(prefix="kr", dir="/tmp")


def test_subscription_streams_full_then_deltas_and_reconnects():
    d = _short_dir()
    req, prev = _tiny_sync()
    leader = _port()
    pub = ReplicationPublisher(leader, os.path.join(d, "l.repl")).attach().start()
    follower = _port(cls=FollowerServicer)
    applier = ReplicaApplier(follower)
    sub = ReplicationSubscriber(pub.path, applier).start()
    try:
        leader.sync(req)
        for i in range(3):
            warm, prev = _warm_usage(prev, i)
            leader.sync(warm)
        assert _wait_until(lambda: follower.snapshot_id() == leader.snapshot_id())
        _assert_state_parity(leader, follower)
        assert applier.last_lag_ms is not None and pub.follower_count() == 1
        connects = sub.connects
        with pub._lock:
            subs = list(pub._subs)
        for s in subs:
            s.close()
        warm, prev = _warm_usage(prev, 5)
        leader.sync(warm)
        assert _wait_until(lambda: follower.snapshot_id() == leader.snapshot_id())
        _assert_state_parity(leader, follower)
        assert sub.connects > connects
    finally:
        sub.stop()
        pub.stop()


def test_truncated_stream_counts_an_error_and_resyncs():
    d = _short_dir()
    path = os.path.join(d, "l.repl")
    req, _ = _tiny_sync()
    leader = _port()
    leader.sync(req)
    lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lsock.bind(path)
    lsock.listen(1)
    served = threading.Event()

    def fake_leader():
        conn, _ = lsock.accept()
        frame = codec.encode_frame(codec.KIND_FULL, "abcdef01", 1, 0, b"x" * 64)
        conn.sendall(frame[:codec.HEADER_LEN + 10])
        conn.close()
        served.set()

    threading.Thread(target=fake_leader, daemon=True).start()
    follower = _port(cls=FollowerServicer)
    sub = ReplicationSubscriber(path, ReplicaApplier(follower)).start()
    pub = None
    try:
        assert served.wait(timeout=WAIT_S)
        lsock.close()
        os.unlink(path)
        pub = ReplicationPublisher(leader, path).attach().start()
        assert _wait_until(lambda: follower.snapshot_id() == leader.snapshot_id())
        _assert_state_parity(leader, follower)
        assert 'koord_scorer_replica_frames_total{result="error"}' in \
            follower.telemetry.registry.render()
    finally:
        sub.stop()
        if pub is not None:
            pub.stop()


def test_an_overflowed_subscriber_is_dropped_without_blocking():
    a, b = socket.socketpair()
    dropped = []
    sub = _Subscriber(a, max_frames=2, on_drop=dropped.append)
    try:
        sub.enqueue(b"1")
        sub.enqueue(b"2")
        assert not dropped
        sub.enqueue(b"3")
        assert dropped == [sub]
        sub.enqueue(b"4")
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("direction", ["reference_leader_to_port_follower",
                                       "port_leader_to_reference_follower"])
def test_the_stream_crosses_packages_over_a_uds(direction):
    """A reference ReplicationPublisher feeds a port ReplicationSubscriber
    (and the other way round) in one process: the full opening frame
    (zlib on the wire), then warm deltas; the follower's Score and Assign
    replies then equal the leader's."""
    d = _short_dir()
    req, prev = _tiny_sync()
    if direction.startswith("reference"):
        leader, pub_cls, sync_msg = _ref(), RefPublisher, _to_pb
        follower, app_cls, sub_cls = _port(cls=FollowerServicer), ReplicaApplier, \
            ReplicationSubscriber
        req_mod, f_mod = pb2, wire
    else:
        leader, pub_cls, sync_msg = _port(), ReplicationPublisher, (lambda m: m)
        follower, app_cls, sub_cls = _ref(cls=RefFollower), RefApplier, RefSubscriber
        req_mod, f_mod = wire, pb2
    pub = pub_cls(leader, os.path.join(d, "l.repl")).attach().start()
    applier = app_cls(follower)
    sub = sub_cls(pub.path, applier).start()
    try:
        # subscribed at generation 0 (an empty full frame), so every Sync
        # below crosses as a delta frame
        assert _wait_until(lambda: follower.snapshot_id() == leader.snapshot_id())
        leader.sync(sync_msg(req))
        for i in range(3):
            warm, prev = _warm_usage(prev, i)
            leader.sync(sync_msg(warm))
        assert _wait_until(lambda: follower.snapshot_id() == leader.snapshot_id())
        sid = leader.snapshot_id()
        assert applier.applied == 5
        assert _score_bytes(follower, sid, f_mod.ScoreRequest) == \
            _score_bytes(leader, sid, req_mod.ScoreRequest)
        assert _placements(follower, sid, f_mod.AssignRequest) == \
            _placements(leader, sid, req_mod.AssignRequest)
    finally:
        sub.stop()
        pub.stop()


def test_the_replication_package_imports_first_where_the_references_cannot():
    """``import <package>.replication`` as a process's first import: the
    reference's fails on the cycle obs -> scorer_metrics ->
    replication.admission -> obs; the port's imports (its metrics module
    imports the admission helper where it is used)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = {
        pkg: subprocess.run([sys.executable, "-c", f"import {pkg}.replication"], cwd=repo,
                            capture_output=True, text=True, timeout=300)
        for pkg in ("koordinator_tpu_torch", "koordinator_tpu")
    }
    assert runs["koordinator_tpu_torch"].returncode == 0, runs["koordinator_tpu_torch"].stderr
    assert runs["koordinator_tpu"].returncode != 0
    assert "circular import" in runs["koordinator_tpu"].stderr
