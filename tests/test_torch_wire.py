"""The port's wire codec (``koordinator_tpu_torch/bridge/wire.py``) against
the golden fixtures and the protobuf runtime, byte for byte.

Every value on the wire is an integer, a string or bytes, so the tolerance
is zero: decoded values equal, re-encoded bytes identical."""

import json
import os
import socket
import struct
import tempfile

import numpy as np
import pytest

from koordinator_tpu.bridge.codegen import pb2
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.state import decode_tensor, numpy_to_tensor

TESTDATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "go", "scorerclient", "testdata",
)

FIXTURES = {
    "sync_request.bin": wire.SyncRequest,
    "sync_reply.bin": wire.SyncReply,
    "score_request.bin": wire.ScoreRequest,
    "score_reply.bin": wire.ScoreReply,
    "assign_request.bin": wire.AssignRequest,
    "assign_reply.bin": wire.AssignReply,
    "plugin_sync1_request.bin": wire.SyncRequest,
    "plugin_sync1_reply.bin": wire.SyncReply,
    "plugin_sync2_request.bin": wire.SyncRequest,
    "plugin_sync2_reply.bin": wire.SyncReply,
    "plugin_score2_request.bin": wire.ScoreRequest,
    "plugin_score2_reply.bin": wire.ScoreReply,
    "empty_name_request.bin": wire.SyncRequest,
}


def load(name: str) -> bytes:
    with open(os.path.join(TESTDATA, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(TESTDATA, "expected.json")) as f:
        return json.load(f)


def test_every_fixture_is_covered():
    bins = sorted(f for f in os.listdir(TESTDATA) if f.endswith(".bin"))
    assert bins == sorted(FIXTURES)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_round_trips_byte_for_byte(name):
    raw = load(name)
    msg = FIXTURES[name].FromString(raw)
    assert msg.SerializeToString() == raw
    # the protobuf runtime decodes the port's bytes to the same message
    ref_cls = getattr(pb2, type(msg).__name__)
    assert ref_cls.FromString(raw).SerializeToString() == raw


def tensor_json(t):
    return {"shape": list(t.shape), "data": np.frombuffer(t.data, "<i8").tolist()}


def flat_json(reply):
    f = reply.flat
    return {
        "pod_index": np.frombuffer(f.pod_index, "<i4").tolist(),
        "counts": np.frombuffer(f.counts, "<i4").tolist(),
        "node_index": np.frombuffer(f.node_index, "<i4").tolist(),
        "score": np.frombuffer(f.score, "<i8").tolist(),
    }


def test_sync_request_values(expected):
    want = expected["sync_request"]
    req = wire.SyncRequest.FromString(load("sync_request.bin"))
    assert req.node_bucket == want["node_bucket"]
    assert req.pod_bucket == want["pod_bucket"]
    assert req.trace_id == want["trace_id"]
    assert req.parent_span == want["parent_span"]
    n, p = req.nodes, req.pods
    assert list(n.names) == want["nodes"]["names"]
    assert list(n.metric_fresh) == want["nodes"]["metric_fresh"]
    for key in ("allocatable", "requested", "usage"):
        assert tensor_json(getattr(n, key)) == want["nodes"][key], key
    assert list(p.names) == want["pods"]["names"]
    for key in ("requests", "estimated"):
        assert tensor_json(getattr(p, key)) == want["pods"][key], key
    for key in ("priority", "gang_id", "quota_id", "priority_class"):
        assert list(getattr(p, key)) == want["pods"][key], key
    assert list(req.gangs.min_member) == want["gangs"]["min_member"]
    for key in ("runtime", "used", "limited"):
        assert tensor_json(getattr(req.quotas, key)) == want["quotas"][key], key


def test_score_and_assign_values(expected):
    sreq = wire.ScoreRequest.FromString(load("score_request.bin"))
    assert sreq.top_k == expected["top_k"] and sreq.flat
    for key, value in expected["score_request"].items():
        assert getattr(sreq, key) == value, key
    sync = wire.SyncReply.FromString(load("sync_reply.bin"))
    for key, value in expected["sync_reply"].items():
        assert getattr(sync, key) == value, key
    score = wire.ScoreReply.FromString(load("score_reply.bin"))
    assert score.HasField("flat") and not score.pods
    assert flat_json(score) == expected["score_reply"]
    assert score.build_ms == 0.125
    assert score.server_span == expected["score_reply_server_span"]
    areq = wire.AssignRequest.FromString(load("assign_request.bin"))
    for key, value in expected["assign_request"].items():
        assert getattr(areq, key) == value, key
    arep = wire.AssignReply.FromString(load("assign_reply.bin"))
    for key, value in expected["assign_reply"].items():
        got = getattr(arep, key)
        assert (list(got) if isinstance(value, list) else got) == value, key
    assert arep.cycle_ms == 1.5


def test_plugin_flow_values(expected):
    want = expected["plugin_flow"]
    for n in (1, 2):
        req = wire.SyncRequest.FromString(load(f"plugin_sync{n}_request.bin"))
        assert list(req.pods.names) == [want[f"pod{n}"]]
        assert np.frombuffer(req.pods.requests.data, "<i8").tolist() == want["pod_vec"]
        assert list(req.nodes.metric_fresh) == want[f"fresh{n}"]
        rep = wire.SyncReply.FromString(load(f"plugin_sync{n}_reply.bin"))
        for key, value in want[f"sync{n}_reply"].items():
            assert getattr(rep, key) == value, key
    assert list(wire.SyncRequest.FromString(
        load("plugin_sync1_request.bin")).nodes.names) == want["names"]
    # the warm request rides deltas against sync 1's node table
    warm = wire.SyncRequest.FromString(load("plugin_sync2_request.bin"))
    assert not warm.nodes.names and warm.nodes.requested.delta_idx
    score = wire.ScoreReply.FromString(load("plugin_score2_reply.bin"))
    assert flat_json(score) == want["score2_reply"]
    empty = wire.SyncRequest.FromString(load("empty_name_request.bin"))
    assert list(empty.pods.names) == expected["empty_name"]["pod_names"]


# -- seeded random messages against the protobuf runtime --

def _rand_str(rng):
    return "".join(chr(c) for c in rng.randint(0x20, 0x7F, rng.randint(0, 12)))


def _rand_ints(rng, n, bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    vals = rng.randint(-1000, 1000, n).tolist()
    # the edges of the type and the varint length steps
    edges = [lo, hi, -1, 0, 127, 128, 16383, 16384]
    return [edges[i % len(edges)] if rng.rand() < 0.2 else v
            for i, v in enumerate(vals)]


def _fill(rng, ours, ref, depth=0):
    """Set the same random values on a port message and a pb2 message,
    field by field (each field set with probability 0.7)."""
    for _, name, kind, cls in type(ours).FIELDS:
        if rng.rand() > 0.7:
            continue
        if kind == "message":
            if depth < 3:
                _fill(rng, getattr(ours, name), getattr(ref, name), depth + 1)
            getattr(ours, name).SetInParent()
            getattr(ref, name).SetInParent()
        elif kind == "repeated message":
            for _ in range(rng.randint(0, 4)):
                _fill(rng, getattr(ours, name).add(), getattr(ref, name).add(),
                      depth + 1)
        elif kind.startswith("repeated"):
            elem = kind.split()[1]
            n = rng.randint(0, 9)
            if elem == "string":
                vals = [_rand_str(rng) for _ in range(n)]
            elif elem == "bool":
                vals = [bool(b) for b in rng.rand(n) > 0.5]
            else:
                vals = _rand_ints(rng, n, 64 if elem == "int64" else 32)
            getattr(ours, name).extend(vals)
            getattr(ref, name).extend(vals)
        else:
            if kind == "string":
                value = _rand_str(rng)
            elif kind == "bytes":
                value = rng.bytes(rng.randint(0, 20))
            elif kind == "bool":
                value = bool(rng.rand() > 0.5)
            elif kind == "double":
                value = float(rng.choice([0.0, -0.0, 0.125, 1.5, rng.randn() * 1e3]))
            else:
                value = _rand_ints(rng, 1, 64 if kind == "int64" else 32)[0]
            setattr(ours, name, value)
            setattr(ref, name, value)


@pytest.mark.parametrize("cls", wire.MESSAGES, ids=lambda c: c.__name__)
@pytest.mark.parametrize("seed", range(4))
def test_random_messages_encode_like_protobuf(cls, seed):
    rng = np.random.RandomState(seed * 97 + len(cls.__name__))
    for _ in range(8):
        ours, ref = cls(), getattr(pb2, cls.__name__)()
        _fill(rng, ours, ref)
        raw = ref.SerializeToString()
        assert ours.SerializeToString() == raw
        # and each side decodes the other's bytes to the same message
        assert cls.FromString(raw).SerializeToString() == raw
        assert cls.FromString(raw) == ours


def test_packed_varints_match_the_scalar_codec():
    rng = np.random.RandomState(3)
    vals = np.concatenate([rng.randint(-2**62, 2**62, 200, dtype=np.int64),
                           np.asarray([0, 1, -1, 127, 128, 2**63 - 1, -2**63])])
    packed = wire.pack_varints(vals)
    out = bytearray()
    for v in vals.tolist():
        wire.append_varint(out, v)
    assert packed == bytes(out)
    assert wire.unpack_varints(packed).tolist() == vals.tolist()


def test_message_presence_follows_the_runtime():
    """A sub-message is written once a write touched it, even when empty,
    and reading never makes it present — the runtime's rules."""
    for build in (
        lambda m: setattr(m.flat, "pod_index", b""),
        lambda m: m.pods.add(),
        lambda m: None,
        lambda m: m.flat.SetInParent(),
    ):
        ours, ref = wire.ScoreReply(), pb2.ScoreReply()
        build(ours)
        build(ref)
        _ = ours.flat.counts  # a read
        assert ours.SerializeToString() == ref.SerializeToString()
    ours, ref = wire.SyncRequest(), pb2.SyncRequest()
    ours.nodes.names.extend([])
    ref.nodes.names.extend([])
    ours.quotas.used.CopyFrom(wire.Tensor())
    ref.quotas.used.CopyFrom(pb2.Tensor())
    assert ours.SerializeToString() == ref.SerializeToString()


# -- negatives (the reference's tests/test_wirecheck.py, against the port) --

@pytest.mark.parametrize("raw,match", [
    (b"\x80", "truncated varint"),
    (b"\x0a\x64ab", "truncated length-delimited"),
    (b"\x0b", "unsupported wire type"),
    (b"\x09\x01\x02", "truncated fixed64"),
    (b"\x0d\x01", "truncated fixed32"),
])
def test_malformed_fields_rejected(raw, match):
    with pytest.raises(ValueError, match=match):
        wire.split_fields(raw)
    with pytest.raises(ValueError, match=match):
        wire.SyncRequest.FromString(raw)


@pytest.mark.parametrize("raw", [b"\x00\x00", b"\x02\x00", b"\x0a\x02\x00\x00"])
def test_field_number_zero_rejected_as_the_runtime_rejects_it(raw):
    """Field number 0 is reserved: the protobuf runtime refuses a message
    holding one, at any depth, and so does the codec (a flipped byte of a
    replication frame can make one)."""
    with pytest.raises(Exception):
        pb2.SyncRequest.FromString(raw)
    with pytest.raises(ValueError, match="field number 0"):
        wire.SyncRequest.FromString(raw)


def test_varint_overflow_rejected():
    with pytest.raises(ValueError, match="varint overflow"):
        wire.read_varint(b"\xff" * 11, 0)
    with pytest.raises(ValueError, match="varint overflow"):
        wire.unpack_varints(b"\xff" * 10 + b"\x01")
    with pytest.raises(ValueError, match="truncated varint"):
        wire.unpack_varints(b"\x01\x80")


def test_wrong_wire_type_for_a_field_rejected():
    # AssignRequest.snapshot_id (field 1, a string) sent as a varint
    with pytest.raises(ValueError, match="wire type"):
        wire.AssignRequest.FromString(b"\x08\x01")


def test_uds_frame_header_negatives():
    """An unknown method answers status 1 and keeps serving; a payload that
    does not decode answers status 1; an oversized length claim answers
    'frame too large' without buffering it."""
    from koordinator_tpu_torch.bridge.udsserver import (
        _MAX_FRAME, METHOD_SYNC, RawUdsServer,
    )

    path = os.path.join(tempfile.mkdtemp(), "scorer.sock")
    srv = RawUdsServer(path, device="cpu").start()
    try:
        def recv_exact(conn, n):
            buf = b""
            while len(buf) < n:
                chunk = conn.recv(n - len(buf))
                if not chunk:
                    raise AssertionError("server closed without a reply")
                buf += chunk
            return buf

        def recv_reply(conn):
            status, length = struct.unpack(">BI", recv_exact(conn, 5))
            return status, recv_exact(conn, length)

        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(30)
        conn.connect(path)
        try:
            conn.sendall(struct.pack(">BI", 99, 0))
            status, payload = recv_reply(conn)
            assert status == 1 and b"unknown method 99" in payload
            conn.sendall(struct.pack(">BI", METHOD_SYNC, 3) + b"\xff\xff\xff")
            status, _ = recv_reply(conn)
            assert status == 1
            conn.sendall(struct.pack(">BI", METHOD_SYNC, _MAX_FRAME + 1))
            status, payload = recv_reply(conn)
            assert status == 1 and b"frame too large" in payload
        finally:
            conn.close()
    finally:
        srv.stop()
    metrics = srv.servicer.telemetry.metrics.registry.render()
    assert 'reason="unknown-method"' in metrics
    assert 'reason="oversized"' in metrics


def _delta(idx, val, shape=None):
    t = wire.Tensor()
    if shape:
        t.shape.extend(shape)
    t.delta_idx = np.asarray(idx, "<i8").tobytes()
    t.delta_val = np.asarray(val, "<i8").tobytes()
    return t


@pytest.mark.parametrize("t,base,match", [
    (_delta([0], [7], shape=[2, 13]), np.zeros((4, 13), np.int64), "delta shape"),
    (_delta([0], [7]), None, "without a resident tensor"),
    (_delta([0, 1], [7]), np.zeros((4, 13), np.int64), "length mismatch"),
    (_delta([52], [7]), np.zeros((4, 13), np.int64), "out of range"),
    (_delta([-1], [7]), np.zeros((4, 13), np.int64), "out of range"),
    (_delta([3, 3], [7, 8]), np.zeros((4, 13), np.int64), "duplicate"),
])
def test_bad_delta_rejected(t, base, match):
    with pytest.raises(ValueError, match=match):
        decode_tensor(t, base)


def test_numpy_to_tensor_matches_the_reference():
    from koordinator_tpu.bridge.state import numpy_to_tensor as ref_encode

    rng = np.random.RandomState(11)
    prev = rng.randint(0, 100, (16, 13)).astype(np.int64)
    for changed in (0, 1, 20, 52, 53, 200):
        nxt = prev.copy()
        nxt.reshape(-1)[rng.choice(prev.size, changed, replace=False)] += 1
        for base in (prev, None):
            assert (numpy_to_tensor(nxt, base).SerializeToString()
                    == ref_encode(nxt, base).SerializeToString())
