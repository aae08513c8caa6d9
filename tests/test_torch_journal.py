"""The port's frame journal (``koordinator_tpu_torch/replication/
journal.py``) on the CPU, against the reference's: the same Syncs write
the same journal bytes in both packages, a journal either package writes
recovers in the other to the same snapshot id and the same replies
(the reference daemon's servicer writes, the port's daemon replays), and
the reference's recovery cases — the warm restart on the same chain,
compaction, every damaged tail, the resume seam — hold in the port.
Epochs and stamps are pinned wherever bytes are compared."""

import os
import struct
import tempfile
import time
import zlib

import numpy as np
import pytest

import koordinator_tpu.obs  # noqa: F401  (before replication: import cycle)
from koordinator_tpu.bridge.codegen import pb2
from koordinator_tpu.bridge.server import ScorerServicer as RefServicer
from koordinator_tpu.replication.journal import FrameJournal as RefJournal

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.client import parse_snapshot_id
from koordinator_tpu_torch.bridge.server import ScorerServicer
from koordinator_tpu_torch.bridge.state import numpy_to_tensor
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.replication import codec
from koordinator_tpu_torch.replication.follower import (
    FollowerServicer,
    ReplicaApplier,
    ReplicationSubscriber,
)
from koordinator_tpu_torch.replication.journal import (
    _REC_HEADER,
    _REC_HEADER_LEN,
    FrameJournal,
)
from koordinator_tpu_torch.replication.leader import ReplicationPublisher

EPOCH = "10a1e001"
WAIT_S = 30.0


def _wait_until(predicate, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _tiny_sync(pods=32, nodes=8, seed=3):
    nodes_l, pods_l, gangs, quotas = generators.quota_colocation(
        seed=seed, pods=pods, nodes=nodes, tenants=2
    )
    req, _ = build_sync_request(nodes_l, pods_l, gangs, quotas)
    usage = np.asarray(
        [res.resource_vector(n.get("usage", {})) for n in nodes_l], dtype=np.int64
    )
    return req, usage


def _warm_usage(prev, bump):
    cur = prev.copy()
    cur.flat[bump % cur.size] += 1 + bump
    warm = wire.SyncRequest()
    warm.nodes.usage.CopyFrom(numpy_to_tensor(cur, prev))
    return warm, cur


def _pin(sv, epoch=EPOCH):
    sv._epoch = epoch
    sv.telemetry.spans.epoch = epoch
    return sv


def _syncs(n):
    """The full Sync and ``n`` warm deltas on top of it."""
    req, prev = _tiny_sync()
    out = [req]
    for i in range(n):
        warm, prev = _warm_usage(prev, i)
        out.append(warm)
    return out


def _journaled(path, syncs=4, compact_every=100, pinned=False):
    """A port servicer with an attached journal after the full Sync and
    ``syncs`` warm deltas.  ``pinned``: fixed epoch and stamps."""
    sv = ScorerServicer(device="cpu", score_memo=False)
    if pinned:
        _pin(sv)
    j = FrameJournal(path, compact_every=compact_every,
                     **({"clock": lambda: 0.0} if pinned else {}))
    j.recover(sv)
    j.attach(sv)
    for msg in _syncs(syncs):
        sv.sync(msg)
    return sv, j


def _ref_journaled(path, syncs=4, compact_every=100):
    sv = _pin(RefServicer(score_memo=False))
    j = RefJournal(path, compact_every=compact_every, clock=lambda: 0.0)
    j.recover(sv)
    j.attach(sv)
    for msg in _syncs(syncs):
        sv.sync(pb2.SyncRequest.FromString(msg.SerializeToString()))
    return sv, j


def _replayed(path, compact_every=100):
    sv = ScorerServicer(device="cpu", score_memo=False)
    j = FrameJournal(path, compact_every=compact_every)
    return sv, j, j.recover(sv)


def _records(path):
    with open(path, "rb") as fh:
        data = fh.read()
    out, off = [], 0
    while off + _REC_HEADER_LEN <= len(data):
        length, _ = struct.unpack_from(_REC_HEADER, data, off)
        end = off + _REC_HEADER_LEN + length
        if end > len(data):
            break
        out.append((off, data[off:end]))
        off = end
    return out


def _score_bytes(sv, sid, request_cls=wire.ScoreRequest):
    reply = sv.score(request_cls(snapshot_id=sid, top_k=8, flat=True))
    reply.build_ms = 0.0
    return reply.SerializeToString()


def _placements(sv, sid, request_cls=wire.AssignRequest):
    reply = sv.assign(request_cls(snapshot_id=sid))
    return list(reply.assignment), list(reply.status)


def _mirrors(sv):
    st = sv.state
    return [np.asarray(getattr(st, k)).tobytes() if getattr(st, k) is not None else None
            for k in ("node_alloc", "node_requested", "node_usage", "pod_requests",
                      "pod_priority", "quota_runtime")] + [st.node_names, st.pod_names]


# -- the same Syncs, the same journal --

@pytest.mark.parametrize("compact_every", [100, 3])
def test_journal_bytes_equal_the_references(tmp_path, compact_every):
    port_path, ref_path = str(tmp_path / "port.krj"), str(tmp_path / "ref.krj")
    sv, j = _journaled(port_path, syncs=7, compact_every=compact_every, pinned=True)
    rsv, rj = _ref_journaled(ref_path, syncs=7, compact_every=compact_every)
    j.close()
    rj.close()
    with open(port_path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    assert sv.snapshot_id() == rsv.snapshot_id()
    assert j.stats()["compactions"] == rj.stats()["compactions"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_journal_recovers_across_packages(tmp_path, writer):
    """One package's journal replays in the other to the same snapshot
    id, and the replies of the recovered servicer equal the writer's."""
    path = str(tmp_path / "journal.krj")
    if writer == "reference":
        src, j = _ref_journaled(path, syncs=4)
        dst, _, stats = _replayed(path)
        src_req, dst_req = (pb2.ScoreRequest, pb2.AssignRequest), (
            wire.ScoreRequest, wire.AssignRequest)
    else:
        src, j = _journaled(path, syncs=4, pinned=True)
        dst = RefServicer(score_memo=False)
        stats = RefJournal(path).recover(dst)
        src_req, dst_req = (wire.ScoreRequest, wire.AssignRequest), (
            pb2.ScoreRequest, pb2.AssignRequest)
    j.close()
    sid = src.snapshot_id()
    assert stats["truncated"] is None and stats["resumed_id"] == sid
    assert stats["replayed_frames"] == 6  # the seeded base and five Syncs
    assert dst.snapshot_id() == sid
    assert _score_bytes(dst, sid, dst_req[0]) == _score_bytes(src, sid, src_req[0])
    assert _placements(dst, sid, dst_req[1]) == _placements(src, sid, src_req[1])


def test_the_reference_daemons_journal_replays_in_the_port_daemon(tmp_path):
    """The reference daemon's servicer writes its journal under its state
    dir; the port's daemon started on that state dir resumes the same
    snapshot id, and its Score and Assign replies over the raw framing
    equal the reference servicer's."""
    from koordinator_tpu.scheduler.server import SchedulerServer as RefServer

    from koordinator_tpu_torch.bridge.client import ScorerClient
    from koordinator_tpu_torch.scheduler.server import SchedulerServer

    import jax

    d = tempfile.mkdtemp(prefix="kj", dir="/tmp")
    state = os.path.join(d, "state")
    # the reference daemon points JAX's compile cache at its state dir
    # unless given one: keep this process's own
    ref_srv = RefServer(lease_path=os.path.join(d, "lease"), uds_path=os.path.join(d, "r.sock"),
                        state_dir=state, journal=True, enable_grpc=False, http_port=0,
                        xla_cache=jax.config.jax_compilation_cache_dir or "")
    ref_srv.start()
    try:
        for msg in _syncs(3):
            ref_srv.servicer.sync(pb2.SyncRequest.FromString(msg.SerializeToString()))
        sid = ref_srv.servicer.snapshot_id()
        want_score = _score_bytes(ref_srv.servicer, sid, pb2.ScoreRequest)
        want_assign = _placements(ref_srv.servicer, sid, pb2.AssignRequest)
    finally:
        ref_srv.stop()
    port_srv = SchedulerServer(lease_path=os.path.join(d, "lease"),
                               uds_path=os.path.join(d, "p.sock"), state_dir=state,
                               journal=True, enable_grpc=False, device="cpu").start()
    cli = ScorerClient(f"raw://{os.path.join(d, 'p.sock.raw')}", rpc_timeout_ms=WAIT_S * 1000)
    try:
        assert port_srv.journal_replay["resumed_id"] == sid
        assert port_srv.servicer.snapshot_id() == sid
        assert _wait_until(lambda: port_srv.elector.is_leader)
        score = cli._scores[0](wire.ScoreRequest(snapshot_id=sid, top_k=8, flat=True),
                               timeout=WAIT_S)
        score.build_ms = 0.0
        assert score.SerializeToString() == want_score
        assign = cli._assigns[0](wire.AssignRequest(snapshot_id=sid), timeout=WAIT_S)
        assert (list(assign.assignment), list(assign.status)) == want_assign
    finally:
        cli.close()
        port_srv.stop()


# -- the round trip --

def test_fresh_journal_seeds_a_base_full_frame(tmp_path):
    path = str(tmp_path / "journal.krj")
    sv = ScorerServicer(device="cpu")
    stats = FrameJournal(path).recover(sv)
    assert stats["replayed_frames"] == 0
    recs = _records(path)
    assert len(recs) == 1
    frame = codec.decode_frame(recs[0][1][_REC_HEADER_LEN:])
    assert frame.kind == codec.KIND_FULL and frame.snapshot_id == sv.snapshot_id()


def test_warm_restart_resumes_the_same_chain(tmp_path):
    path = str(tmp_path / "journal.krj")
    sv, j = _journaled(path)
    sid = sv.snapshot_id()
    j.close()
    sv2, j2, stats = _replayed(path)
    assert stats["truncated"] is None and stats["resumed_id"] == sid
    assert sv2.snapshot_id() == sid and _mirrors(sv2) == _mirrors(sv)
    assert _score_bytes(sv2, sid) == _score_bytes(sv, sid)
    j2.attach(sv2)
    e1, g1 = parse_snapshot_id(sid)
    assert parse_snapshot_id(sv2.sync(wire.SyncRequest()).snapshot_id) == (e1, g1 + 1)


def test_an_empty_delta_journals_the_wire_bytes_and_replays(tmp_path):
    path = str(tmp_path / "journal.krj")
    sv, j = _journaled(path, syncs=0)
    warm = wire.SyncRequest()
    sv.sync(warm, wire_bytes=warm.SerializeToString())
    frame = codec.decode_frame(_records(path)[-1][1][_REC_HEADER_LEN:])
    assert frame.kind == codec.KIND_DELTA and frame.payload == b""
    sid = sv.snapshot_id()
    j.close()
    sv2, _, stats = _replayed(path)
    assert sv2.snapshot_id() == sid and stats["truncated"] is None


def test_stats_and_gauges_move(tmp_path):
    path = str(tmp_path / "journal.krj")
    sv, j = _journaled(path, syncs=3)
    st = j.stats()
    assert (st["appends"], st["generation"]) == (4, 4)
    assert st["bytes"] == os.path.getsize(path)
    render = sv.telemetry.registry.render()
    assert 'koord_scorer_journal_frames_total{op="append"} 4' in render
    assert "koord_scorer_journal_position 4" in render
    assert "koord_scorer_journal_append_us_bucket" in render


def test_compaction_bounds_the_file_and_replays_the_chain(tmp_path):
    path = str(tmp_path / "journal.krj")
    sv, j = _journaled(path, syncs=7, compact_every=3)
    assert j.compactions >= 2
    recs = _records(path)
    assert codec.decode_frame(recs[0][1][_REC_HEADER_LEN:]).kind == codec.KIND_FULL
    assert len(recs) <= 1 + 3 and j.stats()["last_compaction_us"] is not None
    sid = sv.snapshot_id()
    j.close()
    sv2, _, _ = _replayed(path, compact_every=3)
    assert sv2.snapshot_id() == sid and _mirrors(sv2) == _mirrors(sv)


def test_a_snapshot_newer_than_its_tail_drops_the_tail_as_stale(tmp_path):
    path = str(tmp_path / "journal.krj")
    sv, j = _journaled(path, syncs=3)
    sid = sv.snapshot_id()
    recs = _records(path)
    epoch, gen, payload = sv.export_replication_snapshot()
    full = codec.encode_frame(codec.KIND_FULL, epoch, gen, 0, payload)
    with open(path, "wb") as fh:
        fh.write(struct.pack(_REC_HEADER, len(full), zlib.crc32(full)) + full)
        for _, rec in recs[1:]:
            fh.write(rec)
    sv2, _, stats = _replayed(path)
    assert stats["truncated"] is None and stats["stale_frames"] == len(recs) - 1
    assert sv2.snapshot_id() == sid and _score_bytes(sv2, sid) == _score_bytes(sv, sid)


def _truncate_tail(path, recs):
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 7)


def _flip_crc(path, recs):
    off, rec = recs[-2]
    flip = off + len(rec) - 1
    with open(path, "r+b") as fh:
        fh.seek(flip)
        b = fh.read(1)
        fh.seek(flip)
        fh.write(bytes([b[0] ^ 0xFF]))


def _bad_magic(path, recs):
    off, rec = recs[-1]
    frame = bytearray(rec[_REC_HEADER_LEN:])
    frame[0] ^= 0xFF
    with open(path, "r+b") as fh:
        fh.seek(off)
        fh.write(struct.pack(_REC_HEADER, len(frame), zlib.crc32(bytes(frame))) + bytes(frame))


def _absurd_length(path, recs):
    with open(path, "r+b") as fh:
        fh.seek(recs[-1][0])
        fh.write(struct.pack(">I", 0xFFFFFFFF))


def _gap(path, recs):
    off, _ = recs[-2]
    _, rec2 = recs[-1]
    with open(path, "r+b") as fh:
        fh.seek(off)
        fh.write(rec2)
        fh.truncate(off + len(rec2))


# damage -> (the recovery's reason, the records of the valid prefix
# counted back from the end)
DAMAGE = {
    "truncated_tail": (_truncate_tail, ("torn-frame", "torn-header"), 1),
    "flipped_crc_byte": (_flip_crc, ("crc",), 2),
    "bad_magic": (_bad_magic, ("decode",), 1),
    "absurd_record_length": (_absurd_length, ("bad-length",), 1),
    "generation_gap": (_gap, ("gap",), 2),
}


@pytest.mark.parametrize("name", sorted(DAMAGE))
def test_a_damaged_tail_recovers_the_valid_prefix_on_a_fresh_epoch(tmp_path, name):
    """Each damage shape recovers exactly the valid prefix, on a fresh
    epoch at its generation (the truncated tail may have been published),
    and, as in the reference, the daemon keeps serving and journaling
    and a second restart replays cleanly."""
    damage, reasons, dropped = DAMAGE[name]
    path = str(tmp_path / "journal.krj")
    sv, j = _journaled(path, syncs=4)
    recs = _records(path)
    j.close()
    damage(path, recs)
    sv2, j2, stats = _replayed(path)
    assert stats["truncated"] in reasons
    last = codec.decode_frame(recs[len(recs) - dropped - 1][1][_REC_HEADER_LEN:])
    epoch2, gen2 = parse_snapshot_id(sv2.snapshot_id())
    assert gen2 == last.generation and epoch2 != last.epoch
    for _, rec in _records(path):
        codec.decode_frame(rec[_REC_HEADER_LEN:])
    j2.attach(sv2)
    assert _score_bytes(sv2, sv2.snapshot_id())
    sid2 = sv2.sync(wire.SyncRequest()).snapshot_id
    j2.close()
    sv3, _, stats3 = _replayed(path)
    assert stats3["truncated"] is None and sv3.snapshot_id() == sid2
    assert _mirrors(sv3) == _mirrors(sv2)


# -- the resume seam --

def test_frames_since_serves_the_missing_deltas_and_refuses_the_rest(tmp_path):
    sv, j = _journaled(str(tmp_path / "a.krj"), syncs=4)
    epoch, gen = parse_snapshot_id(sv.snapshot_id())
    frames = j.frames_since(epoch, gen - 2)
    assert [codec.decode_frame(f).generation for f in frames] == [gen - 1, gen]
    assert j.frames_since(epoch, gen) == []
    sv, j = _journaled(str(tmp_path / "b.krj"), syncs=7, compact_every=3)
    epoch, gen = parse_snapshot_id(sv.snapshot_id())
    assert j.frames_since(epoch, 0) is None
    assert j.frames_since("ffffffff", gen) is None
    assert j.frames_since(epoch, gen + 5) is None


def test_the_publisher_resumes_a_follower_after_a_warm_restart():
    """Over the socket: a follower holding generation G reconnects after
    the leader's warm restart and receives only the missing deltas — its
    resync count never moves."""
    d = tempfile.mkdtemp(prefix="kj", dir="/tmp")
    path, repl = os.path.join(d, "journal.krj"), os.path.join(d, "l.repl")
    sv, j = _journaled(path, syncs=2)
    pub = ReplicationPublisher(sv, repl, journal=j).attach().start()
    follower = FollowerServicer(device="cpu", score_memo=False)
    applier = ReplicaApplier(follower)
    sub = ReplicationSubscriber(repl, applier).start()
    pub2 = None
    try:
        assert _wait_until(lambda: follower.snapshot_id() == sv.snapshot_id())
        resyncs0 = applier.resyncs
        pub.stop()
        j.close()
        sv2, j2, stats = _replayed(path)
        assert stats["truncated"] is None and sv2.snapshot_id() == sv.snapshot_id()
        j2.attach(sv2)
        pub2 = ReplicationPublisher(sv2, repl, journal=j2).attach().start()
        sid = sv2.sync(wire.SyncRequest()).snapshot_id
        assert _wait_until(lambda: follower.snapshot_id() == sid)
        assert applier.resyncs == resyncs0 and pub2.resumed_subscriptions >= 1
        assert _mirrors(follower) == _mirrors(sv2)
    finally:
        sub.stop()
        pub.stop()
        if pub2 is not None:
            pub2.stop()
