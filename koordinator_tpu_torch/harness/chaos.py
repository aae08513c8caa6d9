"""Chaos fault-injection harness for the serving tier.

Counterpart of ``koordinator_tpu/harness/chaos.py``, with the same names:
composable faults against the replication and journal machinery, and the
invariant checkers that make a chaos run a test instead of a demo.

Faults (compose freely through :class:`FaultPlan` probabilities plus the
explicit methods):

* **drop / duplicate / reorder** replication frames (:class:`ChaosChannel`);
* **corrupt / truncate** frame bytes (the follower must classify every
  mutation as a discontinuity, never apply it; it does for a truncation,
  but a frame carries no checksum, in the reference too, so a flipped
  byte of a delta's values applies: ROADMAP Queue C);
* **kill the leader** (:meth:`ChaosTier.crash_leader` drops the leader
  object with no cleanup, the in-process equivalent of ``kill -9``; the
  journal file keeps only what reached the OS) and **warm-restart** it
  from the journal, or **promote a follower**;
* **stall a follower** (frames buffer; delivered late, they must apply or
  drop as stale, never double-apply);
* **fail a device launch mid-batch** (:func:`fail_next_launch` poisons the
  dispatcher's next launch) or its readback (:func:`fail_next_readback`);
* **truncate the journal tail** (:meth:`ChaosTier.damage_journal`, the
  torn-write crash shape).

Invariants (raise AssertionError with the failing detail):

* **byte parity against an unfaulted oracle**: leader mirrors and
  flat-Score reply bytes equal the oracle's after every converged step,
  and every caught-up follower equals the leader;
* **no torn snapshot**: a frame that did not apply leaves the follower's
  observable state byte-identical to before the offer (checked on every
  delivery, not just at the end);
* **no warm-path cold event**: ``analysis/retrace_guard.py`` holds the
  post-recovery warm stream at zero kernel builds and zero ladder
  demotions;
* **bounded recovery**: kill to serving wall time under a caller-set
  budget.

Every servicer runs on ``device`` (default CUDA, raising when absent;
``"cpu"`` runs the plain path).  :class:`ChaosTraceReplay` serves over
``transport="raw"`` (the raw framing, no gRPC) unless ``"grpc"`` is asked
for; :func:`overload_band_storm` over the raw framing.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import os
import tempfile
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from koordinator_tpu_torch.bridge import state as _bridge_state
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.server import ScorerServicer
from koordinator_tpu_torch.obs.lockwitness import witness_lock
from koordinator_tpu_torch.replication import codec
from koordinator_tpu_torch.replication.follower import (
    APPLIED,
    RESYNC,
    FollowerServicer,
    ReplicaApplier,
)
from koordinator_tpu_torch.replication.journal import FrameJournal

# mirror keys asserted byte-identical between replicas (shared here so the
# chaos checks and the replication tests never drift on what "parity"
# means)
MIRROR_KEYS = _bridge_state._DELTA_TENSORS + (
    "node_fresh", "pod_priority", "pod_priority_class", "pod_gang",
    "pod_quota", "gang_min",
)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class FaultPlan:
    """Per-frame fault probabilities for a :class:`ChaosChannel`."""

    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0
    truncate: float = 0.0


class ChaosChannel:
    """Lossy, reordering, corrupting transport between a leader's frame
    stream and one follower.  Operates on encoded frame bytes so
    corruption and truncation hit the real wire surface."""

    def __init__(self, rng, plan: FaultPlan):
        self.rng = rng
        self.plan = plan
        self.delayed: List[bytes] = []
        self.injected = {"drop": 0, "duplicate": 0, "reorder": 0,
                         "corrupt": 0, "truncate": 0}

    def _mutate(self, raw: bytes) -> bytes:
        roll = self.rng.random()
        if roll < self.plan.corrupt and len(raw) > codec.HEADER_LEN:
            self.injected["corrupt"] += 1
            i = int(self.rng.integers(0, len(raw)))
            b = bytearray(raw)
            b[i] ^= 0xFF
            return bytes(b)
        if roll < self.plan.corrupt + self.plan.truncate and len(raw) > 1:
            self.injected["truncate"] += 1
            return raw[: int(self.rng.integers(1, len(raw)))]
        return raw

    def send(self, raw: bytes) -> List[bytes]:
        out: List[bytes] = []
        roll = self.rng.random()
        if roll < self.plan.drop:
            self.injected["drop"] += 1
        elif roll < self.plan.drop + self.plan.duplicate:
            self.injected["duplicate"] += 1
            out += [self._mutate(raw), self._mutate(raw)]
        elif roll < self.plan.drop + self.plan.duplicate + self.plan.reorder:
            self.injected["reorder"] += 1
            self.delayed.append(raw)
        else:
            out.append(self._mutate(raw))
        if self.delayed and self.rng.random() < 0.6:
            out.append(self.delayed.pop(0))
        return out

    def flush(self) -> List[bytes]:
        out, self.delayed = self.delayed, []
        return out


@contextmanager
def fail_next_launch(servicer, n: int = 1,
                     exc_factory=lambda: RuntimeError("chaos: injected device launch failure")):
    """Poison the next ``n`` coalesced launches on ``servicer``: the
    dispatcher's launch callable raises before touching the device.  The
    dispatcher must route the failure to the batch's callers and keep
    serving afterwards: the fault a flaky device injects mid-batch."""
    dispatch = servicer.dispatch
    real = dispatch._launch_batch
    remaining = [int(n)]

    def poisoned(batch):
        if remaining[0] > 0:
            remaining[0] -= 1
            raise exc_factory()
        return real(batch)

    dispatch._launch_batch = poisoned
    try:
        yield
    finally:
        dispatch._launch_batch = real


@contextmanager
def fail_next_readback(servicer, n: int = 1,
                       exc_factory=lambda: RuntimeError("chaos: injected device readback failure")):
    """Poison the next ``n`` coalesced readbacks: the launch half succeeds
    (the work is enqueued on the device) but the readback closure raises,
    the fault surface asynchronous launches expose, where a failing device
    program reports at the readback rather than at enqueue.  The circuit
    breaker must count these exactly like launch-half failures."""
    dispatch = servicer.dispatch
    real = dispatch._launch_batch
    remaining = [int(n)]

    def poisoned(batch):
        readback = real(batch)
        if (
            readback is None
            or getattr(readback, "no_device", False)
            or remaining[0] <= 0
        ):
            return readback
        remaining[0] -= 1

        def bad_readback():
            raise exc_factory()

        return bad_readback

    dispatch._launch_batch = poisoned
    try:
        yield
    finally:
        dispatch._launch_batch = real


def flat_score_bytes(sv, sid: str, top_k: int = 8) -> bytes:
    reply = sv.score(
        wire.ScoreRequest(snapshot_id=sid, top_k=top_k, flat=True)
    )
    return reply.flat.SerializeToString()


def state_digest(sv) -> str:
    """Order-stable digest of every replicated mirror: the cheap
    every-delivery torn-snapshot probe (``flat_score_bytes`` is the
    expensive reply-surface check run at checkpoints)."""
    h = hashlib.sha256()
    st = sv.state
    for key in MIRROR_KEYS:
        v = getattr(st, key)
        h.update(key.encode())
        if v is None:
            h.update(b"\x00")
        else:
            a = _host(v)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    h.update(repr(st.node_names).encode())
    h.update(repr(st.pod_names).encode())
    h.update(sv.snapshot_id().encode())
    return h.hexdigest()


def assert_mirror_parity(a_sv, b_sv, ids: bool = True) -> None:
    if ids:
        assert b_sv.snapshot_id() == a_sv.snapshot_id(), (
            f"snapshot ids diverged: {a_sv.snapshot_id()} vs "
            f"{b_sv.snapshot_id()}"
        )
    a, b = a_sv.state, b_sv.state
    for key in MIRROR_KEYS:
        va, vb = getattr(a, key), getattr(b, key)
        if va is None or vb is None:
            assert va is None and vb is None, f"{key}: {va!r} vs {vb!r}"
        else:
            va, vb = _host(va), _host(vb)
            assert va.dtype == vb.dtype, key
            assert np.array_equal(va, vb), f"mirror {key} diverged"
    assert a.node_names == b.node_names
    assert a.pod_names == b.pod_names
    assert a.node_bucket == b.node_bucket
    assert a.pod_bucket == b.pod_bucket


class _Follower:
    __slots__ = ("servicer", "applier", "channel", "stalled", "buffer")

    def __init__(self, servicer, applier, channel):
        self.servicer = servicer
        self.applier = applier
        self.channel = channel
        self.stalled = False
        self.buffer: List[bytes] = []


class ChaosTier:
    """One in-process serving tier under fault injection: a journaled
    leader, N followers behind chaos channels, and an unfaulted oracle
    replaying the same Sync stream.

    The tier checks the no-torn-snapshot invariant on every delivery: an
    offer that does not return APPLIED must leave the follower's state
    digest untouched.  ``converge()`` then brings every follower to the
    leader (the documented one-shot full resync where needed) and asserts
    full byte parity against leader and oracle.  ``device``: where every
    servicer keeps its resident snapshot (default CUDA).
    """

    def __init__(
        self,
        state_dir: str,
        followers: int = 1,
        plan: Optional[FaultPlan] = None,
        seed: int = 0,
        compact_every: int = 256,
        servicer_kw: Optional[dict] = None,
        device=None,
    ):
        from koordinator_tpu_torch import resolve_device

        self.state_dir = state_dir
        self.journal_path = os.path.join(state_dir, "journal.krj")
        self.compact_every = compact_every
        self.plan = plan or FaultPlan()
        self.rng = np.random.default_rng(seed)
        self.servicer_kw = dict(servicer_kw or {})
        self.servicer_kw.setdefault("score_memo", False)
        self.servicer_kw["device"] = resolve_device(
            device if device is not None else self.servicer_kw.get("device")
        )
        self.leader = ScorerServicer(**self.servicer_kw)
        self.journal = FrameJournal(
            self.journal_path, compact_every=compact_every
        )
        self.journal.recover(self.leader)
        self.journal.attach(self.leader)
        self._capture_frames(self.leader)
        self.oracle = ScorerServicer(**self.servicer_kw)
        self.followers: List[_Follower] = []
        for _ in range(int(followers)):
            sv = FollowerServicer(**self.servicer_kw)
            self.followers.append(_Follower(
                sv, ReplicaApplier(sv),
                ChaosChannel(self.rng, self.plan),
            ))
        self.resyncs = 0
        self.torn_checks = 0
        self.stats: Dict[str, int] = {"syncs": 0, "delivered": 0}
        for f in self.followers:
            self._resync(f)

    # -- leader plumbing --
    def _capture_frames(self, leader) -> None:
        from koordinator_tpu_torch.bridge.client import parse_snapshot_id

        self._frames: List[bytes] = []

        def hook(req, snapshot_id, wire_bytes=None):
            epoch, gen = parse_snapshot_id(snapshot_id)
            payload = (
                wire_bytes if wire_bytes is not None
                else req.SerializeToString()
            )
            self._frames.append(codec.encode_frame(
                codec.KIND_DELTA, epoch, gen,
                int(time.time() * 1e6), payload,
            ))

        leader.replication_hook = hook

    def full_frame_bytes(self) -> bytes:
        epoch, gen, payload = self.leader.export_replication_snapshot()
        return codec.encode_frame(
            codec.KIND_FULL, epoch, gen, int(time.time() * 1e6), payload
        )

    # -- the write stream --
    def sync(self, req: "wire.SyncRequest", oracle: bool = True) -> str:
        """One committed Sync on leader (and oracle), frames delivered to
        every follower through its chaos channel."""
        if oracle:
            self.oracle.sync(wire.SyncRequest.FromString(
                req.SerializeToString()
            ))
        sid = self.leader.sync(req).snapshot_id
        self.stats["syncs"] += 1
        frame = self._frames[-1] if self._frames else None
        for f in self.followers:
            if frame is not None:
                self._deliver(f, self.channel_out(f, frame))
        return sid

    def channel_out(self, f: _Follower, frame: bytes) -> List[bytes]:
        out = f.channel.send(frame)
        if f.stalled:
            f.buffer.extend(out)
            return []
        return out

    def _deliver(self, f: _Follower, raws: List[bytes]) -> None:
        for raw in raws:
            self.stats["delivered"] += 1
            before = state_digest(f.servicer)
            self.torn_checks += 1
            try:
                frame = codec.decode_frame(raw)
            except codec.FrameError:
                # the transport layer's contract: counted, then a resync
                assert state_digest(f.servicer) == before, (
                    "TORN SNAPSHOT: a malformed frame mutated state"
                )
                self._resync(f)
                continue
            result = f.applier.offer(frame)
            after = state_digest(f.servicer)
            if result == APPLIED:
                continue
            assert after == before, (
                f"TORN SNAPSHOT: offer({result}) mutated follower state"
            )
            if result == RESYNC:
                self._resync(f)

    def _resync(self, f: _Follower) -> None:
        self.resyncs += 1
        assert f.applier.offer(
            codec.decode_frame(self.full_frame_bytes())
        ) == APPLIED

    # -- explicit faults --
    def stall_follower(self, i: int) -> None:
        self.followers[i].stalled = True

    def unstall_follower(self, i: int) -> None:
        f = self.followers[i]
        f.stalled = False
        buffered, f.buffer = f.buffer, []
        self._deliver(f, buffered)

    def crash_leader(self) -> None:
        """The in-process kill: no stop(), no flush, no close; the object
        graph just dies.  Only what the journal already wrote to the OS
        survives (FrameJournal flushes per append, the kill -9
        durability contract)."""
        self.leader = None
        self.journal = None

    def restart_leader(self) -> dict:
        """Warm-restart from the journal; returns the replay stats.  The
        restarted leader must resume the same s<epoch>-<gen> chain the
        journal holds."""
        assert self.leader is None, "crash_leader first"
        t0 = time.perf_counter()
        self.leader = ScorerServicer(**self.servicer_kw)
        self.journal = FrameJournal(
            self.journal_path, compact_every=self.compact_every
        )
        stats = self.journal.recover(self.leader)
        self.journal.attach(self.leader)
        self._capture_frames(self.leader)
        stats["recovery_ms"] = (time.perf_counter() - t0) * 1000.0
        # the subscription handshake's fallback, mirrored: a follower whose
        # position the restarted leader cannot extend (a torn tail rewound
        # the journal behind the follower) must full-resync, exactly what
        # the leader answers a non-coverable hello with.  Without this a
        # rewound leader re-mints generation numbers the follower already
        # holds with different content: the one fork the epoch fence
        # cannot see.
        from koordinator_tpu_torch.bridge.client import parse_snapshot_id

        l_epoch, l_gen = parse_snapshot_id(self.leader.snapshot_id())
        for f in self.followers:
            f_epoch, f_gen = f.applier.position()
            if f_epoch != l_epoch or f_gen > l_gen:
                self._resync(f)
        return stats

    def promote(self, i: int) -> str:
        """Promote follower ``i`` to the writer role: it bumps its epoch,
        opens its own journal (seeded with a full-state frame) and takes
        over the frame stream; the old leader (typically already crashed)
        is forgotten."""
        f = self.followers.pop(i)
        sid = f.servicer.promote()
        self.leader = f.servicer
        self.journal = FrameJournal(
            self.journal_path + ".promoted",
            compact_every=self.compact_every,
        )
        epoch, gen, payload = self.leader.export_replication_snapshot()
        self.journal.write_base(epoch, gen, payload)
        self.journal.attach(self.leader)
        self._capture_frames(self.leader)
        # surviving followers fence on the new epoch at their next frame;
        # resync them through the documented one-shot path now
        for other in self.followers:
            self._resync(other)
        return sid

    def damage_journal(self, cut_bytes: int = 7) -> None:
        """Tear the journal tail (the mid-append crash shape)."""
        size = os.path.getsize(self.journal_path)
        with open(self.journal_path, "r+b") as fh:
            fh.truncate(max(0, size - cut_bytes))

    # -- invariants --
    def converge(self) -> None:
        """Bring every follower to the leader's exact state (the
        documented resync where the chain broke) and assert byte parity:
        follower == leader mirrors and ids, leader == oracle mirrors and
        flat-Score reply bytes."""
        for f in self.followers:
            if f.stalled:
                continue
            self._deliver(f, f.channel.flush())
            if f.servicer.snapshot_id() != self.leader.snapshot_id():
                self._resync(f)
            assert_mirror_parity(self.leader, f.servicer)
        assert_mirror_parity(self.oracle, self.leader, ids=False)
        sid = self.leader.snapshot_id()
        want = flat_score_bytes(self.oracle, self.oracle.snapshot_id())
        assert flat_score_bytes(self.leader, sid) == want, (
            "leader flat-Score bytes diverged from the unfaulted oracle"
        )
        for f in self.followers:
            if f.stalled:
                continue
            assert flat_score_bytes(f.servicer, sid) == want, (
                "follower flat-Score bytes diverged from the oracle"
            )


# ---------------------------------------------------------------------------
# chaos x trace: the two harnesses compose.  The trace generator provides
# the multi-tenant event stream (harness/trace.py), the chaos harness the
# faults, and obs/slo.py judges the result: robustness is measured, not
# asserted.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChaosTraceReport:
    """Outcome of one chaos x trace replay.  ``registry`` holds the
    ``koord_scorer_trace_cycle_ms`` observations (per-band and per-RPC step
    latencies plus the ``rpc="recovery"`` observation) the SLO gate
    judges; ``parity_ok`` is the post-convergence digest comparison
    against the unfaulted oracle; ``retraces`` counts the kernel ladder
    demotions and ``builds`` the kernel builds observed after recovery
    (``analysis/retrace_guard.py``).  ``dead_leader_collected``: the
    killed leader's servicer was garbage-collected, its raw server thread
    joined, before the restart bound the socket (None: no kill)."""

    events_replayed: int
    rpc_errors: int
    degraded_replies: int
    breaker_trips: int
    recovery_ms: Optional[float]
    parity_ok: bool
    parity_detail: str
    retraces: int
    shed_by_band: Dict[str, int]
    registry: object
    bands: List[str]
    builds: int = 0
    dead_leader_collected: Optional[bool] = None


def _serve(transport: str, sv, sock: str):
    """Start ``sv`` on ``sock``: (client target, stop, server thread or
    None)."""
    if transport == "raw":
        from koordinator_tpu_torch.bridge.client import RAW_SCHEME
        from koordinator_tpu_torch.bridge.udsserver import RawUdsServer

        server = RawUdsServer(sock, servicer=sv).start()
        return RAW_SCHEME + sock, server.stop, server._thread
    from koordinator_tpu_torch.bridge.server import make_server

    if os.path.exists(sock):
        os.unlink(sock)
    server = make_server(servicer=sv)
    server.add_insecure_port(f"unix://{sock}")
    server.start()
    # stop() returns at once; its event is set once the server let go
    return f"unix://{sock}", lambda: server.stop(0).wait(10.0), None


class ChaosTraceReplay:
    """Replay a :class:`harness.trace.Trace` through the full serving path
    (the delta-encoding ``ScorerClient`` over a unix socket into the
    coalescer) on a journaled leader while chaos injects faults
    mid-replay:

    * at event ``fail_at`` the next ``fail_n`` device launches are
      poisoned (:func:`fail_next_launch`): the circuit breaker must trip,
      brownout must serve bounded-staleness Scores with the ``degraded``
      flag, and a half-open probe must recover;
    * at event ``kill_at`` the leader is killed in-process (server
      stopped, object graph dropped: only OS-flushed journal bytes
      survive) and warm-restarted from the journal on the same socket;
      ``recovery_ms`` is the client-observed wall time from the kill to
      the next acknowledged RPC, and the post-recovery tail of the replay
      must hold zero kernel builds and zero ladder demotions;
    * ``unrecovered=True`` is the gate's inverse control: the launch
      poison never lifts, so the run ends with the breaker open, recovery
      unmeasured and parity broken; the SLO gate must fail on this run.

    After the last event both sides converge and the engine's flat Score
    and Assign reply digests are compared against an unfaulted serialized
    oracle replaying the identical stream.

    ``transport``: ``"raw"`` (default) serves both sides through
    ``RawUdsServer`` and dials ``raw://``; ``"grpc"`` through
    ``make_server`` (needs the ``grpc`` package).  ``device``: where both
    servicers keep their resident snapshots (default CUDA)."""

    def __init__(
        self,
        trace,
        state_dir: str,
        fail_at: Optional[int] = None,
        fail_n: int = 4,
        kill_at: Optional[int] = None,
        unrecovered: bool = False,
        servicer_kw: Optional[dict] = None,
        retry_policy=None,
        warmup: bool = True,
        trace_export: Optional[str] = None,
        device=None,
        transport: str = "raw",
    ):
        """``trace_export``: export directory for the distributed-trace
        spans of the engine side: the client, the leader and its
        warm-restarted successor all append there, so ``obs.assemble``
        over the one directory reconstructs every client-observed RPC
        across the kill.  The oracle stays untraced."""
        from koordinator_tpu_torch import resolve_device
        from koordinator_tpu_torch.harness.trace import TRANSPORTS

        if transport not in TRANSPORTS:
            raise ValueError(
                f"transport must be one of {TRANSPORTS}, got {transport!r}"
            )
        self.trace = trace
        self.state_dir = state_dir
        self.trace_export = trace_export
        self.fail_at = fail_at
        self.fail_n = int(fail_n)
        self.kill_at = kill_at
        self.unrecovered = bool(unrecovered)
        self.device = resolve_device(device)
        self.transport = transport
        self.servicer_kw = dict(servicer_kw or {})
        # fast breaker recovery by default: the replay is serial, so a long
        # cooldown just stalls the stream between events
        self.servicer_kw.setdefault("breaker_cooldown_ms", 100.0)
        # the replay is write-heavy (one Sync per Score, unlike a real
        # read-dominated tier), so every faulted event ages the brownout
        # cache one generation; a wider default bound keeps the brownout
        # leg exercisable (production keeps the tight default)
        self.servicer_kw.setdefault("brownout_max_lag", 6)
        self.retry_policy = retry_policy
        self.warmup = bool(warmup)
        self.journal_path = os.path.join(state_dir, "journal.krj")

    # -- leader lifecycle (the in-process kill and warm restart) --
    def _start_leader(self, sock: str):
        # each leader incarnation (the warm restart included) opens its
        # own export file in the shared directory; False pins tracing off
        # when the harness was not asked for it
        kw = dict(self.servicer_kw, device=self.device)
        kw.setdefault("trace_export", self.trace_export or False)
        sv = ScorerServicer(**kw)
        journal = FrameJournal(self.journal_path)
        journal.recover(sv)
        journal.attach(sv)
        target, stop, thread = _serve(self.transport, sv, sock)
        return sv, journal, target, stop, thread

    def run(self) -> ChaosTraceReport:
        from koordinator_tpu_torch.analysis.retrace_guard import retrace_guard
        from koordinator_tpu_torch.bridge.client import ScorerClient
        from koordinator_tpu_torch.harness.trace import (
            BANDS,
            ClusterModel,
            INFRA_BAND,
            ORACLE_KW,
            TraceReplay,
        )
        from koordinator_tpu_torch.obs.scorer_metrics import ScorerMetrics
        from koordinator_tpu_torch.replication.retry import BackoffPolicy

        if self.warmup:
            # one untimed, unfaulted pass over the identical stream
            # (TraceReplay's own warm-up): every kernel and route the trace
            # reaches is built before the measured chaos pass, so the
            # post-recovery tail can be held at zero builds and demotions
            TraceReplay(
                self.trace, engine_kw=self.servicer_kw, warmup=False,
                device=self.device, transport=self.transport,
            )._replay_once(record=False)

        trace = self.trace
        metrics = ScorerMetrics()
        policy = self.retry_policy or BackoffPolicy(
            base_ms=20.0, cap_ms=250.0, deadline_ms=20_000.0
        )
        rpc_errors = 0
        degraded = 0
        recovery_ms: Optional[float] = None
        retraces = 0
        builds = 0
        shed_by_band: Dict[str, int] = {}
        breaker_trips = 0
        poison_handle = None
        collected: Optional[bool] = None

        with tempfile.TemporaryDirectory(prefix="koord-chaos-trace-") as tmp:
            sock = os.path.join(tmp, "engine.sock")
            osock = os.path.join(tmp, "oracle.sock")
            leader, journal, target, stop, thread = self._start_leader(sock)
            # the oracle scores under the engine's CycleConfig (fused
            # scoring terms included) or a term-enabled chaos replay would
            # fail parity by construction
            oracle_kw = dict(ORACLE_KW, device=self.device)
            if "cfg" in self.servicer_kw:
                oracle_kw["cfg"] = self.servicer_kw["cfg"]
            oracle_sv = ScorerServicer(trace_export=False, **oracle_kw)
            otarget, ostop, _ = _serve(self.transport, oracle_sv, osock)
            engine = ScorerClient(
                target, retry_policy=policy,
                trace_export=self.trace_export or False,
            )
            oracle = ScorerClient(
                otarget, retry_policy=policy, trace_export=False,
            )
            try:
                model = ClusterModel(trace.init)
                full_kw = dict(
                    node_allocatable=model.nalloc,
                    node_requested=model.nreq,
                    node_usage=model.nuse,
                    metric_fresh=list(model.fresh),
                    pod_requests=model.preq,
                    pod_estimated=model.pest,
                    priority=list(model.priority),
                    gang_id=list(model.gang_id),
                    quota_id=list(model.quota_id),
                    gang_min_member=list(model.gang_min),
                    quota_runtime=model.qrt,
                    quota_used=model.quse,
                    quota_limited=model.qlim,
                )
                if model.tput is not None:
                    full_kw.update(
                        node_accel_type=list(model.accel),
                        workload_class=list(model.wclass),
                        pod_sensitivity=model.sens,
                        throughput=model.tput,
                    )
                k = trace.config.top_k
                engine.sync(**full_kw)
                oracle.sync(**full_kw)
                engine.score_flat(top_k=k)
                engine.assign()
                oracle.score_flat(top_k=k)
                oracle.assign()

                guard_from = (
                    None if self.kill_at is None or self.unrecovered
                    else min(len(trace.events), self.kill_at + 2)
                )
                guard = None
                counter = None
                try:
                    for i, event in enumerate(trace.events):
                        if self.fail_at is not None and i == self.fail_at:
                            n = (10 ** 9 if self.unrecovered
                                 else self.fail_n)
                            poison_handle = fail_next_launch(leader, n=n)
                            poison_handle.__enter__()
                        if (
                            self.kill_at is not None
                            and not self.unrecovered
                            and i == self.kill_at
                        ):
                            # the in-process kill: stop the transport, drop
                            # the object graph; only what the journal
                            # flushed to the OS survives.  Then
                            # warm-restart on the same socket and measure
                            # kill -> first acknowledged client RPC.  The
                            # dying leader's ladder stats must survive it
                            # (the restart zeroes them).
                            breaker_trips += leader.breaker.stats()["trips"]
                            for b, n in leader.admission.stats()[
                                "shed_by_band"
                            ].items():
                                shed_by_band[b] = (
                                    shed_by_band.get(b, 0) + n
                                )
                            degraded += leader.degraded_replies
                            t_kill = time.perf_counter()
                            stop()
                            # drain the dying leader's span exporter before
                            # dropping the object graph: every reply the
                            # client observed had its server span enqueued
                            # first, and the writer thread must not leak
                            leader.telemetry.close()
                            if poison_handle is not None:
                                # the poison belongs to the dead leader's
                                # dispatcher and dies with it
                                poison_handle.__exit__(None, None, None)
                                poison_handle = None
                            dead = weakref.ref(leader)
                            leader = journal = stop = None
                            collected = self._bury(dead, thread)
                            thread = None
                            (leader, journal, target, stop,
                             thread) = self._start_leader(sock)
                            engine.score_flat(top_k=k)  # retries ride it out
                            recovery_ms = (
                                time.perf_counter() - t_kill
                            ) * 1000.0
                            metrics.observe_trace_cycle(
                                INFRA_BAND, "recovery", recovery_ms
                            )
                        if guard_from is not None and i == guard_from:
                            # count-only (the caller asserts on the
                            # report): a huge budget never raises, so
                            # teardown still runs on a faulted replay
                            guard = retrace_guard(budget=10 ** 9)
                            counter = guard.__enter__()
                        changed = model.apply(event)
                        kw = TraceReplay._sync_kwargs(model, changed)
                        engine.band = event.band if event.band in BANDS else ""
                        t0 = time.perf_counter()
                        engine.sync(**kw)
                        t_sync = time.perf_counter()
                        # client-level read retries, the production shape
                        # (a failed Score is re-issued at once): consecutive
                        # failures trip the breaker, and the retry after
                        # the trip is the request the brownout cache
                        # answers with the degraded flag
                        for _ in range(4):
                            try:
                                engine.score_flat(top_k=k)
                                break
                            except Exception:  # koordlint: disable=broad-except(faulted-window RPC failures are the scenario under test: counted, the replay continues)
                                rpc_errors += 1
                        t_score = time.perf_counter()
                        try:
                            engine.assign()
                        except Exception:  # koordlint: disable=broad-except(faulted-window RPC failures are the scenario under test: counted, the replay continues)
                            rpc_errors += 1
                        t_assign = time.perf_counter()
                        oracle.sync(**kw)
                        sync_ms = (t_sync - t0) * 1000.0
                        score_ms = (t_score - t_sync) * 1000.0
                        assign_ms = (t_assign - t_score) * 1000.0
                        for rpc, ms in (
                            ("sync", sync_ms), ("score", score_ms),
                            ("assign", assign_ms),
                            ("cycle", sync_ms + score_ms + assign_ms),
                        ):
                            metrics.observe_trace_cycle(
                                event.band, rpc, ms
                            )
                finally:
                    if guard is not None:
                        guard.__exit__(None, None, None)
                        retraces = counter.traces
                        builds = counter.compiles
                if leader is not None:
                    breaker_trips += leader.breaker.stats()["trips"]
                    for b, n in leader.admission.stats()[
                        "shed_by_band"
                    ].items():
                        shed_by_band[b] = shed_by_band.get(b, 0) + n
                    degraded += leader.degraded_replies

                # post-convergence parity against the unfaulted oracle: flat
                # Score and Assign reply digests must be identical once the
                # stream has drained and the breaker has recovered
                parity_ok, parity_detail = True, ""
                try:
                    engine.band = ""
                    d_e = TraceReplay._digest(
                        engine.score_flat(top_k=k), engine.assign()
                    )
                    if engine.last_degraded:
                        parity_ok = False
                        parity_detail = (
                            "final engine reply still degraded "
                            "(breaker never recovered)"
                        )
                    d_o = TraceReplay._digest(
                        oracle.score_flat(top_k=k), oracle.assign()
                    )
                    if parity_ok and d_e != d_o:
                        parity_ok = False
                        parity_detail = (
                            f"post-convergence digest {d_e[:16]} != "
                            f"oracle {d_o[:16]}"
                        )
                except Exception as exc:  # an unconverged engine is the failing-parity outcome this control measures
                    parity_ok = False
                    parity_detail = f"convergence probe failed: {exc!r:.200}"
            finally:
                if poison_handle is not None:
                    poison_handle.__exit__(None, None, None)
                engine.close()
                oracle.close()
                stop()
                ostop()
                # drain the surviving leader's (and the oracle's) span
                # writers: the caller assembles the export directory right
                # after run() returns
                for sv in (leader, oracle_sv):
                    if sv is not None:
                        sv.telemetry.close()

        return ChaosTraceReport(
            events_replayed=len(trace.events),
            rpc_errors=rpc_errors,
            degraded_replies=degraded,
            breaker_trips=breaker_trips,
            recovery_ms=recovery_ms,
            parity_ok=parity_ok,
            parity_detail=parity_detail,
            retraces=retraces,
            shed_by_band=shed_by_band,
            registry=metrics.registry,
            bands=trace.bands(),
            builds=builds,
            dead_leader_collected=collected,
        )

    @staticmethod
    def _bury(dead, thread, timeout_s: float = 10.0) -> bool:
        """Wait, within ``timeout_s``, until the stopped leader's server
        thread has ended and its servicer (``dead``, a weak reference) has
        been collected with its resident device tensors: the warm restart
        must recover from the journal alone.  True when both happened."""
        deadline = time.monotonic() + timeout_s
        if thread is not None:
            thread.join(timeout_s)
        while True:
            gc.collect()
            if dead() is None and (thread is None or not thread.is_alive()):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)


def chaos_trace_slo_specs(bands, recovery_slo_ms: Optional[float] = None):
    """The chaos x trace gate's declarative spec set: the trace gate's
    per-band cycle p99s plus a recovery-time SLO over the
    ``rpc="recovery"`` observation (no recovery measured = no data = a
    failed verdict: a gate that cannot see recovery is a failed gate)."""
    from koordinator_tpu_torch.harness.trace import default_slo_specs
    from koordinator_tpu_torch.obs.scorer_metrics import TRACE_CYCLE
    from koordinator_tpu_torch.obs.slo import SloSpec

    # `or`: empty env value means unset (the KOORD_* convention)
    if recovery_slo_ms is None:
        recovery_slo_ms = float(
            os.environ.get("KOORD_CHAOS_RECOVERY_SLO_MS") or "5000"
        )
    specs = default_slo_specs(bands)
    specs.append(SloSpec(
        name="recovery-p99",
        family=TRACE_CYCLE,
        quantile=0.99,
        threshold_ms=float(recovery_slo_ms),
        labels={"rpc": "recovery"},
    ))
    return specs


def overload_band_storm(
    max_inflight: int = 3,
    free_threads: int = 4,
    prod_threads: int = 2,
    reps: int = 24,
    launch_delay_ms: float = 15.0,
    top_k: int = 4,
    nodes: int = 16,
    pods: int = 32,
    device=None,
) -> dict:
    """Drive a mixed-band Score storm into an admission-gated servicer and
    report what the band ladder did with it: under overload, free-band
    sheds absorb the pressure while prod-band p99 stays within its SLO.

    Free-band clients outnumber prod clients and every launch carries an
    injected ``launch_delay_ms`` (the trace harness's slow-stage idiom) so
    the in-flight population actually reaches the ladder.  Returns
    per-band client-observed p99s (estimated by the same obs/slo.py bucket
    quantiles the gate uses), shed counts by band, and raw success and
    shed tallies."""
    from koordinator_tpu_torch import resolve_device
    from koordinator_tpu_torch.bridge.client import ScorerClient
    from koordinator_tpu_torch.harness.trace import (
        ClusterModel, TraceConfig, _build_init, slow_stage,
    )
    from koordinator_tpu_torch.obs.scorer_metrics import ScorerMetrics, TRACE_CYCLE
    from koordinator_tpu_torch.obs.slo import histogram_quantile
    from koordinator_tpu_torch.replication.retry import BackoffPolicy

    rng = np.random.default_rng(7)
    cfg = TraceConfig(nodes=nodes, pod_slots=pods, gangs=2,
                      gang_min_member=2)
    init = _build_init(cfg, rng)
    model = ClusterModel(init)
    sv = ScorerServicer(
        max_inflight=max_inflight,
        breaker_threshold=0,  # isolate the ladder from the breaker
        score_memo=False,     # memo hits would dodge the launch delay
        score_incr=False,
        device=resolve_device(device),
    )
    metrics = ScorerMetrics()
    results = {"ok": {}, "shed": {}, "errors": 0}
    results_lock = witness_lock(
        "harness.chaos.overload_band_storm.results_lock")

    with tempfile.TemporaryDirectory(prefix="koord-band-storm-") as tmp:
        target, stop, _ = _serve("raw", sv, os.path.join(tmp, "storm.sock"))
        try:
            seed = ScorerClient(target)
            seed.sync(
                node_allocatable=model.nalloc,
                node_requested=model.nreq,
                node_usage=model.nuse,
                metric_fresh=list(model.fresh),
                pod_requests=model.preq,
                pod_estimated=model.pest,
                priority=list(model.priority),
                gang_id=list(model.gang_id),
                quota_id=list(model.quota_id),
                gang_min_member=list(model.gang_min),
                quota_runtime=model.qrt,
                quota_used=model.quse,
                quota_limited=model.qlim,
            )
            sid = seed.snapshot_id
            seed.score_flat(top_k=top_k)  # warm the route before the clock
            seed.close()

            # one attempt, no retries: a shed must count as a shed, not
            # dissolve into a paced retry
            no_retry = BackoffPolicy(deadline_ms=0.0)

            def worker(band: str) -> None:
                client = ScorerClient(
                    target, band=band, retry_policy=no_retry
                )
                # reads only: adopting the seeded Sync's acked id is all a
                # Score needs
                client.snapshot_id = sid
                try:
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        try:
                            client.score_flat(top_k=top_k)
                        except Exception as exc:  # shed replies are the measured outcome; anything else counts as an error tally
                            with results_lock:
                                if "RESOURCE_EXHAUSTED" in str(exc):
                                    results["shed"][band] = (
                                        results["shed"].get(band, 0) + 1
                                    )
                                else:
                                    results["errors"] += 1
                            continue
                        ms = (time.perf_counter() - t0) * 1000.0
                        with results_lock:
                            results["ok"][band] = (
                                results["ok"].get(band, 0) + 1
                            )
                            metrics.observe_trace_cycle(
                                band, "score", ms
                            )
                finally:
                    client.close()

            threads = [
                threading.Thread(
                    target=worker, args=("koord-free",), daemon=True
                )
                for _ in range(free_threads)
            ] + [
                threading.Thread(
                    target=worker, args=("koord-prod",), daemon=True
                )
                for _ in range(prod_threads)
            ]
            with slow_stage(sv, launch_delay_ms):
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120.0)
        finally:
            stop()
            sv.telemetry.close()

    return {
        "band_p99_ms": {
            band: histogram_quantile(
                metrics.registry, TRACE_CYCLE, 0.99,
                {"band": band, "rpc": "score"},
            )
            for band in ("koord-prod", "koord-free")
        },
        "served": dict(results["ok"]),
        "shed_client": dict(results["shed"]),
        "shed_by_band": dict(sv.admission.stats()["shed_by_band"]),
        "errors": results["errors"],
        "registry": metrics.registry,
        "max_inflight": max_inflight,
    }
