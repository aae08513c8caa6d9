"""Follower side of the replicated serving tier.

Counterpart of ``koordinator_tpu/replication/follower.py``; it imports
no ``grpc`` (a refusal aborts a gRPC call through the servicer context's
``StatusCode``, and reaches a raw-framing client as its text, which the
port's client classifies).

A follower daemon maintains its own device-resident snapshot copy by
applying the leader's replication frames through the very same
``bridge/state.py`` stage/commit seam (delta scatters, warm residency,
donation barrier) a client Sync uses, and serves Score/Assign read
traffic locally.  Three pieces:

* :class:`ReplicaApplier` — the transport-independent continuity core.
  Every frame is judged against the ``s<epoch>-<gen>`` chain the
  follower is on; only a frame that EXTENDS it applies.  Anything else
  is a classified discontinuity: ``gap`` (dropped frame), ``epoch``
  (leader restart/failover), ``apply`` (payload failed validation —
  state untouched, the stage-then-commit atomicity), and duplicates
  from a reordering transport are dropped as ``stale``.
* :class:`ReplicationSubscriber` — the UDS transport: dial the
  leader's ``.repl`` socket, stream frames into the applier, and on
  ANY discontinuity (including a truncated or malformed frame) drop
  the connection and redial — the leader opens every subscription with
  a full-state frame, so reconnect IS the one-shot full resync.
* :class:`FollowerServicer` — a ScorerServicer that refuses client
  Syncs (the tier has ONE writer; Sync goes to the leader) while
  serving Score/Assign exactly like the leader, snapshot ids included.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Optional

from koordinator_tpu_torch.bridge.server import ScorerServicer, StatusCode
from koordinator_tpu_torch.obs.lockwitness import witness_lock
from koordinator_tpu_torch.replication import codec
from koordinator_tpu_torch.replication.retry import BackoffPolicy

logger = logging.getLogger(__name__)

APPLIED = "applied"
STALE = "stale"
RESYNC = "resync"


class NotLeader(Exception):
    """A client sent Sync to a follower replica.  Mapped to gRPC
    FAILED_PRECONDITION / a raw-UDS error frame; the fix is config
    (point Sync at the leader), so the message says where."""


class ReplicaApplier:
    """Continuity-checked frame application onto a follower servicer.

    ``offer(frame)`` returns :data:`APPLIED`, :data:`STALE` (duplicate
    or late redelivery — dropped) or :data:`RESYNC` (discontinuity
    detected; the caller must fetch a full frame, which ``offer``
    always accepts).  Not thread-safe by itself: one transport thread
    feeds one applier (client Score/Assign traffic runs concurrently —
    the servicer's own locks cover that side)."""

    def __init__(self, servicer, clock=time.time, hop: int = 1):
        """``hop`` is this replica's distance from the tree root
        (1 = direct follower of the leader, 2 = behind one
        relay, ...) — it labels the per-hop lag gauge so a deep chain's
        lag amplification is visible per level, not just in aggregate."""
        self.servicer = servicer
        self._clock = clock
        self.hop = max(1, int(hop))
        self.applied = 0
        self.resyncs = 0
        self.last_lag_ms: Optional[float] = None
        servicer.telemetry.metrics.set_replica_role("follower")

    # -- current chain position --
    def position(self):
        """(epoch, generation) the follower is at.  Before the first
        full frame this is the follower's own boot epoch, which no
        leader frame can ever extend — exactly the "must resync first"
        state a fresh follower should be in."""
        from koordinator_tpu_torch.bridge.client import parse_snapshot_id

        return parse_snapshot_id(self.servicer.snapshot_id())

    def offer(self, frame: "codec.Frame") -> str:
        metrics = self.servicer.telemetry.metrics
        if frame.kind == codec.KIND_FULL_Z:
            # negotiated wire compression: inflate back to
            # the canonical KIND_FULL before the continuity core sees
            # it — everything downstream (stage/commit, journal,
            # relay re-publication) handles raw bytes only
            import dataclasses

            try:
                frame = dataclasses.replace(
                    frame, kind=codec.KIND_FULL,
                    payload=codec.decompress_payload(frame.payload),
                )
            except codec.FrameError:
                # corrupt compressed payload: a detected discontinuity,
                # same contract as any malformed frame
                return self._resync("decode", metrics)
            metrics.count_replica_compress("decode")
        if frame.kind == codec.KIND_FULL:
            return self._apply(frame, metrics)
        epoch, gen = self.position()
        if frame.epoch != epoch:
            return self._resync("epoch", metrics)
        if frame.generation <= gen:
            # duplicate / late redelivery on the SAME chain: the state
            # already contains it; applying again would corrupt the
            # delta baselines — drop, don't resync
            metrics.count_replica_frame(STALE)
            return STALE
        if frame.generation != gen + 1:
            return self._resync("gap", metrics)
        return self._apply(frame, metrics)

    def _apply(self, frame, metrics) -> str:
        try:
            self.servicer.apply_replica_frame(frame)
        except Exception:  # a bad frame must demote to the documented full resync, never crash the follower; state is untouched by stage-then-commit
            logger.exception(
                "replica frame s%s-%d failed to apply; forcing full "
                "resync (resident state untouched)",
                frame.epoch, frame.generation,
            )
            return self._resync("apply", metrics)
        self.applied += 1
        lag_ms = max(0.0, self._clock() * 1e6 - frame.stamp_us) / 1000.0
        self.last_lag_ms = lag_ms
        metrics.count_replica_frame(APPLIED)
        metrics.set_replica_lag(lag_ms)
        metrics.set_replica_hop_lag(self.hop, lag_ms)
        return APPLIED

    def _resync(self, reason: str, metrics) -> str:
        self.resyncs += 1
        metrics.count_replica_frame(RESYNC)
        metrics.count_replica_resync(reason)
        return RESYNC


def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes or None on EOF/reset (any partial read is a
    truncated frame — the caller treats it as a discontinuity)."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class ReplicationSubscriber:
    """Dial the leader's replication socket and pump frames into an
    applier; reconnect (= full resync) on any discontinuity.

    ``on_frame(result, frame)`` is an optional callback after every
    offer — the bench's follower worker uses it to publish catch-up
    status; tests use it to observe the stream."""

    def __init__(
        self,
        path: str,
        applier: ReplicaApplier,
        reconnect_delay_s: float = 0.05,
        on_frame=None,
        backoff: Optional[BackoffPolicy] = None,
        hello: bool = True,
        fallbacks=(),
        compress: bool = True,
        on_raw=None,
    ):
        """``backoff`` paces the redial loop: jittered
        exponential from ``reconnect_delay_s`` up to the policy cap —
        a dead leader is polled at the cap, a thundering herd of
        followers never re-arrives in phase.  The subscriber retries
        FOREVER (the deadline budget bounds individual client calls,
        not a daemon's lifelong subscription); a successful connect
        resets the ladder.

        ``hello`` sends the follower's chain position as the first
        frame of every subscription (codec.KIND_HELLO): a leader whose
        journal covers that position answers with only the missing
        delta frames — a journal warm-restart costs followers NO full
        resync.  Leaders ignore unexpected bytes conservatively (a
        hello to a pre-journal leader just reads as the subscription
        opening; the full frame still arrives).

        ``fallbacks`` (the relay tree) are ANCESTOR
        replication sockets in preference order behind the primary
        ``path`` (parent first, then grandparent, ... root): every dial
        attempt walks the whole ladder primary-first, so an interior
        relay's death re-parents this subscriber onto the nearest
        surviving ancestor — whose stream is the SAME chain, so the
        hello/resume handshake serves just the missing deltas (zero
        full resyncs) — and a healed parent is preferred again on the
        next redial.

        ``compress`` advertises the ``z`` hello capability: full frames
        may then arrive as level-1 zlib (KIND_FULL_Z), inflated before
        the continuity core sees them.

        ``on_raw(result, frame, raw_bytes)`` is the relay forwarding
        seam: called with the frame's exact wire bytes after every
        offer, so a relay can re-publish applied delta frames verbatim
        (near-zero-copy) on its own ``.repl`` socket."""
        self.path = path
        self.fallbacks = tuple(fallbacks)
        self.paths = (path,) + self.fallbacks
        self.compress = bool(compress)
        self.on_raw = on_raw
        self.applier = applier
        self.reconnect_delay_s = float(reconnect_delay_s)
        self.backoff = backoff or BackoffPolicy.from_env(
            base_ms=max(1.0, self.reconnect_delay_s * 1000.0)
        )
        self.hello = bool(hello)
        self.on_frame = on_frame
        self._stop = threading.Event()
        self._conn_lock = witness_lock(
            "replication.follower.ReplicationSubscriber._conn_lock")
        self._conn: Optional[socket.socket] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        # set when the LAST stream ended in a detected discontinuity
        # (RESYNC/decode): the next dial must skip the hello and take
        # the full-frame open — offering the same position to a
        # journal-holding leader would re-serve the very delta that
        # just failed to apply, forever (the pre-journal "reconnect IS
        # the full resync" guarantee, preserved exactly where it is
        # load-bearing)
        self._force_full = False
        self.connects = 0
        self.redials = 0
        # which ancestor currently feeds this subscriber (index into
        # ``paths``; 0 = the primary parent) and how many times a dial
        # landed on a non-primary ancestor (the interior-death path)
        self.active_path: Optional[str] = None
        self.ancestor_switches = 0

    def start(self) -> "ReplicationSubscriber":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # unblock a recv in flight: the pump thread would otherwise
        # sit in the blocking read until the leader sends again
        with self._conn_lock:
            conn = self._conn
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(timeout=5)

    # -- internals --
    def _dial(self, metrics) -> Optional[socket.socket]:
        """One dial pass over the ancestor ladder, primary parent
        first.  Returns the connected socket (``active_path`` updated)
        or None when every ancestor refused — the caller backs off.  A
        connect that lands past index 0 is an ancestor switch: the
        parent is dead or unreachable and a surviving ancestor now
        feeds this subscriber (same chain, so resume still applies)."""
        for i, path in enumerate(self.paths):
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                conn.connect(path)
            except OSError:
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            if i > 0:
                self.ancestor_switches += 1
                try:
                    metrics.count_retry("failover")
                except Exception:  # koordlint: disable=broad-except(failover accounting must never abort a successful dial)
                    pass
                logger.warning(
                    "replication parent %s unreachable; re-parented "
                    "onto ancestor %s", self.path, path,
                )
            self.active_path = path
            return conn
        return None

    def _run(self) -> None:
        metrics = self.applier.servicer.telemetry.metrics
        attempt = 0
        while not self._stop.is_set():
            conn = None
            try:
                conn = self._dial(metrics)
                if conn is None:
                    raise OSError("no ancestor reachable")
                with self._conn_lock:
                    self._conn = conn
                self.connects += 1
                attempt = 0  # a live leader resets the backoff ladder
                if self.hello and not self._force_full:
                    epoch, gen = self.applier.position()
                    if len(epoch) != 8:
                        # legacy/malformed id: offer a position no
                        # journal matches -> ordinary full-frame open
                        epoch = "00000000"
                    caps = codec.CAP_COMPRESS if self.compress else b""
                    try:
                        conn.sendall(codec.encode_frame(
                            codec.KIND_HELLO, epoch, max(0, gen),
                            0, caps,
                        ))
                    except OSError:
                        # peer hung up mid-handshake: whatever it
                        # already sent is still buffered locally — the
                        # pump below must READ it (a truncated frame
                        # counts on the error family), not abandon it
                        pass
                self._pump(conn, metrics)
            except OSError:
                pass  # leader down/mid-restart: retry below
            finally:
                with self._conn_lock:
                    self._conn = None
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass
            # every redial resyncs (a journal-holding leader serves the
            # missing deltas, anyone else a full frame); pace it on the
            # shared jittered ladder so a dead leader costs capped
            # polls, never a spin or a synchronized herd
            if self._stop.is_set():
                return
            self.redials += 1
            try:
                metrics.count_retry("subscribe")
            except Exception:  # koordlint: disable=broad-except(retry accounting must never kill the redial loop)
                pass
            self._stop.wait(self.backoff.delay_ms(attempt) / 1000.0)
            attempt += 1

    def _pump(self, conn: socket.socket, metrics) -> None:
        while not self._stop.is_set():
            header = _read_exact(conn, codec.HEADER_LEN)
            if header is None:
                return  # EOF between frames, or leader dropped us
            try:
                partial, plen = codec.decode_header(header)
                payload = b""
                if plen:
                    body = _read_exact(conn, plen)
                    if body is None:
                        # truncated mid-frame: a protocol violation,
                        # not a clean close — count it, then resync by
                        # reconnecting
                        metrics.count_replica_frame("error")
                        metrics.count_replica_resync("connect")
                        self._force_full = True
                        return
                    payload = body
                frame = codec.decode_frame(header + payload)
            except codec.FrameError as exc:
                logger.warning(
                    "malformed replication frame (%s); resyncing", exc
                )
                metrics.count_replica_frame("error")
                metrics.count_replica_resync("decode")
                self._force_full = True
                return
            result = self.applier.offer(frame)
            if result == APPLIED and frame.kind in (
                codec.KIND_FULL, codec.KIND_FULL_Z
            ):
                self._force_full = False  # healed: resume is safe again
            if self.on_raw is not None:
                # relay forwarding seam: the exact wire bytes, so a
                # relay re-publishes applied deltas verbatim with zero
                # re-encoding (delta frames are never compressed, so
                # the bytes are hop-invariant)
                try:
                    self.on_raw(result, frame, header + payload)
                except Exception:  # the relay's descendants resync on their own; a forwarding fault must not kill THIS stream
                    logger.exception("replication on_raw callback failed")
            if self.on_frame is not None:
                try:
                    self.on_frame(result, frame)
                except Exception:  # status callbacks are observability; they must not kill the stream
                    logger.exception("replication on_frame callback failed")
            if result == RESYNC:
                # reconnect -> the leader must reopen with a FULL
                # frame: a journal resume at our unchanged position
                # would re-serve the exact frame that just failed
                self._force_full = True
                return


class FollowerServicer(ScorerServicer):
    """A read-replica servicer: serves Score/Assign exactly like the
    leader (snapshot ids included — they ARE the leader's after the
    first applied frame) but refuses client Syncs: the tier has one
    writer, and a follower silently accepting a Sync would fork its
    chain off the leader's and poison every delta baseline.

    :meth:`promote` flips this replica into the tier's
    writer: it BUMPS THE EPOCH (the old leader's chain must become
    unmistakably dead — a zombie leader's frames now fail the epoch
    fence everywhere) while keeping the generation, and starts
    accepting Syncs.  The daemon layer (scheduler/server.py) wires the
    surrounding moves: stop the subscription, open a journal, start a
    publisher on this daemon's own ``<uds>.repl``."""

    def __init__(self, *args, leader: str = "", **kwargs):
        super().__init__(*args, **kwargs)
        self._leader_hint = leader
        self._promoted = False

    @property
    def promoted(self) -> bool:
        return self._promoted

    def promote(self, epoch: Optional[str] = None) -> str:
        """Become the writer: new epoch, same generation, memos dead.
        Idempotent — a second promote returns the current id without
        bumping again.  Returns the new ``s<epoch>-<gen>`` id."""
        with self._sync_lock:
            with self._state_lock:
                if self._promoted:
                    return self.snapshot_id()
                self._promoted = True
                # the ONE epoch-bump implementation (memos die with
                # the old chain) — shared with the torn-tail rebase
                sid = self._rebase_epoch_locked(epoch)
        m = self.telemetry.metrics
        m.set_replica_role("leader")
        m.count_failover("promoted")
        logger.warning(
            "follower promoted to leader at %s (epoch bumped; clients "
            "full-resync once on the epoch fence, reads were never "
            "interrupted)", sid,
        )
        return sid

    def sync(self, req, ctx=None, wire_bytes=None):
        if self._promoted:
            return super().sync(req, ctx, wire_bytes=wire_bytes)
        msg = (
            "replica follower does not accept Sync: the tier has one "
            "writer"
            + (f" (sync against {self._leader_hint})"
               if self._leader_hint else "")
        )
        if ctx is not None:
            ctx.abort(StatusCode.FAILED_PRECONDITION, msg)
        raise NotLeader(msg)


def promote_replica(raw_sock_path: str, timeout_s: float = 30.0) -> str:
    """Operator/admin seam: ask the follower daemon at ``<uds>.raw`` to
    promote itself (the raw-UDS admin method — SIGUSR2 is the signal
    twin).  Returns the promoted daemon's new snapshot id; raises
    :class:`RuntimeError` with the server's message on refusal."""
    from koordinator_tpu_torch.bridge.udsserver import METHOD_PROMOTE

    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout_s)
    try:
        conn.connect(raw_sock_path)
        conn.sendall(struct.pack(">BI", METHOD_PROMOTE, 0))
        header = b""
        while len(header) < 5:
            chunk = conn.recv(5 - len(header))
            if not chunk:
                raise RuntimeError("promote: connection closed mid-reply")
            header += chunk
        status, length = struct.unpack(">BI", header)
        payload = b""
        while len(payload) < length:
            chunk = conn.recv(length - len(payload))
            if not chunk:
                raise RuntimeError("promote: connection closed mid-reply")
            payload += chunk
        if status != 0:
            raise RuntimeError(
                f"promote refused: {payload.decode(errors='replace')}"
            )
        return payload.decode()
    finally:
        try:
            conn.close()
        except OSError:
            pass
