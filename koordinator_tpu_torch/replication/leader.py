"""Leader side of the replicated serving tier.

Counterpart of ``koordinator_tpu/replication/leader.py``; its frames are
the reference's byte for byte.

One daemon — the leader — applies client Syncs to its device-resident
snapshot and streams every committed frame to N follower daemons over a
unix socket, each follower maintaining its own device-resident copy and
serving Score/Assign read traffic locally.  The paper's design already
separates the one writer from many readers; this module is that split
made horizontal.

Protocol (replication/codec.py frames over a plain ``SOCK_STREAM``
unix socket, one-directional leader -> follower):

* every new subscription OPENS with a ``kind=full`` frame — the
  leader's full-state export at its current ``(epoch, generation)`` —
  so "resync" and "subscribe" are the same mechanism: a follower that
  detects any discontinuity simply drops the connection and redials;
* every committed Sync then streams as a ``kind=delta`` sequence frame
  (the client's already-encoded SyncRequest bytes — a warm delta frame
  replicates at its wire size, O(changed));
* a follower that cannot keep up is DROPPED, not waited for: each
  subscriber has a bounded frame queue drained by its own sender
  thread, and overflow closes the connection (the follower redials and
  full-resyncs).  The writer path never blocks on a reader — publish
  is enqueue-only.

Ordering: the servicer invokes ``replication_hook`` under its
``_sync_lock``, so frames fan out in strict generation order; new
subscriptions serialize against the fan-out under the publisher's own
lock and read the export under the servicer's ``_state_lock``, which
makes the opening full frame a committed-generation prefix of the
delta stream that follows (a delta the full frame already contains
arrives with ``generation <= current`` and is dropped as stale by the
follower — never applied twice).
"""

from __future__ import annotations

import collections
import logging
import os
import socket
import threading
import time

from koordinator_tpu_torch.obs.lockwitness import witness_condition, witness_rlock
from koordinator_tpu_torch.replication import codec

logger = logging.getLogger(__name__)

# frames a slow follower may have outstanding before it is dropped to
# a full resync; bounds leader-side memory at ~queue * frame size
DEFAULT_QUEUE_FRAMES = 64

# sender-path coalescing bound: consecutive queued frames
# are concatenated into ONE sendall per wakeup up to this many bytes —
# bounded by BYTES, not frame count, so a burst of sparse warm deltas
# (a few hundred bytes each) collapses hundreds of syscalls into one
# writev-sized write while a single huge full frame still goes alone
DEFAULT_BATCH_BYTES = 1 << 20

# a hello capability payload is a short ascii string; anything larger
# is drained and ignored (conservative: treated as capability-free)
_MAX_HELLO_CAPS = 64


def _parse_sid(snapshot_id: str):
    from koordinator_tpu_torch.bridge.client import parse_snapshot_id

    return parse_snapshot_id(snapshot_id)


class _Subscriber:
    """One follower connection: bounded queue + sender thread.  The
    sender drains the queue in byte-bounded batches — frame boundaries
    are preserved by the stream framing itself, so concatenation is
    free — and reports each batch's occupancy through ``on_batch`` for
    the publisher's frames-per-wakeup stats."""

    def __init__(self, conn: socket.socket, max_frames: int, on_drop,
                 max_batch_bytes: int = DEFAULT_BATCH_BYTES,
                 on_batch=None):
        self.conn = conn
        self.max_frames = max_frames
        self.max_batch_bytes = max(1, int(max_batch_bytes))
        self._on_drop = on_drop
        self._on_batch = on_batch
        # negotiated in the hello handshake (publisher sets it before
        # any frame is enqueued): may this subscriber receive
        # KIND_FULL_Z compressed full frames?
        self.compress = False
        self._frames = collections.deque()
        self._cond = witness_condition("replication.leader._Subscriber._cond")
        self._dead = False
        # sender-thread-only counters; read racily by stats() (ints)
        self.sent_frames = 0
        self.sent_batches = 0
        self._thread = threading.Thread(target=self._drain, daemon=True)

    def start(self) -> "_Subscriber":
        self._thread.start()
        return self

    def enqueue(self, frame_bytes: bytes) -> None:
        """Non-blocking: the publish path must never wait on a reader.
        Overflow kills the subscription — the follower's reconnect
        gets a fresh full frame, which is strictly more information
        than the frames this queue would have held."""
        overflow = False
        with self._cond:
            if self._dead:
                return
            if len(self._frames) >= self.max_frames:
                overflow = True
            else:
                self._frames.append(frame_bytes)
                self._cond.notify_all()
        if overflow:
            logger.warning(
                "replication subscriber overflowed its %d-frame "
                "queue; dropping it to a full resync",
                self.max_frames,
            )
            self.close()

    def close(self) -> None:
        # the on_drop callback (publisher lock) runs with the condition
        # RELEASED: the sender thread takes cond -> publisher-lock and
        # the publish path publisher-lock -> cond, so calling out while
        # holding the condition would close a lock-order cycle
        if self._kill():
            self._on_drop(self)

    def _kill(self) -> bool:
        """Transition to dead exactly once; True for the transitioning
        caller (who then owns the on_drop notification)."""
        with self._cond:
            if self._dead:
                return False
            self._dead = True
            self._frames.clear()
            try:
                self.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.conn.close()
            except OSError:
                pass
            self._cond.notify_all()
            return True

    def _drain(self) -> None:
        while True:
            with self._cond:
                while not self._frames and not self._dead:
                    # backstop timeout only (unbounded-wait idiom):
                    # every enqueue/close notifies this condition
                    self._cond.wait(timeout=1.0)
                if self._dead:
                    return
                # byte-bounded coalescing: take every
                # consecutive queued frame that fits the batch bound
                # in ONE wakeup; the first frame always ships even
                # when it alone exceeds the bound
                batch = [self._frames.popleft()]
                size = len(batch[0])
                while self._frames and (
                    size + len(self._frames[0]) <= self.max_batch_bytes
                ):
                    nxt = self._frames.popleft()
                    size += len(nxt)
                    batch.append(nxt)
            data = batch[0] if len(batch) == 1 else b"".join(batch)
            try:
                self.conn.sendall(data)
            except OSError:
                self.close()
                return
            self.sent_frames += len(batch)
            self.sent_batches += 1
            if self._on_batch is not None:
                try:
                    self._on_batch(len(batch))
                except Exception:  # koordlint: disable=broad-except(batch-occupancy accounting must never kill the sender thread)
                    pass


class ReplicationPublisher:
    """Streams a leader servicer's committed Syncs to followers.

    ``attach`` + ``start`` on the leader daemon; the scheduler server
    binds it at ``<uds>.repl`` by default (scheduler/server.py)."""

    def __init__(
        self,
        servicer,
        path: str,
        queue_frames: int = DEFAULT_QUEUE_FRAMES,
        clock=time.time,
        journal=None,
        hello_timeout_s: float = 0.25,
        max_batch_bytes: int = DEFAULT_BATCH_BYTES,
        compress_full: bool = True,
    ):
        """``journal`` (a ``replication.journal.FrameJournal``
        — or any object with its ``frames_since`` shape, e.g. the
        relay-side ``replication.journal.RelayFrameCache``) lets a
        subscription RESUME instead of full-resyncing: a follower opens
        with a ``kind=hello`` frame naming its chain position, and when
        the journal's delta chain covers it the subscription is served
        just the missing frames — after a journal warm-restart,
        reconnecting followers observe no full resync.  Followers that
        send no hello within ``hello_timeout_s`` (pre-journal
        subscribers, plain taps) get the plain opening: a full
        frame.

        ``max_batch_bytes`` bounds the sender-path coalescing: each
        subscriber's sender concatenates consecutive queued frames into one ``sendall`` up to this many bytes per wakeup.

        ``compress_full`` serves the opening full frame as
        level-1 zlib (``KIND_FULL_Z``) to any subscriber whose hello
        advertised the ``z`` capability; journal bytes and delta frames
        stay uncompressed."""
        self.servicer = servicer
        self.path = path
        self.queue_frames = max(1, int(queue_frames))
        self.journal = journal
        self.hello_timeout_s = float(hello_timeout_s)
        self.max_batch_bytes = max(1, int(max_batch_bytes))
        self.compress_full = bool(compress_full)
        self._clock = clock
        # RLock: an enqueue overflow inside the fan-out (lock held)
        # drops the subscriber, and the drop re-enters to unregister
        self._lock = witness_rlock(
            "replication.leader.ReplicationPublisher._lock")
        self._subs = []
        self._stop = threading.Event()
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(16)
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        # lifetime stats (tests/bench)
        self.published = 0
        self.subscriptions = 0
        self.resumed_subscriptions = 0
        self.compressed_fulls = 0
        # send-batch totals of DROPPED subscribers, folded in by _drop
        # so stats() never loses a retired sender's work (live
        # subscribers are summed on demand)
        self._retired_frames = 0
        self._retired_batches = 0

    # -- lifecycle --
    def attach(self) -> "ReplicationPublisher":
        """Hook the servicer's Sync commit path.  Separate from start()
        so tests can attach without a socket."""
        self.servicer.replication_hook = self.on_sync_committed
        self.servicer.telemetry.metrics.set_replica_role("leader")
        return self

    def start(self) -> "ReplicationPublisher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.servicer.replication_hook is self.on_sync_committed:
            self.servicer.replication_hook = None
        try:
            self._sock.close()
        finally:
            with self._lock:
                subs = list(self._subs)
            for sub in subs:
                sub.close()
            if os.path.exists(self.path):
                try:
                    os.unlink(self.path)
                except OSError:
                    pass

    def follower_count(self) -> int:
        with self._lock:
            return len(self._subs)

    # -- the servicer hook (runs under the servicer's _sync_lock) --
    def on_sync_committed(self, req, snapshot_id: str,
                          wire_bytes=None) -> None:
        """``wire_bytes`` is the client's original frame when the
        transport kept it (the raw-UDS path) — streamed verbatim, the
        "already-encoded delta frames" economics; a None falls back to
        re-serializing the decoded message (gRPC), byte-identical."""
        epoch, gen = _parse_sid(snapshot_id)
        payload = (
            wire_bytes if wire_bytes is not None
            else req.SerializeToString()
        )
        frame = codec.encode_frame(
            codec.KIND_DELTA, epoch, gen,
            int(self._clock() * 1e6), payload,
        )
        self.publish_frame(frame)

    def publish_frame(self, frame_bytes: bytes) -> None:
        """Fan one already-encoded frame out to every subscriber — the
        relay seam: a relay follower hands the immutable
        delta bytes it just applied straight here, so re-publication is
        a near-zero-copy byte forward (no decode, no re-encode, same
        epoch fencing at every hop)."""
        with self._lock:
            self.published += 1
            for sub in list(self._subs):
                sub.enqueue(frame_bytes)

    # -- subscription plumbing --
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed by stop()
            try:
                self._register(conn)
            except Exception:  # one bad subscription must not kill the accept loop for every other follower
                logger.exception("replication subscription failed")
                try:
                    conn.close()
                except OSError:
                    pass

    def _read_hello(self, conn: socket.socket):
        """Peek for the subscriber's opening hello frame (bounded wait).
        Returns ``(frame, caps)`` — the decoded position frame plus its
        capability payload bytes — or ``(None, b"")``: no hello within
        the window, or anything unexpected, degrades to the plain
        full-frame open, never to a failed subscription.  The window
        is a WHOLE-handshake deadline, not per-recv: this runs on the
        one accept thread, and a peer dribbling bytes must not be able
        to stretch one handshake past ``hello_timeout_s`` total.  A
        payload past the small capability cap is drained and ignored
        (legacy behavior: the payload used to be spec'd empty)."""
        deadline = time.monotonic() + self.hello_timeout_s
        caps = b""
        try:
            buf = b""
            while len(buf) < codec.HEADER_LEN:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None, b""
                conn.settimeout(left)
                chunk = conn.recv(codec.HEADER_LEN - len(buf))
                if not chunk:
                    return None, b""
                buf += chunk
            frame, plen = codec.decode_header(buf)
            if frame.kind != codec.KIND_HELLO:
                return None, b""
            oversized = plen > _MAX_HELLO_CAPS
            while plen > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None, b""
                conn.settimeout(left)
                chunk = conn.recv(min(65536, plen))
                if not chunk:
                    return None, b""
                plen -= len(chunk)
                if not oversized:
                    caps += chunk
            return frame, (b"" if oversized else caps)
        except (socket.timeout, OSError, codec.FrameError):
            return None, b""
        finally:
            try:
                conn.settimeout(None)
            except OSError:
                pass

    def _register(self, conn: socket.socket) -> None:
        """Under the publisher lock: serve the subscription's opening
        state — the journal's missing-delta resume when the follower's
        hello position is covered, else the full-state
        export — then admit the subscriber, atomically against the
        fan-out, so no committed delta can slip between the opening
        frames and the subscription (the continuity argument in the
        module docstring; a frame journaled-but-not-yet-fanned-out can
        be enqueued twice, and the follower drops the second as
        stale)."""
        hello, caps = self._read_hello(conn)
        sub = _Subscriber(
            conn, self.queue_frames, self._drop,
            max_batch_bytes=self.max_batch_bytes,
            on_batch=self._observe_batch,
        )
        sub.compress = (
            self.compress_full and codec.CAP_COMPRESS in caps
        )
        resumed = compressed = False
        with self._lock:
            if hello is not None and self.journal is not None:
                frames = self.journal.frames_since(
                    hello.epoch, hello.generation
                )
                if frames is not None and len(frames) >= self.queue_frames:
                    # the resume frames must fit the subscriber's
                    # bounded queue (the drain thread starts after
                    # admission); a follower this far behind resyncs
                    # cheaper with one full frame anyway
                    frames = None
                if frames is not None:
                    for fb in frames:
                        sub.enqueue(fb)
                    resumed = True
                    self.resumed_subscriptions += 1
            if not resumed:
                epoch, gen, payload = (
                    self.servicer.export_replication_snapshot()
                )
                kind = codec.KIND_FULL
                if sub.compress and payload:
                    kind = codec.KIND_FULL_Z
                    payload = codec.compress_payload(payload)
                    self.compressed_fulls += 1
                    compressed = True
                full = codec.encode_frame(
                    kind, epoch, gen,
                    int(self._clock() * 1e6), payload,
                )
                sub.enqueue(full)
            self._subs.append(sub)
            self.subscriptions += 1
            n = len(self._subs)
        sub.start()
        metrics = self.servicer.telemetry.metrics
        metrics.set_replica_followers(n)
        if resumed:
            metrics.count_retry("resume")
        if compressed:
            metrics.count_replica_compress("encode")

    def _observe_batch(self, n_frames: int) -> None:
        """Sender-thread callback: one coalesced send of ``n_frames``
        frames (the frames-per-wakeup distribution)."""
        try:
            self.servicer.telemetry.metrics.observe_send_batch(n_frames)
        except Exception:  # koordlint: disable=broad-except(send-batch accounting is observability; it must never kill a sender)
            pass

    def stats(self) -> dict:
        """Lifetime fan-out stats, including the sender-path batching
        picture: ``frames_per_wakeup`` is the mean coalesced
        batch occupancy — 1.0 means the batching never fired (serial
        traffic), climbing under bursty fan-out load as syscalls are
        saved."""
        with self._lock:
            frames = self._retired_frames
            batches = self._retired_batches
            for sub in self._subs:
                frames += sub.sent_frames
                batches += sub.sent_batches
            return {
                "published": self.published,
                "subscriptions": self.subscriptions,
                "resumed_subscriptions": self.resumed_subscriptions,
                "followers": len(self._subs),
                "compressed_fulls": self.compressed_fulls,
                "sent_frames": frames,
                "sent_batches": batches,
                "frames_per_wakeup": (
                    frames / batches if batches else 0.0
                ),
                "max_batch_bytes": self.max_batch_bytes,
            }

    def _drop(self, sub: "_Subscriber") -> None:
        # from the sender thread (no lock) or re-entrantly from an
        # enqueue overflow during the fan-out (RLock)
        with self._lock:
            try:
                self._subs.remove(sub)
            except ValueError:
                return
            self._retired_frames += sub.sent_frames
            self._retired_batches += sub.sent_batches
            n = len(self._subs)
        try:
            self.servicer.telemetry.metrics.set_replica_followers(n)
        except Exception:  # koordlint: disable=broad-except(gauge update on a dying connection must not mask the drop itself)
            pass
