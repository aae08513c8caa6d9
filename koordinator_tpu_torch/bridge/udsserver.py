"""Raw length-prefixed protobuf-over-UDS transport of the scorer seam.

Counterpart of ``koordinator_tpu/bridge/udsserver.py``: the same framing,
served by the port's ``ScorerServicer`` through the port's codec
(``bridge/wire.py``), so it needs neither gRPC nor the protobuf runtime.

Frame (both directions, all integers big-endian):

    request:  u8 method (1=Sync, 2=Score, 3=Assign), u32 length, payload
    reply:    u8 status (0=ok, 1=error), u32 length, payload
              (serialized reply message, or UTF-8 error string)

One connection may carry any number of sequential request/reply pairs.
Admin-plane methods (the reference's 4 = Promote and 5 = Profile) are
registered through ``RawUdsServer(admin_handlers=...)``: Profile's handler
is ``obs/devprof.py capture_profile`` (the payload an ASCII window in ms,
the reply the capture directory); Promote's is the daemon's
(``scheduler/server.py``), the reply the promoted snapshot id.  ``bridge/client.py ScorerClient("raw:///path")`` is the
Python client of this framing.

While stage spans are recorded (``obs/spans.py``), each Sync, Score and
Assign frame gives the transport's stages on the connection's thread:
``recv`` (from the header's arrival to the payload's end; the wait for
the next header is not a stage), ``decode``, ``handler`` (the servicer
method's whole wall), ``encode`` and ``send``.
"""

from __future__ import annotations

import inspect
import logging
import os
import socket
import struct
import threading
import time
from typing import Optional, Tuple

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.acceptloop import join_unless_current, wake_accept_loop
from koordinator_tpu_torch.bridge.server import ScorerServicer
from koordinator_tpu_torch.config import CycleConfig, DEFAULT_CYCLE_CONFIG
from koordinator_tpu_torch.obs import spans

logger = logging.getLogger(__name__)

METHOD_SYNC = 1
METHOD_SCORE = 2
METHOD_ASSIGN = 3
# admin plane: method bytes the reference serves through admin_handlers
# (Promote, Profile); no protobuf body either way
METHOD_PROMOTE = 4
METHOD_PROFILE = 5
_METHOD_NAMES = {METHOD_SYNC: "sync", METHOD_SCORE: "score",
                 METHOD_ASSIGN: "assign", METHOD_PROMOTE: "promote",
                 METHOD_PROFILE: "profile"}

# Sized to the largest realistic SyncRequest (10k pods x 2k nodes of i64
# request/capacity vectors serializes to a few MB); anything larger is a
# malformed or hostile frame, not a workload.
_MAX_FRAME = 64 << 20
# One thread per connection; bound concurrent connections so a local
# misbehaving client cannot spawn unbounded threads/buffers.  Sized
# above a 64-client storm: the pipelined dispatcher is the funnel that
# turns a burst into a few launches, so the transport must admit the
# burst first.
_MAX_CONNS = 96


# the transport's stages of one frame, between consecutive marks
_FRAME_STAGES = ("recv", "decode", "handler", "encode", "send")


class _FrameStages:
    """The ``perf_counter_ns`` marks between one frame's stages, taken on
    the connection's thread; :meth:`record` records the stages whose both
    marks were reached."""

    __slots__ = ("_recorder", "_marks")

    def __init__(self, recorder):
        self._recorder = recorder
        self._marks = [time.perf_counter_ns()]

    def mark(self) -> None:
        self._marks.append(time.perf_counter_ns())

    def record(self, rpc: str) -> None:
        marks = self._marks
        for name, start, end in zip(_FRAME_STAGES, marks, marks[1:]):
            self._recorder.record_stage(rpc, name, start, end)


class _NoFrameStages:
    """:class:`_FrameStages` while no stage is recorded."""

    __slots__ = ()

    def mark(self) -> None:
        pass

    def record(self, rpc: str) -> None:
        pass


_NO_FRAME_STAGES = _NoFrameStages()


def _recv_or_eof(conn: socket.socket, n: int) -> Tuple[Optional[bytes], int]:
    """Read exactly ``n`` bytes; on EOF returns (None, bytes_read) so
    the caller can tell a clean between-frames close (0) from a
    truncated frame (> 0) — the latter is a protocol violation worth a
    counter and a log line, not a silent drop."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except OSError:
            chunk = b""  # reset mid-read counts as the EOF it is
        if not chunk:
            return None, len(buf)
        buf.extend(chunk)
    return bytes(buf), n


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    out, _ = _recv_or_eof(conn, n)
    return out


class RawUdsServer:
    """Serve a ScorerServicer over the raw framing on a unix socket."""

    def __init__(
        self,
        path: str,
        servicer: Optional[ScorerServicer] = None,
        cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
        admin_handlers=None,
        device=None,
    ):
        """``servicer``: the servicer to serve (default a new one on
        ``device``: CUDA unless ``"cpu"`` is given).  ``admin_handlers``:
        optional ``{method_byte: fn}`` map of admin-plane methods
        (``fn(payload: bytes) -> bytes``; raise to answer an error
        frame)."""
        self.path = path
        self.servicer = servicer or ScorerServicer(cfg, device=device)
        self.admin_handlers = dict(admin_handlers or {})
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        # backlog matches _MAX_CONNS: with the coalescing dispatcher the
        # intended client is a 16-way worker burst dialing at once, and
        # a listen(8) backlog was refusing dials the connection cap
        # would have accepted
        self._sock.listen(_MAX_CONNS)
        self._stop = threading.Event()
        self._conn_slots = threading.BoundedSemaphore(_MAX_CONNS)
        # live connections, closed on stop(): a stopped server must not
        # keep draining requests on established sockets — a client would
        # get one more successful RPC against dying resident state and
        # only see the restart on the call after (the warm-path recovery
        # protocol depends on the failure surfacing at the Sync)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._methods = {
            METHOD_SYNC: (wire.SyncRequest, self.servicer.sync),
            METHOD_SCORE: (wire.ScoreRequest, self.servicer.score),
            METHOD_ASSIGN: (wire.AssignRequest, self.servicer.assign),
        }
        # the client's original Sync bytes go to a sync() that takes them;
        # a wrapper whose sync() does not is served without, and the
        # journal and publisher re-encode the decoded message
        self._sync_takes_wire = "wire_bytes" in inspect.signature(
            self.servicer.sync).parameters

    def start(self) -> "RawUdsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            wake_accept_loop(self.path, self._thread)
            self._sock.close()
        finally:
            with self._conns_lock:
                conns = list(self._conns)
            for conn in conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            if os.path.exists(self.path):
                os.unlink(self.path)
            join_unless_current(self._thread)

    # -- internals --
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            if not self._conn_slots.acquire(timeout=1.0):
                conn.close()  # saturated: shed instead of queueing unbounded
                continue
            with self._conns_lock:
                self._conns.add(conn)
            # close the race with stop(): a connection accepted just
            # before the listener closed but registered after stop()
            # snapshotted _conns would otherwise keep serving the dying
            # resident state
            if self._stop.is_set():
                with self._conns_lock:
                    self._conns.discard(conn)
                conn.close()
                self._conn_slots.release()
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            self._serve_conn_inner(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            self._conn_slots.release()

    def _metrics(self):
        """The servicer's scorer metric families (None-tolerant: a bare
        test servicer without telemetry still serves)."""
        telemetry = getattr(self.servicer, "telemetry", None)
        return getattr(telemetry, "metrics", None)

    def _frame_stages(self):
        """The stage marks of a frame whose header just arrived: taken
        while stage spans are recorded and the servicer has a span
        recorder, else a no-op."""
        telemetry = getattr(self.servicer, "telemetry", None)
        recorder = getattr(telemetry, "spans", None)
        if recorder is None or not spans.stages_on():
            return _NO_FRAME_STAGES
        return _FrameStages(recorder)

    def _count_malformed(self, reason: str, detail: str) -> None:
        """A malformed frame is COUNTED and LOGGED, never silently
        dropped: a misbehaving client (or codec drift) used to look like
        an ordinary disconnect, invisible until placements went wrong.
        Frames cut short by our OWN stop() closing live connections are
        not client violations — the shutdown path must not pollute the
        counter operators alert on."""
        if self._stop.is_set():
            return
        metrics = self._metrics()
        if metrics is not None:
            metrics.count_uds_malformed(reason)
        logger.warning("malformed UDS frame (%s): %s", reason, detail)

    def _serve_conn_inner(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                header, nread = _recv_or_eof(conn, 5)
                if header is None:
                    if nread:
                        self._count_malformed(
                            "truncated-header",
                            f"connection closed {nread} bytes into a "
                            "5-byte frame header",
                        )
                    return
                stages = self._frame_stages()
                method, length = struct.unpack(">BI", header)
                if length > _MAX_FRAME:
                    self._count_malformed(
                        "oversized",
                        f"method {method} frame of {length} bytes exceeds "
                        f"the {_MAX_FRAME}-byte cap",
                    )
                    self._reply(conn, 1, b"frame too large")
                    return
                payload, nread = _recv_or_eof(conn, length)
                if payload is None:
                    self._count_malformed(
                        "truncated-payload",
                        f"connection closed {nread}/{length} bytes into "
                        f"a method-{method} payload",
                    )
                    return
                stages.mark()
                admin = self.admin_handlers.get(method)
                if admin is not None:
                    metrics = self._metrics()
                    if metrics is not None and method in _METHOD_NAMES:
                        metrics.count_uds_frame(_METHOD_NAMES[method])
                    try:
                        self._reply(conn, 0, admin(payload))
                    except Exception as exc:  # surfaced to the caller, not lost
                        if metrics is not None:
                            metrics.count_uds_error()
                        self._reply(conn, 1, str(exc).encode())
                    continue
                entry = self._methods.get(method)
                if entry is None:
                    self._count_malformed(
                        "unknown-method", f"method byte {method}"
                    )
                    self._reply(conn, 1, f"unknown method {method}".encode())
                    continue
                metrics = self._metrics()
                if metrics is not None:
                    metrics.count_uds_frame(_METHOD_NAMES[method])
                req_cls, fn = entry
                try:
                    req = req_cls.FromString(payload)
                    stages.mark()
                    if method == METHOD_SYNC and self._sync_takes_wire:
                        # the client's original bytes: the journal and the
                        # replication publisher carry them verbatim
                        reply = fn(req, None, wire_bytes=payload)
                    else:
                        reply = fn(req, None)
                    stages.mark()
                    out = reply.SerializeToString()
                    stages.mark()
                    if len(out) > _MAX_FRAME:
                        # every client enforces the same cap on replies; a
                        # full-matrix flat Score (top_k=0) at 10k x 2k is
                        # ~280 MB — fail with a real error instead of
                        # shipping a frame the peer must reject
                        hint = (
                            "; request a smaller top_k"
                            if method == METHOD_SCORE
                            else ""
                        )
                        if metrics is not None:
                            metrics.count_uds_error()
                        self._reply(
                            conn,
                            1,
                            (
                                f"reply frame {len(out)} bytes exceeds the "
                                f"{_MAX_FRAME}-byte transport cap{hint}"
                            ).encode(),
                        )
                        continue
                    self._reply(conn, 0, out)
                    stages.mark()
                except Exception as exc:  # surfaced to the client, not lost
                    if metrics is not None:
                        metrics.count_uds_error()
                    self._reply(conn, 1, str(exc).encode())
                finally:
                    stages.record(_METHOD_NAMES[method])

    @staticmethod
    def _reply(conn: socket.socket, status: int, payload: bytes) -> None:
        """Write header+payload with one gathered ``sendmsg`` instead of
        concatenating (which copies the payload — a full-matrix flat
        Score reply is tens of MB) or two ``sendall`` calls (two
        syscalls per reply on the hot path).  Partial sends are resumed
        across the buffer list; stream UDS sockets rarely split small
        frames, so the common case is exactly one syscall."""
        bufs = [memoryview(struct.pack(">BI", status, len(payload))),
                memoryview(payload)]
        try:
            while bufs:
                sent = conn.sendmsg(bufs)
                while bufs and sent >= len(bufs[0]):
                    sent -= len(bufs[0])
                    bufs.pop(0)
                if bufs and sent:
                    bufs[0] = bufs[0][sent:]
        except OSError:
            pass


def serve_raw_uds(
    path: str, cfg: CycleConfig = DEFAULT_CYCLE_CONFIG, device=None
) -> RawUdsServer:
    """Start a RawUdsServer on ``path`` with a new servicer on ``device``
    (CUDA unless ``"cpu"`` is given)."""
    return RawUdsServer(path, cfg=cfg, device=device).start()
