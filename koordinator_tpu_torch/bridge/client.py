"""Client shim for the BatchedScorer seam.

Counterpart of ``koordinator_tpu/bridge/client.py``: a host scheduler
embeds this client, syncs its cluster view (full once, sparse deltas on
warm cycles against the last ACKED baseline) and gets NodeScoreLists and
assignments back.  Messages are ``bridge/wire.py``'s, so no protobuf
runtime is needed.  Two channels carry them:

* **gRPC** (``unix:///path.sock`` or ``host:port``, as in the reference):
  generic unary stubs on the service ``bridge/wire.py SERVICE`` whose
  serialisers are the codec's.  ``grpc`` is imported only by
  :func:`_grpc_channel`, which builds such a channel.
* **raw** (``raw:///path.sock``): the framing of ``bridge/udsserver.py``
  (``u8 method, u32 length, payload``; the reply ``u8 status, u32 length,
  payload``), one connection per pool slot, dialled at first use and again
  after a socket error — the counterpart of the Go shim
  (``go/scorerclient/``).  A status-1 reply raises :class:`RpcError`
  carrying the server's message, classified as the Go shim classifies it
  (``_RAW_CODES``): "is not resident" is the stale-baseline case
  (FAILED_PRECONDITION: the baseline is invalidated and the next Sync is
  full); a socket error is transient (UNAVAILABLE, or DEADLINE_EXCEEDED on
  a timeout).

Both channels raise :class:`RpcError`, whose ``code()`` is a
``bridge/server.py StatusCode``, so the retry, shed and deadline logic
below is one for both.

Read replicas (``followers=``): Score round-robins over the followers'
leaf layer and falls back to the leader for a follower that lags; Sync
and Assign go to the leader, and on a follower's "one writer" refusal or
a dead leader they probe the tier for the promoted one.
"""

from __future__ import annotations

import functools
import itertools
import os
import re
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.bridge import udsserver, wire
from koordinator_tpu_torch.bridge.server import StatusCode
from koordinator_tpu_torch.bridge.state import numpy_to_tensor
from koordinator_tpu_torch.obs.export import SpanExporter, resolve_export_dir
from koordinator_tpu_torch.obs.lockwitness import witness_lock, witness_rlock
from koordinator_tpu_torch.obs.spans import ClientTraceOp
from koordinator_tpu_torch.replication.retry import BackoffPolicy

RAW_SCHEME = "raw://"

# every stub call carries a transport deadline so a hung daemon can never
# hang the caller forever; generous by default (a cold kernel build is
# seconds, a large first Sync more) and tightened per call by the
# propagated deadline budget
DEFAULT_RPC_TIMEOUT_MS = 300_000.0

_RETRY_AFTER_RE = re.compile(r"retry_after_ms=(\d+(?:\.\d+)?)")

# channel-level failures: the RPC may or may not have reached the server,
# but the CLIENT state is intact — retryable through the shared backoff
# policy, and never a reason to null the delta baseline (the
# generation-continuity check catches an ambiguous apply on the next acked
# Sync)
_TRANSIENT_CODES = (StatusCode.UNAVAILABLE, StatusCode.DEADLINE_EXCEEDED)

# a raw error frame's message -> its status code, first match wins: the
# texts the servicer's errors carry (SnapshotNotResident,
# ResourceExhausted, BreakerOpen, DeadlineExpired); the Go shim's
# isStaleSnapshot / IsResourceExhausted / IsBreakerOpen /
# IsDeadlineExceeded
_RAW_CODES = (
    ("is not resident", StatusCode.FAILED_PRECONDITION),
    # a read replica's Sync refusal (replication/follower.py NotLeader)
    ("one writer", StatusCode.FAILED_PRECONDITION),
    ("RESOURCE_EXHAUSTED", StatusCode.RESOURCE_EXHAUSTED),
    ("BREAKER_OPEN", StatusCode.UNAVAILABLE),
    ("DEADLINE_EXCEEDED", StatusCode.DEADLINE_EXCEEDED),
)

_METHODS = {
    "Sync": (udsserver.METHOD_SYNC, wire.SyncReply),
    "Score": (udsserver.METHOD_SCORE, wire.ScoreReply),
    "Assign": (udsserver.METHOD_ASSIGN, wire.AssignReply),
}


class RpcError(Exception):
    """One failed RPC on either channel: ``code()`` is its
    ``StatusCode``, ``details()`` the server's (or the transport's)
    message."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


def _raw_code(message: str) -> StatusCode:
    for text, code in _RAW_CODES:
        if text in message:
            return code
    return StatusCode.UNKNOWN


def _is_transient(exc: BaseException) -> bool:
    return isinstance(exc, RpcError) and exc.code() in _TRANSIENT_CODES


def _is_shed(exc: BaseException) -> bool:
    """An admission-gate shed (RESOURCE_EXHAUSTED + retry-after hint):
    transient BY CONTRACT — the server is healthy and said when to come
    back — and never a reason to touch the delta baseline."""
    return (
        isinstance(exc, RpcError)
        and exc.code() == StatusCode.RESOURCE_EXHAUSTED
    )


def _is_not_leader(exc: BaseException) -> bool:
    """A follower's Sync refusal: a probe result, not an error — the
    promoted leader is elsewhere."""
    return (
        isinstance(exc, RpcError)
        and exc.code() == StatusCode.FAILED_PRECONDITION
        and "one writer" in (exc.details() or "")
    )


def retry_after_ms(exc: BaseException) -> Optional[float]:
    """The machine-parsable ``retry_after_ms=<n>`` hint a shed or
    breaker-open reply carries, or None: the port's ``RpcError``, or a
    ``grpc.RpcError`` (any error whose ``details()`` is the status's)."""
    details = getattr(exc, "details", None)
    if not isinstance(exc, Exception) or not callable(details):
        return None
    m = _RETRY_AFTER_RE.search(details() or "")
    return float(m.group(1)) if m else None


def parse_snapshot_id(snapshot_id: str) -> Tuple[str, int]:
    """Server snapshot ids are "s<epoch>-<generation>" (bridge/server.py;
    the epoch is a per-boot nonce).  Legacy epoch-less "s<generation>" ids
    parse with an empty epoch; malformed ids yield generation -1, which
    never satisfies a continuity check."""
    body = snapshot_id[1:] if snapshot_id.startswith("s") else snapshot_id
    epoch, sep, gen = body.rpartition("-")
    if not sep:
        epoch, gen = "", body
    try:
        return epoch, int(gen)
    except ValueError:
        return epoch, -1


def parse_follower_target(target: str) -> Tuple[str, int]:
    """Split a read-replica target's optional relay-tree depth annotation:
    ``"unix:///f.sock@2"`` -> ``("unix:///f.sock", 2)``.  Un-annotated
    targets are depth 1 (a direct follower), and a trailing ``@<non-int>``
    is part of the address, not an annotation (abstract sockets and IPv6
    hosts may legitimately contain ``@``)."""
    addr, sep, depth = target.rpartition("@")
    if sep:
        try:
            return addr, max(1, int(depth))
        except ValueError:
            pass
    return target, 1


class _Channel:
    """One connection of a pool: ``call(method, request, timeout)`` with
    ``method`` one of Sync/Score/Assign, and ``close()``."""

    def __init__(self, call, close):
        self.call = call
        self.close = close


class _RawChannel:
    """One raw-framing connection to ``path``, dialled at first use and
    again after a socket error.  Calls on one connection are serialised
    (a frame's reply follows its request on the stream)."""

    def __init__(self, path: str):
        self.path = path
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def call(self, method: str, request, timeout: float):
        code, reply_cls = _METHODS[method]
        body = request.SerializeToString()
        with self._lock:
            try:
                if self._sock is None:
                    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    try:
                        sock.settimeout(timeout)
                        sock.connect(self.path)
                    except BaseException:
                        sock.close()
                        raise
                    self._sock = sock
                self._sock.settimeout(timeout)
                self._sock.sendall(struct.pack(">BI", code, len(body)) + body)
                status, length = struct.unpack(">BI", self._recv(5))
                if length > udsserver._MAX_FRAME:
                    raise ConnectionError(
                        f"reply frame of {length} bytes exceeds the "
                        f"{udsserver._MAX_FRAME}-byte cap"
                    )
                payload = self._recv(length)
            except TimeoutError as exc:
                self._drop_locked()
                raise RpcError(
                    StatusCode.DEADLINE_EXCEEDED,
                    f"raw UDS {method} to {self.path} timed out after "
                    f"{timeout:.3f} s",
                ) from exc
            except OSError as exc:
                self._drop_locked()
                raise RpcError(
                    StatusCode.UNAVAILABLE,
                    f"raw UDS {method} to {self.path}: {exc}",
                ) from exc
        if status != 0:
            message = payload.decode("utf-8", "replace")
            raise RpcError(_raw_code(message), message)
        return reply_cls.FromString(payload)

    def _recv(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(min(n - len(buf), 1 << 22))
            if not chunk:
                raise ConnectionError("the scorer closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def _drop_locked(self) -> None:
        """Close the connection; the caller holds ``_lock``."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop_locked()


@functools.lru_cache(maxsize=None)
def _grpc_rpc_error(grpc_error: type) -> type:
    """The error the gRPC channel raises: the port's ``RpcError`` that is
    also a ``grpc.RpcError``, so a caller catches it as the reference's
    client's error (built here, where ``grpc`` is imported)."""
    return type("GrpcRpcError", (RpcError, grpc_error), {"__module__": __name__})


def _grpc_channel(target: str, slot: int) -> _Channel:
    """A gRPC channel to ``target`` with one generic unary stub per
    method.  Each pool slot carries a distinct ``koord.pool_slot`` channel
    arg: gRPC core shares one subchannel between channels with identical
    args, so without it N channels would be one connection.  Frames are
    unbounded, matching ``make_server``."""
    import grpc

    channel = grpc.insecure_channel(
        target,
        options=(
            ("koord.pool_slot", slot),
            ("grpc.max_receive_message_length", -1),
            ("grpc.max_send_message_length", -1),
        ),
    )
    stubs = {
        method: channel.unary_unary(
            wire.method_path(method),
            request_serializer=lambda msg: msg.SerializeToString(),
            response_deserializer=reply_cls.FromString,
        )
        for method, (_, reply_cls) in _METHODS.items()
    }

    error = _grpc_rpc_error(grpc.RpcError)

    def call(method: str, request, timeout: float):
        try:
            return stubs[method](request, timeout=timeout)
        except grpc.RpcError as exc:
            status = exc.code()
            code = getattr(StatusCode, getattr(status, "name", ""), None)
            raise error(code or StatusCode.UNKNOWN, exc.details() or "") from exc

    return _Channel(call, channel.close)


def _open_channel(target: str, slot: int):
    if target.startswith(RAW_SCHEME):
        return _RawChannel(target[len(RAW_SCHEME):])
    return _grpc_channel(target, slot)


class _ChannelPool:
    """Round-robin pool of independent connections.  One gRPC channel
    multiplexes every in-flight RPC onto one HTTP/2 connection, and one
    raw connection serialises its frames, so a 16-way Score burst needs
    ``size`` real connections to reach the coalescer concurrently.
    Callers round-robin over ``channels`` themselves."""

    def __init__(self, target: str, size: int):
        self.channels = [
            _open_channel(target, i) for i in range(max(1, int(size)))
        ]

    def close(self) -> None:
        for ch in self.channels:
            ch.close()


def _stub(channel, method: str):
    return functools.partial(channel.call, method)


class ScorerClient:
    def __init__(self, target: str, channels: int = 1,
                 followers: Sequence[str] = (),
                 retry_policy: Optional[BackoffPolicy] = None,
                 band: str = "",
                 deadline_ms: Optional[float] = None,
                 rpc_timeout_ms: Optional[float] = None,
                 trace_export: Optional[str] = None):
        """``target``: ``"raw:///path.sock"`` (the raw framing),
        ``"unix:///path.sock"`` or ``host:port`` (gRPC).

        ``channels``: size of the connection pool Score/Assign calls
        round-robin over (default 1).  Size it to the caller's worker
        parallelism.  Sync stays PINNED to the first connection: delta
        frames are order-sensitive against the acked baseline, and one
        connection preserves their wire order.

        ``followers``: targets of read-replica daemons (either scheme).
        Sync keeps going to ``target`` (the leader, the tier's one
        writer); Score round-robins over the followers, and a follower
        still catching up (its FAILED_PRECONDITION means "that generation
        has not replicated here yet") falls back to the leader for that
        one call.  Assign stays on the leader.  A target may carry a
        relay-tree depth (``"raw:///f.sock@2"``); Score then uses the
        deepest layer only.  Sync and Assign retries probe every
        follower for a promoted leader: a follower's "one writer" refusal
        means "not me, keep looking".

        ``retry_policy``: the shared jittered-exponential backoff and
        deadline budget (``replication.retry.BackoffPolicy``; default
        from the ``KOORD_RETRY_*`` envs) that paces every channel-level
        retry.  Transient errors (UNAVAILABLE / DEADLINE_EXCEEDED) retry
        WITHOUT touching the delta baseline.

        ``band``: this client's priority band (koord-prod|mid|batch|free;
        empty = prod treatment), stamped on every Score/Assign for the
        daemon's admission gate.

        ``deadline_ms``: per-RPC deadline budget stamped onto the wire
        (``deadline_ms`` request field) and set as the transport deadline
        for Score/Assign.  Default from ``KOORD_DEADLINE_MS`` (unset =
        none).  Shed and breaker replies carry a ``retry_after_ms`` hint;
        a retry sleeps the hint in place of the backoff delay.

        ``rpc_timeout_ms``: transport deadline applied to EVERY call
        (``KOORD_RPC_TIMEOUT_MS``, default 300 s); ``deadline_ms``
        tightens it per call when set.

        ``trace_export``: directory this client appends its own completed
        spans to as JSON lines (default from ``KOORD_TRACE_EXPORT``;
        unset = tracing off).  Every logical RPC mints one trace id and a
        root op span, every ATTEMPT a child span stamped as the wire
        ``parent_span``, and the server's echoed ``server_span`` is
        recorded on the attempt (``python -m
        koordinator_tpu_torch.obs.assemble`` over the export dirs)."""
        self._pool = _ChannelPool(target, channels)
        self.band = band or ""
        # `or`: an empty env value means unset (the KOORD_* convention)
        if deadline_ms is None:
            env = os.environ.get("KOORD_DEADLINE_MS") or ""
            deadline_ms = float(env) if env else 0.0
        self._deadline_ms = max(0.0, float(deadline_ms))
        if rpc_timeout_ms is None:
            rpc_timeout_ms = float(
                os.environ.get("KOORD_RPC_TIMEOUT_MS")
                or DEFAULT_RPC_TIMEOUT_MS
            )
        self._rpc_timeout_ms = max(1.0, float(rpc_timeout_ms))
        self._channel = self._pool.channels[0]  # Sync's pinned connection
        self._retry = retry_policy or BackoffPolicy.from_env()

        self._sync = _stub(self._channel, "Sync")
        self._scores = [_stub(ch, "Score") for ch in self._pool.channels]
        self._assigns = [_stub(ch, "Assign") for ch in self._pool.channels]
        parsed = [parse_follower_target(t) for t in followers]
        self._follower_depths = [d for _, d in parsed]
        self._follower_pools = [_ChannelPool(t, 1) for t, _ in parsed]
        # the leaf layer (the deepest annotated depth) is Score's
        # round-robin set; every follower stays in the writer probe order
        max_depth = max(self._follower_depths, default=0)
        self._leaf_indices = [
            i for i, d in enumerate(self._follower_depths) if d == max_depth
        ]
        self._follower_scores = [
            _stub(p.channels[0], "Score") for p in self._follower_pools
        ]
        self._follower_syncs = [
            _stub(p.channels[0], "Sync") for p in self._follower_pools
        ]
        self._follower_assigns = [
            _stub(p.channels[0], "Assign") for p in self._follower_pools
        ]
        # which target holds the writer role: -1 = the configured leader,
        # i = follower i, promoted (found by a writer probe)
        self._leader_idx = -1
        self._rr = itertools.count()
        self._rr_lock = witness_lock("bridge.client.ScorerClient._rr_lock")
        # previous-ACKED-sync mirrors (tensor + scalar columns) for delta
        # encoding and full re-sync.  New values are staged per request
        # and promoted only after the server confirms the Sync, so a
        # failed RPC can never desync the delta baseline.  The lock makes
        # sync()'s read-encode-promote sequence atomic against
        # _invalidate() on a pooled Score thread.
        self._baseline_lock = witness_rlock(
            "bridge.client.ScorerClient._baseline_lock")
        self._prev: Dict[str, np.ndarray] = {}
        self._prev_scalars: Dict[str, tuple] = {}
        self._generation: Optional[int] = None
        self._epoch: Optional[str] = None
        self.snapshot_id: Optional[str] = None
        # whether the last flat Score reply carried the brownout degraded
        # flag
        self.last_degraded = False
        self._exporter: Optional[SpanExporter] = None
        export_to = resolve_export_dir(trace_export)
        if export_to is not None:
            self._exporter = SpanExporter(export_to, service="scorer-client")

    def close(self) -> None:
        self._pool.close()
        for p in self._follower_pools:
            p.close()
        if self._exporter is not None:
            self._exporter.close()

    # -- distributed tracing --
    def _trace_op(self, name: str) -> Optional[ClientTraceOp]:
        """One logical RPC's trace (root op span + per-attempt child
        spans), or None when tracing is off."""
        if self._exporter is None:
            return None
        return ClientTraceOp(name, sink=self._exporter.export)

    def _traced_call(self, op: Optional[ClientTraceOp], stub, request,
                     timeout: float):
        """One ATTEMPT: stamp the op's trace context on the request (each
        attempt re-stamps its own span id as ``parent_span``), invoke,
        record the server's echoed span id, end — or abort with the error
        so sheds, deadlines and transport failures stay visible per
        attempt in the assembled tree."""
        if op is None:
            return stub(request, timeout=timeout)
        span = op.attempt()
        request.trace_id = op.trace_id
        request.parent_span = span.span_id
        try:
            reply = stub(request, timeout=timeout)
        except BaseException as exc:
            span.abort(exc)
            raise
        server_span = getattr(reply, "server_span", "") or ""
        if server_span:
            span.set_attr("server_span", server_span)
        span.end()
        return reply

    def _slot(self) -> int:
        with self._rr_lock:
            return next(self._rr) % len(self._scores)

    def _timeout_s(self) -> float:
        """Transport deadline for one call: the client-wide cap,
        tightened by the propagated per-RPC budget when one is set."""
        t = self._rpc_timeout_ms
        if self._deadline_ms > 0.0:
            t = min(t, self._deadline_ms)
        return t / 1000.0

    def _pause_ms(self, delays, last: Optional[BaseException]):
        """The ONE pause before the next retry attempt, or None when the
        budget is spent: a server retry-after hint REPLACES the backoff
        delay for this attempt (capped at the policy's backoff ceiling),
        so a hint can never double-count against the budget."""
        d_ms = next(delays, None)
        if d_ms is None:
            return None
        hint = retry_after_ms(last) if last is not None else None
        if hint is not None:
            return min(hint, self._retry.cap_ms)
        return d_ms

    def _writer_stubs(self, kind: str):
        """``(idx, stub)`` probe order for a writer-side RPC: the target
        last seen holding the writer role first, then every other one
        (the configured leader, then each follower)."""
        leader_stub = (
            self._sync if kind == "sync" else self._assigns[self._slot()]
        )
        table = [(-1, leader_stub)] + list(enumerate(
            self._follower_syncs if kind == "sync" else self._follower_assigns
        ))
        active = self._leader_idx
        table.sort(key=lambda e: 0 if e[0] == active else 1)
        return table

    def _call_writer(self, kind: str, request, op=None):
        """Invoke a writer-side RPC (Sync/Assign) on the active leader,
        failing over through the shared backoff policy: transient errors
        retry, "one writer" refusals probe the next candidate, sheds retry
        after the server's hint, anything else surfaces immediately (it is
        the SERVER's answer).  The delta baseline is never touched here."""
        delays = self._retry.delays()
        timeout = self._timeout_s()
        while True:
            last: Optional[BaseException] = None
            for idx, stub in self._writer_stubs(kind):
                try:
                    reply = self._traced_call(op, stub, request, timeout)
                    self._leader_idx = idx
                    return reply
                except RpcError as exc:
                    if _is_not_leader(exc) or _is_transient(exc) or _is_shed(exc):
                        last = exc
                        continue
                    raise
            pause = self._pause_ms(delays, last)
            if pause is None:
                raise last
            time.sleep(pause / 1000.0)

    def _score_stub(self):
        """``(stub, on_follower)``: round-robin over the leaf-layer
        followers when configured, else over the leader's pool."""
        if self._follower_scores:
            with self._rr_lock:
                i = self._leaf_indices[next(self._rr) % len(self._leaf_indices)]
            return self._follower_scores[i], True
        return self._scores[self._slot()], False

    def _leader_score_stub(self):
        """The active writer's Score stub, the lag fallback: after a
        promotion the configured leader may be dead, so the fallback
        follows the role."""
        if 0 <= self._leader_idx < len(self._follower_scores):
            return self._follower_scores[self._leader_idx]
        return self._scores[self._slot()]

    def _call_score(self, request, op=None):
        """Reads retry freely: they are idempotent against a named
        snapshot, so a transient error moves to the next replica or
        connection under the shared backoff budget; a shed retries after
        the server's hint."""
        delays = self._retry.delays()
        timeout = self._timeout_s()
        while True:
            stub, on_follower = self._score_stub()
            if on_follower:
                try:
                    return self._traced_call(op, stub, request, timeout)
                except RpcError as e:
                    if _is_transient(e) or _is_shed(e):
                        pause = self._pause_ms(delays, e)
                        if pause is None:
                            raise
                        time.sleep(pause / 1000.0)
                        continue  # the next replica
                    if e.code() != StatusCode.FAILED_PRECONDITION:
                        raise
                    # the follower has not applied this generation yet:
                    # the leader certified the id, so the baseline is
                    # fine — serve this call there
            try:
                return self._call(self._leader_score_stub(), request, op=op)
            except RpcError as e:
                if not (_is_transient(e) or _is_shed(e)):
                    raise
                pause = self._pause_ms(delays, e)
                if pause is None:
                    raise
                time.sleep(pause / 1000.0)

    def _invalidate(self) -> None:
        with self._baseline_lock:
            self._prev.clear()
            self._prev_scalars.clear()
            self._generation = None
            self._epoch = None
            self.snapshot_id = None

    def _with_op(self, name: str, fn):
        """Run one logical RPC under a client trace op: ``fn(op)`` gets the
        op (or None with tracing off); the root span ends — with the
        escaping error attached, or clean — on every exit."""
        op = self._trace_op(name)
        if op is None:
            return fn(None)
        try:
            result = fn(op)
        except BaseException as exc:
            op.finish(error=exc)
            raise
        op.finish()
        return result

    def sync(self, **kwargs) -> "wire.SyncReply":
        """One logical Sync (delta-encoded against the acked baseline; see
        :meth:`_sync_op` for the keyword surface).  Traced as ONE op: the
        delta attempt, its retries and the full-resend fallback
        are sibling attempt spans of the same trace."""
        return self._with_op(
            "sync", lambda op: self._sync_op(op, **kwargs)
        )

    def _sync_op(
        self,
        op=None,
        *,
        node_allocatable: Optional[np.ndarray] = None,
        node_requested: Optional[np.ndarray] = None,
        node_usage: Optional[np.ndarray] = None,
        node_names: Sequence[str] = (),
        metric_fresh: Optional[Sequence[bool]] = None,
        pod_requests: Optional[np.ndarray] = None,
        pod_estimated: Optional[np.ndarray] = None,
        pod_names: Sequence[str] = (),
        priority: Optional[Sequence[int]] = None,
        gang_id: Optional[Sequence[int]] = None,
        quota_id: Optional[Sequence[int]] = None,
        gang_min_member: Sequence[int] = (),
        quota_runtime: Optional[np.ndarray] = None,
        quota_used: Optional[np.ndarray] = None,
        quota_limited: Optional[np.ndarray] = None,
        node_bucket: int = 0,
        pod_bucket: int = 0,
        node_accel_type: Optional[Sequence[int]] = None,
        workload_class: Optional[Sequence[int]] = None,
        pod_sensitivity: Optional[np.ndarray] = None,
        throughput: Optional[np.ndarray] = None,
    ) -> "wire.SyncReply":
        tensors = {
            "nalloc": node_allocatable,
            "nreq": node_requested,
            "nuse": node_usage,
            "preq": pod_requests,
            "pest": pod_estimated,
            "qrt": quota_runtime,
            "quse": quota_used,
            "qlim": quota_limited,
            # the fused-term tensors ride the same delta-encoding path
            "psens": pod_sensitivity,
            "tput": throughput,
        }
        scalars = {
            "node_names": tuple(node_names),
            "metric_fresh": (
                tuple(bool(b) for b in metric_fresh)
                if metric_fresh is not None
                else None
            ),
            "pod_names": tuple(pod_names),
            "priority": tuple(priority) if priority is not None else None,
            "gang_id": tuple(gang_id) if gang_id is not None else None,
            "quota_id": tuple(quota_id) if quota_id is not None else None,
            "gang_min": tuple(gang_min_member),
            "accel_type": (
                tuple(int(v) for v in node_accel_type)
                if node_accel_type is not None
                else None
            ),
            "workload_class": (
                tuple(int(v) for v in workload_class)
                if workload_class is not None
                else None
            ),
        }

        staged: Dict[str, np.ndarray] = {}
        staged_scalars: Dict[str, tuple] = {}

        def build(baseline: Dict[str, np.ndarray], full: bool):
            staged.clear()
            staged_scalars.clear()

            def tensor(key):
                arr = tensors[key]
                if full and arr is None:
                    arr = baseline.get(key)  # resend last acked state
                if arr is None:
                    return wire.Tensor()
                # a copy, never the caller's array: a caller that mutates
                # its arrays in place between Syncs would otherwise mutate
                # the acked baseline too, and every later delta would be
                # empty (the reference's client aliases here)
                a = np.array(arr, np.int64, order="C")
                t = numpy_to_tensor(a, None if full else baseline.get(key))
                staged[key] = a
                return t

            def scalar(key):
                val = scalars[key]
                if (val is None or val == ()) and full:
                    val = self._prev_scalars.get(key)
                # the server treats empty repeated fields as "unchanged",
                # so only non-empty values become the acked baseline
                if val:
                    staged_scalars[key] = val
                return val

            req = wire.SyncRequest(node_bucket=node_bucket,
                                   pod_bucket=pod_bucket)
            req.nodes.allocatable.CopyFrom(tensor("nalloc"))
            req.nodes.requested.CopyFrom(tensor("nreq"))
            req.nodes.usage.CopyFrom(tensor("nuse"))
            req.nodes.names.extend(scalar("node_names") or ())
            fresh = scalar("metric_fresh")
            if fresh is not None:
                req.nodes.metric_fresh.extend(fresh)
            req.pods.requests.CopyFrom(tensor("preq"))
            req.pods.estimated.CopyFrom(tensor("pest"))
            req.pods.names.extend(scalar("pod_names") or ())
            prio = scalar("priority")
            if prio is not None:
                req.pods.priority.extend(int(v) for v in prio)
            gang = scalar("gang_id")
            if gang is not None:
                req.pods.gang_id.extend(int(v) for v in gang)
            quota = scalar("quota_id")
            if quota is not None:
                req.pods.quota_id.extend(int(v) for v in quota)
            req.gangs.min_member.extend(
                int(v) for v in scalar("gang_min") or ()
            )
            req.quotas.runtime.CopyFrom(tensor("qrt"))
            req.quotas.used.CopyFrom(tensor("quse"))
            req.quotas.limited.CopyFrom(tensor("qlim"))
            accel = scalar("accel_type")
            if accel is not None:
                req.nodes.accel_type.extend(accel)
            wclass = scalar("workload_class")
            if wclass is not None:
                req.pods.workload_class.extend(wclass)
            req.pods.sensitivity.CopyFrom(tensor("psens"))
            req.terms.throughput.CopyFrom(tensor("tput"))
            return req

        # the lock is held across the RPCs: a pooled Score thread's
        # _invalidate must not clear the dict build() is delta-encoding
        # from, nor null _generation between the reply and the continuity
        # check below — it waits, then wipes the fresh baseline, and the
        # NEXT sync ships full state
        with self._baseline_lock:
            baseline = self._prev
            sent_full = False
            try:
                reply = self._call_writer(
                    "sync", build(baseline, full=False), op=op
                )
            except RpcError as exc:
                if _is_transient(exc) or _is_not_leader(exc):
                    # a channel-level failure that outlived the retry and
                    # probe budget (its last answer may be a follower's
                    # "one writer" refusal): the BASELINE IS KEPT — nothing
                    # verifiably applied; the continuity check below guards
                    # the ambiguous-apply case on the next sync
                    raise
                if not baseline:
                    # nothing was delta-encoded; resending full state
                    # cannot recover
                    self._invalidate()
                    raise
                # a restarted sidecar lost its resident tensors and
                # refused the delta frame: one full re-sync within the
                # same cycle; a second failure is surfaced
                try:
                    reply = self._call_writer(
                        "sync", build(baseline, full=True), op=op
                    )
                    sent_full = True
                except RpcError:
                    self._invalidate()
                    raise
            epoch, gen = parse_snapshot_id(reply.snapshot_id)
            if self._generation is not None and not sent_full and (
                epoch != self._epoch or gen != self._generation + 1
            ):
                # another client synced in between, or the server
                # restarted (a fresh epoch — the bare generation can line
                # up by coincidence after a restart): our deltas were
                # applied onto a base we never saw.  Re-sync full tensors
                # from the pre-clear baseline, so fields omitted this
                # cycle still resend their last acked state.
                try:
                    reply = self._call_writer(
                        "sync", build(baseline, full=True), op=op
                    )
                except RpcError:
                    # the server may have applied the full sync before
                    # failing; the baseline is unknown
                    self._invalidate()
                    raise
                epoch, gen = parse_snapshot_id(reply.snapshot_id)
            self._prev = dict(baseline, **staged)
            self._prev_scalars.update(staged_scalars)
            self._generation = gen
            self._epoch = epoch
            self.snapshot_id = reply.snapshot_id
            return reply

    # -- score / assign --
    def _call(self, stub, request, op=None):
        """Invoke Score/Assign; on FAILED_PRECONDITION (our snapshot was
        displaced by another client's Sync) invalidate the baseline so the
        caller's next sync() ships full state, then surface the error."""
        try:
            return self._traced_call(op, stub, request, self._timeout_s())
        except RpcError as e:
            if e.code() == StatusCode.FAILED_PRECONDITION:
                self._invalidate()
            raise

    def _score_request(self, top_k: int, flat: bool = False):
        """One Score request with the propagated deadline budget and this
        client's band stamped on."""
        return wire.ScoreRequest(
            snapshot_id=self.snapshot_id or "", top_k=top_k, flat=flat,
            deadline_ms=int(self._deadline_ms), band=self.band,
        )

    def score(self, top_k: int = 0) -> List[List[Tuple[int, int]]]:
        reply = self._with_op(
            "score",
            lambda op: self._call_score(self._score_request(top_k), op=op),
        )
        return [
            list(zip(entry.node_index, entry.score)) for entry in reply.pods
        ]

    def score_flat(
        self, top_k: int = 0
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Flat top-k layout: (pod_index, counts, node_index, score) numpy
        arrays decoded straight from the packed reply bytes.  Entry group g
        (pod pod_index[g]) covers counts[g] consecutive entries."""
        reply = self._with_op(
            "score",
            lambda op: self._call_score(
                self._score_request(top_k, flat=True), op=op
            ),
        )
        # True when the LAST flat Score was served stale from the daemon's
        # brownout cache while its breaker was open
        self.last_degraded = bool(reply.degraded)
        if not reply.HasField("flat"):
            # empty arrays would read as "no feasible node for any pod":
            # fail loudly instead
            raise RuntimeError(
                "scorer did not return the flat layout (server too old?); "
                "use score() for the legacy per-pod lists"
            )
        # .copy(): frombuffer over reply bytes is read-only; callers get
        # writable arrays like assign() returns
        return (
            np.frombuffer(reply.flat.pod_index, "<i4").copy(),
            np.frombuffer(reply.flat.counts, "<i4").copy(),
            np.frombuffer(reply.flat.node_index, "<i4").copy(),
            np.frombuffer(reply.flat.score, "<i8").copy(),
        )

    def assign(self) -> Tuple[np.ndarray, np.ndarray, float, str]:
        """Returns (assignment, status, cycle_ms, path); ``path`` names the
        route that ran (``"cuda"`` on the card, ``"scan"``/``"wave"`` on
        the CPU) so callers can alarm on an unexpected route."""
        return self._with_op("assign", self._assign_op)

    def _assign_op(self, op=None):
        try:
            reply = self._call_writer(
                "assign",
                wire.AssignRequest(
                    snapshot_id=self.snapshot_id or "",
                    deadline_ms=int(self._deadline_ms),
                    band=self.band,
                ),
                op=op,
            )
        except RpcError as e:
            # a displaced snapshot (stale-id FAILED_PRECONDITION): the
            # baseline is gone — next sync ships full state
            if e.code() == StatusCode.FAILED_PRECONDITION:
                self._invalidate()
            raise
        return (
            np.asarray(reply.assignment, np.int32),
            np.asarray(reply.status, np.int32),
            reply.cycle_ms,
            reply.path,
        )
