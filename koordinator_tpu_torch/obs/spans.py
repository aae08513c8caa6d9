"""Low-overhead monotonic span recorder for the scoring pipeline.

Copy of ``koordinator_tpu/obs/spans.py``: host-side Python only.

One *cycle* is the unit of correlation: everything that happens between
two Assign (or Score) completions — delta-Sync decodes, device
scatters, dispatch, readback — accumulates on the current
:class:`CycleSpans` under one explicit ``cycle_id``, and ``commit()``
turns it into a plain-dict record for the metric families and the
flight recorder (obs/flight.py).

Design constraints:

* **No host syncs, no retraces.**  The recorder only ever touches
  host-side Python scalars: ``begin_span``/``end_span`` read a
  monotonic clock and append to a list; ``note()`` stores values the
  caller already materialized.  Nothing here touches the device.
  Device-derived stats (``rounds``, ``path``,
  ``wave_ms``) enter through ``note()`` AFTER the caller materialized
  the result, never from inside the device program.
* **Bounded memory.**  A cycle caps its span count; a serve loop that
  never commits (Score-only traffic was the hazard) cannot grow without
  bound — overflowing spans are counted, not stored.
* **Leak-proof spans.**  ``span()`` is the context-manager form and the
  only one most call sites should use; raw ``begin_span`` callers must
  end the span on every exit path (try/finally or the context
  manager).
* **Thread-safe recorder.**  Since the coalescing dispatch engine
  split the servicer's single lock, RPC
  bodies no longer serialize the recorder for free: a Score batch
  leader, a pipelined Sync commit and an Assign device section can all
  touch the current cycle.  :class:`SpanRecorder` therefore guards its
  public API with a small RLock (host-side, ~100ns — invisible next to
  a device launch); :class:`CycleSpans` itself stays lock-free and is
  only reached through the recorder.
"""

from __future__ import annotations

import contextlib
import time
import uuid
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.obs.lockwitness import witness_rlock

# hard cap on spans buffered per cycle: a runaway instrumentation loop
# must cost a counter bump, not memory
MAX_SPANS_PER_CYCLE = 256

# the one cross-trace link type: the many RPC spans of a
# coalesced batch — and every memo/brownout serve — reference the ONE
# launch/readback span that produced the shared bytes
LINK_FANIN = "fanin"


def mint_trace_id() -> str:
    """32-hex trace id, minted ONCE per logical client request; every
    retry/failover attempt keeps it, so the attempts assemble into one
    tree (obs/assemble.py)."""
    return uuid.uuid4().hex


def mint_span_id() -> str:
    """16-hex span id for spans minted outside a SpanRecorder (client
    shims; servers use ``SpanRecorder.mint_span_id`` so ids stay
    deterministic under a pinned epoch — the golden-fixture contract)."""
    return uuid.uuid4().hex[:16]


class TraceSpan:
    """One exportable span of a cross-process distributed trace
   .  Unlike the cycle-scoped stage spans below, a TraceSpan
    carries an identity — ``(trace_id, span_id)`` — a parent link, and
    fan-in links to spans in OTHER traces, so the offline assembler
    (``python -m koordinator_tpu_torch.obs.assemble``) can merge per-process
    exports into one whole-request tree.

    Single-shot: ``end()`` (or ``abort()``) finalizes the span exactly
    once and hands the OTLP-shaped record to ``sink`` (the process's
    SpanExporter, obs/export.py).  Host-side Python scalars only — the
    same no-host-sync contract as the rest of this module.  Call sites
    that create one MUST end or abort it on every exit path; the
    context-manager form is leak-proof by construction."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "kind",
        "start_unix", "_clock", "_t0", "dur_ms", "error",
        "attrs", "links", "_sink", "_done",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str] = None,
        kind: str = "server",
        sink=None,
        attrs: Optional[Dict[str, object]] = None,
        clock=time.perf_counter,
        wall_clock=time.time,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id or None
        self.kind = kind
        self.start_unix = wall_clock()
        self._clock = clock
        self._t0 = clock()
        self.dur_ms: Optional[float] = None
        self.error: Optional[str] = None
        self.attrs: Dict[str, object] = dict(attrs or {})
        self.links: List[Dict[str, str]] = []
        self._sink = sink
        self._done = False

    @property
    def ref(self) -> Tuple[str, str]:
        """The cross-process handle other spans link to."""
        return (self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> None:
        """Host-side scalars only (the ``note()`` contract)."""
        self.attrs[key] = value

    def link(self, trace_id: str, span_id: str,
             link_type: str = LINK_FANIN) -> None:
        """Reference a span that may live in a DIFFERENT trace — the
        fan-in shape: N coalesced RPC spans -> one launch span."""
        self.links.append({
            "traceId": trace_id, "spanId": span_id, "type": link_type,
        })

    def link_ref(self, ref: Optional[Tuple[str, str]],
                 link_type: str = LINK_FANIN) -> None:
        """``link()`` over a stored ``(trace_id, span_id)`` ref (memo /
        brownout entries store these); None is a no-op so cache entries
        produced by an untraced launch need no branching."""
        if ref is not None:
            self.link(ref[0], ref[1], link_type)

    def end(self, error: Optional[str] = None) -> None:
        """Finalize and export.  Idempotent: the first end/abort wins,
        so a ``finally: span.end()`` after an except-path ``abort()``
        cannot double-export."""
        if self._done:
            return
        self._done = True
        self.dur_ms = (self._clock() - self._t0) * 1000.0
        if error is not None:
            self.error = error
        sink = self._sink
        if sink is not None:
            sink(self.to_record())

    def abort(self, exc: BaseException) -> None:
        self.end(error=f"{exc!r:.200}")

    def __enter__(self) -> "TraceSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.abort(exc)
        else:
            self.end()
        return False

    def to_record(self) -> Dict[str, object]:
        """The OTLP-shaped JSON-line body obs/export.py appends — flat
        camelCase keys, nanosecond wall stamps, links with the fan-in
        type in their attributes (obs/assemble.py is the reader)."""
        start_ns = int(self.start_unix * 1e9)
        dur_ns = int((self.dur_ms or 0.0) * 1e6)
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "startTimeUnixNano": start_ns,
            "endTimeUnixNano": start_ns + dur_ns,
            "durMs": round(self.dur_ms or 0.0, 3),
            "status": (
                {"code": "ERROR", "message": self.error}
                if self.error is not None else {"code": "OK"}
            ),
            "attributes": dict(self.attrs),
            "links": list(self.links),
        }


class ClientTraceOp:
    """Client side of one logical RPC: ONE trace id, a root
    op span, and one child span per ATTEMPT — so a retried-then-shed-
    then-served request is one trace with one span per attempt.  Used
    by bridge/client.py; lives here so the id/record shapes have one
    home."""

    __slots__ = ("trace_id", "root", "attempts", "_sink")

    def __init__(self, name: str, sink=None):
        self._sink = sink
        self.trace_id = mint_trace_id()
        self.attempts = 0
        self.root = TraceSpan(
            name, self.trace_id, mint_span_id(), kind="client", sink=sink,
        )

    def attempt(self, target: str = "") -> TraceSpan:
        """A child span for the next attempt; the caller stamps its id
        as the request's ``parent_span`` and must end/abort it."""
        self.attempts += 1
        span = TraceSpan(
            f"{self.root.name}.attempt", self.trace_id, mint_span_id(),
            parent_id=self.root.span_id, kind="client", sink=self._sink,
            attrs={"attempt": self.attempts},
        )
        if target:
            span.set_attr("target", target)
        return span

    def finish(self, error: Optional[BaseException] = None) -> None:
        self.root.set_attr("attempts", self.attempts)
        if error is not None:
            self.root.abort(error)
        else:
            self.root.end()


class CycleSpans:
    """Span + note accumulator for one cycle.  Plain lists, no locks:
    the owner (ScorerServicer) already serializes RPC bodies."""

    __slots__ = (
        "cycle_id", "snapshot_id", "trace_id", "started_unix", "_t0",
        "_clock", "spans", "notes", "error", "overflow",
    )

    def __init__(self, cycle_id: str, clock=time.perf_counter,
                 wall_clock=time.time):
        self.cycle_id = cycle_id
        self.snapshot_id: Optional[str] = None
        # distributed-trace correlation: the trace id of the
        # request this cycle served, when the client sent one — the
        # flight-recorder record carries it so a bad cycle found in a
        # dump is addressable in the assembled trace tree (and vice
        # versa)
        self.trace_id: Optional[str] = None
        self.started_unix = wall_clock()
        self._clock = clock
        self._t0 = clock()
        # each span is [name, start_s, end_s|None] in monotonic seconds
        # relative to the cycle's _t0
        self.spans: List[list] = []
        self.notes: Dict[str, object] = {}
        self.error: Optional[str] = None
        self.overflow = 0

    def begin(self, name: str) -> int:
        """Open a span; returns the handle ``end()`` closes.  A handle
        of -1 means the cycle's span buffer is full (the matching
        ``end(-1)`` is a no-op, so callers never branch)."""
        if len(self.spans) >= MAX_SPANS_PER_CYCLE:
            self.overflow += 1
            return -1
        self.spans.append([name, self._clock() - self._t0, None])
        return len(self.spans) - 1

    def end(self, handle: int) -> None:
        # the upper bound guards a handle minted by a PREVIOUS cycle
        # (begin before a commit, end after): closing a stranger's span
        # — or crashing the RPC on IndexError — is worse than dropping
        # the stale end
        if handle < 0 or handle >= len(self.spans):
            return
        self.spans[handle][2] = self._clock() - self._t0

    def add_measured(self, name: str, dur_s: float) -> None:
        """Record an already-measured stage as a closed span ending now.

        The coalescing pipeline measures some stages OUTSIDE the lock
        that guards this recorder (a Sync's protobuf->numpy decode, a
        batch leader's shared dispatch/readback) and attaches them at
        the commit point; the start is back-computed and clamped to the
        cycle origin (a decode can legitimately begin before the cycle
        it lands on exists)."""
        if len(self.spans) >= MAX_SPANS_PER_CYCLE:
            self.overflow += 1
            return
        end = self._clock() - self._t0
        self.spans.append([name, max(0.0, end - max(0.0, dur_s)), end])

    def to_record(self) -> Dict[str, object]:
        """Flight-recorder/bench shape: durations in milliseconds; a
        span that never ended carries ``dur_ms: None`` (visible, not
        invented)."""
        return {
            "cycle_id": self.cycle_id,
            "snapshot_id": self.snapshot_id,
            "trace_id": self.trace_id,
            "started_unix": self.started_unix,
            "spans": [
                {
                    "name": name,
                    "start_ms": round(start * 1000.0, 3),
                    "dur_ms": (
                        round((end - start) * 1000.0, 3)
                        if end is not None else None
                    ),
                }
                for name, start, end in self.spans
            ],
            "notes": dict(self.notes),
            "error": self.error,
            "span_overflow": self.overflow,
        }


class _SpanContext:
    """Tiny re-usable with-block over begin/end.  Not @contextmanager:
    a generator frame per span is measurable overhead on the warm path."""

    __slots__ = ("_recorder", "_name", "_handle")

    def __init__(self, recorder: "SpanRecorder", name: str):
        self._recorder = recorder
        self._name = name
        self._handle = -1

    def __enter__(self) -> "_SpanContext":
        self._handle = self._recorder.begin_span(self._name)
        return self

    def __exit__(self, *exc) -> bool:
        self._recorder.end_span(self._handle)
        return False


class CycleScope:
    """One RPC's private cycle.

    Under the coalescing pipeline several RPCs run concurrently, and
    two confirmed record blurs came from them sharing the recorder's
    ONE open cycle: an Assign adopting (and relabeling) a cycle another
    RPC was still stamping, and a displaced Assign's stamps landing on
    the pending cycle awaiting a different client's correlation.
    ``SpanRecorder.open_scope`` detaches a cycle into this wrapper —
    atomically claiming the pending cycle when the RPC is its rightful
    correlator, minting a fresh one otherwise — so concurrent RPCs can
    never stamp or relabel each other's records.  Replies were always
    unaffected; this makes the cycle *records* exact too.

    The API mirrors the recorder's span surface (``span``/``note``/
    ``add_measured``/``begin_span``/``end_span``), so recorder-typed
    call sites (``maybe_span``, ``_assign_cycle``, the shard path)
    accept a scope unchanged.  ``commit()`` returns the record; a scope
    is single-shot and never re-enters the recorder."""

    __slots__ = ("_cycle", "_lock")

    def __init__(self, cycle: CycleSpans):
        self._cycle = cycle
        self._lock = witness_rlock("obs.spans.CycleScope._lock")

    @property
    def cycle_id(self) -> str:
        return self._cycle.cycle_id

    @property
    def snapshot_id(self) -> Optional[str]:
        return self._cycle.snapshot_id

    @property
    def trace_id(self) -> Optional[str]:
        return self._cycle.trace_id

    def begin_span(self, name: str) -> int:
        with self._lock:
            return self._cycle.begin(name)

    def end_span(self, handle: int) -> None:
        with self._lock:
            self._cycle.end(handle)

    def add_measured(self, name: str, dur_s: float) -> None:
        with self._lock:
            self._cycle.add_measured(name, dur_s)

    def span(self, name: str) -> "_SpanContext":
        return _SpanContext(self, name)

    def note(self, key: str, value) -> None:
        with self._lock:
            self._cycle.notes[key] = value

    def commit(self, error: Optional[str] = None) -> Dict[str, object]:
        with self._lock:
            if error is not None:
                self._cycle.error = error
            return self._cycle.to_record()


class SpanRecorder:
    """Owns the current cycle and mints cycle ids ("c<epoch>-<seq>",
    correlating with the sidecar's "s<epoch>-<gen>" snapshot ids)."""

    def __init__(self, epoch: str = "", clock=time.perf_counter,
                 wall_clock=time.time):
        self.epoch = epoch
        self._clock = clock
        self._wall_clock = wall_clock
        self._seq = 0
        # distributed-trace span ids: counter-based and
        # epoch-prefixed like cycle ids, so a pinned epoch makes them
        # deterministic (the golden-fixture regen contract); the sink
        # is the process's exporter, wired by CycleTelemetry
        self._span_seq = 0
        self.trace_sink = None
        self._cycle: Optional[CycleSpans] = None
        # reentrant: commit() calls current(); the lock makes each call
        # atomic against the coalescer's concurrent batch leaders
        self._lock = witness_rlock("obs.spans.SpanRecorder._lock")

    # -- cycle lifecycle --
    def has_pending(self) -> bool:
        """Whether an uncommitted cycle is already accumulating spans
        (e.g. a delta-Sync waiting for the Assign that correlates it)."""
        with self._lock:
            return self._cycle is not None

    # -- distributed-trace spans --
    def mint_span_id(self) -> str:
        """Deterministic under a pinned epoch: "sp<epoch>-<n>" (the
        cycle-id convention), so golden-fixture regens stay
        byte-identical."""
        with self._lock:
            self._span_seq += 1
            return f"sp{self.epoch}-{self._span_seq}"

    def start_trace_span(
        self,
        name: str,
        trace_id: str,
        parent_id: Optional[str] = None,
        kind: str = "server",
        attrs: Optional[Dict[str, object]] = None,
    ) -> Optional[TraceSpan]:
        """Open one exportable distributed-trace span, or None when
        ``trace_id`` is empty (tracing off for this request: the
        untraced path pays one truthiness check and nothing else).
        The caller MUST end or abort the returned span on every exit
        path (try/finally or a with-block)."""
        if not trace_id:
            return None
        return TraceSpan(
            name, trace_id, self.mint_span_id(), parent_id=parent_id,
            kind=kind, sink=self.trace_sink, attrs=attrs,
            clock=self._clock, wall_clock=self._wall_clock,
        )

    def current(self, snapshot_id: Optional[str] = None,
                cycle_id: Optional[str] = None) -> CycleSpans:
        """The open cycle, created on first touch.  ``cycle_id`` adopts
        a caller-supplied correlation id (the AssignRequest's) for the
        open cycle; ``snapshot_id`` stamps the resident snapshot it ran
        against."""
        with self._lock:
            if self._cycle is None:
                self._seq += 1
                self._cycle = CycleSpans(
                    cycle_id or f"c{self.epoch}-{self._seq}",
                    clock=self._clock, wall_clock=self._wall_clock,
                )
            elif cycle_id:
                self._cycle.cycle_id = cycle_id
            if snapshot_id is not None:
                self._cycle.snapshot_id = snapshot_id
            return self._cycle

    def commit(self, error: Optional[str] = None) -> Dict[str, object]:
        """Close the current cycle and return its record (an empty cycle
        is created if nothing was recorded, so commit() is total)."""
        with self._lock:
            cycle = self.current()
            if error is not None:
                cycle.error = error
            record = cycle.to_record()
            self._cycle = None
            return record

    def open_scope(
        self,
        snapshot_id: Optional[str] = None,
        cycle_id: Optional[str] = None,
        adopt_pending: bool = True,
        trace_id: Optional[str] = None,
    ) -> CycleScope:
        """Detach a cycle into a private :class:`CycleScope`.

        With ``adopt_pending`` (the correlating RPC — e.g. the Assign
        that closes a Sync→Score→Assign flow) the pending cycle, if
        any, is claimed ATOMICALLY: it leaves the recorder in the same
        lock hold, so a concurrent RPC can neither relabel it nor land
        stray stamps on it, and the next ``current()`` starts fresh.
        ``adopt_pending=False`` (a sibling RPC racing the correlator)
        always mints a fresh cycle and leaves the pending one alone."""
        with self._lock:
            if adopt_pending and self._cycle is not None:
                cycle = self._cycle
                self._cycle = None
                if cycle_id:
                    cycle.cycle_id = cycle_id
            else:
                self._seq += 1
                cycle = CycleSpans(
                    cycle_id or f"c{self.epoch}-{self._seq}",
                    clock=self._clock, wall_clock=self._wall_clock,
                )
            if snapshot_id is not None:
                cycle.snapshot_id = snapshot_id
            if trace_id:
                cycle.trace_id = trace_id
            return CycleScope(cycle)

    # -- span API --
    def begin_span(self, name: str) -> int:
        with self._lock:
            return self.current().begin(name)

    def end_span(self, handle: int) -> None:
        with self._lock:
            if self._cycle is not None:
                self._cycle.end(handle)

    def add_measured(self, name: str, dur_s: float) -> None:
        """Attach a stage measured outside the recorder (see
        ``CycleSpans.add_measured``) to the current cycle."""
        with self._lock:
            self.current().add_measured(name, dur_s)

    def pending_spans(self) -> int:
        """Span count buffered on the open cycle (0 when none) — the
        backlog-flush threshold check, made atomic for the coalescer."""
        with self._lock:
            return len(self._cycle.spans) if self._cycle is not None else 0

    def span(self, name: str) -> _SpanContext:
        """``with recorder.span("dispatch"): ...`` — the leak-proof
        form (raw begin/end callers use try/finally)."""
        return _SpanContext(self, name)

    def note(self, key: str, value) -> None:
        """Attach a device-derived or config stat to the current cycle.
        ``value`` must already be a host-side Python scalar/str — pass
        ``int(np.asarray(x))`` results, never live tracers."""
        with self._lock:
            self.current().notes[key] = value


_NULL_CONTEXT = contextlib.nullcontext()


def maybe_span(recorder: Optional[SpanRecorder], name: str):
    """``with maybe_span(spans, "stage"):`` for recorder-optional call
    sites (bridge/state.py, parallel/shard_assign.py take ``spans=None``
    by default) — leak-proof by construction, no handle bookkeeping."""
    if recorder is None:
        return _NULL_CONTEXT
    return recorder.span(name)
