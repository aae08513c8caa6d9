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

**One clock.**  Every span measures on ``time.perf_counter_ns``, which
never steps.  A recorder takes one :class:`ClockAnchor` when it is made
(``time.time_ns()`` beside ``time.perf_counter_ns()``), and every record
it writes, cycle spans and OTLP spans alike, carries Unix-epoch
nanoseconds derived from that anchor (``start_unix_ns``/``end_unix_ns``,
``startTimeUnixNano``/``endTimeUnixNano``).  That is the clock
``torch.profiler``'s chrome trace counts from (its
``baseTimeNanoseconds``), so a host span and a kernel lie on one
timeline.

**Stage spans.**  The serving path's stages of an RPC, from a frame's
bytes to its reply, are rows ``server.<rpc>.<stage>`` (``rpc`` one of
``sync``, ``score``, ``assign``).  ``SpanRecorder.rpc(name)`` binds the
thread that runs an RPC body to its rpc; :func:`stage` (a with-block),
:func:`stage_at` (a stage the caller timed) and :func:`device_stage`
(a launch section's span on its device: on a card a CUDA event pair
read after the section's own readback, on the CPU the host wall) then
record on the thread that does the work, wherever it is in the program.  A closed stage goes to the
launch ledger (``obs/devprof.py``) as a row of ``kind: "stage"`` while
the ledger is on, and to the open Profile captures' buffers while a
window is open (:func:`open_capture`).  With neither, ``rpc()`` binds
nothing and every stage call site costs one check.  Stage rows are
not cycle spans: the cycle records keep their own names.
"""

from __future__ import annotations

import contextlib
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.obs.lockwitness import witness_rlock

# hard cap on spans buffered per cycle: a runaway instrumentation loop
# must cost a counter bump, not memory
MAX_SPANS_PER_CYCLE = 256

# the one cross-trace link type: the many RPC spans of a
# coalesced batch — and every memo/brownout serve — reference the ONE
# launch/readback span that produced the shared bytes
LINK_FANIN = "fanin"

# hard cap on stage spans one Profile capture keeps: a long window costs
# a counter bump past it, not memory
MAX_CAPTURED_STAGES = 1 << 17


class ClockAnchor:
    """One reading of the Unix-epoch clock taken beside the monotonic
    one.  Spans measure on ``time.perf_counter_ns``; their Unix-epoch
    stamps are derived from the anchor, so every span of one recorder
    lies on one timeline, whatever the wall clock does meanwhile."""

    __slots__ = ("mono_ns", "unix_ns")

    def __init__(self):
        # the Unix reading is bracketed by two monotonic ones and paired
        # with their midpoint; the tightest of three brackets is kept, so a
        # thread switch inside one cannot skew the pairing
        best = None
        for _ in range(3):
            before = time.perf_counter_ns()
            unix = time.time_ns()
            after = time.perf_counter_ns()
            if best is None or after - before < best[0]:
                best = (after - before, unix, (before + after) // 2)
        _, self.unix_ns, self.mono_ns = best

    def unix_ns_at(self, mono_ns: int) -> int:
        """The Unix-epoch nanoseconds of a ``perf_counter_ns`` reading."""
        return self.unix_ns + (mono_ns - self.mono_ns)


# the anchor of spans minted outside a recorder (the client shims)
_PROCESS_ANCHOR = ClockAnchor()


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
        "_anchor", "_t0", "_t1", "dur_ms", "error",
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
        anchor: Optional[ClockAnchor] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id or None
        self.kind = kind
        self._anchor = anchor or _PROCESS_ANCHOR
        self._t0 = time.perf_counter_ns()
        self._t1: Optional[int] = None
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
        self._t1 = time.perf_counter_ns()
        self.dur_ms = (self._t1 - self._t0) / 1e6
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
        start_ns = self._anchor.unix_ns_at(self._t0)
        end_ns = self._anchor.unix_ns_at(
            self._t1 if self._t1 is not None else self._t0
        )
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "startTimeUnixNano": start_ns,
            "endTimeUnixNano": end_ns,
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
        "cycle_id", "snapshot_id", "trace_id", "_anchor", "_t0",
        "spans", "notes", "error", "overflow",
    )

    def __init__(self, cycle_id: str, anchor: Optional[ClockAnchor] = None):
        self.cycle_id = cycle_id
        self.snapshot_id: Optional[str] = None
        # distributed-trace correlation: the trace id of the
        # request this cycle served, when the client sent one — the
        # flight-recorder record carries it so a bad cycle found in a
        # dump is addressable in the assembled trace tree (and vice
        # versa)
        self.trace_id: Optional[str] = None
        self._anchor = anchor or _PROCESS_ANCHOR
        self._t0 = time.perf_counter_ns()
        # each span is [name, start_ns, end_ns|None] on perf_counter_ns
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
        self.spans.append([name, time.perf_counter_ns(), None])
        return len(self.spans) - 1

    def end(self, handle: int) -> None:
        # the upper bound guards a handle minted by a PREVIOUS cycle
        # (begin before a commit, end after): closing a stranger's span
        # — or crashing the RPC on IndexError — is worse than dropping
        # the stale end
        if handle < 0 or handle >= len(self.spans):
            return
        self.spans[handle][2] = time.perf_counter_ns()

    def add_measured(self, name: str, start_ns: int, end_ns: int) -> None:
        """Record an already-measured stage as a closed span, at the
        ``perf_counter_ns`` readings it was measured between.

        The coalescing pipeline measures some stages OUTSIDE the lock
        that guards this recorder (a Sync's protobuf->numpy decode, a
        batch leader's shared dispatch/readback) and attaches them at
        the commit point.  A stage may begin before the cycle it lands on
        was made; the record's origin is then that stage's start."""
        if len(self.spans) >= MAX_SPANS_PER_CYCLE:
            self.overflow += 1
            return
        self.spans.append([name, int(start_ns), int(end_ns)])

    def to_record(self) -> Dict[str, object]:
        """Flight-recorder/bench shape: offsets and durations in
        milliseconds from the cycle's origin (the earlier of its making
        and its first span), and each span's Unix-epoch nanoseconds; a
        span that never ended carries ``dur_ms: None`` (visible, not
        invented)."""
        origin = min([self._t0] + [start for _, start, _ in self.spans])
        unix = self._anchor.unix_ns_at
        return {
            "cycle_id": self.cycle_id,
            "snapshot_id": self.snapshot_id,
            "trace_id": self.trace_id,
            "started_unix": unix(origin) / 1e9,
            "spans": [
                {
                    "name": name,
                    "start_ms": round((start - origin) / 1e6, 3),
                    "dur_ms": (
                        round((end - start) / 1e6, 3)
                        if end is not None else None
                    ),
                    "start_unix_ns": unix(start),
                    "end_unix_ns": unix(end) if end is not None else None,
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

    def add_measured(self, name: str, start_ns: int, end_ns: int) -> None:
        with self._lock:
            self._cycle.add_measured(name, start_ns, end_ns)

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

    def __init__(self, epoch: str = ""):
        self.epoch = epoch
        # the one clock of every span this recorder writes
        self.anchor = ClockAnchor()
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
            kind=kind, sink=self.trace_sink, attrs=attrs, anchor=self.anchor,
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
                    cycle_id or f"c{self.epoch}-{self._seq}", anchor=self.anchor,
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
                    cycle_id or f"c{self.epoch}-{self._seq}", anchor=self.anchor,
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

    def add_measured(self, name: str, start_ns: int, end_ns: int) -> None:
        """Attach a stage measured outside the recorder (see
        ``CycleSpans.add_measured``) to the current cycle."""
        with self._lock:
            self.current().add_measured(name, start_ns, end_ns)

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

    # -- stage spans --
    def rpc(self, name: str):
        """``with recorder.rpc("score"): ...`` around an RPC body: binds
        the thread's stage spans to rows ``server.<name>.<stage>`` until
        the block ends, and notes the RPC's arrival (``stage_since_arrival``).
        Binds nothing while no stage is recorded (the launch ledger off
        and no Profile window open)."""
        if not stages_on():
            return _NULL_CONTEXT
        return _RpcBinding(self, name)

    def record_stage(self, rpc: str, stage_name: str, start_ns: int,
                     end_ns: int) -> None:
        """One closed host stage ``server.<rpc>.<stage_name>``, measured
        between two ``perf_counter_ns`` readings on the thread that did
        the work: its row of the launch ledger (while the ledger is on)
        and the open Profile captures (while a window is open)."""
        self.record_stage_parts(rpc, stage_name, ((start_ns, end_ns),))

    def record_stage_parts(self, rpc: str, stage_name: str, parts) -> None:
        """One stage ``server.<rpc>.<stage_name>`` made of the closed
        intervals ``parts`` (``perf_counter_ns`` pairs): one occurrence of
        its ledger row, their summed wall, and each interval in the open
        Profile captures."""
        name = f"server.{rpc}.{stage_name}"
        devprof.record_stage(name, sum(end - start for start, end in parts) / 1e3, "host")
        captures = _captures
        if captures:
            unix = self.anchor.unix_ns_at
            native, thread = threading.get_native_id(), threading.current_thread().name
            for start_ns, end_ns in parts:
                entry = (name, unix(start_ns), unix(end_ns), native, thread)
                for cap in captures:
                    cap.add(entry)


_NULL_CONTEXT = contextlib.nullcontext()

# the RPC each thread's stages belong to (``SpanRecorder.rpc``)
_BOUND = threading.local()

# the Profile captures open now (copy-on-write under _captures_lock, read
# without it on every stage close)
_captures: Tuple["StageCapture", ...] = ()
_captures_lock = threading.Lock()


class _RpcBinding:
    """``SpanRecorder.rpc``'s with-block: this thread's stages belong to
    ``rpc`` on ``recorder``; the binding it replaced comes back on exit,
    after the split stages (:func:`stage_part`) are recorded, one
    occurrence each."""

    __slots__ = ("recorder", "rpc", "start_ns", "_prev", "parts")

    def __init__(self, recorder: SpanRecorder, rpc: str):
        self.recorder = recorder
        self.rpc = rpc
        self.start_ns = time.perf_counter_ns()
        self._prev = None
        self.parts: Dict[str, List[Tuple[int, int]]] = {}

    def __enter__(self) -> "_RpcBinding":
        self._prev = getattr(_BOUND, "rpc", None)
        _BOUND.rpc = self
        return self

    def __exit__(self, *exc) -> bool:
        _BOUND.rpc = self._prev
        for name, parts in self.parts.items():
            self.recorder.record_stage_parts(self.rpc, name, parts)
        return False


class _Stage:
    """:func:`stage`'s with-block: one stage on the bound RPC, closed
    (and recorded) on every exit path."""

    __slots__ = ("_binding", "_name", "_t0")

    def __init__(self, binding: _RpcBinding, name: str):
        self._binding = binding
        self._name = name
        self._t0 = 0

    def __enter__(self) -> "_Stage":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        b = self._binding
        b.recorder.record_stage(b.rpc, self._name, self._t0, time.perf_counter_ns())
        return False


def stages_on() -> bool:
    """Whether stage spans are recorded now: the launch ledger is on, or
    a Profile window is open."""
    return devprof.enabled() or bool(_captures)


def stage(name: str):
    """``with stage("prepare"): ...``: one stage of the RPC bound to this
    thread; a no-op outside a bound RPC body."""
    b = getattr(_BOUND, "rpc", None)
    if b is None:
        return _NULL_CONTEXT
    return _Stage(b, name)


class _StagePart:
    """:func:`stage_part`'s with-block: one interval of a split stage."""

    __slots__ = ("_binding", "_name", "_t0")

    def __init__(self, binding: _RpcBinding, name: str):
        self._binding = binding
        self._name = name
        self._t0 = 0

    def __enter__(self) -> "_StagePart":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._binding.parts.setdefault(self._name, []).append(
            (self._t0, time.perf_counter_ns()))
        return False


def stage_part(name: str):
    """``with stage_part("tables"): ...``: one interval of a stage that
    the RPC's work splits into several (a Sync decodes its tables in one
    stage and updates their device tensors in another).  The intervals of
    one RPC make one occurrence of ``server.<rpc>.<name>``, recorded when
    the RPC's binding ends; a no-op outside a bound RPC body."""
    b = getattr(_BOUND, "rpc", None)
    if b is None:
        return _NULL_CONTEXT
    return _StagePart(b, name)


def stage_at(name: str, start_ns: int, end_ns: int) -> None:
    """A stage of the bound RPC that the caller timed, between two
    ``perf_counter_ns`` readings; a no-op outside a bound RPC body."""
    b = getattr(_BOUND, "rpc", None)
    if b is not None:
        b.recorder.record_stage(b.rpc, name, start_ns, end_ns)


def stage_since_arrival(name: str) -> None:
    """A stage of the bound RPC from its arrival (``SpanRecorder.rpc``)
    to now: the wait before the RPC's launch section."""
    b = getattr(_BOUND, "rpc", None)
    if b is not None:
        b.recorder.record_stage(b.rpc, name, b.start_ns, time.perf_counter_ns())


class DeviceStage:
    """One launch section's span on its device, the ``device`` stage of
    the bound RPC.  On a card: a CUDA event on the device's current
    stream where the section starts (made here) and where it ends
    (:meth:`close`), read by :meth:`read` after the section's own
    readback, which has waited on the card already, so the span adds no
    synchronisation (``backend: "cuda"``).  On the CPU, whose ops run as
    the section issues them: the host wall between the two points, as
    the launch ledger times a CPU launch (``backend: "cpu"``)."""

    __slots__ = ("_rpc", "_stream", "_start", "_end")

    def __init__(self, rpc: str, device):
        self._rpc = rpc
        self._stream = None
        self._end = None
        if device.type == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        else:
            self._start = time.perf_counter_ns()

    def close(self) -> None:
        if self._stream is None:
            self._end = time.perf_counter_ns()
            return
        import torch

        self._end = torch.cuda.Event(enable_timing=True)
        self._end.record(self._stream)

    def read(self) -> None:
        """Record the span; call after the readback that waited on the
        device past :meth:`close`."""
        if self._end is None:
            return
        if self._stream is None:
            us, backend = (self._end - self._start) / 1e3, "cpu"
        else:
            us, backend = self._start.elapsed_time(self._end) * 1e3, "cuda"
        devprof.record_stage(f"server.{self._rpc}.device", us, backend)


def device_stage(device) -> Optional[DeviceStage]:
    """A :class:`DeviceStage` starting now on ``device``, or None off a
    bound RPC body or with the launch ledger off."""
    b = getattr(_BOUND, "rpc", None)
    if b is None or not devprof.enabled():
        return None
    return DeviceStage(b.rpc, device)


class StageCapture:
    """The host stage spans closed while one Profile window is open:
    ``(name, start_unix_ns, end_unix_ns, thread native id, thread name)``
    each, at most ``MAX_CAPTURED_STAGES``; later ones are counted in
    ``overflow``."""

    __slots__ = ("spans", "overflow")

    def __init__(self):
        self.spans: List[tuple] = []
        self.overflow = 0

    def add(self, entry: tuple) -> None:
        if len(self.spans) >= MAX_CAPTURED_STAGES:
            self.overflow += 1
        else:
            self.spans.append(entry)


def open_capture() -> StageCapture:
    """Start keeping closed stage spans for one Profile window."""
    global _captures
    cap = StageCapture()
    with _captures_lock:
        _captures = _captures + (cap,)
    return cap


def close_capture(cap: StageCapture) -> StageCapture:
    """Stop keeping stage spans for ``cap``'s window; returns ``cap``."""
    global _captures
    with _captures_lock:
        _captures = tuple(c for c in _captures if c is not cap)
    return cap


def maybe_span(recorder: Optional[SpanRecorder], name: str):
    """``with maybe_span(spans, "stage"):`` for recorder-optional call
    sites (bridge/state.py, parallel/shard_assign.py take ``spans=None``
    by default) — leak-proof by construction, no handle bookkeeping."""
    if recorder is None:
        return _NULL_CONTEXT
    return recorder.span(name)
