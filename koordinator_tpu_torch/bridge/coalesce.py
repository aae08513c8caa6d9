"""Pipelined coalescing device dispatch for the BatchedScorer bridge.

built the coalescer: concurrent Score requests that arrive
while the device is busy (or within a small gather window) stack into
ONE batched launch against the resident snapshot, and the replies are
demultiplexed per caller.  But the engine still ran strictly one launch
at a time — the batch leader held the device critical section across
its *blocking* stacked readback, so the device sat idle for the entire
host-side ``device_get`` + demux of batch k before batch k+1 could
launch.

rebuilds the device section as a **double-buffered pipeline**.
The critical section now covers only the *launch* (snapshot capture +
async device dispatch — JAX returns as soon as the program is enqueued);
the blocking readback and the numpy demux run OFF the launch lock, so
the next leader launches batch k+1 while batch k's transfer is still in
flight.  A depth-``DEFAULT_DEPTH`` in-flight bound keeps memory
predictable (and ``depth=1`` reproduces the serial-readback
engine for baselines).

Executor protocol (the two-phase seam):

* ``launch_batch(entries)`` runs with the **launch lock held** and must
  only capture state and dispatch device work — never block on a
  device->host transfer inside ``@launch_section`` functions.  It either finalizes entries in place (sets ``reply`` /
  ``error`` and returns ``None`` — the degenerate no-device path, e.g.
  every entry stale) or returns a **readback closure**.
* the readback closure runs with the launch lock *released*; it blocks
  on the stacked transfer, fills each entry's ``reply``/``error``, and
  may return a post-batch hook the leader runs after followers are
  notified (host bookkeeping must not extend any critical path).
* a closure carrying ``no_device = True`` also runs off the lock but put NOTHING on the
  device: no in-flight slot is taken, no launch is accounted (the
  device-idle gap closes only if queued work drains), and a donating
  ``run_exclusive(drain=True)`` never waits on it.

Concurrency contract (lock order is launch -> state, never state ->
launch while holding state):

* ``submit()`` enqueues and then either *leads* (first thread to take
  the launch lock with pipeline headroom drains up to ``max_batch``
  entries, launches them, then drains its own batch's readback off the
  lock) or *follows* (waits for a leader to publish its slot).  FIFO: a
  batch is always a prefix of the queue.  Every state transition
  (launch-lock release, readback completion, enqueue) notifies the
  shared condition — followers never poll.
* ``run_pipelined(fn)`` runs a non-coalescible launch (Assign's cycle)
  through the same pipeline: ``fn`` executes under the launch lock and
  returns a readback closure that runs outside it.
* ``run_exclusive(fn, drain=True)`` is the **donation barrier**: a
  warm Sync's delta scatter donates the pre-delta resident buffers, so
  it must not run while any launched-but-unread batch could still be
  holding python references that a deletion would invalidate.  With
  ``drain`` the section waits for the in-flight count to reach zero
  before running ``fn`` (launch lock held throughout, so nothing new
  launches).  Non-donating commits pass ``drain=False`` and keep the
  pipeline flowing.

The **gather window** is adaptive by default: instead of the
hand-tuned static ``gather_window_s``, :class:`AdaptiveGatherWindow`
tracks an EWMA of observed inter-arrival gaps (the same quantity the
``koord_scorer_coalesce_queue_delay_ms`` samples measure per entry) and
derives the wait from it — ``min(cap, ewma_gap * (max_batch - 1))``,
zero when traffic is too sparse for waiting to fill a batch.  A leader
only gather-waits when the pipeline is *empty*: with a batch already in
flight, launching immediately is free (the device is busy anyway).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from koordinator_tpu_torch.obs.lockwitness import witness_condition, witness_lock

# One launch serves at most this many stacked Score requests; the Go
# scheduler dispatches 16 parallel Score workers, so a full worker burst
# coalesces into a single device program.
DEFAULT_MAX_BATCH = 16

# Launched-but-unread batches allowed at once.  Two is the double
# buffer: launch k+1 overlaps readback k; deeper queues buy nothing
# once the device is saturated and multiply in-flight result memory.
DEFAULT_DEPTH = 2


def launch_section(fn):
    """Marker for functions that run under the dispatcher's launch
    lock.  Identity at runtime; a function carrying it must not block
    on a device->host transfer (``.cpu()``, ``.item()``,
    ``torch.cuda.synchronize``) — only the readback closure (a nested
    def) may block."""
    return fn


class SnapshotNotResident(ValueError):
    """A coalesced request named a snapshot that is no longer resident
    (the same condition ``ScorerServicer._check_generation`` rejects on
    the serial paths; callers translate to FAILED_PRECONDITION)."""


class DeadlineExpired(Exception):
    """A request's propagated deadline budget ran out before the device
    could serve it.  ``stage`` says
    where the expiry was caught: ``queue`` = the request arrived with
    an already-exhausted budget (rejected at RPC entry, before it could
    deepen any queue), ``gather`` = it expired while queued and the
    batch leader evicted it at gather time — BEFORE it occupied a
    launch slot, so an expired request never costs a device launch.
    Transports map this to gRPC DEADLINE_EXCEEDED."""

    def __init__(self, method: str, stage: str, budget_ms: float):
        self.method = method
        self.stage = stage
        self.budget_ms = float(budget_ms)
        super().__init__(
            f"DEADLINE_EXCEEDED: {method} deadline budget "
            f"({self.budget_ms:.0f} ms) expired at stage={stage}; "
            "the request was never launched"
        )


class PendingRequest:
    """One caller's slot in a coalesced batch.  The executor fills
    ``reply`` (or ``error``); the dispatcher stamps queue/batch stats
    and flips ``done`` under the queue condition.  ``deadline_at`` is
    the absolute (dispatcher-clock) expiry the propagated per-RPC
    budget pins — None = no deadline; the batch leader evicts expired
    entries at gather time before they occupy a launch slot."""

    __slots__ = (
        "req", "enqueued_at", "reply", "error", "done",
        "queue_delay_ms", "batch_size", "deadline_at", "budget_ms",
        "trace_span",
    )

    def __init__(self, req, enqueued_at: float,
                 deadline_at: Optional[float] = None,
                 budget_ms: float = 0.0, trace_span=None):
        self.req = req
        self.enqueued_at = enqueued_at
        self.reply = None
        self.error: Optional[BaseException] = None
        self.done = False
        self.queue_delay_ms = 0.0
        self.batch_size = 0
        self.deadline_at = deadline_at
        self.budget_ms = budget_ms
        # this RPC's distributed-trace span (obs/spans.py TraceSpan)
        # or None: the batch leader fan-in links it to the
        # ONE launch span the coalesced batch shares — the span's
        # lifecycle (end/abort) stays with the submitting RPC body
        self.trace_span = trace_span


class ScoreMemo:
    """Host-side memo of one Score launch's padded top-k readback
   .

    Key: ``(snapshot id, CycleConfig)``; the entry records the
    ``k``-BUCKET it was launched at (``kb`` — the sticky power-of-two
    ``lax.top_k`` width) plus the host arrays of the stacked readback.
    A later batch whose every caller needs ``k <= kb`` serves sliced
    prefixes straight from the entry — no device launch, not even a
    lazy snapshot rebuild — and prefix slicing of the padded top-k is
    bit-identical to a fresh launch (``lax.top_k`` sorts descending
    with index tie-breaks).  A batch needing a LARGER k misses and its
    launch replaces the entry with the wider bucket.

    Thread contract: the caller serializes access (the servicer's
    ``_state_lock`` — lookups happen inside the launch section's state
    capture, publishes after the readback).  Invalidation is the same
    atomic clear-on-generation-bump the Assign memo uses: entries die
    with the snapshot id they certified, and because the id is IN the
    key, a stale publish racing the bump can never serve a future
    request (the caller also guards the publish on the current id, so
    the dict stays one-entry-deep per config).  Hit/miss accounting
    lives on the ``koord_scorer_score_memo_total`` telemetry family,
    fed by the servicer — not here.
    """

    __slots__ = ("_entries",)

    def __init__(self):
        self._entries = {}

    def get(self, sid, cfg):
        """The memo entry dict for (sid, cfg), or None.  Entry keys:
        ``kb`` (launched top-k bucket), ``N``/``P`` (node/pod
        capacities), ``ts``/``ti``/``feasible``/``valid`` (host-side
        stacked readback)."""
        return self._entries.get((sid, cfg))

    def put(self, sid, cfg, data) -> None:
        """Publish a readback; a narrower bucket never replaces a wider
        one (the wider entry already serves every prefix)."""
        prev = self._entries.get((sid, cfg))
        if prev is not None and prev["kb"] >= data["kb"]:
            return
        self._entries[(sid, cfg)] = data

    def invalidate(self) -> None:
        self._entries.clear()


class StaticGatherWindow:
    """The knob: a fixed straggler wait (0 = never wait)."""

    def __init__(self, seconds: float = 0.0):
        self._seconds = max(0.0, float(seconds))

    def observe_arrival(self, now_s: float) -> None:
        pass

    def window_s(self, max_batch: int) -> float:
        return self._seconds if max_batch > 1 else 0.0


class AdaptiveGatherWindow:
    """Gather window derived from the observed inter-arrival rate.

    ``observe_arrival`` feeds an EWMA of the gap between consecutive
    submits (callers hold the dispatcher's condition, so no lock here).
    The window is::

        0                                  while no gap was observed yet
        0                                  if ewma_gap >= lone_cutoff_ms
        min(cap_ms, ewma_gap*(max_batch-1))  otherwise

    Rationale: if requests arrive every ``g`` ms, an idle-device leader
    that waits ``g*(max_batch-1)`` gathers a full batch; the cap bounds
    the latency tax, and the lone cutoff turns the window off entirely
    when traffic is so sparse that a cap-length wait could not gather
    even one extra request (``lone_cutoff_ms`` defaults to ``cap_ms``:
    past it, cap/gap < 1).  Burst trains therefore converge onto wide
    batches while lone requests keep serial latency.
    """

    def __init__(self, alpha: float = 0.2, cap_ms: float = 5.0,
                 lone_cutoff_ms: Optional[float] = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.cap_ms = max(0.0, float(cap_ms))
        self.lone_cutoff_ms = (
            self.cap_ms if lone_cutoff_ms is None else float(lone_cutoff_ms)
        )
        self._last_arrival_s: Optional[float] = None
        self._ewma_gap_ms: Optional[float] = None

    def observe_arrival(self, now_s: float) -> None:
        last = self._last_arrival_s
        self._last_arrival_s = now_s
        if last is None:
            return
        gap_ms = max(0.0, (now_s - last) * 1000.0)
        if self._ewma_gap_ms is None:
            self._ewma_gap_ms = gap_ms
        else:
            self._ewma_gap_ms = (
                self.alpha * gap_ms + (1.0 - self.alpha) * self._ewma_gap_ms
            )

    def window_s(self, max_batch: int) -> float:
        if (
            max_batch <= 1
            or self._ewma_gap_ms is None
            or self._ewma_gap_ms >= self.lone_cutoff_ms
        ):
            return 0.0
        return min(self.cap_ms, self._ewma_gap_ms * (max_batch - 1)) / 1000.0


class CoalescingDispatcher:
    """Queue + pipelined launch section + per-caller demux.

    ``max_batch=1, depth=1`` degenerates to the pre-coalescing
    serialized behavior (every request pays its own launch and its own
    blocking readback) — the bench uses that as the speedup baseline,
    and ``depth=1`` alone reproduces the coalescer (shared
    launches, serial readbacks).
    """

    def __init__(
        self,
        launch_batch: Callable[[List[PendingRequest]], Optional[Callable]],
        max_batch: int = DEFAULT_MAX_BATCH,
        gather_window_s: float = 0.0,
        window=None,
        depth: int = DEFAULT_DEPTH,
        clock=time.perf_counter,
        sleep=time.sleep,
    ):
        self._launch_batch = launch_batch
        self.max_batch = max(1, int(max_batch))
        self.depth = max(1, int(depth))
        # ``window`` (a *GatherWindow object) wins; the float keeps the
        # signature for static callers (tests, bench baselines)
        self.window = (
            window if window is not None
            else StaticGatherWindow(gather_window_s)
        )
        self._clock = clock
        self._sleep = sleep
        # the launch critical section: snapshot capture + async device
        # dispatch only — blocking readbacks run off it (lock-held-
        # dispatch rejects them inside @launch_section code statically)
        self._launch_lock = witness_lock(
            "bridge.coalesce.CoalescingDispatcher._launch_lock")
        # one condition guards the queue, the in-flight count, entry
        # ``done`` flips and the lifetime stats; EVERY transition
        # notifies it, so followers wait, never poll
        self._cond = witness_condition(
            "bridge.coalesce.CoalescingDispatcher._cond")
        self._queue: List[PendingRequest] = []
        self._inflight = 0
        # device-idle bookkeeping: wall time where work was queued but
        # nothing was in flight (the quantity the pipeline exists to
        # drive to ~0; the bench publishes it as ``device_idle_ms``)
        self._idle_since: Optional[float] = None
        self._launched_once = False
        self.device_idle_s = 0.0
        # lifetime stats (under _cond): the bench's coalesce_batch_mean
        # and the parity tests read these
        self.batches = 0
        self.requests = 0
        self.max_occupancy = 0
        # launches that entered the device section while a previous
        # batch was still in flight — the pipeline actually pipelining
        self.launch_overlaps = 0
        # deadline eviction: entries whose propagated budget
        # expired while queued, evicted at gather time (never launched)
        self.deadline_evicted = 0
        # servicer seams: ``deadline_hook(n)`` observes gather-time
        # evictions (the stage="gather" telemetry feed);
        # ``launch_outcome_hook(outcome, exc)`` observes every launch
        # attempt's fate — "ok" (launch AND readback completed: with
        # async dispatch a failing device program usually surfaces at
        # the readback's device_get, so success is only known there),
        # "error" (either half raised), "none" (no device work:
        # all-stale/all-expired batch or a memo serve) — the circuit
        # breaker's failure feed (replication/admission.py
        # CircuitBreaker; the servicer filters request-level
        # rejections before counting)
        self.deadline_hook: Optional[Callable[[int], None]] = None
        self.launch_outcome_hook: Optional[Callable] = None

    # -- public API --
    def submit(self, req, deadline_at: Optional[float] = None,
               budget_ms: float = 0.0, trace_span=None) -> PendingRequest:
        """Enqueue ``req`` and block until a batch containing it ran.
        Returns the finished entry; raises its error if the executor
        (or the batch as a whole) failed.  ``deadline_at`` (dispatcher
        clock) arms gather-time eviction: an entry still queued past it
        fails with :class:`DeadlineExpired` instead of occupying a
        launch slot.  ``trace_span`` rides the entry for the executor's
        fan-in linking; the dispatcher never ends it."""
        entry = PendingRequest(
            req, self._clock(), deadline_at=deadline_at,
            budget_ms=budget_ms, trace_span=trace_span,
        )
        with self._cond:
            self.window.observe_arrival(entry.enqueued_at)
            self._queue.append(entry)
            if self._inflight == 0 and self._idle_since is None:
                self._idle_since = entry.enqueued_at
            # an idle leader may be parked: work just arrived
            self._cond.notify_all()
        while True:
            if self._try_lead() is None:
                with self._cond:
                    if entry.done:
                        break
                    if not self._can_lead_locked():
                        # Not a poll: every launch-lock release, readback
                        # completion and enqueue notifies this condition
                        # after flipping the state it guards, so the
                        # wakeup cannot be missed.  The timeout is a
                        # deadlock backstop only (a lost notify is a bug
                        # this recovers from at 1 Hz, not a latency tax
                        # on the hot path).
                        self._cond.wait(timeout=1.0)
            if entry.done:
                break
        if entry.error is not None:
            raise entry.error
        return entry

    def run_pipelined(self, launch_fn: Callable[[], Callable]):
        """Run a non-coalescible device section through the pipeline:
        ``launch_fn`` executes under the launch lock (with pipeline
        headroom reserved) and returns a readback closure; the closure
        runs with the lock released — so a coalesced Score batch can
        launch while this section's transfer is still in flight — and
        its return value is ``run_pipelined``'s."""
        self._launch_lock.acquire()
        launched = False
        try:
            with self._cond:
                # decrements come from readback threads only, so this
                # wait cannot race another launcher (we hold the lock)
                while self._inflight >= self.depth:
                    self._cond.wait(timeout=1.0)
                launch_at = self._clock()
            try:
                readback = launch_fn()
            except Exception as exc:
                # same breaker seam as the coalesced path: the servicer
                # filters request-level rejections (stale snapshot,
                # expired deadline) before a failure counts
                self._launch_outcome("error", exc)
                raise
            with self._cond:
                # accounted only now: a launch_fn that raised (e.g. a
                # displaced Assign's generation re-check) put nothing
                # on the device, so the idle gap must stay open and no
                # overlap may be counted
                self._note_launch_locked(launch_at)
                self._inflight += 1
                launched = True
        finally:
            self._launch_lock.release()
            with self._cond:
                self._cond.notify_all()
        try:
            try:
                result = readback()
            except Exception as exc:
                # readback-phase device fault: the breaker's failure
                # surface (async dispatch reports failing programs at
                # device_get, not at enqueue)
                self._launch_outcome("error", exc)
                raise
            self._launch_outcome("ok", None)
            return result
        finally:
            if launched:
                with self._cond:
                    self._dec_inflight_locked()
                    self._cond.notify_all()

    def run_exclusive(self, fn, drain=True):
        """Run a device section that must not overlap in-flight batches.

        With ``drain`` (the default — required for anything that
        DONATES resident buffers, e.g. a warm Sync's delta scatter) the
        section waits for every launched batch's readback to complete
        before running ``fn``; the launch lock is held throughout, so
        nothing launches concurrently either.  ``drain=False`` skips
        the barrier for sections that only need launch-ordering (a
        cold commit that drops residency: in-flight batches hold their
        own snapshot references, and deletion without donation cannot
        invalidate them).

        ``drain`` may also be a zero-arg callable, evaluated AFTER the
        launch lock is acquired: a drain decision that depends on
        launch-mutable state (e.g. whether the resident snapshot is
        warm — a concurrent Score's launch section can lazily
        cold-rebuild it) must be made where that state can no longer
        move, not at the call site."""
        self._launch_lock.acquire()
        try:
            if callable(drain):
                drain = drain()
            if drain:
                with self._cond:
                    while self._inflight > 0:
                        self._cond.wait(timeout=1.0)
            return fn()
        finally:
            self._launch_lock.release()
            with self._cond:
                self._cond.notify_all()

    def queue_depth(self) -> int:
        """Requests queued plus batches in flight — the depth the
        admission gate bounds from
        upstream.  Cheap enough for a per-scrape gauge."""
        with self._cond:
            return len(self._queue) + self._inflight

    def stats(self) -> dict:
        with self._cond:
            return {
                "batches": self.batches,
                "requests": self.requests,
                "max_occupancy": self.max_occupancy,
                "batch_mean": (
                    self.requests / self.batches if self.batches else 0.0
                ),
                "inflight": self._inflight,
                "depth": self.depth,
                "launch_overlaps": self.launch_overlaps,
                "device_idle_ms": round(self.device_idle_s * 1000.0, 3),
                "window_ms": round(
                    self.window.window_s(self.max_batch) * 1000.0, 3
                ),
            }

    # -- leader path --
    def _can_lead_locked(self) -> bool:
        return (
            bool(self._queue)
            and self._inflight < self.depth
            and not self._launch_lock.locked()
        )

    def _try_lead(self):
        """Attempt to lead one batch end to end: launch under the lock,
        read back off it.  Returns the batch led, or None if leading was
        not possible (lock held, pipeline full, or empty queue)."""
        with self._cond:
            if not self._queue or self._inflight >= self.depth:
                return None
        if not self._launch_lock.acquire(blocking=False):
            return None
        batch: List[PendingRequest] = []
        readback = None
        launched = False
        try:
            with self._cond:
                headroom = self._inflight < self.depth
            if headroom:
                batch, readback, launched = self._launch_locked()
        finally:
            self._launch_lock.release()
            with self._cond:
                self._cond.notify_all()
        if not batch:
            return None
        if readback is not None:
            no_device = getattr(readback, "no_device", False)
            hook = None
            try:
                try:
                    hook = readback()
                    if launched:
                        # the device program actually completed (the
                        # stacked device_get drained): NOW the breaker
                        # may count a success
                        self._launch_outcome("ok", None)
                except BaseException as exc:
                    if launched and isinstance(exc, Exception):
                        # a readback-phase device fault (async
                        # dispatch surfaces failing programs at
                        # device_get, not at enqueue) counts exactly
                        # like a launch-half failure
                        self._launch_outcome("error", exc)
                    # a whole-readback failure is every unfilled caller's
                    # failure; per-entry errors the executor routed stay.
                    # BaseException too: a KeyboardInterrupt delivered
                    # mid-device_get must not leak the in-flight slot
                    # (finally below) or strand followers un-notified —
                    # two leaks and the depth is gone, deadlocking every
                    # submit() and run_exclusive(drain=True) forever
                    for e in batch:
                        if e.reply is None and e.error is None:
                            e.error = exc
                    if not isinstance(exc, Exception):
                        raise
            finally:
                self._finalize(batch, launched=launched, no_device=no_device)
            self._run_hook(hook)
        return batch

    def _launch_locked(self):
        """Launch phase (launch lock held).  Drains a FIFO prefix, runs
        the executor's launch half, and accounts the in-flight slot.
        Returns ``(batch, readback, launched)``; entries are finalized
        here only when there is nothing to read back."""
        if self.window.window_s(self.max_batch) > 0.0:
            self._gather_stragglers()
        with self._cond:
            batch = self._queue[: self.max_batch]
            del self._queue[: len(batch)]
            if not batch:
                return [], None, False
            now = self._clock()
            expired = 0
            for entry in batch:
                entry.queue_delay_ms = (now - entry.enqueued_at) * 1000.0
                entry.batch_size = len(batch)
                # deadline eviction: an entry whose
                # propagated budget ran out while it queued is answered
                # DEADLINE_EXCEEDED here — BEFORE the executor sees it,
                # so an expired request never occupies a launch slot,
                # and a batch whose every entry expired never launches
                if (
                    entry.deadline_at is not None
                    and now >= entry.deadline_at
                ):
                    entry.error = DeadlineExpired(
                        "score", "gather", entry.budget_ms
                    )
                    expired += 1
                    self.deadline_evicted += 1
        if expired and self.deadline_hook is not None:
            self.deadline_hook(expired)
        live = [e for e in batch if e.error is None]
        if not live:
            # every entry expired: nothing launches, the callers get
            # their DEADLINE_EXCEEDED immediately
            self._launch_outcome("none", None)
            self._finalize(batch, launched=False)
            return batch, None, False
        readback = None
        failed = False
        try:
            readback = self._launch_batch(live)
        except Exception as exc:
            failed = True
            self._launch_outcome("error", exc)
            for entry in live:
                if entry.reply is None and entry.error is None:
                    entry.error = exc
        if readback is None:
            # no device work in flight: the executor finalized (or
            # rejected) every entry during the launch phase — nothing
            # launched, so the device-idle gap stays open and no
            # overlap is counted
            if not failed:
                self._launch_outcome("none", None)
            self._finalize(batch, launched=False)
            return batch, None, False
        if getattr(readback, "no_device", False):
            # off-lock HOST work (memo prefix assembly): the closure
            # runs with the lock released like a readback, but nothing
            # is on the device — no in-flight slot, no launch
            # accounting, and a donating drain never waits on it
            self._launch_outcome("none", None)
            return batch, readback, False
        with self._cond:
            self._note_launch_locked(now)
            self._inflight += 1
        # no outcome yet: with async dispatch the launch half only
        # proves enqueue — success/failure is known at the readback
        # (_try_lead reports it after the closure runs)
        return batch, readback, True

    def _launch_outcome(self, outcome: str, exc) -> None:
        """Feed the launch-outcome seam (the circuit breaker); the hook
        must never fail the batch it observed."""
        hook = self.launch_outcome_hook
        if hook is None:
            return
        try:
            hook(outcome, exc)
        except Exception:  # an observability/breaker hook failing must not fail callers whose launch already resolved
            import logging

            logging.getLogger(__name__).exception(
                "launch outcome hook failed"
            )

    def _gather_stragglers(self) -> None:
        """Idle-pipeline straggler wait (launch lock held).  Only worth
        paying when nothing is in flight: with a batch already on the
        device, launching immediately costs no idle time, and waiting
        would."""
        with self._cond:
            if self._inflight > 0:
                return
            deadline = self._clock() + self.window.window_s(self.max_batch)
        while True:
            with self._cond:
                if len(self._queue) >= self.max_batch or self._inflight > 0:
                    return
                left = deadline - self._clock()
            if left <= 0.0:
                return
            self._sleep(min(left, 0.0005))

    def _note_launch_locked(self, launch_at: float) -> None:
        """Account a successful launch that began at ``launch_at``
        (_cond held): close any open device-idle gap and count
        pipelined overlaps.  Called only after the executor's launch
        half returned — a launch that raised put nothing on the device,
        so the idle gap stays open and no overlap is counted."""
        if self._idle_since is not None:
            if self._launched_once:
                self.device_idle_s += max(0.0, launch_at - self._idle_since)
            self._idle_since = None
        if self._inflight > 0:
            self.launch_overlaps += 1
        self._launched_once = True

    def _dec_inflight_locked(self) -> None:
        self._inflight -= 1
        if self._inflight == 0:
            self._idle_since = self._clock() if self._queue else None

    def _finalize(
        self,
        batch: List[PendingRequest],
        launched: bool,
        no_device: bool = False,
    ) -> None:
        """Publish a batch's results: lifetime stats, ``done`` flips and
        the wakeup, all under the condition.  Runs off the launch lock —
        followers and the next leader proceed immediately."""
        with self._cond:
            # count only entries the executor ACCEPTED (reply set, no
            # error): rejected entries (stale snapshot) and failed
            # batches performed no useful launch, and the stats here
            # must agree with the koord_scorer_coalesce_* counters,
            # which are fed per accepted request
            n_ok = sum(1 for entry in batch if entry.error is None)
            if n_ok:
                self.batches += 1
                self.requests += n_ok
                self.max_occupancy = max(self.max_occupancy, n_ok)
            for entry in batch:
                entry.done = True
            if launched:
                self._dec_inflight_locked()
            elif no_device and self._inflight == 0:
                # a memo-SERVED batch put nothing on the device but did
                # answer its callers; once it drains the queue, a long
                # quiet stretch must not count as device idle at the
                # next real launch (same bookkeeping as
                # _dec_inflight_locked).  Scoped to no_device batches
                # only: an executor-REJECTED batch (every entry stale)
                # served nobody, so its callers' queued time keeps the
                # documented idle-gap-stays-open semantics.
                self._idle_since = self._clock() if self._queue else None
            self._cond.notify_all()

    @staticmethod
    def _run_hook(hook) -> None:
        if not callable(hook):
            return
        try:
            hook()
        except Exception:  # post-batch bookkeeping must not fail callers whose replies already succeeded
            import logging

            logging.getLogger(__name__).exception("post-batch hook failed")
