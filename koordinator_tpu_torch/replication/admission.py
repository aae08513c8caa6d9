"""Admission control, band-aware load shedding and the circuit breaker
for the bridge daemon.

Overload on the old daemon degraded as latency collapse: every Score
past the coalescer's throughput queued without bound, so p99 grew with
the backlog and EVERY caller — including the ones the daemon could have
served on time — missed its deadline.  The gate here sits IN FRONT of
the dispatch queue and converts overload into fast, bounded rejections
instead: once more than ``max_inflight`` read RPCs are admitted-but-
unfinished, new ones fail immediately with :class:`ResourceExhausted`
carrying a retry-after hint (one observed service period), which the
transports map to gRPC ``RESOURCE_EXHAUSTED`` / a tagged raw-UDS error
frame.  In-flight work is untouched — the gate never cancels, it only
refuses to deepen the queue.

makes the shedding BAND-AWARE: requests stamped with one of
the koord-prod|mid|batch|free priority bands (the bands the trace
generator already schedules; ``ScoreRequest.band`` on the wire) shed on
a LADDER instead of all at the same depth.  Each band owns a fraction
of ``max_inflight`` past which ITS new requests shed:

    koord-free   0.50   (sheds first: half the configured depth)
    koord-batch  0.65
    koord-mid    0.80
    koord-prod   1.00   (sheds last, at the full configured depth)
    <unbanded>   1.00   (legacy clients = prod treatment, so the
                         pre-band gate behavior is unchanged)

so under pressure the free/batch tiers absorb the sheds while prod
keeps its full admission depth — the Synergy-style multi-tenant
treatment (2110.06073) applied to the overload path.  Shed replies
carry BAND-SCALED retry-after hints (a shed free-band client backs off
4x the observed service period; prod 1x), pushing the recovered
capacity toward the bands that matter.  Sync is deliberately NEVER
shed or banded: the one-writer path the followers replicate from must
not degrade under a read storm.

The depth the gate counts is exactly the dispatch queue's upstream
population (admitted Score/Assign RPCs that have not finished), which
bounds the coalescer's gather queue plus everything in execution.

``max_inflight=0`` (the default) disables the gate entirely; the
daemon flag is ``--max-inflight`` / ``KOORD_MAX_INFLIGHT``.  Sheds
count on the ``koord_scorer_shed_total{method}`` and
``koord_scorer_shed_band_total{band}`` families.

:class:`CircuitBreaker` is the next rung of the degradation ladder
(docs/REPLICATION.md "Degradation ladder"): ``threshold``
consecutive DEVICE failures — a launch half raising, or the readback's
``device_get`` raising, where async dispatch actually surfaces a
failing program (the chaos harness's ``fail_next_launch`` /
``fail_next_readback`` idioms) — trip it OPEN, and while open the servicer
stops queueing work behind the dead device — Score degrades to the
bounded-staleness brownout cache (an explicit ``degraded`` reply
flag), Assign fails fast with :class:`BreakerOpen` + retry-after.
After ``cooldown_ms`` the breaker goes HALF-OPEN: exactly one launch
is admitted as a probe; success closes the breaker, failure re-opens
it for another cooldown.  Admission sheds happen BEFORE the dispatch
queue, so a shed storm can never feed the breaker — and the breaker's
failure feed additionally ignores request-level rejections
(stale snapshot, expired deadline), counting only real launch faults.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Mapping, Optional

from koordinator_tpu_torch.obs.lockwitness import witness_lock

# the shed ladder: fraction of max_inflight each band may fill before
# ITS new requests shed.  Unknown/empty bands get prod treatment (shed
# last) so legacy clients keep the exact pre-band gate behavior.
# These are the DEFAULTS — tunable per deployment
# via the ``--shed-fraction-<band>`` daemon
# flags / ``KOORD_SHED_FRACTION_{FREE,BATCH,MID,PROD}`` envs, validated
# by :func:`validate_shed_fractions` (each in (0, 1], monotone
# free <= batch <= mid <= prod — an inverted ladder would shed prod
# FIRST, the exact opposite of the contract).
BAND_SHED_FRACTION = {
    "koord-free": 0.50,
    "koord-batch": 0.65,
    "koord-mid": 0.80,
    "koord-prod": 1.00,
}

# band name <-> knob suffix for the flags/envs
_BAND_KNOBS = (
    ("koord-free", "FREE"),
    ("koord-batch", "BATCH"),
    ("koord-mid", "MID"),
    ("koord-prod", "PROD"),
)


def validate_shed_fractions(
    overrides: Optional[Mapping[str, float]],
) -> Dict[str, float]:
    """Merge ``overrides`` (band -> fraction; partial is fine) over the
    defaults and validate the result: every fraction in (0, 1], and
    monotone non-decreasing up the ladder (free <= batch <= mid <=
    prod) — the whole point of the ladder is that LOWER bands shed
    first, so an inverted configuration is an operator error, refused
    at startup rather than discovered in a prod-band shed storm.
    Returns the merged table; raises ValueError on a bad knob."""
    merged = dict(BAND_SHED_FRACTION)
    for band, value in (overrides or {}).items():
        if band not in merged:
            raise ValueError(
                f"unknown shed-fraction band {band!r} "
                f"(expected one of {sorted(merged)})"
            )
        value = float(value)
        if not 0.0 < value <= 1.0:
            raise ValueError(
                f"shed fraction for {band} must be in (0, 1], "
                f"got {value}"
            )
        merged[band] = value
    order = [band for band, _ in _BAND_KNOBS]
    for lo, hi in zip(order, order[1:]):
        if merged[lo] > merged[hi]:
            raise ValueError(
                "shed fractions must be monotone non-decreasing up the "
                f"ladder (free <= batch <= mid <= prod): {lo}="
                f"{merged[lo]} > {hi}={merged[hi]} would shed the "
                "higher band first"
            )
    return merged


def shed_fractions_from_env(env=None) -> Optional[Dict[str, float]]:
    """The ``KOORD_SHED_FRACTION_*`` overrides, or None when none is
    set (empty values mean unset — the KOORD_* convention).  Raises
    ValueError on an unparsable value: a typo'd fraction must fail the
    daemon at startup, never silently run the default ladder."""
    env = os.environ if env is None else env
    overrides: Dict[str, float] = {}
    for band, suffix in _BAND_KNOBS:
        raw = env.get(f"KOORD_SHED_FRACTION_{suffix}") or ""
        if raw:
            try:
                overrides[band] = float(raw)
            except ValueError:
                raise ValueError(
                    f"KOORD_SHED_FRACTION_{suffix}={raw!r} is not a "
                    "number"
                ) from None
    return overrides or None
# retry-after hint multiplier per band: shed low-priority clients back
# off harder, leaving the recovering capacity to the bands above them
BAND_HINT_SCALE = {
    "koord-free": 4.0,
    "koord-batch": 2.0,
    "koord-mid": 1.5,
    "koord-prod": 1.0,
}
_UNBANDED = "none"  # metric label for requests that carried no band


def band_label(band: Optional[str]) -> str:
    """Normalized metric/stats label for a request band (empty/None ->
    the explicit ``none`` so label values are never empty strings)."""
    return band if band else _UNBANDED


class ResourceExhausted(Exception):
    """The admission gate refused a request: the dispatch queue is at
    the refusing band's rung of the ladder.  ``retry_after_ms`` is the
    server's hint — the observed service period scaled by the band's
    back-off factor, i.e. when a slot plausibly frees for THIS band.
    Transports map this to gRPC RESOURCE_EXHAUSTED; the message itself
    carries the machine-parsable ``retry_after_ms=<n>`` token the
    clients' ``IsResourceExhausted``/``RetryAfterMS`` helpers read."""

    def __init__(self, method: str, depth: int, limit: int,
                 retry_after_ms: float, band: str = ""):
        self.method = method
        self.depth = depth
        self.limit = limit
        self.band = band
        self.retry_after_ms = float(retry_after_ms)
        at = f" ({band} band)" if band else ""
        super().__init__(
            f"RESOURCE_EXHAUSTED: {method} shed at queue depth "
            f"{depth}/{limit}{at}; "
            f"retry_after_ms={self.retry_after_ms:.0f}"
        )


class AdmissionGate:
    """Queue-depth gate with a per-band shed ladder and a service-time
    EWMA for the retry hint.

    ``admit(method, band)`` returns a context manager; entering it
    either reserves a slot or raises :class:`ResourceExhausted`
    *immediately* (the bounded-deadline property: a shed response never
    waits on the device).  Exiting releases the slot and feeds the EWMA
    with the observed service time, so the retry-after hint tracks the
    actual per-request cost under the current load, not a config
    constant.

    Thread contract: everything under one small lock; no blocking calls
    inside it (the gate is on the RPC fast path of every Score)."""

    # hint floor/ceiling: a sub-ms hint makes clients busy-spin, a
    # multi-minute one (first request after an idle stretch measuring a
    # cold compile) parks them past any realistic drain
    _MIN_HINT_MS = 1.0
    _MAX_HINT_MS = 30_000.0

    def __init__(self, max_inflight: int = 0, alpha: float = 0.2,
                 clock=None, shed_fractions=None):
        """``shed_fractions``: per-band ladder overrides (partial dict
        band -> fraction), merged over :data:`BAND_SHED_FRACTION` and
        validated; None reads the
        ``KOORD_SHED_FRACTION_*`` envs."""
        self.max_inflight = max(0, int(max_inflight))
        self.alpha = float(alpha)
        if shed_fractions is None:
            shed_fractions = shed_fractions_from_env()
        self.shed_fractions = validate_shed_fractions(shed_fractions)
        self._clock = clock or time.perf_counter
        self._lock = witness_lock("replication.admission.AdmissionGate._lock")
        self._inflight = 0
        self._ewma_ms: Optional[float] = None
        # lifetime stats (bench + /metrics feed)
        self.admitted = 0
        self.shed = 0
        self.shed_by_band: Dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.max_inflight > 0

    def depth(self) -> int:
        with self._lock:
            return self._inflight

    def band_limit(self, band: str) -> int:
        """The ladder rung: admitted-but-unfinished reads at or past
        which a NEW request of ``band`` sheds.  Unknown bands get prod
        treatment (the full depth) — never a surprise shed."""
        frac = self.shed_fractions.get(band, 1.0)
        return max(1, int(self.max_inflight * frac))

    def retry_after_ms(self, band: str = "") -> float:
        """The band-scaled observed service period, clamped (the hint a
        shed reply carries)."""
        with self._lock:
            return self._hint_locked(band)

    def _hint_locked(self, band: str = "") -> float:
        ewma = self._ewma_ms if self._ewma_ms is not None else 50.0
        ewma *= BAND_HINT_SCALE.get(band, 1.0)
        return min(self._MAX_HINT_MS, max(self._MIN_HINT_MS, ewma))

    def stats(self) -> dict:
        with self._lock:
            return {
                "inflight": self._inflight,
                "max_inflight": self.max_inflight,
                "admitted": self.admitted,
                "shed": self.shed,
                "shed_by_band": dict(self.shed_by_band),
                "ewma_service_ms": self._ewma_ms,
            }

    def admit(self, method: str, band: str = "") -> "_Admission":
        return _Admission(self, method, band)

    # -- slot accounting (called by _Admission) --
    def _enter(self, method: str, band: str = "") -> float:
        with self._lock:
            if self.enabled and self._inflight >= self.band_limit(band):
                self.shed += 1
                label = band_label(band)
                self.shed_by_band[label] = (
                    self.shed_by_band.get(label, 0) + 1
                )
                raise ResourceExhausted(
                    method, self._inflight, self.band_limit(band),
                    self._hint_locked(band), band=band,
                )
            self._inflight += 1
            self.admitted += 1
        return self._clock()

    def _exit(self, entered_at: float) -> None:
        served_ms = (self._clock() - entered_at) * 1000.0
        with self._lock:
            self._inflight -= 1
            if self._ewma_ms is None:
                self._ewma_ms = served_ms
            else:
                self._ewma_ms = (
                    self.alpha * served_ms
                    + (1.0 - self.alpha) * self._ewma_ms
                )


class _Admission:
    """One RPC's pass through the gate (context manager)."""

    __slots__ = ("_gate", "_method", "_band", "_entered_at")

    def __init__(self, gate: AdmissionGate, method: str, band: str = ""):
        self._gate = gate
        self._method = method
        self._band = band
        self._entered_at: Optional[float] = None

    def __enter__(self) -> "_Admission":
        self._entered_at = self._gate._enter(self._method, self._band)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._entered_at is not None:
            self._gate._exit(self._entered_at)
            self._entered_at = None
        return False


class BreakerOpen(Exception):
    """The circuit breaker refused a request outright: the device's
    launch path is failing and this RPC must not queue behind it (and,
    for Score, the brownout cache could not serve it within the
    staleness bound either).  ``retry_after_ms`` is the remaining
    cooldown before the next half-open probe — the earliest moment a
    retry could find the breaker willing to try the device again.
    Transports map this to gRPC UNAVAILABLE with the machine-parsable
    ``retry_after_ms=<n>`` token."""

    def __init__(self, method: str, retry_after_ms: float, detail: str = ""):
        self.method = method
        self.retry_after_ms = max(1.0, float(retry_after_ms))
        tail = f"; {detail}" if detail else ""
        super().__init__(
            f"BREAKER_OPEN: {method} refused while the device launch "
            f"path is failing{tail}; "
            f"retry_after_ms={self.retry_after_ms:.0f}"
        )


class CircuitBreaker:
    """Consecutive-launch-failure breaker with half-open probes.

    States: ``closed`` (all launches admitted), ``open`` (no launches;
    Score degrades to the brownout cache, Assign fails fast), and
    ``half-open`` (exactly ONE probe launch admitted; its outcome
    decides).  ``threshold=0`` disables the breaker entirely —
    ``allow_launch`` always grants.

    The failure feed is the dispatcher's launch outcome hook, filtered
    by the servicer: only real launch faults count.  Request-level
    rejections (stale snapshot, expired deadline) and admission sheds
    never reach this object — a shed storm cannot trip the breaker
    (regression-tested).

    Thread contract: every method takes the one internal lock; no
    blocking calls inside it (the breaker sits on the launch path)."""

    def __init__(self, threshold: int = 3, cooldown_ms: float = 250.0,
                 clock=time.monotonic, on_transition=None):
        self.threshold = max(0, int(threshold))
        self.cooldown_ms = max(1.0, float(cooldown_ms))
        self._clock = clock
        self._lock = witness_lock(
            "replication.admission.CircuitBreaker._lock")
        self._consecutive = 0
        self._state = "closed"
        self._opened_at: Optional[float] = None
        self._probe_out = False
        # observability seam (servicer wires the breaker-state gauge +
        # transition counter); called OUTSIDE the lock
        self.on_transition = on_transition
        # lifetime stats (bench + tests)
        self.trips = 0
        self.probes = 0

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._state == "open" and self._cooldown_left_locked() <= 0.0:
            return "half-open"
        return self._state

    def _cooldown_left_locked(self) -> float:
        if self._opened_at is None:
            return 0.0
        spent = (self._clock() - self._opened_at) * 1000.0
        return max(0.0, self.cooldown_ms - spent)

    def retry_after_ms(self) -> float:
        """Remaining cooldown (the hint a fast-fail reply carries); at
        least 1 ms so a shed client never busy-spins."""
        with self._lock:
            return max(1.0, self._cooldown_left_locked())

    def allow_launch(self) -> bool:
        """True when a launch may proceed: breaker closed, or this
        caller won the one half-open probe slot.  False = serve the
        degraded path instead (brownout / fast fail)."""
        if not self.enabled:
            return True
        transition = None
        with self._lock:
            state = self._state_locked()
            if state == "closed":
                return True
            if state == "half-open" and not self._probe_out:
                self._probe_out = True
                self._state = "half-open"
                self.probes += 1
                transition = "half-open"
            else:
                return False
        self._notify(transition)
        return True

    def record_failure(self) -> None:
        """One real launch fault (the servicer filters request-level
        rejections out before calling)."""
        if not self.enabled:
            return
        transition = None
        with self._lock:
            self._consecutive += 1
            was = self._state
            if self._state == "half-open":
                # the probe failed: re-open for a fresh cooldown
                self._state = "open"
                self._opened_at = self._clock()
                self._probe_out = False
                transition = "open"
            elif (
                was == "closed"
                and self._consecutive >= self.threshold
            ):
                self._state = "open"
                self._opened_at = self._clock()
                self.trips += 1
                transition = "open"
        self._notify(transition)

    def release_probe(self) -> None:
        """A half-open probe slot was granted but the batch performed
        no device launch after all (every entry stale/expired, or a
        memo served it): the device was not probed, so no verdict —
        the slot frees for the next caller instead of wedging the
        breaker half-open forever."""
        with self._lock:
            if self._state == "half-open":
                self._probe_out = False

    def record_success(self) -> None:
        if not self.enabled:
            return
        transition = None
        with self._lock:
            self._consecutive = 0
            if self._state != "closed":
                self._state = "closed"
                self._opened_at = None
                self._probe_out = False
                transition = "closed"
        self._notify(transition)

    def _notify(self, transition: Optional[str]) -> None:
        if transition is not None and self.on_transition is not None:
            try:
                self.on_transition(transition)
            except Exception:  # an observability hook must never fail the launch path; the transition itself already happened
                import logging

                logging.getLogger(__name__).exception(
                    "breaker transition hook failed"
                )

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state_locked(),
                "threshold": self.threshold,
                "cooldown_ms": self.cooldown_ms,
                "consecutive_failures": self._consecutive,
                "trips": self.trips,
                "probes": self.probes,
            }
