"""SLO-driven elastic replica autoscaling.

Counterpart of ``koordinator_tpu/replication/autoscale.py``: decisions
only, over the port's metrics registry; the levers are the daemon's.

The relay tree (replication/leader.py ``publish_frame`` + the follower
relay role) makes read capacity CHEAP to add: a new follower splices
into any layer of the tree with one hello handshake, and interior
bandwidth multiplies with tree width instead of burning the root's.
This module is the control loop that decides WHEN: watch the read-side
signals a serving tier already exports — the windowed read-latency p99
(obs/slo.py estimator over the registry's histograms), replication lag,
and admission sheds — and hold a declared read SLO by spawning
followers into the tree under load and draining them back when the
storm passes.

Three pieces, separated so the decision logic is unit-testable with no
sockets, threads or clocks:

* :class:`AutoscalePolicy` — the declarative knobs: the SLO itself
  (``p99_high_ms``), the calm band (``p99_low_ratio``), lag/shed
  breach thresholds, and the anti-flap machinery (consecutive-tick
  hysteresis in both directions plus a post-action cooldown).
* :class:`RegistrySignals` — the production signal source: delta-window
  p99 over any histogram family (cumulative buckets snapshotted per
  tick, quantile-estimated on the difference — the
  :class:`~koordinator_tpu_torch.obs.slo.SloWindow` trick, aggregated over a
  label subset), plus shed and lag deltas off the counters/gauges.
* :class:`ReplicaAutoscaler` — the loop: collect signals, run the
  hysteresis state machine, invoke the ``spawn``/``drain`` callbacks
  (the daemon layer owns HOW a replica starts — a process, a thread, a
  k8s scale-up; the harness hands in fakes), publish the
  ``koord_scorer_autoscale_*`` families, and keep a bounded decision
  log for /healthz and the bench artifact.

The decision rule, stated once: a tick is a BREACH when any watched
signal is over its threshold (p99 above the SLO with enough window
samples to trust it, lag past ``lag_high_ms``, or any shed in the
window); a tick is CALM only when every signal is comfortably inside
(p99 under ``p99_high_ms * p99_low_ratio`` or no read traffic at all,
zero sheds, lag under half the breach bound).  The band between breach
and calm is dead: both streaks reset, nothing moves — that dead band,
the consecutive-tick requirements and the cooldown are three
independent anti-flap stages, and the unit tests drive oscillating
signals through all of them asserting the replica count moves as a
step function, never a sawtooth.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from koordinator_tpu_torch.obs.slo import aggregate_buckets, quantile_from_buckets

logger = logging.getLogger(__name__)

SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
HOLD = "hold"


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The declarative autoscaling contract.

    ``p99_high_ms`` IS the read SLO: the windowed read p99 the tier
    must hold.  ``p99_low_ratio`` defines the calm band's ceiling as a
    fraction of it — scaling down only when comfortably under the SLO
    keeps the up/down thresholds apart (classic hysteresis; equal
    thresholds flap on any noisy signal).  ``up_after``/``down_after``
    are consecutive-tick requirements (down is deliberately slower:
    adding capacity late costs SLO, removing it late costs only a
    replica's keep), and ``cooldown_ticks`` freezes decisions after
    every action so the tier's response has time to land in the
    signals before the next judgement."""

    min_replicas: int = 1
    max_replicas: int = 8
    p99_high_ms: float = 50.0
    p99_low_ratio: float = 0.5
    lag_high_ms: float = 1_000.0
    min_count: int = 20
    up_after: int = 2
    down_after: int = 5
    cooldown_ticks: int = 3

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"replica bounds [{self.min_replicas}, "
                f"{self.max_replicas}] are not a range"
            )
        if not (0.0 < self.p99_low_ratio <= 1.0):
            raise ValueError(
                f"p99_low_ratio {self.p99_low_ratio} must be in (0, 1]"
            )


@dataclasses.dataclass(frozen=True)
class AutoscaleSignals:
    """One tick's view of the tier.  ``read_p99_ms``/``read_count``
    are WINDOW values (since the previous tick), ``shed_delta`` sheds
    in the window, ``lag_ms`` the current replication lag gauge;
    any signal may be None/0 when its source has nothing to say."""

    read_p99_ms: Optional[float] = None
    read_count: int = 0
    shed_delta: int = 0
    lag_ms: Optional[float] = None
    replicas: Optional[int] = None


class RegistrySignals:
    """Signal source over a ``koordlet.metrics.MetricsRegistry``.

    ``p99_family``/``p99_labels`` name the read-latency histogram to
    window (the trace harness populates
    ``koord_scorer_trace_cycle_ms``; a daemon can point this at
    ``koord_scorer_cycle_latency_ms`` instead).  ``shed_families`` are
    counter (family, labels) pairs summed into the shed delta, and
    ``lag_gauge`` the replication-lag gauge to read directly.  Each
    ``collect()`` snapshots the cumulative counters/buckets, so the
    returned signals are per-window deltas — exactly what the
    hysteresis machine wants (cumulative counters never calm down)."""

    def __init__(
        self,
        registry,
        p99_family: str = "koord_scorer_trace_cycle_ms",
        p99_labels: Optional[Mapping[str, str]] = None,
        shed_families: Tuple[Tuple[str, Mapping[str, str]], ...] = (
            ("koord_scorer_shed_total", {"method": "score"}),
            ("koord_scorer_shed_total", {"method": "assign"}),
        ),
        lag_gauge: str = "koord_scorer_replica_lag_ms",
    ):
        self.registry = registry
        self.p99_family = p99_family
        self.p99_labels = dict(p99_labels or {})
        self.shed_families = tuple(
            (fam, dict(labels)) for fam, labels in shed_families
        )
        self.lag_gauge = lag_gauge
        self._prev_buckets: Tuple[int, ...] = ()
        self._prev_shed = 0.0

    def collect(self) -> AutoscaleSignals:
        bounds, cumulative, _count = aggregate_buckets(
            self.registry, self.p99_family, self.p99_labels
        )
        if self._prev_buckets and len(self._prev_buckets) == len(cumulative):
            delta = [c - p for c, p in zip(cumulative, self._prev_buckets)]
        else:
            delta = list(cumulative)
        self._prev_buckets = tuple(cumulative)
        p99 = quantile_from_buckets(bounds, delta, 0.99)
        count = delta[-1] if delta else 0
        shed = 0.0
        for fam, labels in self.shed_families:
            shed += self.registry.get(fam, labels) or 0.0
        shed_delta = max(0.0, shed - self._prev_shed)
        self._prev_shed = shed
        lag = self.registry.get(self.lag_gauge)
        return AutoscaleSignals(
            read_p99_ms=p99,
            read_count=int(count),
            shed_delta=int(shed_delta),
            lag_ms=lag,
        )


class ReplicaAutoscaler:
    """The elastic-tier control loop.

    ``spawn()``/``drain()`` are the daemon layer's capacity levers —
    called OUTSIDE the autoscaler's lock, expected to return quickly
    (kick off the replica start/stop, don't wait for it) and allowed
    to raise (a failed spawn logs, the decision stands and cooldown
    still applies, so a broken lever cannot turn into a spawn storm).
    ``signals`` is any callable returning :class:`AutoscaleSignals`
    (:class:`RegistrySignals` ``.collect`` in production, a lambda in
    tests).  ``replicas`` seeds the tracked target; when a tick's
    signals carry an authoritative ``replicas`` count it wins."""

    def __init__(
        self,
        policy: AutoscalePolicy,
        signals: Callable[[], AutoscaleSignals],
        spawn: Callable[[], object],
        drain: Callable[[], object],
        metrics=None,
        replicas: Optional[int] = None,
        interval_s: float = 1.0,
        max_events: int = 256,
    ):
        self.policy = policy
        self.signals = signals
        self.spawn = spawn
        self.drain = drain
        self.metrics = metrics
        self.interval_s = float(interval_s)
        self.replicas = (
            policy.min_replicas if replicas is None else int(replicas)
        )
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        # spawn -> first-served-read economics: each spawn
        # stamps a start; a SYNCHRONOUS lever (the in-process relay
        # tier returns once the replica serves) closes it on return,
        # an async lever closes it via notify_ready() when the replica
        # reports in.  The last closed interval is the stats() stat.
        self._spawn_t0: Optional[float] = None
        self.spawn_to_ready_ms: List[float] = []
        self.events: List[Dict[str, object]] = []
        self._max_events = max(1, int(max_events))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the decision state machine (pure against the signals) --
    def _classify(self, s: AutoscaleSignals) -> str:
        p = self.policy
        p99_known = (
            s.read_p99_ms is not None and s.read_count >= p.min_count
        )
        if (
            (p99_known and s.read_p99_ms > p.p99_high_ms)
            or (s.lag_ms is not None and s.lag_ms > p.lag_high_ms)
            or s.shed_delta > 0
        ):
            return "breach"
        p99_calm = (
            not p99_known  # idle tier: no read traffic to defend
            or s.read_p99_ms <= p.p99_high_ms * p.p99_low_ratio
        )
        lag_calm = s.lag_ms is None or s.lag_ms <= p.lag_high_ms / 2.0
        if p99_calm and lag_calm and s.shed_delta == 0:
            return "calm"
        return "band"  # the dead band: hold, reset both streaks

    def decide(self, s: AutoscaleSignals) -> str:
        """One tick of the hysteresis machine.  Returns the ACTION
        (:data:`SCALE_UP`/:data:`SCALE_DOWN`/:data:`HOLD`); the caller
        (``tick``) owns applying it.  Stateful across calls — streaks
        and cooldown live here — but free of I/O and clocks."""
        if s.replicas is not None:
            self.replicas = int(s.replicas)
        state = self._classify(s)
        if state == "breach":
            self._up_streak += 1
            self._down_streak = 0
        elif state == "calm":
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return HOLD
        p = self.policy
        if (
            self._up_streak >= p.up_after
            and self.replicas < p.max_replicas
        ):
            self._up_streak = 0
            self._down_streak = 0
            self._cooldown = p.cooldown_ticks
            return SCALE_UP
        if (
            self._down_streak >= p.down_after
            and self.replicas > p.min_replicas
        ):
            self._up_streak = 0
            self._down_streak = 0
            self._cooldown = p.cooldown_ticks
            return SCALE_DOWN
        return HOLD

    # -- the loop body --
    def tick(self) -> Dict[str, object]:
        """Collect -> decide -> act -> record.  Returns the decision
        record (also appended to the bounded ``events`` log)."""
        s = self.signals()
        action = self.decide(s)
        if action == SCALE_UP:
            self.replicas += 1
            self.scale_ups += 1
            t0 = time.perf_counter()
            self._spawn_t0 = t0
            try:
                self.spawn()
                # a synchronous lever just finished the whole start; an
                # async one re-stamps the real readiness via
                # notify_ready() (later wins — it replaces this sample)
                self._record_ready(t0)
            except Exception:  # a broken capacity lever must not kill the control loop; cooldown already gates the retry rate
                self._spawn_t0 = None
                logger.exception("autoscale spawn failed")
        elif action == SCALE_DOWN:
            self.replicas -= 1
            self.scale_downs += 1
            try:
                self.drain()
            except Exception:  # same contract as spawn
                logger.exception("autoscale drain failed")
        self.ticks += 1
        record: Dict[str, object] = {
            "tick": self.ticks,
            "action": action,
            "replicas": self.replicas,
            "read_p99_ms": s.read_p99_ms,
            "read_count": s.read_count,
            "shed_delta": s.shed_delta,
            "lag_ms": s.lag_ms,
        }
        if action != HOLD:
            self.events.append(record)
            del self.events[:-self._max_events]
        m = self.metrics
        if m is not None:
            try:
                if action != HOLD:
                    m.count_autoscale_event(action)
                m.set_autoscale_replicas(self.replicas)
            except Exception:  # koordlint: disable=broad-except(autoscale metrics are observability; they must never stop the control loop)
                pass
        return record

    def _record_ready(self, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        self.spawn_to_ready_ms.append(ms)
        del self.spawn_to_ready_ms[:-self._max_events]

    def notify_ready(self) -> None:
        """Async-lever readiness callback: the daemon layer calls this
        when the replica the last spawn started actually serves.  The
        measured interval REPLACES the lever-return sample the spawn
        recorded (for a kick-off-and-return lever, return time is not
        readiness)."""
        t0 = self._spawn_t0
        if t0 is None:
            return
        self._spawn_t0 = None
        ms = (time.perf_counter() - t0) * 1e3
        if self.spawn_to_ready_ms:
            self.spawn_to_ready_ms[-1] = ms
        else:
            self.spawn_to_ready_ms.append(ms)

    # -- optional daemon thread --
    def start(self) -> "ReplicaAutoscaler":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # a transient signal-source failure (registry mid-mutation, healthz probe refused) must not end autoscaling forever
                logger.exception("autoscale tick failed")

    def stats(self) -> Dict[str, object]:
        return {
            "replicas": self.replicas,
            "min_replicas": self.policy.min_replicas,
            "max_replicas": self.policy.max_replicas,
            "p99_high_ms": self.policy.p99_high_ms,
            "ticks": self.ticks,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "cooldown": self._cooldown,
            "spawn_to_ready_ms": (
                round(self.spawn_to_ready_ms[-1], 3)
                if self.spawn_to_ready_ms else None
            ),
            "events": list(self.events[-16:]),
        }
