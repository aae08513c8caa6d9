"""Relay-tree and elastic-tier harness.

Counterpart of ``koordinator_tpu/harness/relay.py``, with the same names.
Two instruments over the chainable follower relay tree:

* :class:`RelayTier` — a REAL in-process tier of ``SchedulerServer``
  daemons wired exactly like production: a journaled root leader
  publishing on ``<uds>.repl``, a linear relay chain (each hop dials
  its parent with the full ancestor ladder as dial fallbacks and
  re-publishes the applied stream on its own ``.repl``), and optional
  flat followers off the root for the speedup/parity comparison.  The
  harness exposes the failure lever the tree exists for —
  :meth:`RelayTier.kill` an INTERIOR relay mid-storm — plus the
  counters that make the recovery claim checkable: full-frame opens
  (``subscriptions - resumed_subscriptions`` summed over every live
  publisher) and applier-detected discontinuities.  Zero of either
  during a failover means every orphaned descendant re-parented onto a
  surviving ancestor through the hello/resume splice, the tentpole's
  acceptance invariant.

* :func:`autoscale_wave` — the SLO leg: a real
  :class:`~koordinator_tpu_torch.replication.autoscale.ReplicaAutoscaler`
  fed through a real ``MetricsRegistry`` +
  :class:`~koordinator_tpu_torch.replication.autoscale.RegistrySignals`
  (cumulative-bucket delta windows, the production signal path) while
  a traffic WAVE runs load up 10x and back down.  Read latency is
  MODELED (``base_ms * load / replicas`` + jitter) so the control
  loop's judgement — not a 2-core container's scheduling noise — is
  what the gate measures; the spawn/drain levers may be fakes or a
  :class:`RelayTier`'s real leaf spawner.  The report carries the
  per-tick p99s, the decision log and the SLO verdict.

Every daemon serves ``device`` (default CUDA, raising when absent;
``"cpu"`` runs the plain path) over the raw framing only
(``enable_grpc=False``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.replication.autoscale import (
    AutoscalePolicy,
    RegistrySignals,
    ReplicaAutoscaler,
    SCALE_DOWN,
    SCALE_UP,
)


def wait_until(pred, timeout_s: float = 20.0, poll_s: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return bool(pred())


class RelayTier:
    """One in-process relay tree of real daemons.

    ``chain`` is the linear relay depth below the root (``chain=3``
    builds root -> hop1 -> hop2 -> hop3, every interior hop a relay
    publishing on its own socket); ``flat`` adds that many direct
    followers of the root (the tier the tree is benchmarked against).
    All daemons share one tmp directory, raw-UDS transport only (no
    gRPC: Score parity is asserted straight on the servicers), and run on
    ``device`` (default CUDA).
    """

    def __init__(
        self,
        tmp: str,
        chain: int = 3,
        flat: int = 0,
        compress: bool = True,
        batch_bytes: Optional[int] = None,
        device=None,
    ):
        from koordinator_tpu_torch import resolve_device
        from koordinator_tpu_torch.scheduler.server import SchedulerServer

        self.tmp = tmp
        self.device = resolve_device(device)
        self._next_id = 0
        self.leader = SchedulerServer(
            lease_path=os.path.join(tmp, "root.lease"),
            uds_path=os.path.join(tmp, "root.sock"),
            http_port=0,
            enable_grpc=False,
            state_dir=os.path.join(tmp, "root-state"),
            journal=True,
            repl_compress=compress,
            repl_batch_bytes=batch_bytes,
            device=self.device,
        ).start()
        self._compress = compress
        self._batch_bytes = batch_bytes
        # chain[i] is the hop-(i+1) daemon; ancestry for hop k is
        # (parent, grandparent, ..., root)
        self.chain: List[object] = []
        for _ in range(int(chain)):
            self.chain.append(self._spawn(parent_chain=self.chain))
        self.flat: List[object] = []
        for _ in range(int(flat)):
            self.flat.append(self._spawn(parent_chain=[]))
        # elastic leaves added by the autoscale lever, deepest layer
        self.elastic: List[object] = []

    # -- construction --
    def _ladder(self, parent_chain) -> str:
        """The relay_from value for a child of ``parent_chain[-1]``:
        every ancestor's .repl, nearest first, root last."""
        rungs = [srv.repl_path for srv in reversed(parent_chain)]
        rungs.append(self.leader.repl_path)
        return ",".join(rungs)

    def _spawn(self, parent_chain) -> object:
        from koordinator_tpu_torch.scheduler.server import SchedulerServer

        i = self._next_id
        self._next_id += 1
        return SchedulerServer(
            lease_path=os.path.join(self.tmp, f"n{i}.lease"),
            uds_path=os.path.join(self.tmp, f"n{i}.sock"),
            http_port=0,
            enable_grpc=False,
            state_dir=os.path.join(self.tmp, f"n{i}-state"),
            relay_from=self._ladder(parent_chain),
            repl_compress=self._compress,
            repl_batch_bytes=self._batch_bytes,
            device=self.device,
        ).start()

    def spawn_leaf(self) -> object:
        """The autoscaler's spawn lever: one more follower spliced into
        the DEEPEST live layer of the chain (capacity where the tree's
        fan-out multiplies, not on the root's uplink)."""
        live_chain = [s for s in self.chain if s is not None]
        leaf = self._spawn(parent_chain=live_chain)
        self.elastic.append(leaf)
        return leaf

    def drain_leaf(self) -> None:
        """The drain lever: retire the newest elastic leaf."""
        if self.elastic:
            self.elastic.pop().stop()

    # -- the write stream --
    def sync(self, req: "wire.SyncRequest") -> str:
        return self.leader.servicer.sync(req).snapshot_id

    def followers(self) -> List[object]:
        return (
            [s for s in self.chain if s is not None]
            + self.flat
            + self.elastic
        )

    def wait(self, sid: str, timeout_s: float = 30.0) -> bool:
        """Every live follower converged to ``sid``."""
        return wait_until(
            lambda: all(
                s.servicer.snapshot_id() == sid for s in self.followers()
            ),
            timeout_s,
        )

    # -- the recovery counters --
    def full_opens(self) -> int:
        """Subscriptions served a FULL opening frame instead of a
        journal/cache resume, summed over every live publisher.  The
        interior-kill invariant is a ZERO DELTA on this during
        failover: orphans resumed through an ancestor's splice."""
        total = 0
        for srv in [self.leader] + self.followers():
            pub = getattr(srv, "_publisher", None)
            if pub is not None:
                total += pub.subscriptions - pub.resumed_subscriptions
        return total

    def resyncs(self) -> int:
        """Applier-detected discontinuities over every live follower
        (epoch breaks, gaps, decode faults — each forces a reconnect
        and a full-frame open)."""
        return sum(
            s.applier.resyncs
            for s in self.followers()
            if getattr(s, "applier", None) is not None
        )

    # -- the failure lever --
    def kill(self, hop: int) -> None:
        """Kill the interior relay at chain index ``hop`` (0 = the
        root's direct child).  Its descendants lose their parent and
        must redial the surviving ancestor ladder."""
        victim = self.chain[hop]
        assert victim is not None, f"hop {hop} already dead"
        self.chain[hop] = None
        victim.stop()

    def stop(self) -> None:
        for srv in self.elastic + self.flat:
            srv.stop()
        for srv in self.chain:
            if srv is not None:
                srv.stop()
        self.leader.stop()


# ---------------------------------------------------------------------------
# the elastic-tier traffic wave
# ---------------------------------------------------------------------------


def wave_profile(ticks: int, peak: float = 10.0) -> List[float]:
    """The 1x -> ``peak``x -> 1x read-traffic wave: a quarter ramp up,
    half plateau at the peak, quarter ramp down."""
    ramp = max(1, ticks // 4)
    out = []
    for t in range(ticks):
        if t < ramp:
            load = 1.0 + (peak - 1.0) * (t / ramp)
        elif t < ticks - ramp:
            load = peak
        else:
            load = peak - (peak - 1.0) * ((t - (ticks - ramp)) / ramp)
        out.append(load)
    return out


def autoscale_wave(
    ticks: int = 48,
    peak: float = 10.0,
    slo_p99_ms: float = 50.0,
    base_ms: float = 16.0,
    samples_per_tick: int = 64,
    policy: Optional[AutoscalePolicy] = None,
    spawn=None,
    drain=None,
    replicas0: int = 1,
    seed: int = 0,
) -> Dict[str, object]:
    """Drive a 1x->``peak``x->1x read wave through a REAL autoscaler.

    Per tick: the modeled tier serves ``samples_per_tick`` reads at
    ``base_ms * load / replicas`` (+10% jitter) observed into a real
    ``MetricsRegistry`` under the trace-cycle family; the autoscaler's
    :class:`RegistrySignals` then window-deltas those cumulative
    buckets and the hysteresis machine decides.  ``spawn``/``drain``
    default to bookkeeping fakes; pass a :class:`RelayTier`'s levers to
    run the wave against real daemons.

    Returns the report: per-tick records, the
    decision log, peak replica count, and the SLO verdict — the p99
    held under ``slo_p99_ms`` for every plateau tick after the control
    loop's reaction window (policy reaction = up_after + cooldown ticks
    per step, the documented response time of the loop).
    """
    import numpy as np

    from koordinator_tpu_torch.obs.scorer_metrics import ScorerMetrics

    rng = np.random.default_rng(seed)
    metrics = ScorerMetrics()
    policy = policy or AutoscalePolicy(
        min_replicas=1,
        max_replicas=8,
        p99_high_ms=float(slo_p99_ms),
        min_count=max(1, samples_per_tick // 4),
        up_after=1,
        down_after=3,
        cooldown_ticks=1,
    )
    state = {"replicas": max(policy.min_replicas, int(replicas0))}

    def _spawn():
        state["replicas"] += 1
        if spawn is not None:
            spawn()

    def _drain():
        state["replicas"] -= 1
        if drain is not None:
            drain()

    signals = RegistrySignals(metrics.registry)
    scaler = ReplicaAutoscaler(
        policy, signals.collect, _spawn, _drain,
        metrics=metrics, replicas=state["replicas"],
    )

    profile = wave_profile(int(ticks), float(peak))
    ramp = max(1, int(ticks) // 4)
    # the loop's documented reaction window: one scale step costs
    # up_after breach ticks + cooldown_ticks of freeze, and the model
    # says how many steps peak load needs (worst-case jittered latency
    # under the SLO) — plateau ticks after that window are the ones the
    # control loop is accountable for
    import math

    needed = min(
        policy.max_replicas,
        max(
            policy.min_replicas,
            math.ceil(base_ms * peak * 1.1 / slo_p99_ms),
        ),
    )
    steps = max(0, needed - state["replicas"])
    reaction = (policy.up_after + policy.cooldown_ticks) * max(1, steps) + 1
    records: List[Dict[str, object]] = []
    plateau_ok = 0
    plateau_judged = 0
    for t, load in enumerate(profile):
        lat = (
            base_ms * load / max(1, state["replicas"])
            * (1.0 + 0.1 * rng.random(samples_per_tick))
        )
        for ms in lat:
            metrics.observe_trace_cycle("koord-prod", "score", float(ms))
        tick_p99 = float(np.percentile(lat, 99))
        rec = scaler.tick()
        rec["load"] = round(load, 3)
        rec["tick_p99_ms"] = round(tick_p99, 3)
        records.append(rec)
        in_plateau = ramp <= t < int(ticks) - ramp
        if in_plateau and t >= ramp + reaction:
            plateau_judged += 1
            if tick_p99 <= slo_p99_ms:
                plateau_ok += 1

    ups = sum(1 for e in scaler.events if e["action"] == SCALE_UP)
    downs = sum(1 for e in scaler.events if e["action"] == SCALE_DOWN)
    return {
        "ticks": int(ticks),
        "peak_load": float(peak),
        "slo_p99_ms": float(slo_p99_ms),
        "scale_ups": ups,
        "scale_downs": downs,
        "peak_replicas": max(r["replicas"] for r in records),
        "final_replicas": state["replicas"],
        "plateau_ticks_judged": plateau_judged,
        "plateau_ticks_within_slo": plateau_ok,
        "slo_held": plateau_judged > 0 and plateau_ok == plateau_judged,
        # spawn -> first-served-read economics: how long the
        # tier's capacity lever takes to turn a SCALE_UP decision into a
        # serving replica (RelayTier.spawn_leaf returns only once the
        # leaf's server started, so the lever-call duration IS it)
        "spawn_to_ready_ms": scaler.stats()["spawn_to_ready_ms"],
        "spawn_to_ready_ms_all": [
            round(v, 3) for v in scaler.spawn_to_ready_ms
        ],
        "events": list(scaler.events),
        "records": records,
        "registry": metrics.registry,
    }
