"""The port's replica autoscaler (``koordinator_tpu_torch/replication/
autoscale.py``) against the reference's on the same signal sequences:
the hysteresis decisions, the ticks with their levers and events, the
metric families, and the registry signal windows.  Every compared value
is a decision, a count or a float both sides compute the same way, so
every comparison is exact."""

import numpy as np
import pytest

import koordinator_tpu.obs  # noqa: F401  (before replication: import cycle)
from koordinator_tpu.obs.scorer_metrics import ScorerMetrics as RefMetrics
from koordinator_tpu.replication import autoscale as ref

from koordinator_tpu_torch.obs.scorer_metrics import ScorerMetrics
from koordinator_tpu_torch.replication import autoscale as port

PACKAGES = (ref, port)


def _policy(mod, **kw):
    defaults = dict(
        min_replicas=1, max_replicas=8, p99_high_ms=50.0,
        p99_low_ratio=0.5, min_count=4, up_after=2, down_after=3,
        cooldown_ticks=0,
    )
    defaults.update(kw)
    return mod.AutoscalePolicy(**defaults)


_KINDS = {
    "breach": dict(read_p99_ms=120.0, read_count=100),
    "calm": dict(read_p99_ms=10.0, read_count=100),
    # under the SLO, over the calm ceiling
    "band": dict(read_p99_ms=40.0, read_count=100),
    "idle": {},
    # 2 samples under min_count=4: the window p99 is noise
    "thin": dict(read_p99_ms=500.0, read_count=2),
    "lag": dict(lag_ms=500.0),
    "shed": dict(shed_delta=3),
    "authority": dict(replicas=5),
}


def _signals(mod, kind):
    return mod.AutoscaleSignals(**_KINDS[kind])


def _decide_all(mod, policy_kw, replicas, kinds, apply=False):
    """(decision per tick, replicas after) of ``decide`` on ``kinds``;
    ``apply`` moves the count as the tick would."""
    sc = mod.ReplicaAutoscaler(
        _policy(mod, **policy_kw), signals=lambda: mod.AutoscaleSignals(),
        spawn=lambda: None, drain=lambda: None, replicas=replicas,
    )
    out = []
    for kind in kinds:
        action = sc.decide(_signals(mod, kind))
        out.append(action)
        if apply and action == mod.SCALE_UP:
            sc.replicas += 1
        elif apply and action == mod.SCALE_DOWN:
            sc.replicas -= 1
    return out, sc.replicas


# the reference's tests/test_autoscale.py TestDecision cases: (policy,
# starting replicas, signal kinds, apply the actions, the expected
# decisions); "U"/"D"/"." = scale up / scale down / hold
SCENARIOS = {
    "scale_up_needs_consecutive_breaches": (
        dict(up_after=3), None, ["breach"] * 3, False, "..U"),
    "breach_streak_resets_on_calm_tick": (
        dict(up_after=2), None, ["breach", "calm", "breach", "breach"], False, "...U"),
    "scale_down_is_deliberately_slower": (
        dict(up_after=1, down_after=3), 3, ["breach", "calm", "calm", "calm"], False,
        "U..D"),
    "dead_band_resets_both_streaks": (
        dict(up_after=2, down_after=2), 4,
        ["breach", "band", "breach", "band", "calm", "band", "calm"], False, "......."),
    "cooldown_freezes_decisions": (
        dict(up_after=1, cooldown_ticks=2), None, ["breach"] * 4, True, "U..U"),
    "bounds_clamp_at_max": (dict(up_after=1, max_replicas=2), 2, ["breach"], False, "."),
    "bounds_clamp_at_min": (dict(down_after=1, min_replicas=1), 1, ["calm"], False, "."),
    "idle_tier_counts_as_calm": (dict(down_after=2), 3, ["idle", "idle"], False, ".D"),
    "untrusted_p99_cannot_breach": (dict(up_after=1), None, ["thin"], False, "."),
    "lag_breaches_without_p99": (
        dict(up_after=1, lag_high_ms=100.0), None, ["lag"], False, "U"),
    "shed_breaches_without_p99": (dict(up_after=1), None, ["shed"], False, "U"),
}

_CODE = {"scale_up": "U", "scale_down": "D", "hold": "."}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_the_reference(name):
    policy_kw, replicas, kinds, apply, want = SCENARIOS[name]
    got = {}
    for mod in PACKAGES:
        actions, after = _decide_all(mod, policy_kw, replicas, kinds, apply)
        got[mod.__name__.split(".")[0]] = ("".join(_CODE[a] for a in actions), after)
    assert got["koordinator_tpu_torch"] == got["koordinator_tpu"]
    assert got["koordinator_tpu_torch"][0] == want


@pytest.mark.parametrize("seed", range(6))
def test_seeded_signal_sequences_decide_as_the_reference(seed):
    """Random walks over every signal kind and random policies: the port
    decides tick for tick as the reference does, applied counts included."""
    rng = np.random.default_rng(seed)
    kinds = list(rng.choice(["breach", "calm", "band", "idle", "thin", "lag", "shed"], 80))
    policy_kw = dict(
        up_after=int(rng.integers(1, 4)), down_after=int(rng.integers(1, 5)),
        cooldown_ticks=int(rng.integers(0, 3)), max_replicas=int(rng.integers(2, 6)),
        lag_high_ms=float(rng.choice([100.0, 1000.0])),
    )
    runs = [_decide_all(mod, policy_kw, 2, kinds, apply=True) for mod in PACKAGES]
    assert runs[0] == runs[1]


def test_authoritative_replica_count_wins():
    for mod in PACKAGES:
        sc = mod.ReplicaAutoscaler(
            _policy(mod), signals=lambda: None, spawn=lambda: None,
            drain=lambda: None, replicas=1,
        )
        sc.decide(_signals(mod, "authority"))
        assert sc.replicas == 5


def test_oscillating_signal_never_saws():
    for mod in PACKAGES:
        seq = iter([_signals(mod, "breach"), _signals(mod, "calm")] * 20)
        sc = mod.ReplicaAutoscaler(
            _policy(mod, up_after=2, down_after=3, cooldown_ticks=1),
            signals=seq.__next__, spawn=lambda: None, drain=lambda: None, replicas=2,
        )
        for _ in range(40):
            sc.tick()
        assert (sc.scale_ups, sc.scale_downs, sc.replicas) == (0, 0, 2)


def _ticked(mod, metrics):
    calls = []
    seq = iter([_signals(mod, "breach"), _signals(mod, "calm"), _signals(mod, "calm")])
    sc = mod.ReplicaAutoscaler(
        _policy(mod, up_after=1, down_after=1), signals=seq.__next__,
        spawn=lambda: calls.append("spawn"), drain=lambda: calls.append("drain"),
        metrics=metrics, replicas=1,
    )
    first = sc.tick()
    sc.tick()
    return first["action"], sc.replicas, calls, [e["action"] for e in sc.events]


def test_ticks_apply_levers_log_events_and_count_as_the_reference():
    pm, rm = ScorerMetrics(), RefMetrics()
    got = _ticked(port, pm)
    want = _ticked(ref, rm)
    assert got == want == (
        "scale_up", 1, ["spawn", "drain"], ["scale_up", "scale_down"])
    for action in ("scale_up", "scale_down"):
        assert pm.registry.get("koord_scorer_autoscale_events_total",
                               {"action": action}) == 1
        assert rm.registry.get("koord_scorer_autoscale_events_total",
                               {"action": action}) == 1
    assert pm.registry.get("koord_scorer_autoscale_replicas") == \
        rm.registry.get("koord_scorer_autoscale_replicas") == 1


def test_broken_spawn_does_not_kill_the_loop():
    def bad_spawn():
        raise RuntimeError("no capacity")

    for mod in PACKAGES:
        sc = mod.ReplicaAutoscaler(
            _policy(mod, up_after=1, cooldown_ticks=2),
            signals=lambda: _signals(mod, "breach"),
            spawn=bad_spawn, drain=lambda: None, replicas=1,
        )
        sc.tick()
        assert sc.replicas == 2
        sc.tick()
        sc.tick()
        assert sc._cooldown == 0


def _windows(metrics, mod):
    """The three windows of the reference's TestRegistrySignals."""
    sig = mod.RegistrySignals(metrics.registry)
    out = []
    for ms in (200.0, 1.0):
        for _ in range(50):
            metrics.observe_trace_cycle("t", "score", ms)
        s = sig.collect()
        out.append((s.read_count, s.read_p99_ms))
    out.append((sig.collect().read_count,))
    metrics.count_shed("score")
    metrics.count_shed("assign")
    metrics.set_replica_lag(123.0)
    s = sig.collect()
    out.append((s.shed_delta, s.lag_ms, sig.collect().shed_delta))
    return out


def test_registry_signal_windows_equal_the_reference():
    got = _windows(ScorerMetrics(), port)
    assert got == _windows(RefMetrics(), ref)
    (n1, p1), (n2, p2), (n3,), shed = got
    assert (n1, n2, n3) == (50, 50, 0)
    assert p1 > 50.0 and p2 <= 10.0
    assert shed == (2, 123.0, 0)
