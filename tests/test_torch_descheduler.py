"""Parity of the port's descheduler (the LowNodeLoad rebalance leg) with
the JAX package, exactly.

* The anomaly detector, the sorter, the evictor and the classification:
  the reference's own cases (``tests/test_descheduler.py``) run through
  both packages, each result equal and equal to the reference's expected
  value;
* ``balance`` on seeded clusters (one and two pools, node selectors,
  deviation thresholds, node fit on and off, debounced detectors over
  ticks of simulated time, dry run and a limiting evictor): the planned
  evictions, the evictor's records and the detectors' states;
* the rebalance leg of ``chip_smoke.py``: the plan digest at the anchor
  recipe recomputed from the JAX package's ``balance`` on the reference's
  placements, and the port's plan on its own cycle's placements.
"""

import types

import numpy as np
import pytest

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu.descheduler import anomaly as janomaly
from koordinator_tpu.descheduler import evictions as jevictions
from koordinator_tpu.descheduler import lownodeload as jlnl
from koordinator_tpu.descheduler import sorter as jsorter
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.manager.noderesource import priority_class_of as j_priority_class_of
from koordinator_tpu.model import resources as jres
from koordinator_tpu.solver import greedy_assign as j_greedy_assign

from koordinator_tpu_torch import descheduler as tdesched
from koordinator_tpu_torch.descheduler import anomaly as tanomaly
from koordinator_tpu_torch.descheduler import evictions as tevictions
from koordinator_tpu_torch.descheduler import lownodeload as tlnl
from koordinator_tpu_torch.descheduler import sorter as tsorter
from koordinator_tpu_torch.harness import generators as tgen
from koordinator_tpu_torch.harness import rebalance as trebalance
from koordinator_tpu_torch.harness.anchor import (
    ANCHOR_RECIPE,
    ANCHOR_SHA256,
    REBALANCE_ANCHOR_SHA256,
    cycle_digest,
    plan_digest,
)
from koordinator_tpu_torch.model import resources as tres
from koordinator_tpu_torch.solver import run_cycle

REF = types.SimpleNamespace(anomaly=janomaly, evictions=jevictions, sorter=jsorter,
                            lnl=jlnl, res=jres)
PORT = types.SimpleNamespace(anomaly=tanomaly, evictions=tevictions, sorter=tsorter,
                             lnl=tlnl, res=tres)
Gi = 1024**3


def both(fn, *args):
    """``fn(M, *args)`` for the reference and the port; equal results."""
    want = fn(REF, *args)
    got = fn(PORT, *args)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# anomaly detector
# ---------------------------------------------------------------------------


def detector_trace(M, marks, timeout, conds):
    t = [0.0]
    kw = {}
    if conds:
        kw = {"anomaly_condition": lambda c: c.consecutive_abnormalities > 2,
              "normal_condition": lambda c: c.consecutive_normalities > 1}
    changes = []
    d = M.anomaly.BasicDetector("n1", timeout_seconds=timeout, clock=lambda: t[0],
                                on_state_change=lambda n, a, b: changes.append(
                                    (n, a.value, b.value)), **kw)
    out = []
    for step, mark in enumerate(marks):
        if mark == "tick":
            t[0] += 61.0
            continue
        if mark == "reset":
            d.reset()
            out.append(("reset", d.state().value, d.counter.total))
            continue
        out.append((step, d.mark(mark).value, dict(vars(d.counter))))
    return out, changes


@pytest.mark.parametrize("marks,timeout,conds", [
    ([False] * 6, 60, False),
    ([False] * 6 + [True] * 4, 60, False),
    ([False] * 5 + ["tick"] + [False] * 6, 60, False),
    ([False] * 6 + ["reset", False], 60, False),
    ([False, True, False, False, False, True, True, "tick", False], 0, True),
])
def test_detector(marks, timeout, conds):
    out, changes = both(detector_trace, marks, timeout, conds)
    assert out


def test_detector_expected_states():
    def trips(M):
        d = M.anomaly.BasicDetector("n1", clock=lambda: 0.0)
        return [d.mark(False).value for _ in range(6)]

    assert both(trips) == ["ok"] * 5 + ["anomaly"]

    def rolls(M):
        d = M.anomaly.BasicDetector("n", timeout_seconds=60, clock=lambda: 0.0)
        for _ in range(5):
            d.mark(False, now=0.0)
        return d.mark(False, now=100.0).value

    assert both(rolls) == "ok"


# ---------------------------------------------------------------------------
# sorter
# ---------------------------------------------------------------------------


def sorted_names(M, pods, metrics, alloc, weights):
    return [p["name"] for p in M.sorter.sort_pods_for_eviction(pods, metrics, alloc, weights)]


SORT_CASES = [
    ([{"name": "prod", "priority_class": "koord-prod", "priority": 9500},
      {"name": "batch-low-use", "priority_class": "koord-batch", "priority": 5500},
      {"name": "free", "priority_class": "koord-free", "priority": 3500}],
     {}, ["free", "batch-low-use", "prod"]),
    ([{"name": "a", "priority": 5500}, {"name": "b", "priority": 5500}],
     {"a": {"cpu": "1"}, "b": {"cpu": "4"}}, ["b", "a"]),
    ([{"name": "ls", "priority": 5500, "qos": "LS"},
      {"name": "be", "priority": 5500, "qos": "BE"}], {}, ["be", "ls"]),
]


@pytest.mark.parametrize("pods,metrics,want", SORT_CASES)
def test_sorter_reference_cases(pods, metrics, want):
    assert both(sorted_names, pods, metrics, {"cpu": "10"}, {"cpu": 1}) == want


def random_pods(seed, n=24):
    rng = np.random.RandomState(seed)
    classes = ["koord-prod", "koord-mid", "koord-batch", "koord-free", "", "other"]
    pods = []
    for i in range(n):
        pod = {"name": f"p{i}", "priority": int(rng.choice([0, 3500, 5500, 7500, 9500, 100])),
               "creation_timestamp": int(rng.randint(0, 5))}
        for key, choices in (("priority_class", classes),
                             ("k8s_qos", ["BestEffort", "Burstable", "Guaranteed"]),
                             ("qos", ["BE", "LS", "LSR", "LSE", "SYSTEM"])):
            if rng.uniform() < 0.7:
                pod[key] = str(rng.choice(choices))
        if rng.uniform() < 0.3:
            pod["deletion_cost"] = int(rng.randint(-2, 3))
        if rng.uniform() < 0.3:
            pod["eviction_cost"] = int(rng.randint(0, 3))
        if rng.uniform() < 0.2:
            del pod["priority"]
        pods.append(pod)
    metrics = {f"p{i}": {"cpu": f"{int(rng.randint(0, 4000))}m",
                         "memory": int(rng.randint(0, 8)) * Gi}
               for i in range(n) if rng.uniform() < 0.8}
    return pods, metrics


@pytest.mark.parametrize("seed", range(6))
def test_sorter_fuzz(seed):
    pods, metrics = random_pods(seed)
    both(sorted_names, pods, metrics, {"cpu": "16", "memory": "64Gi"},
         {"cpu": 1, "memory": 2})
    for pod in pods:
        assert tsorter.priority_class_of(pod) == j_priority_class_of(pod)

    def nodes_by_usage(M, ascending):
        nodes = [{"name": p["name"], "u": i % 5} for i, p in enumerate(pods)]
        return [n["name"] for n in M.sorter.sort_nodes_by_usage(
            nodes, lambda n: n["u"], ascending=ascending)]

    both(nodes_by_usage, False)
    both(nodes_by_usage, True)


# ---------------------------------------------------------------------------
# evictor
# ---------------------------------------------------------------------------


def evictor_trace(M, kw, ops):
    t = [0.0]
    ev = M.evictions.PodEvictor(clock=lambda: t[0], **kw)
    out = []
    for op in ops:
        if op == "tick":
            t[0] += 1.1
        elif op == "reset":
            ev.reset()
        else:
            name, ns, node = op
            out.append(ev.evict({"name": name, "namespace": ns}, node, reason="r"))
    return out, ev.total_evicted(), [vars(r) for r in ev.evicted], ev.node_counts


@pytest.mark.parametrize("kw,ops,want", [
    ({"max_pods_per_node": 1}, [("a", "d", "n1"), ("b", "d", "n1"), ("c", "d", "n2")],
     [True, False, True]),
    ({"max_pods_per_namespace": 1}, [("a", "x", "n1"), ("b", "x", "n2")], [True, False]),
    ({"qps": 1.0, "burst": 2}, [("a", "d", "n1"), ("b", "d", "n1"), ("c", "d", "n1"),
                                "tick", ("c", "d", "n1")], [True, True, False, True]),
    ({"evict_fn": lambda pod, reason: False}, [("a", "d", "n1")], [False]),
    ({"max_pods_per_node": 1, "dry_run": True, "evict_fn": lambda pod, reason: False},
     [("a", "d", "n1"), "reset", ("b", "d", "n1")], [True, True]),
])
def test_evictor(kw, ops, want):
    assert both(evictor_trace, kw, ops)[0] == want


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


def classified(M, usage, alloc, low, high, deviation, unsched=None):
    cls = M.lnl.classify([f"n{i}" for i in range(len(usage))], np.array(usage, np.int64),
                         np.array(alloc, np.int64), np.array(low), np.array(high),
                         deviation, unschedulable=unsched)
    return (cls.underutilized.tolist(), cls.overutilized.tolist(),
            cls.low_threshold.tolist(), cls.high_threshold.tolist())


@pytest.mark.parametrize("usage,alloc,low,high,deviation,unsched,want", [
    ([[10, 10], [50, 50], [95, 40]], [[100, 100]] * 3, [30.0, 30.0], [80.0, 80.0], False,
     None, ([True, False, False], [False, False, True])),
    ([[10, 10]], [[100, 100]], [30.0, 30.0], [80.0, 80.0], False, np.array([True]),
     ([False], [False])),
    ([[30], [50], [70]], [[100]] * 3, [10.0], [10.0], True, None,
     ([True, False, False], [False, False, True])),
])
def test_classify_reference_cases(usage, alloc, low, high, deviation, unsched, want):
    got = both(classified, usage, alloc, low, high, deviation, unsched)
    assert got[:2] == want


@pytest.mark.parametrize("deviation", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_classify_fuzz(seed, deviation):
    rng = np.random.RandomState(seed)
    alloc = rng.randint(0, 64000, (12, 3))
    usage = (alloc * rng.uniform(0, 1.1, (12, 3))).astype(np.int64)
    low = rng.choice([0.0, 10.0, 30.0], 3)
    high = rng.choice([0.0, 20.0, 70.0], 3)
    both(classified, usage.tolist(), alloc.tolist(), low.tolist(), high.tolist(), deviation,
         rng.uniform(size=12) < 0.2)


# ---------------------------------------------------------------------------
# balance
# ---------------------------------------------------------------------------


def mk_node(name, cpu_used, pods=(), cpu_cap=100, labels=None):
    nd = {"name": name, "allocatable": {"cpu": str(cpu_cap), "memory": 100 * Gi},
          "usage": {"cpu": str(cpu_used), "memory": 10 * Gi}, "pods": list(pods)}
    if labels is not None:
        nd["labels"] = labels
    return nd


def pool(M, **kw):
    kw.setdefault("low_thresholds", {"cpu": 30, "memory": 30})
    kw.setdefault("high_thresholds", {"cpu": 70, "memory": 70})
    return M.lnl.NodePool(**kw)


def run_balance(M, nodes, pools, args_kw=None, ticks=1, evictor_kw=None, now=None):
    detectors = {}
    plans = []
    ev = M.evictions.PodEvictor(**(evictor_kw or {}))
    args = M.lnl.LowNodeLoadArgs(node_pools=[pool(M, **p) for p in pools], **(args_kw or {}))
    for k in range(ticks):
        plans.append(M.lnl.balance(args, nodes, ev, detectors,
                                   now=None if now is None else now + 30.0 * k))
    states = {n: (d.state(now).value, vars(d.counter)) for n, d in sorted(detectors.items())}
    return plans, [vars(r) for r in ev.evicted], states


def hot_pods(n, cpu="10", **extra):
    return [{"name": f"be-{i}", "priority": 5500, "qos": "BE", "usage": {"cpu": cpu}, **extra}
            for i in range(n)]


BALANCE_CASES = {
    "evicts_until_under": ([mk_node("cold", 10), mk_node("hot", 90, hot_pods(5)),
                            mk_node("mid", 50)], [{}], {}, 1, None,
                           [["be-0", "be-1"]]),
    "no_low_nodes": ([mk_node("hot", 90, [{"name": "p", "usage": {"cpu": "10"}}]),
                      mk_node("hot2", 85)], [{}], {}, 1, None, [[]]),
    "all_low_nodes": ([mk_node("a", 5), mk_node("b", 5)], [{}], {}, 1, None, [[]]),
    "anomaly_debounce": ([mk_node("cold", 10), mk_node("hot", 90, [
        {"name": "p", "priority": 5500, "usage": {"cpu": "30"}}]), mk_node("mid", 50)],
        [{"consecutive_abnormalities": 3}], {}, 4, None, [[], [], [], ["p"]]),
    "headroom_limits": ([mk_node("cold", 59), mk_node("hot", 95, hot_pods(5)),
                         mk_node("mid", 65)],
                        [{"low_thresholds": {"cpu": 60, "memory": 60},
                          "high_thresholds": {"cpu": 70, "memory": 70}}], {}, 1, None,
                        [["be-0", "be-1"]]),
    "pool_selector": ([mk_node("hot", 90, [{"name": "p", "usage": {"cpu": "30"}}],
                               labels={"pool": "other"}),
                       mk_node("cold", 10, labels={"pool": "other"})],
                      [{"node_selector": {"pool": "mine"}}], {}, 1, None, [[]]),
    "dry_run": ([mk_node("cold", 10), mk_node("hot", 90, hot_pods(1, "30")),
                 mk_node("mid", 50)], [{}], {"dry_run": True}, 1,
                {"evict_fn": lambda pod, reason: False}, [["be-0"]]),
    "node_fit_blocks": ([mk_node("cold", 10), mk_node("hot", 90, hot_pods(
        1, "30", requests={"cpu": "90"})), mk_node("mid", 50)], [{}], {"node_fit": True}, 1,
        None, [[]]),
    "node_fit_off": ([mk_node("cold", 10), mk_node("hot", 90, hot_pods(
        1, "30", requests={"cpu": "90"})), mk_node("mid", 50)], [{}], {"node_fit": False}, 1,
        None, [["be-0"]]),
    "guard_exit_leaves_nodes": ([mk_node("cold", 10), mk_node("hot", 90, hot_pods(1, "30")),
                                 mk_node("mid", 50)],
                                [{"name": "a", "low_thresholds": {"cpu": 99, "memory": 99},
                                  "high_thresholds": {"cpu": 99, "memory": 99}},
                                 {"name": "b"}], {}, 1, None, [["be-0"]]),
    "paused": ([mk_node("cold", 10), mk_node("hot", 90, hot_pods(2))], [{}],
               {"paused": True}, 1, None, [[]]),
    "per_node_cap": ([mk_node("cold", 10), mk_node("hot", 95, hot_pods(5)),
                      mk_node("mid", 50)], [{}], {}, 1, {"max_pods_per_node": 1},
                     [["be-0"]]),
}


@pytest.mark.parametrize("case", sorted(BALANCE_CASES))
def test_balance_reference_cases(case):
    nodes, pools, args_kw, ticks, ev_kw, want = BALANCE_CASES[case]
    plans, _, _ = both(run_balance, nodes, pools, args_kw, ticks, ev_kw)
    assert [[p["pod"] for p in plan] for plan in plans] == want


def random_cluster(seed, n_nodes=16):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        cap = int(rng.choice([16, 32, 64]))
        used = float(rng.uniform(0.02, 0.95))
        pods = []
        for k in range(int(rng.randint(0, 7))):
            cpu = int(rng.choice([250, 500, 1000, 4000]))
            pod = {"name": f"n{i}-p{k}", "priority": int(rng.choice([3500, 5500, 9500])),
                   "qos": str(rng.choice(["BE", "LS", "SYSTEM"])),
                   "requests": {"cpu": f"{cpu}m", "memory": int(rng.choice([1, 4])) * Gi}}
            if rng.uniform() < 0.8:
                pod["usage"] = {"cpu": f"{int(cpu * rng.uniform(0.2, 2))}m",
                                "memory": int(rng.choice([1, 2, 6])) * Gi}
            if rng.uniform() < 0.1:
                pod["non_removable"] = True
            pods.append(pod)
        nodes.append({
            "name": f"node-{i}", "labels": {"zone": "a" if i % 3 else "b"},
            "allocatable": {"cpu": f"{cap}", "memory": cap * 4 * Gi},
            "usage": {"cpu": f"{int(cap * 1000 * used)}m",
                      "memory": int(cap * 4 * Gi * rng.uniform(0.05, 0.9))},
            "unschedulable": bool(rng.uniform() < 0.1), "pods": pods})
    return nodes


@pytest.mark.parametrize("variant", [
    ([{}], {}, None),
    ([{"low_thresholds": {"cpu": 20, "memory": 20},
       "high_thresholds": {"cpu": 50, "memory": 50}}], {"dry_run": True}, None),
    ([{"use_deviation_thresholds": True, "low_thresholds": {"cpu": 10},
       "high_thresholds": {"cpu": 10}}], {}, None),
    ([{"name": "a", "node_selector": {"zone": "a"}},
      {"name": "b", "low_thresholds": {"cpu": 40}, "high_thresholds": {"cpu": 60}}],
     {"number_of_nodes": 1}, None),
    ([{"consecutive_abnormalities": 2, "anomaly_timeout_seconds": 300}],
     {"node_fit": False}, 100.0),
    ([{"consecutive_abnormalities": 2}], {}, 100.0),
])
@pytest.mark.parametrize("seed", range(4))
def test_balance_fuzz(seed, variant):
    pools, args_kw, now = variant
    both(run_balance, random_cluster(seed), pools, args_kw, 4, {"max_pods_per_node": 3}, now)


def test_pod_filter_and_package_exports():
    nodes = random_cluster(5)

    def filtered(M):
        args = M.lnl.LowNodeLoadArgs(node_pools=[pool(M)])
        return M.lnl.balance(args, nodes, M.evictions.PodEvictor(),
                             pod_filter=lambda p: p["priority"] != 3500)

    both(filtered)
    assert tdesched.balance is tlnl.balance and tdesched.NodePool is tlnl.NodePool
    assert tdesched.BasicDetector is tanomaly.BasicDetector


# ---------------------------------------------------------------------------
# the rebalance leg at the anchor recipe
# ---------------------------------------------------------------------------


def test_rebalance_anchor_from_the_reference():
    snap, nodes, pods, *_ = jgen.quota_colocation_snapshot(**ANCHOR_RECIPE)
    result = j_greedy_assign(snap)
    assignment = np.asarray(result.assignment)
    assert cycle_digest(assignment, result.status) == ANCHOR_SHA256
    args = jlnl.LowNodeLoadArgs(node_pools=[jlnl.NodePool(
        low_thresholds={"cpu": 20, "memory": 20},
        high_thresholds={"cpu": 50, "memory": 50})], dry_run=True)
    plan = jlnl.balance(args, trebalance.placed_node_dicts(nodes, pods, assignment.tolist()),
                        jevictions.PodEvictor(dry_run=True))
    assert plan_digest(plan) == REBALANCE_ANCHOR_SHA256


def test_port_meets_the_rebalance_anchor():
    snap, nodes, pods, *_ = tgen.quota_colocation_snapshot(**ANCHOR_RECIPE, device="cpu")
    result = run_cycle(snap)
    node_dicts = trebalance.placed_node_dicts(nodes, pods, result.assignment.tolist())
    plan = trebalance.plan_rebalance(node_dicts)
    assert plan_digest(plan) == REBALANCE_ANCHOR_SHA256
    assert len(plan) > 0
    assert sum(len(n["pods"]) for n in node_dicts) == int((result.assignment >= 0).sum())
