"""The port's control plane around the scheduler (``koordinator_tpu_torch/
manager/``, the descheduler's runtime, migration, k8s plugins and server,
``transformers.py`` and ``harness/reference.py``), held against the JAX
package.

The reference's own cases (``tests/test_manager.py``, the webhook classes
of ``tests/test_webhook_features_proxy.py``, the descheduler, webhook and
manager server classes of ``tests/test_servers_ha.py``,
``tests/test_descheduler_runtime.py``, ``tests/test_descheduler.py``,
``tests/test_transformers.py`` and ``tests/test_e2e_smoke.py``) run through
both packages by the rebinding of ``tests/test_torch_koordlint.py``, in
groups of at most 40 parametrised tests, each from its own
``tests/test_torch_controlplane_<group>.py``.

The port's own cases follow: the whole co-location loop of
``harness/controlplane.py`` (cycle A, NodeMetrics, the manager, the
webhook over HTTPS, the transformers and cycle B, the ReservationFirst
migration with cycle C) driven through both packages on seeded clusters
and compared exactly, its daemons elected, healthy and stopped, and the
sequential oracle ``harness/reference.py`` against the JAX package's.
"""

import os
import types

import numpy as np
import pytest

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
import jax.numpy as jnp
from koordinator_tpu import transformers as j_transformers
from koordinator_tpu.descheduler import evictions as j_evictions
from koordinator_tpu.descheduler import lownodeload as j_lownodeload
from koordinator_tpu.descheduler import migration as j_migration
from koordinator_tpu.descheduler import runtime as j_runtime
from koordinator_tpu.descheduler import server as j_dserver
from koordinator_tpu.harness import generators as j_generators
from koordinator_tpu.harness import reference as j_reference
from koordinator_tpu.koordlet import metriccache as j_mc
from koordinator_tpu.koordlet import statesinformer as j_si
from koordinator_tpu.manager import noderesource as j_noderesource
from koordinator_tpu.manager import profile as j_profile
from koordinator_tpu.manager import server as j_mserver
from koordinator_tpu.manager import sloconfig as j_sloconfig
from koordinator_tpu.manager import validating as j_validating
from koordinator_tpu.manager import webhook_server as j_webhook
from koordinator_tpu.model import encode_snapshot as j_encode_snapshot
from koordinator_tpu.model import resources as j_resources
from koordinator_tpu.scheduler import reservation_controller as j_rc
from koordinator_tpu.solver import run_cycle as j_run_cycle

from koordinator_tpu_torch.harness import controlplane as cp
from koordinator_tpu_torch.harness import generators as t_generators
from koordinator_tpu_torch.harness import reference as t_reference
from koordinator_tpu_torch.manager import server as t_mserver
from koordinator_tpu_torch.model import resources as t_resources
from koordinator_tpu_torch.solver import greedy_assign
from test_torch_constraints import PACKAGES
from test_torch_koordlint import rebound, reference_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's control-plane cases, in groups of at most 40
# parametrised tests (20 cases on two packages); ``None`` stands for a
# module's test functions.
GROUPS = {
    "manager": (("test_manager", ("TestSloConfig", "TestBatchResource", "TestMidResource",
                                  "TestNeedSync", "TestPriorityClass", "TestNodeSLO")),),
    "webhook": (("test_manager", ("TestProfileMutation", "TestQuotaProfile",
                                  "TestNodeMetricController", "TestReviewRegressions",
                                  "TestJsonPatch")),
                ("test_webhook_features_proxy", ("TestValidatePod", "TestQuotaTree",
                                                 "TestNodeValidation"))),
    "servers": (("test_servers_ha", ("TestDeschedulerServer", "TestWebhookServer",
                                     "TestManagerServer", "TestWebhookRemainingEndpoints")),
                ("test_e2e_smoke", None),
                ("test_descheduler", ("TestReviewRegressions",))),
    "runtime": (("test_descheduler_runtime", ("TestDeschedulerLoop",)),
                ("test_transformers", ("TestPodTransform", "TestNodeTransform",
                                       "TestQuotaAndCluster"))),
    "migration": (("test_descheduler", ("TestMigration", "TestNodeTaints",
                                        "TestRemoveFailedPods", "TestPodLifeTime",
                                        "TestTopologySpread", "TestNewAdaptorsRegistered",
                                        "TestReviewRegressionsRound4")),),
    "lownodeload": (("test_descheduler", ("TestAnomalyDetector", "TestSorter",
                                          "TestPodEvictor", "TestClassify", "TestBalance")),),
}


def group_cases(group):
    """The reference cases of one group: ``(module, class, method)``, the
    class ``""`` for a module-level test function."""
    cases = []
    for module, classes in GROUPS[group]:
        if classes is None:
            bound = rebound(module, "koordinator_tpu")
            cases += [(module, "", name) for name in sorted(vars(bound))
                      if name.startswith("test_") and callable(getattr(bound, name))]
        else:
            cases += reference_cases(module, classes)
    return cases


def test_the_reference_cases_are_collected():
    every = [case for group in GROUPS for case in group_cases(group)]
    assert len(every) == len(set(every)) >= 100
    for group in GROUPS:
        assert os.path.exists(os.path.join(REPO, "tests", f"test_torch_controlplane_{group}.py"))
        assert len(PACKAGES) * len(group_cases(group)) <= 40
    # every class of the reference's manager, descheduler, runtime and
    # transformer suites runs
    for module in ("test_manager", "test_descheduler", "test_descheduler_runtime",
                   "test_transformers"):
        bound = rebound(module, "koordinator_tpu")
        classes = {name for name, v in vars(bound).items()
                   if isinstance(v, type) and name.startswith("Test")}
        assert classes == {c[1] for c in every if c[0] == module}, module


# ---------------------------------------------------------------------------
# the whole loop through both packages
# ---------------------------------------------------------------------------

J_IMPL = types.SimpleNamespace(
    generators=j_generators, metriccache=j_mc, statesinformer=j_si, sloconfig=j_sloconfig,
    noderesource=j_noderesource, profile=j_profile, validating=j_validating,
    manager_server=j_mserver, webhook_server=j_webhook, transformers=j_transformers,
    evictions=j_evictions, lownodeload=j_lownodeload, migration=j_migration,
    descheduler_runtime=j_runtime, descheduler_server=j_dserver, reservation_controller=j_rc,
    resources=j_resources, encode_snapshot=j_encode_snapshot,
    run_cycle=lambda snap, extra_mask=None: j_run_cycle(snap, extra_mask=extra_mask),
    mask=jnp.asarray, host=np.asarray, encode_kw={},
)
# the loop's recipe on the CPU: 256 nodes x 1,024 pods
LOOP = {"pods": 1024, "nodes": 256, "tenants": 4}
NOW = 100_000.0
WEBHOOK_SAMPLE = 32
STEPS = ("cycle_a", "node_metrics", "manager", "cycle_b", "deschedule")
CYCLE_FIELDS = ("assignment", "status", "node_requested", "node_estimated", "quota_used")


def drive_loop(impl, server_module, base, seed, monkeypatch):
    """The loop's six steps on ``impl``, the manager's clock pinned 30 s
    after the reports' ``now``; returns the loop and its lines."""
    monkeypatch.setattr(server_module, "time", types.SimpleNamespace(time=lambda: NOW + 30.0))
    loop = cp.ControlPlaneLoop(impl, str(base), seed=seed, now=NOW, **LOOP)
    lines = {}
    for step in STEPS[:3]:
        lines[step] = getattr(loop, step)()
    lines["webhook"] = loop.webhook(WEBHOOK_SAMPLE)
    for step in STEPS[3:]:
        lines[step] = getattr(loop, step)()
    return loop, lines


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_loop_matches_the_reference(seed, tmp_path, monkeypatch):
    """NodeMetrics, NodeMetric specs, every node's batch resources, the
    NodeSLOs and root quotas, every mutated pod and its JSON patch, the
    validation replies, the transformed objects, cycles A, B and C's five
    arrays, the migration jobs' phases and reasons, the reservations and
    the evictor's records: equal in the two packages."""
    j, j_lines = drive_loop(J_IMPL, j_mserver, tmp_path / "j", seed, monkeypatch)
    t, t_lines = drive_loop(cp.port_impl("cpu"), t_mserver, tmp_path / "t", seed, monkeypatch)
    assert t.metrics == j.metrics
    for field in ("nodemetric_specs", "node_extended_resources", "nodeslos", "quotas"):
        assert getattr(t.view, field) == getattr(j.view, field), field
    assert np.array_equal(t.batch, j.batch)
    assert t.be_mutated == j.be_mutated
    assert t.replies == j.replies and len(t.replies) == 2 * WEBHOOK_SAMPLE
    assert (t.nodes_t, t.pods_t, t.quotas_t) == (j.nodes_t, j.pods_t, j.quotas_t)
    for name in ("a", "b", "c"):
        for field in CYCLE_FIELDS:
            assert np.array_equal(getattr(getattr(t, name), field),
                                  getattr(getattr(j, name), field)), (name, field)
    assert t.jobs == j.jobs and t.evicted == j.evicted and t.reservations == j.reservations
    # the loop did its work: batch resources on every node, the BE pods
    # moved onto them and placed, a migration through reservations
    assert t_lines["manager"]["nodes_with_batch_cpu"] == LOOP["nodes"]
    # the manager reclaimed by usage: pods reported, LSE pods among them,
    # pods without samples and pods the pod list lacks
    nm, m = t_lines["node_metrics"], t_lines["manager"]
    assert nm["pods_reported"] > 0 and nm["pods_unreported"] > 0 and nm["pods_unlisted"] > 0
    assert t_lines["cycle_a"]["lse_pods"] > 0
    assert m["hp_used_cpu_milli_sum"] < m["hp_request_cpu_milli_sum"]
    assert t_lines["webhook"]["moved_to_batch_resources"] == t_lines["webhook"]["be_pods"]
    assert t_lines["cycle_b"]["placed"] > 0 and t_lines["cycle_b"]["trimmed_nodes"] > 0
    assert t_lines["cycle_b"]["batch_cpu_requested_milli"] > 0
    d = t_lines["deschedule"]
    assert d["reservations"] > 0 and d["evicted"] == d["succeeded"] > 0
    for step in STEPS:
        for key in ("placed", "planned_jobs", "evicted", "succeeded", "reservations"):
            assert t_lines[step].get(key) == j_lines[step].get(key), (step, key)


def test_each_cycle_of_the_loop_matches_the_plain_cycle(tmp_path, monkeypatch):
    """The port's cycles A, B and C through ``run_cycle`` on the CPU equal
    ``greedy_assign`` on the same snapshot and mask, all five arrays."""
    checked = []

    def cycle(name, snap, extra_mask=None):
        from koordinator_tpu_torch.solver import run_cycle

        got = run_cycle(snap, extra_mask=extra_mask)
        want = greedy_assign(snap, extra_mask=extra_mask)
        for field in CYCLE_FIELDS:
            assert np.array_equal(getattr(got, field), getattr(want, field)), (name, field)
        checked.append(name)
        return got

    monkeypatch.setattr(t_mserver, "time", types.SimpleNamespace(time=lambda: NOW))
    loop = cp.ControlPlaneLoop(cp.port_impl("cpu"), str(tmp_path), seed=3, now=NOW,
                               cycle=cycle, pods=512, nodes=128, tenants=4)
    for step in STEPS[:3]:
        getattr(loop, step)()
    loop.webhook(8)
    for step in STEPS[3:]:
        getattr(loop, step)()
    assert checked == ["A", "B", "C"]


def test_a_stale_metric_degrades_batch_resources_in_both(tmp_path, monkeypatch):
    """The reference's clock: reports older than the strategy's degrade
    time leave every node without batch resources, in both packages (the
    loop's batch check refuses such a node)."""
    for impl, module, name in ((J_IMPL, j_mserver, "j"), (cp.port_impl("cpu"), t_mserver, "t")):
        monkeypatch.setattr(module, "time", types.SimpleNamespace(time=lambda: NOW + 16 * 60))
        loop = cp.ControlPlaneLoop(impl, str(tmp_path / name), seed=0, now=NOW, pods=64,
                                   nodes=16, tenants=2)
        loop.cycle_a()
        loop.node_metrics()
        with pytest.raises(AssertionError, match="degraded"):
            loop.manager()
        assert all(ext == {} for ext in loop.view.node_extended_resources.values())


def test_the_daemons_are_elected_healthy_and_stopped(tmp_path):
    """``servers_leg`` on the port: the manager and the descheduler each win
    their lease, tick once, answer ``/healthz`` and end every thread they
    started."""
    loop = cp.ControlPlaneLoop(cp.port_impl("cpu"), str(tmp_path), seed=0, pods=64, nodes=16,
                               tenants=2, now=NOW)
    loop.cycle_a()
    loop.node_metrics()
    loop.view = t_mserver.ClusterView(nodes_fn=lambda: loop.nodes,
                                      pods_fn=lambda: loop.ls_placed,
                                      node_metrics_fn=lambda: loop.metrics)
    loop.nodes_t, loop.be_placed = loop.nodes, []
    out = cp.servers_leg(cp.port_impl("cpu"), str(tmp_path), loop.view, loop.placed_node_dicts)
    assert out["manager"]["ticks"] == 1 and out["manager"]["healthz"]["reconciles"] == 1
    assert out["descheduler"]["ticks"] == 1 and out["descheduler"]["healthz"]["leader"]


def test_json_patch_round_trip():
    pod = {"name": "p", "labels": {"a": "1"}, "requests": {"cpu": "1"}, "qos": "LS"}
    patch = [{"op": "replace", "path": "/labels", "value": {"a": "2"}},
             {"op": "add", "path": "/priority", "value": 5},
             {"op": "remove", "path": "/qos"}]
    assert cp.apply_json_patch(pod, patch) == {"name": "p", "labels": {"a": "2"},
                                               "requests": {"cpu": "1"}, "priority": 5}
    assert pod["labels"] == {"a": "1"}
    with pytest.raises(ValueError):
        cp.apply_json_patch(pod, [{"op": "move", "path": "/qos"}])


# ---------------------------------------------------------------------------
# the sequential oracle
# ---------------------------------------------------------------------------


def oracle_inputs(res, generators, seed):
    """A seeded cluster as plain lists: node allocatable, requested, usage,
    freshness; pod requests, estimates, priorities, quota ids, prod flags;
    the quotas' runtime, used and limited rows."""
    rng = np.random.RandomState(seed)
    nodes, pods, _, quotas = generators.quota_colocation(seed=seed, pods=48, nodes=12, tenants=3)
    R = res.NUM_RESOURCES
    alloc = [res.resource_vector(n["allocatable"]) for n in nodes]
    requested = [[int(v * rng.uniform(0, 0.5)) for v in a] for a in alloc]
    usage = [res.resource_vector(n["usage"]) for n in nodes]
    fresh = [bool(rng.uniform() < 0.85) for _ in nodes]
    reqs = [res.resource_vector(p["requests"]) for p in pods]
    ests = [[int(v * rng.uniform(0.5, 1.5)) for v in r] for r in reqs]
    prio = [int(p["priority"]) for p in pods]
    qid = [int(rng.randint(-1, 3)) for _ in pods]
    prod = [p["priority_class"] == "koord-prod" for p in pods]
    runtime = {q: [int(v) for v in rng.randint(0, 200_000, R)] for q in range(3)}
    used = {q: [int(v) for v in rng.randint(0, 100_000, R)] for q in range(3)}
    limited = {q: [bool(b) for b in rng.uniform(size=R) < 0.5] for q in range(3)}
    return alloc, requested, usage, fresh, reqs, ests, prio, qid, prod, runtime, used, limited


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated"])
def test_reference_cycle_matches_the_jax_package(seed, strategy):
    """``fit_ok``, ``loadaware_filter_ok``, ``quota_ok``, ``combined_score``
    for every (pod, node) pair and ``schedule_batch`` of the port's oracle
    equal the JAX package's on the same seeded lists."""
    from koordinator_tpu.config import CycleConfig as JCycleConfig
    from koordinator_tpu_torch.config import CycleConfig as TCycleConfig

    (alloc, requested, usage, fresh, reqs, ests, prio, qid, prod, runtime, used,
     limited) = oracle_inputs(t_resources, t_generators, seed)
    assert oracle_inputs(j_resources, j_generators, seed)[0] == alloc

    def make(mod, cfg):
        return mod.ReferenceCycle(alloc, requested, usage, fresh, cfg=cfg,
                                  quota_runtime=runtime, quota_used=used,
                                  quota_limited=limited)

    j = make(j_reference, JCycleConfig(fit_scoring_strategy=strategy))
    t = make(t_reference, TCycleConfig(fit_scoring_strategy=strategy))
    for p, (req, est) in enumerate(zip(reqs, ests)):
        assert t.quota_ok(qid[p], req) == j.quota_ok(qid[p], req)
        for n in range(len(alloc)):
            assert t.fit_ok(n, req) == j.fit_ok(n, req)
            assert t.loadaware_filter_ok(n, prod[p]) == j.loadaware_filter_ok(n, prod[p])
            assert (t.combined_score(n, req, est, prod[p])
                    == j.combined_score(n, req, est, prod[p]))
    got = t.schedule_batch(reqs, ests, priorities=prio, quota_ids=qid, is_prod=prod)
    want = j.schedule_batch(reqs, ests, priorities=prio, quota_ids=qid, is_prod=prod)
    assert got == want and any(a >= 0 for a in got)
    assert t.requested == j.requested and t.quota_used == j.quota_used


def test_reference_cycle_holds_the_port_cycle():
    """The port's oracle against the port's plain cycle on the CPU: the
    spark example's scores and feasibility, and ``schedule_batch`` against
    ``greedy_assign`` on a quota-free seeded cluster."""
    from koordinator_tpu_torch.model import encode_snapshot
    from koordinator_tpu_torch.model.snapshot import estimate_pod
    from koordinator_tpu_torch.model.snapshot import PriorityClass
    from koordinator_tpu_torch.solver import score_cycle

    nodes, pods, gangs, _ = t_generators.spark_colocation()
    snap = encode_snapshot(nodes, pods, gangs, [], device="cpu")
    scores, feasible = score_cycle(snap)
    oracle = t_reference.ReferenceCycle(
        [t_resources.resource_vector(n["allocatable"]) for n in nodes],
        [[0] * t_resources.NUM_RESOURCES for _ in nodes],
        [t_resources.resource_vector(n.get("usage", {})) for n in nodes],
        [bool(n.get("metric_fresh", True)) for n in nodes])
    for p, pod in enumerate(pods):
        req = t_resources.resource_vector(pod["requests"])
        est = estimate_pod(req, t_resources.resource_vector(pod.get("limits", {})),
                           PriorityClass.from_name(pod.get("priority_class")))
        for n in range(len(nodes)):
            assert int(scores[p, n]) == oracle.combined_score(n, req, est)
            assert bool(feasible[p, n]) == (oracle.fit_ok(n, req)
                                             and oracle.loadaware_filter_ok(n))

    nodes, pods, _, _ = t_generators.loadaware_joint(seed=4, pods=96, nodes=16)
    snap = encode_snapshot(nodes, pods, [], [], device="cpu")
    n, P = len(nodes), len(pods)
    cyc = t_reference.ReferenceCycle(
        snap.nodes.allocatable[:n].tolist(), snap.nodes.requested[:n].tolist(),
        snap.nodes.usage[:n].tolist(), snap.nodes.metric_fresh[:n].tolist())
    want = cyc.schedule_batch(snap.pods.requests[:P].tolist(), snap.pods.estimated[:P].tolist(),
                              priorities=snap.pods.priority[:P].tolist())
    assert greedy_assign(snap).assignment[:P].tolist() == want
