"""The port's ElasticQuota, Coscheduling and topology-hint host modules
(``constraints/quota_manager.py``, ``quota_enforce.py``,
``gang_manager.py``, ``scheduler/topologymanager.py``) and the PostFilter,
held against the JAX package.

The reference's own cases (``tests/test_quota_manager.py``,
``tests/test_gang_manager.py``, ``tests/test_numa.py::TestTopologyManager``)
run through both packages: each reference test module is loaded a second
time with its imports bound to the port (encoders on the CPU), and every
test method runs on both bindings.  Seeded and hypothesis-drawn inputs then
go through both packages and the results are compared exactly: quota
runtimes, revoke lists, victims, gang states and phases, merged hints.
"""

import dataclasses
import functools
import inspect
import re
import types
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import koordinator_tpu.obs  # noqa: F401  (before replication: the reference's import cycle)
from koordinator_tpu.constraints import gang_manager as j_gang
from koordinator_tpu.constraints import quota_enforce as j_enforce
from koordinator_tpu.constraints import quota_manager as j_quota
from koordinator_tpu.scheduler import topologymanager as j_topo
from koordinator_tpu_torch.constraints import gang_manager as t_gang
from koordinator_tpu_torch.constraints import quota_enforce as t_enforce
from koordinator_tpu_torch.constraints import quota_manager as t_quota
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.scheduler import topologymanager as t_topo

TESTS = Path(__file__).resolve().parent
PACKAGES = ("koordinator_tpu", "koordinator_tpu_torch")
# the port's entry points default to CUDA: the port binding runs them on
# the CPU
_ON_CPU = ("encode_snapshot", "encode_reservations", "encode_zones", "encode_devices",
           "ScorerServicer", "FollowerServicer", "ChaosTier", "ChaosTraceReplay",
           "RelayTier", "extras_scenario")


@functools.lru_cache(maxsize=None)
def rebound(name: str, package: str) -> types.ModuleType:
    """The reference test module ``tests/<name>.py`` with its imports bound
    to ``package``: as written for the JAX package, else every
    ``koordinator_tpu.`` import pointing at the port, ``pb2`` at the port's
    ``wire`` codec, ``jax.numpy`` at ``torch`` and every call of an entry
    point that takes a device given ``device="cpu"``."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    if package == "koordinator_tpu_torch":
        src = src.replace("from koordinator_tpu.bridge.codegen import pb2",
                          "from koordinator_tpu_torch.bridge import wire as pb2")
        src = src.replace("koordinator_tpu.", "koordinator_tpu_torch.")
        src = src.replace("import jax.numpy as jnp", "import torch as jnp")
        src = re.sub(r"(?<![\w.])(%s)\(" % "|".join(_ON_CPU), r"_on_cpu(\1)(", src)
    module = types.ModuleType(f"{name}__{package}")
    module.__file__ = str(path)
    module._on_cpu = lambda fn: functools.partial(fn, device="cpu")
    exec(compile(src, str(path), "exec"), module.__dict__)
    return module


def run_reference_case(module, cls, method, package, tmp_path):
    """One test method of a rebound reference module, given ``tmp_path``
    when it asks for it."""
    instance = getattr(rebound(module, package), cls)()
    fn = getattr(instance, method)
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()


def reference_cases(name, classes=None):
    module = rebound(name, "koordinator_tpu")
    return [
        (name, cls_name, method)
        for cls_name, cls in sorted(vars(module).items())
        if isinstance(cls, type) and cls_name.startswith("Test")
        and (classes is None or cls_name in classes)
        for method in sorted(vars(cls))
        if method.startswith("test_")
    ]


CASES = (reference_cases("test_quota_manager")
         + reference_cases("test_gang_manager")
         + reference_cases("test_numa", classes=("TestTopologyManager",)))


def test_the_reference_cases_are_collected():
    assert len(CASES) >= 40
    assert {c[0] for c in CASES} == {"test_quota_manager", "test_gang_manager", "test_numa"}


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path):
    run_reference_case(module, cls, method, package, tmp_path)


# ---------------------------------------------------------------------------
# seeded inputs through both packages
# ---------------------------------------------------------------------------

CPU = res.RESOURCE_INDEX[res.CPU]
MEM = res.RESOURCE_INDEX[res.MEMORY]


def plain(obj):
    """A comparable view of either package's objects: dataclasses as
    dicts, enums as values, sets sorted."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(plain(v) for v in obj)
    if hasattr(obj, "value") and type(obj).__module__.startswith("koordinator_tpu"):
        return obj.value
    return obj


def quota_tree(rng):
    """Quota dicts of a two-level tree (2 parents, 2-3 leaves each) and
    pods (name, quota, requests, priority, assigned)."""
    quotas, pods = [], []
    for p in range(2):
        quotas.append({"name": f"p{p}", "is_parent": True,
                       "min": {"cpu": f"{int(rng.integers(10, 40)) * 1000}m"},
                       "max": {"cpu": f"{int(rng.integers(40, 80)) * 1000}m",
                               "memory": int(rng.integers(64, 256)) << 30},
                       "shared_weight": int(rng.integers(1, 4))})
        for c in range(int(rng.integers(2, 4))):
            name = f"p{p}-q{c}"
            quotas.append({
                "name": name, "parent": f"p{p}",
                "min": {"cpu": f"{int(rng.integers(2, 12)) * 1000}m",
                        "memory": int(rng.integers(4, 32)) << 30},
                "max": {"cpu": f"{int(rng.integers(12, 40)) * 1000}m",
                        "memory": int(rng.integers(32, 128)) << 30},
                "shared_weight": int(rng.integers(1, 4)),
                "allow_lent_resource": bool(rng.random() < 0.8),
                "enable_min_quota_scale": bool(rng.random() < 0.5),
            })
            for k in range(int(rng.integers(2, 7))):
                pods.append((name, {
                    "name": f"{name}-pod{k}",
                    "requests": {"cpu": f"{int(rng.integers(1, 9)) * 1000}m",
                                 "memory": int(rng.integers(1, 16)) << 30},
                    "priority": int(rng.integers(0, 100)),
                    "non_preemptible": bool(rng.random() < 0.2),
                    "start_time": float(rng.integers(0, 50)),
                }, bool(rng.random() < 0.7)))
    total = [0] * res.NUM_RESOURCES
    total[CPU] = int(rng.integers(40, 120)) * 1000
    total[MEM] = int(rng.integers(64, 512)) << 30
    return quotas, pods, total


def drive_quota(mod_quota, mod_enforce, quotas, pods, total):
    mgr = mod_quota.MultiTreeQuotaManager()
    for q in quotas:
        mgr.update_quota(q)
    tree = mgr.manager_for("")
    tree.set_cluster_total(total)
    for quota, pod, assigned in pods:
        tree.on_pod_add(quota, pod, assigned=assigned)
    names = sorted(tree.nodes)
    runtimes = {n: tree.refresh_runtime(n) for n in names}
    table = tree.leaf_quota_table([q["name"] for q in quotas if not q.get("is_parent")])
    ctl = mod_enforce.QuotaOverUsedRevokeController(mgr, trigger_evict_duration=10.0)
    revoked = [[p["name"] for p in ctl.monitor_all_quotas(now)] for now in (0.0, 5.0, 20.0, 40.0)]
    # a pod moves, another leaves: the aggregates follow
    quota, pod, _ = pods[0]
    tree.update_pod_assigned(quota, pod["name"], True)
    tree.on_pod_delete(pods[-1][0], pods[-1][1]["name"])
    after = {n: tree.refresh_runtime(n) for n in names}
    return {"runtimes": runtimes, "table": table, "revoked": revoked, "after": after,
            "nodes": plain({n: tree.nodes[n] for n in names})}


@pytest.mark.parametrize("seed", range(8))
def test_quota_tree_runtimes_and_revokes_match(seed):
    quotas, pods, total = quota_tree(np.random.default_rng(seed))
    want = drive_quota(j_quota, j_enforce, quotas, pods, total)
    got = drive_quota(t_quota, t_enforce, quotas, pods, total)
    assert got == want
    assert any(any(rt) for rt in want["runtimes"].values())


def _victims(nv):
    if nv is None:
        return None
    return (nv.node, [v["name"] for v in nv.victims], nv.num_violating)


pod_st = st.fixed_dictionaries({
    "cpu": st.integers(0, 8), "mem": st.integers(0, 8), "priority": st.integers(0, 5),
    "quota": st.sampled_from(["q0", "q1", None]), "non_preemptible": st.booleans(),
    "start_time": st.integers(0, 3),
})


def _pod(name, d):
    return {"name": name, "requests": {"cpu": f"{d['cpu']}", "memory": d["mem"] << 30},
            "priority": d["priority"], "quota": d["quota"],
            "non_preemptible": d["non_preemptible"], "start_time": float(d["start_time"])}


@settings(max_examples=60, deadline=None)
@given(nodes=st.lists(st.tuples(st.integers(1, 12), st.lists(pod_st, max_size=5)),
                      min_size=1, max_size=4),
       pod=pod_st, used=st.integers(0, 20), runtime=st.integers(0, 24),
       violators=st.sets(st.integers(0, 20), max_size=4))
def test_run_quota_preemption_matches_the_reference(nodes, pod, used, runtime, violators):
    alloc = {f"n{i}": [0] * res.NUM_RESOURCES for i in range(len(nodes))}
    node_pods = {}
    k = 0
    for i, (cpu, residents) in enumerate(nodes):
        alloc[f"n{i}"][CPU] = cpu * 1000
        alloc[f"n{i}"][MEM] = cpu << 31
        node_pods[f"n{i}"] = []
        for d in residents:
            node_pods[f"n{i}"].append(_pod(f"v{k}", d))
            k += 1
    pending = dict(_pod("pending", pod), priority=pod["priority"] + 2)
    quota_used = [0] * res.NUM_RESOURCES
    quota_used[CPU] = used * 1000
    quota_runtime = [1 << 60] * res.NUM_RESOURCES
    quota_runtime[CPU] = runtime * 1000
    pdb = {f"v{i}" for i in violators}
    args = (pending, alloc, node_pods, quota_used, quota_runtime)
    want = _victims(j_enforce.run_quota_preemption(*args, pdb_violators=pdb))
    got = _victims(t_enforce.run_quota_preemption(*args, pdb_violators=pdb))
    assert got == want
    for name in alloc:
        a = j_enforce.select_victims_on_node(pending, name, alloc[name], node_pods[name],
                                             quota_used, quota_runtime)
        b = t_enforce.select_victims_on_node(pending, name, alloc[name], node_pods[name],
                                             quota_used, quota_runtime)
        assert _victims(b) == _victims(a)


hint_st = st.lists(
    st.dictionaries(st.sampled_from(["cpu", "memory", "device"]),
                    st.lists(st.tuples(st.integers(1, 15), st.booleans()), max_size=4),
                    max_size=3),
    max_size=3)


@settings(max_examples=80, deadline=None)
@given(policy=st.sampled_from([p.value for p in j_topo.NUMATopologyPolicy]),
       numa=st.integers(1, 4), providers=hint_st)
def test_merge_hints_matches_the_reference(policy, numa, providers):
    nodes = list(range(numa))
    mask = (1 << numa) - 1

    def hints(mod):
        return [{k: [mod.NUMATopologyHint(a & mask or None, pref) for a, pref in v]
                 for k, v in p.items()} for p in providers]

    want = j_topo.merge_hints(j_topo.NUMATopologyPolicy(policy), nodes, hints(j_topo))
    got = t_topo.merge_hints(t_topo.NUMATopologyPolicy(policy), nodes, hints(t_topo))
    assert plain(got) == plain(want)


@pytest.mark.parametrize("seed", range(4))
def test_generate_cpu_hints_match(seed):
    rng = np.random.default_rng(seed)
    free = {z: int(rng.integers(0, 16)) for z in range(int(rng.integers(1, 5)))}
    for need in range(0, 40, 3):
        assert plain(t_topo.generate_cpu_hints(free, need)) == plain(
            j_topo.generate_cpu_hints(free, need))


def drive_gangs(mod, seed):
    """A seeded stream of PodGroup events through ``mod``'s manager and
    controller: (every call's return, gang states, phases)."""
    rng = np.random.default_rng(seed)
    mgr = mod.PodGroupManager(default_wait_time=30.0)
    ctl = mod.PodGroupController(mgr)
    names = [f"g{i}" for i in range(3)]
    for i, name in enumerate(names):
        mgr.on_pod_group_add({
            "name": name, "min_member": int(rng.integers(1, 4)),
            "total_num": int(rng.integers(3, 6)),
            "mode": mod.GANG_MODE_STRICT if rng.random() < 0.6 else mod.GANG_MODE_NONSTRICT,
            "match_policy": [mod.MATCH_ONLY_WAITING, mod.MATCH_WAITING_AND_RUNNING,
                             mod.MATCH_ONCE_SATISFIED][i % 3],
            "wait_time": float(rng.integers(5, 40)),
            "gang_group": names[:2] if i < 2 else [],
        })
    pods = {name: [f"{name}-p{k}" for k in range(4)] for name in names}
    log = []
    for step in range(60):
        now = float(step)
        g = names[int(rng.integers(0, 3))]
        pod = pods[g][int(rng.integers(0, 4))]
        op = int(rng.integers(0, 8))
        if op == 0:
            log.append(("add", plain(mgr.on_pod_add(g, pod).name)))
        elif op == 1:
            log.append(("pre_filter", mgr.pre_filter(g, pod)))
        elif op == 2:
            log.append(("permit", mgr.permit(g, pod, now)))
        elif op == 3:
            log.append(("unreserve", mgr.unreserve(g, pod)))
        elif op == 4:
            log.append(("reject", mgr.post_filter_reject(g, pod)))
        elif op == 5:
            log.append(("timeouts", mgr.check_timeouts(now)))
        elif op == 6:
            mgr.post_bind(g, pod)
            log.append(("bind", pod))
        else:
            phases = {p: ["Pending", "Running", "Succeeded", "Failed"][int(rng.integers(0, 4))]
                      for p in pods[g]}
            log.append(("sync", ctl.sync(g, phases)))
    return log, plain(mgr.gangs), dict(ctl.phases), dict(mgr.rejected_messages)


@pytest.mark.parametrize("seed", range(6))
def test_gang_event_streams_match(seed):
    assert drive_gangs(t_gang, seed) == drive_gangs(j_gang, seed)


def test_post_filter_dry_runs_share_a_victim_in_both_packages():
    """The PostFilter's dry runs do not see each other (ROADMAP Queue C):
    two pending pods of one quota, one node holding one lower-priority pod
    of that quota, and room for one preemptor only.  Each dry run runs
    against the same inventory, so both pods name the same victim on the
    same node, in both packages."""
    import types

    from koordinator_tpu.scheduler import framework as j_framework
    from koordinator_tpu_torch.scheduler import framework as t_framework

    cpu = {"cpu": "4000m", "memory": 4 << 30, "pods": 10}
    victim = {"name": "victim", "priority": 100, "quota": "q0",
              "requests": {"cpu": "3000m", "memory": 1 << 30, "pods": 1}}
    pending = [{"name": f"pending-{i}", "index": i, "priority": 1000, "quota": "q0",
                "requests": {"cpu": "3000m", "memory": 1 << 30, "pods": 1}}
               for i in range(2)]
    inventory = {
        "node_allocatable": {"node-0": res.resource_vector(cpu)},
        "node_pods": {"node-0": [victim]},
        "quota_runtime": {"q0": [1 << 40] * res.NUM_RESOURCES},
        "quota_used": {"q0": res.resource_vector(victim["requests"])},
        "pending_pods": pending,
    }
    import torch

    got = {}
    for name, fw, unplaced in (
            ("reference", j_framework, types.SimpleNamespace(assignment=np.array([-1, -1]))),
            ("port", t_framework, types.SimpleNamespace(assignment=torch.tensor([-1, -1])))):
        ctx = fw.CycleContext(snapshot=None, extras={"preemption": inventory})
        out = fw.FrameworkExtender().post_filter_preempt(ctx, unplaced)
        got[name] = {pod: (nv.node, [v["name"] for v in nv.victims]) for pod, nv in out.items()}
    want = {"pending-0": ("node-0", ["victim"]), "pending-1": ("node-0", ["victim"])}
    assert got["port"] == got["reference"] == want
