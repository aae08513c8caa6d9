"""Synthetic snapshot generators: the reference's recipes, seed for seed.

Counterpart of ``koordinator_tpu/harness/generators.py``.  Each recipe
returns ``(nodes, pods, gangs, quotas)`` plain-dict lists accepted by
``model.snapshot.encode_snapshot``, drawn from ``numpy.random.RandomState``
in the same order as the reference, so the same seed gives the same dicts.

1. ``spark_colocation``   — 3 nodes, spark-driver/executor + nginx pods.
2. ``loadaware_joint``    — 1k pods x 200 nodes, LoadAware + Fit.
3. ``gang_batch``         — 5k pods x 500 nodes, PodGroups minMember=8.
4. ``quota_colocation``   — 10k pods x 2k nodes, LS/BE mix + quota tree.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Mi = 1024 * 1024
Gi = 1024 * Mi


def _node(name: str, cpu_milli: int, mem: int, used_cpu: int, used_mem: int, pods_cap: int = 110) -> Dict:
    return {
        "name": name,
        "allocatable": {"cpu": f"{cpu_milli}m", "memory": mem, "pods": pods_cap},
        "requested": {},
        "usage": {"cpu": f"{used_cpu}m", "memory": used_mem},
        "metric_fresh": True,
    }


def spark_colocation(seed: int = 0) -> Tuple[List, List, List, List]:
    rng = np.random.RandomState(seed)
    nodes = [
        _node(f"kind-worker-{i}", 8000, 16 * Gi, int(rng.randint(500, 2000)), int(rng.randint(1, 4) * Gi))
        for i in range(3)
    ]
    pods: List[Dict] = []
    # one nginx LS deployment + spark driver/executors as koord-batch
    for i in range(6):
        pods.append(
            {
                "name": f"nginx-{i}",
                "requests": {"cpu": "500m", "memory": 512 * Mi, "pods": 1},
                "limits": {"cpu": "1", "memory": Gi},
                "qos": "LS",
                "priority_class": "koord-prod",
                "priority": 9500,
            }
        )
    pods.append(
        {
            "name": "spark-driver",
            "requests": {"cpu": "1", "memory": Gi, "pods": 1},
            "limits": {"cpu": "1", "memory": Gi},
            "qos": "BE",
            "priority_class": "koord-batch",
            "priority": 5500,
        }
    )
    for i in range(8):
        pods.append(
            {
                "name": f"spark-exec-{i}",
                "requests": {"cpu": "1", "memory": 2 * Gi, "pods": 1},
                "limits": {"cpu": "2", "memory": 2 * Gi},
                "qos": "BE",
                "priority_class": "koord-batch",
                "priority": 5400,
            }
        )
    return nodes, pods, [], []


def _random_nodes(rng, count: int, cpu_choices=(16000, 32000, 64000), mem_per_core=4 * Gi) -> List[Dict]:
    nodes = []
    for i in range(count):
        cpu = int(rng.choice(cpu_choices))
        mem = (cpu // 1000) * mem_per_core
        used_frac = rng.uniform(0.05, 0.55)
        nodes.append(
            _node(
                f"node-{i}",
                cpu,
                mem,
                int(cpu * used_frac),
                int(mem * rng.uniform(0.05, 0.6)),
                pods_cap=256,
            )
        )
    return nodes


def _random_pods(rng, count: int, name_prefix: str = "pod") -> List[Dict]:
    pods = []
    for i in range(count):
        cpu_m = int(rng.choice([250, 500, 1000, 2000, 4000]))
        mem = int(rng.choice([256, 512, 1024, 2048, 4096])) * Mi
        be = rng.uniform() < 0.4
        pods.append(
            {
                "name": f"{name_prefix}-{i}",
                "requests": {"cpu": f"{cpu_m}m", "memory": mem, "pods": 1},
                "limits": {"cpu": f"{cpu_m * 2}m", "memory": mem * 2},
                "qos": "BE" if be else "LS",
                "priority_class": "koord-batch" if be else "koord-prod",
                "priority": int(5000 + rng.randint(0, 999)) if be else int(9000 + rng.randint(0, 999)),
            }
        )
    return pods


def loadaware_joint(seed: int = 0, pods: int = 1000, nodes: int = 200):
    rng = np.random.RandomState(seed)
    return _random_nodes(rng, nodes), _random_pods(rng, pods), [], []


def gang_batch(seed: int = 0, pods: int = 5000, nodes: int = 500, min_member: int = 8):
    rng = np.random.RandomState(seed)
    node_list = _random_nodes(rng, nodes)
    pod_list = _random_pods(rng, pods, name_prefix="member")
    gangs = []
    n_gangs = pods // min_member
    for g in range(n_gangs):
        gangs.append({"name": f"gang-{g}", "min_member": min_member})
    for i, p in enumerate(pod_list):
        if i < n_gangs * min_member:
            p["gang"] = f"gang-{i // min_member}"
    return node_list, pod_list, gangs, []


def quota_colocation(seed: int = 0, pods: int = 10000, nodes: int = 2000, tenants: int = 16):
    """LS/BE multi-tenant mix with an elastic quota group per tenant.

    Quota ``min``/``max`` are chosen so the tree's fair division matters:
    total min ~60% of cluster CPU, max twice min.
    """
    rng = np.random.RandomState(seed)
    node_list = _random_nodes(rng, nodes)
    pod_list = _random_pods(rng, pods, name_prefix="tenant-pod")
    total_cpu = sum(int(n["allocatable"]["cpu"][:-1]) for n in node_list)
    total_mem = sum(int(n["allocatable"]["memory"]) for n in node_list)
    quotas = []
    for t in range(tenants):
        quotas.append(
            {
                "name": f"tenant-{t}",
                "min": {"cpu": f"{total_cpu * 6 // 10 // tenants}m", "memory": total_mem * 6 // 10 // tenants},
                "max": {"cpu": f"{total_cpu * 12 // 10 // tenants}m", "memory": total_mem * 12 // 10 // tenants},
                "shared_weight": int(rng.randint(1, 4)),
                "used": {},
            }
        )
    for i, p in enumerate(pod_list):
        p["quota"] = f"tenant-{i % tenants}"
    return node_list, pod_list, [], quotas


def with_usage_extensions(node_list: List[Dict], seed: int = 0) -> List[Dict]:
    """Copies of ``node_list`` that also report LoadAware's optional data:
    aggregated usage percentiles (some nodes none, some a subset), prod-pods
    usage, and a few expired NodeMetrics.  Not a reference recipe: it drives
    the aggregated and prod branches of the cycle with the same dicts in
    both packages."""
    rng = np.random.RandomState(seed)
    out = []
    for nd in node_list:
        nd = dict(nd)
        cpu = int(nd["allocatable"]["cpu"][:-1])
        mem = int(nd["allocatable"]["memory"])
        if rng.uniform() < 0.8:
            nd["agg_usage"] = {
                pct: {"cpu": f"{int(cpu * rng.uniform(0.05, 0.9))}m",
                      "memory": int(mem * rng.uniform(0.05, 0.9))}
                for pct in ("p50", "p90", "p95", "p99")
                if rng.uniform() < 0.8
            }
        nd["prod_usage"] = {"cpu": f"{int(cpu * rng.uniform(0.0, 0.8))}m",
                            "memory": int(mem * rng.uniform(0.0, 0.8))}
        nd["metric_fresh"] = bool(rng.uniform() < 0.9)
        out.append(nd)
    return out


CONFIGS = {
    "spark_colocation": spark_colocation,
    "loadaware_joint": loadaware_joint,
    "gang_batch": gang_batch,
    "quota_colocation": quota_colocation,
}


def quota_colocation_snapshot(
    seed: int = 0,
    pods: int = 10000,
    nodes: int = 2000,
    tenants: int = 16,
    node_bucket=None,
    pod_bucket=None,
    device=None,
):
    """The encoded quota_colocation snapshot, on ``device``: the headline
    cluster of the Assign cycle at its defaults (10k pods x 2k nodes).

    Returns (snapshot, node_list, pod_list, gangs, quotas, quota_dicts).
    """
    node_list, pod_list, gangs, quotas = quota_colocation(
        seed=seed, pods=pods, nodes=nodes, tenants=tenants
    )
    snap, qdicts = encode_quota_lists(
        node_list,
        pod_list,
        gangs,
        quotas,
        node_bucket=node_bucket or nodes,
        pod_bucket=pod_bucket or pods,
        device=device,
    )
    return snap, node_list, pod_list, gangs, quotas, qdicts


def encode_quota_lists(
    node_list, pod_list, gangs, quotas, node_bucket=None, pod_bucket=None,
    device=None,
):
    """Encode explicit node/pod/quota lists with the one quota-table recipe
    (quota ids by pod "quota" name, cluster totals from node allocatables,
    fair division by ``build_quota_table_inputs``).  Returns (snapshot,
    quota_dicts)."""
    from koordinator_tpu_torch.constraints import build_quota_table_inputs
    from koordinator_tpu_torch.model import encode_snapshot, resources as res

    pod_reqs = [res.resource_vector(p["requests"]) for p in pod_list]
    qidx = {q["name"]: i for i, q in enumerate(quotas)}
    qids = [qidx.get(p.get("quota"), -1) for p in pod_list]
    total = [0] * res.NUM_RESOURCES
    for n in node_list:
        v = res.resource_vector(n["allocatable"])
        total = [a + b for a, b in zip(total, v)]
    qdicts = build_quota_table_inputs(quotas, pod_reqs, qids, total)
    snap = encode_snapshot(
        node_list,
        pod_list,
        gangs,
        qdicts,
        node_bucket=node_bucket,
        pod_bucket=pod_bucket,
        device=device,
    )
    return snap, qdicts


# The term configuration's data (the reference's plugins measurement,
# ``bench.py --config plugins``): 4 workload classes, 3 accelerator types.
TERM_CLASSES = 4
TERM_ACCELS = 3


def term_tensors(pod_bucket: int, node_bucket: int, seed: int = 0):
    """numpy data of the fused scoring terms for a snapshot of these
    buckets, drawn as the reference's plugins measurement draws it:
    ``accel_type = arange(N) % 3``, ``workload_class = arange(P) % 4``,
    sensitivity columns cpu and memory uniform in [0, 100] (the rest 0) and
    a 4 x 3 throughput matrix uniform in [0, 100], from
    ``numpy.random.default_rng(seed)`` in that order."""
    from koordinator_tpu_torch.model import resources as res

    rng = np.random.default_rng(seed)
    sens = np.zeros((pod_bucket, res.NUM_RESOURCES), np.int64)
    sens[:, res.RESOURCE_INDEX[res.CPU]] = rng.integers(0, 101, pod_bucket)
    sens[:, res.RESOURCE_INDEX[res.MEMORY]] = rng.integers(0, 101, pod_bucket)
    return {
        "accel_type": (np.arange(node_bucket) % TERM_ACCELS).astype(np.int32),
        "workload_class": (np.arange(pod_bucket) % TERM_CLASSES).astype(np.int32),
        "sensitivity": sens,
        "throughput": rng.integers(0, 101, (TERM_CLASSES, TERM_ACCELS)).astype(np.int64),
    }


def with_term_tensors(snapshot, seed: int = 0):
    """``snapshot`` with the term data of :func:`term_tensors` on its
    device."""
    import dataclasses

    import torch

    t = term_tensors(snapshot.pods.capacity, snapshot.nodes.capacity, seed)
    dev = snapshot.device

    def on(name):
        return torch.from_numpy(t[name]).to(dev)

    return dataclasses.replace(
        snapshot,
        nodes=dataclasses.replace(snapshot.nodes, accel_type=on("accel_type")),
        pods=dataclasses.replace(
            snapshot.pods,
            workload_class=on("workload_class"),
            sensitivity=on("sensitivity"),
        ),
        throughput=on("throughput"),
    )


def sparse_leaves(nodes: int, pods: int, n_open: int, seed: int):
    """numpy leaves (``model.snapshot.snapshot_from_numpy``) of the sparse
    engine's narrow-feasibility cluster, as the reference's sparse
    measurement builds it: ``n_open`` nodes chosen by
    ``numpy.random.default_rng(seed)`` have room for the uniform 500m /
    512 MiB pods, every other node is requested to the brim, so each pod's
    exact feasible count is ``n_open``."""
    from koordinator_tpu_torch.model import resources as res

    R = res.NUM_RESOURCES
    cpu, mem, npods = (res.RESOURCE_INDEX[k] for k in (res.CPU, res.MEMORY, res.PODS))
    rng = np.random.default_rng(seed)
    nalloc = np.zeros((nodes, R), np.int64)
    nalloc[:, cpu] = 32_000
    nalloc[:, mem] = 128 * 1024
    nalloc[:, npods] = 256
    nreq = np.zeros((nodes, R), np.int64)
    nreq[:, cpu] = 31_800  # 200m free < the 500m ask
    nreq[rng.choice(nodes, size=n_open, replace=False), cpu] = 0
    nuse = (nalloc * 0.3).astype(np.int64)
    preq = np.zeros((pods, R), np.int64)
    preq[:, cpu], preq[:, mem], preq[:, npods] = 500, 512, 1
    return {
        "nodes": {"allocatable": nalloc, "requested": nreq, "usage": nuse,
                  "metric_fresh": np.ones(nodes, bool), "valid": np.ones(nodes, bool)},
        "pods": {"requests": preq, "estimated": preq.copy(),
                 "priority_class": np.zeros(pods, np.int32),
                 "qos": np.zeros(pods, np.int32),
                 "priority": np.full(pods, 5000, np.int32),
                 "gang_id": np.full(pods, -1, np.int32),
                 "quota_id": np.full(pods, -1, np.int32),
                 "valid": np.ones(pods, bool)},
        "gangs": {"min_member": np.zeros(1, np.int32), "valid": np.zeros(1, bool)},
        "quotas": {"runtime": np.zeros((1, R), np.int64),
                   "used": np.zeros((1, R), np.int64),
                   "limited": np.zeros((1, R), bool),
                   "valid": np.zeros(1, bool)},
    }
