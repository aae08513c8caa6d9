"""Golden SyncRequest encoder: generator output -> the seam's wire message.

Counterpart of ``koordinator_tpu/harness/golden.py``, on the port's codec
(``bridge/wire.py``): the same bytes a scheduler would ship over the Sync
RPC for a cluster of plain-dict nodes, pods, gangs and quotas.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.state import numpy_to_tensor
from koordinator_tpu_torch.constraints import build_quota_table_inputs
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import PERCENTILES, PriorityClass, estimate_pod


def _priority_class(p: Dict) -> PriorityClass:
    if p.get("priority_class") is not None:
        return PriorityClass.from_name(p["priority_class"])
    return PriorityClass.from_priority_value(p.get("priority"))


def estimate_pods(pods: List[Dict]) -> np.ndarray:
    """LoadAware estimator output per pod (the estimator runs host-side)."""
    return np.asarray(
        [
            estimate_pod(
                res.resource_vector(p["requests"]),
                res.resource_vector(p.get("limits", {})),
                _priority_class(p),
            )
            for p in pods
        ]
    )


def build_sync_request(
    nodes: List[Dict],
    pods: List[Dict],
    gangs: List[Dict],
    quotas: List[Dict],
    node_bucket: int = 0,
    pod_bucket: int = 0,
) -> Tuple["wire.SyncRequest", List[int]]:
    """Encode generator-style dict lists as a full SyncRequest.

    Returns (request, quota_id per pod).  Quota runtime fair division runs
    host-side (``constraints.build_quota_table_inputs``)."""
    pod_reqs = [res.resource_vector(p["requests"]) for p in pods]
    qidx = {q["name"]: i for i, q in enumerate(quotas)}
    qids = [qidx.get(p.get("quota"), -1) for p in pods]

    req = wire.SyncRequest(node_bucket=node_bucket, pod_bucket=pod_bucket)
    nalloc = np.asarray([res.resource_vector(n["allocatable"]) for n in nodes])
    nuse = np.asarray(
        [res.resource_vector(n.get("usage", {})) for n in nodes]
    )
    nreq = np.asarray(
        [res.resource_vector(n.get("requested", {})) for n in nodes]
    )
    req.nodes.allocatable.CopyFrom(numpy_to_tensor(nalloc))
    req.nodes.requested.CopyFrom(numpy_to_tensor(nreq))
    req.nodes.usage.CopyFrom(numpy_to_tensor(nuse))
    req.nodes.names.extend(n["name"] for n in nodes)
    req.nodes.metric_fresh.extend(
        bool(n.get("metric_fresh", True)) for n in nodes
    )
    if any("agg_usage" in n for n in nodes):
        agg = np.zeros((len(nodes), len(PERCENTILES), res.NUM_RESOURCES), np.int64)
        agg_fresh = np.zeros((len(nodes), len(PERCENTILES)), np.int64)
        for i, n in enumerate(nodes):
            for a, pct in enumerate(PERCENTILES):
                if pct in n.get("agg_usage", {}):
                    agg[i, a] = res.resource_vector(n["agg_usage"][pct])
                    agg_fresh[i, a] = 1
        req.nodes.agg_usage.CopyFrom(numpy_to_tensor(agg))
        req.nodes.agg_fresh.CopyFrom(numpy_to_tensor(agg_fresh))
    if any("prod_usage" in n for n in nodes):
        prod = np.asarray(
            [res.resource_vector(n.get("prod_usage", {})) for n in nodes]
        )
        req.nodes.prod_usage.CopyFrom(numpy_to_tensor(prod))

    req.pods.requests.CopyFrom(numpy_to_tensor(np.asarray(pod_reqs)))
    req.pods.estimated.CopyFrom(numpy_to_tensor(estimate_pods(pods)))
    req.pods.names.extend(p["name"] for p in pods)
    req.pods.priority.extend(int(p.get("priority", 0)) for p in pods)
    req.pods.priority_class.extend(int(_priority_class(p)) for p in pods)
    gidx = {g["name"]: i for i, g in enumerate(gangs)}
    req.pods.gang_id.extend(gidx.get(p.get("gang"), -1) for p in pods)
    req.pods.quota_id.extend(int(q) for q in qids)
    req.gangs.min_member.extend(int(g["min_member"]) for g in gangs)

    if quotas:
        total = [0] * res.NUM_RESOURCES
        for n in nodes:
            v = res.resource_vector(n["allocatable"])
            total = [a + b for a, b in zip(total, v)]
        qdicts = build_quota_table_inputs(quotas, pod_reqs, qids, total)
        qrt = np.asarray(
            [res.resource_vector(q["runtime"]) for q in qdicts]
        )
        quse = np.asarray(
            [res.resource_vector(q.get("used", {})) for q in qdicts]
        )
        qlim = np.asarray(
            [
                [
                    1 if res.RESOURCE_AXIS[r] in q["runtime"] else 0
                    for r in range(res.NUM_RESOURCES)
                ]
                for q in qdicts
            ],
            np.int64,
        )
        req.quotas.runtime.CopyFrom(numpy_to_tensor(qrt))
        req.quotas.used.CopyFrom(numpy_to_tensor(quse))
        req.quotas.limited.CopyFrom(numpy_to_tensor(qlim))
    return req, qids


def write_golden(path: str, *args, **kwargs) -> "wire.SyncRequest":
    """Write ``build_sync_request(*args, **kwargs)``'s request to ``path``
    as its wire bytes, and return it."""
    req, _ = build_sync_request(*args, **kwargs)
    with open(path, "wb") as f:
        f.write(req.SerializeToString())
    return req
