"""Fixed-shape cluster snapshot as torch tensors.

The port's counterpart of ``koordinator_tpu/model/snapshot.py``: the same
dense, padded int64 encoding of a scheduling cycle's world state (nodes,
pending pods, gangs, quota groups), held in frozen dataclasses of torch
tensors on an explicit device.  ``encode_snapshot`` reads the same plain-dict
lists as the reference encoder and produces the same values leaf for leaf;
``snapshot_from_numpy`` carries a reference snapshot's leaves across as numpy
arrays.

Estimator semantics (``estimated``) follow the reference's defaultEstimator
(``pkg/scheduler/plugins/loadaware/estimator/default_estimator.go:81-127``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.model import resources as res

MAX_NODE_SCORE = 100  # k8s framework.MaxNodeScore

DEFAULT_MILLI_CPU_REQUEST = 250  # default_estimator.go:36
DEFAULT_MEMORY_REQUEST = 200  # default_estimator.go:38: 200Mi, on the MiB axis

# v1beta2/defaults.go:35-48
DEFAULT_RESOURCE_WEIGHTS = {res.CPU: 1, res.MEMORY: 1}
DEFAULT_USAGE_THRESHOLDS = {res.CPU: 65, res.MEMORY: 95}
DEFAULT_ESTIMATED_SCALING_FACTORS = {res.CPU: 85, res.MEMORY: 70}
DEFAULT_NODE_METRIC_EXPIRATION_SECONDS = 180

# NodeMetric aggregated-usage percentiles carried by NodeBatch.agg_usage
PERCENTILES = ("p50", "p90", "p95", "p99")


class PriorityClass(enum.IntEnum):
    """Koordinator priority bands (reference apis/extension/priority.go:29)."""

    PROD = 0
    MID = 1
    BATCH = 2
    FREE = 3
    NONE = 4

    @classmethod
    def from_name(cls, name: Optional[str]) -> "PriorityClass":
        return {
            "koord-prod": cls.PROD,
            "koord-mid": cls.MID,
            "koord-batch": cls.BATCH,
            "koord-free": cls.FREE,
        }.get(name or "", cls.NONE)

    @classmethod
    def from_priority_value(cls, priority: Optional[int]) -> "PriorityClass":
        # reference apis/extension/priority.go:84-101
        if priority is None:
            return cls.NONE
        if 9000 <= priority <= 9999:
            return cls.PROD
        if 7000 <= priority <= 7999:
            return cls.MID
        if 5000 <= priority <= 5999:
            return cls.BATCH
        if 3000 <= priority <= 3999:
            return cls.FREE
        return cls.NONE


class QoSClass(enum.IntEnum):
    """Koordinator QoS classes (reference apis/extension/qos.go:22-28)."""

    LSE = 0
    LSR = 1
    LS = 2
    BE = 3
    SYSTEM = 4
    NONE = 5

    @classmethod
    def from_name(cls, name: Optional[str]) -> "QoSClass":
        return {
            "LSE": cls.LSE,
            "LSR": cls.LSR,
            "LS": cls.LS,
            "BE": cls.BE,
            "SYSTEM": cls.SYSTEM,
        }.get(name or "", cls.NONE)


# PriorityClass -> {native resource index -> translated resource index},
# reference apis/extension/resource.go:40-49.
_RESOURCE_TRANSLATION = {
    PriorityClass.BATCH: {
        res.RESOURCE_INDEX[res.CPU]: res.RESOURCE_INDEX[res.BATCH_CPU],
        res.RESOURCE_INDEX[res.MEMORY]: res.RESOURCE_INDEX[res.BATCH_MEMORY],
    },
    PriorityClass.MID: {
        res.RESOURCE_INDEX[res.CPU]: res.RESOURCE_INDEX[res.MID_CPU],
        res.RESOURCE_INDEX[res.MEMORY]: res.RESOURCE_INDEX[res.MID_MEMORY],
    },
}


def translate_resource_index(priority_class: PriorityClass, idx: int) -> int:
    """reference apis/extension/resource.go:53 TranslateResourceNameByPriorityClass."""
    if priority_class in (PriorityClass.PROD, PriorityClass.NONE):
        return idx
    return _RESOURCE_TRANSLATION.get(priority_class, {}).get(idx, idx)


def tensors_to(table, device):
    """``table`` (a frozen dataclass) with every tensor field moved to
    ``device``; other fields are kept."""
    dev = torch.device(device)
    return dataclasses.replace(table, **{
        f.name: getattr(table, f.name).to(dev)
        for f in dataclasses.fields(table)
        if isinstance(getattr(table, f.name), torch.Tensor)
    })


def pad_bucket(n: int, minimum: int = 8) -> int:
    """Smallest power-of-two bucket >= n (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class NodeBatch:
    """Dense node-side state, shapes [N] / [N, R]."""

    allocatable: torch.Tensor  # i64[N, R]
    requested: torch.Tensor  # i64[N, R] sum of scheduled pod requests
    usage: torch.Tensor  # i64[N, R] measured usage from NodeMetric
    metric_fresh: torch.Tensor  # bool[N]
    valid: torch.Tensor  # bool[N] padding mask
    agg_usage: Optional[torch.Tensor] = None  # i64[N, A, R], axis PERCENTILES
    agg_fresh: Optional[torch.Tensor] = None  # bool[N, A]
    prod_usage: Optional[torch.Tensor] = None  # i64[N, R]
    accel_type: Optional[torch.Tensor] = None  # i32[N]
    names: Tuple[str, ...] = ()

    @property
    def capacity(self) -> int:
        return self.allocatable.shape[0]


@dataclasses.dataclass(frozen=True)
class PodBatch:
    """Dense pending-pod state, shapes [P] / [P, R]."""

    requests: torch.Tensor  # i64[P, R]
    estimated: torch.Tensor  # i64[P, R] LoadAware estimator output
    priority_class: torch.Tensor  # i32[P] PriorityClass enum
    qos: torch.Tensor  # i32[P] QoSClass enum
    priority: torch.Tensor  # i32[P] raw pod priority (queue order)
    gang_id: torch.Tensor  # i32[P], -1 = no gang
    quota_id: torch.Tensor  # i32[P], -1 = no quota
    valid: torch.Tensor  # bool[P] padding mask
    workload_class: Optional[torch.Tensor] = None  # i32[P]
    sensitivity: Optional[torch.Tensor] = None  # i64[P, R]
    names: Tuple[str, ...] = ()

    @property
    def capacity(self) -> int:
        return self.requests.shape[0]


@dataclasses.dataclass(frozen=True)
class GangTable:
    """Coscheduling PodGroups (reference plugins/coscheduling/core/core.go:220)."""

    min_member: torch.Tensor  # i32[G]
    valid: torch.Tensor  # bool[G]
    names: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class QuotaTable:
    """Flattened ElasticQuota groups after host-side runtime fair division."""

    runtime: torch.Tensor  # i64[Q, R]
    used: torch.Tensor  # i64[Q, R]
    limited: torch.Tensor  # bool[Q, R] quota declares this dimension
    valid: torch.Tensor  # bool[Q]
    names: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ClusterSnapshot:
    nodes: NodeBatch
    pods: PodBatch
    gangs: GangTable
    quotas: QuotaTable
    throughput: Optional[torch.Tensor] = None  # i64[C, A]

    @property
    def device(self) -> torch.device:
        return self.nodes.allocatable.device

    @property
    def num_nodes(self) -> int:
        return int(self.nodes.valid.sum())

    @property
    def num_pods(self) -> int:
        return int(self.pods.valid.sum())


# Tensor fields of each table, in the reference's pytree order.
SNAPSHOT_FIELDS = {
    "nodes": (NodeBatch, ("allocatable", "requested", "usage", "metric_fresh",
                          "valid", "agg_usage", "agg_fresh", "prod_usage",
                          "accel_type")),
    "pods": (PodBatch, ("requests", "estimated", "priority_class", "qos",
                        "priority", "gang_id", "quota_id", "valid",
                        "workload_class", "sensitivity")),
    "gangs": (GangTable, ("min_member", "valid")),
    "quotas": (QuotaTable, ("runtime", "used", "limited", "valid")),
}


def snapshot_from_numpy(leaves: Mapping, device=None) -> ClusterSnapshot:
    """Build a snapshot from numpy leaves, e.g. a reference snapshot's.

    ``leaves`` maps each table name of ``SNAPSHOT_FIELDS`` to a mapping of
    field -> numpy array (or None for an absent optional field), and may
    carry ``"names"`` per table and a top-level ``"throughput"``.  Every
    array is copied as is: dtypes and values are kept.
    """
    dev = resolve_device(device)

    def conv(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(dev)

    tables = {}
    for table, (cls, fields) in SNAPSHOT_FIELDS.items():
        src = leaves[table]
        kwargs = {f: conv(src.get(f)) for f in fields}
        kwargs["names"] = tuple(src.get("names", ()))
        tables[table] = cls(**kwargs)
    return ClusterSnapshot(throughput=conv(leaves.get("throughput")), **tables)


# ---------------------------------------------------------------------------
# Host-side estimator (exact integer parity with default_estimator.go)
# ---------------------------------------------------------------------------


def _estimated_used_by_resource(
    request: int, limit: int, default_value: int, scaling_factor: int
) -> int:
    """default_estimator.go:81-127 estimatedUsedByResource, one resource."""
    if limit > request:
        scaling_factor = 100
        quantity = limit
    else:
        quantity = request
    if quantity == 0:
        return default_value
    # Go: int64(math.Round(float64(q) * float64(factor) / 100)); math.Round
    # rounds half away from zero (quantities are non-negative here), unlike
    # Python's banker's round().
    estimated = int(math.floor(quantity * scaling_factor / 100 + 0.5))
    if limit > 0 and estimated > limit:
        estimated = limit
    return estimated


def estimate_pod(
    requests_vec: Sequence[int],
    limits_vec: Sequence[int],
    priority_class: PriorityClass,
    resource_weights: Mapping[str, int] = DEFAULT_RESOURCE_WEIGHTS,
    scaling_factors: Mapping[str, int] = DEFAULT_ESTIMATED_SCALING_FACTORS,
) -> List[int]:
    """defaultEstimator.EstimatePod (default_estimator.go:58-73), dense form.

    Returns estimated used in the *weighted* (native) resource slots; the
    lookup reads the priority-translated slot of requests/limits.
    """
    out = [0] * res.NUM_RESOURCES
    for name, _w in resource_weights.items():
        idx = res.RESOURCE_INDEX[name]
        real_idx = translate_resource_index(priority_class, idx)
        if res.RESOURCE_AXIS[real_idx] in (res.CPU, res.BATCH_CPU):
            default_value = DEFAULT_MILLI_CPU_REQUEST
        elif res.RESOURCE_AXIS[real_idx] in (res.MEMORY, res.BATCH_MEMORY):
            default_value = DEFAULT_MEMORY_REQUEST
        else:
            default_value = 0
        out[idx] = _estimated_used_by_resource(
            requests_vec[real_idx],
            limits_vec[real_idx],
            default_value,
            # a weighted resource with no scaling-factor entry estimates 0
            # (Go map zero-value in estimatedPodUsed, default_estimator.go:67)
            int(scaling_factors.get(name, 0)),
        )
    return out


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode_snapshot(
    nodes: Sequence[Mapping],
    pods: Sequence[Mapping],
    gangs: Sequence[Mapping] = (),
    quotas: Sequence[Mapping] = (),
    *,
    resource_weights: Mapping[str, int] = DEFAULT_RESOURCE_WEIGHTS,
    scaling_factors: Mapping[str, int] = DEFAULT_ESTIMATED_SCALING_FACTORS,
    node_bucket: Optional[int] = None,
    pod_bucket: Optional[int] = None,
    throughput: Optional[Sequence[Sequence[int]]] = None,
    device=None,
) -> ClusterSnapshot:
    """Encode plain-dict cluster state into a padded ClusterSnapshot.

    Reads the same dicts as the reference encoder (node ``allocatable`` /
    ``requested`` / ``usage`` / ``metric_fresh`` / ``agg_usage`` /
    ``prod_usage`` / ``accel_type``; pod ``requests`` / ``limits`` /
    ``priority_class`` / ``priority`` / ``qos`` / ``gang`` / ``quota`` /
    ``workload_class`` / ``sensitivity``; gang ``min_member``; quota
    ``runtime`` / ``used`` / ``limited``) and builds the arrays on the host
    in numpy before one copy to ``device``.
    """
    dev = resolve_device(device)
    n_bucket = node_bucket or pad_bucket(len(nodes))
    p_bucket = pod_bucket or pad_bucket(len(pods))
    g_bucket = pad_bucket(max(len(gangs), 1))
    q_bucket = pad_bucket(max(len(quotas), 1))
    R = res.NUM_RESOURCES

    gang_index = {g["name"]: i for i, g in enumerate(gangs)}
    quota_index = {q["name"]: i for i, q in enumerate(quotas)}

    node_alloc = np.zeros((n_bucket, R), np.int64)
    node_req = np.zeros((n_bucket, R), np.int64)
    node_usage = np.zeros((n_bucket, R), np.int64)
    node_fresh = np.zeros((n_bucket,), bool)
    node_valid = np.zeros((n_bucket,), bool)
    n_pct = len(PERCENTILES)
    node_agg = np.zeros((n_bucket, n_pct, R), np.int64)
    node_agg_fresh = np.zeros((n_bucket, n_pct), bool)
    node_prod = np.zeros((n_bucket, R), np.int64)
    node_accel = np.zeros((n_bucket,), np.int32)
    any_accel = any("accel_type" in nd for nd in nodes)
    for i, nd in enumerate(nodes):
        node_alloc[i] = res.resource_vector(nd.get("allocatable", {}))
        node_req[i] = res.resource_vector(nd.get("requested", {}))
        node_usage[i] = res.resource_vector(nd.get("usage", {}))
        node_fresh[i] = bool(nd.get("metric_fresh", True))
        node_valid[i] = True
        agg = nd.get("agg_usage")
        if agg:
            for a, pct in enumerate(PERCENTILES):
                if pct in agg:
                    node_agg[i, a] = res.resource_vector(agg[pct])
                    node_agg_fresh[i, a] = True
        if nd.get("prod_usage") is not None:
            node_prod[i] = res.resource_vector(nd["prod_usage"])
        if nd.get("accel_type") is not None:
            node_accel[i] = int(nd["accel_type"])

    pod_req = np.zeros((p_bucket, R), np.int64)
    pod_est = np.zeros((p_bucket, R), np.int64)
    pod_prio_class = np.full((p_bucket,), int(PriorityClass.NONE), np.int32)
    pod_qos = np.full((p_bucket,), int(QoSClass.NONE), np.int32)
    pod_prio = np.zeros((p_bucket,), np.int32)
    pod_gang = np.full((p_bucket,), -1, np.int32)
    pod_quota = np.full((p_bucket,), -1, np.int32)
    pod_valid = np.zeros((p_bucket,), bool)
    pod_wclass = np.zeros((p_bucket,), np.int32)
    pod_sens = np.zeros((p_bucket, R), np.int64)
    any_wclass = any("workload_class" in pd for pd in pods)
    any_sens = any("sensitivity" in pd for pd in pods)
    for i, pd in enumerate(pods):
        req_vec = res.resource_vector(pd.get("requests", {}))
        lim_vec = res.resource_vector(pd.get("limits", {}))
        pc = pd.get("priority_class")
        if pc is not None:
            prio_class = PriorityClass.from_name(pc)
        else:
            prio_class = PriorityClass.from_priority_value(pd.get("priority"))
        pod_req[i] = req_vec
        pod_est[i] = estimate_pod(
            req_vec, lim_vec, prio_class, resource_weights, scaling_factors
        )
        pod_prio_class[i] = int(prio_class)
        pod_qos[i] = int(QoSClass.from_name(pd.get("qos")))
        pod_prio[i] = int(pd.get("priority") or 0)
        # unknown gang/quota names degrade to "no gang"/"no quota"
        if pd.get("gang") is not None:
            pod_gang[i] = gang_index.get(pd["gang"], -1)
        if pd.get("quota") is not None:
            pod_quota[i] = quota_index.get(pd["quota"], -1)
        if pd.get("workload_class") is not None:
            pod_wclass[i] = int(pd["workload_class"])
        if pd.get("sensitivity") is not None:
            pod_sens[i] = res.resource_vector(pd["sensitivity"])
        pod_valid[i] = True

    gang_min = np.zeros((g_bucket,), np.int32)
    gang_valid = np.zeros((g_bucket,), bool)
    for i, g in enumerate(gangs):
        gang_min[i] = int(g.get("min_member", 0))
        gang_valid[i] = True

    quota_runtime = np.zeros((q_bucket, R), np.int64)
    quota_used = np.zeros((q_bucket, R), np.int64)
    quota_limited = np.zeros((q_bucket, R), bool)
    quota_valid = np.zeros((q_bucket,), bool)
    for i, q in enumerate(quotas):
        quota_runtime[i] = res.resource_vector(q.get("runtime", {}))
        quota_used[i] = res.resource_vector(q.get("used", {}))
        # a quota constrains only the dimensions it declares; a declared
        # zero-runtime dimension still rejects (elasticquota PreFilter)
        for name in q.get("limited", q.get("runtime", {})):
            idx = res.RESOURCE_INDEX.get(name)
            if idx is not None:
                quota_limited[i, idx] = True
        quota_valid[i] = True

    def t(a):
        return torch.from_numpy(a).to(dev)

    return ClusterSnapshot(
        nodes=NodeBatch(
            allocatable=t(node_alloc),
            requested=t(node_req),
            usage=t(node_usage),
            metric_fresh=t(node_fresh),
            valid=t(node_valid),
            agg_usage=t(node_agg),
            agg_fresh=t(node_agg_fresh),
            prod_usage=t(node_prod),
            accel_type=t(node_accel) if any_accel else None,
            names=tuple(nd.get("name", f"node-{i}") for i, nd in enumerate(nodes)),
        ),
        pods=PodBatch(
            requests=t(pod_req),
            estimated=t(pod_est),
            priority_class=t(pod_prio_class),
            qos=t(pod_qos),
            priority=t(pod_prio),
            gang_id=t(pod_gang),
            quota_id=t(pod_quota),
            valid=t(pod_valid),
            workload_class=t(pod_wclass) if any_wclass else None,
            sensitivity=t(pod_sens) if any_sens else None,
            names=tuple(pd.get("name", f"pod-{i}") for i, pd in enumerate(pods)),
        ),
        gangs=GangTable(
            min_member=t(gang_min),
            valid=t(gang_valid),
            names=tuple(g["name"] for g in gangs),
        ),
        quotas=QuotaTable(
            runtime=t(quota_runtime),
            used=t(quota_used),
            limited=t(quota_limited),
            valid=t(quota_valid),
            names=tuple(q["name"] for q in quotas),
        ),
        throughput=(
            t(np.asarray(throughput, np.int64)) if throughput is not None else None
        ),
    )
