"""Batch / Mid overcommit calculation (the noderesource controller).

The port's own copy of ``koordinator_tpu/manager/noderesource.py``.

Reference: ``pkg/slo-controller/noderesource`` — BatchResource plugin
(``plugins/batchresource/plugin.go:136 Calculate``, formula helpers
``util.go:38-70``), MidResource plugin (``plugins/midresource/plugin.go``),
degrade-on-stale-metric (``batchresource/plugin.go:370-388``), and the
sync-needed diff check (``util.IsResourceDiff``).

The math runs on dense ``[cpu_milli, memory_mib]`` numpy vectors —
exact integer arithmetic, matching the reference's resource.Quantity
accounting.  For whole-cluster reconciliation, ``batch_allocatable_batch``
computes every node at once as one vectorized numpy program over ``[N, 2]``
arrays, the same formula as the per-node ``calculate_batch_resource``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.manager.sloconfig import (
    CALCULATE_BY_POD_REQUEST,
    ColocationStrategy,
)
from koordinator_tpu_torch.model import resources as res

# dense axis for this module: [cpu (milli), memory (MiB)]
CPU, MEM = 0, 1

PRIORITY_PROD = "koord-prod"
PRIORITY_MID = "koord-mid"
PRIORITY_BATCH = "koord-batch"
PRIORITY_FREE = "koord-free"

# Priority value bands (reference apis/extension/priority.go:38-49).
PRIORITY_BANDS = {
    PRIORITY_PROD: (9000, 9999),
    PRIORITY_MID: (7000, 7999),
    PRIORITY_BATCH: (5000, 5999),
    PRIORITY_FREE: (3000, 3999),
}


def priority_class_of(pod: Mapping) -> str:
    """reference ``extension.GetPodPriorityClassWithDefault``: explicit
    priority-class label wins, else derive from the numeric priority band,
    else prod (HP) by default."""
    pc = pod.get("priority_class", "")
    if pc in PRIORITY_BANDS:
        return pc
    prio = pod.get("priority")
    if prio is not None:
        for name, (lo, hi) in PRIORITY_BANDS.items():
            if lo <= int(prio) <= hi:
                return name
    return PRIORITY_PROD


def _vec(rl: Optional[Mapping[str, object]]) -> np.ndarray:
    """[cpu_milli, mem_mib] int64 vector from a resource dict."""
    out = np.zeros(2, dtype=np.int64)
    if rl:
        v = res.resource_vector(rl)
        out[CPU] = v[res.RESOURCE_INDEX[res.CPU]]
        out[MEM] = v[res.RESOURCE_INDEX[res.MEMORY]]
    return out


@dataclasses.dataclass
class BatchResourceResult:
    batch_cpu_milli: int
    batch_memory_mib: int
    degraded: bool
    message: str

    def as_extended_resources(self) -> Dict[str, int]:
        if self.degraded:
            return {}
        return {
            res.BATCH_CPU: self.batch_cpu_milli,
            res.BATCH_MEMORY: res.format_quantity(
                self.batch_memory_mib, res.BATCH_MEMORY
            ),
        }


def is_degrade_needed(
    strategy: ColocationStrategy,
    metric_update_time: Optional[float],
    now: float,
) -> bool:
    """reference ``batchresource/plugin.go:370 isDegradeNeeded``: nil or
    stale (> DegradeTimeMinutes) NodeMetric freezes the batch resources."""
    if metric_update_time is None:
        return True
    return now > metric_update_time + strategy.degrade_time_minutes * 60.0


def calculate_batch_resource(
    strategy: ColocationStrategy,
    node_capacity: Mapping[str, object],
    node_annotation_reserved: Optional[Mapping[str, object]],
    kubelet_reserved: Optional[Mapping[str, object]],
    system_usage: Mapping[str, object],
    pods: Sequence[Mapping],
    pod_metrics: Mapping[str, Mapping[str, object]],
    metric_update_time: Optional[float] = None,
    now: float = 0.0,
    cpu_normalization_ratio: float = -1.0,
) -> BatchResourceResult:
    """One node's batch-allocatable.

    Formula (reference ``util.go:38-49``)::

        System.Used        = max(system_usage, System.Reserved)
        System.Reserved    = max(node_anno_reserved, kubelet_reserved)
        byUsage   = max(0, capacity - nodeReservation - System.Used - podHPUsed)
        byRequest = max(0, capacity - nodeReservation - System.Reserved - podHPRequest)

    CPU always uses byUsage; memory uses byRequest when the strategy's
    ``memory_calculate_policy`` is ``request`` (``util.go:57``).  HP pods
    are all running/pending pods not in the batch/free bands
    (``plugin.go:184-198``); pods reported in metrics but absent from the
    pod list count into HP used (``plugin.go:201-203``).
    """
    if is_degrade_needed(strategy, metric_update_time, now):
        return BatchResourceResult(0, 0, True, "degradedByBatchResource: stale or missing NodeMetric")

    cap = _vec(node_capacity)
    sys_reserved = np.maximum(_vec(node_annotation_reserved), _vec(kubelet_reserved))
    sys_used = np.maximum(_vec(system_usage), sys_reserved)

    hp_request = np.zeros(2, dtype=np.int64)
    hp_used = np.zeros(2, dtype=np.int64)
    known_used = np.zeros(2, dtype=np.int64)
    all_used = np.zeros(2, dtype=np.int64)
    for key, m in pod_metrics.items():
        all_used += _vec(m)

    for pod in pods:
        phase = pod.get("phase", "Running")
        if phase not in ("Running", "Pending"):
            continue
        key = pod.get("name", "")
        metric = pod_metrics.get(key)
        if metric is not None:
            known_used += _vec(metric)
        if priority_class_of(pod) in (PRIORITY_BATCH, PRIORITY_FREE):
            continue  # ignore LP pods
        preq = _vec(pod.get("requests"))
        hp_request += preq
        if metric is None:
            hp_used += preq
        elif pod.get("qos") == "LSE":
            # LSE pods do not reclaim CPU: request for cpu, usage for memory
            # (reference plugin.go:193-195).
            mu = _vec(metric)
            hp_used += np.array([preq[CPU], mu[MEM]], dtype=np.int64)
        else:
            hp_used += _vec(metric)

    # pods with metrics but not in the list: unknown priority -> HP used
    hp_used += all_used - known_used

    node_reservation = _node_reservation(strategy, cap)

    by_usage = np.maximum(cap - node_reservation - sys_used - hp_used, 0)
    by_request = np.maximum(cap - node_reservation - sys_reserved - hp_request, 0)

    batch = by_usage.copy()
    if strategy.memory_calculate_policy == CALCULATE_BY_POD_REQUEST:
        batch[MEM] = by_request[MEM]

    batch_cpu = int(batch[CPU])
    # amplify batch cpu by the cpu-normalization ratio (util.go:80-91)
    if cpu_normalization_ratio > 1.0:
        batch_cpu = int(batch_cpu * cpu_normalization_ratio)

    msg = (
        f"batchAllocatable[CPU(Milli-Core)]:{batch_cpu} = nodeCapacity:{cap[CPU]}"
        f" - nodeReservation:{node_reservation[CPU]} - systemUsageOrReserved:{sys_used[CPU]}"
        f" - podHPUsed:{hp_used[CPU]}"
    )
    return BatchResourceResult(batch_cpu, int(batch[MEM]), False, msg)


def _node_reservation(strategy: ColocationStrategy, cap: np.ndarray) -> np.ndarray:
    """reference ``util.go:178-186 getNodeReservation``: reserve
    (100 - reclaimPercent)% of allocatable."""
    cpu = cap[CPU] * (100 - strategy.cpu_reclaim_threshold_percent) // 100
    mem = cap[MEM] * (100 - strategy.memory_reclaim_threshold_percent) // 100
    return np.array([cpu, mem], dtype=np.int64)


def calculate_mid_resource(
    strategy: ColocationStrategy,
    node_allocatable: Mapping[str, object],
    prod_reclaimable: Optional[Mapping[str, object]],
    metric_update_time: Optional[float] = None,
    now: float = 0.0,
) -> BatchResourceResult:
    """Mid-tier resources: ``min(ProdReclaimable, allocatable * midThresholdRatio)``
    (reference ``midresource/plugin.go:84-120``; degrade when the prod
    reclaimable metric is absent or stale)."""
    if prod_reclaimable is None or is_degrade_needed(strategy, metric_update_time, now):
        return BatchResourceResult(0, 0, True, "degradedByMidResource: stale or missing ProdReclaimable")
    alloc = _vec(node_allocatable)
    reclaimable = _vec(prod_reclaimable)
    cap = np.array(
        [
            alloc[CPU] * strategy.mid_cpu_threshold_percent // 100,
            alloc[MEM] * strategy.mid_memory_threshold_percent // 100,
        ],
        dtype=np.int64,
    )
    mid = np.minimum(reclaimable, cap)
    result = BatchResourceResult(int(mid[CPU]), int(mid[MEM]), False, "midAllocatable=min(prodReclaimable, allocatable*ratio)")
    return result


def need_sync(
    strategy: ColocationStrategy,
    old_allocatable: Mapping[str, int],
    new_allocatable: Mapping[str, int],
    resource_names: Sequence[str] = (res.BATCH_CPU, res.BATCH_MEMORY),
) -> bool:
    """reference ``util.IsResourceDiff`` used by ``NeedSync``
    (``batchresource/plugin.go`` / ``midresource/plugin.go:50``): resync when
    any tracked resource moved by more than ResourceDiffThreshold
    (relative to the old value; new-vs-missing counts as diff)."""
    for name in resource_names:
        old = old_allocatable.get(name)
        new = new_allocatable.get(name)
        if (old is None) != (new is None):
            return True
        if old is None or new is None:
            continue
        old = res.parse_quantity(old, name)
        new = res.parse_quantity(new, name)
        if old == 0:
            if new != 0:
                return True
            continue
        if abs(new - old) / abs(old) > strategy.resource_diff_threshold:
            return True
    return False


def batch_allocatable_batch(
    strategy: ColocationStrategy,
    capacity: np.ndarray,          # [N, 2] int64
    sys_reserved: np.ndarray,      # [N, 2]
    sys_usage: np.ndarray,         # [N, 2]
    hp_request: np.ndarray,        # [N, 2]
    hp_used: np.ndarray,           # [N, 2]
) -> np.ndarray:
    """Vectorized whole-cluster batch-allocatable: same formula as
    ``calculate_batch_resource`` evaluated for all N nodes at once (one
    program per cluster sweep rather than the reference's per-node
    Reconcile)."""
    reclaim = np.array(
        [100 - strategy.cpu_reclaim_threshold_percent, 100 - strategy.memory_reclaim_threshold_percent],
        dtype=np.int64,
    )
    node_reservation = capacity * reclaim // 100
    sys_used = np.maximum(sys_usage, sys_reserved)
    by_usage = np.maximum(capacity - node_reservation - sys_used - hp_used, 0)
    by_request = np.maximum(capacity - node_reservation - sys_reserved - hp_request, 0)
    out = by_usage
    if strategy.memory_calculate_policy == CALCULATE_BY_POD_REQUEST:
        out = np.stack([by_usage[:, CPU], by_request[:, MEM]], axis=1)
    return out
