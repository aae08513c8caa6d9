"""LowNodeLoad Balance: utilization classification + eviction planning.

A host-only copy of ``koordinator_tpu/descheduler/lownodeload.py``
(reference ``pkg/descheduler/framework/plugins/loadaware/low_node_load.go``:
``Balance`` :135, ``processOneNodePool`` :154, ``newThresholds`` :287;
``utilization_util.go``: ``getNodeThresholds``,
``evictPodsFromSourceNodes``).  The classification is a thresholded
reduction over a dense ``[N, R]`` usage/capacity array in numpy
(``classify``), run on the host inside the controller loop.

A node is *underutilized* when usage is under the low threshold for every
tracked resource, *overutilized* when over the high threshold for any one
(reference ``isNodeUnderutilized`` / ``isNodeOverutilized``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.descheduler.anomaly import BasicDetector, State
from koordinator_tpu_torch.descheduler.evictions import PodEvictor
from koordinator_tpu_torch.descheduler.sorter import sort_pods_for_eviction
from koordinator_tpu_torch.model import resources as res

MIN_RESOURCE_PERCENTAGE = 0.0
MAX_RESOURCE_PERCENTAGE = 100.0


@dataclasses.dataclass
class NodePool:
    """reference config.LowNodeLoadNodePool."""

    name: str = "default"
    node_selector: Optional[Mapping[str, str]] = None
    low_thresholds: Mapping[str, float] = dataclasses.field(default_factory=dict)
    high_thresholds: Mapping[str, float] = dataclasses.field(default_factory=dict)
    use_deviation_thresholds: bool = False
    resource_weights: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {res.CPU: 1, res.MEMORY: 1}
    )
    # anomaly debounce: evict only after this many consecutive overloaded
    # observations (reference LoadAnomalyCondition)
    consecutive_abnormalities: int = 1
    anomaly_timeout_seconds: float = 60.0


@dataclasses.dataclass
class LowNodeLoadArgs:
    node_pools: Sequence[NodePool] = dataclasses.field(default_factory=lambda: [NodePool()])
    number_of_nodes: int = 0
    dry_run: bool = False
    node_fit: bool = True
    paused: bool = False


@dataclasses.dataclass
class NodeClassification:
    names: List[str]
    usage: np.ndarray        # [N, R] int64
    allocatable: np.ndarray  # [N, R] int64
    low_threshold: np.ndarray   # [N, R] quantity units
    high_threshold: np.ndarray  # [N, R]
    underutilized: np.ndarray   # [N] bool
    overutilized: np.ndarray    # [N] bool


def _resource_list_vec(rl: Mapping[str, object], names: Sequence[str]) -> np.ndarray:
    full = res.resource_vector(rl or {})
    return np.array([full[res.RESOURCE_INDEX[n]] for n in names], dtype=np.int64)


def resolved_thresholds(
    pool: NodePool, resource_names: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """reference ``newThresholds`` :287: unset resources default to 100%
    (absolute mode, i.e. never trips) or 0% (deviation mode)."""
    fill = MIN_RESOURCE_PERCENTAGE if pool.use_deviation_thresholds else MAX_RESOURCE_PERCENTAGE
    low = np.array([float(pool.low_thresholds.get(n, fill)) for n in resource_names])
    high = np.array([float(pool.high_thresholds.get(n, fill)) for n in resource_names])
    return low, high


def classify(
    names: Sequence[str],
    usage: np.ndarray,
    allocatable: np.ndarray,
    low_pct: np.ndarray,
    high_pct: np.ndarray,
    use_deviation: bool,
    unschedulable: Optional[np.ndarray] = None,
) -> NodeClassification:
    """Vectorized ``getNodeThresholds`` + ``classifyNodes``."""
    usage = np.asarray(usage, dtype=np.int64)
    allocatable = np.asarray(allocatable, dtype=np.int64)
    n, r = usage.shape
    if use_deviation:
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = np.where(allocatable > 0, 100.0 * usage / np.maximum(allocatable, 1), 0.0)
        avg = pct.mean(axis=0)  # calcAverageResourceUsagePercent
        low_eff = np.clip(avg - low_pct, 0.0, 100.0)
        high_eff = np.clip(avg + high_pct, 0.0, 100.0)
        # resources with MinResourcePercentage pin thresholds to capacity
        pinned = low_pct == MIN_RESOURCE_PERCENTAGE
        low_eff = np.where(pinned, 100.0, low_eff)
        high_eff = np.where(pinned, 100.0, high_eff)
    else:
        low_eff, high_eff = low_pct, high_pct
    low_q = (low_eff[None, :] * 0.01 * allocatable).astype(np.int64)
    high_q = (high_eff[None, :] * 0.01 * allocatable).astype(np.int64)
    # usage equal to the threshold is still underutilized (isNodeUnderutilized
    # rejects only used.Cmp(threshold) > 0, utilization_util.go:406)
    under = (usage <= low_q).all(axis=1)
    if unschedulable is not None:
        under &= ~np.asarray(unschedulable, dtype=bool)
    over = (usage > high_q).any(axis=1)
    return NodeClassification(list(names), usage, allocatable, low_q, high_q, under, over)


def classify_nodes(nodes: Sequence[Mapping], pool: NodePool) -> Tuple[NodeClassification, List[str]]:
    resource_names = sorted(
        set(pool.low_thresholds) | set(pool.high_thresholds) | {res.MEMORY},
        key=lambda n: res.RESOURCE_INDEX.get(n, 99),
    )
    low_pct, high_pct = resolved_thresholds(pool, resource_names)
    usage = np.stack([_resource_list_vec(nd.get("usage", {}), resource_names) for nd in nodes])
    alloc = np.stack([_resource_list_vec(nd.get("allocatable", {}), resource_names) for nd in nodes])
    unsched = np.array([bool(nd.get("unschedulable")) for nd in nodes])
    return (
        classify([nd["name"] for nd in nodes], usage, alloc, low_pct, high_pct, pool.use_deviation_thresholds, unsched),
        resource_names,
    )


def balance(
    args: LowNodeLoadArgs,
    nodes: Sequence[Mapping],
    evictor: PodEvictor,
    detectors: Optional[Dict[str, BasicDetector]] = None,
    pod_filter: Optional[Callable[[Mapping], bool]] = None,
    now: Optional[float] = None,
) -> List[Dict]:
    """One Balance tick over all node pools (reference ``Balance`` :135).

    ``nodes`` are dicts: name, labels, allocatable, usage, unschedulable,
    pods (list of pod dicts with optional ``usage`` metric).  Returns the
    planned/performed evictions as dicts.
    """
    if args.paused:
        return []
    detectors = detectors if detectors is not None else {}
    planned: List[Dict] = []
    processed: set = set()
    for pool in args.node_pools:
        pool_nodes = [
            nd
            for nd in nodes
            if nd["name"] not in processed
            and (
                pool.node_selector is None
                or all(nd.get("labels", {}).get(k) == v for k, v in pool.node_selector.items())
            )
        ]
        if not pool_nodes:
            continue
        cls, resource_names = classify_nodes(pool_nodes, pool)
        low_idx = np.flatnonzero(cls.underutilized)
        high_idx = np.flatnonzero(cls.overutilized)
        # reference guards (:173-194); guard exits do NOT mark nodes as
        # processed — an overlapping later pool still evaluates them
        # (processOneNodePool inserts only sourceNodes, on success).
        for i in low_idx:  # underutilized nodes reset their detectors
            d = detectors.get(cls.names[i])
            if d:
                d.reset()
        if (
            len(low_idx) == 0
            or len(low_idx) <= args.number_of_nodes
            or len(low_idx) == len(pool_nodes)
            or len(high_idx) == 0
        ):
            continue

        abnormal = _filter_real_abnormal(cls, high_idx, pool, detectors, now)
        if not len(abnormal):
            continue

        # destination headroom per low node (node-fit check) and its total:
        # sum(highThreshold - usage) over underutilized nodes
        dest_headroom = cls.high_threshold[low_idx] - cls.usage[low_idx]
        total_available = dest_headroom.sum(axis=0)

        # most-loaded first (weighted usage fraction)
        weights = np.array(
            [float(pool.resource_weights.get(n, 0)) for n in resource_names]
        )
        frac = (cls.usage / np.maximum(cls.allocatable, 1)).astype(float)
        load = (frac * weights).sum(axis=1) / max(weights.sum(), 1e-9)
        abnormal = sorted(abnormal, key=lambda i: -load[i])

        name_to_node = {nd["name"]: nd for nd in pool_nodes}
        for i in abnormal:
            node = name_to_node[cls.names[i]]
            node_usage = cls.usage[i].copy()
            pods = [
                p
                for p in node.get("pods", [])
                if _removable(p, pod_filter)
                and (
                    not args.node_fit
                    or _fits_any(p, dest_headroom, resource_names)
                )
            ]
            if not pods:
                continue
            metrics = {p["name"]: p.get("usage", p.get("requests", {})) for p in pods}
            ordered = sort_pods_for_eviction(
                pods, metrics, node.get("allocatable", {}), pool.resource_weights
            )
            for pod in ordered:
                still_over = (node_usage > cls.high_threshold[i]).any()
                if not still_over:
                    d = detectors.get(cls.names[i])
                    if d:
                        d.reset()
                    break
                if (total_available <= 0).any():
                    break
                pod_vec = _resource_list_vec(metrics.get(pod["name"], {}), resource_names)
                if not args.dry_run and not evictor.evict(
                    pod, cls.names[i], reason=f"node overutilized in pool {pool.name}"
                ):
                    continue
                node_usage -= pod_vec
                total_available -= pod_vec
                planned.append({"pod": pod["name"], "node": cls.names[i], "pool": pool.name})
        # after the round every overutilized source node is marked normal
        # once (tryMarkNodesAsNormal, low_node_load.go:234: Mark(true) on
        # existing detectors only) and excluded from later pools
        # (low_node_load.go:235-237 inserts all sourceNodes)
        for i in high_idx:
            d = detectors.get(cls.names[i])
            if d:
                d.mark(True, now)
            processed.add(cls.names[i])
    return planned


def _removable(pod: Mapping, pod_filter) -> bool:
    if pod.get("non_removable") or pod.get("qos") == "SYSTEM":
        return False
    if pod_filter is not None and not pod_filter(pod):
        return False
    return True


def _fits_any(pod: Mapping, dest_headroom: np.ndarray, resource_names: Sequence[str]) -> bool:
    """NodeFit guard (reference wraps the pod filter with
    ``PodFitsAnyNode`` over the destination nodes): the pod's requests
    must fit into at least one underutilized node's headroom."""
    if len(dest_headroom) == 0:
        return False
    req = _resource_list_vec(pod.get("requests", {}), resource_names)
    return bool((dest_headroom >= req).all(axis=1).any())


def _filter_real_abnormal(
    cls: NodeClassification,
    high_idx: np.ndarray,
    pool: NodePool,
    detectors: Dict[str, BasicDetector],
    now: Optional[float] = None,
) -> List[int]:
    """reference ``filterRealAbnormalNodes`` :256: with a 1-observation
    condition every overutilized node qualifies; otherwise the per-node
    circuit breaker must have tripped."""
    if pool.consecutive_abnormalities <= 1:
        return list(high_idx)
    out = []
    for i in high_idx:
        name = cls.names[i]
        d = detectors.get(name)
        if d is None:
            d = BasicDetector(
                name,
                timeout_seconds=pool.anomaly_timeout_seconds,
                anomaly_condition=lambda c, k=pool.consecutive_abnormalities: c.consecutive_abnormalities > k,
            )
            detectors[name] = d
        if d.mark(False, now) is State.ANOMALY:
            out.append(i)
    return out
