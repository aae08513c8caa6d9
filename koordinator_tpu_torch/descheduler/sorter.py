"""Multi-key pod/node ranking for eviction candidate selection.

A host-only copy of ``koordinator_tpu/descheduler/sorter.py`` (reference
``pkg/descheduler/utils/sorter``): ``OrderedBy`` chains compare functions
(``helper.go``); the pod ordering is KoordinatorPriorityClass, then numeric
Priority, then Kubernetes QoS, then Koordinator QoS, then pod deletion
cost, then eviction cost, then a caller-supplied key (usually
Reverse(PodUsage)), then creation timestamp (``pod.go:161 PodSorter``).
Lower-ranked pods are evicted first.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping, Sequence

from koordinator_tpu_torch.model import resources as res

CompareFn = Callable[[Mapping, Mapping], int]

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
    else prod (HP) by default.  (The reference package keeps it in
    ``manager/noderesource.py``, which is not ported.)"""
    pc = pod.get("priority_class", "")
    if pc in PRIORITY_BANDS:
        return pc
    prio = pod.get("priority")
    if prio is not None:
        for name, (lo, hi) in PRIORITY_BANDS.items():
            if lo <= int(prio) <= hi:
                return name
    return PRIORITY_PROD

# ascending eviction preference: free evicted before batch before mid before prod
_PRIORITY_CLASS_RANK = {"koord-free": 0, "koord-batch": 1, "koord-mid": 2, "koord-prod": 3}
_K8S_QOS_RANK = {"BestEffort": 0, "Burstable": 1, "Guaranteed": 2}
# reference apis/extension/qos.go: SYSTEM > LSE > LSR > LS > BE
_KOORD_QOS_RANK = {"BE": 0, "LS": 1, "LSR": 2, "LSE": 3, "SYSTEM": 4}


def _cmp(a, b) -> int:
    return (a > b) - (a < b)


def koordinator_priority_class(a: Mapping, b: Mapping) -> int:
    return _cmp(_PRIORITY_CLASS_RANK.get(priority_class_of(a), 3), _PRIORITY_CLASS_RANK.get(priority_class_of(b), 3))


def priority(a: Mapping, b: Mapping) -> int:
    return _cmp(a.get("priority", 0), b.get("priority", 0))


def kubernetes_qos_class(a: Mapping, b: Mapping) -> int:
    return _cmp(_K8S_QOS_RANK.get(a.get("k8s_qos", "Burstable"), 1), _K8S_QOS_RANK.get(b.get("k8s_qos", "Burstable"), 1))


def koordinator_qos_class(a: Mapping, b: Mapping) -> int:
    return _cmp(_KOORD_QOS_RANK.get(a.get("qos", "LS"), 1), _KOORD_QOS_RANK.get(b.get("qos", "LS"), 1))


def pod_deletion_cost(a: Mapping, b: Mapping) -> int:
    return _cmp(int(a.get("deletion_cost", 0)), int(b.get("deletion_cost", 0)))


def eviction_cost(a: Mapping, b: Mapping) -> int:
    return _cmp(int(a.get("eviction_cost", 0)), int(b.get("eviction_cost", 0)))


def creation_timestamp(a: Mapping, b: Mapping) -> int:
    return _cmp(a.get("creation_timestamp", 0), b.get("creation_timestamp", 0))


def reverse(cmp: CompareFn) -> CompareFn:
    """reference ``helper.go:107 Reverse``."""

    def inner(a, b):
        return -cmp(a, b)

    return inner


def pod_usage(
    pod_metrics: Mapping[str, Mapping[str, object]],
    node_allocatable: Mapping[str, object],
    resource_weights: Mapping[str, int],
) -> CompareFn:
    """Weighted mean usage fraction of node allocatable (reference
    ``scorer.go`` podUsageScorer); higher usage sorts first under
    ``reverse``."""
    alloc = res.resource_vector(node_allocatable)
    weights = res.weights_vector(resource_weights)

    def score(pod: Mapping) -> float:
        m = pod_metrics.get(pod.get("name", ""))
        if not m:
            return 0.0
        vec = res.resource_vector(m)
        total, wsum = 0.0, 0
        for v, a, w in zip(vec, alloc, weights):
            if w <= 0 or a <= 0:
                continue
            total += w * (v / a)
            wsum += w
        return total / wsum if wsum else 0.0

    def compare(a, b):
        return _cmp(score(a), score(b))

    return compare


def ordered_by(*comparators: CompareFn) -> Callable[[Sequence[Mapping]], list]:
    """reference ``helper.go OrderedBy``: stable multi-key sort."""

    def key_cmp(a, b):
        for cmp in comparators:
            r = cmp(a, b)
            if r:
                return r
        return 0

    def sort(items: Sequence[Mapping]) -> list:
        return sorted(items, key=functools.cmp_to_key(key_cmp))

    return sort


def sort_pods_for_eviction(
    pods: Sequence[Mapping],
    pod_metrics: Mapping[str, Mapping[str, object]],
    node_allocatable: Mapping[str, object],
    resource_weights: Mapping[str, int],
) -> list:
    """reference ``pod.go:175 SortPodsByUsage`` composed with the standard
    PodSorter chain; first element is the best eviction candidate."""
    return ordered_by(
        koordinator_priority_class,
        priority,
        kubernetes_qos_class,
        koordinator_qos_class,
        pod_deletion_cost,
        eviction_cost,
        reverse(pod_usage(pod_metrics, node_allocatable, resource_weights)),
        creation_timestamp,
    )(pods)


def sort_nodes_by_usage(
    nodes: Sequence[Mapping],
    usage_fraction: Callable[[Mapping], float],
    ascending: bool = False,
) -> list:
    """reference ``low_node_load.go sortNodesByUsage``: most-loaded first
    unless ascending."""
    return sorted(nodes, key=usage_fraction, reverse=not ascending)
