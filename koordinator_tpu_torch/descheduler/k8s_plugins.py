"""Upstream-descheduler adaptor plugins.

The port's own copy of ``koordinator_tpu/descheduler/k8s_plugins.py``.

Reference: ``pkg/descheduler/framework/plugins/kubernetes`` wraps
sigs.k8s.io/descheduler plugins (DefaultEvictor, RemovePodsViolating*,
RemoveDuplicates, RemovePodsHavingTooManyRestarts) into the koord
descheduler framework (``framework/types.go:80 DeschedulePlugin``).
Here the same plugin set as pure functions over pod/node dicts, composed
with the evictions/ rate-limited evictor the way the adaptor wires the
upstream evictor seam.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

PRIORITY_CRITICAL = 2_000_000_000  # system-cluster-critical


@dataclasses.dataclass(frozen=True)
class DefaultEvictorArgs:
    """sigs.k8s.io defaultevictor semantics: which pods are evictable."""

    evict_system_critical_pods: bool = False
    evict_local_storage_pods: bool = False
    evict_failed_bare_pods: bool = False
    ignore_pvc_pods: bool = False
    priority_threshold: Optional[int] = None
    label_selector: Optional[Mapping[str, str]] = None


def _matches(selector: Optional[Mapping[str, str]], labels: Mapping) -> bool:
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


def default_evictor_filter(pod: Mapping, args: DefaultEvictorArgs) -> List[str]:
    """Reasons the pod is NOT evictable; empty list = evictable."""
    reasons: List[str] = []
    labels = pod.get("labels") or {}
    annotations = pod.get("annotations") or {}
    owner_kinds = {o.get("kind") for o in pod.get("owner_references") or []}
    if not owner_kinds:
        # upstream DefaultEvictor: bare pods (no controller to recreate
        # them) are never evictable, except Failed ones when
        # evictFailedBarePods is set
        if not (args.evict_failed_bare_pods and pod.get("phase") == "Failed"):
            reasons.append("pod is a bare pod without owner")
    if "DaemonSet" in owner_kinds:
        reasons.append("pod is owned by a DaemonSet")
    if pod.get("mirror") or "kubernetes.io/config.mirror" in annotations:
        reasons.append("pod is a static/mirror pod")
    prio = int(pod.get("priority") or 0)
    if not args.evict_system_critical_pods:
        if prio >= PRIORITY_CRITICAL:
            reasons.append("pod is system-critical")
        if args.priority_threshold is not None and prio >= args.priority_threshold:
            reasons.append("pod priority above threshold")
    if not args.evict_local_storage_pods and pod.get("has_local_storage"):
        reasons.append("pod uses local storage")
    if args.ignore_pvc_pods and pod.get("has_pvc"):
        reasons.append("pod uses a PVC")
    if annotations.get("descheduler.alpha.kubernetes.io/evict") in ("false", False):
        reasons.append("pod opted out of eviction")
    if not _matches(args.label_selector, labels):
        reasons.append("pod does not match the evictor label selector")
    return reasons


@dataclasses.dataclass(frozen=True)
class TooManyRestartsArgs:
    pod_restart_threshold: int = 100
    include_init_containers: bool = False


def remove_pods_having_too_many_restarts(
    pods: Sequence[Mapping], args: TooManyRestartsArgs
) -> List[Mapping]:
    """Upstream RemovePodsHavingTooManyRestarts: total container restarts
    >= threshold selects the pod for eviction."""
    out = []
    for pod in pods:
        restarts = sum(int(c.get("restart_count", 0)) for c in pod.get("containers", []))
        if args.include_init_containers:
            restarts += sum(
                int(c.get("restart_count", 0))
                for c in pod.get("init_containers", [])
            )
        if restarts >= args.pod_restart_threshold:
            out.append(pod)
    return out


def remove_duplicates(pods: Sequence[Mapping]) -> List[Mapping]:
    """Upstream RemoveDuplicates: for each (owner, node) keep one replica,
    select the rest for eviction so replicas spread across nodes."""
    seen: Dict[tuple, Mapping] = {}
    dupes: List[Mapping] = []
    for pod in pods:
        owners = tuple(
            sorted(
                (o.get("kind", ""), o.get("name", ""))
                for o in pod.get("owner_references") or []
            )
        )
        if not owners:
            continue
        key = (owners, pod.get("node"))
        if key in seen:
            dupes.append(pod)
        else:
            seen[key] = pod
    return dupes


def remove_pods_violating_node_affinity(
    pods: Sequence[Mapping], nodes: Sequence[Mapping]
) -> List[Mapping]:
    """Upstream RemovePodsViolatingNodeAffinity (requiredDuringScheduling
    IgnoredDuringExecution re-checked): pod's required node selector no
    longer matches the labels of the node it runs on."""
    node_labels = {n["name"]: n.get("labels") or {} for n in nodes}
    out = []
    for pod in pods:
        required = pod.get("node_selector") or {}
        if not required:
            continue
        labels = node_labels.get(pod.get("node"), {})
        if not _matches(required, labels):
            out.append(pod)
    return out


def _dedup_by_id(pods: Sequence[Mapping]) -> List[Mapping]:
    """Stable de-dup of pod dicts by object identity."""
    seen = set()
    uniq: List[Mapping] = []
    for p in pods:
        if id(p) not in seen:
            seen.add(id(p))
            uniq.append(p)
    return uniq


def remove_pods_violating_interpod_antiaffinity(
    pods: Sequence[Mapping],
) -> List[Mapping]:
    """Upstream RemovePodsViolatingInterPodAntiAffinity: a pod colocated
    on the same node with a pod whose required anti-affinity selector
    matches it is selected for eviction."""
    by_node: Dict[str, List[Mapping]] = {}
    for pod in pods:
        by_node.setdefault(pod.get("node", ""), []).append(pod)
    out = []
    for node_pods in by_node.values():
        for holder in node_pods:
            selector = holder.get("anti_affinity_selector")
            if not selector:
                continue
            for other in node_pods:
                if other is holder:
                    continue
                if _matches(selector, other.get("labels") or {}):
                    out.append(other)
    return _dedup_by_id(out)


@dataclasses.dataclass
class DeschedulePluginResult:
    selected: List[Mapping]
    evicted: List[Mapping]
    skipped: Dict[str, List[str]]


def run_deschedule_plugin(
    selector: Callable[[], List[Mapping]],
    evictor_args: DefaultEvictorArgs,
    evict: Callable[[Mapping], bool],
) -> DeschedulePluginResult:
    """The adaptor glue (framework/plugins/kubernetes): selection ->
    DefaultEvictor filter -> rate-limited eviction."""
    selected = selector()
    evicted: List[Mapping] = []
    skipped: Dict[str, List[str]] = {}
    for pod in selected:
        reasons = default_evictor_filter(pod, evictor_args)
        if reasons:
            skipped[pod.get("name", "?")] = reasons
            continue
        if evict(pod):
            evicted.append(pod)
    return DeschedulePluginResult(selected, evicted, skipped)


# ---------------------------------------------------------------------------
# RemovePodsViolatingNodeTaints
# ---------------------------------------------------------------------------


def _tolerates(toleration: Mapping, taint: Mapping) -> bool:
    """Upstream v1.Toleration.ToleratesTaint: operator Exists matches any
    value; Equal (the default) requires equal values; an empty key with
    Exists matches every taint; an empty effect matches every effect."""
    op = toleration.get("operator") or "Equal"
    t_effect = toleration.get("effect") or ""
    if t_effect and t_effect != taint.get("effect"):
        return False
    key = toleration.get("key") or ""
    if not key:
        return op == "Exists"
    if key != taint.get("key"):
        return False
    if op == "Exists":
        return True
    return (toleration.get("value") or "") == (taint.get("value") or "")


@dataclasses.dataclass(frozen=True)
class NodeTaintsArgs:
    """Upstream RemovePodsViolatingNodeTaints args: which taint keys are
    considered (None = all), and whether PreferNoSchedule counts."""

    excluded_taints: Sequence[str] = ()
    included_taints: Sequence[str] = ()  # empty = all
    include_prefer_no_schedule: bool = False


def remove_pods_violating_node_taints(
    pods: Sequence[Mapping],
    nodes: Sequence[Mapping],
    args: Optional[NodeTaintsArgs] = None,
) -> List[Mapping]:
    """Upstream RemovePodsViolatingNodeTaints: select pods whose node
    carries a NoSchedule (optionally PreferNoSchedule) taint the pod does
    not tolerate — the scheduler would no longer place them there."""
    args = args or NodeTaintsArgs()
    effects = {"NoSchedule"}
    if args.include_prefer_no_schedule:
        effects.add("PreferNoSchedule")
    node_taints: Dict[str, List[Mapping]] = {}
    for n in nodes:
        taints = []
        for t in n.get("taints") or []:
            key = t.get("key", "")
            if t.get("effect") not in effects:
                continue
            if args.excluded_taints and key in args.excluded_taints:
                continue
            if args.included_taints and key not in args.included_taints:
                continue
            taints.append(t)
        node_taints[n["name"]] = taints
    out = []
    for pod in pods:
        taints = node_taints.get(pod.get("node"), [])
        if not taints:
            continue
        tolerations = pod.get("tolerations") or []
        untolerated = any(
            not any(_tolerates(tol, taint) for tol in tolerations)
            for taint in taints
        )
        if untolerated:
            out.append(pod)
    return out


# ---------------------------------------------------------------------------
# RemoveFailedPods
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FailedPodsArgs:
    """Upstream RemoveFailedPods args (reasons/min lifetime/owner-kind
    exclusion; including_init_containers widens the reason scan)."""

    reasons: Sequence[str] = ()  # empty = any failure reason
    min_pod_lifetime_seconds: Optional[int] = None
    exclude_owner_kinds: Sequence[str] = ()
    including_init_containers: bool = False


def remove_failed_pods(
    pods: Sequence[Mapping],
    args: Optional[FailedPodsArgs] = None,
    now: float = 0.0,
) -> List[Mapping]:
    """Upstream RemoveFailedPods: Failed-phase pods (optionally filtered
    by failure reason and minimum age) are selected so their controllers
    recreate them."""
    args = args or FailedPodsArgs()
    out = []
    for pod in pods:
        if pod.get("phase") != "Failed":
            continue
        owner_kinds = {o.get("kind") for o in pod.get("owner_references") or []}
        if args.exclude_owner_kinds and owner_kinds & set(args.exclude_owner_kinds):
            continue
        if args.min_pod_lifetime_seconds is not None:
            start = pod.get("start_time")
            if start is None:
                continue  # unknown age cannot pass an age gate
            if now - float(start) < args.min_pod_lifetime_seconds:
                continue
        if args.reasons:
            reasons = {pod.get("reason", "")}
            containers = list(pod.get("containers") or [])
            if args.including_init_containers:
                containers += list(pod.get("init_containers") or [])
            for c in containers:
                reasons.add(c.get("reason", ""))
            if not reasons & set(args.reasons):
                continue
        out.append(pod)
    return out


# ---------------------------------------------------------------------------
# PodLifeTime
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PodLifeTimeArgs:
    """Upstream PodLifeTime args: age limit + optional phase/label gates."""

    max_pod_life_time_seconds: int = 86400
    states: Sequence[str] = ()  # empty = any phase
    label_selector: Optional[Mapping[str, str]] = None


def pod_life_time(
    pods: Sequence[Mapping],
    args: Optional[PodLifeTimeArgs] = None,
    now: float = 0.0,
) -> List[Mapping]:
    """Upstream PodLifeTime: pods older than the limit (matching the
    state/label gates) are selected for refresh."""
    args = args or PodLifeTimeArgs()
    out = []
    for pod in pods:
        if args.states and pod.get("phase", "Running") not in args.states:
            continue
        if not _matches(args.label_selector, pod.get("labels") or {}):
            continue
        start = pod.get("start_time")
        if start is None:
            continue  # unknown age: never treat as infinitely old
        if now - float(start) > args.max_pod_life_time_seconds:
            out.append(pod)
    return out


# ---------------------------------------------------------------------------
# RemovePodsViolatingTopologySpreadConstraint
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologySpreadArgs:
    """Upstream RemovePodsViolatingTopologySpreadConstraint: balance each
    constraint's domains until skew <= max_skew (hard constraints only
    unless include_soft_constraints)."""

    include_soft_constraints: bool = False


def remove_pods_violating_topology_spread(
    pods: Sequence[Mapping],
    nodes: Sequence[Mapping],
    args: Optional[TopologySpreadArgs] = None,
) -> List[Mapping]:
    """Upstream balanceDomains: group each constraint's matching pods by
    the topology value of their node; while (max - min) > maxSkew, move
    pods off the largest domains — the moved pods are the selection.

    Constraints ride the pods: ``{"topology_spread": [{"max_skew": 1,
    "topology_key": "zone", "when_unsatisfiable": "DoNotSchedule",
    "label_selector": {...}}]}`` — the reference reads them from each
    namespace's pods the same way.
    """
    args = args or TopologySpreadArgs()
    node_topo: Dict[str, Mapping] = {
        n["name"]: (n.get("labels") or {}) for n in nodes
    }
    out: List[Mapping] = []
    seen_constraints = set()
    for pod in pods:
        for c in pod.get("topology_spread") or []:
            unsat = c.get("when_unsatisfiable", "DoNotSchedule")
            if unsat != "DoNotSchedule" and not args.include_soft_constraints:
                continue
            key = (
                c.get("topology_key", ""),
                int(c.get("max_skew", 1)),
                tuple(sorted((c.get("label_selector") or {}).items())),
            )
            if key in seen_constraints:
                continue
            seen_constraints.add(key)
            topo_key, max_skew, selector = key[0], key[1], dict(key[2])

            domains: Dict[str, List[Mapping]] = {}
            # every node with the topology label is a domain, even when
            # empty (upstream counts zero-pod domains for skew)
            for n in nodes:
                val = (n.get("labels") or {}).get(topo_key)
                if val is not None:
                    domains.setdefault(val, [])
            for p in pods:
                if not _matches(selector, p.get("labels") or {}):
                    continue
                val = node_topo.get(p.get("node"), {}).get(topo_key)
                if val is None:
                    continue
                domains.setdefault(val, []).append(p)
            if len(domains) < 2:
                continue
            counts = {d: len(ps) for d, ps in domains.items()}
            moved: List[Mapping] = []
            while True:
                src = max(sorted(counts), key=lambda d: counts[d])
                dst = min(sorted(counts), key=lambda d: counts[d])
                diff = counts[src] - counts[dst]
                # moving one pod changes the gap by 2: when the gap is
                # already <= 1 no move can improve it (an unsatisfiable
                # max_skew=0 on an odd split must select nothing, not
                # ping-pong every pod out)
                if diff <= max(max_skew, 1):
                    break
                victims = [p for p in domains[src] if p not in moved]
                if not victims:
                    break
                moved.append(victims[-1])  # newest-listed first, like the
                # upstream sort preferring lower-priority/newer victims
                counts[src] -= 1
                counts[dst] += 1
            out.extend(moved)
    return _dedup_by_id(out)
