"""ElasticQuota enforcement: overuse revocation and quota preemption.

Round 1 only *admitted* pods against runtime caps; this module adds the
reclaim half (citations into the upstream Koordinator source):

* ``QuotaOverUsedRevokeController`` — watches every quota across all trees;
  when a group's used exceeds its runtime continuously for longer than the
  configured delay, evicts the smallest set of its lowest-priority pods
  that brings used back under runtime
  (``pkg/scheduler/plugins/elasticquota/quota_overuse_revoke.go``).
* ``select_victims_on_node`` / ``pick_preemption_node`` — the PostFilter
  preemption path: a pod rejected by quota admission may preempt
  lower-priority pods of the SAME quota group
  (``pkg/scheduler/plugins/elasticquota/preempt.go:283 canPreempt``,
  ``:111 SelectVictimsOnNode``).

Pods are plain mappings ({"name", "priority", "requests", "start_time",
"non_preemptible"}); node feasibility is exact integer fit over the dense
resource axis, so the victim sets match what the reference computes from
NodeInfo.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.constraints.quota_manager import (
    DEFAULT_QUOTA,
    MultiTreeQuotaManager,
)
from koordinator_tpu_torch.model import resources as res

R = res.NUM_RESOURCES


def _req(pod: Mapping) -> List[int]:
    return res.resource_vector(pod.get("requests") or {})


def more_important_pod(a: Mapping, b: Mapping) -> bool:
    """k8s scheduler util.MoreImportantPod: higher priority wins; ties go
    to the earlier-started pod (used by both revoke and preemption)."""
    pa, pb = int(a.get("priority") or 0), int(b.get("priority") or 0)
    if pa != pb:
        return pa > pb
    return float(a.get("start_time") or 0) < float(b.get("start_time") or 0)


def _importance_key(pod: Mapping):
    # sort key equivalent of more_important_pod, ascending = least first
    return (int(pod.get("priority") or 0), -float(pod.get("start_time") or 0))


def _less_equal(used: Sequence[int], runtime: Sequence[int], dims=None) -> bool:
    if dims is not None:
        return all(used[r] <= runtime[r] for r in dims)
    return all(u <= r for u, r in zip(used, runtime))


def _constraining_dims(declared: Sequence[int], runtime: Sequence[int]):
    """The dims the over-use check compares: declared ones plus any with a
    nonzero runtime — an undeclared dim whose cluster total is zero must not
    constrain, or the revoke target is unreachable and every preemptible pod
    gets evicted (the same mask monitor() uses for its over check)."""
    return sorted(set(declared) | {r for r in range(R) if runtime[r]})


# ---------------------------------------------------------------------------
# Overuse revocation (quota_overuse_revoke.go)
# ---------------------------------------------------------------------------


class QuotaOverUsedGroupMonitor:
    """quota_overuse_revoke.go:45 — per-quota debounce + victim selection."""

    def __init__(
        self,
        quota_name: str,
        manager,
        trigger_evict_duration: float,
        now: float = 0.0,
    ):
        self.quota_name = quota_name
        self.manager = manager
        self.trigger_evict_duration = trigger_evict_duration
        self.last_under_used_time = now

    def monitor(self, now: float) -> bool:
        """:61 — True once used > runtime continuously past the delay."""
        node = self.manager.nodes.get(self.quota_name)
        if node is None:
            return False
        runtime = self.manager.refresh_runtime(self.quota_name)
        # only declared dims constrain (undeclared fall open, matching the
        # masked runtime the reference compares against)
        over = any(
            node.used[r] > runtime[r] for r in node.declared
        ) or any(
            node.used[r] > runtime[r]
            for r in range(R)
            if runtime[r] and r not in node.declared
        )
        if not over:
            self.last_under_used_time = now
            return False
        if now - self.last_under_used_time > self.trigger_evict_duration:
            self.last_under_used_time = now
            return True
        return False

    def get_to_revoke_pod_list(self) -> List[Mapping]:
        """:92 getToRevokePodList — exact reference algorithm: strip
        lowest-priority pods until used <= runtime, then try to assign back
        from highest priority down."""
        node = self.manager.nodes.get(self.quota_name)
        if node is None:
            return []
        runtime = self.manager.refresh_runtime(self.quota_name)
        dims = _constraining_dims(node.declared, runtime)
        used = list(node.used)
        # assigned pods, low priority first (:105 sorts by !MoreImportantPod)
        pods = sorted(
            (p for n, p in node.pods.items() if node.assigned.get(n)),
            key=_importance_key,
        )
        try_revoke: List[Mapping] = []
        for pod in pods:
            if _less_equal(used, runtime, dims):
                break
            if pod.get("non_preemptible"):
                continue  # :114 IsPodNonPreemptible
            used = [u - v for u, v in zip(used, _req(pod))]
            try_revoke.append(pod)
        if not _less_equal(used, runtime, dims):
            return try_revoke  # :123 still over -> evict all tried
        # :131 assign back high -> low while it still fits
        revoke: List[Mapping] = []
        for pod in reversed(try_revoke):
            preq = _req(pod)
            used = [u + v for u, v in zip(used, preq)]
            if not _less_equal(used, runtime, dims):
                used = [u - v for u, v in zip(used, preq)]
                revoke.append(pod)
        return revoke


class QuotaOverUsedRevokeController:
    """quota_overuse_revoke.go:149 — all-quota monitor across trees."""

    def __init__(
        self,
        multi_manager: MultiTreeQuotaManager,
        trigger_evict_duration: float = 300.0,
        monitor_all: bool = True,
    ):
        self.multi = multi_manager
        self.trigger_evict_duration = trigger_evict_duration
        self.monitor_all = monitor_all
        self.monitors: Dict[str, QuotaOverUsedGroupMonitor] = {}

    def sync_quota(self, now: float) -> None:
        """:210 — add monitors for new quotas, drop removed ones."""
        alive = self.multi.all_quota_names()
        for name, mgr in alive.items():
            if name not in self.monitors:
                self.monitors[name] = QuotaOverUsedGroupMonitor(
                    name, mgr, self.trigger_evict_duration, now
                )
        for name in list(self.monitors):
            if name not in alive:
                del self.monitors[name]

    def monitor_all_quotas(self, now: float) -> List[Mapping]:
        """:197 monitorAll — one tick: returns the pods to revoke."""
        if not self.monitor_all:
            return []
        self.sync_quota(now)
        to_revoke: List[Mapping] = []
        for monitor in self.monitors.values():
            if monitor.monitor(now):
                to_revoke.extend(monitor.get_to_revoke_pod_list())
        return to_revoke


# ---------------------------------------------------------------------------
# Preemption (preempt.go)
# ---------------------------------------------------------------------------


def can_preempt(pod: Mapping, victim: Mapping) -> bool:
    """preempt.go:283 — same quota group, strictly higher priority, and the
    victim is preemptible."""
    if victim.get("non_preemptible"):
        return False
    return int(pod.get("priority") or 0) > int(
        victim.get("priority") or 0
    ) and (pod.get("quota") or DEFAULT_QUOTA) == (
        victim.get("quota") or DEFAULT_QUOTA
    )


@dataclasses.dataclass
class NodeVictims:
    node: str
    victims: List[Mapping]
    num_violating: int = 0


def _fits(
    requested: Sequence[int], allocatable: Sequence[int], req: Sequence[int]
) -> bool:
    return all(
        q + r <= a if r > 0 else True
        for q, a, r in zip(requested, allocatable, req)
    )


def select_victims_on_node(
    pod: Mapping,
    node_name: str,
    node_allocatable: Sequence[int],
    node_pods: Sequence[Mapping],
    quota_used: Sequence[int],
    quota_runtime: Sequence[int],
    pdb_violators: Optional[set] = None,
) -> Optional[NodeVictims]:
    """preempt.go:111 SelectVictimsOnNode.

    ``node_pods`` are the pods currently placed on the node (each carrying
    "requests"); ``quota_used``/``quota_runtime`` are the preemptor's
    group's vectors.  Returns None when preemption on this node cannot make
    the pod schedulable.
    """
    preq = _req(pod)
    potential = [p for p in node_pods if can_preempt(pod, p)]
    if not potential:
        return None  # :150 no victims -> UnschedulableAndUnresolvable

    # remove all potential victims, check the pod then fits (:137-163)
    requested = _zeros_like(node_allocatable)
    for p in node_pods:
        requested = [a + b for a, b in zip(requested, _req(p))]
    removed_req = _zeros_like(node_allocatable)
    removed_quota = _zeros_like(node_allocatable)
    for p in potential:
        removed_req = [a + b for a, b in zip(removed_req, _req(p))]
        removed_quota = [a + b for a, b in zip(removed_quota, _req(p))]
    base_requested = [a - b for a, b in zip(requested, removed_req)]
    if not _fits(base_requested, node_allocatable, preq):
        return None
    base_quota_used = [u - v for u, v in zip(quota_used, removed_quota)]
    if not _less_equal([u + v for u, v in zip(base_quota_used, preq)], quota_runtime):
        return None

    # reprieve most-important first (:166-213); PDB violators first so as
    # many of them as possible survive
    ordered = sorted(potential, key=_importance_key, reverse=True)
    violators = [p for p in ordered if pdb_violators and p["name"] in pdb_violators]
    others = [p for p in ordered if not (pdb_violators and p["name"] in pdb_violators)]
    victims: List[Mapping] = []
    num_violating = 0
    cur_requested = list(base_requested)
    cur_quota_used = list(base_quota_used)

    def reprieve(p: Mapping) -> bool:
        nonlocal cur_requested, cur_quota_used
        trial_requested = [a + b for a, b in zip(cur_requested, _req(p))]
        trial_quota = [a + b for a, b in zip(cur_quota_used, _req(p))]
        fits = _fits(trial_requested, node_allocatable, preq) and _less_equal(
            [u + v for u, v in zip(trial_quota, preq)], quota_runtime
        )
        if fits:
            cur_requested = trial_requested
            cur_quota_used = trial_quota
        else:
            victims.append(p)
        return fits

    for p in violators:
        if not reprieve(p):
            num_violating += 1
    for p in others:
        reprieve(p)
    return NodeVictims(node=node_name, victims=victims, num_violating=num_violating)


def _zeros_like(v: Sequence[int]) -> List[int]:
    return [0] * len(v)


def run_quota_preemption(
    pod: Mapping,
    node_allocatable: Mapping[str, Sequence[int]],
    node_pods: Mapping[str, Sequence[Mapping]],
    quota_used: Sequence[int],
    quota_runtime: Sequence[int],
    pdb_violators: Optional[set] = None,
) -> Optional[NodeVictims]:
    """The PostFilter dry run (preempt.go via upstream defaultpreemption):
    evaluate SelectVictimsOnNode on every candidate node and pick the best
    (:43 GetOffsetAndNumCandidates evaluates ALL nodes)."""
    candidates = []
    for name, alloc in node_allocatable.items():
        nv = select_victims_on_node(
            pod,
            name,
            alloc,
            node_pods.get(name, ()),
            quota_used,
            quota_runtime,
            pdb_violators=pdb_violators,
        )
        if nv is not None and nv.victims:
            candidates.append(nv)
    return pick_preemption_node(candidates)


def pick_preemption_node(candidates: Sequence[NodeVictims]) -> Optional[NodeVictims]:
    """Upstream dry-run node choice (defaultpreemption pickOneNodeForPreemption,
    delegated to by preempt.go): fewest PDB violations, then lowest highest
    victim priority, then lowest priority sum, then fewest victims, then
    stable by node name."""
    if not candidates:
        return None

    def key(c: NodeVictims):
        prios = [int(v.get("priority") or 0) for v in c.victims]
        return (
            c.num_violating,
            max(prios) if prios else 0,
            sum(prios),
            len(c.victims),
            c.node,
        )

    return min(candidates, key=key)
