"""Hierarchical ElasticQuota management: quota tree, min scaling, multi-tree.

Host-side control plane mirroring the reference's GroupQuotaManager
(``pkg/scheduler/plugins/elasticquota/core/group_quota_manager.go:35``):
the stateful tree lives here; each scheduling cycle flattens the current
leaf runtimes into the device-side ``QuotaTable`` admission masks
(constraints/quota.py ``build_quota_table_inputs``).

Semantics mirrored (citations into the upstream Koordinator source):

* request/used aggregation up the tree with limit-request clamping and the
  no-lend min floor (``group_quota_manager.go:184 recursiveUpdateGroup
  TreeWithDeltaRequest``, ``quota_info.go:193 getLimitRequestNoLock``) —
  implemented as a bottom-up recompute, which converges to the same fixed
  point as the reference's delta propagation;
* cluster total excludes the system/default groups' used
  (``group_quota_manager.go:120 updateClusterTotalResourceNoLock``);
* per-level runtime refresh walking root->leaf, feeding each level's
  runtime as the next level's distributable total
  (``group_quota_manager.go:264 RefreshRuntimeNoLock``), with the sibling
  fair division from constraints/quota.py (``runtime_quota_calculator.go``);
* min-quota scaling when the children's min sum exceeds the (shrunken)
  total (``core/scale_minquota_when_over_root_res.go``);
* multi quota tree: one independent manager per tree id plus the default
  manager (``plugin.go ListGroupQuotaManagersForQuotaTree``, feature gate
  MultiQuotaTree in ``pkg/features/features.go``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from koordinator_tpu_torch.constraints.quota import QuotaGroup, refresh_runtime
from koordinator_tpu_torch.model import resources as res

R = res.NUM_RESOURCES

# reference apis/extension/elastic_quota.go:28-32
ROOT_QUOTA = "koordinator-root-quota"
SYSTEM_QUOTA = "koordinator-system-quota"
DEFAULT_QUOTA = "koordinator-default-quota"


def _zeros() -> List[int]:
    return [0] * R


def _add(a: Sequence[int], b: Sequence[int]) -> List[int]:
    return [x + y for x, y in zip(a, b)]


def _sub_nonneg(a: Sequence[int], b: Sequence[int]) -> List[int]:
    return [max(0, x - y) for x, y in zip(a, b)]


def _min_vec(a: Sequence[int], b: Sequence[int]) -> List[int]:
    return [min(x, y) for x, y in zip(a, b)]


class ScaleMinQuota:
    """core/scale_minquota_when_over_root_res.go:36 ScaleMinQuotaManager.

    Tracks, per parent, the min-quota sums of scaling-enabled and
    scaling-disabled children; when the distributable total drops below the
    combined min sum, enabled children's mins shrink proportionally while
    disabled children keep theirs (:99 getScaledMinQuota).
    """

    def __init__(self):
        self.enable_sums: Dict[str, List[int]] = {}
        self.disable_sums: Dict[str, List[int]] = {}
        self.original_min: Dict[str, List[int]] = {}
        self.enabled: Dict[str, bool] = {}
        # the parent each sub's min is currently registered under — a
        # re-parented quota must be subtracted from its OLD parent's sums,
        # not the new one's (:58 keys sums by the prior parent)
        self.parent_of: Dict[str, str] = {}

    def _unregister(self, sub: str) -> None:
        old_parent = self.parent_of.get(sub)
        if old_parent is None:
            return
        target = self.enable_sums if self.enabled[sub] else self.disable_sums
        target[old_parent] = _sub_nonneg(
            target[old_parent], self.original_min[sub]
        )

    def update(
        self, parent: str, sub: str, min_quota: Sequence[int], enable: bool
    ) -> None:
        """:58 update — move the child's min between the two parent sums."""
        self.enable_sums.setdefault(parent, _zeros())
        self.disable_sums.setdefault(parent, _zeros())
        self._unregister(sub)
        target = self.enable_sums if enable else self.disable_sums
        target[parent] = _add(target[parent], list(min_quota))
        self.original_min[sub] = list(min_quota)
        self.enabled[sub] = enable
        self.parent_of[sub] = parent

    def remove(self, sub: str) -> None:
        """Drop a deleted quota's contribution (delete path of :58)."""
        self._unregister(sub)
        self.original_min.pop(sub, None)
        self.enabled.pop(sub, None)
        self.parent_of.pop(sub, None)

    def get_scaled_min(
        self, new_total: Optional[Sequence[int]], parent: str, sub: str
    ) -> Tuple[bool, Optional[List[int]]]:
        """:99 getScaledMinQuota."""
        if new_total is None or sub not in self.original_min:
            return False, None
        if parent not in self.disable_sums or parent not in self.enable_sums:
            return False, None
        if not self.enabled[sub]:
            return False, None
        enable_sum = self.enable_sums[parent]
        disable_sum = self.disable_sums[parent]
        need_scale = [
            r
            for r in range(R)
            if new_total[r] < enable_sum[r] + disable_sum[r]
        ]
        original = self.original_min[sub]
        if not need_scale:
            return True, list(original)
        new_min = list(original)
        for r in need_scale:
            avail = new_total[r] - disable_sum[r]
            if avail <= 0:
                new_min[r] = 0
            elif enable_sum[r] > 0:
                # Go truncates: int64(float64(avail) * orig / enableSum)
                new_min[r] = int(avail * original[r] / enable_sum[r])
            else:
                new_min[r] = 0
        return True, new_min


@dataclasses.dataclass
class QuotaNode:
    """core/quota_info.go QuotaInfo analog (dense vectors, host-side)."""

    name: str
    parent: str = ROOT_QUOTA
    is_parent: bool = False
    allow_lent_resource: bool = True
    enable_min_quota_scale: bool = False
    shared_weight: int = 1
    min: List[int] = dataclasses.field(default_factory=_zeros)
    max: List[int] = dataclasses.field(default_factory=lambda: [1 << 60] * R)
    auto_scale_min: List[int] = dataclasses.field(default_factory=_zeros)
    guarantee: List[int] = dataclasses.field(default_factory=_zeros)
    # aggregates
    request: List[int] = dataclasses.field(default_factory=_zeros)
    child_request: List[int] = dataclasses.field(default_factory=_zeros)
    used: List[int] = dataclasses.field(default_factory=_zeros)
    non_preemptible_used: List[int] = dataclasses.field(default_factory=_zeros)
    runtime: List[int] = dataclasses.field(default_factory=_zeros)
    declared: List[int] = dataclasses.field(default_factory=list)
    # leaf pod cache: name -> pod mapping (with "requests", "priority",
    # "non_preemptible", "start_time"); assigned tracked separately like
    # quota_info.go:393 UpdatePodIsAssigned
    pods: Dict[str, Mapping] = dataclasses.field(default_factory=dict)
    assigned: Dict[str, bool] = dataclasses.field(default_factory=dict)

    def limit_request(self) -> List[int]:
        """quota_info.go:193 — request clamped to max."""
        return _min_vec(self.request, self.max)

    @classmethod
    def from_dict(cls, d: Mapping) -> "QuotaNode":
        def vec(key, default=None):
            v = d.get(key)
            if v is None:
                return default() if default else None
            return res.resource_vector(v)

        declared = sorted(
            {
                res.RESOURCE_INDEX[name]
                for key in ("min", "max")
                for name in (d.get(key) or {})
                if name in res.RESOURCE_INDEX
            }
        )
        node = cls(
            name=d["name"],
            parent=d.get("parent") or ROOT_QUOTA,
            is_parent=bool(d.get("is_parent", False)),
            allow_lent_resource=bool(d.get("allow_lent_resource", True)),
            enable_min_quota_scale=bool(d.get("enable_min_quota_scale", False)),
            shared_weight=int(d.get("shared_weight", 1)),
            declared=declared,
        )
        m = vec("min")
        if m is not None:
            node.min = m
            node.auto_scale_min = list(m)
        if d.get("max") is not None:
            # dims the max spec does not declare stay UNLIMITED (the
            # reference masks runtime to declared max dims, quota_info.go:334
            # — a dense zero would instead clamp undeclared dims shut)
            for idx, v in res.encode_resource_list(d["max"]).items():
                node.max[idx] = v
        g = vec("guarantee")
        if g is not None:
            node.guarantee = g
        return node


class GroupQuotaManager:
    """One quota tree (group_quota_manager.go:35)."""

    def __init__(self, tree_id: str = "", scale_min_enabled: bool = True):
        self.tree_id = tree_id
        self.scale_min_enabled = scale_min_enabled
        self.cluster_total: List[int] = _zeros()
        self.nodes: Dict[str, QuotaNode] = {}
        self.scale_min = ScaleMinQuota()
        self._children: Dict[str, List[str]] = {}

    # -- topology ----------------------------------------------------------
    def update_quota(self, quota: Mapping, is_delete: bool = False) -> None:
        name = quota["name"]
        if is_delete:
            if self.nodes.pop(name, None) is not None:
                self.scale_min.remove(name)
        else:
            node = QuotaNode.from_dict(quota)
            old = self.nodes.get(name)
            if old is not None:
                node.pods, node.assigned = old.pods, old.assigned
            self.nodes[name] = node
            self.scale_min.update(
                node.parent, name, node.min, node.enable_min_quota_scale
            )
        self._rebuild()

    def _rebuild(self) -> None:
        """buildSubParGroupTopoNoLock (:425): recompute the child lists and
        re-aggregate all request/used bottom-up."""
        self._children = {}
        for node in self.nodes.values():
            self._children.setdefault(node.parent, []).append(node.name)
        self._recompute_aggregates()

    def children_of(self, name: str) -> List[QuotaNode]:
        return [self.nodes[c] for c in sorted(self._children.get(name, ()))]

    def _depth_order(self) -> List[QuotaNode]:
        """Nodes deepest-first (leaves before parents)."""

        def depth(n: QuotaNode) -> int:
            d = 0
            seen = set()
            while n.parent != ROOT_QUOTA and n.parent in self.nodes:
                if n.parent in seen:
                    break  # defensive: cycles are validation errors
                seen.add(n.parent)
                n = self.nodes[n.parent]
                d += 1
            return d

        return sorted(self.nodes.values(), key=depth, reverse=True)

    def _recompute_aggregates(self) -> None:
        """Fixed point of recursiveUpdateGroupTreeWithDeltaRequest (:184)
        and updateGroupDeltaUsedNoLock (:227), recomputed bottom-up."""
        for node in self._depth_order():
            kids = self.children_of(node.name)
            if kids:
                child_request = _zeros()
                used = _zeros()
                npu = _zeros()
                for k in kids:
                    child_request = _add(child_request, k.limit_request())
                    used = _add(used, k.used)
                    npu = _add(npu, k.non_preemptible_used)
                node.child_request = child_request
                node.used = used
                node.non_preemptible_used = npu
                request = list(child_request)
            else:
                reqs = [res.resource_vector(p.get("requests") or {}) for p in node.pods.values()]
                request = _zeros()
                for v in reqs:
                    request = _add(request, v)
                node.child_request = list(request)
                used = _zeros()
                npu = _zeros()
                for pname, p in node.pods.items():
                    if node.assigned.get(pname):
                        v = res.resource_vector(p.get("requests") or {})
                        used = _add(used, v)
                        if p.get("non_preemptible"):
                            npu = _add(npu, v)
                node.used = used
                node.non_preemptible_used = npu
            if not node.allow_lent_resource:
                # no-lend groups always request at least their min (:196)
                request = [max(a, b) for a, b in zip(request, node.min)]
            node.request = request

    # -- pods --------------------------------------------------------------
    def on_pod_add(self, quota_name: str, pod: Mapping, assigned: bool = False):
        node = self._leaf(quota_name)
        node.pods[pod["name"]] = pod
        if assigned:
            node.assigned[pod["name"]] = True
        self._recompute_aggregates()

    def on_pod_delete(self, quota_name: str, pod_name: str) -> None:
        node = self._leaf(quota_name)
        node.pods.pop(pod_name, None)
        node.assigned.pop(pod_name, None)
        self._recompute_aggregates()

    def update_pod_assigned(self, quota_name: str, pod_name: str, assigned: bool):
        node = self._leaf(quota_name)
        if pod_name not in node.pods:
            raise KeyError(f"pod {pod_name} not cached in quota {quota_name}")
        node.assigned[pod_name] = assigned
        self._recompute_aggregates()

    def migrate_pod(self, pod_name: str, out: str, in_: str) -> None:
        """group_quota_manager.go:684 MigratePod."""
        src = self._leaf(out)
        pod = src.pods.get(pod_name)
        if pod is None:
            return
        assigned = src.assigned.get(pod_name, False)
        src.pods.pop(pod_name)
        src.assigned.pop(pod_name, None)
        dst = self._leaf(in_)
        dst.pods[pod_name] = pod
        if assigned:
            dst.assigned[pod_name] = True
        self._recompute_aggregates()

    def _leaf(self, quota_name: str) -> QuotaNode:
        node = self.nodes.get(quota_name)
        if node is None:
            node = self.nodes.get(DEFAULT_QUOTA)
            if node is None:
                node = QuotaNode(name=DEFAULT_QUOTA)
                self.nodes[DEFAULT_QUOTA] = node
                self._rebuild()
        return node

    # -- totals / runtime --------------------------------------------------
    def set_cluster_total(self, total: Sequence[int]) -> None:
        self.cluster_total = list(total)

    def total_except_system_default_used(self) -> List[int]:
        """group_quota_manager.go:120: total minus system+default used."""
        sys_used = _zeros()
        for special in (SYSTEM_QUOTA, DEFAULT_QUOTA):
            node = self.nodes.get(special)
            if node is not None:
                sys_used = _add(sys_used, node.used)
        return [t - u for t, u in zip(self.cluster_total, sys_used)]

    def _chain(self, name: str) -> List[QuotaNode]:
        """cur -> ... -> top-level (children of root), leaf first (:334)."""
        chain = []
        cur = self.nodes[name]
        while True:
            chain.append(cur)
            if cur.parent == ROOT_QUOTA or cur.parent not in self.nodes:
                return chain
            cur = self.nodes[cur.parent]

    def refresh_runtime(self, name: str) -> Optional[List[int]]:
        """group_quota_manager.go:264 RefreshRuntimeNoLock."""
        node = self.nodes.get(name)
        if node is None:
            return None
        if name == ROOT_QUOTA:
            return self.total_except_system_default_used()
        if name in (SYSTEM_QUOTA, DEFAULT_QUOTA):
            return list(node.max)
        chain = self._chain(name)
        total = self.total_except_system_default_used()
        for cur in reversed(chain):  # top level down to the leaf
            if self.scale_min_enabled:
                need, scaled = self.scale_min.get_scaled_min(
                    total, cur.parent, cur.name
                )
                if need and scaled is not None:
                    cur.auto_scale_min = scaled
            siblings = self.children_of(cur.parent)
            groups = [
                QuotaGroup(
                    name=s.name,
                    min=list(s.auto_scale_min),
                    max=list(s.max),
                    request=s.limit_request(),
                    used=list(s.used),
                    shared_weight=s.shared_weight,
                    guarantee=list(s.guarantee),
                    allow_lent_resource=s.allow_lent_resource,
                )
                for s in siblings
            ]
            runtimes = refresh_runtime(groups, total)
            for s, rt in zip(siblings, runtimes):
                s.runtime = rt
            total = next(
                rt for s, rt in zip(siblings, runtimes) if s.name == cur.name
            )
        # masked runtime: only dims the quota declares a max for
        # (quota_info.go:334); undeclared dims fall open host-side too
        return list(self.nodes[name].runtime)

    def leaf_quota_table(
        self, leaf_names: Sequence[str]
    ) -> List[Dict]:
        """Flatten current leaf runtimes into encode_snapshot quota dicts —
        the tree's cycle-facing output (device admission masks)."""
        out = []
        for name in leaf_names:
            node = self.nodes.get(name)
            if node is None:
                continue
            rt = self.refresh_runtime(name)
            limited = set(node.declared) | {r for r in range(R) if rt[r]}
            out.append(
                {
                    "name": name,
                    "runtime": {
                        res.RESOURCE_AXIS[r]: res.format_quantity(
                            rt[r], res.RESOURCE_AXIS[r]
                        )
                        for r in sorted(limited)
                    },
                    "limited": [res.RESOURCE_AXIS[r] for r in sorted(limited)],
                    "used": {
                        res.RESOURCE_AXIS[r]: res.format_quantity(
                            node.used[r], res.RESOURCE_AXIS[r]
                        )
                        for r in range(R)
                        if node.used[r]
                    },
                }
            )
        return out


class MultiTreeQuotaManager:
    """Default manager plus one independent manager per quota tree id
    (plugin.go ListGroupQuotaManagersForQuotaTree; MultiQuotaTree feature,
    reference pkg/features/features.go)."""

    def __init__(self, scale_min_enabled: bool = True):
        self.scale_min_enabled = scale_min_enabled
        self.default = GroupQuotaManager("", scale_min_enabled)
        self.trees: Dict[str, GroupQuotaManager] = {}

    def manager_for(self, tree_id: str = "") -> GroupQuotaManager:
        if not tree_id:
            return self.default
        if tree_id not in self.trees:
            self.trees[tree_id] = GroupQuotaManager(
                tree_id, self.scale_min_enabled
            )
        return self.trees[tree_id]

    def update_quota(self, quota: Mapping, is_delete: bool = False) -> None:
        self.manager_for(quota.get("tree", "")).update_quota(quota, is_delete)

    def managers(self) -> List[GroupQuotaManager]:
        return [self.default, *self.trees.values()]

    def all_quota_names(self) -> Dict[str, GroupQuotaManager]:
        out: Dict[str, GroupQuotaManager] = {}
        for mgr in self.managers():
            for name in mgr.nodes:
                if name in (ROOT_QUOTA, SYSTEM_QUOTA, DEFAULT_QUOTA):
                    continue
                out[name] = mgr
        return out
