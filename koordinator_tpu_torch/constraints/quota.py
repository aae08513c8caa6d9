"""ElasticQuota runtime fair division.

Host-side exact mirror of the reference's RuntimeQuotaCalculator
(``pkg/scheduler/plugins/elasticquota/core/runtime_quota_calculator.go``):

* ``redistribution`` (:109-141): each group's runtime starts at
  ``min(max(min, guarantee), request)`` — groups requesting more than their
  (auto-scaled) min are capped at min and share the leftover by
  ``sharedWeight``; groups under min keep ``request`` if they lend unused
  quota (``allowLentResource``), else their full min.
* ``iterationForRedistribution`` (:143-155): leftover is split
  proportionally to sharedWeight, iterating until no group is left short or
  nothing remains (surplus handed back by satisfied groups re-enters).

The division runs per resource dimension over a flat list of sibling groups
(one quotaTree per resource, as in the reference).  The result feeds the
device-side ``QuotaTable.runtime`` caps used as admission masks; the
stateful tree itself stays host-side, exactly like the reference keeps it in
the GroupQuotaManager (``core/group_quota_manager.go:35``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Sequence

from koordinator_tpu_torch.model import resources as res


@dataclasses.dataclass
class QuotaGroup:
    """One ElasticQuota group (a child of a single parent in the tree)."""

    name: str
    min: List[int]  # dense resource vector
    max: List[int]
    request: List[int]  # current demand (sum of member pod requests)
    used: List[int]
    shared_weight: int = 1
    guarantee: List[int] = dataclasses.field(
        default_factory=lambda: [0] * res.NUM_RESOURCES
    )
    allow_lent_resource: bool = True
    # resource dims the quota spec declares (indices into RESOURCE_AXIS);
    # admission applies only to these.  A declared dim with runtime 0
    # admits nothing: the reference's RefreshRuntime emits declared dims
    # with an explicit 0 that quotav1.LessThanOrEqual then compares
    # against (undeclared dims are simply absent and fall open).
    declared: List[int] = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "QuotaGroup":
        def vec(key):
            return res.resource_vector(d.get(key, {}) or {})

        declared = sorted(
            {
                res.RESOURCE_INDEX[name]
                for key in ("min", "max")
                for name in (d.get(key, {}) or {})
                if name in res.RESOURCE_INDEX
            }
        )
        return cls(
            name=d["name"],
            min=vec("min"),
            max=vec("max"),
            request=vec("request"),
            used=vec("used"),
            shared_weight=int(d.get("shared_weight", 1)),
            guarantee=vec("guarantee"),
            allow_lent_resource=bool(d.get("allow_lent_resource", True)),
            declared=declared,
        )


def _redistribute_one_resource(
    groups: Sequence[QuotaGroup], r: int, total: int
) -> List[int]:
    """runtime_quota_calculator.go:109-141, one resource dimension."""
    runtime = [0] * len(groups)
    to_partition = total
    total_shared_weight = 0
    need_adjust: List[int] = []
    for i, g in enumerate(groups):
        gmin = max(g.min[r], g.guarantee[r])
        request = min(g.request[r], g.max[r])  # request never exceeds max
        if request > gmin:
            need_adjust.append(i)
            total_shared_weight += g.shared_weight
            runtime[i] = gmin
        else:
            runtime[i] = request if g.allow_lent_resource else gmin
        to_partition -= runtime[i]

    # iterationForRedistribution (:143-155)
    while to_partition > 0 and total_shared_weight > 0 and need_adjust:
        still_short: List[int] = []
        next_weight = 0
        surplus = 0
        for i in need_adjust:
            g = groups[i]
            delta = int(
                math.floor(g.shared_weight * to_partition / total_shared_weight + 0.5)
            )
            runtime[i] += delta
            request = min(g.request[r], g.max[r])
            if runtime[i] < request:
                still_short.append(i)
                next_weight += g.shared_weight
            else:
                surplus += runtime[i] - request
                runtime[i] = request
        to_partition = surplus
        total_shared_weight = next_weight
        need_adjust = still_short

    # runtime never exceeds max
    for i, g in enumerate(groups):
        runtime[i] = min(runtime[i], g.max[r])
    return runtime


def refresh_runtime(
    groups: Sequence[QuotaGroup], total_resource: Sequence[int]
) -> List[List[int]]:
    """Compute each sibling group's runtimeQuota vector for the given total.

    ``total_resource`` is the parent's distributable quantity per resource
    (cluster total for root-level trees).
    """
    runtimes = [[0] * res.NUM_RESOURCES for _ in groups]
    for r in range(res.NUM_RESOURCES):
        if total_resource[r] == 0 and not any(g.request[r] for g in groups):
            continue
        col = _redistribute_one_resource(groups, r, int(total_resource[r]))
        for i, v in enumerate(col):
            runtimes[i][r] = v
    return runtimes


def build_quota_table_inputs(
    quota_dicts: Sequence[Mapping],
    pod_requests: Sequence[Sequence[int]],
    pod_quota_ids: Sequence[int],
    total_resource: Sequence[int],
) -> List[Dict]:
    """Aggregate per-group demand, run fair division, emit encode_snapshot
    quota dicts with dense ``runtime``/``used`` vectors.
    """
    groups = [QuotaGroup.from_dict(d) for d in quota_dicts]
    for req, qid in zip(pod_requests, pod_quota_ids):
        if 0 <= qid < len(groups):
            for r in range(res.NUM_RESOURCES):
                groups[qid].request[r] += req[r]
    runtimes = refresh_runtime(groups, total_resource)
    out = []
    for g, rt in zip(groups, runtimes):
        # Emit every *declared* dimension, including runtime 0: the
        # reference's RefreshRuntime keeps declared dims with explicit
        # zeros, so admission rejects on them; only undeclared dims are
        # absent from the runtime list and fall open.
        limited = set(g.declared) | {r for r in range(res.NUM_RESOURCES) if rt[r]}
        out.append(
            {
                "name": g.name,
                # values are in axis units already; render them as
                # round-trippable quantities ("...Mi"/"...m") so
                # encode_snapshot's parse_quantity doesn't re-divide
                # byte-denominated lanes by MiB
                "runtime": {
                    res.RESOURCE_AXIS[r]: res.format_quantity(
                        rt[r], res.RESOURCE_AXIS[r]
                    )
                    for r in sorted(limited)
                },
                "limited": [res.RESOURCE_AXIS[r] for r in sorted(limited)],
                "used": {
                    res.RESOURCE_AXIS[r]: res.format_quantity(
                        g.used[r], res.RESOURCE_AXIS[r]
                    )
                    for r in range(res.NUM_RESOURCES)
                    if g.used[r]
                },
            }
        )
    return out
