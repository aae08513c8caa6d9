"""ElasticQuotaProfile -> per-node-selector ElasticQuota tree roots.

The port's own copy of ``koordinator_tpu/manager/quota_profile.py``.

Reference: ``pkg/quota-controller/profile/profile_controller.go``
(``Reconcile`` :79, ``decorateTotalResource``/``DecorateResourceByResourceRatio``
:57-271): sum the allocatable of the nodes matching the profile's node
selector, scale by the profile's resource ratio, and emit/refresh a root
ElasticQuota (min = max = scaled total) tagged with the profile's tree ID.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.manager.sloconfig import node_selector_matches
from koordinator_tpu_torch.model import resources as res

LABEL_QUOTA_TREE_ID = "quota.scheduling.koordinator.sh/tree-id"
LABEL_QUOTA_IS_ROOT = "quota.scheduling.koordinator.sh/is-root"


def sum_matching_allocatable(
    nodes: Sequence[Mapping[str, Any]],
    node_selector: Optional[Mapping[str, str]],
) -> Dict[str, int]:
    total: Dict[str, int] = {}
    for node in nodes:
        labels = node.get("labels", {})
        if node_selector and not node_selector_matches(node_selector, labels):
            continue
        for name, qty in node.get("allocatable", {}).items():
            total[name] = total.get(name, 0) + res.parse_quantity(qty, name)
    return total


def scale_total(total: Mapping[str, int], ratio: Optional[float]) -> Dict[str, int]:
    """reference ``DecorateResourceByResourceRatio`` :259-271."""
    if ratio is None:
        return dict(total)
    return {name: int(v * float(ratio)) for name, v in total.items()}


def reconcile_profile(
    profile: Mapping[str, Any],
    nodes: Sequence[Mapping[str, Any]],
) -> Dict[str, Any]:
    """Build the root ElasticQuota object for one profile."""
    spec = profile.get("spec", profile)
    total = sum_matching_allocatable(nodes, spec.get("nodeSelector", {}).get("matchLabels"))
    ratio = spec.get("resourceRatio")
    scaled = scale_total(total, float(ratio) if ratio is not None else None)
    tree_id = spec.get("treeID") or profile.get("name", "")
    # axis-unit ints must round-trip through a later parse_quantity
    quantities = {n: res.format_quantity(v, n) for n, v in scaled.items()}
    return {
        "name": spec.get("quotaName", profile.get("name", "")),
        "labels": {LABEL_QUOTA_TREE_ID: tree_id, LABEL_QUOTA_IS_ROOT: "true"},
        "min": dict(quantities),
        "max": dict(quantities),
    }


def reconcile_profiles(
    profiles: Sequence[Mapping[str, Any]],
    nodes: Sequence[Mapping[str, Any]],
) -> List[Dict[str, Any]]:
    return [reconcile_profile(p, nodes) for p in profiles]
