"""ClusterColocationProfile pod mutation (the mutating-webhook analog).

The port's own copy of ``koordinator_tpu/manager/profile.py``.

Reference: ``pkg/webhook/pod/mutating/cluster_colocation_profile.go``
(``doMutateByColocationProfile`` :157, ``mutatePodResourceSpec`` :221,
``replaceAndEraseResource`` :247): a matching profile stamps labels /
annotations / scheduler name / QoS / priority onto the pod, and non-prod
pods get their native cpu/memory requests translated to the extended
batch/mid resources so the scheduler fits them against overcommitted
capacity.

Pods are plain dicts (same shape the harness generators produce).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Sequence

from koordinator_tpu_torch.manager.noderesource import (
    PRIORITY_BATCH,
    PRIORITY_MID,
    priority_class_of,
)
from koordinator_tpu_torch.model import resources as res

LABEL_POD_QOS = "koordinator.sh/qosClass"
LABEL_POD_PRIORITY = "koordinator.sh/priority"

# reference ``apis/extension/resource.go ResourceNameMap``: which extended
# resource a native cpu/memory request becomes, per priority class.
RESOURCE_NAME_MAP = {
    PRIORITY_BATCH: {res.CPU: res.BATCH_CPU, res.MEMORY: res.BATCH_MEMORY},
    PRIORITY_MID: {res.CPU: res.MID_CPU, res.MEMORY: res.MID_MEMORY},
}


def selector_matches(selector: Optional[Mapping[str, Any]], labels: Mapping[str, str]) -> bool:
    """matchLabels + matchExpressions(In/NotIn/Exists/DoesNotExist)."""
    if selector is None:
        return True
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or ():
        key, op = expr["key"], expr["operator"]
        values = expr.get("values", ())
        if op == "In" and labels.get(key) not in values:
            return False
        if op == "NotIn" and labels.get(key) in values:
            return False
        if op == "Exists" and key not in labels:
            return False
        if op == "DoesNotExist" and key in labels:
            return False
    return True


def apply_profile(pod: Mapping[str, Any], profile: Mapping[str, Any]) -> Dict[str, Any]:
    """Return a mutated copy of ``pod`` with the profile applied
    (reference ``doMutateByColocationProfile`` :157-218)."""
    out = copy.deepcopy(dict(pod))
    spec = profile.get("spec", profile)
    labels = dict(out.get("labels", {}))
    annotations = dict(out.get("annotations", {}))
    labels.update(spec.get("labels", {}))
    annotations.update(spec.get("annotations", {}))
    if spec.get("schedulerName"):
        out["scheduler_name"] = spec["schedulerName"]
    if spec.get("qosClass"):
        labels[LABEL_POD_QOS] = spec["qosClass"]
        out["qos"] = spec["qosClass"]
    if spec.get("priorityClassName"):
        out["priority_class"] = spec["priorityClassName"]
        if "priorityClassValue" in spec:
            out["priority"] = spec["priorityClassValue"]
    if spec.get("koordinatorPriority") is not None:
        labels[LABEL_POD_PRIORITY] = str(spec["koordinatorPriority"])
    out["labels"] = labels
    out["annotations"] = annotations
    return out


def mutate_pod_resources(pod: Mapping[str, Any]) -> Dict[str, Any]:
    """Translate native cpu/memory requests+limits to extended batch/mid
    resources for batch/mid pods (reference ``mutatePodResourceSpec``
    :221-244; cpu becomes integer *milli* quantities, ``:255-258``).
    Prod/none — and free, which has no ResourceNameMap entry
    (``apis/extension/resource.go:40``) — pass through unchanged."""
    pc = priority_class_of(pod)
    name_map = RESOURCE_NAME_MAP.get(pc)
    if name_map is None:
        return dict(pod)
    out = copy.deepcopy(dict(pod))
    for section in ("requests", "limits"):
        rl = out.get(section)
        if not rl:
            continue
        for native, extended in name_map.items():
            if native in rl:
                qty = res.parse_quantity(rl.pop(native), native)
                # axis units (milli / MiB) must round-trip through a
                # second parse when the mutated pod is encoded again
                rl[extended] = res.format_quantity(qty, extended)
    return out


def mutate_by_profiles(
    pod: Mapping[str, Any],
    profiles: Sequence[Mapping[str, Any]],
    namespace_labels: Optional[Mapping[str, str]] = None,
) -> Dict[str, Any]:
    """Apply every matching profile in name order then the resource
    translation, mirroring the webhook handler's flow."""
    out = dict(pod)
    pod_labels = out.get("labels", {})
    for profile in sorted(profiles, key=lambda p: p.get("name", "")):
        spec = profile.get("spec", profile)
        if not selector_matches(spec.get("namespaceSelector"), namespace_labels or {}):
            continue
        if not selector_matches(spec.get("selector"), pod_labels):
            continue
        out = apply_profile(out, profile)
        pod_labels = out.get("labels", {})
    return mutate_pod_resources(out)
