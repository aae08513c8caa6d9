"""Validating admission: pod QoS/priority/resource rules + quota tree guard.

The port's own copy of ``koordinator_tpu/manager/validating.py``.

Reference: ``pkg/webhook/pod/validating/cluster_colocation_profile.go:35``
(required BE QoS with batch resources, immutable QoS/priority, forbidden
QoS+priorityClass combos, LSR/LSE integer-CPU requirement) and
``pkg/webhook/elasticquota`` (quota tree topology checks: parent exists,
min <= max, children min sum <= parent min).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.model import resources as res

LABEL_POD_QOS = "koordinator.sh/qosClass"
LABEL_POD_PRIORITY = "koordinator.sh/priority"

# forbidden QoS / priority-class combinations
# (cluster_colocation_profile.go:58-59)
_FORBIDDEN = {
    "BE": {"", "koord-prod"},  # BE + None/Prod forbidden
    "LSR": {"", "koord-mid", "koord-batch", "koord-free"},
    "LSE": {"", "koord-mid", "koord-batch", "koord-free"},
}


def _safe_parse(rl: Mapping, errs: List[str], where: str) -> Dict[str, int]:
    """Parse a resource list; malformed quantities become admission error
    strings (the reference denies with a field error, never crashes)."""
    out: Dict[str, int] = {}
    for name, qty in (rl or {}).items():
        try:
            out[name] = res.parse_quantity(qty, name)
        except ValueError:
            errs.append(f"{where}[{name}]: unparseable quantity {qty!r}")
    return out


def validate_pod(
    pod: Mapping[str, Any], old_pod: Optional[Mapping[str, Any]] = None
) -> List[str]:
    """Returns error strings; empty = admitted."""
    errs: List[str] = []
    labels = pod.get("labels") or {}
    qos = labels.get(LABEL_POD_QOS, pod.get("qos", ""))
    priority_class = pod.get("priority_class", "") or ""
    requests = _safe_parse(pod.get("requests") or {}, errs, "requests")

    if old_pod is not None:
        old_labels = old_pod.get("labels") or {}
        if old_labels.get(LABEL_POD_QOS, old_pod.get("qos", "")) != qos:
            errs.append(f"labels.{LABEL_POD_QOS}: field is immutable")
        if (old_pod.get("priority_class") or "") != priority_class:
            errs.append("spec.priority: field is immutable")
        if old_labels.get(LABEL_POD_PRIORITY) != labels.get(LABEL_POD_PRIORITY):
            errs.append(f"labels.{LABEL_POD_PRIORITY}: field is immutable")

    # batch resources require QoS BE (validateRequiredQoSClass)
    if (
        requests.get(res.BATCH_CPU, 0) or requests.get(res.BATCH_MEMORY, 0)
    ) and qos != "BE":
        errs.append(
            f"labels.{LABEL_POD_QOS}: must specify koordinator QoS BE with "
            "koordinator colocation resources"
        )

    # forbidden combos (forbidSpecialQoSClassAndPriorityClass)
    if priority_class in _FORBIDDEN.get(qos, ()):  # "" = PriorityNone
        errs.append(
            f"{LABEL_POD_QOS}={qos} and priorityClass={priority_class or 'none'} "
            "cannot be used in combination"
        )

    # LSR/LSE need integer CPU (validateResources)
    if qos in ("LSR", "LSE"):
        cpu_milli = requests.get(res.CPU, 0)
        if cpu_milli == 0:
            errs.append("LSR Pod must declare the requested CPUs")
        elif cpu_milli % 1000 != 0:
            errs.append("the requested CPUs of LSR Pod must be integer")
    return errs


def validate_quota_tree(quotas: Sequence[Mapping[str, Any]]) -> List[str]:
    """ElasticQuota topology guard (pkg/webhook/elasticquota): every
    parent exists, min <= max per dimension, and each parent's min covers
    the sum of its children's min."""
    errs: List[str] = []
    by_name = {q["name"]: q for q in quotas}

    def vec(m, where):
        return _safe_parse(m or {}, errs, where)

    children: Dict[str, List[str]] = {}
    for q in quotas:
        name = q["name"]
        parent = q.get("parent")
        if parent:
            if parent not in by_name:
                errs.append(f"{name}: parent quota {parent} does not exist")
            else:
                children.setdefault(parent, []).append(name)
        mn, mx = vec(q.get("min"), f"{name}.min"), vec(q.get("max"), f"{name}.max")
        for dim, v in mn.items():
            if dim in mx and v > mx[dim]:
                errs.append(f"{name}: min[{dim}] {v} exceeds max {mx[dim]}")

    for parent, kids in children.items():
        pmin = vec(by_name[parent].get("min"), f"{parent}.min") if parent in by_name else {}
        total: Dict[str, int] = {}
        for kid in kids:
            for dim, v in vec(by_name[kid].get("min"), f"{kid}.min").items():
                total[dim] = total.get(dim, 0) + v
        for dim, v in total.items():
            if v > pmin.get(dim, 0):
                errs.append(
                    f"{parent}: children min sum {v} exceeds parent min "
                    f"{pmin.get(dim, 0)} for {dim}"
                )
    return errs


def validate_node_colocation(node: Mapping[str, Any]) -> List[str]:
    """Node validating webhook (pkg/webhook/node): batch allocatable must
    not exceed node capacity."""
    errs: List[str] = []
    cap = _safe_parse(node.get("capacity") or {}, errs, "capacity")
    alloc = _safe_parse(node.get("allocatable") or {}, errs, "allocatable")
    pairs = [(res.BATCH_CPU, res.CPU), (res.BATCH_MEMORY, res.MEMORY)]
    for batch_name, native_name in pairs:
        b = alloc.get(batch_name, 0)
        c = cap.get(native_name, 0)
        if b and c and b > c:
            errs.append(
                f"{batch_name} allocatable {b} exceeds node {native_name} "
                f"capacity {c}"
            )
    return errs
