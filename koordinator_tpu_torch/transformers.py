"""Informer-level object transformers (trim + rename rewrites).

The port's own copy of ``koordinator_tpu/transformers.py``.

Reference ``pkg/util/transformer`` — hooked into every informer with
``SetTransform`` before objects reach the caches
(``transformers.go:31-36``, installed by
``cmd/koord-scheduler/app/server.go``):

* pods/nodes/quotas carrying DEPRECATED resource names
  (``koordinator.sh/batch-cpu``, ``koordinator.sh/gpu`` families) are
  rewritten to the canonical names (``pod_transformer.go:63``,
  ``node_transformer.go:68-75``, ``elastic_quota_transformer.go:65``);
* node allocatable is trimmed by the node-reservation annotation
  (``node_transformer.go:64`` -> ``util.TrimNodeAllocatableByNodeReservation``,
  non-negative subtraction, Default apply policy only);
* memory-heavy fields nobody downstream reads are dropped (the informer
  trim role).

Here the transforms run where objects enter the system: callers pass
node/pod/quota dicts through ``transform_node``/``transform_pod``/
``transform_elastic_quota`` (or ``transform_cluster``) before
``encode_snapshot``/``build_sync_request``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional, Tuple

from koordinator_tpu_torch.model import resources as res

# apis/extension/deprecated.go:48-60
DEPRECATED_BATCH = {
    "koordinator.sh/batch-cpu": res.BATCH_CPU,
    "koordinator.sh/batch-memory": res.BATCH_MEMORY,
}
# deprecated device names use the kubernetes.io/ prefix
# (apis/extension/deprecated.go:28-38: ResourceDomainPrefix)
DEPRECATED_DEVICE = {
    "kubernetes.io/rdma": res.RDMA,
    "kubernetes.io/fpga": res.FPGA,
    "kubernetes.io/gpu-core": res.GPU_CORE,
    "kubernetes.io/gpu-memory": res.GPU_MEMORY,
    "kubernetes.io/gpu-memory-ratio": res.GPU_MEMORY_RATIO,
}
_MAPPERS = {**DEPRECATED_BATCH, **DEPRECATED_DEVICE}

ANNOTATION_NODE_RESERVATION = "node.koordinator.sh/reservation"

# fields the informer trim drops (managed fields dominate apiserver object
# size; the reference SetTransform exists chiefly to shed them)
_TRIM_FIELDS = ("managed_fields", "managedFields", "last_applied")


def _rename_resources(rl: Optional[Mapping]) -> Optional[Dict]:
    if not rl:
        return dict(rl) if rl is not None else None
    out = {}
    for name, qty in rl.items():
        canonical = _MAPPERS.get(name, name)
        # canonical name wins when both are present (replaceAndErase
        # semantics: the deprecated entry is erased, never overwrites)
        if canonical in rl and canonical != name:
            continue
        out[canonical] = qty
    return out


def transform_pod(pod: Mapping) -> Dict:
    """pod_transformer.go:39 TransformPod: deprecated batch/device resource
    renames in requests/limits + informer trim."""
    out = {k: v for k, v in pod.items() if k not in _TRIM_FIELDS}
    for field in ("requests", "limits"):
        if field in out:
            out[field] = _rename_resources(out[field])
    return out


def transform_node(node: Mapping) -> Dict:
    """node_transformer.go:40 TransformNode: reservation trim on
    allocatable + deprecated renames on allocatable/capacity."""
    out = {k: v for k, v in node.items() if k not in _TRIM_FIELDS}
    for field in ("allocatable", "capacity"):
        if field in out:
            out[field] = _rename_resources(out[field])
    reservation = _node_reservation(out.get("annotations") or {})
    if reservation and out.get("allocatable"):
        policy = reservation.get("applyPolicy", "")
        if policy in ("", "Default"):
            reserved = reservation.get("resources") or {}
            out["allocatable"] = _subtract_non_negative(
                out["allocatable"], reserved
            )
    return out


def transform_elastic_quota(quota: Mapping) -> Dict:
    """elastic_quota_transformer.go:43: deprecated renames in min/max."""
    out = {k: v for k, v in quota.items() if k not in _TRIM_FIELDS}
    for field in ("min", "max", "used"):
        if field in out:
            out[field] = _rename_resources(out[field])
    return out


def transform_cluster(
    nodes: List[Mapping],
    pods: List[Mapping],
    quotas: List[Mapping] = (),
) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    """Apply every transformer, the SetupTransformers flow."""
    return (
        [transform_node(n) for n in nodes],
        [transform_pod(p) for p in pods],
        [transform_elastic_quota(q) for q in quotas],
    )


def _node_reservation(annotations: Mapping) -> Optional[Dict]:
    raw = annotations.get(ANNOTATION_NODE_RESERVATION)
    if not raw:
        return None
    if isinstance(raw, Mapping):
        return dict(raw)
    try:
        return json.loads(raw)
    except (TypeError, ValueError):
        return None  # a bad annotation must not drop the node


def _subtract_non_negative(allocatable: Mapping, reserved: Mapping) -> Dict:
    """quotav1.SubtractWithNonNegativeResult over quantity dicts, exact in
    axis units then rendered back (format_quantity round-trip)."""
    out = dict(allocatable)
    for name, qty in reserved.items():
        if name not in out:
            continue
        have = res.parse_quantity(out[name], name)
        take = res.parse_quantity(qty, name)
        out[name] = res.format_quantity(max(0, have - take), name)
    return out
