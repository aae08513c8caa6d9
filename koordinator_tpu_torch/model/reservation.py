"""Reservation data model: reservations as dense tables + owner matching.

Counterpart of ``koordinator_tpu/model/reservation.py``.  The reference
models a Reservation as a pseudo-pod occupying its reserved resources on a
node, restored into NodeInfo per scheduling pod by the transformer
(reference ``pkg/scheduler/plugins/reservation/transformer.go:39
BeforePreFilter``).  Here a cycle carries one ``ReservationTable`` with a
host-computed ``matched[P, V]`` owner matrix, and the restore is a sum
over each reservation's node (``koordinator_tpu_torch.ops.reservation``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import pad_bucket, tensors_to

# Allocate policies (reference apis/scheduling/v1alpha1/reservation_types.go
# ReservationAllocatePolicy)
ALLOCATE_POLICY_DEFAULT = 0
ALLOCATE_POLICY_ALIGNED = 1
ALLOCATE_POLICY_RESTRICTED = 2


@dataclasses.dataclass(frozen=True)
class ReservationTable:
    """Dense reservation state, shapes [V] / [V, R] (+ matched [P, V]).

    ``remaining = allocatable - allocated`` is what a matching pod may take;
    ``declared`` marks the nonzero allocatable dims (the reference scores
    and restricts only over ``quotav1.RemoveZeros(allocatable)``,
    scoring.go:186).  ``affinity_required`` flags pods carrying a REQUIRED
    reservation affinity: such a pod may only land on nodes holding a
    matched reservation (reference plugin.go:238).  ``names``/``uids`` are
    host metadata for the reservation-allocated annotation
    (``SetReservationAllocated``, apis/extension/reservation.go:86-97).
    """

    node_index: torch.Tensor  # i32[V] node the reservation is bound to, -1 unbound
    allocatable: torch.Tensor  # i64[V, R]
    allocated: torch.Tensor  # i64[V, R] already taken by owner pods
    declared: torch.Tensor  # bool[V, R]
    allocate_policy: torch.Tensor  # i32[V] ALLOCATE_POLICY_*
    order: torch.Tensor  # i64[V] LabelReservationOrder, 0 = unset
    unschedulable: torch.Tensor  # bool[V]
    valid: torch.Tensor  # bool[V]
    matched: torch.Tensor  # bool[P, V] owner match per pending pod
    affinity_required: Optional[torch.Tensor] = None  # bool[P]
    names: Tuple[str, ...] = ()
    uids: Tuple[str, ...] = ()

    @property
    def capacity(self) -> int:
        return self.allocatable.shape[0]

    @property
    def remaining(self) -> torch.Tensor:
        return self.allocatable - self.allocated

    def to(self, device) -> "ReservationTable":
        return tensors_to(self, device)


def match_owners(pod: Mapping, owners: Sequence[Mapping]) -> bool:
    """reference ``pkg/util/reservation`` MatchReservationOwners: a pod may
    allocate a reservation if any owner entry matches — by exact object
    reference (namespace/name), controller reference, or label selector.
    """
    for owner in owners or ():
        obj = owner.get("object")
        if obj is not None:
            if obj.get("name") == pod.get("name") and obj.get(
                "namespace", "default"
            ) == pod.get("namespace", "default"):
                return True
            continue
        controller = owner.get("controller")
        if controller is not None:
            ref = pod.get("owner_ref") or {}
            if controller.get("name") == ref.get("name") and controller.get(
                "namespace", pod.get("namespace", "default")
            ) == pod.get("namespace", "default"):
                return True
            continue
        selector = owner.get("label_selector")
        if selector is not None:
            labels = pod.get("labels", {})
            if all(labels.get(k) == v for k, v in selector.items()):
                return True
    return False


_POLICY_NAMES = {
    "Default": ALLOCATE_POLICY_DEFAULT,
    "Aligned": ALLOCATE_POLICY_ALIGNED,
    "Restricted": ALLOCATE_POLICY_RESTRICTED,
}

# reference apis/extension/reservation.go:40
RESERVATION_AFFINITY_ANNOTATION = (
    "scheduling.koordinator.sh/reservation-affinity"
)


#: sentinel for a present-but-unparseable affinity annotation: the pod
#: REQUIRES reservation affinity but can match nothing — it schedules
#: nowhere through reservations, mirroring the reference's per-pod
#: rejection (GetReservationAffinity error -> PreFilter Unschedulable)
#: without aborting the whole table encode.
INVALID_AFFINITY = object()


def required_reservation_affinity(pod: Mapping):
    """Parse the pod's ReservationAffinity annotation (the reference's
    exact key and JSON shape, apis/extension/reservation.go:48-68):
    ``{"reservationSelector": {k: v}, "requiredDuringScheduling...":
    {"reservationSelectorTerms": [{"matchExpressions": [...]}]}}``.
    Returns the parsed dict, None when the pod has no affinity, or
    ``INVALID_AFFINITY`` when the annotation is present but malformed
    (one bad pod must not abort encoding every other pod's table)."""
    import json

    raw = (pod.get("annotations") or {}).get(RESERVATION_AFFINITY_ANNOTATION)
    if not raw:
        return None
    if isinstance(raw, Mapping):
        return raw
    try:
        parsed = json.loads(raw)
    except ValueError:
        return INVALID_AFFINITY
    return parsed if isinstance(parsed, Mapping) else INVALID_AFFINITY


def _match_expressions(labels: Mapping, exprs: Sequence[Mapping]) -> bool:
    """corev1.NodeSelectorTerm matchExpressions over reservation labels
    (terms reuse the node-selector operators; GetReservationAffinity
    validates the same set)."""
    for e in exprs or ():
        key = e.get("key")
        op = e.get("operator")
        values = e.get("values") or []
        have = key in labels
        val = labels.get(key)
        if op == "In":
            if not (have and val in values):
                return False
        elif op == "NotIn":
            if have and val in values:
                return False
        elif op == "Exists":
            if not have:
                return False
        elif op == "DoesNotExist":
            if have:
                return False
        else:
            return False  # unknown operator: fail closed, like validation
    return True


def matches_reservation_affinity(
    affinity: Mapping, reservation_labels: Mapping
) -> bool:
    """reference pkg/util/reservation GetRequiredReservationAffinity +
    ReservationAffinity.Match: the flat ``reservationSelector`` map must
    all match; selector TERMS are ORed."""
    selector = affinity.get("reservationSelector")
    if selector:
        if not all(reservation_labels.get(k) == v for k, v in selector.items()):
            return False
    required = affinity.get(
        "requiredDuringSchedulingIgnoredDuringExecution"
    )
    terms = (required or {}).get("reservationSelectorTerms")
    if terms:
        return any(
            _match_expressions(reservation_labels, t.get("matchExpressions"))
            for t in terms
        )
    return True


def encode_reservations(
    reservations: Sequence[Mapping],
    pods: Sequence[Mapping],
    node_names: Sequence[str],
    *,
    pod_bucket: Optional[int] = None,
    reservation_bucket: Optional[int] = None,
    device=None,
) -> ReservationTable:
    """Encode reservation dicts + pending pods into a ReservationTable on
    ``device``.

    Reservation dict: ``{"name", "node": node-name, "allocatable": {...},
    "allocated": {...}, "owners": [...], "labels": {...},
    "allocate_policy": "Default"|"Aligned"|"Restricted", "order": int,
    "allocate_once": bool, "assigned_pods": int, "unschedulable": bool}``.

    AllocateOnce reservations that already have assigned pods are dropped
    from the table entirely (the reference skips them during restore,
    transformer.go:95).

    A pod carrying the ReservationAffinity annotation (the reference's
    exact key ``scheduling.koordinator.sh/reservation-affinity``) matches
    only reservations whose LABELS satisfy its selector, and is flagged
    in ``affinity_required`` — the ReservationPlugin's filter then admits
    it only onto nodes holding a matched reservation (plugin.go:238).
    """
    dev = resolve_device(device)
    active = [
        r
        for r in reservations
        if not (r.get("allocate_once") and r.get("assigned_pods", 0) > 0)
    ]
    v_bucket = reservation_bucket or pad_bucket(max(len(active), 1))
    p_bucket = pod_bucket or pad_bucket(max(len(pods), 1))
    R = res.NUM_RESOURCES
    node_idx = {n: i for i, n in enumerate(node_names)}

    node_index = np.full((v_bucket,), -1, np.int32)
    alloc = np.zeros((v_bucket, R), np.int64)
    allocated = np.zeros((v_bucket, R), np.int64)
    declared = np.zeros((v_bucket, R), bool)
    policy = np.zeros((v_bucket,), np.int32)
    order = np.zeros((v_bucket,), np.int64)
    unsched = np.zeros((v_bucket,), bool)
    valid = np.zeros((v_bucket,), bool)
    matched = np.zeros((p_bucket, v_bucket), bool)

    affinity_required = np.zeros((p_bucket,), bool)
    pod_affinity = [required_reservation_affinity(pod) for pod in pods]
    for p, aff in enumerate(pod_affinity):
        affinity_required[p] = aff is not None

    for i, r in enumerate(active):
        node_index[i] = node_idx.get(r.get("node"), -1)
        alloc[i] = res.resource_vector(r.get("allocatable", {}))
        allocated[i] = res.resource_vector(r.get("allocated", {}))
        declared[i] = alloc[i] != 0
        policy[i] = _POLICY_NAMES.get(r.get("allocate_policy", "Default"), 0)
        order[i] = int(r.get("order", 0))
        unsched[i] = bool(r.get("unschedulable"))
        valid[i] = node_index[i] >= 0
        rlabels = r.get("labels", {})
        for p, pod in enumerate(pods):
            ok = valid[i] and match_owners(pod, r.get("owners", ()))
            if ok and pod_affinity[p] is not None:
                # malformed affinity: required with zero matches (the
                # pod alone becomes unschedulable via reservations)
                ok = pod_affinity[p] is not INVALID_AFFINITY and (
                    matches_reservation_affinity(pod_affinity[p], rlabels)
                )
            matched[p, i] = ok

    def t(a):
        return torch.from_numpy(a).to(dev)

    return ReservationTable(
        node_index=t(node_index),
        allocatable=t(alloc),
        allocated=t(allocated),
        declared=t(declared),
        allocate_policy=t(policy),
        order=t(order),
        unschedulable=t(unsched),
        valid=t(valid),
        matched=t(matched),
        affinity_required=t(affinity_required),
        names=tuple(r.get("name", f"rsv-{i}") for i, r in enumerate(active)),
        uids=tuple(str(r.get("uid", "")) for r in active),
    )
