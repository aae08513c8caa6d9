"""Reservation restore, fit, scoring and nomination as batched tensors.

Counterpart of ``koordinator_tpu/ops/reservation.py`` (reference
``pkg/scheduler/plugins/reservation``):

* BeforePreFilter (``transformer.go:39``): a matched reservation's
  unallocated remainder returns to its node's free space for the pod;
* Filter: Aligned/Restricted policies bound the pod by the reservation's
  remainder (``plugin.go filterWithReservations``), and a pod with a
  required reservation affinity lands only on nodes holding a matched
  reservation (``plugin.go:238``);
* PreScore/Score (``scoring.go:42,105,177``): MostAllocated over the
  reservation's declared resources; the node holding the smallest nonzero
  reservation order is the preferred node and scores max.

Every reservation sits on one node, so the reference's integer einsums
over a one-hot ``[V, N]`` become sums over each reservation's node index
(``index_add_``, exact in int64 with no float step), and the per-node
nomination is a gather of each node's reservations.  None of them builds
the reference's ``[P, N, V]`` broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from koordinator_tpu_torch.model.reservation import (
    ALLOCATE_POLICY_ALIGNED,
    ALLOCATE_POLICY_RESTRICTED,
    ReservationTable,
)
from koordinator_tpu_torch.model.snapshot import MAX_NODE_SCORE
from koordinator_tpu_torch.solver.greedy import by_rows

_LONG_MAX = 2**62


def _valid_nodes(rsv: ReservationTable, num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices of the valid reservations on one of the ``num_nodes``
    nodes, ascending, i64[W]; their nodes i64[W]).  The reference's one-hot
    over the node axis drops a reservation on any other node the same
    way."""
    node = rsv.node_index.long()
    v = torch.nonzero(rsv.valid & (node >= 0) & (node < num_nodes)).squeeze(1)
    return v, node[v]


def restored_node_free(
    node_allocatable: torch.Tensor,  # i64[N, R]
    node_requested: torch.Tensor,  # i64[N, R]
    rsv: ReservationTable,
) -> torch.Tensor:
    """i64[P, N, R]: per-pod free space after restoring matched reservations.

    The reserve pseudo-pod holds the reservation's full allocatable in
    ``node_requested``; a matching pod sees the unallocated remainder of its
    matched reservations returned (transformer.go restore semantics).
    """
    base_free = node_allocatable - node_requested  # [N, R]
    P = rsv.matched.shape[0]
    v, nodes = _valid_nodes(rsv, base_free.shape[0])
    remaining = rsv.remaining[v]  # [W, R]

    def rows(sl):
        m = rsv.matched[sl][:, v].long()  # [rows, W]
        out = base_free[None].repeat(m.shape[0], 1, 1)
        out.index_add_(1, nodes, m[:, :, None] * remaining[None])
        return out

    return by_rows(rows, P, base_free.numel() * 8 + v.numel() * remaining.shape[1] * 8)


def reservation_fit_mask(
    pod_requests: torch.Tensor,  # i64[P, R]
    rsv: ReservationTable,
) -> torch.Tensor:
    """bool[P, V]: the pod can allocate from the reservation under its
    policy.  Restricted/Aligned: every declared dim of the request fits the
    remainder (plugin.go filterWithReservations); Default: always (the pod
    may spill to node free space)."""
    fits_declared = (
        ~rsv.declared[None] | (pod_requests[:, None, :] <= rsv.remaining[None])
    ).all(-1)  # [P, V]
    constrained = (rsv.allocate_policy == ALLOCATE_POLICY_ALIGNED) | (
        rsv.allocate_policy == ALLOCATE_POLICY_RESTRICTED
    )
    ok = torch.where(constrained[None, :], fits_declared, True)
    return ok & rsv.matched & rsv.valid[None, :] & ~rsv.unschedulable[None, :]


def reservation_scores(
    pod_requests: torch.Tensor,  # i64[P, R]
    rsv: ReservationTable,
) -> torch.Tensor:
    """i64[P, V]: scoreReservation (scoring.go:177), MostAllocated over the
    reservation's declared dims with all weights 1, divided by the number
    of declared dims."""
    requested = pod_requests[:, None, :] + rsv.allocated[None]
    cap = rsv.allocatable[None]
    safe_cap = torch.where(cap == 0, 1, cap)
    per_res = torch.where(
        rsv.declared[None] & (requested <= cap),
        MAX_NODE_SCORE * requested // safe_cap,
        0,
    )
    w = rsv.declared.sum(-1).clamp(min=1)[None, :]  # [1, V]
    scores = per_res.sum(-1) // w
    return torch.where(rsv.valid[None, :], scores, 0)


def reservation_affinity_mask(
    rsv: ReservationTable,
    num_nodes: int,
) -> Optional[torch.Tensor]:
    """bool[P, N] Filter for required reservation affinity (reference
    ``plugin.go:238``): a pod flagged ``affinity_required`` lands only on
    nodes holding a matched, schedulable reservation; other pods pass
    everywhere.  None when the table carries no ``affinity_required``."""
    if rsv.affinity_required is None:
        return None
    v, nodes = _valid_nodes(rsv, num_nodes)
    usable = (rsv.matched & ~rsv.unschedulable[None, :])[:, v].int()  # [P, W]
    count = torch.zeros(
        (usable.shape[0], num_nodes), dtype=torch.int32, device=usable.device
    )
    count.index_add_(1, nodes, usable)
    return (count > 0) | ~rsv.affinity_required[:, None]


def _node_slots(rsv: ReservationTable, num_nodes: int) -> torch.Tensor:
    """i64[N, K]: the valid reservations of each node in ascending index
    order, K the most on one node, padded with V (an index past the last
    reservation)."""
    V = rsv.capacity
    dev = rsv.node_index.device
    v, nodes = _valid_nodes(rsv, num_nodes)
    per_node = torch.bincount(nodes, minlength=num_nodes)
    K = max(int(per_node.max()) if v.numel() else 0, 1)
    order = torch.sort(nodes, stable=True).indices  # by node, then by index
    nodes_sorted = nodes[order]
    first = torch.cumsum(per_node, 0) - per_node  # first slot of each node
    pos = torch.arange(v.numel(), device=dev) - first[nodes_sorted]
    slots = torch.full((num_nodes, K), V, dtype=torch.long, device=dev)
    slots[nodes_sorted, pos] = v[order]
    return slots


def nominate_reservations(
    pod_requests: torch.Tensor,  # i64[P, R]
    rsv: ReservationTable,
    num_nodes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (pod, node) nomination and node score.

    Returns ``(node_scores i64[P, N], nominated i32[P, N])``, ``nominated``
    the reservation the pod would allocate on that node (-1 = none).  As
    PreScore+Score (scoring.go:42,105): among the fitting matched
    reservations on a node the highest scoreReservation wins, the lowest
    index among equals (the reference's first-maximum argmax); the node of
    the pod's fitting reservation with the smallest nonzero order label
    (the first among equals) scores ``MAX_NODE_SCORE``.

    Each (pod, reservation) cell becomes one int64 key, ``(score + 1) * V +
    (V - 1 - v)`` where it fits and 0 elsewhere, so a node's largest key
    names its highest score at its lowest index; a gather of each node's
    reservations and a max over them gives the node's nomination.
    """
    V = rsv.capacity
    slots = _node_slots(rsv, num_nodes)  # [N, K]
    node_ids = torch.arange(num_nodes, device=slots.device)[None, :]
    rev = (V - 1) - torch.arange(V, device=slots.device)

    def rows(sl):
        req = pod_requests[sl]
        fit = reservation_fit_mask(req, _rows_of(rsv, sl))  # [rows, V]
        scores = reservation_scores(req, rsv)  # [rows, V]
        key = torch.where(fit, (scores + 1) * V + rev, 0)
        key = torch.cat([key, key.new_zeros((key.shape[0], 1))], 1)  # slot V: none
        best = key[:, slots].amax(-1)  # [rows, N]
        node_scores = torch.where(best > 0, best // V - 1, 0)
        nominated = torch.where(best > 0, (V - 1) - best % V, -1).int()

        # preferred node: smallest nonzero order among the fitting matches
        order = torch.where((rsv.order != 0) & fit, rsv.order[None, :], _LONG_MAX)
        best_v = order.argmin(-1)  # the first minimum
        best_order = order.gather(1, best_v[:, None])[:, 0]
        preferred = torch.where(
            best_order < _LONG_MAX, rsv.node_index[best_v].long(), -1
        )
        node_scores = torch.where(node_ids == preferred[:, None], MAX_NODE_SCORE, node_scores)
        return node_scores, nominated

    K = slots.shape[1]
    return by_rows(rows, pod_requests.shape[0], num_nodes * K * 8 + V * pod_requests.shape[1] * 8)


def _rows_of(rsv: ReservationTable, rows: slice) -> ReservationTable:
    """The table with its per-pod fields cut to the pod rows ``rows``."""
    return dataclasses.replace(
        rsv,
        matched=rsv.matched[rows],
        affinity_required=(
            None if rsv.affinity_required is None else rsv.affinity_required[rows]
        ),
    )
