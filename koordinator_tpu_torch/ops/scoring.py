"""Resource-allocation scorers in exact int64 floor-division math.

Counterpart of ``koordinator_tpu/ops/scoring.py`` (reference
``nodenumaresource/least_allocated.go:49-58``, ``most_allocated.go:46-63``,
the weighted ``sum(score*weight)/weightSum`` of ``least_allocated.go:31-44``).
Shape-polymorphic over leading batch dims; ``least_allocated_scores`` and
``most_allocated_scores`` score every (pod, node) pair as if the pod were
placed (upstream NodeResourcesFit).
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.model.snapshot import MAX_NODE_SCORE


def least_requested_score(
    requested: torch.Tensor, capacity: torch.Tensor
) -> torch.Tensor:
    """((capacity-requested)*MaxNodeScore)//capacity; 0 if cap==0 or req>cap."""
    requested = requested.long()
    capacity = capacity.long()
    empty = capacity == 0
    score = ((capacity - requested) * MAX_NODE_SCORE) // torch.where(empty, 1, capacity)
    return torch.where(empty | (requested > capacity), 0, score)


def most_requested_score(
    requested: torch.Tensor, capacity: torch.Tensor
) -> torch.Tensor:
    """(min(requested,capacity)*MaxNodeScore)//capacity; 0 if cap==0."""
    requested = requested.long()
    capacity = capacity.long()
    empty = capacity == 0
    score = (torch.minimum(requested, capacity) * MAX_NODE_SCORE) // torch.where(
        empty, 1, capacity)
    return torch.where(empty, 0, score)


def weighted_resource_score(
    per_resource_score: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """sum_r(score_r * weight_r) // sum_r(weight_r); 0 when the weights sum
    to 0.  ``per_resource_score``: i64[..., R]; ``weights``: i64[R]."""
    weights = weights.long()
    weight_sum = weights.sum()
    total = (per_resource_score * weights).sum(-1)
    out = total // weight_sum.clamp(min=1)
    return torch.where(weight_sum == 0, 0, out)


def least_allocated_scores(
    pod_requests: torch.Tensor,  # i64[P, R]
    node_requested: torch.Tensor,  # i64[N, R]
    node_allocatable: torch.Tensor,  # i64[N, R]
    weights: torch.Tensor,  # i64[R]
) -> torch.Tensor:
    """NodeResourcesFit/LeastAllocated over all (pod, node) pairs -> i64[P, N]:
    each weighted resource scored as if the pod were placed (requested +
    pod request against allocatable)."""
    total = node_requested[None, :, :] + pod_requests[:, None, :]
    scores = least_requested_score(total, node_allocatable[None, :, :])
    return weighted_resource_score(scores, weights)


def most_allocated_scores(
    pod_requests: torch.Tensor,
    node_requested: torch.Tensor,
    node_allocatable: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """The MostAllocated (bin-packing) variant -> i64[P, N]."""
    total = node_requested[None, :, :] + pod_requests[:, None, :]
    scores = most_requested_score(total, node_allocatable[None, :, :])
    return weighted_resource_score(scores, weights)
