"""NodeNUMAResource fit and scoring as batched zone tensors.

Counterpart of ``koordinator_tpu/ops/numa.py``.  The reference's Score runs
a full NUMA allocation per (pod, node) on the host (reference
``pkg/scheduler/plugins/nodenumaresource/scoring.go:86``,
``resource_manager.go:142 Allocate``); here per-zone fit and
least/most-allocated scores are broadcasts over ``[P, N, Z, R]``, and the
exact cpuset accumulator runs on the host only for the node the cycle
picks (``koordinator_tpu_torch.scheduler.cpu_accumulator``).

The reference composes these broadcasts in one XLA program, which never
materialises them.  Eager PyTorch does, so every function here computes
its ``[P, ...]`` result over chunks of pod rows (``greedy.by_rows``,
within ``greedy.CHUNK_BYTES`` a temporary).  Every output row reads its own
pod row only, so the chunked result equals one unchunked call bit for bit.

Amplified-CPU scoring (``scoring.go:95 scoreWithAmplifiedCPUs``) keeps
exact integer parity: ratios are fixed-point x10000 and the ceil is an
integer ceil-div, as ``apis/extension``'s Amplify.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.topology import DEFAULT_AMPLIFICATION_DENOMINATOR
from koordinator_tpu_torch.ops.scoring import (
    least_requested_score,
    most_requested_score,
    weighted_resource_score,
)
from koordinator_tpu_torch.solver.greedy import by_rows

# NUMATopologyPolicy codes on the node axis (apis/extension numa_aware.go
# policy names as ints).
POLICY_NONE = 0
POLICY_BEST_EFFORT = 1
POLICY_RESTRICTED = 2
POLICY_SINGLE_NUMA_NODE = 3

_CPU_IDX = res.RESOURCE_INDEX[res.CPU]


def _zone_fits(pod_requests, free, zone_valid):
    """bool[rows, N, Z] of the pod rows ``pod_requests`` [rows, R]."""
    fits = (pod_requests[:, None, None, :] <= free[None]).all(-1)
    return fits & zone_valid[None]


def zone_fit_mask(
    pod_requests: torch.Tensor,  # i64[P, R]
    zone_alloc: torch.Tensor,  # i64[N, Z, R]
    zone_requested: torch.Tensor,  # i64[N, Z, R]
    zone_valid: torch.Tensor,  # bool[N, Z]
) -> torch.Tensor:
    """bool[P, N, Z]: the pod fits entirely inside one zone, free =
    allocatable - requested (the single-NUMA-node admission check of
    ``plugin.go GetPodTopologyHints`` + ``resource_manager.go``)."""
    free = zone_alloc - zone_requested
    return by_rows(
        lambda rows: _zone_fits(pod_requests[rows], free, zone_valid),
        pod_requests.shape[0], free.numel(),
    )


def numa_admit_mask(
    pod_requests: torch.Tensor,  # i64[P, R]
    zone_alloc: torch.Tensor,  # i64[N, Z, R]
    zone_requested: torch.Tensor,  # i64[N, Z, R]
    zone_valid: torch.Tensor,  # bool[N, Z]
    node_policy: torch.Tensor,  # i32[N] POLICY_* codes
) -> torch.Tensor:
    """bool[P, N]: NUMA admission per (pod, node) by the node's policy.

    * single-numa-node: some single zone holds the whole request
      (policy_single_numa_node.go);
    * restricted: the request fits within the union of zones
      (policy_restricted.go);
    * best-effort / none: always admitted (policy_best_effort.go,
      policy_none.go).

    Nodes that report no zones skip NUMA admission (plugin.go skipTheNode).
    """
    free = zone_alloc - zone_requested
    union_free = torch.where(zone_valid[:, :, None], free, 0).sum(1)  # [N, R]
    has_zones = zone_valid.any(-1)  # [N]
    policy = node_policy[None, :]

    def rows(sl):
        req = pod_requests[sl]
        single = _zone_fits(req, free, zone_valid).any(-1)
        union_fit = (req[:, None, :] <= union_free[None]).all(-1)
        admitted = torch.where(
            policy == POLICY_SINGLE_NUMA_NODE,
            single,
            torch.where(policy == POLICY_RESTRICTED, union_fit, True),
        )
        return admitted | ~has_zones[None, :]

    return by_rows(rows, pod_requests.shape[0], free.numel())


def numa_zone_scores(
    pod_requests: torch.Tensor,  # i64[P, R]
    zone_alloc: torch.Tensor,  # i64[N, Z, R]
    zone_requested: torch.Tensor,  # i64[N, Z, R]
    zone_valid: torch.Tensor,  # bool[N, Z]
    weights: torch.Tensor,  # i64[R]
    *,
    most_allocated: bool = False,
) -> torch.Tensor:
    """i64[P, N]: the score of the zone the allocator would pick.

    Every (pod, node, zone) placement is scored least/most-allocated on
    the post-placement zone occupancy (``scoring.go
    calculateAllocatableAndRequested``), masked to fitting zones, and the
    highest wins (the allocator's preference order).  A node with no
    fitting zone scores 0 (Allocate fails, scoring.go:86).
    """
    free = zone_alloc - zone_requested
    scorer = most_requested_score if most_allocated else least_requested_score
    weights = weights.to(zone_alloc.device)

    def rows(sl):
        req = pod_requests[sl]
        req_after = zone_requested[None] + req[:, None, None, :]
        per_zone = weighted_resource_score(scorer(req_after, zone_alloc[None]), weights)
        masked = torch.where(_zone_fits(req, free, zone_valid), per_zone, -1)
        return masked.max(-1).values.clamp(min=0)

    return by_rows(rows, pod_requests.shape[0], free.numel() * 8)


def amplify_milli(value: torch.Tensor, ratio_x10000: torch.Tensor) -> torch.Tensor:
    """Integer ceil(value * ratio), ratio fixed-point x10000 (reference
    apis/extension Amplify; ``topology.amplify``, vectorised)."""
    num = value.long() * ratio_x10000.long()
    amplified = -(-num // DEFAULT_AMPLIFICATION_DENOMINATOR)
    return torch.where(
        ratio_x10000 <= DEFAULT_AMPLIFICATION_DENOMINATOR, value.long(), amplified
    )


def amplified_cpu_scores(
    pod_requests: torch.Tensor,  # i64[P, R]
    node_requested: torch.Tensor,  # i64[N, R]
    node_allocatable: torch.Tensor,  # i64[N, R] (amplified allocatable)
    cpuset_allocated_milli: torch.Tensor,  # i64[N] milli-cpus held by cpuset pods
    cpu_amplification: torch.Tensor,  # i32[N] ratio x10000
    weights: torch.Tensor,  # i64[R]
    *,
    most_allocated: bool = False,
) -> torch.Tensor:
    """i64[P, N]: least/most-allocated score with amplified cpuset usage
    (``scoring.go:95 scoreWithAmplifiedCPUs``): on nodes with a CPU
    amplification ratio the milli-CPUs held by cpuset-bound pods count at
    the amplified rate, ``requested.cpu += amplify(allocated) - allocated``.
    """
    adjusted_cpu = (
        node_requested[:, _CPU_IDX]
        - cpuset_allocated_milli
        + amplify_milli(cpuset_allocated_milli, cpu_amplification)
    )
    node_requested = node_requested.clone()
    node_requested[:, _CPU_IDX] = adjusted_cpu
    scorer = most_requested_score if most_allocated else least_requested_score
    weights = weights.to(node_requested.device)

    def rows(sl):
        requested = node_requested[None] + pod_requests[sl][:, None, :]
        return weighted_resource_score(scorer(requested, node_allocatable[None]), weights)

    return by_rows(rows, pod_requests.shape[0], node_requested.numel() * 8)
