"""Filter-phase feasibility (NodeResourcesFit semantics).

Counterpart of ``koordinator_tpu/ops/fit.py``.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.model import resources as res

# upstream kube-scheduler non-zero request defaults (DefaultMilliCPURequest
# = 100, DefaultMemoryRequest = 200Mi on the MiB axis), used by Fit scoring
NONZERO_MILLI_CPU = 100
NONZERO_MEMORY = 200

_CPU_IDX = res.RESOURCE_INDEX[res.CPU]
_MEM_IDX = res.RESOURCE_INDEX[res.MEMORY]


def nonzero_requests(pod_requests: torch.Tensor) -> torch.Tensor:
    """Apply upstream GetNonzeroRequests defaults to cpu/memory slots."""
    defaults = torch.zeros(
        res.NUM_RESOURCES, dtype=torch.int64, device=pod_requests.device
    )
    defaults[_CPU_IDX] = NONZERO_MILLI_CPU
    defaults[_MEM_IDX] = NONZERO_MEMORY
    return torch.where(pod_requests == 0, defaults, pod_requests)


def fit_mask(
    pod_requests: torch.Tensor,  # i64[P, R]
    node_requested: torch.Tensor,  # i64[N, R] or i64[P, C, R]
    node_allocatable: torch.Tensor,  # i64[N, R] or i64[P, C, R]
    node_valid: torch.Tensor,  # bool[N] or bool[P, C]
    pod_valid: torch.Tensor,  # bool[P]
) -> torch.Tensor:
    """Feasibility mask bool[P, N]: the pod fits the node's remaining
    allocatable on every resource it requests (zero requests never fail).

    The node side broadcasts against the pods' ``[P, 1, R]``: node tables
    of [N, R] give every pod x node cell, node rows gathered per pod
    ([P, C, R], the sparse engine's candidate lists) give [P, C]."""
    need = pod_requests[:, None, :] > 0
    fits_r = node_requested + pod_requests[:, None, :] <= node_allocatable
    ok = (fits_r | ~need).all(-1)
    return ok & node_valid & pod_valid[:, None]
