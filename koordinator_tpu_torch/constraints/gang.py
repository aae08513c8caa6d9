"""Coscheduling gang (PodGroup) Permit gate, as a post-cycle reduction.

Counterpart of ``koordinator_tpu/constraints/gang.py``: a gang whose number
of assigned members stays below minMember keeps its pods waiting
(reference ``coscheduling/core/core.go:308-338``).
"""

from __future__ import annotations

import torch


def gang_satisfaction(
    assignment: torch.Tensor,  # i32[P] node or -1
    pod_valid: torch.Tensor,  # bool[P]
    gang_id: torch.Tensor,  # i32[P], -1 = no gang
    min_member: torch.Tensor,  # i32[G]
):
    """Returns (gang_satisfied bool[G], pod_gang_ok bool[P]).

    A pod with no gang is always ok; a gang is satisfied when its number of
    assigned members reaches minMember.  Gang ids outside [0, G) count in
    the overflow slot G, like the reference's clamped scatter.
    """
    G = min_member.shape[0]
    assigned = (assignment >= 0) & pod_valid
    gid = gang_id.long()
    slot = torch.where((gid >= 0) & (gid < G), gid, torch.full_like(gid, G))
    counts = torch.zeros(G + 1, dtype=torch.int32, device=assignment.device)
    counts.index_add_(0, slot, assigned.to(torch.int32))
    satisfied = counts[:G] >= min_member
    pod_ok = torch.where(
        gid >= 0, satisfied[gid.clamp(0, max(G - 1, 0))], torch.ones_like(assigned)
    )
    return satisfied, pod_ok
