"""The PostFilter's preemption inventory, built from a cycle's placements.

``FrameworkExtender.post_filter_preempt`` reads ``ctx.extras["preemption"]``:
node allocatables, the pods placed on each node, the quota groups' used
and runtime vectors, and the pending pods.  :func:`preemption_inventory`
builds it from a snapshot, the node and pod lists it was encoded from, and
one cycle's result: every placed pod (with its requests, priority and
quota) lands in its node's list, ``quota_used`` is what the cycle left,
``quota_runtime`` the snapshot's quota table, and every pod the cycle did
not place is pending, in index order.  A dimension a
quota does not declare (``limited`` false) is ``UNLIMITED`` in
``quota_runtime``, as in the cycle's own quota admission, which checks
declared dimensions only: the PostFilter compares every dimension, so a
runtime of 0 there would refuse every preemption.  The device is read once
for each tensor the inventory needs.

The inputs may be tensors on either device or numpy arrays, so the parity
tests build the same inventory from the reference's results.
:func:`preempt_digest` fixes a PostFilter's answer as one sha256.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

# the PostFilter's own value for a quota it has no vector of
UNLIMITED = 1 << 60


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def preemption_inventory(
    snapshot,
    assignment,
    quota_used,
    node_list: Sequence[Mapping],
    pod_list: Sequence[Mapping],
) -> Dict[str, object]:
    """``ctx.extras["preemption"]`` for the placements ``assignment`` (i32[P],
    -1 unplaced) of ``snapshot`` (encoded from ``node_list`` and
    ``pod_list``), with ``quota_used`` (i64[Q, R]) as the cycle left it."""
    alloc = _host(snapshot.nodes.allocatable)
    runtime = np.where(_host(snapshot.quotas.limited),
                       _host(snapshot.quotas.runtime), UNLIMITED)
    used = _host(quota_used)
    placed = _host(assignment)
    node_names = [n["name"] for n in node_list]
    quota_names = list(snapshot.quotas.names)
    node_pods: Dict[str, List[Mapping]] = {name: [] for name in node_names}
    pending: List[Mapping] = []
    for i, pod in enumerate(pod_list):
        entry = {
            "name": pod["name"],
            "requests": pod.get("requests") or {},
            "priority": int(pod.get("priority") or 0),
            "quota": pod.get("quota"),
        }
        node = int(placed[i])
        if node >= 0:
            node_pods[node_names[node]].append(entry)
        else:
            pending.append(dict(entry, index=i))
    return {
        "node_allocatable": {
            name: [int(x) for x in alloc[j]] for j, name in enumerate(node_names)
        },
        "node_pods": node_pods,
        "quota_used": {
            q: [int(x) for x in used[j]] for j, q in enumerate(quota_names)
        },
        "quota_runtime": {
            q: [int(x) for x in runtime[j]] for j, q in enumerate(quota_names)
        },
        "pending_pods": pending,
    }


def preempt_doc(found: Mapping[str, object]) -> List[list]:
    """``post_filter_preempt``'s answer as plain data, in its order:
    ``[pod, node, [victim names], num_violating]`` a pod."""
    return [
        [pod, nv.node, [v["name"] for v in nv.victims], int(nv.num_violating)]
        for pod, nv in found.items()
    ]


def preempt_digest(found: Mapping[str, object]) -> str:
    """sha256 of :func:`preempt_doc` as canonical JSON."""
    text = json.dumps(preempt_doc(found), separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()
