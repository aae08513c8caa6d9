"""The LowNodeLoad rebalance leg of the reference bench.

The reference's ``bench.py --config rebalance`` (``bench.py:4709-4776``):
a cycle places the pods, each placement becomes a pod entry of its node's
dict, then one dry-run Balance tick plans evictions with one node pool,
low thresholds cpu/memory 20 %, high 50 %.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

from koordinator_tpu_torch.descheduler.evictions import PodEvictor
from koordinator_tpu_torch.descheduler.lownodeload import (
    LowNodeLoadArgs,
    NodePool,
    balance,
)


def placed_node_dicts(
    nodes: Sequence[Mapping], pods: Sequence[Mapping], assignment: Sequence[int]
) -> List[Dict]:
    """Node dicts for ``balance``: name, allocatable and usage of each node,
    with the pods ``assignment`` (host ints, -1 = unplaced) put on it."""
    node_dicts = [
        {"name": n["name"], "allocatable": n["allocatable"],
         "usage": n.get("usage", {}), "pods": []}
        for n in nodes
    ]
    for p, a in enumerate(assignment[: len(pods)]):
        if a >= 0:
            node_dicts[a]["pods"].append({
                "name": pods[p]["name"],
                "namespace": "default",
                "requests": pods[p]["requests"],
                "priority": pods[p].get("priority", 0),
            })
    return node_dicts


def rebalance_args() -> LowNodeLoadArgs:
    return LowNodeLoadArgs(
        node_pools=[NodePool(low_thresholds={"cpu": 20, "memory": 20},
                             high_thresholds={"cpu": 50, "memory": 50})],
        dry_run=True,
    )


def plan_rebalance(node_dicts: Sequence[Mapping]) -> List[Dict]:
    """One dry-run Balance tick over ``node_dicts``: the planned evictions."""
    return balance(rebalance_args(), node_dicts, PodEvictor(dry_run=True))
