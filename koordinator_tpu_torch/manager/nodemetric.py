"""NodeMetric CR lifecycle: ensure one per node, push the collect policy.

The port's own copy of ``koordinator_tpu/manager/nodemetric.py``.

Reference: ``pkg/slo-controller/nodemetric`` (``nodemetric_controller.go:59
Reconcile`` creates/deletes NodeMetric alongside its Node and stamps the
spec's ``CollectPolicy`` from the merged colocation strategy;
``collect_policy.go`` derives the policy fields).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

from koordinator_tpu_torch.manager.sloconfig import ColocationStrategy, merge_node_strategy


def collect_policy(strategy: ColocationStrategy) -> Dict[str, Any]:
    """reference ``collect_policy.go getNodeMetricCollectPolicy``."""
    return {
        "aggregateDurationSeconds": strategy.metric_aggregate_duration_seconds,
        "reportIntervalSeconds": strategy.metric_report_interval_seconds,
        "nodeAggregatePolicy": {
            "durations": list(strategy.metric_aggregate_durations_seconds),
        },
        "nodeMemoryCollectPolicy": strategy.metric_memory_collect_policy,
    }


def reconcile_nodemetrics(
    nodes: Sequence[Mapping[str, Any]],
    existing: Mapping[str, Mapping[str, Any]],
    cluster_strategy: ColocationStrategy,
    node_cfgs: Sequence[Mapping[str, Any]] = (),
) -> Dict[str, Optional[Dict[str, Any]]]:
    """Desired NodeMetric spec per node name; ``None`` marks a NodeMetric
    whose Node is gone and should be garbage-collected (the reference
    relies on ownerReferences for that)."""
    desired: Dict[str, Optional[Dict[str, Any]]] = {}
    node_names = set()
    for node in nodes:
        name = node["name"]
        node_names.add(name)
        strategy = merge_node_strategy(cluster_strategy, node.get("labels", {}), node_cfgs)
        desired[name] = {"metricCollectPolicy": collect_policy(strategy)}
    for name in existing:
        if name not in node_names:
            desired[name] = None
    return desired
