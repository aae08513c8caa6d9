"""Colocation / SLO strategy configuration: parse, validate, merge.

The port's own copy of ``koordinator_tpu/manager/sloconfig.py``.

Mirrors the reference's ConfigMap-borne strategy handling
(``pkg/util/sloconfig/colocation_config.go``; types at
``apis/configuration/slo_controller_config.go:211``): a cluster-level
``ColocationStrategy`` plus per-node-selector overrides, merged
field-by-field (the reference merges via JSON patch of non-nil fields).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

# Memory calculate policies (reference apis/configuration:
# CalculateByPodUsage / CalculateByPodRequest / CalculateByPodMaxUsageRequest).
CALCULATE_BY_POD_USAGE = "usage"
CALCULATE_BY_POD_REQUEST = "request"
CALCULATE_BY_POD_MAX_USAGE_REQUEST = "maxUsageRequest"


@dataclasses.dataclass
class ColocationStrategy:
    """Cluster colocation strategy (reference
    ``apis/configuration/slo_controller_config.go:211``, defaults at
    ``pkg/util/sloconfig/colocation_config.go:44-68``)."""

    enable: bool = False
    metric_aggregate_duration_seconds: int = 300
    metric_report_interval_seconds: int = 60
    # aggregate windows used by the percentile usage model (5m / 10m / 30m)
    metric_aggregate_durations_seconds: Sequence[int] = (300, 600, 1800)
    metric_memory_collect_policy: str = "usageWithoutPageCache"
    cpu_reclaim_threshold_percent: int = 60
    memory_reclaim_threshold_percent: int = 65
    memory_calculate_policy: str = CALCULATE_BY_POD_USAGE
    degrade_time_minutes: int = 15
    update_time_threshold_seconds: int = 300
    resource_diff_threshold: float = 0.1
    # Mid-tier: fraction of node allocatable usable as mid resources
    mid_cpu_threshold_percent: int = 100
    mid_memory_threshold_percent: int = 100

    def replace(self, **overrides) -> "ColocationStrategy":
        kept = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **kept)


def default_colocation_strategy() -> ColocationStrategy:
    return ColocationStrategy()


def is_strategy_valid(s: Optional[ColocationStrategy]) -> bool:
    """reference ``sloconfig.IsColocationStrategyValid`` (:70-80): every set
    numeric knob must be positive."""
    if s is None:
        return False
    return (
        s.metric_aggregate_duration_seconds > 0
        and s.metric_report_interval_seconds > 0
        and s.cpu_reclaim_threshold_percent > 0
        and s.memory_reclaim_threshold_percent > 0
        and s.degrade_time_minutes > 0
        and s.update_time_threshold_seconds > 0
        and s.resource_diff_threshold > 0
        and len(s.metric_memory_collect_policy) > 0
    )


_CAMEL_TO_FIELD = {
    "enable": "enable",
    "metricAggregateDurationSeconds": "metric_aggregate_duration_seconds",
    "metricReportIntervalSeconds": "metric_report_interval_seconds",
    "metricAggregateDurationsSeconds": "metric_aggregate_durations_seconds",
    "cpuReclaimThresholdPercent": "cpu_reclaim_threshold_percent",
    "memoryReclaimThresholdPercent": "memory_reclaim_threshold_percent",
    "memoryCalculatePolicy": "memory_calculate_policy",
    "degradeTimeMinutes": "degrade_time_minutes",
    "updateTimeThresholdSeconds": "update_time_threshold_seconds",
    "resourceDiffThreshold": "resource_diff_threshold",
    "metricMemoryCollectPolicy": "metric_memory_collect_policy",
    "midCPUThresholdPercent": "mid_cpu_threshold_percent",
    "midMemoryThresholdPercent": "mid_memory_threshold_percent",
}
_FIELD_NAMES = {f.name for f in dataclasses.fields(ColocationStrategy)}


def _normalize_overrides(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """Accept both camelCase (ConfigMap JSON) and snake_case keys; keep
    only fields the strategy actually has, with the given values."""
    out: Dict[str, Any] = {}
    for key, value in cfg.items():
        field = _CAMEL_TO_FIELD.get(key, key if key in _FIELD_NAMES else None)
        if field is not None and value is not None:
            out[field] = value
    return out


def parse_strategy(cfg: Mapping[str, Any]) -> ColocationStrategy:
    """Parse a ConfigMap-style JSON dict (camelCase keys like the
    reference's ``colocation-config`` data) into a strategy, applying
    defaults for missing fields."""
    return default_colocation_strategy().replace(**_normalize_overrides(cfg))


def node_selector_matches(selector: Optional[Mapping[str, str]], labels: Mapping[str, str]) -> bool:
    """matchLabels-only selector, as used by NodeColocationCfg
    (reference ``sloconfig.IsNodeColocationCfgValid``)."""
    if not selector:
        return False
    return all(labels.get(k) == v for k, v in selector.items())


def merge_node_strategy(
    cluster: ColocationStrategy,
    node_labels: Mapping[str, str],
    node_cfgs: Sequence[Mapping[str, Any]],
) -> ColocationStrategy:
    """Apply matching per-node-selector overrides on top of the cluster
    strategy (reference ``colocation_config.go`` node-cfg merge: later
    matching entries win field-by-field)."""
    merged = cluster
    for cfg in node_cfgs:
        if node_selector_matches(cfg.get("nodeSelector", {}).get("matchLabels"), node_labels):
            merged = dataclasses.replace(merged, **_normalize_overrides(cfg.get("strategy", {})))
    return merged
