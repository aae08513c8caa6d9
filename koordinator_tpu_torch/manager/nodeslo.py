"""NodeSLO rendering: per-node SLO spec from cluster strategy ConfigMaps.

The port's own copy of ``koordinator_tpu/manager/nodeslo.py``.

Reference: ``pkg/slo-controller/nodeslo`` (``nodeslo_controller.go:128
Reconcile`` renders the merged resource-threshold / resource-qos /
cpu-burst / system strategies into each node's NodeSLO CR) with defaults
from ``pkg/util/sloconfig/nodeslo_config.go``.

Specs are plain nested dicts (the CR's JSON form); merging is deep
field-wise with the node-selector override winning, like the reference's
``mergeNodeSLOSpec``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Sequence

from koordinator_tpu_torch.manager.sloconfig import node_selector_matches

QOS_CLASSES = ("LSR", "LS", "BE", "SYSTEM")


def default_resource_threshold_strategy() -> Dict[str, Any]:
    """reference ``sloconfig.DefaultResourceThresholdStrategy`` (:51-59)."""
    return {
        "enable": False,
        "cpuSuppressThresholdPercent": 65,
        "cpuSuppressPolicy": "cpuset",
        "memoryEvictThresholdPercent": 70,
        "cpuEvictPolicy": "evictByRealLimit",
    }


def default_cpu_qos(qos: str) -> Optional[Dict[str, Any]]:
    """Group-identity (bvt) values per QoS (reference
    ``sloconfig.DefaultCPUQOS``: LSR/LS=2, BE=-1, SYSTEM=0)."""
    return {
        "LSR": {"groupIdentity": 2},
        "LS": {"groupIdentity": 2},
        "BE": {"groupIdentity": -1},
        "SYSTEM": {"groupIdentity": 0},
    }.get(qos)


def default_resctrl_qos(qos: str) -> Optional[Dict[str, Any]]:
    """L3 CAT / MBA percentages per QoS (reference
    ``sloconfig.DefaultResctrlQOS``: BE capped to 30% of LLC ways)."""
    base = {"catRangeStartPercent": 0, "catRangeEndPercent": 100, "mbaPercent": 100}
    if qos == "BE":
        return {**base, "catRangeEndPercent": 30}
    if qos in QOS_CLASSES:
        return dict(base)
    return None


def default_memory_qos(qos: str) -> Optional[Dict[str, Any]]:
    """memcg qos knobs per QoS (reference ``sloconfig.DefaultMemoryQOS``:
    async-reclaim watermarks on, all limits off; BE gets a positive
    wmark_min_adj, LSR/LS a negative one)."""
    if qos not in QOS_CLASSES:
        return None
    wmark_min_adj = {"LSR": -25, "LS": -25, "BE": 50, "SYSTEM": 0}[qos]
    wmark_ratio = 0 if qos == "SYSTEM" else 95
    wmark_scale = 50 if qos == "SYSTEM" else 20
    return {
        "minLimitPercent": 0,
        "lowLimitPercent": 0,
        "throttlingPercent": 0,
        "wmarkRatio": wmark_ratio,
        "wmarkScalePermill": wmark_scale,
        "wmarkMinAdj": wmark_min_adj,
        "priorityEnable": 0,
        "priority": 0,
        "oomKillGroup": 0,
    }


def default_resource_qos_strategy() -> Dict[str, Any]:
    """reference ``sloconfig.DefaultResourceQOSStrategy``: per-class cpu /
    resctrl / memory QoS configs, all gated off by default."""
    out: Dict[str, Any] = {}
    for qos in QOS_CLASSES:
        out[f"{qos.lower()}Class"] = {
            "cpuQOS": {"enable": False, **(default_cpu_qos(qos) or {})},
            "resctrlQOS": {"enable": False, **(default_resctrl_qos(qos) or {})},
            "memoryQOS": {"enable": False, **(default_memory_qos(qos) or {})},
        }
    return out


def default_cpu_burst_strategy() -> Dict[str, Any]:
    """reference ``sloconfig.DefaultCPUBurstStrategy``."""
    return {
        "policy": "none",
        "cpuBurstPercent": 1000,
        "cfsQuotaBurstPercent": 300,
        "cfsQuotaBurstPeriodSeconds": -1,
        "sharePoolThresholdPercent": 50,
    }


def default_system_strategy() -> Dict[str, Any]:
    """reference ``sloconfig.DefaultSystemStrategy``."""
    return {
        "minFreeKbytesFactor": 100,
        "watermarkScaleFactor": 150,
        "memcgReapBackGround": 0,
    }


def default_nodeslo_spec() -> Dict[str, Any]:
    return {
        "resourceUsedThresholdWithBE": default_resource_threshold_strategy(),
        "resourceQOSStrategy": default_resource_qos_strategy(),
        "cpuBurstStrategy": default_cpu_burst_strategy(),
        "systemStrategy": default_system_strategy(),
    }


def deep_merge(base: Mapping[str, Any], override: Mapping[str, Any]) -> Dict[str, Any]:
    """Field-wise deep merge; override's non-None leaves win (the
    reference merges via JSON merge-patch of the ConfigMap strategy onto
    defaults)."""
    out: Dict[str, Any] = copy.deepcopy(dict(base))
    for k, v in override.items():
        if v is None:
            continue
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def render_nodeslo(
    node_labels: Mapping[str, str],
    cluster_strategies: Optional[Mapping[str, Any]] = None,
    node_strategies: Sequence[Mapping[str, Any]] = (),
) -> Dict[str, Any]:
    """Render one node's NodeSLO spec: defaults <- cluster ConfigMap
    strategies <- matching node-selector overrides (reference
    ``nodeslo/resource_strategy.go`` get*Spec helpers)."""
    spec = default_nodeslo_spec()
    if cluster_strategies:
        spec = deep_merge(spec, cluster_strategies)
    for cfg in node_strategies:
        selector = cfg.get("nodeSelector", {}).get("matchLabels")
        if node_selector_matches(selector, node_labels):
            spec = deep_merge(spec, cfg.get("strategies", {}))
    return spec
