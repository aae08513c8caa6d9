"""Versioned component config: plugin args with defaults + validation.

Reference: ``pkg/scheduler/apis/config/types.go`` (LoadAwareSchedulingArgs
:30, NodeNUMAResourceArgs :103, ReservationArgs :150, CoschedulingArgs
:160, ElasticQuotaArgs :188, DeviceShareArgs :205), defaults
``v1beta2/defaults.go:33-48``, validation ``validation/``.  The component
config file is KubeSchedulerConfiguration-shaped YAML: profiles carry
pluginConfig entries keyed by plugin name; unknown fields are rejected
like strict decoding upstream.  The port's copy of
``koordinator_tpu/scheduler/config_api.py``: the same profiles, built on
the port's ``CycleConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

from koordinator_tpu_torch.config import CycleConfig, LEAST_ALLOCATED, LoadAwareArgs, MOST_ALLOCATED
from koordinator_tpu_torch.model import resources as res

LOADAWARE = "LoadAwareScheduling"
NODENUMA = "NodeNUMAResource"
RESERVATION = "Reservation"
COSCHEDULING = "Coscheduling"
ELASTICQUOTA = "ElasticQuota"
DEVICESHARE = "DeviceShare"
FIT = "NodeResourcesFit"


@dataclasses.dataclass(frozen=True)
class NodeNUMAResourceArgs:
    """types.go:103: default CPU bind policy + scoring strategy."""

    default_cpu_bind_policy: str = "FullPCPUs"
    scoring_strategy: str = LEAST_ALLOCATED
    numa_scoring_strategy: str = LEAST_ALLOCATED


@dataclasses.dataclass(frozen=True)
class CoschedulingArgs:
    """types.go:160: gang wait timeout + controller workers."""

    default_timeout_seconds: int = 600
    controller_workers: int = 1


@dataclasses.dataclass(frozen=True)
class ElasticQuotaArgs:
    """types.go:188: delay evict + revoke interval."""

    delay_evict_time_seconds: int = 300
    revoke_pods_interval_seconds: int = 60
    default_quota_group_max: Dict[str, str] = dataclasses.field(default_factory=dict)
    quota_group_namespace: str = "koordinator-system"


@dataclasses.dataclass(frozen=True)
class ReservationArgs:
    """types.go:150: enable preemption against reservations."""

    enable_preemption: bool = False
    min_candidate_nodes_percentage: int = 10
    min_candidate_nodes_absolute: int = 100


@dataclasses.dataclass(frozen=True)
class DeviceShareArgs:
    """types.go:205: allocation scoring strategy."""

    allocate_strategy: str = "FirstFit"
    scoring_strategy: str = LEAST_ALLOCATED


@dataclasses.dataclass
class Profile:
    scheduler_name: str
    cycle: CycleConfig
    numa: NodeNUMAResourceArgs
    coscheduling: CoschedulingArgs
    elasticquota: ElasticQuotaArgs
    reservation: ReservationArgs
    deviceshare: DeviceShareArgs


_KNOWN_PLUGINS = {
    LOADAWARE,
    NODENUMA,
    RESERVATION,
    COSCHEDULING,
    ELASTICQUOTA,
    DEVICESHARE,
    FIT,
}
_STRATEGIES = {LEAST_ALLOCATED, MOST_ALLOCATED}


class ConfigError(ValueError):
    pass


def _check_fields(args: Mapping, allowed: set, where: str, errs: List[str]):
    for k in args:
        if k not in allowed:
            errs.append(f"{where}: unknown field {k!r}")


def _resource_map(m: Optional[Mapping], where: str, errs: List[str]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for name, v in (m or {}).items():
        if name not in res.RESOURCE_INDEX:
            errs.append(f"{where}: unknown resource {name!r}")
            continue
        iv = int(v)
        if iv < 0:
            errs.append(f"{where}[{name}]: must be >= 0")
        out[name] = iv
    return out


def _loadaware(args: Mapping, errs: List[str]) -> LoadAwareArgs:
    where = f"pluginConfig[{LOADAWARE}]"
    _check_fields(
        args,
        {
            "resourceWeights",
            "usageThresholds",
            "estimatedScalingFactors",
            "filterExpiredNodeMetrics",
            "nodeMetricExpirationSeconds",
        },
        where,
        errs,
    )
    weights = _resource_map(args.get("resourceWeights"), f"{where}.resourceWeights", errs)
    thresholds = _resource_map(
        args.get("usageThresholds"), f"{where}.usageThresholds", errs
    )
    for name, pct in thresholds.items():
        if pct > 100:
            errs.append(f"{where}.usageThresholds[{name}]: percent > 100")
    factors = _resource_map(
        args.get("estimatedScalingFactors"), f"{where}.estimatedScalingFactors", errs
    )
    for name, pct in factors.items():
        if not 0 < pct <= 100:
            errs.append(f"{where}.estimatedScalingFactors[{name}]: want (0, 100]")
    defaults = LoadAwareArgs()
    return LoadAwareArgs(
        resource_weights=weights or defaults.resource_weights,
        usage_thresholds=thresholds or defaults.usage_thresholds,
        estimated_scaling_factors=factors or defaults.estimated_scaling_factors,
        filter_expired_node_metrics=bool(
            args.get("filterExpiredNodeMetrics", defaults.filter_expired_node_metrics)
        ),
        node_metric_expiration_seconds=int(
            args.get(
                "nodeMetricExpirationSeconds",
                defaults.node_metric_expiration_seconds,
            )
        ),
    )


def _fit(args: Mapping, errs: List[str]):
    where = f"pluginConfig[{FIT}]"
    _check_fields(args, {"scoringStrategy"}, where, errs)
    strategy = args.get("scoringStrategy", {}) or {}
    stype = strategy.get("type", LEAST_ALLOCATED)
    if stype not in _STRATEGIES:
        errs.append(f"{where}.scoringStrategy.type: unknown {stype!r}")
        stype = LEAST_ALLOCATED
    weights = {}
    for e in strategy.get("resources", []) or []:
        name, w = e.get("name"), int(e.get("weight", 1))
        if name not in res.RESOURCE_INDEX:
            errs.append(f"{where}.scoringStrategy.resources: unknown {name!r}")
            continue
        if not 0 < w <= 100:
            errs.append(f"{where}.scoringStrategy.resources[{name}]: weight (0,100]")
        weights[name] = w
    return stype, weights


def load_profile(doc: Mapping[str, Any]) -> Profile:
    """Parse one profile mapping (strict: unknown plugins/fields error)."""
    errs: List[str] = []
    name = doc.get("schedulerName", "koord-scheduler")
    la = LoadAwareArgs()
    fit_strategy, fit_weights = LEAST_ALLOCATED, {res.CPU: 1, res.MEMORY: 1}
    numa = NodeNUMAResourceArgs()
    cos = CoschedulingArgs()
    eq = ElasticQuotaArgs()
    rsv = ReservationArgs()
    ds = DeviceShareArgs()
    for entry in doc.get("pluginConfig", []) or []:
        pname = entry.get("name")
        args = entry.get("args", {}) or {}
        if pname not in _KNOWN_PLUGINS:
            errs.append(f"pluginConfig: unknown plugin {pname!r}")
            continue
        if pname == LOADAWARE:
            la = _loadaware(args, errs)
        elif pname == FIT:
            fit_strategy, w = _fit(args, errs)
            fit_weights = w or fit_weights
        elif pname == NODENUMA:
            _check_fields(
                args,
                {"defaultCPUBindPolicy", "scoringStrategy", "numaScoringStrategy"},
                f"pluginConfig[{NODENUMA}]",
                errs,
            )
            numa = NodeNUMAResourceArgs(
                default_cpu_bind_policy=args.get(
                    "defaultCPUBindPolicy", numa.default_cpu_bind_policy
                ),
                scoring_strategy=args.get("scoringStrategy", numa.scoring_strategy),
                numa_scoring_strategy=args.get(
                    "numaScoringStrategy", numa.numa_scoring_strategy
                ),
            )
            if numa.default_cpu_bind_policy not in ("FullPCPUs", "SpreadByPCPUs"):
                errs.append(
                    f"pluginConfig[{NODENUMA}].defaultCPUBindPolicy: unknown "
                    f"{numa.default_cpu_bind_policy!r}"
                )
        elif pname == COSCHEDULING:
            _check_fields(
                args,
                {"defaultTimeoutSeconds", "controllerWorkers"},
                f"pluginConfig[{COSCHEDULING}]",
                errs,
            )
            cos = CoschedulingArgs(
                default_timeout_seconds=int(
                    args.get("defaultTimeoutSeconds", cos.default_timeout_seconds)
                ),
                controller_workers=int(
                    args.get("controllerWorkers", cos.controller_workers)
                ),
            )
            if cos.default_timeout_seconds <= 0:
                errs.append(
                    f"pluginConfig[{COSCHEDULING}].defaultTimeoutSeconds: want > 0"
                )
        elif pname == ELASTICQUOTA:
            _check_fields(
                args,
                {
                    "delayEvictTime",
                    "revokePodInterval",
                    "defaultQuotaGroupMax",
                    "quotaGroupNamespace",
                },
                f"pluginConfig[{ELASTICQUOTA}]",
                errs,
            )
            eq = ElasticQuotaArgs(
                delay_evict_time_seconds=int(
                    args.get("delayEvictTime", eq.delay_evict_time_seconds)
                ),
                revoke_pods_interval_seconds=int(
                    args.get("revokePodInterval", eq.revoke_pods_interval_seconds)
                ),
                default_quota_group_max=dict(args.get("defaultQuotaGroupMax", {})),
                quota_group_namespace=args.get(
                    "quotaGroupNamespace", eq.quota_group_namespace
                ),
            )
        elif pname == RESERVATION:
            _check_fields(
                args,
                {
                    "enablePreemption",
                    "minCandidateNodesPercentage",
                    "minCandidateNodesAbsolute",
                },
                f"pluginConfig[{RESERVATION}]",
                errs,
            )
            rsv = ReservationArgs(
                enable_preemption=bool(args.get("enablePreemption", rsv.enable_preemption)),
                min_candidate_nodes_percentage=int(
                    args.get(
                        "minCandidateNodesPercentage",
                        rsv.min_candidate_nodes_percentage,
                    )
                ),
                min_candidate_nodes_absolute=int(
                    args.get(
                        "minCandidateNodesAbsolute", rsv.min_candidate_nodes_absolute
                    )
                ),
            )
            if not 0 <= rsv.min_candidate_nodes_percentage <= 100:
                errs.append(
                    f"pluginConfig[{RESERVATION}].minCandidateNodesPercentage: "
                    "want [0, 100]"
                )
        elif pname == DEVICESHARE:
            _check_fields(
                args,
                {"allocateStrategy", "scoringStrategy"},
                f"pluginConfig[{DEVICESHARE}]",
                errs,
            )
            ds = DeviceShareArgs(
                allocate_strategy=args.get("allocateStrategy", ds.allocate_strategy),
                scoring_strategy=args.get("scoringStrategy", ds.scoring_strategy),
            )
    if errs:
        raise ConfigError("; ".join(errs))
    cycle = CycleConfig(
        loadaware=la,
        fit_scoring_strategy=fit_strategy,
        fit_resource_weights=fit_weights,
    )
    return Profile(
        scheduler_name=name,
        cycle=cycle,
        numa=numa,
        coscheduling=cos,
        elasticquota=eq,
        reservation=rsv,
        deviceshare=ds,
    )


def load_config(text_or_doc) -> List[Profile]:
    """Load a KubeSchedulerConfiguration-shaped YAML string or dict.
    ``yaml`` is imported only to parse a string."""
    if isinstance(text_or_doc, (str, bytes)):
        import yaml

        doc = yaml.safe_load(text_or_doc)
    else:
        doc = dict(text_or_doc)
    if not doc:
        return [load_profile({})]
    profiles = doc.get("profiles")
    if not profiles:
        return [load_profile(doc)]
    return [load_profile(p) for p in profiles]
