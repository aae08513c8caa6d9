"""Cycle configuration: plugin args + weights.

Counterpart of ``koordinator_tpu/config.py`` (reference component-config
``pkg/scheduler/apis/config/types.go:30-205``, defaults
``v1beta2/defaults.go:33-48``).  The dataclasses are the same frozen,
hashable records, so a config built for one package reads the same in the
other; the dense encodings take an explicit ``device``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Tuple, Union

import torch

from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import (
    DEFAULT_ESTIMATED_SCALING_FACTORS,
    DEFAULT_RESOURCE_WEIGHTS,
    DEFAULT_USAGE_THRESHOLDS,
    PERCENTILES,
)

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"

# mappings are stored as sorted (name, value) tuples so configs stay hashable
ResMap = Union[Mapping[str, int], Tuple[Tuple[str, int], ...]]


def _freeze(m: ResMap) -> Tuple[Tuple[str, int], ...]:
    if isinstance(m, tuple):
        return m
    return tuple(sorted((k, int(v)) for k, v in m.items()))


@functools.lru_cache(maxsize=256)
def _dense_on(m: ResMap, device: torch.device) -> torch.Tensor:
    return torch.tensor(res.weights_vector(dict(m)), dtype=torch.int64, device=device)


def _dense(m: ResMap, device) -> torch.Tensor:
    """The dense [R] vector of ``m`` on ``device``, one tensor per (map,
    device), which callers only read: an eager per-pod step asks for it on
    every step, and a new device tensor from a host list is a copy that
    waits for every launch queued before it."""
    return _dense_on(m, torch.device("cpu") if device is None else torch.device(device))


@dataclasses.dataclass(frozen=True)
class AggregatedArgs:
    """reference config.LoadAwareSchedulingAggregatedArgs (types.go:66):
    filter/score against an aggregated usage percentile instead of the
    instantaneous NodeUsage."""

    usage_thresholds: ResMap = ()
    usage_aggregation_type: str = "p99"
    score_aggregation_type: str = ""  # "" = score on plain NodeUsage

    def __post_init__(self):
        object.__setattr__(self, "usage_thresholds", _freeze(self.usage_thresholds))
        if dict(self.usage_thresholds) and self.usage_aggregation_type not in PERCENTILES:
            raise ValueError(
                "aggregated usage_thresholds need a valid "
                f"usage_aggregation_type, got {self.usage_aggregation_type!r}"
            )
        for t in (self.usage_aggregation_type, self.score_aggregation_type):
            if t and t not in PERCENTILES:
                raise ValueError(f"unknown aggregation type {t!r}")


@dataclasses.dataclass(frozen=True)
class LoadAwareArgs:
    """reference config.LoadAwareSchedulingArgs (types.go:30)."""

    resource_weights: ResMap = _freeze(DEFAULT_RESOURCE_WEIGHTS)
    usage_thresholds: ResMap = _freeze(DEFAULT_USAGE_THRESHOLDS)
    estimated_scaling_factors: ResMap = _freeze(DEFAULT_ESTIMATED_SCALING_FACTORS)
    filter_expired_node_metrics: bool = True
    node_metric_expiration_seconds: int = 180
    # aggregated-percentile profile (load_aware.go:150-224, :311); None =
    # plain instantaneous usage
    aggregated: "AggregatedArgs | None" = None
    # PriorityProd pods filter against the prod pods' usage (:226)
    prod_usage_thresholds: ResMap = ()
    # PriorityProd pods score against prod-pods usage (:291)
    score_according_prod_usage: bool = False

    def __post_init__(self):
        object.__setattr__(self, "resource_weights", _freeze(self.resource_weights))
        object.__setattr__(self, "usage_thresholds", _freeze(self.usage_thresholds))
        object.__setattr__(
            self, "estimated_scaling_factors", _freeze(self.estimated_scaling_factors)
        )
        object.__setattr__(
            self, "prod_usage_thresholds", _freeze(self.prod_usage_thresholds)
        )


# Fused scoring-term configs (the registry is ``solver/terms.py``).


@dataclasses.dataclass(frozen=True)
class HeterogeneityTermArgs:
    """Gavel-style heterogeneity-aware scoring (throughput matrix term)."""

    weight: int = 1


@dataclasses.dataclass(frozen=True)
class SensitivityTermArgs:
    """Synergy-style resource-sensitivity scoring term."""

    weight: int = 1


@dataclasses.dataclass(frozen=True)
class PackingTermArgs:
    """Bin-packing objective plus an optional post-placement headroom mask
    (resource -> max utilization percent)."""

    weight: int = 1
    resource_weights: ResMap = _freeze({res.CPU: 1, res.MEMORY: 1})
    headroom: ResMap = ()

    def __post_init__(self):
        object.__setattr__(
            self, "resource_weights", _freeze(self.resource_weights)
        )
        object.__setattr__(self, "headroom", _freeze(self.headroom))

    def weights_arr(self, device=None) -> torch.Tensor:
        return _dense(self.resource_weights, device)

    def headroom_arr(self, device=None) -> torch.Tensor:
        """Per-resource headroom percent; 0 = unconstrained dimension."""
        return _dense(self.headroom, device)


@dataclasses.dataclass(frozen=True)
class CycleConfig:
    """One scheduling cycle's plugin set and weights.

    ``wave > 1`` selects the wave-batched cycle (``top_m`` candidates per
    pod): ``run_cycle`` runs the wave kernel on the card and ``wave_assign``
    on the CPU, with the per-pod path's placements bit for bit and the
    number of rounds on the result.  ``candidate_width`` (a power of two,
    0 = off) is the sparse candidate engine's list width
    (``solver/candidates.py``); ``candidate_max_stale`` is carried so that
    configs round-trip with the reference's serving layer.
    """

    loadaware: LoadAwareArgs = LoadAwareArgs()
    fit_scoring_strategy: str = LEAST_ALLOCATED
    fit_resource_weights: ResMap = _freeze({res.CPU: 1, res.MEMORY: 1})
    fit_plugin_weight: int = 1
    loadaware_plugin_weight: int = 1
    enable_loadaware: bool = True
    enable_fit_score: bool = True
    wave: int = 1
    top_m: int = 4
    heterogeneity: "HeterogeneityTermArgs | None" = None
    sensitivity: "SensitivityTermArgs | None" = None
    packing: "PackingTermArgs | None" = None
    candidate_width: int = 0
    candidate_max_stale: int = 8

    def __post_init__(self):
        object.__setattr__(
            self, "fit_resource_weights", _freeze(self.fit_resource_weights)
        )
        cw = int(self.candidate_width)
        if cw < 0 or (cw & (cw - 1)) != 0:
            raise ValueError(
                "candidate_width must be 0 (sparse off) or a power of "
                f"two, got {self.candidate_width!r}"
            )
        if int(self.candidate_max_stale) < 1:
            raise ValueError(
                "candidate_max_stale must be >= 1, got "
                f"{self.candidate_max_stale!r}"
            )

    @property
    def has_terms(self) -> bool:
        return any(
            t is not None
            for t in (self.heterogeneity, self.sensitivity, self.packing)
        )

    def loadaware_weights_arr(self, device=None) -> torch.Tensor:
        return _dense(self.loadaware.resource_weights, device)

    def loadaware_thresholds_arr(self, device=None) -> torch.Tensor:
        """Filter thresholds: the aggregated profile's when configured
        (load_aware.go:157-162), else the plain usage thresholds."""
        agg = self.loadaware.aggregated
        if agg is not None and agg.usage_thresholds:
            src = agg.usage_thresholds
        else:
            src = self.loadaware.usage_thresholds
        return _dense(src, device)

    def prod_thresholds_arr(self, device=None) -> torch.Tensor:
        return _dense(self.loadaware.prod_usage_thresholds, device)

    def fit_weights_arr(self, device=None) -> torch.Tensor:
        return _dense(self.fit_resource_weights, device)


DEFAULT_CYCLE_CONFIG = CycleConfig()
