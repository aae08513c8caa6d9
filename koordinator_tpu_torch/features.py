"""Feature gates for every binary.

The port's own copy of ``koordinator_tpu/features.py`` (which imports no
JAX); the daemon's flags read the scheduler gates.

Reference: ``pkg/features`` — per-binary mutable feature gates with
alpha/beta defaults (``koordlet_features.go:146``, ``features.go:28-63``,
``scheduler_features.go``), parsed from ``--feature-gates`` style
``Name=true,Other=false`` strings, plus the NodeSLO-driven disable check
(``IsFeatureDisabled``).
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional

ALPHA = "Alpha"
BETA = "Beta"
GA = "GA"


class FeatureGate:
    """Mutable feature gate (k8s component-base featuregate semantics)."""

    def __init__(self, defaults: Mapping[str, tuple]):
        # name -> (default_enabled, prerelease)
        self._specs: Dict[str, tuple] = dict(defaults)
        self._overrides: Dict[str, bool] = {}
        self._lock = threading.RLock()

    def enabled(self, feature: str) -> bool:
        with self._lock:
            if feature in self._overrides:
                return self._overrides[feature]
            spec = self._specs.get(feature)
            return bool(spec and spec[0])

    def set(self, feature: str, value: bool) -> None:
        with self._lock:
            if feature not in self._specs:
                raise KeyError(f"unknown feature gate {feature}")
            self._overrides[feature] = value

    def set_from_map(self, m: Mapping[str, bool]) -> None:
        for k, v in m.items():
            self.set(k, bool(v))

    def parse(self, spec: str) -> None:
        """'A=true,B=false' (the --feature-gates flag format).

        Unparseable values raise, matching component-base's strict boolean
        parsing — a typo must not silently flip a gate."""
        parsed = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, eq, val = part.partition("=")
            val = val.strip().lower()
            if not eq or val in ("true", "1"):
                # bare "Name" means enable, like upstream's map form
                parsed[name.strip()] = True
            elif val in ("false", "0"):
                parsed[name.strip()] = False
            else:
                raise ValueError(
                    f"invalid feature gate value {part!r}: want Name=true|false"
                )
        # apply only after the whole spec parsed AND validated: an error
        # must not leave a half-applied gate set
        unknown = [n for n in parsed if n not in self._specs]
        if unknown:
            raise ValueError(f"unknown feature gates: {', '.join(sorted(unknown))}")
        self.set_from_map(parsed)

    def known(self) -> Dict[str, bool]:
        with self._lock:
            return {k: self.enabled(k) for k in self._specs}


# koordlet gates (koordlet_features.go:146-164)
KOORDLET_FEATURES = {
    "AuditEvents": (False, ALPHA),
    "AuditEventsHTTPHandler": (False, ALPHA),
    "BECPUSuppress": (True, BETA),
    "BECPUManager": (False, ALPHA),
    "BECPUEvict": (False, ALPHA),
    "BEMemoryEvict": (False, ALPHA),
    "CPUBurst": (True, BETA),
    "SystemConfig": (False, ALPHA),
    "RdtResctrl": (True, BETA),
    "CgroupReconcile": (False, ALPHA),
    "NodeTopologyReport": (True, BETA),
    "Accelerators": (False, ALPHA),
    "CPICollector": (False, ALPHA),
    "Libpfm4": (False, ALPHA),
    "PSICollector": (False, ALPHA),
    "BlkIOReconcile": (False, ALPHA),
    "ColdPageCollector": (False, ALPHA),
}

# manager/webhook gates (features.go:28-63)
MANAGER_FEATURES = {
    "PodMutatingWebhook": (True, BETA),
    "PodValidatingWebhook": (True, BETA),
    "ElasticMutatingWebhook": (False, ALPHA),
    "ElasticValidatingWebhook": (False, ALPHA),
    "NodeValidatingWebhook": (False, ALPHA),
    "ConfigMapValidatingWebhook": (False, ALPHA),
    "ColocationProfileSkipMutatingResources": (False, ALPHA),
    "WebhookFramework": (True, BETA),
    "MultiQuotaTree": (False, ALPHA),
    "ElasticQuotaIgnorePodOverhead": (False, ALPHA),
    "ElasticQuotaGuaranteeUsage": (False, ALPHA),
    "DisableDefaultQuota": (False, ALPHA),
    "DisablePVCReservation": (False, ALPHA),
}

# scheduler gates (scheduler_features.go)
SCHEDULER_FEATURES = {
    "CompatibleCSIStorageCapacity": (False, ALPHA),
    "DisableCSIStorageCapacityInformer": (False, ALPHA),
    "CompatiblePodDisruptionBudget": (False, ALPHA),
    "DisablePodDisruptionBudgetInformer": (False, ALPHA),
    "ResizePod": (False, ALPHA),
}

default_koordlet_gate = FeatureGate(KOORDLET_FEATURES)
default_manager_gate = FeatureGate(MANAGER_FEATURES)
default_scheduler_gate = FeatureGate(SCHEDULER_FEATURES)

# qos strategy <-> NodeSLO spec field (IsFeatureDisabled,
# koordlet_features.go:168)
_FEATURE_SLO_FIELD = {
    "BECPUSuppress": "resourceUsedThresholdWithBE",
    "BECPUEvict": "resourceUsedThresholdWithBE",
    "BEMemoryEvict": "resourceUsedThresholdWithBE",
}


def is_feature_disabled(node_slo: Optional[Mapping], feature: str) -> bool:
    """NodeSLO-level disable: the strategy's enable flag wins over the
    gate (koordlet_features.go IsFeatureDisabled)."""
    if not node_slo:
        return True
    field = _FEATURE_SLO_FIELD.get(feature)
    if field is None:
        return False
    cfg = node_slo.get(field) or {}
    return not bool(cfg.get("enable", False))
