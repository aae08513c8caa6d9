"""Profile-based descheduler runtime + main loop.

The port's own copy of ``koordinator_tpu/descheduler/runtime.py``.

Mirrors the reference's own plugin framework (NOT upstream descheduler):

* ``DeschedulerProfile`` / plugin registry / framework instance —
  reference ``pkg/descheduler/framework/runtime/framework.go:121
  NewFramework``, plugin sets per extension point
  (``framework/types.go:80 DeschedulePlugin``, ``:85 BalancePlugin``).
* ``Framework.run_deschedule_plugins`` / ``run_balance_plugins`` —
  ``framework/runtime/framework.go:310,330`` (aggregate errors, keep
  running remaining plugins).
* ``Descheduler.descheduler_once`` — ``pkg/descheduler/descheduler.go:259``:
  ready-node gate (<= 1 node aborts the tick), eviction-limiter reset,
  ALL profiles' Deschedule plugins then ALL profiles' Balance plugins.
* ``Descheduler.start`` — ``descheduler.go:241``: non-sliding ticks at
  ``descheduling_interval``; interval 0 = run once.

Evictions flow LowNodeLoad -> MigrationController (PodMigrationJob
arbitration/reservation) -> PodEvictor, the reference's
MigrationController evictor path (``controllers/migration/controller.go``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.descheduler.anomaly import BasicDetector
from koordinator_tpu_torch.descheduler.evictions import PodEvictor
from koordinator_tpu_torch.descheduler.k8s_plugins import (
    DefaultEvictorArgs,
    default_evictor_filter,
    pod_life_time,
    remove_duplicates,
    remove_failed_pods,
    remove_pods_having_too_many_restarts,
    remove_pods_violating_interpod_antiaffinity,
    remove_pods_violating_node_affinity,
    remove_pods_violating_node_taints,
    remove_pods_violating_topology_spread,
    TooManyRestartsArgs,
)
from koordinator_tpu_torch.descheduler.lownodeload import LowNodeLoadArgs, balance
from koordinator_tpu_torch.descheduler.migration import (
    MigrationController,
    MigrationControllerArgs,
    MigrationJob,
)


@dataclasses.dataclass
class Status:
    """framework.Status (framework/types.go:32): nil err = success."""

    err: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.err is None


@dataclasses.dataclass
class PluginSet:
    """Enabled plugin names per extension point (profile plugin sets)."""

    deschedule: Sequence[str] = ()
    balance: Sequence[str] = ()
    evict: Sequence[str] = ("MigrationController",)


@dataclasses.dataclass
class DeschedulerProfile:
    """config.DeschedulerProfile: name + plugin set + per-plugin args."""

    name: str = "default"
    plugins: PluginSet = dataclasses.field(default_factory=PluginSet)
    plugin_config: Mapping[str, object] = dataclasses.field(default_factory=dict)


class Framework:
    """One profile's instantiated plugins + shared handle state
    (framework/runtime/framework.go:121 NewFramework)."""

    def __init__(
        self,
        profile: DeschedulerProfile,
        registry: Mapping[str, Callable],
        evictor: PodEvictor,
        migration: Optional[MigrationController] = None,
        dry_run: bool = False,
    ):
        self.profile = profile
        self.evictor = evictor
        self.migration = migration
        self.dry_run = dry_run
        self.planned_only: List[Mapping] = []  # dry-run audit trail
        self.detectors: Dict[str, BasicDetector] = {}
        self._deschedule = []
        self._balance = []
        for name in profile.plugins.deschedule:
            if name not in registry:
                raise ValueError(f"unknown deschedule plugin {name!r}")
            self._deschedule.append((name, registry[name](self, profile.plugin_config.get(name))))
        for name in profile.plugins.balance:
            if name not in registry:
                raise ValueError(f"unknown balance plugin {name!r}")
            self._balance.append((name, registry[name](self, profile.plugin_config.get(name))))

    # -- Evictor handle (evictorProxy, framework.go:294): plugins call
    # this; it routes through the MigrationController when the profile's
    # evict plugin set enables it --
    def evict(self, pod: Mapping, node: str, reason: str = "") -> bool:
        if self.dry_run:
            # evictorProxy dry-run: report the decision, touch nothing
            self.planned_only.append(
                {"pod": pod.get("name"), "node": node, "reason": reason}
            )
            return True
        if (
            self.migration is not None
            and "MigrationController" in self.profile.plugins.evict
        ):
            job = self.migration.submit(
                MigrationJob(
                    name=f"mj-{pod.get('namespace', 'default')}-{pod.get('name')}",
                    pod=dict(pod, node=node),
                    reason=reason,
                    creation_time=self._now,
                )
            )
            return job is not None
        return self.evictor.evict(pod, node, reason=reason)

    _now: float = 0.0

    def run_deschedule_plugins(self, nodes: Sequence[Mapping]) -> Status:
        errs = []
        for name, fn in self._deschedule:
            try:
                fn(nodes)
            except Exception as exc:  # keep running remaining plugins
                errs.append(f"{name}: {exc}")
        return Status("; ".join(errs) or None)

    def run_balance_plugins(self, nodes: Sequence[Mapping]) -> Status:
        errs = []
        for name, fn in self._balance:
            try:
                fn(nodes)
            except Exception as exc:
                errs.append(f"{name}: {exc}")
        return Status("; ".join(errs) or None)


# ---------------------------------------------------------------------------
# Built-in plugin registry (framework/plugins/registry.go:26)
# ---------------------------------------------------------------------------


def _low_node_load(fw: Framework, args) -> Callable:
    args = args or LowNodeLoadArgs()
    evictor_args = DefaultEvictorArgs()

    def run(nodes):
        balance(
            args,
            nodes,
            # route through the framework's evictor proxy so the
            # MigrationController path applies
            _EvictorAdapter(fw),
            detectors=fw.detectors,
            pod_filter=lambda p: not default_evictor_filter(p, evictor_args),
            now=fw._now,
        )

    return run


class _EvictorAdapter:
    """PodEvictor look-alike routing evictions through Framework.evict."""

    def __init__(self, fw: Framework):
        self.fw = fw

    def evict(self, pod, node, reason=""):
        return self.fw.evict(pod, node, reason=reason)


def _deschedule_adaptor(reason: str, select):
    """Wrap the k8s-descheduler adaptor plugins (k8s_plugins.py) as
    Deschedule plugins evicting through the framework.  ``select(pods,
    nodes, args, now)`` returns the victims per node; ``reason`` names
    the plugin in the eviction audit trail.  ``now`` is the framework's
    tick clock so age gates stay fake-clock-testable."""

    def factory(fw: Framework, args):
        def run(nodes):
            for nd in nodes:
                pods = nd.get("pods", [])
                for pod in select(pods, nodes, args, fw._now):
                    fw.evict(pod, nd["name"], reason=reason)

        return run

    return factory


def _cluster_deschedule_adaptor(reason: str, select):
    """Like _deschedule_adaptor but selection sees the CLUSTER-WIDE pod
    set in one call — required for plugins whose decision is a global
    property (topology spread skew is computed across every domain; a
    per-node view would see counts like (3, 0) in a balanced cluster and
    evict from every node)."""

    def factory(fw: Framework, args):
        def run(nodes):
            node_of = {}
            all_pods = []
            for nd in nodes:
                for pod in nd.get("pods", []):
                    all_pods.append(pod)
                    node_of[id(pod)] = nd["name"]
            for pod in select(all_pods, nodes, args, fw._now):
                fw.evict(
                    pod,
                    node_of.get(id(pod), pod.get("node", "")),
                    reason=reason,
                )

        return run

    return factory


DEFAULT_REGISTRY: Dict[str, Callable] = {
    "LowNodeLoad": _low_node_load,
    "RemovePodsHavingTooManyRestarts": _deschedule_adaptor(
        "RemovePodsHavingTooManyRestarts",
        lambda pods, nodes, args, now: remove_pods_having_too_many_restarts(
            pods, args or TooManyRestartsArgs()
        ),
    ),
    "RemoveDuplicates": _deschedule_adaptor(
        "RemoveDuplicates",
        lambda pods, nodes, args, now: remove_duplicates(pods),
    ),
    "RemovePodsViolatingNodeAffinity": _deschedule_adaptor(
        "RemovePodsViolatingNodeAffinity",
        lambda pods, nodes, args, now: remove_pods_violating_node_affinity(
            pods, nodes
        ),
    ),
    "RemovePodsViolatingInterPodAntiAffinity": _deschedule_adaptor(
        "RemovePodsViolatingInterPodAntiAffinity",
        lambda pods, nodes, args, now: (
            remove_pods_violating_interpod_antiaffinity(pods)
        ),
    ),
    "RemovePodsViolatingNodeTaints": _deschedule_adaptor(
        "RemovePodsViolatingNodeTaints",
        lambda pods, nodes, args, now: remove_pods_violating_node_taints(
            pods, nodes, args
        ),
    ),
    "RemoveFailedPods": _deschedule_adaptor(
        "RemoveFailedPods",
        lambda pods, nodes, args, now: remove_failed_pods(pods, args, now=now),
    ),
    "PodLifeTime": _deschedule_adaptor(
        "PodLifeTime",
        lambda pods, nodes, args, now: pod_life_time(pods, args, now=now),
    ),
    "RemovePodsViolatingTopologySpreadConstraint": _cluster_deschedule_adaptor(
        "RemovePodsViolatingTopologySpreadConstraint",
        lambda pods, nodes, args, now: remove_pods_violating_topology_spread(
            pods, nodes, args
        ),
    ),
}


class Descheduler:
    """The ticking main loop (descheduler.go:241 Start, :259
    deschedulerOnce)."""

    def __init__(
        self,
        profiles: Sequence[DeschedulerProfile],
        nodes_fn: Callable[[], List[Mapping]],
        descheduling_interval: float = 120.0,
        node_selector: Optional[Mapping[str, str]] = None,
        evictor: Optional[PodEvictor] = None,
        migration: Optional[MigrationController] = None,
        registry: Optional[Mapping[str, Callable]] = None,
        dry_run: bool = False,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.nodes_fn = nodes_fn
        self.descheduling_interval = descheduling_interval
        self.node_selector = node_selector or {}
        self.evictor = evictor or PodEvictor()
        self.migration = migration
        self.clock = clock
        self.frameworks = [
            Framework(
                p,
                registry or DEFAULT_REGISTRY,
                self.evictor,
                migration=migration,
                dry_run=dry_run,
            )
            for p in profiles
        ]

    def _ready_nodes(self) -> List[Mapping]:
        nodes = [
            nd
            for nd in self.nodes_fn()
            if not nd.get("unschedulable")
            and not nd.get("not_ready")
            and all(
                nd.get("labels", {}).get(k) == v
                for k, v in self.node_selector.items()
            )
        ]
        return nodes

    def descheduler_once(self) -> Status:
        """descheduler.go:259: one full tick."""
        nodes = self._ready_nodes()
        if len(nodes) <= 1:
            return Status(
                "the cluster size is 0 or 1 meaning eviction causes service "
                "disruption or degradation"
            )
        now = self.clock()
        self.evictor.reset()
        for fw in self.frameworks:
            fw._now = now
            fw.planned_only.clear()  # per-tick dry-run decisions
        # ALL profiles' Deschedule plugins run before ANY Balance plugin;
        # one broken profile must not stall the others or the migration
        # reconcile (errors aggregate, like the framework's plugin loops)
        errs = []
        for fw in self.frameworks:
            status = fw.run_deschedule_plugins(nodes)
            if not status.ok:
                errs.append(status.err)
        for fw in self.frameworks:
            status = fw.run_balance_plugins(nodes)
            if not status.ok:
                errs.append(status.err)
        if self.migration is not None:
            self.migration.reconcile(now)
        return Status("; ".join(errs) or None)

    def start(self, max_ticks: Optional[int] = None, sleep=time.sleep) -> None:
        """descheduler.go:241: non-sliding until loop; interval 0 = once."""
        ticks = 0
        while True:
            self.descheduler_once()
            ticks += 1
            if self.descheduling_interval <= 0:
                return
            if max_ticks is not None and ticks >= max_ticks:
                return
            sleep(self.descheduling_interval)
