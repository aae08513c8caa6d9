"""States informer: node/pod/NodeSLO state + NodeMetric reporting.

Reference: ``pkg/koordlet/statesinformer`` — plugin-registered informers
sync apiserver state into the agent and report back ``NodeMetric.Status``
(``impl/states_nodemetric.go:237 sync``, ``:324 collectMetric``: windowed
AVG node/pod usage plus P50/P90/P95/P99 aggregated usage) and the
NodeResourceTopology CR (``impl/states_noderesourcetopology.go``).

This rebuild keeps the informer as plain state + callbacks (no apiserver in
the loop); the report dicts are the CR payloads the manager controllers
(``koordinator_tpu_torch.manager``) consume directly.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.koordlet import metriccache as mc
from koordinator_tpu_torch.koordlet.collectors import PodMeta
from koordinator_tpu_torch.koordlet.metriccache import MetricCache

DEFAULT_AGGREGATE_DURATION_SECONDS = 300.0  # collect policy default
DEFAULT_REPORT_INTERVAL_SECONDS = 60.0


@dataclasses.dataclass
class CollectPolicy:
    """NodeMetric spec collect policy (reference
    slo-controller/nodemetric/collect_policy.go defaults)."""

    aggregate_duration_seconds: float = DEFAULT_AGGREGATE_DURATION_SECONDS
    report_interval_seconds: float = DEFAULT_REPORT_INTERVAL_SECONDS


class StatesInformer:
    """Holds node/pods/NodeSLO state; thread-safe snapshot accessors
    (states_informer.go:105 GetAllPods/GetNode/GetNodeSLO)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._node: Dict = {}
        self._pods: List[PodMeta] = []
        self._pod_specs: Dict[str, Dict] = {}
        self._node_slo: Dict = {}
        self._node_topo: Dict = {}
        self._devices: List[Dict] = []
        self._plugins: List = []
        self._callbacks: List[Callable[[str], None]] = []

    def register_callback(self, cb: Callable[[str], None]) -> None:
        """reference statesinformer RegisterCallbacks: qosmanager and
        runtimehooks react to state changes."""
        self._callbacks.append(cb)

    def _notify(self, what: str) -> None:
        for cb in self._callbacks:
            cb(what)

    def set_node(self, node: Mapping) -> None:
        with self._lock:
            self._node = dict(node)
        self._notify("node")

    def get_node(self) -> Dict:
        with self._lock:
            return dict(self._node)

    def set_pods(self, pods: Sequence[PodMeta], specs: Optional[Mapping] = None) -> None:
        with self._lock:
            self._pods = list(pods)
            if specs is not None:
                self._pod_specs = dict(specs)
        self._notify("pods")

    def get_all_pods(self) -> List[PodMeta]:
        with self._lock:
            return list(self._pods)

    def sync_from_kubelet(self, stub) -> int:
        """Pull the authoritative pod list from the kubelet endpoint
        (reference ``impl/states_pods.go`` syncPods via the kubelet stub)
        and refresh the informer's pod view.  Returns the pod count."""
        items = stub.get_all_pods()
        pods: List[PodMeta] = []
        specs: Dict[str, Dict] = {}
        for item in items:
            meta = item.get("metadata") or {}
            status = item.get("status") or {}
            labels = meta.get("labels") or {}
            uid = meta.get("uid", meta.get("name", ""))
            pods.append(
                PodMeta(
                    name=meta.get("name", ""),
                    uid=uid,
                    qos=status.get("qosClass", "Burstable"),
                    koord_qos=labels.get("koordinator.sh/qosClass", ""),
                    namespace=meta.get("namespace", "default"),
                )
            )
            specs[uid] = item.get("spec") or {}
        self.set_pods(pods, specs)
        return len(pods)

    def get_pod_spec(self, uid: str) -> Dict:
        with self._lock:
            return dict(self._pod_specs.get(uid, {}))

    def set_node_slo(self, slo: Mapping) -> None:
        with self._lock:
            self._node_slo = dict(slo)
        self._notify("nodeslo")

    def get_node_slo(self) -> Dict:
        with self._lock:
            return dict(self._node_slo)

    def set_node_topo(self, topo: Mapping) -> None:
        with self._lock:
            self._node_topo = dict(topo)
        self._notify("nodetopo")

    def get_node_topo(self) -> Dict:
        with self._lock:
            return dict(self._node_topo)

    def set_devices(self, devices: Sequence[Mapping]) -> None:
        with self._lock:
            self._devices = [dict(d) for d in devices]
        self._notify("devices")

    def get_devices(self) -> List[Dict]:
        with self._lock:
            return [dict(d) for d in self._devices]

    # -- plugin registry (reference impl/registry.go: informer plugins
    # registered by name, set up once, synced by the informer loop) --
    def register_plugin(self, plugin) -> None:
        with self._lock:
            self._plugins.append(plugin)

    def sync_plugins(self, now: float) -> Dict[str, object]:
        """Run every registered informer plugin once; returns name ->
        report (None when a plugin had nothing to publish).  A failing
        plugin is logged and skipped — the reference koordlet continues
        past informer-plugin errors rather than killing the daemon."""
        import logging

        with self._lock:
            plugins = list(self._plugins)
        out: Dict[str, object] = {}
        for p in plugins:
            try:
                out[p.name] = p.sync(now)
            except Exception:
                logging.getLogger(__name__).exception(
                    "informer plugin %s sync failed", p.name
                )
                out[p.name] = None
        return out


class NodeMetricReporter:
    """Builds the NodeMetric.Status payload (states_nodemetric.go:324
    collectMetric): window AVG node/system/pod usage plus the aggregated
    P50/P90/P95/P99 node usage the LoadAware plugin's aggregated mode and
    the prod-usage estimator consume."""

    def __init__(
        self,
        cache: MetricCache,
        informer: StatesInformer,
        policy: Optional[CollectPolicy] = None,
    ):
        self.cache = cache
        self.informer = informer
        self.policy = policy or CollectPolicy()

    def _node_usage(self, start: float, end: float, agg: str) -> Optional[Dict]:
        cpu = self.cache.query(mc.NODE_CPU_USAGE, start=start, end=end, agg=agg)
        memory = self.cache.query(mc.NODE_MEMORY_USAGE, start=start, end=end, agg=agg)
        if cpu is None and memory is None:
            return None
        return {
            "cpu": f"{int(round((cpu or 0.0) * 1000))}m",
            "memory": str(int(memory or 0)),
        }

    def collect(self, now: float) -> Optional[Dict]:
        """One NodeMetric.Status dict, or None when metrics are absent
        (the manager then degrades, noderesource degradeCalculate)."""
        start = now - self.policy.aggregate_duration_seconds
        node_usage = self._node_usage(start, now, mc.AGG_AVG)
        if node_usage is None:
            return None

        pods_usage = []
        for pod in self.informer.get_all_pods():
            labels = {"pod": pod.uid}
            cpu = self.cache.query(
                mc.POD_CPU_USAGE, start=start, end=now, agg=mc.AGG_AVG, labels=labels
            )
            memory = self.cache.query(
                mc.POD_MEMORY_USAGE,
                start=start,
                end=now,
                agg=mc.AGG_AVG,
                labels=labels,
            )
            if cpu is None and memory is None:
                continue
            pods_usage.append(
                {
                    "namespace": pod.namespace,
                    "name": pod.name,
                    "uid": pod.uid,
                    "usage": {
                        "cpu": f"{int(round((cpu or 0.0) * 1000))}m",
                        "memory": str(int(memory or 0)),
                    },
                }
            )

        sys_cpu = self.cache.query(
            mc.SYS_CPU_USAGE, start=start, end=now, agg=mc.AGG_AVG
        )
        aggregated = {
            name: usage
            for name, agg in (
                ("p50", mc.AGG_P50),
                ("p90", mc.AGG_P90),
                ("p95", mc.AGG_P95),
                ("p99", mc.AGG_P99),
            )
            if (usage := self._node_usage(start, now, agg)) is not None
        }
        return {
            "updateTime": now,
            "nodeMetric": {
                "nodeUsage": node_usage,
                "systemUsage": (
                    {"cpu": f"{int(round((sys_cpu or 0.0) * 1000))}m"}
                    if sys_cpu is not None
                    else {}
                ),
                "aggregatedNodeUsages": aggregated,
            },
            "podsMetric": pods_usage,
        }


class NodeTopoReporter:
    """NodeResourceTopology producer (reference
    ``impl/states_noderesourcetopology.go``): reads the host CPU/NUMA
    layout from sysfs, builds the NRT report — per-NUMA-zone allocatable
    resources plus the CPU topology detail the scheduler's cpuset
    accumulator consumes (``scheduler/topology_options.go``) — and
    publishes it through the informer store.

    The report dict IS the CR payload: the scheduler side turns a set of
    them into the NodeNUMAResource plugin's ZoneBatch extras via
    ``zones_from_node_topos`` + ``model.topology.encode_zones``.
    """

    name = "nodetopo"

    def __init__(self, fs, informer: StatesInformer, node_name: str = ""):
        self.fs = fs
        self.informer = informer
        self.node_name = node_name
        self._last: Optional[Dict] = None

    def build(self) -> Optional[Dict]:
        detail = self.fs.cpu_topology()
        if not detail:
            return None
        zones = []
        for numa in sorted({node for _, _, node, _ in detail}):
            cpus = [c for c, _, node, _ in detail if node == numa]
            zones.append(
                {
                    "name": f"node-{numa}",
                    "type": "Node",
                    "resources": {
                        "cpu": f"{len(cpus) * 1000}m",
                        "memory": self.fs.numa_node_memory_bytes(numa),
                    },
                    "cpus": cpus,
                }
            )
        return {
            "name": self.node_name,
            "zones": zones,
            "cpuTopology": {
                "detail": [
                    {"cpu": c, "core": core, "node": node, "socket": sock}
                    for c, core, node, sock in detail
                ]
            },
        }

    def sync(self, now: float) -> Optional[Dict]:
        report = self.build()
        # publish (and fire informer callbacks) only on change: the
        # topology is static, so every tick re-notifying qosmanager /
        # runtimehooks reactions would be pure churn
        if report is not None and report != self._last:
            self.informer.set_node_topo(report)
            self._last = report
        return report


class DeviceReporter:
    """Device CR producer (reference ``impl/states_device.go``: the GPU
    device informer reports the Device CR the DeviceShare plugin
    consumes; here accelerators come from CUDA enumeration)."""

    name = "device"

    def __init__(self, informer: StatesInformer, devices_fn=None):
        self.informer = informer
        if devices_fn is None:
            from koordinator_tpu_torch.koordlet.collectors import _cuda_devices

            devices_fn = _cuda_devices
        self.devices_fn = devices_fn
        self._last: Optional[List[Dict]] = None

    def sync(self, now: float) -> List[Dict]:
        devices = []
        for dev in self.devices_fn():
            # the default enumeration (collectors._cuda_devices) yields
            # {"minor", "platform", "memory_used"}; only accelerators become CR entries —
            # a CPU-only host must not publish phantom devices
            dev_type = dev.get("type") or dev.get("platform", "")
            if dev_type in ("", "cpu"):
                continue
            devices.append(
                {
                    "type": dev_type,
                    "minor": int(dev.get("minor", 0)),
                    "health": bool(dev.get("health", True)),
                    "resources": dev.get("resources", {}),
                    "topology": {"numaNode": int(dev.get("numa_node", 0))},
                }
            )
        # publish (and fire informer callbacks) only on change, like
        # NodeTopoReporter — device lists are near-static
        if devices != self._last:
            self.informer.set_devices(devices)
            self._last = devices
        return devices


def zones_from_node_topos(topos: Sequence[Mapping]) -> List[Dict]:
    """Adapt published NRT reports into the node-dict shape
    ``model.topology.encode_zones`` consumes — the producer half feeding
    the scheduler's NodeNUMAResource zone tensors, replacing hand-built
    test fixtures (round-3 review #6)."""
    out: List[Dict] = []
    for topo in topos:
        out.append(
            {
                "name": topo.get("name", ""),
                "zones": [
                    {
                        "allocatable": z.get("resources", {}),
                        "requested": z.get("requested", {}),
                    }
                    for z in topo.get("zones", ())
                ],
                "cpu_amplification": topo.get("cpu_amplification"),
            }
        )
    return out


def device_nodes_from_informers(
    device_lists: Sequence[Sequence[Mapping]],
) -> List[Dict]:
    """Adapt published Device CRs (DeviceReporter output, one list per
    node) into the node-dict shape ``model.device.encode_devices``
    consumes — the producer half feeding the DeviceShare plugin's
    tensors, mirroring ``zones_from_node_topos`` for NRT.

    Unhealthy devices stay IN the list (``encode_devices`` keeps their
    minor slot with ``valid=False``) — dropping one would renumber its
    neighbors, and slot index is the device identity the Reserve path
    reports back."""
    out: List[Dict] = []
    for devices in device_lists:
        out.append(
            {
                "devices": [
                    {
                        "type": d.get("type", "gpu"),
                        "minor": d.get("minor", 0),
                        "total": d.get("resources", {}),
                        "topology": d.get("topology", {}),
                        "health": bool(d.get("health", True)),
                    }
                    for d in devices
                ]
            }
        )
    return out
