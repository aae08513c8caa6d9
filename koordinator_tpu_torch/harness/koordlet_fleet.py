"""The node agent's side of the extended-plugin cycle, and a koordlet daemon
driven over a synthetic node.

The scheduler's NodeNUMAResource, DeviceShare and LoadAware inputs come
from three koordlet reporters (``koordlet/statesinformer.py``):
``NodeTopoReporter`` (the NUMA zones), ``DeviceReporter`` (the Device CRs)
and ``NodeMetricReporter`` (the node usage).  ``fleet_snapshot`` runs one
``StatesInformer`` with those three reporters for every node of the
extras scenario (``extras_scenario.extras_snapshot``):

* the topology reporter reads a synthetic sysfs tree with the node's NUMA
  layout: ``NUMA_NODES`` NUMA nodes, the node's whole CPUs and its memory
  split between them.  Nodes of one shape share one tree;
* the device reporter enumerates the GPU minors and the RDMA NIC that
  the node advertises in its allocatable;
* the metric reporter reads a ``MetricCache`` of ``SAMPLES`` seeded
  samples per metric whose window average is the node's usage.

The reports then go through ``zones_from_node_topos``,
``device_nodes_from_informers`` and ``nodeUsage -> node["usage"]`` into
the snapshot and its zone and device tables.

``qos_daemon`` and ``run_qos_ticks`` drive ``build_default_daemon`` over a
synthetic node tree whose ``/proc`` and cgroup counters advance from a
seed between ``QOS_TICKS`` fake-clock ticks; ``tree_digest`` hashes what
is under the root after each tick.

The code here is numpy and the standard library only: it takes the
package it drives as ``impl`` (``port_impl`` is this package), so the same
code drives any package with the same module layout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import types
from typing import Dict, List, Sequence

import numpy as np

NUMA_NODES = 2
THREADS_PER_CORE = 2
SAMPLES = 8  # samples per metric and node, in the aggregation window
SAMPLE_STEP_S = 10.0
REPORT_NOW = 100_000.0
GPU_CORE = "koordinator.sh/gpu-core"
GPU_MEMORY = "koordinator.sh/gpu-memory"
GPU_RATIO = "koordinator.sh/gpu-memory-ratio"
RDMA = "koordinator.sh/rdma"


def port_impl(device) -> types.SimpleNamespace:
    """This package's modules, as ``fleet_snapshot`` and ``qos_daemon``
    take them; ``device`` is given to every encoder."""
    from koordinator_tpu_torch.harness import extras_scenario, generators
    from koordinator_tpu_torch.koordlet import collectors, daemon, metriccache
    from koordinator_tpu_torch.koordlet import statesinformer, sysfs
    from koordinator_tpu_torch.model import device as device_model
    from koordinator_tpu_torch.model import topology

    return types.SimpleNamespace(
        generators=generators, extras_scenario=extras_scenario, topology=topology,
        device=device_model, statesinformer=statesinformer, metriccache=metriccache,
        sysfs=sysfs, collectors=collectors, daemon=daemon,
        encode_kw={"device": device},
    )


# ---------------------------------------------------------------------------
# the fleet's synthetic sysfs trees
# ---------------------------------------------------------------------------


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def node_shape(node) -> tuple:
    """(whole CPUs, memory bytes) of a node dict's allocatable."""
    cpu = node["allocatable"]["cpu"]
    milli = int(cpu[:-1]) if isinstance(cpu, str) and cpu.endswith("m") else int(cpu) * 1000
    return milli // 1000, int(node["allocatable"]["memory"])


def write_topology(root: str, cpus: int, mem_bytes: int) -> None:
    """A sysfs tree of ``NUMA_NODES`` NUMA nodes splitting ``cpus`` logical
    CPUs (``THREADS_PER_CORE`` to a core, contiguous ids) and ``mem_bytes``
    (whole kB, the remainder on the last node)."""
    numa = NUMA_NODES
    per = [cpus // numa + (1 if n < cpus % numa else 0) for n in range(numa)]
    kb = mem_bytes // 1024
    mem_kb = [kb // numa] * (numa - 1) + [kb - kb // numa * (numa - 1)]
    cpu = 0
    for n in range(numa):
        base = os.path.join(root, "sys", "devices", "system", "node", f"node{n}")
        first, last = cpu, cpu + per[n] - 1
        _write(os.path.join(base, "cpulist"), f"{first}-{last}\n" if per[n] else "\n")
        _write(os.path.join(base, "meminfo"), f"Node {n} MemTotal: {mem_kb[n]} kB\n")
        for c in range(first, last + 1):
            topo = os.path.join(root, "sys", "devices", "system", "cpu", f"cpu{c}", "topology")
            _write(os.path.join(topo, "core_id"), f"{c // THREADS_PER_CORE}\n")
            _write(os.path.join(topo, "physical_package_id"), f"{n}\n")
        cpu = last + 1


def build_trees(base: str, nodes: Sequence[Dict]) -> List[str]:
    """One tree under ``base`` per distinct node shape; the root of each
    node's tree, in node order."""
    roots: Dict[tuple, str] = {}
    out = []
    for nd in nodes:
        shape = node_shape(nd)
        if shape not in roots:
            roots[shape] = os.path.join(base, f"shape{len(roots)}")
            write_topology(roots[shape], *shape)
        out.append(roots[shape])
    return out


def tree_files(roots: Sequence[str]) -> List[str]:
    """Every file of the distinct trees among ``roots``, sorted."""
    out = []
    for root in sorted(set(roots)):
        for d, _, names in os.walk(root):
            out.extend(os.path.join(d, n) for n in names)
    return sorted(out)


# ---------------------------------------------------------------------------
# devices and usage samples
# ---------------------------------------------------------------------------


def node_devices(node) -> List[Dict]:
    """The devices a node advertises in its allocatable, as a device
    enumeration yields them: ``gpu-core // 100`` GPU minors sharing the
    GPU memory evenly, spread over the NUMA nodes, and one RDMA NIC when
    the node has RDMA."""
    alloc = node["allocatable"]
    gpus = int(alloc.get(GPU_CORE, 0)) // 100
    out = [{
        "type": "gpu", "minor": m, "numa_node": m * NUMA_NODES // gpus,
        "resources": {GPU_CORE: 100, GPU_MEMORY: int(alloc.get(GPU_MEMORY, 0)) // gpus,
                      GPU_RATIO: 100},
    } for m in range(gpus)]
    if int(alloc.get(RDMA, 0)):
        out.append({"type": "rdma", "minor": 0, "numa_node": 0,
                    "resources": {RDMA: int(alloc[RDMA])}})
    return out


def usage_samples(nodes: Sequence[Dict], seed: int):
    """(cpu cores f64[N, SAMPLES], memory bytes f64[N, SAMPLES]): pairs
    of seeded samples on either side of each node's usage, so the window
    average is the usage (exactly for memory, to the milli-CPU for cpu)."""
    rng = np.random.RandomState(seed)
    cpu = np.asarray([int(nd["usage"]["cpu"][:-1]) for nd in nodes], np.int64)
    mem = np.asarray([int(nd["usage"]["memory"]) for nd in nodes], np.int64)
    half = SAMPLES // 2
    dc = (rng.uniform(0, 1, (len(nodes), half)) * cpu[:, None]).astype(np.int64)
    dm = (rng.uniform(0, 1, (len(nodes), half)) * mem[:, None]).astype(np.int64)
    cpu_s = np.concatenate([cpu[:, None] + dc, cpu[:, None] - dc], 1) / 1000.0
    mem_s = np.concatenate([mem[:, None] + dm, mem[:, None] - dm], 1).astype(np.float64)
    return cpu_s, mem_s


# ---------------------------------------------------------------------------
# the reports and the snapshot
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetReports:
    topos: List[Dict]  # NodeTopoReporter's NRT report, per node
    devices: List[List[Dict]]  # DeviceReporter's Device CR entries, per node
    usages: List[Dict]  # NodeMetricReporter's nodeUsage, per node
    node_seconds: List[float]  # each node's report pass
    trees: int  # distinct sysfs trees
    wall_s: float  # the pass over every node


def fleet_reports(impl, nodes: Sequence[Dict], roots: Sequence[str], seed: int) -> FleetReports:
    """Run the three reporters of every node through its own
    ``StatesInformer`` at ``REPORT_NOW``; raises when a reporter publishes
    nothing."""
    si, mc = impl.statesinformer, impl.metriccache
    now = REPORT_NOW
    cpu_s, mem_s = usage_samples(nodes, seed)
    ts = now - SAMPLE_STEP_S * np.arange(SAMPLES, 0, -1)
    topos, device_lists, usages, seconds = [], [], [], []
    wall = time.perf_counter()
    for i, nd in enumerate(nodes):
        cache = mc.MetricCache(capacity_per_series=SAMPLES)
        for k in range(SAMPLES):
            cache.append(mc.NODE_CPU_USAGE, float(cpu_s[i, k]), ts=float(ts[k]))
            cache.append(mc.NODE_MEMORY_USAGE, float(mem_s[i, k]), ts=float(ts[k]))
        devs = node_devices(nd)
        t0 = time.perf_counter()
        informer = si.StatesInformer()
        informer.register_plugin(si.NodeTopoReporter(
            impl.sysfs.SysFS(root=roots[i]), informer, nd["name"]))
        informer.register_plugin(si.DeviceReporter(informer, devices_fn=lambda: devs))
        synced = informer.sync_plugins(now)
        metric = si.NodeMetricReporter(cache, informer).collect(now)
        seconds.append(time.perf_counter() - t0)
        if synced.get("nodetopo") is None or synced.get("device") is None or metric is None:
            raise RuntimeError(f"node {nd['name']}: a reporter published nothing: "
                               f"{sorted(k for k, v in synced.items() if v is None)}")
        topos.append(informer.get_node_topo())
        device_lists.append(informer.get_devices())
        usages.append(metric["nodeMetric"]["nodeUsage"])
    return FleetReports(topos, device_lists, usages, seconds, len(set(roots)),
                        time.perf_counter() - wall)


@dataclasses.dataclass
class Fleet:
    snapshot: object
    zones: object
    policy: np.ndarray
    devices: object
    rsv: object
    nodes: List[Dict]  # the scenario's node dicts
    pods: List[Dict]
    reports: FleetReports
    adapt_encode_s: float

    @property
    def tables(self):
        return self.zones, self.policy, self.devices, self.rsv


def fleet_snapshot(base: str, impl, seed: int = 0, pods: int = 10000, nodes: int = 2000,
                   tenants: int = 16) -> Fleet:
    """The extras scenario (``extras_snapshot``'s recipe) with its usage,
    zones and devices built from the koordlet reports of every node, the
    sysfs trees under ``base``.  The reservations and the NUMA policy
    stay the scenario's."""
    kw = impl.encode_kw
    node_list, pod_list, gangs, quotas = impl.generators.quota_colocation(
        seed=seed, pods=pods, nodes=nodes, tenants=tenants)
    _, policy, _, rsv, node_list, pod_list = impl.extras_scenario.extras_scenario(
        node_list, pod_list, seed=0, node_bucket=nodes, pod_bucket=pods, **kw)
    reports = fleet_reports(impl, node_list, build_trees(base, node_list), seed)
    t0 = time.perf_counter()
    si = impl.statesinformer
    fleet_nodes = [dict(nd, usage=u) for nd, u in zip(node_list, reports.usages)]
    zones = impl.topology.encode_zones(si.zones_from_node_topos(reports.topos),
                                       node_bucket=nodes, **kw)
    devices = impl.device.encode_devices(
        si.device_nodes_from_informers(reports.devices), node_bucket=nodes, **kw)
    snap, _ = impl.generators.encode_quota_lists(
        fleet_nodes, pod_list, gangs, quotas, node_bucket=nodes, pod_bucket=pods, **kw)
    return Fleet(snap, zones, policy, devices, rsv, node_list, pod_list,
                 reports, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# a koordlet daemon over a synthetic node
# ---------------------------------------------------------------------------

QOS_TICKS = 16
QOS_STEP_S = 10.0
QOS_T0 = 1_000.0
QOS_CPUS = 8
QOS_MEMORY = 16 << 30
QOS_NODE = {"name": "koordlet-0", "capacity_milli_cpu": QOS_CPUS * 1000,
            "capacity_memory_bytes": QOS_MEMORY}
# (name, kubelet QoS, koord QoS, request milli, limit milli, priority, pid)
QOS_PODS = (
    ("ls-0", "Burstable", "LS", 2000, 4000, 9100, 101),
    ("ls-1", "Burstable", "LS", 1000, 2000, 9050, 102),
    ("lsr-0", "Guaranteed", "LSR", 2000, 2000, 9500, 103),
    ("be-0", "BestEffort", "BE", 1000, 0, 5100, 201),
    ("be-1", "BestEffort", "BE", 2000, 0, 5050, 202),
    ("be-2", "BestEffort", "BE", 500, 0, 5200, 203),
)
QOS_NODE_SLO = {
    "resourceUsedThresholdWithBE": {
        "enable": True, "cpuSuppressThresholdPercent": 65,
        "cpuEvictPolicy": "evictByRealLimit", "cpuEvictBESatisfactionLowerPercent": 60,
        "memoryEvictThresholdPercent": 70, "memoryEvictLowerPercent": 65,
    },
    "cpuBurstStrategy": {"policy": "auto", "cpuBurstPercent": 300},
    "resctrlQOS": {
        "enable": True,
        "lsClass": {"resctrlQOS": {"catRangeStartPercent": 0, "catRangeEndPercent": 100,
                                   "mbaPercent": 100}},
        "beClass": {"resctrlQOS": {"catRangeStartPercent": 0, "catRangeEndPercent": 30,
                                   "mbaPercent": 40}},
    },
    "blkioQOS": [{"device": "253:0", "readBPS": 104857600, "writeBPS": 52428800}],
    "systemStrategy": {"minFreeKbytesFactor": 100, "watermarkScaleFactor": 150},
}


def _pod_dir(qos: str, uid: str) -> str:
    if qos == "Guaranteed":
        return f"kubepods/pod{uid}"
    if qos == "BestEffort":
        return f"kubepods/besteffort/pod{uid}"
    return f"kubepods/burstable/pod{uid}"


class QosTree:
    """The synthetic node's ``/proc`` and cgroup v2 counters under
    ``root``, advanced by ``tick`` from a seed."""

    def __init__(self, root: str, seed: int):
        self.root = root
        self.rng = np.random.RandomState(seed)
        self.stat = np.zeros(8, np.int64)  # user nice system idle iowait irq softirq steal
        self.be_usec = 0
        self.psi_total = 0
        self.available = QOS_MEMORY * 3 // 4
        write_topology(root, QOS_CPUS, QOS_MEMORY)
        for name, qos, _, _, _, _, pid in QOS_PODS:
            _write(self._cg(_pod_dir(qos, name), "cgroup.procs"), f"{pid}\n")
        self._write_counters()

    def _cg(self, *parts: str) -> str:
        return os.path.join(self.root, "sys", "fs", "cgroup", *parts)

    def tick(self) -> None:
        """Advance every counter by one step of seeded load."""
        step_ticks = int(QOS_STEP_S * 100) * QOS_CPUS
        busy = int(step_ticks * self.rng.uniform(0.3, 0.95))
        self.stat += np.asarray([busy * 7 // 10, 0, busy - busy * 7 // 10,
                                 step_ticks - busy, 0, 0, 0, 0], np.int64)
        self.be_usec += int(QOS_STEP_S * 1e6 * self.rng.uniform(0.2, 2.5))
        self.psi_total += int(self.rng.randint(0, 50_000))
        self.available = int(np.clip(
            self.available - self.rng.randint(-1, 4) * (256 << 20), 1 << 30, QOS_MEMORY))
        self._write_counters()

    def _write_counters(self) -> None:
        cpu = " ".join(str(int(v)) for v in self.stat)
        _write(os.path.join(self.root, "proc", "stat"), f"cpu  {cpu} 0 0\n")
        _write(os.path.join(self.root, "proc", "meminfo"),
               f"MemTotal: {QOS_MEMORY // 1024} kB\nMemFree: {self.available // 2048} kB\n"
               f"MemAvailable: {self.available // 1024} kB\n")
        _write(self._cg("kubepods", "besteffort", "cpu.stat"),
               f"usage_usec {self.be_usec}\nuser_usec {self.be_usec // 2}\n")
        avg = self.psi_total % 1000 / 100
        for res in ("cpu.pressure", "memory.pressure", "io.pressure"):
            _write(self._cg(res), f"some avg10={avg:.2f} avg60=0.00 avg300=0.00 "
                                  f"total={self.psi_total}\n"
                                  f"full avg10=0.00 avg60=0.00 avg300=0.00 total=0\n")


def qos_daemon(impl, root: str):
    """``build_default_daemon`` over ``root`` with the node, the pods and
    the NodeSLO that enable every QoS strategy."""
    d = impl.daemon.build_default_daemon(cgroup_root=root, node_name=QOS_NODE["name"])
    d.informer.set_node(QOS_NODE)
    pods = [impl.collectors.PodMeta(name=name, uid=name, qos=qos, koord_qos=koord)
            for name, qos, koord, *_ in QOS_PODS]
    specs = {name: {"request_milli_cpu": req, "limit_milli_cpu": lim, "priority": prio}
             for name, _, _, req, lim, prio, _ in QOS_PODS}
    d.informer.set_pods(pods, specs)
    d.informer.set_node_slo(QOS_NODE_SLO)
    return d


def tree_digest(h, root: str) -> None:
    """Feed ``h`` every file under ``root``: its path relative to the root,
    then its bytes, in path order."""
    paths = []
    for d, _, names in os.walk(root):
        paths.extend(os.path.join(d, n) for n in names)
    for path in sorted(paths):
        h.update(os.path.relpath(path, root).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read() + b"\0")


def run_qos_ticks(d, tree: QosTree) -> tuple:
    """``QOS_TICKS`` fake-clock ticks of the daemon, the tree advanced before
    each.  Returns (sha256 over the tree after every tick and the
    evictions so far, the strategies each tick ran, each tick's ms)."""
    h = hashlib.sha256()
    ran, tick_ms = [], []
    for k in range(QOS_TICKS):
        tree.tick()
        t0 = time.perf_counter()
        out = d.run_once(now=QOS_T0 + QOS_STEP_S * k)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        ran.append(list(out["strategies"]))
        tree_digest(h, tree.root)
        for e in d.evictor.evicted:
            h.update(f"{e.pod.uid}:{e.reason}\n".encode())
    return h.hexdigest(), ran, tick_ms


def fleet_usage_rows(res_module, nodes: Sequence[Dict]) -> np.ndarray:
    """The usage column ``encode_snapshot`` builds from ``nodes``: i64[N, R]."""
    return np.stack([np.asarray(res_module.resource_vector(nd.get("usage", {})), np.int64)
                     for nd in nodes])

