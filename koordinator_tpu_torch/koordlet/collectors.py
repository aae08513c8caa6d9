"""Metrics advisor: collector framework + the standard collector set.

Reference: ``pkg/koordlet/metricsadvisor`` — a plugin framework
(``framework/plugin.go:28 Collector``) running each collector on its own
tick (``metrics_advisor.go:102``), registry at ``plugins_profile.go:36-52``:
noderesource, podresource, beresource, sysresource, performance (CPI/PSI),
coldmemoryresource, and the device collector (NVML there; CUDA enumeration
through PyTorch here).

Collectors are deterministic functions of the SysFS + prior state so tests
drive them against a temp-dir fake fs (the reference fakes cgroupfs the
same way, ``util_test_tool.go``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.koordlet import metriccache as mc
from koordinator_tpu_torch.koordlet.metriccache import MetricCache
from koordinator_tpu_torch.koordlet.sysfs import (
    KUBEPODS_BESTEFFORT,
    SysFS,
    pod_cgroup_dir,
)


class Collector:
    """Collector plugin interface (framework/plugin.go:28): Enabled/Setup/
    Run condensed to a ``collect(now)`` tick."""

    name = "collector"
    interval_seconds = 10.0

    def collect(self, now: float) -> None:
        raise NotImplementedError

    def enabled(self) -> bool:
        return True


@dataclasses.dataclass
class PodMeta:
    """statesinformer pod description consumed by collectors."""

    name: str
    uid: str
    qos: str = "Burstable"  # kubelet QoS class
    koord_qos: str = ""  # LSE/LSR/LS/BE
    namespace: str = "default"


class NodeResourceCollector(Collector):
    """Node cpu (cores) + memory (bytes) usage from /proc
    (collectors/noderesource).  CPU usage derives from /proc/stat tick
    deltas between collections."""

    name = "noderesource"

    def __init__(self, fs: SysFS, cache: MetricCache, *, ticks_per_second: int = 100):
        self.fs = fs
        self.cache = cache
        self.ticks_per_second = ticks_per_second
        self._last: Optional[tuple] = None  # (used, total, wall)

    def collect(self, now: float) -> None:
        used, total = self.fs.proc_stat_cpu()
        if self._last is not None:
            last_used, last_total, last_now = self._last
            dt = now - last_now
            if dt > 0 and total > last_total:
                cores = (used - last_used) / self.ticks_per_second / dt
                self.cache.append(mc.NODE_CPU_USAGE, max(0.0, cores), ts=now)
        self._last = (used, total, now)
        self.cache.append(
            mc.NODE_MEMORY_USAGE, float(self.fs.memory_usage_bytes()), ts=now
        )


class PodResourceCollector(Collector):
    """Per-pod cpu/memory from the pod cgroup (collectors/podresource)."""

    name = "podresource"

    def __init__(self, fs: SysFS, cache: MetricCache, pods_fn):
        self.fs = fs
        self.cache = cache
        self.pods_fn = pods_fn  # () -> Sequence[PodMeta]
        self._last_cpu: Dict[str, tuple] = {}  # uid -> (usage_ns, wall)

    def collect(self, now: float) -> None:
        for pod in self.pods_fn():
            cgdir = pod_cgroup_dir(pod.qos, pod.uid)
            usage_ns = self.fs.cpuacct_usage_ns(cgdir)
            last = self._last_cpu.get(pod.uid)
            if last is not None:
                last_ns, last_now = last
                dt = now - last_now
                if dt > 0 and usage_ns >= last_ns:
                    cores = (usage_ns - last_ns) / 1e9 / dt
                    self.cache.append(
                        mc.POD_CPU_USAGE, cores, ts=now, labels={"pod": pod.uid}
                    )
            self._last_cpu[pod.uid] = (usage_ns, now)
            self.cache.append(
                mc.POD_MEMORY_USAGE,
                float(self.fs.memory_usage_cgroup(cgdir)),
                ts=now,
                labels={"pod": pod.uid},
            )


class BEResourceCollector(Collector):
    """Aggregate BestEffort-tree usage (collectors/beresource): the
    cpusuppress strategy consumes this."""

    name = "beresource"

    def __init__(self, fs: SysFS, cache: MetricCache):
        self.fs = fs
        self.cache = cache
        self._last: Optional[tuple] = None

    def collect(self, now: float) -> None:
        usage_ns = self.fs.cpuacct_usage_ns(KUBEPODS_BESTEFFORT)
        if self._last is not None:
            last_ns, last_now = self._last
            dt = now - last_now
            if dt > 0 and usage_ns >= last_ns:
                self.cache.append(
                    mc.BE_CPU_USAGE, (usage_ns - last_ns) / 1e9 / dt, ts=now
                )
        self._last = (usage_ns, now)


class SysResourceCollector(Collector):
    """System (non-pod) usage = node usage - sum(pod usage)
    (collectors/sysresource)."""

    name = "sysresource"

    def __init__(self, cache: MetricCache):
        self.cache = cache

    def collect(self, now: float) -> None:
        node = self.cache.query(
            mc.NODE_CPU_USAGE, start=now - 60, end=now, agg=mc.AGG_LATEST
        )
        if node is None:
            return
        pod_total = 0.0
        for labels in self.cache.series_labels(mc.POD_CPU_USAGE):
            v = self.cache.query(
                mc.POD_CPU_USAGE,
                start=now - 60,
                end=now,
                agg=mc.AGG_LATEST,
                labels=labels,
            )
            pod_total += v or 0.0
        self.cache.append(mc.SYS_CPU_USAGE, max(0.0, node - pod_total), ts=now)


class PSICollector(Collector):
    """Node PSI cpu/mem/io some-avg10 (collectors/performance PSI path)."""

    name = "psi"

    def __init__(self, fs: SysFS, cache: MetricCache):
        self.fs = fs
        self.cache = cache

    def collect(self, now: float) -> None:
        for resource, metric in (
            ("cpu.pressure", mc.NODE_PSI_CPU_SOME_AVG10),
            ("memory.pressure", mc.NODE_PSI_MEM_SOME_AVG10),
            ("io.pressure", mc.NODE_PSI_IO_SOME_AVG10),
        ):
            psi = self.fs.psi(resource)
            if psi is not None:
                self.cache.append(metric, psi.some.avg10, ts=now)


class PerformanceCollector(Collector):
    """Container CPI via the native perf shim (collectors/performance
    collectContainerCPI, cgo libpfm4 there; ``native.perf`` here).  Falls
    back to disabled when the shim or perf_event_open is unavailable."""

    name = "performance"

    def __init__(self, cache: MetricCache, pods_fn, perf_reader=None):
        self.cache = cache
        self.pods_fn = pods_fn
        self.perf_reader = perf_reader

    def enabled(self) -> bool:
        return self.perf_reader is not None

    def collect(self, now: float) -> None:
        if self.perf_reader is None:
            return
        for pod in self.pods_fn():
            sample = self.perf_reader(pod)
            if not sample:
                continue
            cycles, instructions = sample
            self.cache.append(
                mc.CONTAINER_CPI_CYCLES, cycles, ts=now, labels={"pod": pod.uid}
            )
            self.cache.append(
                mc.CONTAINER_CPI_INSTRUCTIONS,
                instructions,
                ts=now,
                labels={"pod": pod.uid},
            )


def make_native_perf_reader(fs: SysFS):
    """Perf reader backed by the native CPI shim
    (``koordinator_tpu_torch.native.PerfCPIGroup``; reference cgo path
    ``perf_group_linux.go collectContainerCPI``): opens the pod cgroup dir
    as a perf cgroup target.  Returns None when perf is unavailable so the
    PerformanceCollector disables itself (feature-gate semantics)."""
    import os

    from koordinator_tpu_torch import native

    if not native.available() or native.read_self_cpi() is None:
        return None

    def reader(pod: "PodMeta"):
        cgdir = os.path.join(
            fs.root, "sys/fs/cgroup/perf_event", pod_cgroup_dir(pod.qos, pod.uid)
        )
        try:
            fd = os.open(cgdir, os.O_RDONLY)
        except OSError:
            return None
        try:
            with native.PerfCPIGroup(fd, is_cgroup=True) as g:
                return g.read()
        except OSError:
            return None
        finally:
            os.close(fd)

    return reader


class ColdMemoryCollector(Collector):
    """kidled cold-page accounting (collectors/coldmemoryresource
    cold_page_kidled.go): reads idle-page stats to size reclaimable
    memory."""

    name = "coldmemoryresource"

    def __init__(self, fs: SysFS, cache: MetricCache):
        self.fs = fs
        self.cache = cache

    def enabled(self) -> bool:
        return (
            self.fs.read(self.fs.proc_path("sys/vm/kidled_scan_period_in_seconds"))
            is not None
        )

    def collect(self, now: float) -> None:
        text = self.fs.read(
            self.fs.proc_path("kidled_cold_pages")
        )
        if text is None:
            return
        try:
            cold_bytes = int(text.strip())
        except ValueError:
            return
        self.cache.append(mc.COLD_PAGE_BYTES, float(cold_bytes), ts=now)


class DeviceCollector(Collector):
    """Accelerator enumeration + utilization (reference NVML GPU collector,
    ``metricsadvisor/devices/gpu/collector_gpu_linux.go``; here the device
    list comes from CUDA through PyTorch)."""

    name = "device"

    def __init__(self, cache: MetricCache, devices_fn=None):
        self.cache = cache
        self.devices_fn = devices_fn or _cuda_devices

    def collect(self, now: float) -> None:
        for dev in self.devices_fn():
            labels = {"minor": str(dev.get("minor", 0))}
            if "util" in dev:
                self.cache.append(
                    mc.DEVICE_UTIL, float(dev["util"]), ts=now, labels=labels
                )
            if "memory_used" in dev:
                self.cache.append(
                    mc.DEVICE_MEMORY_USED,
                    float(dev["memory_used"]),
                    ts=now,
                    labels=labels,
                )


def _cuda_devices() -> List[Dict]:
    """One entry per CUDA device: ``minor``, ``platform`` ``"gpu"`` and
    ``memory_used`` (total less free, from ``torch.cuda.mem_get_info``).
    A host without CUDA has no devices to report: ``[]``, as the
    reference reports on a host without its accelerator runtime.  There
    is no ``util`` key: that needs NVML.  Call it outside any lock: it
    reads the devices."""
    import torch

    if not torch.cuda.is_available():
        return []
    try:
        out = []
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            out.append({"minor": i, "platform": "gpu", "memory_used": int(total - free)})
        return out
    except Exception:
        # an unhealthy device must read as "no devices", but not
        # invisibly: the scrape path keeps running and the reason lands
        # in the debug log
        import logging

        logging.getLogger(__name__).debug(
            "cuda device enumeration failed", exc_info=True
        )
        return []


class MetricsAdvisor:
    """Collector scheduler (metrics_advisor.go): each collector ticks on
    its own interval; ``run_once`` advances every due collector — the
    production loop calls it from a timer, tests call it directly."""

    def __init__(self, collectors: Sequence[Collector]):
        self.collectors = [c for c in collectors if c.enabled()]
        self._next_due: Dict[str, float] = {}

    def run_once(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        ran = []
        for c in self.collectors:
            if now >= self._next_due.get(c.name, 0):
                c.collect(now)
                self._next_due[c.name] = now + c.interval_seconds
                ran.append(c.name)
        return ran
