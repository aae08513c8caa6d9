"""QoS manager: strategy framework + the standard strategy set.

Reference: ``pkg/koordlet/qosmanager`` — ``framework/strategy.go:21
QOSStrategy`` plugins on independent ticks (``qosmanager.go:92``), registry
``plugins/register.go``: cpusuppress, cpuevict, memoryevict, cpuburst,
cgreconcile, resctrl, blkio, sysreconcile.

Every strategy is a pure-ish function of (statesinformer, metriccache,
NodeSLO strategy config) emitting writes through the
ResourceUpdateExecutor, so the whole actuation path is testable against a
fake fs.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.koordlet import metriccache as mc
from koordinator_tpu_torch.koordlet.collectors import PodMeta
from koordinator_tpu_torch.koordlet.metriccache import MetricCache
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    ResourceUpdate,
    ResourceUpdateExecutor,
    format_cpuset,
)
from koordinator_tpu_torch.koordlet.statesinformer import StatesInformer
from koordinator_tpu_torch.koordlet.sysfs import (
    KUBEPODS_BESTEFFORT,
    pod_cgroup_dir,
)

CFS_PERIOD_US = 100_000  # kernel default, the reference assumes it too


class QOSStrategy:
    """framework/strategy.go:21 — Enabled + periodic tick."""

    name = "strategy"
    interval_seconds = 1.0

    def enabled(self) -> bool:
        return True

    def tick(self, now: float) -> None:
        raise NotImplementedError


@dataclasses.dataclass
class Evicted:
    pod: PodMeta
    reason: str


class Evictor:
    """Eviction sink (the reference calls the apiserver eviction API;
    here a callback records/performs it).  The ledger is bounded: a
    strategy that keeps re-selecting the same victim (its condition only
    clears once the pod is really gone) must not grow memory without
    bound in the live loop."""

    def __init__(
        self,
        evict_fn: Optional[Callable[[PodMeta, str], bool]] = None,
        max_ledger: int = 1024,
    ):
        self.evict_fn = evict_fn
        self.max_ledger = max_ledger
        self.evicted: List[Evicted] = []

    def evict(self, pod: PodMeta, reason: str) -> bool:
        if self.evict_fn is not None and not self.evict_fn(pod, reason):
            return False
        self.evicted.append(Evicted(pod, reason))
        if len(self.evicted) > self.max_ledger:
            # explicit length arithmetic: a [-max_ledger:] slice would be
            # a no-op at max_ledger=0 (negative zero slicing)
            del self.evicted[: len(self.evicted) - max(self.max_ledger, 0)]
        return True


# ---------------------------------------------------------------------------
# CPUSuppress
# ---------------------------------------------------------------------------


def calculate_be_suppress_cpu(
    node_capacity_milli: int,
    node_usage_cores: float,
    pod_usages_cores: Mapping[str, float],
    pod_is_be: Mapping[str, bool],
    be_cpu_used_threshold_percent: int,
    *,
    node_anno_reserved_milli: int = 0,
    kubelet_reserved_milli: int = 0,
) -> int:
    """Milli-CPUs BE pods may use (reference cpu_suppress.go:139
    calculateBESuppressCPU):

    ``suppress(BE) = capacity * SLOPercent - pod(non-BE).used
    - max(system.used, node.anno.reserved, kubelet.reserved)``
    where ``system.used = max(0, nodeUsed - sum(podUsed))``.
    """
    pod_all = sum(pod_usages_cores.values())
    pod_none_be = sum(
        u for uid, u in pod_usages_cores.items() if not pod_is_be.get(uid, False)
    )
    system_used = max(0.0, node_usage_cores - pod_all)
    system_used_milli = max(
        int(system_used * 1000), node_anno_reserved_milli, kubelet_reserved_milli
    )
    return (
        node_capacity_milli * be_cpu_used_threshold_percent // 100
        - int(pod_none_be * 1000)
        - system_used_milli
    )


class CPUSuppressStrategy(QOSStrategy):
    """Suppress the BestEffort tree to the SLO-allowed CPU share
    (cpu_suppress.go:269 suppressBECPU): by cpuset (count of cpus) or by
    cfs quota on the BE root."""

    name = "cpusuppress"

    def __init__(
        self,
        informer: StatesInformer,
        cache: MetricCache,
        executor: ResourceUpdateExecutor,
        *,
        policy: str = "cfsQuota",  # or "cpuset"
        metric_window_seconds: float = 60.0,
    ):
        self.informer = informer
        self.cache = cache
        self.executor = executor
        self.policy = policy
        self.window = metric_window_seconds

    def enabled(self) -> bool:
        slo = self.informer.get_node_slo()
        be = (slo.get("resourceUsedThresholdWithBE") or {})
        return bool(be.get("enable", False))

    def tick(self, now: float) -> None:
        slo = self.informer.get_node_slo()
        be_cfg = slo.get("resourceUsedThresholdWithBE") or {}
        threshold = int(be_cfg.get("cpuSuppressThresholdPercent", 65))
        node = self.informer.get_node()
        capacity_milli = int(node.get("capacity_milli_cpu", 0))
        if capacity_milli <= 0:
            return
        node_usage = self.cache.query(
            mc.NODE_CPU_USAGE, start=now - self.window, end=now, agg=mc.AGG_AVG
        )
        if node_usage is None:
            return
        pods = self.informer.get_all_pods()
        pod_usages: Dict[str, float] = {}
        pod_is_be: Dict[str, bool] = {}
        for pod in pods:
            u = self.cache.query(
                mc.POD_CPU_USAGE,
                start=now - self.window,
                end=now,
                agg=mc.AGG_AVG,
                labels={"pod": pod.uid},
            )
            if u is not None:
                pod_usages[pod.uid] = u
            pod_is_be[pod.uid] = pod.koord_qos == "BE" or pod.qos == "BestEffort"

        suppress_milli = calculate_be_suppress_cpu(
            capacity_milli,
            node_usage,
            pod_usages,
            pod_is_be,
            threshold,
            node_anno_reserved_milli=int(node.get("anno_reserved_milli_cpu", 0)),
            kubelet_reserved_milli=int(node.get("kubelet_reserved_milli_cpu", 0)),
        )
        suppress_milli = max(suppress_milli, 0)

        if self.policy == "cpuset":
            # round up to whole cpus, at least 1 (cpu_suppress.go
            # calculateBESuppressCPUSetPolicy keeps BE pods schedulable)
            num_cpus = max(1, math.ceil(suppress_milli / 1000))
            all_cpus = list(range(capacity_milli // 1000))
            chosen = all_cpus[-num_cpus:] if num_cpus <= len(all_cpus) else all_cpus
            self.executor.update(
                ResourceUpdate(
                    "cpuset.cpus", KUBEPODS_BESTEFFORT, format_cpuset(chosen)
                ),
                now,
            )
        else:
            quota = max(suppress_milli * CFS_PERIOD_US // 1000, 1000)
            self.executor.update(
                ResourceUpdate("cpu.cfs_quota", KUBEPODS_BESTEFFORT, str(quota)), now
            )


# ---------------------------------------------------------------------------
# CPUBurst
# ---------------------------------------------------------------------------


class CPUBurstStrategy(QOSStrategy):
    """Set cfs burst for LS pods (reference
    qosmanager/plugins/cpuburst/cpu_burst.go): burst quota =
    limit * cpuBurstPercent / 100, written to cpu.cfs_burst_us."""

    name = "cpuburst"

    def __init__(
        self,
        informer: StatesInformer,
        executor: ResourceUpdateExecutor,
    ):
        self.informer = informer
        self.executor = executor

    def enabled(self) -> bool:
        slo = self.informer.get_node_slo()
        return (slo.get("cpuBurstStrategy") or {}).get("policy", "none") != "none"

    def tick(self, now: float) -> None:
        slo = self.informer.get_node_slo()
        cfg = slo.get("cpuBurstStrategy") or {}
        burst_percent = int(cfg.get("cpuBurstPercent", 1000))
        for pod in self.informer.get_all_pods():
            if pod.koord_qos not in ("LS", ""):
                continue
            spec = self.informer.get_pod_spec(pod.uid)
            limit_milli = int(spec.get("limit_milli_cpu", 0))
            if limit_milli <= 0:
                continue
            burst_us = limit_milli * CFS_PERIOD_US // 1000 * burst_percent // 100
            cgdir = pod_cgroup_dir(pod.qos, pod.uid)
            self.executor.update(
                ResourceUpdate("cpu.cfs_burst", cgdir, str(burst_us)), now
            )


# ---------------------------------------------------------------------------
# CPU / memory eviction
# ---------------------------------------------------------------------------


class CPUEvictStrategy(QOSStrategy):
    """Evict BE pods when their CPU satisfaction stays below threshold
    (reference qosmanager/plugins/cpuevict/cpu_evict.go): satisfaction =
    realLimit / request; below ``lowPercent`` for the window -> evict by
    priority until the gap clears."""

    name = "cpuevict"

    def __init__(
        self,
        informer: StatesInformer,
        cache: MetricCache,
        evictor: Evictor,
        *,
        window_seconds: float = 60.0,
    ):
        self.informer = informer
        self.cache = cache
        self.evictor = evictor
        self.window = window_seconds

    def enabled(self) -> bool:
        slo = self.informer.get_node_slo()
        be = slo.get("resourceUsedThresholdWithBE") or {}
        return be.get("cpuEvictPolicy", "none") != "none"

    def tick(self, now: float) -> None:
        slo = self.informer.get_node_slo()
        be = slo.get("resourceUsedThresholdWithBE") or {}
        low = int(be.get("cpuEvictBESatisfactionLowerPercent", 60))
        be_usage = self.cache.query(
            mc.BE_CPU_USAGE, start=now - self.window, end=now, agg=mc.AGG_AVG
        )
        if be_usage is None:
            return
        be_pods = [
            p
            for p in self.informer.get_all_pods()
            if p.koord_qos == "BE" or p.qos == "BestEffort"
        ]
        request_milli = sum(
            int(self.informer.get_pod_spec(p.uid).get("request_milli_cpu", 0))
            for p in be_pods
        )
        if request_milli <= 0:
            return
        satisfaction = be_usage * 1000 * 100 / request_milli
        if satisfaction >= low:
            return
        # evict the lowest-priority BE pods first until the shortfall clears
        shortfall = request_milli * (low - satisfaction) / 100
        for pod in sorted(
            be_pods,
            key=lambda p: int(self.informer.get_pod_spec(p.uid).get("priority", 0)),
        ):
            if shortfall <= 0:
                break
            if self.evictor.evict(pod, "cpu satisfaction below threshold"):
                shortfall -= int(
                    self.informer.get_pod_spec(pod.uid).get("request_milli_cpu", 0)
                )


class MemoryEvictStrategy(QOSStrategy):
    """Evict BE pods when node memory usage exceeds the threshold
    (reference qosmanager/plugins/memoryevict/memory_evict.go), lowest
    priority first, until below the lower percent."""

    name = "memoryevict"

    def __init__(
        self,
        informer: StatesInformer,
        cache: MetricCache,
        evictor: Evictor,
        *,
        window_seconds: float = 60.0,
    ):
        self.informer = informer
        self.cache = cache
        self.evictor = evictor
        self.window = window_seconds

    def enabled(self) -> bool:
        slo = self.informer.get_node_slo()
        be = slo.get("resourceUsedThresholdWithBE") or {}
        return be.get("memoryEvictThresholdPercent") is not None

    def tick(self, now: float) -> None:
        slo = self.informer.get_node_slo()
        be = slo.get("resourceUsedThresholdWithBE") or {}
        threshold = int(be.get("memoryEvictThresholdPercent", 70))
        lower = int(be.get("memoryEvictLowerPercent", threshold - 2))
        node = self.informer.get_node()
        capacity = int(node.get("capacity_memory_bytes", 0))
        if capacity <= 0:
            return
        usage = self.cache.query(
            mc.NODE_MEMORY_USAGE, start=now - self.window, end=now, agg=mc.AGG_LATEST
        )
        if usage is None or usage * 100 / capacity < threshold:
            return
        to_release = usage - capacity * lower / 100
        be_pods = [
            p
            for p in self.informer.get_all_pods()
            if p.koord_qos == "BE" or p.qos == "BestEffort"
        ]
        for pod in sorted(
            be_pods,
            key=lambda p: int(self.informer.get_pod_spec(p.uid).get("priority", 0)),
        ):
            if to_release <= 0:
                break
            mem = self.cache.query(
                mc.POD_MEMORY_USAGE,
                start=now - self.window,
                end=now,
                agg=mc.AGG_LATEST,
                labels={"pod": pod.uid},
            )
            if self.evictor.evict(pod, "node memory usage above threshold"):
                to_release -= mem or 0


# ---------------------------------------------------------------------------
# Reconcilers: cgroup QoS params / resctrl / blkio / sysctl
# ---------------------------------------------------------------------------

# QoS-class cgroup parameters (reference runtimehooks/hooks/groupidentity
# bvt values; cgreconcile cpu shares)
BVT_BY_QOS = {"LSE": 2, "LSR": 2, "LS": 2, "BE": -1, "SYSTEM": 0, "": 0}


class CgroupReconcileStrategy(QOSStrategy):
    """Keep per-QoS-tree cgroup params converged (reference
    qosmanager/plugins/cgreconcile): BE tree gets minimal cpu shares and
    bvt -1; burstable keeps defaults."""

    name = "cgreconcile"

    def __init__(self, informer: StatesInformer, executor: ResourceUpdateExecutor):
        self.informer = informer
        self.executor = executor

    def tick(self, now: float) -> None:
        updates = [
            ResourceUpdate("cpu.shares", KUBEPODS_BESTEFFORT, "2"),
            ResourceUpdate("cpu.bvt_warp_ns", KUBEPODS_BESTEFFORT, "-1"),
        ]
        self.executor.update_batch(updates, now)


def calculate_cat_l3_mask(cbm: int, start_percent: int, end_percent: int) -> str:
    """reference ``util/system/resctrl.go:558 CalculateCatL3MaskValue``:
    contiguous way mask covering [start% * ways, end% * ways), hex.

    The root cbm must be a full mask (all ones): x86 CAT requires
    contiguous '1' bits and the root group exposes every way."""
    if cbm <= 0 or bin(cbm + 1).count("1") != 1:
        raise ValueError(f"illegal cbm {cbm:#x}")
    if start_percent < 0 or end_percent > 100 or end_percent <= start_percent:
        raise ValueError(
            f"illegal l3 cat percent: start {start_percent}, end {end_percent}"
        )
    ways = cbm.bit_length()
    start_way = math.ceil(ways * start_percent / 100)
    end_way = math.ceil(ways * end_percent / 100)
    if end_way <= start_way:
        # a narrow interval rounding to the same way boundary would yield
        # an empty CBM the kernel rejects with EINVAL
        raise ValueError(
            f"empty l3 way interval: start {start_percent}%, end "
            f"{end_percent}% both round to way {start_way} of {ways}"
        )
    return format((1 << end_way) - (1 << start_way), "x")


class ResctrlStrategy(QOSStrategy):
    """L3 cache / memory-bandwidth isolation groups (reference
    qosmanager/plugins/resctrl + resourceexecutor/resctrl_updater.go):
    create the LS/BE/LSR groups, write L3 way-interval + MB percent
    schemata from NodeSLO, and bind each QoS class's tasks into its
    group's tasks file (appending one pid per write, duplicates dropped —
    ``resctrl_updater.go:143-146``)."""

    name = "resctrl"

    # QoS class -> resctrl group (reference init: LSR/LS share LS by default)
    GROUPS = ("LSR", "LS", "BE")

    def __init__(
        self, informer: StatesInformer, executor: ResourceUpdateExecutor, *,
        cbm: int = 0xFFF, num_l3: int = 1
    ):
        self.informer = informer
        self.executor = executor
        self.cbm = cbm
        self.num_l3 = num_l3

    def enabled(self) -> bool:
        slo = self.informer.get_node_slo()
        return (slo.get("resctrlQOS") or {}).get("enable", False)

    def _root(self) -> str:
        return f"{self.executor.fs.root}/sys/fs/resctrl"

    def _schemata(self, qos_cfg: Mapping) -> str:
        start = int(qos_cfg.get("catRangeStartPercent", 0))
        end = int(qos_cfg.get("catRangeEndPercent", 100))
        mask = calculate_cat_l3_mask(self.cbm, start, end)
        l3 = ";".join(f"{i}={mask}" for i in range(self.num_l3))
        lines = [f"L3:{l3}"]
        mba = qos_cfg.get("mbaPercent")
        if mba is not None:
            mb = ";".join(f"{i}={int(mba)}" for i in range(self.num_l3))
            lines.append(f"MB:{mb}")
        return "\n".join(lines) + "\n"

    def tick(self, now: float) -> None:
        slo = self.informer.get_node_slo()
        cfg = slo.get("resctrlQOS") or {}
        class_key = {"LSR": "lsrClass", "LS": "lsClass", "BE": "beClass"}
        for group in self.GROUPS:
            qos_cfg = (cfg.get(class_key[group]) or {}).get("resctrlQOS")
            if qos_cfg is None and group == "LSR":
                # LSR falls back to the LS class config (reference default)
                qos_cfg = (cfg.get("lsClass") or {}).get("resctrlQOS")
            if qos_cfg is None:
                qos_cfg = {}
            gdir = f"{self._root()}/{group}"
            os.makedirs(gdir, exist_ok=True)  # resctrl group = mkdir
            try:
                schemata = self._schemata(qos_cfg)
            except ValueError:
                # malformed NodeSLO percentages must not kill the daemon
                # loop: skip this group's update, keep the others running
                continue
            self.executor.fs.write(f"{gdir}/schemata", schemata)
            # task binding: one pid per appending write() call — the
            # kernel interface binds per write (resctrl_updater.go:143-146).
            # Membership truth lives in the group's tasks file (the kernel
            # drops dead pids itself), so re-reading it each tick handles
            # pid recycling with no cache to go stale.
            pids = set(self._group_tasks(group))
            tasks_path = f"{gdir}/tasks"
            bound = set()
            current = self.executor.fs.read(tasks_path)
            if current:
                bound = {int(t) for t in current.split() if t.isdigit()}
            for pid in sorted(pids - bound):
                self._append_task(tasks_path, pid)

    @staticmethod
    def _append_task(path: str, pid: int) -> bool:
        """One pid per O_APPEND write, never a truncate-rewrite; a failed
        write (task exited mid-bind, EPERM) is retried next tick."""
        try:
            with open(path, "a") as fh:
                fh.write(f"{pid}\n")
            return True
        except OSError:
            return False

    def _group_tasks(self, group: str):
        """All pids of pods in the group's koord QoS class, read from each
        pod's cgroup.procs (the reference walks the pod cgroup dirs the
        same way, ``resctrl.go`` task collection)."""
        out = []
        for pod in self.informer.get_all_pods():
            koord_qos = pod.koord_qos or "LS"
            if koord_qos == "LSE":  # LSE never shares a CAT group
                continue
            target = "LSR" if koord_qos == "LSR" else (
                "BE" if koord_qos == "BE" else "LS"
            )
            if target != group:
                continue
            fs = self.executor.fs
            procs = fs.read(
                f"{fs.root}/{fs.cgroup_mount}/"
                f"{pod_cgroup_dir(pod.qos, pod.uid)}/cgroup.procs"
            )
            if procs:
                out.extend(
                    int(line) for line in procs.split() if line.isdigit()
                )
        return out


class BlkIOReconcileStrategy(QOSStrategy):
    """Throttle BE block IO (reference qosmanager/plugins/blkio): write
    read/write bps limits from NodeSLO blkioQOS config."""

    name = "blkio"

    def __init__(self, informer: StatesInformer, executor: ResourceUpdateExecutor):
        self.informer = informer
        self.executor = executor

    def enabled(self) -> bool:
        slo = self.informer.get_node_slo()
        return bool(slo.get("blkioQOS"))

    def tick(self, now: float) -> None:
        slo = self.informer.get_node_slo()
        for blk in slo.get("blkioQOS") or []:
            dev = blk.get("device", "253:0")
            if blk.get("readBPS"):
                self.executor.update(
                    ResourceUpdate(
                        "blkio.throttle.read_bps",
                        KUBEPODS_BESTEFFORT,
                        f"{dev} {blk['readBPS']}",
                    ),
                    now,
                )
            if blk.get("writeBPS"):
                self.executor.update(
                    ResourceUpdate(
                        "blkio.throttle.write_bps",
                        KUBEPODS_BESTEFFORT,
                        f"{dev} {blk['writeBPS']}",
                    ),
                    now,
                )


class SystemReconcileStrategy(QOSStrategy):
    """Node-level sysctl knobs (reference qosmanager/plugins/sysreconcile):
    min_free_kbytes / watermark_scale_factor from NodeSLO systemStrategy."""

    name = "sysreconcile"

    def __init__(self, informer: StatesInformer, executor: ResourceUpdateExecutor):
        self.informer = informer
        self.executor = executor

    def enabled(self) -> bool:
        return bool(self.informer.get_node_slo().get("systemStrategy"))

    def tick(self, now: float) -> None:
        cfg = self.informer.get_node_slo().get("systemStrategy") or {}
        fs = self.executor.fs
        if "minFreeKbytesFactor" in cfg:
            node = self.informer.get_node()
            total_kb = int(node.get("capacity_memory_bytes", 0)) // 1024
            v = total_kb * int(cfg["minFreeKbytesFactor"]) // 10000
            fs.write(fs.proc_path("sys/vm/min_free_kbytes"), str(v))
        if "watermarkScaleFactor" in cfg:
            fs.write(
                fs.proc_path("sys/vm/watermark_scale_factor"),
                str(cfg["watermarkScaleFactor"]),
            )


def default_qos_strategies(
    informer: StatesInformer,
    cache: MetricCache,
    executor: ResourceUpdateExecutor,
    evictor: Evictor,
) -> List[QOSStrategy]:
    """The reference's full battery (plugins/register.go) — the ONE
    wiring both daemon constructors share, so they cannot drift."""
    return [
        CPUSuppressStrategy(informer, cache, executor),
        CPUBurstStrategy(informer, executor),
        CPUEvictStrategy(informer, cache, evictor),
        MemoryEvictStrategy(informer, cache, evictor),
        CgroupReconcileStrategy(informer, executor),
        ResctrlStrategy(informer, executor),
        BlkIOReconcileStrategy(informer, executor),
        SystemReconcileStrategy(informer, executor),
    ]


class QOSManager:
    """Strategy scheduler (qosmanager.go:51): independent per-strategy
    ticks, enable-gated by NodeSLO."""

    def __init__(self, strategies: Sequence[QOSStrategy]):
        self.strategies = list(strategies)
        self._next_due: Dict[str, float] = {}

    def run_once(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        ran = []
        for s in self.strategies:
            # enabled() reads user-supplied NodeSLO and can throw on
            # malformed config just like tick() — one failing strategy
            # must not stop the rest of the battery or kill the daemon
            # loop (the reference runs each strategy in its own goroutine)
            try:
                if not s.enabled():
                    continue
                if now >= self._next_due.get(s.name, 0):
                    self._next_due[s.name] = now + s.interval_seconds
                    s.tick(now)
                    ran.append(s.name)
            except Exception:
                import logging

                # a throw in enabled() skips the interval update (cheap
                # recheck next tick); a throw in tick() already consumed
                # its interval slot, so no hot loop either way
                logging.getLogger(__name__).exception(
                    "qos strategy %s failed", s.name
                )
        return ran
