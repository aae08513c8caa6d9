"""Node OS interface: cgroup v1/v2 + /proc readers behind a fake-able root.

Reference L0 (``pkg/koordlet/util/system``): cgroup driver for both
hierarchies (``cgroup_driver_linux.go``, ``cgroup2.go``), resource registry
(``cgroup_resource.go``), PSI parsing
(``pkg/koordlet/resourceexecutor/psi.go``), proc parsing
(``util/system`` meminfo/cpuinfo helpers).  Everything resolves under a
configurable root so tests run against a temp-dir fake fs (the reference's
``util_test_tool.go`` pattern).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Dict, List, Mapping, Optional, Tuple


class CgroupVersion(enum.IntEnum):
    V1 = 1
    V2 = 2


# Cgroup resource registry (reference util/system/cgroup_resource.go):
# logical resource -> (v1 subsystem relative file, v2 file)
CGROUP_FILES = {
    "cpu.cfs_quota": ("cpu/cpu.cfs_quota_us", "cpu.max"),
    "cpu.cfs_period": ("cpu/cpu.cfs_period_us", "cpu.max"),
    "cpu.cfs_burst": ("cpu/cpu.cfs_burst_us", "cpu.max.burst"),
    "cpu.shares": ("cpu/cpu.shares", "cpu.weight"),
    "cpu.bvt_warp_ns": ("cpu/cpu.bvt_warp_ns", "cpu.bvt_warp_ns"),
    "cpu.idle": ("cpu/cpu.idle", "cpu.idle"),
    "cpuset.cpus": ("cpuset/cpuset.cpus", "cpuset.cpus"),
    "cpuacct.usage": ("cpuacct/cpuacct.usage", "cpu.stat"),
    "memory.limit": ("memory/memory.limit_in_bytes", "memory.max"),
    "memory.usage": ("memory/memory.usage_in_bytes", "memory.current"),
    "memory.wmark_ratio": ("memory/memory.wmark_ratio", "memory.wmark_ratio"),
    "memory.priority": ("memory/memory.priority", "memory.priority"),
    "memory.oom_group": ("memory/memory.use_priority_oom", "memory.oom.group"),
    "cpu.pressure": ("cpuacct/cpu.pressure", "cpu.pressure"),
    "memory.pressure": ("cpuacct/memory.pressure", "memory.pressure"),
    "io.pressure": ("cpuacct/io.pressure", "io.pressure"),
    "blkio.throttle.read_bps": (
        "blkio/blkio.throttle.read_bps_device",
        "io.max",
    ),
    "blkio.throttle.write_bps": (
        "blkio/blkio.throttle.write_bps_device",
        "io.max",
    ),
}


@dataclasses.dataclass
class PSILine:
    """One parsed PSI record (resourceexecutor/psi.go)."""

    avg10: float
    avg60: float
    avg300: float
    total: int


@dataclasses.dataclass
class PSI:
    some: PSILine
    full: Optional[PSILine]


@dataclasses.dataclass
class SysFS:
    """Filesystem accessor rooted at ``root`` ('/' in production)."""

    root: str = "/"
    cgroup_version: CgroupVersion = CgroupVersion.V2
    cgroup_mount: str = "sys/fs/cgroup"

    # -- path helpers --

    def proc_path(self, *parts: str) -> str:
        return os.path.join(self.root, "proc", *parts)

    def cgroup_path(self, resource: str, cgroup_dir: str = "") -> str:
        v1_rel, v2_rel = CGROUP_FILES[resource]
        base = os.path.join(self.root, self.cgroup_mount)
        if self.cgroup_version == CgroupVersion.V1:
            subsystem, _, fname = v1_rel.partition("/")
            return os.path.join(base, subsystem, cgroup_dir, fname)
        return os.path.join(base, cgroup_dir, v2_rel)

    # -- raw io --

    def read(self, path: str) -> Optional[str]:
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return None

    def write(self, path: str, value: str) -> bool:
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(value)
            return True
        except OSError:
            return False

    def read_cgroup(self, resource: str, cgroup_dir: str = "") -> Optional[str]:
        v = self.read(self.cgroup_path(resource, cgroup_dir))
        return v.strip() if v is not None else None

    def write_cgroup(self, resource: str, cgroup_dir: str, value: str) -> bool:
        return self.write(self.cgroup_path(resource, cgroup_dir), value)

    # -- /proc parsers (reference util/system) --

    def meminfo(self) -> Dict[str, int]:
        """Parse /proc/meminfo into bytes."""
        out: Dict[str, int] = {}
        text = self.read(self.proc_path("meminfo")) or ""
        for line in text.splitlines():
            if ":" not in line:
                continue
            key, _, rest = line.partition(":")
            fields = rest.split()
            if not fields:
                continue
            value = int(fields[0])
            if len(fields) > 1 and fields[1] == "kB":
                value *= 1024
            out[key.strip()] = value
        return out

    def memory_usage_bytes(self) -> int:
        """Node memory usage = MemTotal - MemAvailable (the reference's
        node memory accounting, util/meminfo)."""
        mi = self.meminfo()
        return max(0, mi.get("MemTotal", 0) - mi.get("MemAvailable", 0))

    # -- CPU / NUMA topology (reference util/system + koordlet nodeinfo
    # collectors read the same sysfs files to build the
    # NodeResourceTopology CR, states_noderesourcetopology.go) --

    def sys_path(self, *parts: str) -> str:
        return os.path.join(self.root, "sys", *parts)

    @staticmethod
    def _parse_cpulist(text: str) -> List[int]:
        """"0-3,8,10-11" -> [0, 1, 2, 3, 8, 10, 11]."""
        cpus: List[int] = []
        for part in text.strip().split(","):
            if not part:
                continue
            if "-" in part:
                lo, hi = part.split("-")
                cpus.extend(range(int(lo), int(hi) + 1))
            else:
                cpus.append(int(part))
        return cpus

    def numa_nodes(self) -> List[int]:
        """NUMA node ids from /sys/devices/system/node/node*/."""
        base = self.sys_path("devices", "system", "node")
        out: List[int] = []
        try:
            for name in os.listdir(base):
                if name.startswith("node") and name[4:].isdigit():
                    out.append(int(name[4:]))
        except OSError:
            return []
        return sorted(out)

    def numa_node_cpus(self, node: int) -> List[int]:
        text = self.read(
            self.sys_path("devices", "system", "node", f"node{node}", "cpulist")
        )
        return self._parse_cpulist(text) if text else []

    def numa_node_memory_bytes(self, node: int) -> int:
        """Node-local MemTotal from node<X>/meminfo ("Node 0 MemTotal: N kB")."""
        text = (
            self.read(
                self.sys_path(
                    "devices", "system", "node", f"node{node}", "meminfo"
                )
            )
            or ""
        )
        for line in text.splitlines():
            if "MemTotal:" in line:
                fields = line.split()
                try:
                    idx = fields.index("MemTotal:")
                    value = int(fields[idx + 1])
                except (ValueError, IndexError):
                    return 0
                if len(fields) > idx + 2 and fields[idx + 2] == "kB":
                    value *= 1024
                return value
        return 0

    def cpu_topology(self) -> List[Tuple[int, int, int, int]]:
        """(cpu, core, numa_node, socket) per online logical CPU, from
        cpu<N>/topology/{core_id,physical_package_id} + the NUMA cpulists."""
        cpu_node: Dict[int, int] = {}
        for n in self.numa_nodes():
            for c in self.numa_node_cpus(n):
                cpu_node[c] = n
        base = self.sys_path("devices", "system", "cpu")
        out: List[Tuple[int, int, int, int]] = []
        try:
            names = os.listdir(base)
        except OSError:
            return []
        for name in sorted(names):
            if not (name.startswith("cpu") and name[3:].isdigit()):
                continue
            cpu = int(name[3:])
            core = self.read(os.path.join(base, name, "topology", "core_id"))
            sock = self.read(
                os.path.join(base, name, "topology", "physical_package_id")
            )
            if core is None or sock is None:
                continue
            out.append(
                (cpu, int(core), cpu_node.get(cpu, 0), int(sock))
            )
        return out

    def proc_stat_cpu(self) -> Tuple[int, int]:
        """(used_ticks, total_ticks) from the aggregate /proc/stat cpu line."""
        text = self.read(self.proc_path("stat")) or ""
        for line in text.splitlines():
            if line.startswith("cpu "):
                vals = [int(v) for v in line.split()[1:]]
                # user nice system idle iowait irq softirq steal [guest ...]
                total = sum(vals[:8])
                idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
                return total - idle, total
        return 0, 0

    def psi(self, resource: str, cgroup_dir: str = "") -> Optional[PSI]:
        """Parse a PSI file (resourceexecutor/psi.go readPSI)."""
        text = self.read_cgroup(resource, cgroup_dir)
        if text is None:
            return None
        lines: Dict[str, PSILine] = {}
        for line in text.splitlines():
            fields = line.split()
            if not fields:
                continue
            kind = fields[0]
            kv = dict(f.split("=", 1) for f in fields[1:])
            lines[kind] = PSILine(
                avg10=float(kv.get("avg10", 0)),
                avg60=float(kv.get("avg60", 0)),
                avg300=float(kv.get("avg300", 0)),
                total=int(kv.get("total", 0)),
            )
        if "some" not in lines:
            return None
        return PSI(some=lines["some"], full=lines.get("full"))

    def cpuacct_usage_ns(self, cgroup_dir: str = "") -> int:
        """Container/pod cpu usage in nanoseconds (v1 cpuacct.usage; v2
        cpu.stat usage_usec)."""
        if self.cgroup_version == CgroupVersion.V1:
            v = self.read_cgroup("cpuacct.usage", cgroup_dir)
            return int(v) if v else 0
        text = self.read_cgroup("cpuacct.usage", cgroup_dir) or ""
        for line in text.splitlines():
            if line.startswith("usage_usec"):
                return int(line.split()[1]) * 1000
        return 0

    def memory_usage_cgroup(self, cgroup_dir: str = "") -> int:
        v = self.read_cgroup("memory.usage", cgroup_dir)
        return int(v) if v and v.isdigit() else 0


# Well-known koordinator cgroup layout (reference util/koordlet cgroup
# paths): besteffort pods live under a dedicated QoS tree.
KUBEPODS = "kubepods"
KUBEPODS_BESTEFFORT = "kubepods/besteffort"
KUBEPODS_BURSTABLE = "kubepods/burstable"


def pod_cgroup_dir(qos: str, pod_uid: str) -> str:
    """Pod dir by k8s QoS class (reference util/pod.go GetPodCgroupParentDir)."""
    if qos == "Guaranteed":
        return f"{KUBEPODS}/pod{pod_uid}"
    if qos == "BestEffort":
        return f"{KUBEPODS_BESTEFFORT}/pod{pod_uid}"
    return f"{KUBEPODS_BURSTABLE}/pod{pod_uid}"
