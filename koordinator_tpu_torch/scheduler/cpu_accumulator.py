"""CPUSet accumulator: pick logical CPUs for an LSE/LSR pod on its chosen node.

A host-only copy of ``koordinator_tpu/scheduler/cpu_accumulator.py``, with
the same behaviour as the reference's accumulator (reference
``pkg/scheduler/plugins/nodenumaresource/cpu_accumulator.go``): the same
decision ladder (full free cores in one NUMA node -> one socket ->
most-free-socket spill -> per-core chunks; spread-by-pcpus variants; final
one-at-a-time fill), the same sort keys (NUMA allocate strategy
most/least-allocated, socket-affinity-with-result, ref counts, stable id
tiebreaks), and the same exclusive-policy filters.

It runs on the host once per pod on the *selected* node (Reserve phase);
the batched zone tensors (``koordinator_tpu_torch.ops.numa``) stand in for
the reference's per-(pod, node) Allocate inside Score (``scoring.go:86``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Sequence, Set

from koordinator_tpu_torch.model.topology import CPUTopology


class CPUBindPolicy(str, enum.Enum):
    """reference apis/extension/numa_aware.go CPUBindPolicy."""

    DEFAULT = "Default"
    FULL_PCPUS = "FullPCPUs"
    SPREAD_BY_PCPUS = "SpreadByPCPUs"
    CONSTRAINED_BURST = "ConstrainedBurst"


class CPUExclusivePolicy(str, enum.Enum):
    """reference apis/extension/numa_aware.go CPUExclusivePolicy."""

    NONE = "None"
    PCPU_LEVEL = "PCPULevel"
    NUMA_NODE_LEVEL = "NUMANodeLevel"


class NUMAAllocateStrategy(str, enum.Enum):
    """reference apis/extension/numa_aware.go NUMAAllocateStrategy."""

    MOST_ALLOCATED = "MostAllocated"
    LEAST_ALLOCATED = "LeastAllocated"


@dataclasses.dataclass
class CPUAllocation:
    """Per-CPU allocation bookkeeping on one node (reference
    ``cpu_accumulator.go CPUDetails`` ref counts + exclusive marks)."""

    ref_count: Dict[int, int] = dataclasses.field(default_factory=dict)
    exclusive_policy: Dict[int, CPUExclusivePolicy] = dataclasses.field(
        default_factory=dict
    )

    def exclusive_cores(self, topology: CPUTopology) -> Set[int]:
        return {
            topology.details[c].core
            for c, p in self.exclusive_policy.items()
            if p == CPUExclusivePolicy.PCPU_LEVEL
        }

    def exclusive_numa_nodes(self, topology: CPUTopology) -> Set[int]:
        return {
            topology.details[c].node
            for c, p in self.exclusive_policy.items()
            if p == CPUExclusivePolicy.NUMA_NODE_LEVEL
        }


class _Accumulator:
    """Mutable take state (reference cpu_accumulator.go:238 cpuAccumulator)."""

    def __init__(
        self,
        topology: CPUTopology,
        max_ref_count: int,
        available: Iterable[int],
        allocated: CPUAllocation,
        num_needed: int,
        exclusive_policy: CPUExclusivePolicy,
        strategy: NUMAAllocateStrategy,
    ):
        self.topology = topology
        self.max_ref_count = max_ref_count
        self.allocatable: Dict[int, int] = {}  # cpu -> ref count
        for cpu in available:
            if cpu in topology.details:
                self.allocatable[cpu] = (
                    allocated.ref_count.get(cpu, 0) if max_ref_count > 1 else 0
                )
        self.exclusive_in_cores = allocated.exclusive_cores(topology)
        self.exclusive_in_nodes = allocated.exclusive_numa_nodes(topology)
        self.exclusive_policy = exclusive_policy
        self.exclusive = exclusive_policy in (
            CPUExclusivePolicy.PCPU_LEVEL,
            CPUExclusivePolicy.NUMA_NODE_LEVEL,
        )
        self.strategy = strategy
        self.num_needed = num_needed
        self.result: List[int] = []

    # -- state predicates (cpu_accumulator.go:306-316) --

    def needs(self, n: int) -> bool:
        return self.num_needed >= n

    def satisfied(self) -> bool:
        return self.num_needed < 1

    def failed(self) -> bool:
        return self.num_needed > len(self.allocatable)

    def take(self, cpus: Sequence[int]) -> None:
        for cpu in cpus:
            self.result.append(cpu)
            self.allocatable.pop(cpu, None)
            if self.exclusive:
                info = self.topology.details[cpu]
                if self.exclusive_policy == CPUExclusivePolicy.PCPU_LEVEL:
                    self.exclusive_in_cores.add(info.core)
                elif self.exclusive_policy == CPUExclusivePolicy.NUMA_NODE_LEVEL:
                    self.exclusive_in_nodes.add(info.node)
        self.num_needed -= len(cpus)

    # -- exclusive filters (cpu_accumulator.go:318-330) --

    def _excl_pcpu(self, cpu: int) -> bool:
        return (
            self.exclusive_policy == CPUExclusivePolicy.PCPU_LEVEL
            and self.topology.details[cpu].core in self.exclusive_in_cores
        )

    def _excl_numa(self, cpu: int) -> bool:
        return (
            self.exclusive_policy == CPUExclusivePolicy.NUMA_NODE_LEVEL
            and self.topology.details[cpu].node in self.exclusive_in_nodes
        )

    # -- sort helpers --

    def _strategy_key(self, free_score: int) -> int:
        """MostAllocated prefers fewer free, LeastAllocated more free
        (cpu_accumulator.go:433-439 and peers)."""
        if self.strategy == NUMAAllocateStrategy.MOST_ALLOCATED:
            return free_score
        return -free_score

    def _core_ref_count(self, core: int) -> int:
        return sum(
            rc
            for cpu, rc in self.allocatable.items()
            if self.topology.details[cpu].core == core
        )

    def _sorted_core_cpus(self, cpus: List[int]) -> List[int]:
        cpus = sorted(cpus)
        if self.max_ref_count > 1:
            cpus.sort(key=lambda c: (self.allocatable.get(c, 0), c))
        return cpus

    def _sort_cores(
        self, cores: List[int], cpus_in_cores: Dict[int, List[int]]
    ) -> List[int]:
        """Fuller-free cores first, then ref count, then id
        (cpu_accumulator.go:345 sortCores)."""

        def key(core: int):
            k = [-len(cpus_in_cores[core])]
            if self.max_ref_count > 1:
                k.append(self._core_ref_count(core))
            k.append(core)
            return tuple(k)

        return sorted(cores, key=key)

    def _group(
        self, filter_exclusive_numa: bool = False, filter_exclusive_both: bool = False
    ):
        """Group allocatable cpus by core, with free-score tallies."""
        cpus_in_cores: Dict[int, List[int]] = {}
        node_free: Dict[int, int] = {}
        socket_free: Dict[int, int] = {}
        for cpu in self.allocatable:
            if filter_exclusive_numa and self._excl_numa(cpu):
                continue
            if filter_exclusive_both and (self._excl_pcpu(cpu) or self._excl_numa(cpu)):
                continue
            info = self.topology.details[cpu]
            cpus_in_cores.setdefault(info.core, []).append(cpu)
            node_free[info.node] = node_free.get(info.node, 0) + 1
            socket_free[info.socket] = socket_free.get(info.socket, 0) + 1
        return cpus_in_cores, node_free, socket_free

    # -- candidate listings (cpu_accumulator.go:371,464,530,608,666) --

    def free_cores_in_node(
        self, full_free_only: bool, filter_exclusive: bool
    ) -> List[List[int]]:
        cpus_in_cores, _, socket_free = self._group(
            filter_exclusive_numa=filter_exclusive
        )
        per_core = self.topology.cpus_per_core()
        cores_in_nodes: Dict[int, List[int]] = {}
        for core, cpus in cpus_in_cores.items():
            if full_free_only and len(cpus) != per_core:
                continue
            node = self.topology.details[cpus[0]].node
            cores_in_nodes.setdefault(node, []).append(core)

        cpus_in_nodes: Dict[int, List[int]] = {}
        for node, cores in cores_in_nodes.items():
            ordered = self._sort_cores(cores, cpus_in_cores)
            cpus_in_nodes[node] = [
                c for core in ordered for c in sorted(cpus_in_cores[core])
            ]

        def node_key(node: int):
            some_cpu = cpus_in_nodes[node][0]
            socket = self.topology.details[some_cpu].socket
            return (
                self._strategy_key(len(cpus_in_nodes[node])),
                self._strategy_key(socket_free.get(socket, 0)),
                node,
            )

        return [cpus_in_nodes[n] for n in sorted(cpus_in_nodes, key=node_key)]

    def free_cores_in_socket(self, full_free_only: bool) -> List[List[int]]:
        cpus_in_cores, _, _ = self._group()
        per_core = self.topology.cpus_per_core()
        cores_in_sockets: Dict[int, List[int]] = {}
        for core, cpus in cpus_in_cores.items():
            if full_free_only and len(cpus) != per_core:
                continue
            socket = self.topology.details[cpus[0]].socket
            cores_in_sockets.setdefault(socket, []).append(core)

        cpus_in_sockets: Dict[int, List[int]] = {}
        for socket, cores in cores_in_sockets.items():
            ordered = self._sort_cores(cores, cpus_in_cores)
            cpus_in_sockets[socket] = [
                c for core in ordered for c in sorted(cpus_in_cores[core])
            ]

        def socket_key(socket: int):
            return (self._strategy_key(len(cpus_in_sockets[socket])), socket)

        return [cpus_in_sockets[s] for s in sorted(cpus_in_sockets, key=socket_key)]

    def _extract_one_per_core(self, cpus: List[int]) -> List[int]:
        seen: Set[int] = set()
        out = []
        for c in cpus:
            core = self.topology.details[c].core
            if core not in seen:
                seen.add(core)
                out.append(c)
        return out

    def free_cpus_in_node(self, filter_exclusive: bool) -> List[List[int]]:
        cpus_in_nodes: Dict[int, List[int]] = {}
        node_free: Dict[int, int] = {}
        socket_free: Dict[int, int] = {}
        for cpu in self.allocatable:
            if filter_exclusive and (self._excl_pcpu(cpu) or self._excl_numa(cpu)):
                continue
            info = self.topology.details[cpu]
            cpus_in_nodes.setdefault(info.node, []).append(cpu)
            node_free[info.node] = node_free.get(info.node, 0) + 1
            socket_free[info.socket] = socket_free.get(info.socket, 0) + 1

        for node, cpus in cpus_in_nodes.items():
            cpus = self._sorted_core_cpus(cpus)
            if filter_exclusive:
                cpus = self._extract_one_per_core(cpus)
            cpus_in_nodes[node] = cpus

        def node_key(node: int):
            socket = self.topology.details[cpus_in_nodes[node][0]].socket
            return (
                self._strategy_key(node_free.get(node, 0)),
                self._strategy_key(socket_free.get(socket, 0)),
                node,
            )

        return [cpus_in_nodes[n] for n in sorted(cpus_in_nodes, key=node_key)]

    def free_cpus_in_socket(self, filter_exclusive: bool) -> List[List[int]]:
        cpus_in_sockets: Dict[int, List[int]] = {}
        for cpu in self.allocatable:
            if filter_exclusive and self._excl_pcpu(cpu):
                continue
            info = self.topology.details[cpu]
            cpus_in_sockets.setdefault(info.socket, []).append(cpu)

        for socket, cpus in cpus_in_sockets.items():
            cpus = self._sorted_core_cpus(cpus)
            if filter_exclusive:
                cpus = self._extract_one_per_core(cpus)
            cpus_in_sockets[socket] = cpus

        def socket_key(socket: int):
            return (self._strategy_key(len(cpus_in_sockets[socket])), socket)

        return [cpus_in_sockets[s] for s in sorted(cpus_in_sockets, key=socket_key)]

    def free_cpus(self, filter_exclusive: bool) -> List[int]:
        """Global ordering (cpu_accumulator.go:666 freeCPUs): socket affinity
        with already-taken cpus, then strategy free scores, then fuller
        cores last, stable ids."""
        cpus_in_cores, node_free, socket_free = self._group(
            filter_exclusive_both=filter_exclusive
        )
        result_sockets: Dict[int, int] = {}
        for cpu in self.result:
            s = self.topology.details[cpu].socket
            result_sockets[s] = result_sockets.get(s, 0) + 1

        def core_key(core: int):
            some_cpu = cpus_in_cores[core][0]
            info = self.topology.details[some_cpu]
            k = [
                -result_sockets.get(info.socket, 0),
                self._strategy_key(socket_free.get(info.socket, 0)),
                self._strategy_key(node_free.get(info.node, 0)),
                len(cpus_in_cores[core]),
                info.socket,
            ]
            if self.max_ref_count > 1:
                k.append(self._core_ref_count(core))
            k.append(core)
            return tuple(k)

        out: List[int] = []
        for core in sorted(cpus_in_cores, key=core_key):
            out.extend(self._sorted_core_cpus(cpus_in_cores[core]))
        return out

    def spread(self, cpus: List[int]) -> List[int]:
        """Round-robin one cpu per core per pass (cpu_accumulator.go:798)."""
        if len(cpus) <= self.topology.cpus_per_core():
            return cpus
        out: List[int] = []
        pending = list(cpus)
        while pending:
            seen: Set[int] = set()
            reserved: List[int] = []
            for c in pending:
                core = self.topology.details[c].core
                if core in seen:
                    reserved.append(c)
                else:
                    seen.add(core)
                    out.append(c)
            pending = reserved
        return out


class CPUAllocationError(Exception):
    pass


def take_cpus(
    topology: CPUTopology,
    available: Iterable[int],
    num_needed: int,
    *,
    allocated: Optional[CPUAllocation] = None,
    max_ref_count: int = 1,
    bind_policy: CPUBindPolicy = CPUBindPolicy.FULL_PCPUS,
    exclusive_policy: CPUExclusivePolicy = CPUExclusivePolicy.NONE,
    strategy: NUMAAllocateStrategy = NUMAAllocateStrategy.LEAST_ALLOCATED,
) -> List[int]:
    """Pick ``num_needed`` logical CPUs (reference cpu_accumulator.go:88 takeCPUs)."""
    acc = _Accumulator(
        topology,
        max_ref_count,
        available,
        allocated or CPUAllocation(),
        num_needed,
        exclusive_policy,
        strategy,
    )
    if acc.satisfied():
        return acc.result
    if acc.failed():
        raise CPUAllocationError("not enough cpus available to satisfy request")

    full_pcpus = bind_policy == CPUBindPolicy.FULL_PCPUS
    if full_pcpus or topology.cpus_per_core() == 1:
        # whole free cores inside one NUMA node (go:107-121)
        if acc.num_needed <= topology.cpus_per_node():
            for filter_exclusive in (True, False):
                for cpus in acc.free_cores_in_node(True, filter_exclusive):
                    if len(cpus) >= acc.num_needed:
                        acc.take(cpus[: acc.num_needed])
                        return acc.result
        # whole free cores inside one socket (go:126-134)
        if acc.num_needed <= topology.cpus_per_socket():
            for cpus in acc.free_cores_in_socket(True):
                if len(cpus) >= acc.num_needed:
                    acc.take(cpus[: acc.num_needed])
                    return acc.result
        # spill: most-free sockets whole, leftovers from least-free in
        # per-core chunks (go:141-177)
        free = acc.free_cores_in_socket(True)
        free.sort(key=len, reverse=True)
        unsatisfied = []
        for cpus in free:
            if not acc.needs(len(cpus)):
                unsatisfied.append(cpus)
            else:
                acc.take(cpus)
                if acc.satisfied():
                    return acc.result
        if acc.needs(topology.cpus_per_core()):
            unsatisfied.sort(key=len)
            per_core = topology.cpus_per_core()
            for cpus in unsatisfied:
                for i in range(0, len(cpus), per_core):
                    acc.take(cpus[i : i + per_core])
                    if acc.satisfied():
                        return acc.result
                    if not acc.needs(per_core):
                        break

    if not full_pcpus:
        # spread inside one NUMA node, then one socket (go:185-216)
        if acc.num_needed <= topology.cpus_per_node():
            for filter_exclusive in (True, False):
                for cpus in acc.free_cpus_in_node(filter_exclusive):
                    if len(cpus) >= acc.num_needed:
                        acc.take(acc.spread(cpus)[: acc.num_needed])
                        return acc.result
        if acc.num_needed <= topology.cpus_per_socket():
            for filter_exclusive in (True, False):
                for cpus in acc.free_cpus_in_socket(filter_exclusive):
                    if len(cpus) >= acc.num_needed:
                        acc.take(acc.spread(cpus)[: acc.num_needed])
                        return acc.result

    # final one-at-a-time fill near already-taken cpus (go:220-232)
    for filter_exclusive in (True, False):
        for c in acc.spread(acc.free_cpus(filter_exclusive)):
            if acc.needs(1):
                acc.take([c])
            if acc.satisfied():
                return acc.result

    raise CPUAllocationError("failed to allocate cpus")


def take_preferred_cpus(
    topology: CPUTopology,
    available: Iterable[int],
    preferred: Iterable[int],
    num_needed: int,
    **kwargs,
) -> List[int]:
    """Prefer reusable (e.g. reservation-owned) cpus first
    (reference cpu_accumulator.go:30 takePreferredCPUs)."""
    available = set(available)
    preferred = available & set(preferred)
    result: List[int] = []
    if preferred:
        needed = min(num_needed, len(preferred))
        result = take_cpus(topology, preferred, needed, **kwargs)
        num_needed -= len(result)
        available -= preferred
    if num_needed > 0:
        result = result + take_cpus(topology, available, num_needed, **kwargs)
    return result
