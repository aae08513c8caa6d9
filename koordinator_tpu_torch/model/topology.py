"""CPU / NUMA topology model.

Counterpart of ``koordinator_tpu/model/topology.py``.  Host side:
``CPUTopology`` describes one node's logical-CPU layout (cpu -> core ->
NUMA node -> socket), the contract for the cpuset accumulator (reference
``pkg/scheduler/plugins/nodenumaresource/cpu_topology.go``).

Device side: ``ZoneBatch`` holds every node's NUMA-zone resources as one
dense ``[N, Z, R]`` tensor, so zone-level fit and scoring run batched
(reference ``topology_options.go TopologyOptions.NUMANodeResources``, per
node lists there; here the zone axis is padded like every snapshot axis).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import pad_bucket, tensors_to

DEFAULT_AMPLIFICATION_DENOMINATOR = 10_000


def amplify(value: int, ratio_x10000: int) -> int:
    """reference apis/extension/node.go Amplify: ceil(value * ratio), the
    ratio carried as a fixed-point x10000 int."""
    if ratio_x10000 <= DEFAULT_AMPLIFICATION_DENOMINATOR:
        return value
    num = value * ratio_x10000
    return -(-num // DEFAULT_AMPLIFICATION_DENOMINATOR)  # ceil div


@dataclasses.dataclass(frozen=True)
class CPUInfo:
    """One logical CPU (reference cpu_topology.go CPUInfo)."""

    cpu: int
    core: int
    node: int  # NUMA node id
    socket: int


@dataclasses.dataclass
class CPUTopology:
    """Logical-CPU layout of one node (reference cpu_topology.go CPUTopology).

    ``details`` maps cpu id -> CPUInfo.  Derived counts mirror
    ``CPUsPerCore/CPUsPerNode/CPUsPerSocket`` (cpu_topology.go:51-73).
    """

    details: Dict[int, CPUInfo]

    @classmethod
    def build(
        cls,
        sockets: int,
        nodes_per_socket: int,
        cores_per_node: int,
        threads_per_core: int = 2,
    ) -> "CPUTopology":
        """A regular topology, CPU ids contiguous per core (siblings
        adjacent), as the reference's tests build it
        (cpu_accumulator_test.go:30 buildCPUTopologyForTest)."""
        details: Dict[int, CPUInfo] = {}
        cpu = 0
        core = 0
        node = 0
        for s in range(sockets):
            for _n in range(nodes_per_socket):
                for _c in range(cores_per_node):
                    for _t in range(threads_per_core):
                        details[cpu] = CPUInfo(cpu=cpu, core=core, node=node, socket=s)
                        cpu += 1
                    core += 1
                node += 1
        return cls(details=details)

    @property
    def num_cpus(self) -> int:
        return len(self.details)

    @property
    def num_cores(self) -> int:
        return len({i.core for i in self.details.values()})

    @property
    def num_nodes(self) -> int:
        return len({i.node for i in self.details.values()})

    @property
    def num_sockets(self) -> int:
        return len({i.socket for i in self.details.values()})

    def is_valid(self) -> bool:
        return self.num_cpus > 0 and self.num_cores > 0

    def cpus_per_core(self) -> int:
        return self.num_cpus // max(self.num_cores, 1)

    def cpus_per_node(self) -> int:
        return self.num_cpus // max(self.num_nodes, 1)

    def cpus_per_socket(self) -> int:
        return self.num_cpus // max(self.num_sockets, 1)

    def cpus_in_node(self, node: int) -> List[int]:
        return sorted(i.cpu for i in self.details.values() if i.node == node)

    def cpus_in_socket(self, socket: int) -> List[int]:
        return sorted(i.cpu for i in self.details.values() if i.socket == socket)

    def cpus_in_core(self, core: int) -> List[int]:
        return sorted(i.cpu for i in self.details.values() if i.core == core)


@dataclasses.dataclass(frozen=True)
class ZoneBatch:
    """Dense per-node NUMA-zone resources, shapes [N, Z, R] / [N, Z].

    ``allocatable``/``requested`` follow the snapshot's resource axis;
    ``valid`` masks real zones (Z is the padded max zone count).
    ``cpu_amplification`` is the node-level CPU amplification ratio x10000
    (reference ``apis/extension/node.go NodeResourceAmplificationRatio``).
    """

    allocatable: torch.Tensor  # i64[N, Z, R]
    requested: torch.Tensor  # i64[N, Z, R]
    valid: torch.Tensor  # bool[N, Z]
    cpu_amplification: torch.Tensor  # i32[N] ratio x10000 (10000 = 1.0)

    @property
    def num_zones(self) -> int:
        return self.allocatable.shape[1]

    def to(self, device) -> "ZoneBatch":
        return tensors_to(self, device)


def encode_zones(
    nodes: Sequence[Mapping],
    *,
    node_bucket: Optional[int] = None,
    zone_bucket: Optional[int] = None,
    device=None,
) -> ZoneBatch:
    """Encode per-node zone dicts into a ZoneBatch on ``device``.

    Node dict: ``{"zones": [{"allocatable": {res: qty}, "requested": {...}},
    ...], "cpu_amplification": float}``; nodes without zones get zero zones
    (they skip NUMA admission).
    """
    dev = resolve_device(device)
    n_bucket = node_bucket or pad_bucket(len(nodes))
    max_zones = max((len(nd.get("zones", ())) for nd in nodes), default=0)
    z_bucket = zone_bucket or max(1, max_zones)
    R = res.NUM_RESOURCES

    alloc = np.zeros((n_bucket, z_bucket, R), np.int64)
    reqd = np.zeros((n_bucket, z_bucket, R), np.int64)
    valid = np.zeros((n_bucket, z_bucket), bool)
    ampl = np.full((n_bucket,), DEFAULT_AMPLIFICATION_DENOMINATOR, np.int32)
    for i, nd in enumerate(nodes):
        for z, zone in enumerate(nd.get("zones", ())):
            alloc[i, z] = res.resource_vector(zone.get("allocatable", {}))
            reqd[i, z] = res.resource_vector(zone.get("requested", {}))
            valid[i, z] = True
        ratio = nd.get("cpu_amplification")
        if ratio:
            ampl[i] = int(round(float(ratio) * DEFAULT_AMPLIFICATION_DENOMINATOR))
    return ZoneBatch(
        allocatable=torch.from_numpy(alloc).to(dev),
        requested=torch.from_numpy(reqd).to(dev),
        valid=torch.from_numpy(valid).to(dev),
        cpu_amplification=torch.from_numpy(ampl).to(dev),
    )
