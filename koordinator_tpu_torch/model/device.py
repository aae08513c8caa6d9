"""Device (GPU / RDMA / FPGA) data model for DeviceShare.

Counterpart of ``koordinator_tpu/model/device.py``.  The reference keeps a
per-node device cache keyed by device type and minor (reference
``pkg/scheduler/plugins/deviceshare/device_cache.go:44 nodeDevice``); here
every node's device minors are one dense ``[N, D, C]`` tensor (D = padded
minors per node across all types, C = device resource dims), typed by an
``[N, D]`` device-type code, so device fit counting runs batched.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import pad_bucket, tensors_to

# Device type codes ([N, D] tensor values; reference
# apis/scheduling/v1alpha1/device_types.go DeviceType)
DEVICE_GPU = 0
DEVICE_RDMA = 1
DEVICE_FPGA = 2
DEVICE_TYPE_NAMES = {"gpu": DEVICE_GPU, "rdma": DEVICE_RDMA, "fpga": DEVICE_FPGA}
DEVICE_TYPE_CODE_TO_NAME = {v: k for k, v in DEVICE_TYPE_NAMES.items()}

# Device resource dims (the C axis).  Order is part of the device ABI.
DEVICE_RESOURCE_AXIS = (
    res.GPU_CORE,
    res.GPU_MEMORY,
    res.GPU_MEMORY_RATIO,
    res.RDMA,
    res.FPGA,
)
NUM_DEVICE_RESOURCES = len(DEVICE_RESOURCE_AXIS)
DEVICE_RESOURCE_INDEX = {n: i for i, n in enumerate(DEVICE_RESOURCE_AXIS)}

# Which device resources each type supports (reference
# pkg/scheduler/plugins/deviceshare/utils.go DeviceResourceNames)
DEVICE_TYPE_RESOURCES = {
    DEVICE_GPU: (res.GPU_CORE, res.GPU_MEMORY, res.GPU_MEMORY_RATIO),
    DEVICE_RDMA: (res.RDMA,),
    DEVICE_FPGA: (res.FPGA,),
}


def device_resource_vector(rl: Mapping[str, object]) -> np.ndarray:
    full = res.resource_vector(rl or {})
    return np.array(
        [full[res.RESOURCE_INDEX[n]] for n in DEVICE_RESOURCE_AXIS], dtype=np.int64
    )


@dataclasses.dataclass(frozen=True)
class DeviceBatch:
    """Dense per-node device minors, shapes [N, D, C] / [N, D].

    ``numa`` carries each minor's NUMA node id from the Device CR's
    topology block (reference ``device_types.go DeviceTopology.NodeID``);
    the joint allocator's NUMA-affinity tiebreak reads it.  ``minor`` is
    the per-TYPE CR minor (each type numbers its own minors, so the slot
    index is not the device id on multi-type nodes).
    """

    total: torch.Tensor  # i64[N, D, C]
    free: torch.Tensor  # i64[N, D, C]
    dev_type: torch.Tensor  # i32[N, D] DEVICE_* code
    valid: torch.Tensor  # bool[N, D] healthy minor exists
    numa: Optional[torch.Tensor] = None  # i32[N, D] NUMA node id
    minor: Optional[torch.Tensor] = None  # i32[N, D]

    @property
    def minors(self) -> int:
        return self.total.shape[1]

    def to(self, device) -> "DeviceBatch":
        return tensors_to(self, device)


def encode_devices(
    nodes: Sequence[Mapping],
    *,
    node_bucket: Optional[int] = None,
    minor_bucket: Optional[int] = None,
    device=None,
) -> DeviceBatch:
    """Encode per-node device dicts into a DeviceBatch on ``device``.

    Node dict: ``{"devices": [{"type": "gpu", "minor": 0,
    "total": {res: qty}, "free": {...}, "health": bool,
    "topology": {"numaNode": int}}, ...]}``; ``free`` defaults to
    ``total``.  Devices occupy dense slots in list order; the CR minor
    rides ``minor``.  An unhealthy device keeps its slot with
    ``valid=False``.
    """
    dev = resolve_device(device)
    n_bucket = node_bucket or pad_bucket(len(nodes))
    max_minors = max((len(nd.get("devices", ())) for nd in nodes), default=0)
    d_bucket = minor_bucket or max(1, max_minors)
    C = NUM_DEVICE_RESOURCES

    total = np.zeros((n_bucket, d_bucket, C), np.int64)
    free = np.zeros((n_bucket, d_bucket, C), np.int64)
    dtype = np.zeros((n_bucket, d_bucket), np.int32)
    valid = np.zeros((n_bucket, d_bucket), bool)
    numa = np.zeros((n_bucket, d_bucket), np.int32)
    minor = np.zeros((n_bucket, d_bucket), np.int32)
    for i, nd in enumerate(nodes):
        for j, d in enumerate(nd.get("devices", ())):
            total[i, j] = device_resource_vector(d.get("total", {}))
            free[i, j] = device_resource_vector(d.get("free", d.get("total", {})))
            dtype[i, j] = DEVICE_TYPE_NAMES.get(str(d.get("type", "gpu")).lower(), 0)
            valid[i, j] = bool(d.get("health", True))
            topo = d.get("topology") or {}
            numa[i, j] = int(topo.get("numaNode", 0))
            minor[i, j] = int(d.get("minor", j))

    def t(a):
        return torch.from_numpy(a).to(dev)

    return DeviceBatch(
        total=t(total), free=t(free), dev_type=t(dtype), valid=t(valid),
        numa=t(numa), minor=t(minor),
    )
