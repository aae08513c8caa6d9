"""Resource registry and Kubernetes quantity parsing.

The dense snapshot tensors have a fixed, ordered resource axis.  This module
defines that ordering and converts Kubernetes-style quantity strings
("500m", "8Gi", "2") into the integer units each resource is accounted in.

Units follow the reference's accounting (reference
``pkg/scheduler/plugins/loadaware/load_aware.go`` ``getResourceValue``:
CPU in milli-cores via ``MilliValue()``, everything else in base units via
``Value()``; batch-cpu is already milli — ``apis/extension/resource.go:26``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

# Canonical resource axis for all snapshot tensors.  Order is part of the
# on-device ABI: encoders, kernels and the bridge all index by it.
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
BATCH_CPU = "kubernetes.io/batch-cpu"
BATCH_MEMORY = "kubernetes.io/batch-memory"
MID_CPU = "kubernetes.io/mid-cpu"
MID_MEMORY = "kubernetes.io/mid-memory"
GPU_CORE = "koordinator.sh/gpu-core"
GPU_MEMORY_RATIO = "koordinator.sh/gpu-memory-ratio"
GPU_MEMORY = "koordinator.sh/gpu-memory"
RDMA = "koordinator.sh/rdma"
FPGA = "koordinator.sh/fpga"

RESOURCE_AXIS = (
    CPU,
    MEMORY,
    EPHEMERAL_STORAGE,
    PODS,
    BATCH_CPU,
    BATCH_MEMORY,
    MID_CPU,
    MID_MEMORY,
    GPU_CORE,
    GPU_MEMORY_RATIO,
    GPU_MEMORY,
    RDMA,
    FPGA,
)
NUM_RESOURCES = len(RESOURCE_AXIS)
RESOURCE_INDEX: Dict[str, int] = {name: i for i, name in enumerate(RESOURCE_AXIS)}

# Resources accounted in milli-units (the reference calls MilliValue() for
# native cpu; batch-cpu / mid-cpu quantities are already expressed in milli).
_MILLI_RESOURCES = frozenset({CPU})

# Byte-denominated resources are accounted in MiB on the dense axis (the
# reference accounts them in bytes via Quantity.Value()).  MiB units keep
# every scoring intermediate — (capacity - requested) * MaxNodeScore — inside
# int32 for capacities up to 2^31/100 MiB (~20 TiB per node), which lets a
# 32-bit kernel run exact integer score math without int64
# emulation.  Inputs remain k8s byte quantities; only the axis unit changes.
MIB_RESOURCES = frozenset(
    {MEMORY, EPHEMERAL_STORAGE, BATCH_MEMORY, MID_MEMORY, GPU_MEMORY}
)
MIB = 1024 * 1024

_BINARY_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIX = {
    "n": 10**-9,
    "u": 10**-6,
    "m": 10**-3,
    "": 1,
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+)([A-Za-z]*)$")


def _base_units(value, resource: str) -> float:
    """Quantity -> float base units (bytes for memory, cores for cpu)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    text = str(value).strip()
    m = _QUANTITY_RE.match(text)
    if m is None:
        raise ValueError(f"unparseable quantity {value!r} for {resource}")
    digits, suffix = m.groups()
    if suffix in _BINARY_SUFFIX:
        return float(digits) * _BINARY_SUFFIX[suffix]
    if suffix in _DECIMAL_SUFFIX:
        return float(digits) * _DECIMAL_SUFFIX[suffix]
    raise ValueError(f"unknown quantity suffix {suffix!r} in {value!r}")


def _ceil(base: float) -> int:
    # Quantity.Value() rounds up to the nearest integer.
    iv = int(base)
    return iv if iv == base or base < 0 else iv + 1


def parse_quantity(value, resource: str) -> int:
    """Parse a quantity into the integer unit used on the resource axis.

    ``cpu`` is returned in milli-cores (``"1.5" -> 1500``, ``"500m" -> 500``);
    byte-denominated resources (memory, ephemeral-storage, batch/mid memory,
    gpu-memory) in MiB rounded up (``"1Gi" -> 1024``, ``"512Mi" -> 512``);
    all other resources in base units rounded up like apimachinery's
    ``Quantity.Value()`` (``"100m" -> 1`` for non-cpu, matching ceil
    semantics).
    """
    base = _base_units(value, resource)
    if resource in _MILLI_RESOURCES:
        return round(base * 1000)
    if resource in MIB_RESOURCES:
        base = base / MIB
    return _ceil(base)


def parse_quantity_bytes(value, resource: str) -> int:
    """Parse a byte-denominated quantity into BYTES (not axis MiB units).

    For node-local actuation (cgroup memory limits) where the kernel needs
    bytes.  Accepts the same forms as parse_quantity; raw numbers are bytes.
    """
    if resource not in MIB_RESOURCES:
        raise ValueError(f"{resource} is not byte-denominated")
    return _ceil(_base_units(value, resource))


def format_quantity(axis_value: int, resource: str):
    """Render an axis-unit integer as a quantity that parse_quantity will
    round-trip exactly (MiB resources need the "Mi" suffix; cpu axis units
    are milli, rendered with "m").  Producers that write system-computed
    resources back into pod/node objects must use this."""
    if resource in MIB_RESOURCES:
        return f"{int(axis_value)}Mi"
    if resource in _MILLI_RESOURCES:
        return f"{int(axis_value)}m"
    return int(axis_value)


def encode_resource_list(resources: Mapping[str, object]) -> Dict[int, int]:
    """Map a {resource-name: quantity} dict onto {axis-index: int units}.

    Unknown resource names are ignored (the dense axis is fixed; exotic
    scalar resources ride the bridge as opaque key/values instead).
    """
    out: Dict[int, int] = {}
    for name, q in resources.items():
        idx = RESOURCE_INDEX.get(name)
        if idx is not None:
            out[idx] = parse_quantity(q, name)
    return out


def resource_vector(resources: Mapping[str, object]) -> list:
    """Encode into a dense length-NUM_RESOURCES python int list."""
    vec = [0] * NUM_RESOURCES
    for idx, v in encode_resource_list(resources).items():
        vec[idx] = v
    return vec


def weights_vector(weights: Mapping[str, int]) -> list:
    """Encode a resource->weight map onto the dense axis (0 = unscored)."""
    vec = [0] * NUM_RESOURCES
    for name, w in weights.items():
        idx = RESOURCE_INDEX.get(name)
        if idx is not None:
            vec[idx] = int(w)
    return vec


def names(indices: Iterable[int]) -> list:
    return [RESOURCE_AXIS[i] for i in indices]
