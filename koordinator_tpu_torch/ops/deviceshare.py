"""DeviceShare fit and scoring as batched tensors, and exact minor allocation.

Counterpart of ``koordinator_tpu/ops/deviceshare.py`` (reference
``pkg/scheduler/plugins/deviceshare``):

* Requests are shares-of-100 per card; a request whose gpu-memory-ratio is a
  multiple of 100 spans ``ratio/100`` whole cards at ``request/wanted`` per
  card (``device_cache.go:367 calcDeviceWanted``).
* gpu-memory and gpu-memory-ratio fill each other from the card's total
  memory (``utils.go:211 fillGPUTotalMem``), so the normalised request is
  node-dependent: ``[P, N, C]``.
* Filter: a node fits if, per requested device type, at least ``wanted``
  minors have ``free >= perCard`` (``device_cache.go:329-352``).
* Score: least/most-allocated over summed minor resources
  (``scoring.go:179 scoreNode``).
* The per-minor choice on the selected node replays the reference's exact
  ordering on the host (``allocate_minors``; ``device_resources.go:161,177``).

The ``[P, N, ...]`` functions compute over chunks of pod rows
(``greedy.by_rows``); each output row reads its own pod row only, so the
chunked result equals one unchunked call bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.model.device import (
    DEVICE_FPGA,
    DEVICE_GPU,
    DEVICE_RDMA,
    DEVICE_RESOURCE_AXIS,
    DEVICE_RESOURCE_INDEX,
    DEVICE_TYPE_CODE_TO_NAME,
    DEVICE_TYPE_NAMES,
    DEVICE_TYPE_RESOURCES,
    DeviceBatch,
    NUM_DEVICE_RESOURCES,
)
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import MAX_NODE_SCORE
from koordinator_tpu_torch.ops.scoring import (
    least_requested_score,
    most_requested_score,
)
from koordinator_tpu_torch.solver.greedy import by_rows

_CORE = DEVICE_RESOURCE_INDEX[res.GPU_CORE]
_MEM = DEVICE_RESOURCE_INDEX[res.GPU_MEMORY]
_RATIO = DEVICE_RESOURCE_INDEX[res.GPU_MEMORY_RATIO]
# snapshot resource index of each device dim
_DEVICE_AXIS = [res.RESOURCE_INDEX[n] for n in DEVICE_RESOURCE_AXIS]
# device resource dims that belong to the GPU type: the card-spanning
# division applies to these only (an RDMA/FPGA quantity is not divided by
# the number of GPU cards a co-requesting pod wants)
_GPU_DIMS = [DEVICE_RESOURCE_INDEX[n] for n in DEVICE_TYPE_RESOURCES[DEVICE_GPU]]


def pod_device_requests(pod_requests: torch.Tensor) -> torch.Tensor:
    """i64[P, C]: snapshot resource rows projected onto the device axis."""
    return pod_requests[:, _DEVICE_AXIS]


def gpu_card_total_memory(devices: DeviceBatch) -> torch.Tensor:
    """i64[N]: per-node GPU card memory (all cards on a node are the same
    model, utils.go:225)."""
    is_gpu = (devices.dev_type == DEVICE_GPU) & devices.valid
    return torch.where(is_gpu, devices.total[:, :, _MEM], 0).max(1).values


def fill_gpu_memory(dev_requests: torch.Tensor, card_mem: torch.Tensor) -> torch.Tensor:
    """i64[..., C]: fillGPUTotalMem for requests ``[..., C]`` against card
    memories that broadcast with their leading shape: a memory-only request
    derives its ratio from the card's memory and a ratio-only request its
    memory."""
    mem_req = dev_requests[..., _MEM]
    ratio_req = dev_requests[..., _RATIO]
    new_ratio = torch.where(mem_req > 0, mem_req * 100 // card_mem.clamp(min=1), ratio_req)
    new_mem = torch.where(mem_req > 0, mem_req, ratio_req * card_mem // 100)
    shape = torch.broadcast_shapes(mem_req.shape, card_mem.shape)
    out = dev_requests.expand(shape + dev_requests.shape[-1:]).clone()
    out[..., _RATIO] = new_ratio
    out[..., _MEM] = new_mem
    return out


def normalize_gpu_requests(
    dev_requests: torch.Tensor,  # i64[P, C]
    card_mem: torch.Tensor,  # i64[N]
) -> torch.Tensor:
    """i64[P, N, C]: ``fill_gpu_memory`` of every pod on every node."""
    return fill_gpu_memory(dev_requests[:, None, :], card_mem[None, :])


def split_per_card(norm_requests: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perCard i64[..., C], wanted i64[...]): calcDeviceWanted, a ratio
    that is a positive multiple of 100 spans ratio/100 cards.  The division
    applies to the GPU dims only; other device types keep their whole
    per-minor quantity (they allocate one minor per request)."""
    ratio = norm_requests[..., _RATIO]
    multi = (ratio >= 100) & (ratio % 100 == 0)
    wanted = torch.where(multi, ratio // 100, 1)
    is_gpu_dim = torch.zeros(
        norm_requests.shape[-1], dtype=torch.bool, device=norm_requests.device
    )
    is_gpu_dim[_GPU_DIMS] = True
    divided = norm_requests // wanted.clamp(min=1)[..., None]
    return torch.where(is_gpu_dim, divided, norm_requests), wanted


def device_fit_mask(
    pod_requests: torch.Tensor,  # i64[P, R] (snapshot axis)
    devices: DeviceBatch,
) -> torch.Tensor:
    """bool[P, N]: every requested device type has >= wanted satisfying minors."""
    card_mem = gpu_card_total_memory(devices)  # [N]
    N, D, C = devices.total.shape

    def rows(sl):
        dev_req = pod_device_requests(pod_requests[sl])  # [rows, C]
        norm = normalize_gpu_requests(dev_req, card_mem)  # [rows, N, C]
        per_card, wanted = split_per_card(norm)
        ok = torch.ones((dev_req.shape[0], N), dtype=torch.bool, device=dev_req.device)
        for type_code, type_resources in DEVICE_TYPE_RESOURCES.items():
            dims = [DEVICE_RESOURCE_INDEX[n] for n in type_resources]
            requested_type = (dev_req[:, dims] > 0).any(-1)  # [rows]
            minors_of_type = (devices.dev_type == type_code) & devices.valid  # [N, D]
            satisfied = (
                per_card[:, :, None, dims] <= devices.free[None, :, :, dims]
            ).all(-1) & minors_of_type[None]  # [rows, N, D]
            count = satisfied.sum(-1)  # [rows, N]
            # card-spanning applies to the GPU type; other types want one
            # satisfying minor for their (undivided) request
            type_ok = count >= (wanted if type_code == DEVICE_GPU else 1)
            ok &= torch.where(requested_type[:, None], type_ok, True)
            has_type = minors_of_type.any(-1)  # [N]
            ok &= torch.where(requested_type[:, None], has_type[None, :] | type_ok, True)
        return ok

    return by_rows(rows, pod_requests.shape[0], N * max(D, 1) * C * 8)


def deviceshare_scores(
    pod_requests: torch.Tensor,  # i64[P, R]
    devices: DeviceBatch,
    weights: Optional[torch.Tensor] = None,  # i64[C]
    *,
    most_allocated: bool = False,
) -> torch.Tensor:
    """i64[P, N]: scoreNode (scoring.go:179), least/most allocated over
    per-type summed minor resources; dims the pod does not request carry
    weight 0 (the reference masks podRequest per type)."""
    card_mem = gpu_card_total_memory(devices)
    valid = devices.valid[:, :, None]
    total = torch.where(valid, devices.total, 0).sum(1)  # [N, C]
    used = total - torch.where(valid, devices.free, 0).sum(1)
    if weights is None:
        weights = torch.ones(NUM_DEVICE_RESOURCES, dtype=torch.int64)
    weights = weights.to(total.device)
    scorer = most_requested_score if most_allocated else least_requested_score
    N, C = total.shape

    def rows(sl):
        norm = normalize_gpu_requests(pod_device_requests(pod_requests[sl]), card_mem)
        per_res = scorer(used[None] + norm, total[None])  # [rows, N, C]
        w = weights[None, None, :] * (norm > 0)
        return (per_res * w).sum(-1) // w.sum(-1).clamp(min=1)

    return by_rows(rows, pod_requests.shape[0], N * C * 8)


def allocate_minors(
    minors: Sequence[Mapping],
    per_card: Mapping[str, int],
    wanted: int,
    *,
    preferred: Optional[Set[int]] = None,
    required: Optional[Set[int]] = None,
    most_allocated: bool = False,
    preferred_numa: Optional[Set[int]] = None,
) -> List[int]:
    """Host-side exact minor selection on the chosen node.

    ``minors``: ``[{"minor": int, "total": {dim: qty}, "free": {dim: qty},
    "topology": {"numaNode": int}}]``.
    Ordering parity with scoreDevices + sortDeviceResourcesByMinor
    (device_resources.go:161,177): preferred minors first, then score
    descending (scoreDevice), then — when ``preferred_numa`` is given —
    NUMA-affine minors before others (the joint allocator's cross-type
    alignment tiebreak), then minor ascending; the first ``wanted``
    satisfying minors win.  Raises ValueError when the node can't satisfy.
    """
    preferred = preferred or set()
    required = required or set()
    preferred_numa = preferred_numa or set()

    ranked = sorted(
        minors,
        key=lambda m: (
            m["minor"] not in preferred,
            -_score_device(m, per_card, most_allocated),
            bool(preferred_numa) and _numa_of(m) not in preferred_numa,
            m["minor"],
        ),
    )
    out: List[int] = []
    for m in ranked:
        if required and m["minor"] not in required:
            continue
        if _satisfies(m, per_card):
            out.append(m["minor"])
            if len(out) == wanted:
                return out
    raise ValueError(f"node cannot satisfy {wanted} device minors")


def _free_of(m: Mapping) -> Dict[str, int]:
    # an unallocated healthy device is fully free (deviceFree == total)
    src = m.get("free")
    if src is None:
        src = m.get("total") or {}
    return {dim: res.parse_quantity(v, dim) for dim, v in src.items()}


def _numa_of(m: Mapping) -> int:
    return int((m.get("topology") or {}).get("numaNode", 0))


def _satisfies(m: Mapping, per_card: Mapping[str, int]) -> bool:
    free = _free_of(m)
    return all(free.get(d, 0) >= q for d, q in per_card.items())


def _score_device(
    m: Mapping, per_card: Mapping[str, int], most_allocated: bool
) -> int:
    """scoreDevice (device_resources.go:161): least/most allocated over
    the minor's dims as if per_card were placed — the ONE copy both the
    per-minor and the partition-group orderings use."""
    s = 0
    n = 0
    free = _free_of(m)
    for dim, total in (m.get("total") or {}).items():
        total = res.parse_quantity(total, dim)
        if total == 0:
            continue
        f = free.get(dim, 0)
        req = total - f + int(per_card.get(dim, 0)) if total >= f else total
        if most_allocated:
            val = max(0, MAX_NODE_SCORE * req // total) if req <= total else 0
        else:
            val = (total - req) * MAX_NODE_SCORE // total if req <= total else 0
        s += val
        n += 1
    return s // n if n else 0


def allocate_partitioned(
    minors: Sequence[Mapping],
    per_card: Mapping[str, int],
    wanted: int,
    partitions: Mapping[int, Sequence[Sequence[int]]],
    *,
    preferred: Optional[Set[int]] = None,
    required: Optional[Set[int]] = None,
    most_allocated: bool = False,
) -> List[int]:
    """Partition-table-constrained multi-card selection.

    ``partitions`` maps allocation size -> the minor groups that may be
    co-allocated at that size (the GPU partition-table semantics of newer
    koordinator ``apis/extension`` — e.g. NVLink rings on an 8-GPU host:
    ``{4: [[0,1,2,3], [4,5,6,7]], 8: [[0..7]]}``).  The chosen set must
    be exactly one listed group whose every minor satisfies ``per_card``
    (and covers ``required`` when given); among feasible groups the one
    containing preferred minors wins, then the emptiest (least-allocated)
    or fullest (most-allocated) by summed minor score, then the lowest
    first minor.  Sizes without a table entry fall back to the free
    per-minor ordering (``allocate_minors``).
    """
    groups = partitions.get(wanted) if partitions else None
    if not groups:
        return allocate_minors(
            minors,
            per_card,
            wanted,
            preferred=preferred,
            required=required,
            most_allocated=most_allocated,
        )
    preferred = preferred or set()
    required = required or set()
    by_minor = {m["minor"]: m for m in minors}

    feasible = []
    for group in groups:
        if len(group) != wanted:
            continue
        members = [by_minor.get(g) for g in group]
        if any(m is None for m in members):
            continue
        if required and not required.issubset(set(group)):
            continue
        if not all(_satisfies(m, per_card) for m in members):
            continue
        feasible.append((group, members))
    if not feasible:
        raise ValueError(
            f"no partition group of size {wanted} can satisfy the request"
        )
    best = min(
        feasible,
        key=lambda gm: (
            not any(g in preferred for g in gm[0]),
            -sum(_score_device(m, per_card, most_allocated) for m in gm[1]),
            min(gm[0]),
        ),
    )
    return sorted(best[0])


# device-type allocation order of the joint allocator (tryAllocateDevice
# iterates DeviceResourceNames; a fixed order keeps results deterministic)
_JOINT_TYPE_ORDER = (DEVICE_GPU, DEVICE_RDMA, DEVICE_FPGA)
_TYPE_NAMES = {DEVICE_GPU: "gpu", DEVICE_RDMA: "rdma", DEVICE_FPGA: "fpga"}


def allocate_joint(
    minors: Sequence[Mapping],
    per_card_by_type: Mapping[int, Mapping[str, int]],
    wanted_by_type: Mapping[int, int],
    *,
    partitions: Optional[Mapping[int, Sequence[Sequence[int]]]] = None,
    preferred: Optional[Mapping[int, Set[int]]] = None,
    required: Optional[Mapping[int, Set[int]]] = None,
    most_allocated: bool = False,
) -> Dict[int, List[int]]:
    """Joint allocation across device types on one node (reference
    ``device_cache.go:272 tryAllocateDevice`` loops the requested types;
    ``allocator.go:91`` drives it from the plugin).

    Types allocate in a fixed order (GPU first); after the first type
    lands, its minors' NUMA nodes become the NUMA-affinity preference for
    every later type, so a GPU+RDMA pod gets an RDMA NIC on the same NUMA
    node as its GPUs whenever one satisfies the request (the alignment
    newer koordinator drives through device topology hints).  GPU
    allocations honor the node's partition table when one exists.

    ``minors`` carry a ``"type"`` name; returns {type_code: [minor, ...]}.
    Raises ValueError when any requested type cannot be satisfied
    (all-or-nothing, like the reference's tryAllocateDevice).
    """
    preferred = preferred or {}
    required = required or {}
    out: Dict[int, List[int]] = {}
    numa_hint: Set[int] = set()
    by_type: Dict[int, List[Mapping]] = {}
    for m in minors:
        code = DEVICE_TYPE_NAMES.get(str(m.get("type", "gpu")).lower(), DEVICE_GPU)
        by_type.setdefault(code, []).append(m)
    for code in _JOINT_TYPE_ORDER:
        per_card = per_card_by_type.get(code)
        if not per_card:
            continue
        wanted = int(wanted_by_type.get(code, 1))
        pool = by_type.get(code, [])
        if not pool:
            raise ValueError(f"node has no {_TYPE_NAMES[code]} devices")
        if code == DEVICE_GPU and partitions:
            chosen = allocate_partitioned(
                pool,
                per_card,
                wanted,
                partitions,
                preferred=preferred.get(code),
                required=required.get(code),
                most_allocated=most_allocated,
            )
        else:
            chosen = allocate_minors(
                pool,
                per_card,
                wanted,
                preferred=preferred.get(code),
                required=required.get(code),
                most_allocated=most_allocated,
                preferred_numa=numa_hint or None,
            )
        out[code] = chosen
        for m in pool:
            if m["minor"] in chosen:
                numa_hint.add(_numa_of(m))
    return out


def minor_dicts_from_batch(devices: DeviceBatch, node_idx: int) -> List[Dict]:
    """The host-side minor dicts of one node, rebuilt from the dense
    DeviceBatch: the Reserve path's input when the caller supplies only the
    tensor extras (device id from ``devices.minor``, else the dense index;
    topology from ``devices.numa``).  Reads the node's rows to the host;
    Reserve passes a host copy of the batch, read once a cycle."""
    def host(t):
        return t[node_idx].cpu().numpy()

    total, free, dtyp, valid = (
        host(devices.total), host(devices.free), host(devices.dev_type), host(devices.valid)
    )
    numa = host(devices.numa) if devices.numa is not None else np.zeros_like(dtyp)
    minors_t = (
        host(devices.minor) if devices.minor is not None
        else np.arange(total.shape[0], dtype=np.int32)
    )
    out: List[Dict] = []
    for d in range(total.shape[0]):
        if not valid[d]:
            continue
        dims = DEVICE_TYPE_RESOURCES[int(dtyp[d])]
        # tensor cells are axis units (MiB/milli); the minor-dict contract
        # carries parse_quantity-round-trippable forms
        out.append(
            {
                "minor": int(minors_t[d]),
                "type": DEVICE_TYPE_CODE_TO_NAME[int(dtyp[d])],
                "total": {
                    n: res.format_quantity(int(total[d, DEVICE_RESOURCE_INDEX[n]]), n)
                    for n in dims
                },
                "free": {
                    n: res.format_quantity(int(free[d, DEVICE_RESOURCE_INDEX[n]]), n)
                    for n in dims
                },
                "topology": {"numaNode": int(numa[d])},
            }
        )
    return out


def partition_fit_mask(
    pod_requests: torch.Tensor,  # i64[P, R] (snapshot axis)
    devices: DeviceBatch,
    partitions_by_node: Mapping[int, Mapping[int, Sequence[Sequence[int]]]],
    *,
    per_card: Optional[np.ndarray] = None,  # precomputed [P, N, C]
    wanted: Optional[np.ndarray] = None,  # precomputed [P, N]
) -> np.ndarray:
    """bool[P, N], the host-side refinement of ``device_fit_mask``: on nodes
    with a GPU partition table, a multi-card request fits only when some
    listed group of the wanted size has every member free enough (the
    count-based tensor fit can overcount minors that no single group
    contains).  Callers that already ran the normalisation pass
    ``per_card``/``wanted``."""
    dev_req = pod_device_requests(pod_requests).cpu().numpy()  # [P, C]
    if per_card is None or wanted is None:
        norm = normalize_gpu_requests(
            pod_device_requests(pod_requests), gpu_card_total_memory(devices)
        )
        per_card_t, wanted_t = split_per_card(norm)
        per_card = per_card_t.cpu().numpy()
        wanted = wanted_t.cpu().numpy()
    free = devices.free.cpu().numpy()
    is_gpu = ((devices.dev_type == DEVICE_GPU) & devices.valid).cpu().numpy()
    # partition-table groups carry CR minor ids (the id space
    # allocate_partitioned matches against m["minor"]), which differ from
    # dense slot indices on multi-type nodes; map minor -> slot per node,
    # restricted to GPU minors so an RDMA NIC sharing a minor number with
    # a GPU cannot shadow it.
    minors_t = (
        devices.minor.cpu().numpy()
        if devices.minor is not None
        else np.broadcast_to(np.arange(free.shape[1], dtype=np.int64), is_gpu.shape)
    )

    P, N = wanted.shape
    ok = np.ones((P, N), bool)
    gpu_requested = dev_req[:, _GPU_DIMS].max(axis=1) > 0  # [P]
    for n, tables in (partitions_by_node or {}).items():
        if n >= N or not tables:
            continue
        minor_to_slot = {
            int(minors_t[n, d]): d for d in range(free.shape[1]) if is_gpu[n, d]
        }
        for p in range(P):
            if not gpu_requested[p]:
                continue
            w = int(wanted[p, n])
            groups = tables.get(w)
            if not groups:
                continue  # no table for this size: tensor fit stands
            need = per_card[p, n][_GPU_DIMS]
            fit = False
            for group in groups:
                if len(group) != w:
                    continue
                slots = [minor_to_slot.get(g) for g in group]
                if all(
                    d is not None and (free[n, d][_GPU_DIMS] >= need).all()
                    for d in slots
                ):
                    fit = True
                    break
            ok[p, n] = fit
    return ok
