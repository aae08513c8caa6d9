"""Built-in extended plugins: NUMA, Reservation, DeviceShare adapters.

Counterpart of ``koordinator_tpu/scheduler/plugins.py``.  Each adapter
exposes a subsystem's batched tensors through the ``TensorPlugin``
boundary (reference plugin registrations at
``cmd/koord-scheduler/main.go:45-53``) and settles the exact per-pod
allocation on the host at Reserve, as the reference's Reserve-phase caches
do (``nodenumaresource/plugin.go Reserve``, ``deviceshare/plugin.go
Reserve``).  What the hooks read from the device (the pods' QoS and CPU
request, each placed pod's nominated reservation on its node and its
request row, the device table) is read back once a cycle by
``read_back``; the hooks themselves run on the host.

Context extras consumed:

* ``zones``: ZoneBatch, ``numa_policy``: i32[N] (NodeNUMAResourcePlugin);
* ``reservations``: ReservationTable (ReservationPlugin);
* ``devices``: DeviceBatch (DeviceSharePlugin);
* ``cpu_topologies``: {node_idx: CPUTopology}, ``available_cpus``:
  {node_idx: set[int]}: cpuset accumulation at Reserve;
* ``device_minors``: {node_idx: [minor dicts]}: minor selection at Reserve;
* ``device_partitions``: {node_idx: {size: [[minor, ...], ...]}}.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.device import (
    DEVICE_GPU,
    DEVICE_RESOURCE_INDEX,
    DEVICE_TYPE_CODE_TO_NAME,
    DEVICE_TYPE_NAMES,
    DEVICE_TYPE_RESOURCES,
)
from koordinator_tpu_torch.ops.deviceshare import (
    allocate_joint,
    device_fit_mask,
    deviceshare_scores,
    fill_gpu_memory,
    gpu_card_total_memory,
    minor_dicts_from_batch,
    normalize_gpu_requests,
    partition_fit_mask,
    pod_device_requests,
    split_per_card,
)
from koordinator_tpu_torch.ops.numa import numa_admit_mask, numa_zone_scores
from koordinator_tpu_torch.ops.reservation import (
    nominate_reservations,
    reservation_affinity_mask,
)
from koordinator_tpu_torch.scheduler.cpu_accumulator import (
    CPUBindPolicy,
    NUMAAllocateStrategy,
    take_cpus,
)
from koordinator_tpu_torch.scheduler.framework import CycleContext, TensorPlugin

_CPU_IDX = res.RESOURCE_INDEX[res.CPU]


def _on(device, idx: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


class NodeNUMAResourcePlugin(TensorPlugin):
    """Zone admission + zone scoring; cpuset accumulation at Reserve.

    reference pkg/scheduler/plugins/nodenumaresource (PreFilter/Filter/
    Score plugin.go:210,266, scoring.go:55; Reserve allocates the cpuset).
    """

    name = "NodeNUMAResource"

    def __init__(
        self,
        *,
        most_allocated: bool = False,
        bind_policy: CPUBindPolicy = CPUBindPolicy.FULL_PCPUS,
        strategy: NUMAAllocateStrategy = NUMAAllocateStrategy.LEAST_ALLOCATED,
    ):
        self.most_allocated = most_allocated
        self.bind_policy = bind_policy
        self.strategy = strategy

    def filter_mask(self, ctx: CycleContext) -> Optional[torch.Tensor]:
        zones = ctx.extras.get("zones")
        policy = ctx.extras.get("numa_policy")
        if zones is None or policy is None:
            return None
        return numa_admit_mask(
            ctx.snapshot.pods.requests, zones.allocatable, zones.requested,
            zones.valid, torch.as_tensor(policy, device=zones.allocatable.device),
        )

    def score(self, ctx: CycleContext) -> Optional[torch.Tensor]:
        zones = ctx.extras.get("zones")
        if zones is None:
            return None
        return numa_zone_scores(
            ctx.snapshot.pods.requests,
            zones.allocatable,
            zones.requested,
            zones.valid,
            ctx.cfg.fit_weights_arr(zones.allocatable.device),
            most_allocated=self.most_allocated,
        )

    def read_back(self, ctx, pods, nodes) -> None:
        """Each placed pod's QoS and CPU request (milli): two columns."""
        snap_pods = ctx.snapshot.pods
        qos = snap_pods.qos.cpu().numpy()[pods]
        milli = snap_pods.requests[:, _CPU_IDX].cpu().numpy()[pods]
        table = ctx.state.setdefault("numa_host", {})
        table.update(zip(zip(pods.tolist(), nodes.tolist()),
                         zip(qos.tolist(), milli.tolist())))

    def reserve(self, ctx: CycleContext, pod_idx: int, node_idx: int) -> None:
        """LSE/LSR pods get an exact cpuset on the chosen node (the
        reference runs this same accumulator; plugin.go Reserve)."""
        topo = (ctx.extras.get("cpu_topologies") or {}).get(node_idx)
        if topo is None:
            return
        qos, milli = self.host_value(ctx, "numa_host", pod_idx, node_idx)
        if qos > 1:  # only LSE(0)/LSR(1) bind cpus
            return
        num_cpus = milli // 1000
        if num_cpus <= 0:
            return
        available = ctx.extras.setdefault("available_cpus", {}).setdefault(
            node_idx, set(topo.details)
        )
        cpus = take_cpus(
            topo,
            available,
            num_cpus,
            bind_policy=self.bind_policy,
            strategy=self.strategy,
        )
        available -= set(cpus)
        ctx.state.setdefault("cpuset_allocations", {})[pod_idx] = sorted(cpus)

    def unreserve(self, ctx: CycleContext, pod_idx: int, node_idx: int) -> None:
        cpus = ctx.state.get("cpuset_allocations", {}).pop(pod_idx, None)
        if cpus:
            avail = ctx.extras.get("available_cpus", {}).get(node_idx)
            if avail is not None:
                avail |= set(cpus)

    def pre_bind(self, ctx, pod_idx, node_idx) -> Optional[Mapping]:
        cpus = ctx.state.get("cpuset_allocations", {}).get(pod_idx)
        if not cpus:
            return None
        # reference apis/extension ResourceStatus annotation
        return {
            "annotations": {
                "scheduling.koordinator.sh/resource-status": {
                    "cpuset": ",".join(map(str, cpus))
                }
            }
        }


class ReservationPlugin(TensorPlugin):
    """Reservation nomination + scoring (reference
    pkg/scheduler/plugins/reservation scoring.go; restore runs as a
    BeforePreFilter transformer upstream of this plugin)."""

    name = "Reservation"

    def filter_mask(self, ctx: CycleContext) -> Optional[torch.Tensor]:
        """Required reservation affinity: a pod carrying the
        reservation-affinity annotation is admitted only onto nodes with
        a matched reservation (reference plugin.go:238)."""
        rsv = ctx.extras.get("reservations")
        if rsv is None:
            return None
        return reservation_affinity_mask(rsv, ctx.snapshot.nodes.capacity)

    def score(self, ctx: CycleContext) -> Optional[torch.Tensor]:
        rsv = ctx.extras.get("reservations")
        if rsv is None:
            return None
        node_scores, nominated = nominate_reservations(
            ctx.snapshot.pods.requests, rsv, ctx.snapshot.nodes.capacity
        )
        ctx.state["nominated_reservations"] = nominated
        return node_scores

    def read_back(self, ctx, pods, nodes) -> None:
        """The reservation each placed pod is nominated to on its node: one
        gather."""
        nominated = ctx.state.get("nominated_reservations")
        if nominated is None:
            return
        flat = _on(nominated.device, pods * nominated.shape[1] + nodes)
        v = nominated.reshape(-1)[flat].cpu().tolist()
        table = ctx.state.setdefault("nominated_at", {})
        table.update(zip(zip(pods.tolist(), nodes.tolist()), v))

    def pre_bind(self, ctx, pod_idx, node_idx) -> Optional[Mapping]:
        if ctx.state.get("nominated_reservations") is None:
            return None
        v = self.host_value(ctx, "nominated_at", pod_idx, node_idx)
        if v < 0:
            return None
        rsv = ctx.extras["reservations"]
        name = rsv.names[v] if v < len(rsv.names) else str(v)
        # reference SetReservationAllocated writes {"name", "uid"}
        # (apis/extension/reservation.go:86-97); uid omitted when the CR
        # uid is unknown to the table
        allocated = {"name": name}
        uid = rsv.uids[v] if v < len(rsv.uids) else ""
        if uid:
            allocated["uid"] = uid
        return {
            "annotations": {
                "scheduling.koordinator.sh/reservation-allocated": allocated
            }
        }


class DeviceSharePlugin(TensorPlugin):
    """Device fit + scoring; minor selection at Reserve (reference
    pkg/scheduler/plugins/deviceshare plugin.go:146,284,450)."""

    name = "DeviceShare"

    def __init__(self, *, most_allocated: bool = False):
        self.most_allocated = most_allocated

    def filter_mask(self, ctx: CycleContext) -> Optional[torch.Tensor]:
        devices = ctx.extras.get("devices")
        if devices is None:
            return None
        mask = device_fit_mask(ctx.snapshot.pods.requests, devices)
        partitions = ctx.extras.get("device_partitions")
        if partitions:
            # partition tables constrain which minor GROUPS co-allocate:
            # the count-based tensor fit overcounts minors no single
            # group contains, so refine with the host-side group check
            norm = normalize_gpu_requests(
                pod_device_requests(ctx.snapshot.pods.requests),
                gpu_card_total_memory(devices),
            )
            per_card_t, wanted_t = split_per_card(norm)
            mask = mask & torch.as_tensor(
                partition_fit_mask(
                    ctx.snapshot.pods.requests,
                    devices,
                    partitions,
                    per_card=per_card_t.cpu().numpy(),
                    wanted=wanted_t.cpu().numpy(),
                ),
                device=mask.device,
            )
        return mask

    def score(self, ctx: CycleContext) -> Optional[torch.Tensor]:
        devices = ctx.extras.get("devices")
        if devices is None:
            return None
        return deviceshare_scores(
            ctx.snapshot.pods.requests, devices, most_allocated=self.most_allocated
        )

    def read_back(self, ctx, pods, nodes) -> None:
        """The device table (once per table) and the placed pods' request
        rows, read to the host; each pod's request split per card on its
        node (requests a device, per-card vector, wanted cards) is then
        computed there, with the same integer ops."""
        devices = ctx.extras.get("devices")
        if devices is None:
            return
        cached = ctx.state.get("devices_host")
        if cached is None or cached[0] is not devices:
            ctx.state["devices_host"] = cached = (devices, devices.to("cpu"))
        requests = ctx.snapshot.pods.requests
        dev_req = pod_device_requests(requests[_on(requests.device, pods)].cpu())
        card_mem = gpu_card_total_memory(cached[1])[torch.from_numpy(nodes)]
        per_card, wanted = split_per_card(fill_gpu_memory(dev_req, card_mem))
        rows = zip(dev_req.any(-1).tolist(), per_card.numpy(), wanted.tolist())
        table = ctx.state.setdefault("device_split", {})
        table.update(zip(zip(pods.tolist(), nodes.tolist()), rows))

    def reserve(self, ctx: CycleContext, pod_idx: int, node_idx: int) -> None:
        if ctx.extras.get("devices") is None:
            return
        requests_any, per_card_vec, wanted = self.host_value(
            ctx, "device_split", pod_idx, node_idx
        )
        minors = (ctx.extras.get("device_minors") or {}).get(node_idx)
        if minors is None:
            # derive the host-side minor view from the tensor extras'
            # host copy.  Minors carry the CR device id from devices.minor
            # (the dense slot index only when devices.minor is absent);
            # device_partitions / preferred / required sets are authored
            # in that minor-id space, never in slot space.
            minors = minor_dicts_from_batch(ctx.state["devices_host"][1], node_idx)
            ctx.extras.setdefault("device_minors", {})[node_idx] = minors
        if not requests_any:
            return

        # split the request per device type and allocate JOINTLY
        # (tryAllocateDevice loops the requested types; NUMA affinity
        # aligns later types with the first's minors); split_per_card
        # divides the GPU dims by wanted and keeps the others whole, so
        # per_card_vec is per-minor for every type
        per_card_by_type = {}
        wanted_by_type = {}
        for code, type_resources in DEVICE_TYPE_RESOURCES.items():
            pc = {
                name: int(per_card_vec[DEVICE_RESOURCE_INDEX[name]])
                for name in type_resources
                if per_card_vec[DEVICE_RESOURCE_INDEX[name]] > 0
            }
            if pc:
                per_card_by_type[code] = pc
                # multi-card spanning applies to GPU ratio requests; other
                # types allocate one minor carrying the full quantity
                wanted_by_type[code] = int(wanted) if code == DEVICE_GPU else 1
        partitions = (ctx.extras.get("device_partitions") or {}).get(node_idx)
        chosen_by_type = allocate_joint(
            minors,
            per_card_by_type,
            wanted_by_type,
            partitions=partitions,
            most_allocated=self.most_allocated,
        )

        def code_of(m):
            return DEVICE_TYPE_NAMES.get(str(m.get("type", "gpu")).lower(), 0)

        for m in minors:
            if m["minor"] in chosen_by_type.get(code_of(m), ()):
                per_card = per_card_by_type.get(code_of(m), {})
                free = m.setdefault("free", dict(m.get("total", {})))
                for dim, q in per_card.items():
                    left = int(res.parse_quantity(free.get(dim, 0), dim)) - q
                    # write back a form parse_quantity round-trips exactly
                    free[dim] = res.format_quantity(left, dim)
        # the reference's DeviceAllocations annotation payload
        # (apis/extension/device_share.go:56-66: type name -> entries of
        # {"minor", "resources"}), written at PreBind and read by the
        # koordlet gpu hook
        allocations = {}
        for code, chosen in chosen_by_type.items():
            per_card = per_card_by_type.get(code, {})
            allocations[DEVICE_TYPE_CODE_TO_NAME[code]] = [
                {
                    "minor": int(m),
                    "resources": {
                        dim: res.format_quantity(int(q), dim)
                        for dim, q in per_card.items()
                    },
                }
                for m in sorted(chosen)
            ]
        ctx.state.setdefault("device_allocations", {})[pod_idx] = allocations

    def pre_bind(self, ctx, pod_idx, node_idx) -> Optional[Mapping]:
        alloc = ctx.state.get("device_allocations", {}).get(pod_idx)
        if not alloc:
            return None
        return {
            "annotations": {
                "scheduling.koordinator.sh/device-allocated": alloc
            }
        }
