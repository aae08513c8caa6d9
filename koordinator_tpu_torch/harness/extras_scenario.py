"""The extended-plugin scenario, its composed tensors, and the native
interchange file.

Counterpart of ``koordinator_tpu/harness/extras_scenario.py``:

* ``extras_scenario`` builds one deterministic cluster whose tables
  exercise all three extended plugins (NUMA zones with a policy mix,
  GPU/RDMA minors, matched reservations with required affinity);
* ``plugin_extra_tensors`` composes the real TensorPlugins through the
  FrameworkExtender: the ``(extra_mask, extra_scores)`` that
  ``FrameworkExtender.run_cycle`` hands the cycle;
* ``write_extras_file`` serialises the raw subsystem tables (not the
  composed tensors) for ``native/score_baseline.cpp``, which re-derives
  the mask and scores on its own.

File format (little-endian): magic ``KEXT1\n``, then per section a u32 name
length, the name, u32 ndim, i64 dims, and the row-major i64 payload
(bools/i32 widened to i64).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.device import (
    DEVICE_RESOURCE_AXIS,
    DeviceBatch,
    encode_devices,
)
from koordinator_tpu_torch.model.reservation import (
    ReservationTable,
    encode_reservations,
)
from koordinator_tpu_torch.model.snapshot import pad_bucket
from koordinator_tpu_torch.model.topology import ZoneBatch, encode_zones

Gi = 1 << 30
Mi = 1 << 20

# canonical device-axis projection: C column -> snapshot resource index
DEV_AXIS = [res.RESOURCE_INDEX[n] for n in DEVICE_RESOURCE_AXIS]


def extended_plugins():
    """NUMA, Reservation and DeviceShare with their default settings, in
    the reference bench's order."""
    from koordinator_tpu_torch.scheduler.plugins import (
        DeviceSharePlugin,
        NodeNUMAResourcePlugin,
        ReservationPlugin,
    )

    return [NodeNUMAResourcePlugin(), ReservationPlugin(), DeviceSharePlugin()]


def extras_context(snapshot, zones, policy, devices, rsv, cfg=None, **extras):
    """The CycleContext of the scenario's tables (plus any ``extras``,
    e.g. ``cpu_topologies``)."""
    from koordinator_tpu_torch.config import DEFAULT_CYCLE_CONFIG
    from koordinator_tpu_torch.scheduler.framework import CycleContext

    return CycleContext(
        snapshot=snapshot,
        cfg=cfg or DEFAULT_CYCLE_CONFIG,
        extras={"zones": zones, "numa_policy": policy, "devices": devices,
                "reservations": rsv, **extras},
    )


def extras_scenario(
    nodes: List[Dict],
    pods: List[Dict],
    seed: int = 0,
    node_bucket: int = 0,
    pod_bucket: int = 0,
    device=None,
) -> Tuple[ZoneBatch, np.ndarray, DeviceBatch, ReservationTable, List[Dict], List[Dict]]:
    """Deterministic extras tables for an existing node/pod list, plus
    the MUTATED node/pod lists that make every plugin leg load-bearing
    (callers must encode the snapshot from the returned lists):

    * every node gets 2 NUMA zones splitting its FULL allocatable vector
      (cpu, memory, pods, device axes — ``zone_fit_mask`` checks every
      requested axis), with a policy mix over the node index
      (none / best-effort / restricted / single-numa-node);
    * every 4th node carries 4 GPU minors (some partially used) and one
      RDMA NIC, and advertises the device resources in its allocatable;
    * every 8th pod requests one GPU card (every 32nd two cards, every
      64th also an RDMA share), so device count-fit and scoreNode have
      real work on both implementations;
    * one reservation per 16th node, matched to every 8th pod.

    The tables are on ``device``; ``policy`` is host numpy, as the
    reference's.  Returns ``(zones, policy, devices, rsv, nodes_out,
    pods_out)``.
    """
    rng = np.random.RandomState(seed)
    N = len(nodes)
    P = len(pods)
    node_bucket = node_bucket or pad_bucket(N)
    pod_bucket = pod_bucket or pad_bucket(P)

    # device-carrying nodes advertise the resources node-level (the
    # reference's device webhook patches Node status the same way)
    nodes_out: List[Dict] = []
    for i, nd in enumerate(nodes):
        nd = dict(nd)
        if i % 4 == 0:
            alloc = dict(nd["allocatable"])
            alloc["koordinator.sh/gpu-core"] = 400
            alloc["koordinator.sh/gpu-memory"] = 4 * 16 * Gi
            alloc["koordinator.sh/gpu-memory-ratio"] = 400
            alloc["koordinator.sh/rdma"] = 100
            nd["allocatable"] = alloc
        nodes_out.append(nd)

    # every 8th pod requests a GPU card; the koordlet-side webhook fills
    # memory from ratio, so ratio+core is the canonical request shape
    pods_out: List[Dict] = []
    for p, pod in enumerate(pods):
        pod = dict(pod)
        if p % 8 == 0:
            reqs = dict(pod.get("requests", {}))
            cards = 2 if p % 32 == 0 else 1
            reqs["koordinator.sh/gpu-core"] = 100 * cards
            reqs["koordinator.sh/gpu-memory-ratio"] = 100 * cards
            if p % 64 == 0:
                reqs["koordinator.sh/rdma"] = 50
            pod["requests"] = reqs
        pods_out.append(pod)

    zone_specs = []
    for i, nd in enumerate(nodes_out):
        full = res.resource_vector(nd["allocatable"])
        used_cpu = int(rng.randint(0, max(full[res.RESOURCE_INDEX[res.CPU]] // 4, 1)))
        # axis units (cpu milli, MiB) back through format_quantity so
        # encode_zones' resource_vector round-trips them exactly
        half0 = {
            name: res.format_quantity(int(full[res.RESOURCE_INDEX[name]]) // 2, name)
            for name in res.RESOURCE_AXIS
            if full[res.RESOURCE_INDEX[name]]
        }
        half1 = {
            name: res.format_quantity(
                int(full[res.RESOURCE_INDEX[name]])
                - int(full[res.RESOURCE_INDEX[name]]) // 2,
                name,
            )
            for name in res.RESOURCE_AXIS
            if full[res.RESOURCE_INDEX[name]]
        }
        zones = [
            {"allocatable": half0, "requested": {"cpu": f"{used_cpu}m"}},
            {"allocatable": half1, "requested": {}},
        ]
        zone_specs.append({"zones": zones})
    zbatch = encode_zones(zone_specs, node_bucket=node_bucket, device=device)
    policy = np.asarray(
        [i % 4 for i in range(N)] + [0] * (node_bucket - N), np.int32
    )

    dev_specs = []
    for i in range(N):
        devs = []
        if i % 4 == 0:
            for m in range(4):
                free_core = 100 if (i + m) % 3 else 40
                devs.append(
                    {
                        "type": "gpu",
                        "minor": m,
                        "total": {
                            "koordinator.sh/gpu-core": 100,
                            "koordinator.sh/gpu-memory": 16 * Gi,
                            "koordinator.sh/gpu-memory-ratio": 100,
                        },
                        "free": {
                            "koordinator.sh/gpu-core": free_core,
                            "koordinator.sh/gpu-memory": 16 * Gi * free_core // 100,
                            "koordinator.sh/gpu-memory-ratio": free_core,
                        },
                        "topology": {"numaNode": m // 2},
                    }
                )
            devs.append(
                {
                    "type": "rdma",
                    "minor": 0,
                    "total": {"koordinator.sh/rdma": 100},
                    "free": {"koordinator.sh/rdma": 100},
                    "topology": {"numaNode": 0},
                }
            )
        dev_specs.append({"devices": devs})
    dbatch = encode_devices(dev_specs, node_bucket=node_bucket, device=device)

    # reservations match pods by owner label selector (the reference's
    # MatchReservationOwners label path); tag every 8th pod round-robin
    node_names = [nd["name"] for nd in nodes_out]
    rsv_specs = reservation_specs(node_names)
    n_rsv = len(rsv_specs)
    for p, pod in enumerate(pods_out):
        if p % 8 == 0:
            labels = dict(pod.get("labels", {}))
            labels["rsv-owner"] = f"rsv-{(p // 8) % n_rsv}"
            pod["labels"] = labels
        if p % 16 == 0 and n_rsv > 1:
            # required reservation affinity (reference exact key): these
            # pods may only land on nodes holding a matched gold-labeled
            # reservation — the affinity filter leg is load-bearing
            anns = dict(pod.get("annotations", {}))
            anns["scheduling.koordinator.sh/reservation-affinity"] = {
                "reservationSelector": {"reservation-type": "gold"}
            }
            pod["annotations"] = anns
    rsv = encode_reservations(
        rsv_specs, pods_out, node_names, pod_bucket=pod_bucket, device=device
    )
    return zbatch, policy, dbatch, rsv, nodes_out, pods_out


def reservation_specs(node_names):
    """The scenario's reservation dicts (``encode_reservations`` rows): one
    on every 16th node, ``rsv-<k>``, 4 cpu and 8 Gi with 1 cpu and 2 Gi
    allocated, Aligned unless the node index is a multiple of 32, an order
    on every 48th node, owned by the pods labelled ``rsv-owner: rsv-<k>``,
    and labelled gold on even ``k``, general on odd."""
    specs = []
    for k, i in enumerate(range(0, len(node_names), 16)):
        specs.append(
            {
                "name": f"rsv-{k}",
                "node": node_names[i],
                "allocatable": {"cpu": "4000m", "memory": 8 * Gi},
                "allocated": {"cpu": "1000m", "memory": 2 * Gi},
                "allocate_policy": "Aligned" if i % 32 else "Default",
                "order": (k + 1) if i % 48 == 0 else 0,
                "owners": [{"label_selector": {"rsv-owner": f"rsv-{k}"}}],
                "labels": {
                    "reservation-type": "gold" if k % 2 == 0 else "general"
                },
            }
        )
    return specs


def extras_snapshot(seed: int = 0, pods: int = 10000, nodes: int = 2000,
                    tenants: int = 16, device=None):
    """The reference bench's extras configuration (``bench.py --config
    extras``, ``bench.py:1908-2009``): the quota_colocation lists, mutated
    by ``extras_scenario`` at seed 0, encoded once through the quota
    recipe, buckets equal to the counts.  Returns ``(snapshot, zones,
    policy, devices, rsv, node_list, pod_list)``."""
    from koordinator_tpu_torch.harness.generators import (
        encode_quota_lists,
        quota_colocation,
    )

    node_list, pod_list, gangs, quotas = quota_colocation(
        seed=seed, pods=pods, nodes=nodes, tenants=tenants
    )
    zones, policy, devices, rsv, node_list, pod_list = extras_scenario(
        node_list, pod_list, seed=0, node_bucket=nodes, pod_bucket=pods, device=device
    )
    snap, _ = encode_quota_lists(
        node_list, pod_list, gangs, quotas, node_bucket=nodes, pod_bucket=pods,
        device=device,
    )
    return snap, zones, policy, devices, rsv, node_list, pod_list


def plugin_extra_tensors(snapshot, zones, policy, devices, rsv, cfg=None):
    """Compose the real plugins into ``(extra_mask, extra_scores)``, the
    tensors ``FrameworkExtender.run_cycle`` feeds the cycle, on the
    snapshot's device.  The reference runs the composition as one jitted
    program; here each op is eager and chunked over pod rows."""
    from koordinator_tpu_torch.scheduler.framework import FrameworkExtender

    ctx = extras_context(snapshot, zones, policy, devices, rsv, cfg)
    mask, scores, _ = FrameworkExtender(plugins=extended_plugins()).extended_tensors(ctx)
    return mask, scores


def _section(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, np.int64)
    head = struct.pack("<I", len(name)) + name.encode()
    head += struct.pack("<I", arr.ndim)
    head += np.asarray(arr.shape, "<i8").tobytes()
    return head + arr.astype("<i8").tobytes()


def write_extras_file(
    path: str,
    zones: ZoneBatch,
    policy: np.ndarray,
    devices: DeviceBatch,
    rsv: ReservationTable,
    fit_weights,
) -> None:
    """Write the raw subsystem tables in the KEXT1 format above, the same
    bytes as the reference's ``write_extras_file`` for the same tables
    (``native/score_baseline.cpp`` reads either).  Takes tensors on any
    device or numpy arrays."""
    def host(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    sections = {
        "fit_weights": host(fit_weights),
        "zone_alloc": host(zones.allocatable),
        "zone_req": host(zones.requested),
        "zone_valid": host(zones.valid),
        "numa_policy": host(policy),
        "dev_total": host(devices.total),
        "dev_free": host(devices.free),
        "dev_type": host(devices.dev_type),
        "dev_valid": host(devices.valid),
        "dev_axis": np.asarray(DEV_AXIS),
        "rsv_node": host(rsv.node_index),
        "rsv_allocatable": host(rsv.allocatable),
        "rsv_allocated": host(rsv.allocated),
        "rsv_declared": host(rsv.declared),
        "rsv_policy": host(rsv.allocate_policy),
        "rsv_order": host(rsv.order),
        "rsv_unschedulable": host(rsv.unschedulable),
        "rsv_valid": host(rsv.valid),
        "rsv_matched": host(rsv.matched),
        "rsv_affinity_required": (
            host(rsv.affinity_required)
            if rsv.affinity_required is not None
            else np.zeros(rsv.matched.shape[0], bool)
        ),
    }
    with open(path, "wb") as f:
        f.write(b"KEXT1\n")
        for name, arr in sections.items():
            f.write(_section(name, arr))
