"""Parity of the port's extended-plugin cycle with the JAX package, exactly.

The same seeded numpy inputs go through the JAX package and the port on
the CPU:

* the encoders (``encode_zones``, ``encode_devices``,
  ``encode_reservations``), field for field;
* every op of ``ops/numa.py``, ``ops/reservation.py`` and
  ``ops/deviceshare.py`` on fuzzed tables: MostAllocated on and off, a node
  holding two reservations with equal scores (the argmax tie) and equal
  order labels, partition tables, the host allocators;
* each op chunked over pod rows (a tiny ``greedy.CHUNK_BYTES``) against one
  unchunked call;
* each plugin's mask and score, the Reserve and PreBind results, and
  ``FrameworkExtender.run_cycle``/``pre_bind_patches``/``run_score_only``
  against the reference's, on the extras scenario with cpusets, and the
  reference's own framework cases;
* ``plugin_extra_tensors`` and ``write_extras_file`` byte for byte, and the
  anchors ``chip_smoke.py`` checks on the card, recomputed from the JAX
  package;
* the routes of ``FrameworkExtender.run_cycle`` on a CUDA snapshot (stub
  kernel rungs), and one read-back a plugin per hook pass.

Every compared value is an integer, a bool or a host object: tolerance 0.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu.config import DEFAULT_CYCLE_CONFIG as J_CFG
from koordinator_tpu.harness import extras_scenario as jx
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.model import device as jdevice
from koordinator_tpu.model import reservation as jrsv
from koordinator_tpu.model import topology as jtopo
from koordinator_tpu.model.snapshot import encode_snapshot as j_encode_snapshot
from koordinator_tpu.ops import deviceshare as jds
from koordinator_tpu.ops import numa as jnuma
from koordinator_tpu.ops import reservation as jres
from koordinator_tpu.scheduler import framework as jfw
from koordinator_tpu.scheduler import plugins as jpl
from koordinator_tpu.solver import greedy_assign as j_greedy_assign

from koordinator_tpu_torch import solver as tsolver
from koordinator_tpu_torch.config import DEFAULT_CYCLE_CONFIG as T_CFG
from koordinator_tpu_torch.harness import extras_scenario as tx
from koordinator_tpu_torch.harness import generators as tgen
from koordinator_tpu_torch.harness.anchor import (
    ANCHOR_RECIPE,
    EXTRAS_ANCHOR_SHA256,
    EXTRAS_TENSORS_SHA256,
    PREEMPT_ANCHOR_SHA256,
    cycle_digest,
    extras_digest,
)
from koordinator_tpu_torch.harness.preempt import (
    preempt_digest,
    preempt_doc,
    preemption_inventory,
)
from koordinator_tpu_torch.model import device as tdevice
from koordinator_tpu_torch.model import reservation as trsv
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model import topology as ttopo
from koordinator_tpu_torch.model.snapshot import ClusterSnapshot, QoSClass
from koordinator_tpu_torch.model.snapshot import encode_snapshot as t_encode_snapshot
from koordinator_tpu_torch.ops import deviceshare as tds
from koordinator_tpu_torch.ops import numa as tnuma
from koordinator_tpu_torch.ops import reservation as tres
from koordinator_tpu_torch.scheduler import framework as tfw
from koordinator_tpu_torch.scheduler import plugins as tpl
from koordinator_tpu_torch.solver import greedy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 2, 3]
R = res.NUM_RESOURCES
Gi = 1 << 30


def host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def same(ref, port, what=""):
    """Equal values, shape and dtype (tuples compared elementwise)."""
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(ref) == len(port), what
        for i, (a, b) in enumerate(zip(ref, port)):
            same(a, b, f"{what}[{i}]")
        return
    if ref is None:
        assert port is None, what
        return
    a, b = host(ref), host(port)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def same_table(ref, port, fields):
    for f in fields:
        same(getattr(ref, f), getattr(port, f), f)


def jt(a):
    return jnp.asarray(a)


def tt(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------


def zone_nodes(seed, n=7):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n):
        zones = []
        for _ in range(int(rng.randint(0, 4))):
            zones.append({
                "allocatable": {"cpu": f"{int(rng.randint(0, 16000))}m",
                                "memory": int(rng.randint(0, 32)) * Gi,
                                "pods": int(rng.randint(0, 60))},
                "requested": {"cpu": f"{int(rng.randint(0, 9000))}m",
                              "memory": int(rng.randint(0, 16)) * Gi},
            })
        nd = {"zones": zones}
        if i % 3 == 1:
            nd["cpu_amplification"] = float(rng.choice([1.0, 1.5, 2.25]))
        nodes.append(nd)
    return nodes


def pod_rows(seed, p=11, devices=False):
    """i64[p, R] pod requests on the snapshot axis; some over-sized."""
    rng = np.random.RandomState(seed + 100)
    out = np.zeros((p, R), np.int64)
    for i in range(p):
        rl = {"cpu": f"{int(rng.choice([0, 500, 2000, 6000, 20000]))}m",
              "memory": int(rng.choice([0, 1, 4, 12, 40])) * Gi,
              "pods": int(rng.randint(0, 2))}
        if devices:
            kind = i % 5
            if kind == 1:
                rl[res.GPU_CORE] = 100
                rl[res.GPU_MEMORY_RATIO] = 100
            elif kind == 2:
                rl[res.GPU_CORE] = 200
                rl[res.GPU_MEMORY_RATIO] = 200
                rl[res.RDMA] = int(rng.choice([50, 100]))
            elif kind == 3:
                rl[res.GPU_MEMORY] = int(rng.choice([4, 8, 20])) * Gi
                rl[res.GPU_CORE] = 50
            elif kind == 4:
                rl[res.FPGA] = 1
        out[i] = res.resource_vector(rl)
    return out


def device_nodes(seed, n=6):
    rng = np.random.RandomState(seed + 200)
    nodes = []
    for i in range(n):
        devs = []
        if i % 3 != 2:
            mem = int(rng.choice([16, 32]))
            for m in range(int(rng.randint(1, 5))):
                free = int(rng.choice([0, 40, 100]))
                devs.append({
                    "type": "gpu", "minor": m,
                    "total": {res.GPU_CORE: 100, res.GPU_MEMORY: mem * Gi,
                              res.GPU_MEMORY_RATIO: 100},
                    "free": {res.GPU_CORE: free, res.GPU_MEMORY: mem * Gi * free // 100,
                             res.GPU_MEMORY_RATIO: free},
                    "health": bool(rng.uniform() > 0.15),
                    "topology": {"numaNode": m // 2},
                })
            devs.append({"type": "rdma", "minor": 0, "total": {res.RDMA: 100},
                         "free": {res.RDMA: int(rng.choice([20, 100]))},
                         "topology": {"numaNode": int(rng.randint(0, 2))}})
        if i % 2 == 0:
            devs.append({"type": "fpga", "minor": 0, "total": {res.FPGA: 1}})
        nodes.append({"devices": devs})
    return nodes


AFF = trsv.RESERVATION_AFFINITY_ANNOTATION


def reservation_inputs(seed, n_nodes=5, p=9):
    """Reservations (two on node-1 with equal tables and equal order
    labels, one unbound, one dropped allocate-once) and pods (labels,
    owner refs, the three affinity forms, a malformed affinity)."""
    rng = np.random.RandomState(seed + 300)
    names = [f"node-{i}" for i in range(n_nodes)]
    twin = {"allocatable": {"cpu": "4", "memory": "8Gi"},
            "allocated": {"cpu": "1", "memory": "2Gi"},
            "owners": [{"label_selector": {"app": "web"}}], "order": 3,
            "labels": {"tier": "gold"}}
    rsvs = [
        {"name": "twin-a", "node": "node-1", **twin},
        {"name": "twin-b", "node": "node-1", **twin},
    ]
    policies = ["Default", "Aligned", "Restricted"]
    for k in range(int(rng.randint(3, 7))):
        rsvs.append({
            "name": f"rsv-{k}", "uid": f"uid-{k}" if k % 2 else "",
            "node": names[int(rng.randint(0, n_nodes))] if k != 2 else "nowhere",
            "allocatable": {"cpu": f"{int(rng.choice([1000, 4000, 8000]))}m",
                            "memory": int(rng.choice([0, 4, 16])) * Gi},
            "allocated": {"cpu": f"{int(rng.choice([0, 500, 2000]))}m"},
            "allocate_policy": policies[k % 3],
            "order": int(rng.choice([0, 0, 2, 5])),
            "unschedulable": k == 4,
            "owners": [{"label_selector": {"app": str(rng.choice(["web", "db"]))}}],
            "labels": {"tier": str(rng.choice(["gold", "silver"]))},
        })
    rsvs.append({"name": "used-once", "node": "node-0", "allocate_once": True,
                 "assigned_pods": 1, "allocatable": {"cpu": "2"},
                 "owners": [{"label_selector": {"app": "web"}}]})
    pods = []
    for i in range(p):
        pod = {"name": f"pod-{i}", "labels": {"app": "web" if i % 3 else "db"}}
        if i % 4 == 1:
            pod["annotations"] = {AFF: {"reservationSelector": {"tier": "gold"}}}
        elif i % 4 == 2:
            pod["annotations"] = {AFF: json.dumps({
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "reservationSelectorTerms": [{"matchExpressions": [
                        {"key": "tier", "operator": "In", "values": ["silver"]}]}]}})}
        elif i == 7:
            pod["annotations"] = {AFF: "{not json"}
        pods.append(pod)
    return rsvs, pods, names


def rsv_pair(seed, p=9, n_nodes=5):
    rsvs, pods, names = reservation_inputs(seed, n_nodes, p)
    return (jrsv.encode_reservations(rsvs, pods, names, pod_bucket=p),
            trsv.encode_reservations(rsvs, pods, names, pod_bucket=p, device="cpu"))


RSV_FIELDS = ("node_index", "allocatable", "allocated", "declared", "allocate_policy",
              "order", "unschedulable", "valid", "matched", "affinity_required",
              "names", "uids")
ZONE_FIELDS = ("allocatable", "requested", "valid", "cpu_amplification")
DEVICE_FIELDS = ("total", "free", "dev_type", "valid", "numa", "minor")


def weights_pair(seed):
    rng = np.random.RandomState(seed + 400)
    w = np.zeros(R, np.int64)
    w[res.RESOURCE_INDEX[res.CPU]] = int(rng.randint(0, 4))
    w[res.RESOURCE_INDEX[res.MEMORY]] = int(rng.randint(1, 4))
    return jt(w), tt(w)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_zones(seed):
    nodes = zone_nodes(seed)
    same_table(jtopo.encode_zones(nodes, node_bucket=8),
               ttopo.encode_zones(nodes, node_bucket=8, device="cpu"), ZONE_FIELDS)
    same_table(jtopo.encode_zones(nodes, zone_bucket=4),
               ttopo.encode_zones(nodes, zone_bucket=4, device="cpu"), ZONE_FIELDS)


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_devices(seed):
    nodes = device_nodes(seed)
    same_table(jdevice.encode_devices(nodes, node_bucket=8),
               tdevice.encode_devices(nodes, node_bucket=8, device="cpu"), DEVICE_FIELDS)
    same_table(jdevice.encode_devices(nodes, minor_bucket=8),
               tdevice.encode_devices(nodes, minor_bucket=8, device="cpu"), DEVICE_FIELDS)


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_reservations(seed):
    j, t = rsv_pair(seed)
    same_table(j, t, RSV_FIELDS)
    same(j.remaining, t.remaining)
    assert "used-once" not in t.names and t.capacity == j.capacity


def test_encoders_default_to_cuda():
    if torch.cuda.is_available():
        return
    for encode, arg in ((ttopo.encode_zones, zone_nodes(0)),
                        (tdevice.encode_devices, device_nodes(0))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            encode(arg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trsv.encode_reservations(*reservation_inputs(0))


@pytest.mark.parametrize("case", [
    ({"name": "p", "labels": {"app": "web"}}, [{"label_selector": {"app": "web"}}]),
    ({"name": "p", "labels": {"app": "web"}}, [{"label_selector": {"app": "db"}}]),
    ({"name": "p", "namespace": "ns1"}, [{"object": {"name": "p", "namespace": "ns1"}}]),
    ({"name": "p", "namespace": "ns1"}, [{"object": {"name": "p", "namespace": "ns2"}}]),
    ({"name": "p", "owner_ref": {"name": "rs-1"}}, [{"controller": {"name": "rs-1"}}]),
    ({"name": "p", "owner_ref": {"name": "rs-1"}}, [{"controller": {"name": "rs-2"}}]),
    ({"name": "p", "labels": {"a": "1"}},
     [{"label_selector": {"b": "2"}}, {"label_selector": {"a": "1"}}]),
])
def test_match_owners(case):
    pod, owners = case
    assert trsv.match_owners(pod, owners) == jrsv.match_owners(pod, owners)


def test_topology_model():
    for args in ((1, 1, 4, 2), (2, 2, 4, 2), (2, 1, 3, 1)):
        j, t = jtopo.CPUTopology.build(*args), ttopo.CPUTopology.build(*args)
        assert {k: tuple(vars(v).values()) for k, v in j.details.items()} == {
            k: tuple(vars(v).values()) for k, v in t.details.items()}
        for f in ("cpus_per_core", "cpus_per_node", "cpus_per_socket"):
            assert getattr(j, f)() == getattr(t, f)()
    for value, ratio in ((1000, 10_000), (1000, 15_000), (1, 15_000), (1000, 5_000)):
        assert ttopo.amplify(value, ratio) == jtopo.amplify(value, ratio)


# ---------------------------------------------------------------------------
# ops/numa.py
# ---------------------------------------------------------------------------


def numa_inputs(seed):
    nodes = zone_nodes(seed)
    zb_j = jtopo.encode_zones(nodes, node_bucket=8)
    zb_t = ttopo.encode_zones(nodes, node_bucket=8, device="cpu")
    pods = pod_rows(seed)
    policy = np.random.RandomState(seed).randint(0, 4, size=8).astype(np.int32)
    return zb_j, zb_t, pods, policy


@pytest.mark.parametrize("seed", SEEDS)
def test_zone_fit_and_admit(seed):
    zj, zt, pods, policy = numa_inputs(seed)
    same(jnuma.zone_fit_mask(jt(pods), zj.allocatable, zj.requested, zj.valid),
         tnuma.zone_fit_mask(tt(pods), zt.allocatable, zt.requested, zt.valid))
    same(jnuma.numa_admit_mask(jt(pods), zj.allocatable, zj.requested, zj.valid, jt(policy)),
         tnuma.numa_admit_mask(tt(pods), zt.allocatable, zt.requested, zt.valid, tt(policy)))


@pytest.mark.parametrize("most_allocated", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_numa_zone_scores(seed, most_allocated):
    zj, zt, pods, _ = numa_inputs(seed)
    wj, wt = weights_pair(seed)
    same(jnuma.numa_zone_scores(jt(pods), zj.allocatable, zj.requested, zj.valid, wj,
                                most_allocated=most_allocated),
         tnuma.numa_zone_scores(tt(pods), zt.allocatable, zt.requested, zt.valid, wt,
                                most_allocated=most_allocated))


@pytest.mark.parametrize("most_allocated", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_amplified_cpu_scores(seed, most_allocated):
    rng = np.random.RandomState(seed + 500)
    N = 6
    alloc = np.zeros((N, R), np.int64)
    alloc[:, 0] = rng.randint(8000, 64000, N)
    alloc[:, 1] = rng.randint(1024, 65536, N)
    req = (alloc * rng.uniform(0, 0.9, (N, R))).astype(np.int64)
    held = (req[:, 0] * rng.uniform(0, 1, N)).astype(np.int64)
    ratio = rng.choice([5_000, 10_000, 15_000, 22_500], N).astype(np.int32)
    pods = pod_rows(seed)
    wj, wt = weights_pair(seed)
    same(jnuma.amplify_milli(jt(held), jt(ratio)), tnuma.amplify_milli(tt(held), tt(ratio)))
    same(jnuma.amplified_cpu_scores(jt(pods), jt(req), jt(alloc), jt(held), jt(ratio), wj,
                                    most_allocated=most_allocated),
         tnuma.amplified_cpu_scores(tt(pods), tt(req), tt(alloc), tt(held), tt(ratio), wt,
                                    most_allocated=most_allocated))


# ---------------------------------------------------------------------------
# ops/reservation.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_reservation_ops(seed):
    j, t = rsv_pair(seed)
    pods = pod_rows(seed, p=9)
    rng = np.random.RandomState(seed + 600)
    alloc = rng.randint(0, 64000, (5, R)).astype(np.int64)
    req = (alloc * rng.uniform(0, 1, (5, R))).astype(np.int64)
    same(jres.restored_node_free(jt(alloc), jt(req), j),
         tres.restored_node_free(tt(alloc), tt(req), t))
    same(jres.reservation_fit_mask(jt(pods), j), tres.reservation_fit_mask(tt(pods), t))
    same(jres.reservation_scores(jt(pods), j), tres.reservation_scores(tt(pods), t))
    same(jres.reservation_affinity_mask(j, 5), tres.reservation_affinity_mask(t, 5))
    same(jres.nominate_reservations(jt(pods), j, 5),
         tres.nominate_reservations(tt(pods), t, 5))


@pytest.mark.parametrize("orders", [(3, 3), (0, 0), (5, 3)])
def test_nomination_tie_picks_the_lowest_index(orders):
    """Two reservations on node-1 with the same tables score equally for
    every matched pod: both packages' argmax takes the first (index 1),
    and among equal order labels the first one's node is preferred."""
    twin = {"allocatable": {"cpu": "4", "memory": "8Gi"},
            "allocated": {"cpu": "1", "memory": "2Gi"},
            "owners": [{"label_selector": {"app": "web"}}]}
    rsvs = [{"name": "other", "node": "node-2", "order": 4, **twin},
            {"name": "twin-a", "node": "node-1", "order": orders[0], **twin},
            {"name": "twin-b", "node": "node-1", "order": orders[1], **twin}]
    pods = [{"name": f"p{i}", "labels": {"app": "web" if i else "db"}} for i in range(3)]
    names = ["node-0", "node-1", "node-2"]
    j = jrsv.encode_reservations(rsvs, pods, names, pod_bucket=3)
    t = trsv.encode_reservations(rsvs, pods, names, pod_bucket=3, device="cpu")
    req = np.stack([res.resource_vector({"cpu": "1", "memory": "1Gi"})] * 3).astype(np.int64)
    node_scores, nominated = tres.nominate_reservations(tt(req), t, 3)
    same(jres.nominate_reservations(jt(req), j, 3), (node_scores, nominated))
    assert nominated[1:, 1].tolist() == [1, 1] and nominated[1:, 2].tolist() == [0, 0]
    assert (nominated[0] == -1).all()
    preferred = {(3, 3): 1, (0, 0): 2, (5, 3): 1}[orders]
    assert node_scores[1:, preferred].tolist() == [100, 100]


def test_reservation_affinity_absent_is_none():
    j, t = rsv_pair(1)
    import dataclasses

    assert tres.reservation_affinity_mask(
        dataclasses.replace(t, affinity_required=None), 5) is None
    assert jres.reservation_affinity_mask(
        dataclasses.replace(j, affinity_required=None), 5) is None


# ---------------------------------------------------------------------------
# ops/deviceshare.py
# ---------------------------------------------------------------------------


def device_pair(seed, n=6):
    nodes = device_nodes(seed, n)
    return (jdevice.encode_devices(nodes, node_bucket=8),
            tdevice.encode_devices(nodes, node_bucket=8, device="cpu"), nodes)


@pytest.mark.parametrize("seed", SEEDS)
def test_device_tensor_ops(seed):
    dj, dt, _ = device_pair(seed)
    pods = pod_rows(seed, p=13, devices=True)
    same(jds.pod_device_requests(jt(pods)), tds.pod_device_requests(tt(pods)))
    cj, ct = jds.gpu_card_total_memory(dj), tds.gpu_card_total_memory(dt)
    same(cj, ct)
    nj = jds.normalize_gpu_requests(jds.pod_device_requests(jt(pods)), cj)
    nt = tds.normalize_gpu_requests(tds.pod_device_requests(tt(pods)), ct)
    same(nj, nt)
    same(jds.split_per_card(nj), tds.split_per_card(nt))
    same(jds.device_fit_mask(jt(pods), dj), tds.device_fit_mask(tt(pods), dt))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("most_allocated", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_deviceshare_scores(seed, most_allocated, weighted):
    dj, dt, _ = device_pair(seed)
    pods = pod_rows(seed, p=13, devices=True)
    w = np.array([3, 1, 2, 5, 1], np.int64) if weighted else None
    same(jds.deviceshare_scores(jt(pods), dj, None if w is None else jt(w),
                                most_allocated=most_allocated),
         tds.deviceshare_scores(tt(pods), dt, None if w is None else tt(w),
                                most_allocated=most_allocated))


PARTITIONS = {0: {2: [[0, 1], [2, 3]], 4: [[0, 1, 2, 3]]},
              1: {2: [[1, 2]]}, 3: {2: [[0, 3]], 1: [[2]]}}


@pytest.mark.parametrize("seed", SEEDS)
def test_partition_fit_mask(seed):
    dj, dt, _ = device_pair(seed)
    pods = pod_rows(seed, p=13, devices=True)
    same(jds.partition_fit_mask(jt(pods), dj, PARTITIONS),
         tds.partition_fit_mask(tt(pods), dt, PARTITIONS))


@pytest.mark.parametrize("seed", SEEDS)
def test_minor_dicts_and_host_allocators(seed):
    dj, dt, _ = device_pair(seed)
    for n in range(6):
        minors = jds.minor_dicts_from_batch(dj, n)
        assert tds.minor_dicts_from_batch(dt, n) == minors
        gpus = [m for m in minors if m["type"] == "gpu"]
        for per_card, wanted in (({res.GPU_CORE: 40}, 1), ({res.GPU_CORE: 100}, 2),
                                 ({res.GPU_CORE: 30, res.GPU_MEMORY_RATIO: 30}, 1)):
            for kw in ({}, {"most_allocated": True}, {"preferred": {1}},
                       {"required": {0, 2, 3}}):
                outs = []
                for mod in (jds, tds):
                    try:
                        outs.append(mod.allocate_minors(gpus, per_card, wanted, **kw))
                    except ValueError as exc:
                        outs.append(str(exc))
                    try:
                        outs.append(mod.allocate_partitioned(
                            gpus, per_card, wanted, PARTITIONS.get(n, {}), **kw))
                    except ValueError as exc:
                        outs.append(str(exc))
                assert outs[:2] == outs[2:]
        for by_type, wanted in (({0: {res.GPU_CORE: 50}, 1: {res.RDMA: 20}}, {0: 1, 1: 1}),
                                ({0: {res.GPU_CORE: 100}, 2: {res.FPGA: 1}}, {0: 2, 2: 1})):
            outs = []
            for mod in (jds, tds):
                try:
                    outs.append(mod.allocate_joint(minors, by_type, wanted,
                                                   partitions=PARTITIONS.get(n)))
                except ValueError as exc:
                    outs.append(str(exc))
            assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# chunking: a tiny CHUNK_BYTES against one unchunked call
# ---------------------------------------------------------------------------


def chunk_cases():
    zj, zt, pods, policy = numa_inputs(2)
    _, rt = rsv_pair(2)
    _, dt, _ = device_pair(2)
    dpods = tt(pod_rows(2, p=13, devices=True))
    rpods = tt(pod_rows(2, p=9))
    w = weights_pair(2)[1]
    held = torch.tensor([1000, 0, 3000, 500, 0, 7000, 0, 0])
    ratio = torch.tensor([15000, 10000, 22500, 10000, 10000, 12000, 10000, 10000],
                         dtype=torch.int32)
    alloc = zt.allocatable.sum(1)
    return {
        "zone_fit_mask": lambda: tnuma.zone_fit_mask(
            tt(pods), zt.allocatable, zt.requested, zt.valid),
        "numa_admit_mask": lambda: tnuma.numa_admit_mask(
            tt(pods), zt.allocatable, zt.requested, zt.valid, tt(policy)),
        "numa_zone_scores": lambda: tnuma.numa_zone_scores(
            tt(pods), zt.allocatable, zt.requested, zt.valid, w),
        "amplified_cpu_scores": lambda: tnuma.amplified_cpu_scores(
            tt(pods), zt.requested.sum(1), alloc, held, ratio, w, most_allocated=True),
        "restored_node_free": lambda: tres.restored_node_free(
            alloc[:5], zt.requested.sum(1)[:5], rt),
        "nominate_reservations": lambda: tres.nominate_reservations(rpods, rt, 5),
        "device_fit_mask": lambda: tds.device_fit_mask(dpods, dt),
        "deviceshare_scores": lambda: tds.deviceshare_scores(dpods, dt, most_allocated=True),
    }


@pytest.mark.parametrize("op", sorted(chunk_cases()))
def test_chunked_equals_unchunked(op, monkeypatch):
    whole = chunk_cases()[op]()
    monkeypatch.setattr(greedy, "CHUNK_BYTES", 1)  # one pod row a chunk
    same(whole, chunk_cases()[op]())


def test_by_rows_splits_at_the_budget(monkeypatch):
    seen = []

    def fn(rows):
        seen.append((rows.start, rows.stop))
        return torch.arange(rows.start, rows.stop), torch.ones(rows.stop - rows.start, 2)

    monkeypatch.setattr(greedy, "CHUNK_BYTES", 24)
    a, b = greedy.by_rows(fn, 7, 8)
    assert seen == [(0, 3), (3, 6), (6, 7)]
    assert a.tolist() == list(range(7)) and b.shape == (7, 2)


# ---------------------------------------------------------------------------
# the extras scenario, the plugins and the framework
# ---------------------------------------------------------------------------

SCENARIO = {"seed": 13, "pods": 256, "nodes": 64}


def scenario_pair(pods=256, nodes=64, seed=13):
    """The reference's native-parity scenario (loadaware_joint, seed 13)
    through both packages: (ref snapshot, ref tables, port snapshot, port
    tables, node list, pod list)."""
    jn, jp, jg, _ = jgen.loadaware_joint(seed=seed, pods=pods, nodes=nodes)
    z, pol, d, r, jn, jp = jx.extras_scenario(jn, jp, seed=seed, node_bucket=nodes,
                                              pod_bucket=pods)
    jsnap = j_encode_snapshot(jn, jp, jg, [], node_bucket=nodes, pod_bucket=pods)
    tn, tp, tg, _ = tgen.loadaware_joint(seed=seed, pods=pods, nodes=nodes)
    z2, pol2, d2, r2, tn, tp = tx.extras_scenario(tn, tp, seed=seed, node_bucket=nodes,
                                                  pod_bucket=pods, device="cpu")
    assert (tn, tp) == (jn, jp)
    tsnap = t_encode_snapshot(tn, tp, tg, [], node_bucket=nodes, pod_bucket=pods,
                              device="cpu")
    return jsnap, (z, pol, d, r), tsnap, (z2, pol2, d2, r2), tn, tp


@pytest.fixture(scope="module")
def scenario():
    return scenario_pair()


def test_extras_scenario_tables(scenario):
    _, (z, pol, d, r), _, (z2, pol2, d2, r2), _, _ = scenario
    same_table(z, z2, ZONE_FIELDS)
    same(pol, pol2)
    same_table(d, d2, DEVICE_FIELDS)
    same_table(r, r2, RSV_FIELDS)


def test_plugin_extra_tensors(scenario):
    jsnap, jtab, tsnap, ttab, _, _ = scenario
    jm, js = jx.plugin_extra_tensors(jsnap, *jtab)
    tm, ts = tx.plugin_extra_tensors(tsnap, *ttab)
    same((jm, js), (tm, ts))
    # every leg is load-bearing: pods filtered and scored, GPU requests,
    # pod 0's required gold affinity admits only its reservation's node
    assert not host(tm).all() and host(ts).max() > 0
    assert host(tds.pod_device_requests(tsnap.pods.requests)).max() > 0
    assert host(tm)[0].sum() == 1


def test_write_extras_file_bytes(scenario, tmp_path):
    _, jtab, _, ttab, _, _ = scenario
    w = np.asarray(J_CFG.fit_weights_arr())
    jx.write_extras_file(str(tmp_path / "j.bin"), *jtab, w)
    tx.write_extras_file(str(tmp_path / "t.bin"), *ttab, T_CFG.fit_weights_arr())
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()


def _plugins(mod, most_allocated=False):
    return [mod.NodeNUMAResourcePlugin(most_allocated=most_allocated),
            mod.ReservationPlugin(), mod.DeviceSharePlugin(most_allocated=most_allocated)]


def _context(fw, snap, tables, cpu_topologies=None, pol=None):
    z, policy, d, r = tables
    extras = {"zones": z, "numa_policy": policy if pol is None else pol,
              "devices": d, "reservations": r}
    if cpu_topologies is not None:
        extras["cpu_topologies"] = cpu_topologies
    return fw.CycleContext(snapshot=snap, extras=extras)


@pytest.mark.parametrize("most_allocated", [False, True])
@pytest.mark.parametrize("index", [0, 1, 2])
def test_each_plugin_mask_and_score(scenario, index, most_allocated):
    jsnap, jtab, tsnap, ttab, _, _ = scenario
    jp = _plugins(jpl, most_allocated)[index]
    tp = _plugins(tpl, most_allocated)[index]
    jctx = _context(jfw, jsnap, jtab, pol=jnp.asarray(jtab[1]))
    tctx = _context(tfw, tsnap, ttab)
    same(jp.filter_mask(jctx), tp.filter_mask(tctx))
    same(jp.score(jctx), tp.score(tctx))
    same(jctx.state.get("nominated_reservations"), tctx.state.get("nominated_reservations"))


def with_lsr(snap_j, snap_t, every=5):
    """Both snapshots with QoS LSR on every ``every``-th pod, so NUMA
    Reserve binds cpusets."""
    import dataclasses

    qos = host(snap_t.pods.qos).copy()
    qos[::every] = int(QoSClass.LSR)
    return (dataclasses.replace(snap_j, pods=dataclasses.replace(snap_j.pods, qos=jnp.asarray(qos))),
            dataclasses.replace(snap_t, pods=dataclasses.replace(snap_t.pods, qos=tt(qos))))


def topologies(mod, nodes):
    """One CPUTopology per node, sized by its cpu (2 sockets x 1 NUMA node)."""
    out = {}
    for i, nd in enumerate(nodes):
        cores = res.parse_quantity(nd["allocatable"]["cpu"], res.CPU) // 1000
        out[i] = mod.CPUTopology.build(2, 1, max(cores // 4, 1), 2)
    return out


def run_framework(fw, mod, topo_mod, snap, tables, nodes, pol=None):
    fx = fw.FrameworkExtender(_plugins(mod))
    failures = []
    fx.register_error_handler(lambda ctx, p, exc: failures.append((p, str(exc))) or True)
    ctx = _context(fw, snap, tables, topologies(topo_mod, nodes), pol=pol)
    result = fx.run_cycle(ctx)
    patches = fx.pre_bind_patches(ctx, result)
    return result, ctx, patches, failures


def test_framework_run_cycle_and_hooks(scenario):
    jsnap, jtab, tsnap, ttab, nodes, _ = scenario
    jsnap, tsnap = with_lsr(jsnap, tsnap)
    jr, jctx, jpatch, jfail = run_framework(jfw, jpl, jtopo, jsnap, jtab, nodes,
                                            pol=jnp.asarray(jtab[1]))
    tr, tctx, tpatch, tfail = run_framework(tfw, tpl, ttopo, tsnap, ttab, nodes)
    for f in ("assignment", "status", "node_requested", "node_estimated", "quota_used"):
        same(getattr(jr, f), getattr(tr, f), f)
    assert tpatch == jpatch and tfail == jfail
    for key in ("cpuset_allocations", "device_allocations"):
        assert tctx.state.get(key) == jctx.state.get(key), key
        assert tctx.state.get(key), key  # the leg really allocated
    for key in ("device_minors", "available_cpus"):
        assert tctx.extras.get(key) == jctx.extras.get(key), key
    kinds = {k for p in tpatch.values() for k in p["annotations"]}
    assert kinds == {"scheduling.koordinator.sh/resource-status",
                     "scheduling.koordinator.sh/reservation-allocated",
                     "scheduling.koordinator.sh/device-allocated"}


def test_run_score_only(scenario):
    jsnap, jtab, tsnap, ttab, _, _ = scenario
    js, jf, jper = jfw.FrameworkExtender(_plugins(jpl)).run_score_only(
        _context(jfw, jsnap, jtab, pol=jnp.asarray(jtab[1])))
    ts, tf, tper = tfw.FrameworkExtender(_plugins(tpl)).run_score_only(
        _context(tfw, tsnap, ttab))
    same((js, jf), (ts, tf))
    assert list(jper) == list(tper)
    for name in jper:
        same(jper[name], tper[name], name)


def test_hooks_read_back_once_a_cycle(scenario, monkeypatch):
    """One read-back a plugin before the Reserve hooks, however many pods
    were placed; the PreBind hooks of the same result read nothing more,
    those of a result the framework did not reserve read back once; no
    hook reads on its own."""
    import dataclasses

    _, _, tsnap, ttab, nodes, _ = scenario
    calls = []
    for cls in (tpl.NodeNUMAResourcePlugin, tpl.ReservationPlugin, tpl.DeviceSharePlugin):
        real = cls.read_back

        def counted(self, ctx, pods, nodes_, real=real, name=cls.name):
            calls.append((name, len(pods)))
            return real(self, ctx, pods, nodes_)

        monkeypatch.setattr(cls, "read_back", counted)
    _, tsnap_lsr = with_lsr(tsnap, tsnap)
    fx = tfw.FrameworkExtender(_plugins(tpl))
    fx.register_error_handler(lambda ctx, p, exc: True)
    ctx = _context(tfw, tsnap_lsr, ttab, topologies(ttopo, nodes))
    result = fx.run_cycle(ctx)
    patches = fx.pre_bind_patches(ctx, result)
    placed = int((result.assignment >= 0).sum())
    assert placed > 100 and patches
    names = ["NodeNUMAResource", "Reservation", "DeviceShare"]
    assert calls == [(n, placed) for n in names]
    again = fx.pre_bind_patches(ctx, dataclasses.replace(result))
    assert again == patches and [n for n, _ in calls[3:]] == names


def post_filter(fw, snap, result, nodes, pods):
    """``fw``'s PostFilter over every pod ``result`` left unplaced, on the
    inventory of ``result``'s placements."""
    ctx = fw.CycleContext(snapshot=snap)
    ctx.extras["preemption"] = preemption_inventory(snap, result.assignment,
                                                    result.quota_used, nodes, pods)
    return ctx, fw.FrameworkExtender().post_filter_preempt(ctx, result)


def test_post_filter_preempt_matches_the_reference(scenario):
    """Both packages' PostFilter on the extras scenario's cycle (the
    plugins' extras, the hooks run) propose the same victims for the same
    pods: node, victim names and PDB violations."""
    jsnap, jtab, tsnap, ttab, nodes, pods = scenario
    jr, *_ = run_framework(jfw, jpl, jtopo, jsnap, jtab, nodes, pol=jnp.asarray(jtab[1]))
    tr, *_ = run_framework(tfw, tpl, ttopo, tsnap, ttab, nodes)
    same(jr.assignment, tr.assignment)
    jctx, want = post_filter(jfw, jsnap, jr, nodes, pods)
    tctx, got = post_filter(tfw, tsnap, tr, nodes, pods)
    assert jctx.extras["preemption"] == tctx.extras["preemption"]
    assert preempt_doc(got) == preempt_doc(want)
    # the leg is load-bearing: unplaced pods, and some of them find victims
    assert tctx.extras["preemption"]["pending_pods"] and got
    assert all(nv.victims for nv in got.values())


# ---------------------------------------------------------------------------
# the reference's framework cases, through both packages
# ---------------------------------------------------------------------------


def small_lists(n_nodes=2, n_pods=3, cpu="2", node_cpu="16"):
    nodes = [{"name": f"node-{i}",
              "allocatable": {"cpu": node_cpu, "memory": "32Gi", "pods": "110"},
              "usage": {"cpu": "1", "memory": "2Gi"}} for i in range(n_nodes)]
    pods = [{"name": f"pod-{i}", "requests": {"cpu": cpu, "memory": "4Gi"},
             "qos": "LSR", "priority": 9000 + i} for i in range(n_pods)]
    return nodes, pods


def both(**kw):
    nodes, pods = small_lists(**kw)
    return (j_encode_snapshot(nodes, pods), t_encode_snapshot(nodes, pods, device="cpu"))


class Veto:
    """A plugin vetoing node 0 (mask) and preferring node 1 (score), for
    either package."""

    def __init__(self, fw, xp, veto=True, prefer=False):
        base = fw.TensorPlugin

        class P(base):
            name = "veto"
            weight = 100

            def filter_mask(self, ctx):
                if not veto:
                    return None
                m = np.ones((ctx.snapshot.pods.capacity, ctx.snapshot.nodes.capacity), bool)
                m[:, 0] = False
                return xp(m)

            def score(self, ctx):
                if not prefer:
                    return None
                s = np.zeros((ctx.snapshot.pods.capacity, ctx.snapshot.nodes.capacity),
                             np.int64)
                s[:, 1] = 100
                return xp(s)

        self.plugin = P()


@pytest.mark.parametrize("veto,prefer", [(False, False), (True, False), (False, True)])
def test_framework_mask_and_score_plugins(veto, prefer):
    js, ts = both()
    out = []
    for fw, xp, snap in ((jfw, jnp.asarray, js), (tfw, tt, ts)):
        fx = fw.FrameworkExtender([Veto(fw, xp, veto, prefer).plugin], debug_top_n=2)
        result = fx.run_cycle(fw.CycleContext(snapshot=snap))
        out.append((host(result.assignment).tolist(), str(fx.last_debug)))
    assert out[0] == out[1]
    a = out[1][0][:3]
    assert all(x >= 0 for x in a)
    if veto:
        assert 0 not in a
    if prefer:
        assert a == [1, 1, 1]


def test_framework_transformers_run_once():
    _, ts = both()
    calls = []

    def t(ctx):
        calls.append("before_pre_filter")
        return ctx

    tfw.FrameworkExtender(before_pre_filter=[t]).run_cycle(tfw.CycleContext(snapshot=ts))
    assert calls == ["before_pre_filter"]


@pytest.mark.parametrize("handled", [True, False])
def test_reserve_failure_unwinds_to_the_handlers(handled):
    js, ts = both()
    out = []
    for fw, snap in ((jfw, js), (tfw, ts)):
        events = []

        class Failing(fw.TensorPlugin):
            name = "fails"

            def reserve(self, ctx, pod_idx, node_idx):
                events.append(("reserve", pod_idx, node_idx))
                if pod_idx == 1:
                    raise RuntimeError("boom")

            def unreserve(self, ctx, pod_idx, node_idx):
                events.append(("unreserve", pod_idx, node_idx))

        fx = fw.FrameworkExtender([Failing()])
        fx.register_error_handler(lambda ctx, p, exc: events.append(("handler", p)) or handled)
        try:
            fx.run_cycle(fw.CycleContext(snapshot=snap))
            events.append("returned")
        except RuntimeError as exc:
            events.append(("raised", str(exc)))
        out.append(events)
    assert out[0] == out[1]
    assert out[1][-1] == ("returned" if handled else ("raised", "boom"))


def test_numa_plugin_integration():
    out = []
    for fw, mod, topo, enc, xp, dev in ((jfw, jpl, jtopo, j_encode_snapshot, jnp.asarray, {}),
                                        (tfw, tpl, ttopo, t_encode_snapshot, tt,
                                         {"device": "cpu"})):
        nodes, pods = small_lists(n_nodes=2, n_pods=1, cpu="4")
        snap = enc(nodes, pods, **dev)
        zones = topo.encode_zones([
            {"zones": [{"allocatable": {"cpu": "8", "memory": "16Gi"}}] * 2},
            {"zones": [{"allocatable": {"cpu": "8", "memory": "16Gi"},
                        "requested": {"cpu": "6"}}] * 2},
        ], node_bucket=snap.nodes.capacity, **dev)
        policy = xp(np.full((snap.nodes.capacity,), jnuma.POLICY_SINGLE_NUMA_NODE, np.int32))
        fx = fw.FrameworkExtender([mod.NodeNUMAResourcePlugin()])
        ctx = fw.CycleContext(snapshot=snap, extras={
            "zones": zones, "numa_policy": policy,
            "cpu_topologies": {0: topo.CPUTopology.build(1, 2, 4, 2)}})
        result = fx.run_cycle(ctx)
        out.append((host(result.assignment)[0], ctx.state["cpuset_allocations"],
                    fx.pre_bind_patches(ctx, result)))
    assert out[0] == out[1]
    assert out[1][0] == 0 and len(out[1][1][0]) == 4
    assert "resource-status" in str(out[1][2][0])


def test_device_plugin_integration():
    node_list = [
        {"name": "node-0", "allocatable": {"cpu": "16", "memory": "32Gi", res.GPU_CORE: 100,
                                           res.GPU_MEMORY: "16Gi", res.GPU_MEMORY_RATIO: 100}},
        {"name": "node-1", "allocatable": {"cpu": "16", "memory": "32Gi"}},
    ]
    pod_list = [{"name": "gpu-pod", "requests": {"cpu": "2", "memory": "4Gi",
                                                 res.GPU_CORE: 100, res.GPU_MEMORY_RATIO: 100}}]
    dev_nodes = [{"devices": [{"type": "gpu", "minor": 0, "total": {
        res.GPU_CORE: 100, res.GPU_MEMORY: "16Gi", res.GPU_MEMORY_RATIO: 100}}]},
        {"devices": []}]
    out = []
    for fw, mod, devmod, enc, dev in ((jfw, jpl, jdevice, j_encode_snapshot, {}),
                                      (tfw, tpl, tdevice, t_encode_snapshot, {"device": "cpu"})):
        snap = enc(node_list, pod_list, **dev)
        devices = devmod.encode_devices(dev_nodes, node_bucket=snap.nodes.capacity, **dev)
        minors = {0: [{"minor": 0, "total": {res.GPU_CORE: 100, res.GPU_MEMORY: 16 * Gi,
                                             res.GPU_MEMORY_RATIO: 100}}]}
        fx = fw.FrameworkExtender([mod.DeviceSharePlugin()])
        ctx = fw.CycleContext(snapshot=snap, extras={"devices": devices, "device_minors": minors})
        result = fx.run_cycle(ctx)
        out.append((host(result.assignment)[0], ctx.state["device_allocations"], minors))
    assert out[0] == out[1]
    assert out[1][0] == 0 and out[1][2][0][0]["free"][res.GPU_CORE] == 0


def test_device_reserve_called_directly():
    """A hook called outside the framework reads back its one placement
    (reference test_deviceshare.py TestMixedTypeRequests)."""
    node = {"devices": [{"type": "gpu", "minor": i, "total": {
        res.GPU_CORE: 100, res.GPU_MEMORY: 16 << 30, res.GPU_MEMORY_RATIO: 100}}
        for i in range(4)] + [{"type": "rdma", "minor": 0, "total": {res.RDMA: 100}}]}
    pod = [{"name": "p0", "requests": {"cpu": "1", res.GPU_CORE: 400,
                                       res.GPU_MEMORY_RATIO: 400, res.RDMA: 100}}]
    node_list = [{"name": "n0", "allocatable": {"cpu": "32", "memory": "64Gi"}}]
    out = []
    for fw, mod, devmod, enc, dev in ((jfw, jpl, jdevice, j_encode_snapshot, {}),
                                      (tfw, tpl, tdevice, t_encode_snapshot, {"device": "cpu"})):
        ctx = fw.CycleContext(snapshot=enc(node_list, pod, [], [], **dev), extras={
            "devices": devmod.encode_devices([node], node_bucket=8, **dev)})
        mod.DeviceSharePlugin().reserve(ctx, 0, 0)
        out.append((ctx.state["device_allocations"], ctx.extras["device_minors"]))
    assert out[0] == out[1]
    assert [e["minor"] for e in out[1][0][0]["gpu"]] == [0, 1, 2, 3]


def test_reservation_plugin_integration():
    out = []
    for fw, mod, rmod, enc, dev in ((jfw, jpl, jrsv, j_encode_snapshot, {}),
                                    (tfw, tpl, trsv, t_encode_snapshot, {"device": "cpu"})):
        nodes, pods = small_lists(n_nodes=2, n_pods=1)
        snap = enc(nodes, pods, **dev)
        rsv = rmod.encode_reservations(
            [{"name": "rsv", "uid": "u-1", "node": "node-1",
              "allocatable": {"cpu": "4", "memory": "8Gi"},
              "owners": [{"label_selector": {"app": "web"}}], "order": 1}],
            [{"name": "pod-0", "labels": {"app": "web"}}], ["node-0", "node-1"],
            pod_bucket=snap.pods.capacity, **dev)
        fx = fw.FrameworkExtender([mod.ReservationPlugin()])
        ctx = fw.CycleContext(snapshot=snap, extras={"reservations": rsv})
        result = fx.run_cycle(ctx)
        out.append((host(result.assignment)[0], fx.pre_bind_patches(ctx, result)))
    assert out[0] == out[1]
    assert out[1][0] == 1 and "reservation-allocated" in str(out[1][1][0])


# ---------------------------------------------------------------------------
# the routes on a CUDA snapshot, with stub kernel rungs
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_routes(monkeypatch):
    calls = []
    plain = tsolver.greedy_assign

    def stub(name):
        def fn(snapshot, cfg, extra_mask, extra_scores, **_):
            calls.append(name)
            return plain(snapshot, cfg, extra_mask, extra_scores)
        return fn

    for attr, name in (("greedy_assign_dense", "K1"), ("greedy_assign_wide", "K2"),
                       ("wave_assign", "wave_assign"), ("greedy_assign", "greedy_assign")):
        monkeypatch.setattr(tsolver, attr, stub(name))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(ClusterSnapshot, "device", property(lambda s: torch.device("cuda")))
    with tsolver._LOCK:
        saved = dict(tsolver._FAILURES)
        tsolver._FAILURES.clear()
    yield calls
    with tsolver._LOCK:
        tsolver._FAILURES.clear()
        tsolver._FAILURES.update(saved)


@pytest.mark.parametrize("i32_ok,kernel", [(None, "K2"), (False, "K1")])
def test_framework_cycle_on_cuda_takes_a_kernel(scenario, cuda_routes, i32_ok, kernel):
    _, _, tsnap, ttab, nodes, _ = scenario
    fx = tfw.FrameworkExtender(_plugins(tpl))
    fx.register_error_handler(lambda ctx, p, exc: True)
    fx.run_cycle(_context(tfw, tsnap, ttab, topologies(ttopo, nodes)), i32_ok=i32_ok)
    assert cuda_routes == [kernel]


# ---------------------------------------------------------------------------
# the anchors chip_smoke.py checks on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def anchor():
    rec = ANCHOR_RECIPE
    jn, jp, jg, jq = jgen.quota_colocation(**rec)
    z, pol, d, r, jn, jp = jx.extras_scenario(jn, jp, seed=0, node_bucket=rec["nodes"],
                                              pod_bucket=rec["pods"])
    jsnap, _ = jgen.encode_quota_lists(jn, jp, jg, jq, node_bucket=rec["nodes"],
                                       pod_bucket=rec["pods"])
    return jsnap, (z, pol, d, r), tx.extras_snapshot(**rec, device="cpu")


def test_extras_anchor_constants_from_the_reference(anchor):
    jsnap, jtab, _ = anchor
    jm, js = jx.plugin_extra_tensors(jsnap, *jtab)
    assert extras_digest(jm, js) == EXTRAS_TENSORS_SHA256
    res_j = j_greedy_assign(jsnap, extra_mask=jm, extra_scores=js)
    assert cycle_digest(res_j.assignment, res_j.status) == EXTRAS_ANCHOR_SHA256


def test_port_meets_the_extras_anchors(anchor):
    _, _, (snap, z, pol, d, r, _, _) = anchor
    m, s = tx.plugin_extra_tensors(snap, z, pol, d, r)
    assert extras_digest(m, s) == EXTRAS_TENSORS_SHA256
    fx = tfw.FrameworkExtender(tx.extended_plugins())
    failures = []
    fx.register_error_handler(lambda ctx, p, exc: failures.append(p) or True)
    result = fx.run_cycle(tx.extras_context(snap, z, pol, d, r))
    assert cycle_digest(result.assignment, result.status) == EXTRAS_ANCHOR_SHA256
    # the cycle's count-based device fit reads the table before the cycle:
    # some GPU pods find no free minor at Reserve, in the reference too
    assert failures


def test_preempt_anchor_from_the_reference(anchor):
    """The PostFilter over the reference's extras cycle at the anchor."""
    jsnap, jtab, (_, _, _, _, _, nodes, pods) = anchor
    jm, js = jx.plugin_extra_tensors(jsnap, *jtab)
    res_j = j_greedy_assign(jsnap, extra_mask=jm, extra_scores=js)
    _, found = post_filter(jfw, jsnap, res_j, nodes, pods)
    assert found and preempt_digest(found) == PREEMPT_ANCHOR_SHA256


def test_port_meets_the_preempt_anchor(anchor):
    _, _, (snap, z, pol, d, r, nodes, pods) = anchor
    m, s = tx.plugin_extra_tensors(snap, z, pol, d, r)
    result = tsolver.run_cycle(snap, extra_mask=m, extra_scores=s)
    _, found = post_filter(tfw, snap, result, nodes, pods)
    assert preempt_digest(found) == PREEMPT_ANCHOR_SHA256


_ISOLATED = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from koordinator_tpu_torch.harness.extras_scenario import (
    extended_plugins, extras_context, extras_snapshot)
from koordinator_tpu_torch.harness.rebalance import placed_node_dicts, plan_rebalance
from koordinator_tpu_torch.scheduler.framework import FrameworkExtender
snap, z, pol, d, r, nodes, pods = extras_snapshot(pods=64, nodes=16, device="cpu")
fx = FrameworkExtender(extended_plugins())
fx.register_error_handler(lambda ctx, p, exc: True)
ctx = extras_context(snap, z, pol, d, r)
result = fx.run_cycle(ctx)
patches = fx.pre_bind_patches(ctx, result)
plan = plan_rebalance(placed_node_dicts(nodes, pods, result.assignment.tolist()))
loaded = sorted(m for m in sys.modules if m == "koordinator_tpu" or m.startswith("koordinator_tpu."))
print(json.dumps({"placed": int((result.assignment >= 0).sum()), "path": result.path,
                  "patched": len(patches) > 0, "plan": isinstance(plan, list),
                  "loaded": loaded}))
"""


def test_extras_cycle_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("placed") > 0
    assert got == {"path": "scan", "patched": True, "plan": True, "loaded": []}
