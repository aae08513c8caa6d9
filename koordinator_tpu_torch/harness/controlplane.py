"""The co-location control loop around the scheduler, from seeded inputs.

``tests/test_e2e_smoke.py`` states the loop at four nodes: koord-manager
turns NodeMetrics into batch resources, the ClusterColocationProfile
webhook moves the BE pods onto them, the scheduler places the mix, and
koord-descheduler moves pods off hot nodes through a Reservation.
``ControlPlaneLoop`` runs it on the ``quota_colocation`` cluster (about
40 % BE pods), one step a method:

1. ``cycle_a``: the LS/prod pods (those not BE, every ``LSE_EVERY``-th of
   them LSE) placed on the nodes, with the tenants' quotas;
2. ``node_metrics``: every node's NodeMetric from a ``NodeMetricReporter``
   over a ``MetricCache`` of seeded samples (``koordlet_fleet.
   usage_samples``, and a system CPU share) and a ``StatesInformer`` that
   holds the pods cycle A put on the node, reported at ``now``; no sysfs
   is read.  Each pod's usage is sampled below its request, except every
   ``UNREPORTED_EVERY``-th pod, which has no samples yet; every
   ``UNLISTED_EVERY``-th node also runs a pod the manager's pod list
   lacks (a static pod the koordlet sees);
3. ``manager``: ``ManagerServer.reconcile_once`` over a ``ClusterView`` of
   the nodes, cycle A's placements as their pods, the NodeMetrics, the
   default ``ColocationStrategy`` and one ElasticQuotaProfile per tenant
   (each over one of ``POOLS`` node pools); every node's batch resources
   held against ``batch_allocatable_batch`` on the same ``[N, 2]`` inputs,
   its HP usage taken from the reported pod metrics;
4. ``webhook``: the BE pods as submitted (no QoS, no priority class, the
   colocation label) mutated in process by ``mutate_by_profiles``; a seeded
   sample of them sent over HTTPS to ``WebhookServer``'s ``/mutate-pod``,
   each reply's JSON patch applied to its pod and held against the
   in-process mutation, and the mutated pods to ``/validate-pod``, each
   reply held against ``validate_pod``;
5. ``cycle_b``: nodes whose allocatable carries the manager's batch
   resources and whose ``requested`` is cycle A's post-cycle state, every
   ``RESERVED_EVERY``-th with a node-reservation annotation, the mutated
   BE pods and the tenants' quotas through ``transform_cluster``; the BE
   pods placed.  The tenants' quotas declare cpu and memory only, so they
   do not cap pods on batch resources;
6. ``deschedule``: one ``Descheduler.descheduler_once`` with LowNodeLoad
   (one pool, low 20/20, high 50/50) over the placed cluster, its
   ``MigrationController`` in ``ReservationFirst`` mode with the
   reference's defaults: each job that passes arbitration creates a
   Reservation in a ``ReservationController``; cycle C places the reserve
   pods with each one's source node masked out; a second reconcile evicts.

``servers_leg`` starts ``ManagerServer`` and ``DeschedulerServer`` on lease
files: each wins its lease, runs one tick, answers ``/healthz`` and, once
stopped, lets go of its threads.

The code here is numpy and the standard library only: it takes the
package it drives as ``impl`` (``port_impl`` is this package), so the same
code drives any package with the same module layout.  A cycle runs through
``cycle(name, snapshot, extra_mask)``, which a caller may wrap to count or
hold its launches; every output is host data.  The clock is the
reference's: ``reconcile_once`` reads ``time.time()``, so a caller that
pins ``now`` far from the wall clock pins the manager's clock too, else
every NodeMetric is stale and every node's batch resources degrade to 0.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import json
import os
import ssl
import threading
import time
import types
import urllib.request
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from koordinator_tpu_torch.harness.koordlet_fleet import SAMPLE_STEP_S, SAMPLES, usage_samples

POOLS = 4  # node pools, one ElasticQuotaProfile per tenant over one pool
RESERVED_EVERY = 10  # every 10th node carries a node-reservation annotation
NODE_RESERVATION = {"resources": {"cpu": "1000m", "memory": "1024Mi"}}
SYSTEM_CPU_SHARE = (0.02, 0.06)  # the system's share of a node's CPU
COLOCATION_LABEL = "koordinator.sh/enable-colocation"
LOOP_SEED = 13  # the loop's own draws (system CPU, pod usage, the webhook sample)
OWNER_KIND = "ReplicaSet"
LSE_EVERY = 20  # every 20th LS pod is LSE (its CPU request is not reclaimed)
UNREPORTED_EVERY = 16  # every 16th placed pod has no usage samples yet
UNLISTED_EVERY = 8  # every 8th node runs a pod the manager's pod list lacks
POD_USAGE_SHARE = (0.2, 0.9)  # a pod's usage as a share of its request
UNLISTED_USAGE = {"cpu": (100, 400), "memory": (64, 512)}  # milli-CPU, MiB
SERVER_WAIT_S = 30.0  # a daemon's bound to win its lease and tick

# the ClusterColocationProfile of the reference's co-location guide: pods
# labelled for co-location become BE pods on batch resources
COLOCATION_PROFILE = {
    "name": "colocation-profile-example",
    "spec": {
        "selector": {"matchLabels": {COLOCATION_LABEL: "true"}},
        "qosClass": "BE",
        "priorityClassName": "koord-batch",
        "koordinatorPriority": 1000,
        "schedulerName": "koord-scheduler",
        "labels": {"koordinator.sh/mutated": "true"},
        "annotations": {"koordinator.sh/intercepted": "true"},
    },
}


def port_impl(device) -> types.SimpleNamespace:
    """This package's modules, as ``ControlPlaneLoop`` takes them; ``device``
    is given to every encoder and the cycle runs ``solver.run_cycle``."""
    import torch

    from koordinator_tpu_torch import transformers
    from koordinator_tpu_torch.descheduler import evictions, lownodeload, migration
    from koordinator_tpu_torch.descheduler import runtime as descheduler_runtime
    from koordinator_tpu_torch.descheduler import server as descheduler_server
    from koordinator_tpu_torch.harness import generators
    from koordinator_tpu_torch.koordlet import metriccache, statesinformer
    from koordinator_tpu_torch.manager import noderesource, profile, sloconfig, validating
    from koordinator_tpu_torch.manager import server as manager_server
    from koordinator_tpu_torch.manager import webhook_server
    from koordinator_tpu_torch.model import encode_snapshot, resources
    from koordinator_tpu_torch.scheduler import reservation_controller
    from koordinator_tpu_torch.solver import run_cycle

    return types.SimpleNamespace(
        generators=generators, metriccache=metriccache, statesinformer=statesinformer,
        sloconfig=sloconfig, noderesource=noderesource, profile=profile,
        validating=validating, manager_server=manager_server, webhook_server=webhook_server,
        transformers=transformers, evictions=evictions, lownodeload=lownodeload,
        migration=migration, descheduler_runtime=descheduler_runtime,
        descheduler_server=descheduler_server, reservation_controller=reservation_controller,
        resources=resources, encode_snapshot=encode_snapshot,
        run_cycle=lambda snap, extra_mask=None: run_cycle(snap, extra_mask=extra_mask),
        mask=lambda rows: torch.as_tensor(rows, device=device),
        host=lambda t: t.cpu().numpy(),
        encode_kw={"device": device},
    )


# ---------------------------------------------------------------------------
# glue
# ---------------------------------------------------------------------------


def node_metric_view(report: Mapping) -> Dict:
    """A ``NodeMetricReporter`` report as the metric dict the manager's
    ``ClusterView`` reads: system usage, pod usage by pod name and the
    report's update time."""
    return {
        "system_usage": dict(report["nodeMetric"]["systemUsage"]),
        "pod_metrics": {p["name"]: dict(p["usage"]) for p in report["podsMetric"]},
        "update_time": report["updateTime"],
    }


def apply_json_patch(obj: Mapping, patch: Sequence[Mapping]) -> Dict:
    """``obj`` with the webhook's top-level RFC-6902 add, replace and remove
    operations applied."""
    out = copy.deepcopy(dict(obj))
    for op in patch:
        key = op["path"].lstrip("/")
        if op["op"] in ("add", "replace"):
            out[key] = op["value"]
        elif op["op"] == "remove":
            del out[key]
        else:
            raise ValueError(f"unexpected patch op {op!r}")
    return out


def quantities(res, row) -> Dict:
    """A resource-axis row as a quantity dict of its nonzero entries."""
    return {name: res.format_quantity(int(v), name)
            for name, v in zip(res.RESOURCE_AXIS, row) if v}


def lownodeload_profile(impl):
    """The LowNodeLoad ``DeschedulerProfile`` of the loop and its daemon:
    one node pool, low 20/20, high 50/50 (the ``rebalance`` line's)."""
    rt, lnl = impl.descheduler_runtime, impl.lownodeload
    return rt.DeschedulerProfile(
        plugins=rt.PluginSet(balance=["LowNodeLoad"]),
        plugin_config={"LowNodeLoad": lnl.LowNodeLoadArgs(node_pools=[lnl.NodePool(
            low_thresholds={"cpu": 20, "memory": 20},
            high_thresholds={"cpu": 50, "memory": 50})])})


def cert_generator() -> str:
    """Which generator ``CertManager`` takes here: ``cryptography`` when it
    imports, else the ``openssl`` command."""
    try:
        import cryptography  # noqa: F401
    except ImportError:
        return "openssl"
    return "cryptography"


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CycleRecord:
    """One cycle's host arrays (the valid pod and node rows only)."""

    assignment: np.ndarray
    status: np.ndarray
    node_requested: np.ndarray
    node_estimated: np.ndarray
    quota_used: np.ndarray
    encode_ms: float
    cycle_ms: float


class ControlPlaneLoop:
    """The co-location loop over one seeded ``quota_colocation`` cluster;
    call the steps in order.  ``base`` holds the lease files and the
    webhook's certificates; ``cycle(name, snapshot, extra_mask)`` runs a
    cycle (``impl.run_cycle`` by default).  Each cycle encodes its pods
    and nodes exactly, with no padding rows."""

    def __init__(self, impl, base: str, *, seed: int = 0, pods: int = 10000,
                 nodes: int = 2000, tenants: int = 16, now: float = 0.0,
                 cycle: Optional[Callable] = None):
        self.impl = impl
        self.base = base
        self.now = now
        self.cycle = cycle or (lambda name, snap, extra_mask=None:
                               impl.run_cycle(snap, extra_mask))
        self.rng = np.random.RandomState(seed + LOOP_SEED)
        node_list, pod_list, _, quotas = impl.generators.quota_colocation(
            seed=seed, pods=pods, nodes=nodes, tenants=tenants)
        annotation = impl.transformers.ANNOTATION_NODE_RESERVATION
        self.nodes = [
            dict(nd, labels={"node-pool": f"pool-{i % POOLS}"},
                 **({"annotations": {annotation: json.dumps(NODE_RESERVATION)}}
                    if i % RESERVED_EVERY == 0 else {}))
            for i, nd in enumerate(node_list)
        ]
        owned = [dict(p, owner_references=[{"kind": OWNER_KIND, "name": f"{p['quota']}-rs"}])
                 for p in pod_list]
        self.ls_pods = [dict(p, qos="LSE") if k % LSE_EVERY == 0 else p
                        for k, p in enumerate(p for p in owned if p["qos"] != "BE")]
        # the BE pods as their owners submit them: no QoS or priority class,
        # the co-location label the profile selects
        self.be_submitted = [
            {**{k: v for k, v in p.items() if k not in ("qos", "priority_class")},
             "labels": {COLOCATION_LABEL: "true"}}
            for p in owned if p["qos"] == "BE"
        ]
        self.quotas = quotas
        self.quota_profiles = [{
            "name": f"{q['name']}-profile",
            "spec": {"quotaName": f"{q['name']}-root", "treeID": q["name"],
                     "nodeSelector": {"matchLabels": {"node-pool": f"pool-{t % POOLS}"}},
                     "resourceRatio": "0.5"},
        } for t, q in enumerate(quotas)]
        self.profiles = [COLOCATION_PROFILE]
        self.strategy = impl.sloconfig.ColocationStrategy()

    # -- helpers ------------------------------------------------------------
    def _run(self, name, nodes, pods, quotas, extra_mask=None) -> CycleRecord:
        impl, n, p = self.impl, len(nodes), len(pods)
        t0 = time.perf_counter()
        if quotas:
            snap, _ = impl.generators.encode_quota_lists(
                nodes, pods, [], quotas, node_bucket=n, pod_bucket=p, **impl.encode_kw)
        else:
            snap = impl.encode_snapshot(nodes, pods, [], [], node_bucket=n, pod_bucket=p,
                                        **impl.encode_kw)
        encode_ms = _ms(t0)
        mask = None if extra_mask is None else impl.mask(extra_mask)
        t0 = time.perf_counter()
        out = self.cycle(name, snap, mask)
        h = impl.host
        return CycleRecord(h(out.assignment)[:p].copy(), h(out.status)[:p].copy(),
                           h(out.node_requested)[:n].copy(), h(out.node_estimated)[:n].copy(),
                           h(out.quota_used)[:len(quotas)].copy(), encode_ms, _ms(t0))

    # -- 1 ------------------------------------------------------------------
    def cycle_a(self) -> Dict:
        self.a = self._run("A", self.nodes, self.ls_pods, self.quotas)
        self.ls_placed = [dict(p, node=self.nodes[a]["name"])
                          for p, a in zip(self.ls_pods, self.a.assignment) if a >= 0]
        return {"pods": len(self.ls_pods), "placed": len(self.ls_placed),
                "lse_pods": sum(1 for p in self.ls_pods if p["qos"] == "LSE"),
                "encode_ms": self.a.encode_ms, "cycle_ms_host_wall": self.a.cycle_ms}

    # -- 2 ------------------------------------------------------------------
    def node_metrics(self) -> Dict:
        """Every node's NodeMetric at ``now`` over the pods cycle A put on
        it, as ``ClusterView`` reads it."""
        mc, si, res = self.impl.metriccache, self.impl.statesinformer, self.impl.resources
        cpu, mem = res.RESOURCE_INDEX[res.CPU], res.RESOURCE_INDEX[res.MEMORY]
        n = len(self.nodes)
        cpu_s, mem_s = usage_samples(self.nodes, 0)
        cores = np.asarray([int(nd["allocatable"]["cpu"][:-1]) for nd in self.nodes]) / 1000.0
        sys_s = cores[:, None] * self.rng.uniform(*SYSTEM_CPU_SHARE, (n, SAMPLES))
        ts = self.now - SAMPLE_STEP_S * np.arange(SAMPLES, 0, -1)
        # each placed pod's samples (cores, bytes), a share of its request
        req = np.asarray([res.resource_vector(p["requests"]) for p in self.ls_placed],
                         np.int64).reshape(-1, res.NUM_RESOURCES)
        share = self.rng.uniform(*POD_USAGE_SHARE, (len(self.ls_placed), SAMPLES))
        pod_cpu_s = req[:, cpu, None] * share / 1000.0
        pod_mem_s = np.floor(req[:, mem, None] * share * 2.0 ** 20)
        row = {nd["name"]: i for i, nd in enumerate(self.nodes)}
        on_node: List[List[int]] = [[] for _ in range(n)]
        for k, p in enumerate(self.ls_placed):
            on_node[row[p["node"]]].append(k)
        unlisted = {i: (self.rng.randint(*UNLISTED_USAGE["cpu"]) / 1000.0,
                        float(self.rng.randint(*UNLISTED_USAGE["memory"]) * 2 ** 20))
                    for i in range(0, n, UNLISTED_EVERY)}
        t0 = time.perf_counter()
        self.metrics = {}
        for i, nd in enumerate(self.nodes):
            cache = mc.MetricCache(capacity_per_series=SAMPLES)
            metas = []
            for k in range(SAMPLES):
                t = float(ts[k])
                cache.append(mc.NODE_CPU_USAGE, float(cpu_s[i, k]), ts=t)
                cache.append(mc.NODE_MEMORY_USAGE, float(mem_s[i, k]), ts=t)
                cache.append(mc.SYS_CPU_USAGE, float(sys_s[i, k]), ts=t)
            for j in on_node[i]:
                pod = self.ls_placed[j]
                metas.append(si.PodMeta(name=pod["name"], uid=f"uid-{pod['name']}",
                                        koord_qos=pod["qos"]))
                if j % UNREPORTED_EVERY == 0:
                    continue
                labels = {"pod": metas[-1].uid}
                for k in range(SAMPLES):
                    cache.append(mc.POD_CPU_USAGE, float(pod_cpu_s[j, k]), ts=float(ts[k]),
                                 labels=labels)
                    cache.append(mc.POD_MEMORY_USAGE, float(pod_mem_s[j, k]), ts=float(ts[k]),
                                 labels=labels)
            if i in unlisted:
                metas.append(si.PodMeta(name=f"{nd['name']}-static", uid=f"uid-{nd['name']}"))
                for k in range(SAMPLES):
                    for metric, v in zip((mc.POD_CPU_USAGE, mc.POD_MEMORY_USAGE), unlisted[i]):
                        cache.append(metric, v, ts=float(ts[k]), labels={"pod": metas[-1].uid})
            informer = si.StatesInformer()
            informer.set_pods(metas)
            report = si.NodeMetricReporter(cache, informer).collect(self.now)
            if report is None:
                raise RuntimeError(f"node {nd['name']}: no NodeMetric")
            self.metrics[nd["name"]] = node_metric_view(report)
        return {"nodes": len(self.metrics), "report_ms": _ms(t0),
                "samples_per_metric": SAMPLES,
                "pods_reported": sum(len(m["pod_metrics"]) for m in self.metrics.values()),
                "pods_unreported": len(range(0, len(self.ls_placed), UNREPORTED_EVERY)),
                "pods_unlisted": len(unlisted)}

    # -- 3 ------------------------------------------------------------------
    def manager(self) -> Dict:
        impl, res = self.impl, self.impl.resources
        view = impl.manager_server.ClusterView(
            nodes_fn=lambda: self.nodes, pods_fn=lambda: self.ls_placed,
            node_metrics_fn=lambda: self.metrics, strategy_fn=lambda: self.strategy,
            quota_profiles_fn=lambda: self.quota_profiles)
        server = impl.manager_server.ManagerServer(
            view, lease_path=os.path.join(self.base, "manager.lease"), resync_seconds=3600.0)
        try:
            t0 = time.perf_counter()
            server.reconcile_once()
            reconcile_ms = _ms(t0)
        finally:
            server.stop()
        self.view = view
        # every node's batch resources against the vectorized formula on
        # the same [N, 2] inputs
        cpu, mem = res.RESOURCE_INDEX[res.CPU], res.RESOURCE_INDEX[res.MEMORY]
        n = len(self.nodes)
        row = {nd["name"]: i for i, nd in enumerate(self.nodes)}
        capacity = np.zeros((n, 2), np.int64)
        sys_usage = np.zeros((n, 2), np.int64)
        hp_request = np.zeros((n, 2), np.int64)
        # HP used: a reported pod's usage (an LSE pod's CPU request), an
        # unreported pod's request, and the usage of the reported pods the
        # pod list lacks
        hp_used = np.zeros((n, 2), np.int64)
        listed: List[set] = [set() for _ in range(n)]
        for p in self.ls_placed:
            i = row[p["node"]]
            v = res.resource_vector(p["requests"])
            hp_request[i] += (v[cpu], v[mem])
            listed[i].add(p["name"])
            m = self.metrics[p["node"]]["pod_metrics"].get(p["name"])
            u = v if m is None else res.resource_vector(m)
            hp_used[i] += (v[cpu] if p["qos"] == "LSE" else u[cpu], u[mem])
        for i, nd in enumerate(self.nodes):
            v = res.resource_vector(nd["allocatable"])
            capacity[i] = (v[cpu], v[mem])
            nm = self.metrics[nd["name"]]
            u = res.resource_vector(nm["system_usage"])
            sys_usage[i] = (u[cpu], u[mem])
            for name, m in nm["pod_metrics"].items():
                if name not in listed[i]:
                    u = res.resource_vector(m)
                    hp_used[i] += (u[cpu], u[mem])
        if not (hp_used[:, 0] < hp_request[:, 0]).any():
            raise AssertionError("manager: no node's HP usage is below its HP request")
        want = impl.noderesource.batch_allocatable_batch(
            self.strategy, capacity, np.zeros((n, 2), np.int64), sys_usage, hp_request,
            hp_used)
        got = np.zeros((n, 2), np.int64)
        for i, nd in enumerate(self.nodes):
            ext = view.node_extended_resources[nd["name"]]
            if not ext:
                raise AssertionError(f"manager: node {nd['name']} degraded")
            got[i] = (res.parse_quantity(ext[res.BATCH_CPU], res.BATCH_CPU),
                      res.parse_quantity(ext[res.BATCH_MEMORY], res.BATCH_MEMORY))
        if not np.array_equal(got, want):
            bad = int((got != want).any(axis=1).sum())
            raise AssertionError(f"manager: {bad} nodes' batch resources differ from "
                                 "batch_allocatable_batch")
        self.batch = got
        return {"reconcile_ms_host_wall": reconcile_ms, "nodes": n,
                "nodemetric_specs": len(view.nodemetric_specs), "nodeslos": len(view.nodeslos),
                "root_quotas": len(view.quotas),
                "batch_cpu_milli_sum": int(got[:, 0].sum()),
                "batch_memory_mib_sum": int(got[:, 1].sum()),
                "nodes_with_batch_cpu": int((got[:, 0] > 0).sum()),
                "hp_request_cpu_milli_sum": int(hp_request[:, 0].sum()),
                "hp_used_cpu_milli_sum": int(hp_used[:, 0].sum()),
                "hp_request_memory_mib_sum": int(hp_request[:, 1].sum()),
                "hp_used_memory_mib_sum": int(hp_used[:, 1].sum()),
                "batch_check": "every node equal to batch_allocatable_batch, HP used from the "
                               "reported pod metrics"}

    # -- 4 ------------------------------------------------------------------
    def webhook(self, sample: int = 512) -> Dict:
        impl = self.impl
        t0 = time.perf_counter()
        self.be_mutated = [impl.profile.mutate_by_profiles(p, self.profiles)
                           for p in self.be_submitted]
        mutate_ms = _ms(t0)
        picks = np.sort(self.rng.choice(len(self.be_submitted),
                                        size=min(sample, len(self.be_submitted)),
                                        replace=False))
        t0 = time.perf_counter()
        server = impl.webhook_server.WebhookServer(os.path.join(self.base, "certs"),
                                                   profiles_fn=lambda: self.profiles)
        certs_ms = _ms(t0)
        server.start()
        self.replies = []
        try:
            ctx = ssl.create_default_context(cafile=server.certs.ca_path)
            ctx.check_hostname = False  # an IP connect; the SANs cover localhost

            def post(path, uid, obj):
                review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                          "request": {"uid": uid, "object": obj}}
                req = urllib.request.Request(
                    f"https://127.0.0.1:{server.port}{path}",
                    data=json.dumps(review).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30, context=ctx) as r:
                    return json.loads(r.read())["response"]

            t0 = time.perf_counter()
            for i in picks.tolist():
                pod = self.be_submitted[i]
                out = post("/mutate-pod", f"m-{i}", pod)
                patch = json.loads(base64.b64decode(out["patch"]))
                if (not out["allowed"] or out["uid"] != f"m-{i}"
                        or apply_json_patch(pod, patch) != self.be_mutated[i]):
                    raise AssertionError(f"webhook: pod {pod['name']}'s patched reply differs "
                                         "from the in-process mutation")
                self.replies.append(("mutate", pod["name"], patch))
            mutate_https_ms = _ms(t0)
            t0 = time.perf_counter()
            for i in picks.tolist():
                pod = self.be_mutated[i]
                out = post("/validate-pod", f"v-{i}", pod)
                errs = impl.validating.validate_pod(pod)
                if out["allowed"] != (not errs) or out.get("status", {}).get(
                        "message", "") != "; ".join(errs):
                    raise AssertionError(f"webhook: pod {pod['name']}'s validation reply "
                                         "differs from validate_pod")
                self.replies.append(("validate", pod["name"], out["allowed"]))
            validate_https_ms = _ms(t0)
        finally:
            server.stop()
        res = impl.resources
        moved = sum(1 for p in self.be_mutated if res.BATCH_CPU in p["requests"]
                    and res.CPU not in p["requests"])
        return {"be_pods": len(self.be_submitted), "mutated_in_process_ms": mutate_ms,
                "moved_to_batch_resources": moved, "https_sample": len(picks),
                "mutate_replies": len(picks), "validate_replies": len(picks),
                "allowed": sum(1 for r in self.replies if r[0] == "validate" and r[2]),
                "cert_generator": cert_generator(), "certs_ms": certs_ms,
                "mutate_https_ms": mutate_https_ms, "validate_https_ms": validate_https_ms,
                "parity": "each reply's patch applied equals mutate_by_profiles; each "
                          "validation equals validate_pod"}

    # -- 5 ------------------------------------------------------------------
    def cycle_b(self) -> Dict:
        impl, res = self.impl, self.impl.resources
        ext = self.view.node_extended_resources
        nodes_b = [dict(nd, allocatable={**nd["allocatable"], **ext[nd["name"]]},
                        requested=quantities(res, self.a.node_requested[i]))
                   for i, nd in enumerate(self.nodes)]
        t0 = time.perf_counter()
        self.nodes_t, self.pods_t, self.quotas_t = impl.transformers.transform_cluster(
            nodes_b, self.be_mutated, self.quotas)
        transform_ms = _ms(t0)
        self.b = self._run("B", self.nodes_t, self.pods_t, self.quotas_t)
        bc, bm = res.RESOURCE_INDEX[res.BATCH_CPU], res.RESOURCE_INDEX[res.BATCH_MEMORY]
        alloc = np.stack([res.resource_vector(nd["allocatable"]) for nd in self.nodes_t])
        self.be_placed = [dict(p, node=self.nodes[a]["name"])
                          for p, a in zip(self.pods_t, self.b.assignment) if a >= 0]
        return {"be_pods": len(self.pods_t), "placed": len(self.be_placed),
                "transform_ms": transform_ms,
                "trimmed_nodes": sum(1 for a, b in zip(nodes_b, self.nodes_t)
                                     if a["allocatable"] != b["allocatable"]),
                "batch_cpu_requested_milli": int(self.b.node_requested[:, bc].sum()),
                "batch_cpu_allocatable_milli": int(alloc[:, bc].sum()),
                "batch_memory_requested_mib": int(self.b.node_requested[:, bm].sum()),
                "batch_memory_allocatable_mib": int(alloc[:, bm].sum()),
                "quotas": "the tenants' (cpu and memory declared; batch resources uncapped)",
                "encode_ms": self.b.encode_ms, "cycle_ms_host_wall": self.b.cycle_ms}

    # -- 6 ------------------------------------------------------------------
    def placed_node_dicts(self) -> List[Dict]:
        """The placed cluster as LowNodeLoad reads it: each node's transformed
        allocatable, its usage, and the pods cycles A and B put on it."""
        node_dicts = [{"name": nd["name"], "allocatable": nd["allocatable"],
                       "usage": nd.get("usage", {}), "labels": nd.get("labels", {}),
                       "pods": []} for nd in self.nodes_t]
        row = {nd["name"]: i for i, nd in enumerate(self.nodes_t)}
        for p in self.ls_placed + self.be_placed:
            node_dicts[row[p["node"]]]["pods"].append({
                "name": p["name"], "namespace": "default", "node": p["node"],
                "requests": p["requests"], "priority": p.get("priority", 0),
                "priority_class": p.get("priority_class", ""), "qos": p.get("qos", ""),
                "owner_references": p["owner_references"],
            })
        return node_dicts

    def deschedule(self) -> Dict:
        impl = self.impl
        rt, mig, rcm = impl.descheduler_runtime, impl.migration, impl.reservation_controller
        node_dicts = self.placed_node_dicts()
        row = {nd["name"]: i for i, nd in enumerate(self.nodes_t)}
        rc = rcm.ReservationController(clock=lambda: self.now)
        evictor = impl.evictions.PodEvictor()
        early = []

        def create_reservation(job):
            name = f"migrate-{job.pod['name']}"
            rc.create(rcm.Reservation(name=name, requests=dict(job.pod.get("requests") or {}),
                                      ttl_seconds=None))
            return name

        def evict(pod):
            job = migration.jobs[f"mj-{pod.get('namespace', 'default')}-{pod['name']}"]
            r = rc.reservations.get(job.reservation_name)
            if r is None or r.phase != rcm.AVAILABLE or r.node == pod.get("node"):
                early.append(pod["name"])
            return evictor.evict(pod, pod.get("node", ""), reason="reservation-first migration")

        migration = mig.MigrationController(
            args=mig.MigrationControllerArgs(default_job_mode="ReservationFirst"),
            create_reservation=create_reservation,
            reservation_bound=lambda name: rc.reservations[name].phase == rcm.AVAILABLE,
            evict=evict)
        d = rt.Descheduler([lownodeload_profile(impl)], nodes_fn=lambda: node_dicts, evictor=evictor,
                           migration=migration, clock=lambda: self.now)
        t0 = time.perf_counter()
        status = d.descheduler_once()
        tick_ms = _ms(t0)
        if not status.ok:
            raise AssertionError(f"descheduler: {status.err}")
        if evictor.total_evicted():
            raise AssertionError("descheduler: a pod was evicted before its reservation")
        reserve = rc.pending_reserve_pods()
        rname = "scheduling.koordinator.sh/reservation-name"
        job_of = {j.reservation_name: j for j in migration.jobs.values() if j.reservation_name}
        self.c = None
        if reserve:
            mask = np.ones((len(reserve), len(self.nodes_t)), bool)
            for k, pod in enumerate(reserve):
                mask[k, row[job_of[pod["annotations"][rname]].pod["node"]]] = False
            nodes_c = [dict(nd, requested=quantities(impl.resources, self.b.node_requested[i]))
                       for i, nd in enumerate(self.nodes_t)]
            self.c = self._run("C", nodes_c, reserve, [], extra_mask=mask)
            for pod, a in zip(reserve, self.c.assignment):
                if a >= 0:
                    rc.on_reserve_pod_assigned(pod["annotations"][rname],
                                               self.nodes_t[a]["name"], now=self.now)
        t0 = time.perf_counter()
        migration.reconcile(self.now + 1.0)
        reconcile_ms = _ms(t0)
        jobs = sorted(migration.jobs.values(), key=lambda j: j.name)
        succeeded = [j for j in jobs if j.phase == mig.SUCCEEDED]
        misplaced = [r.name for r in rc.reservations.values()
                     if r.phase == rcm.AVAILABLE and r.node == job_of[r.name].pod["node"]]
        if early or misplaced or len(succeeded) != evictor.total_evicted():
            raise AssertionError(f"descheduler: {len(early)} evicted early, {len(misplaced)} "
                                 f"reservations on their source node, {len(succeeded)} "
                                 f"succeeded against {evictor.total_evicted()} evictions")
        self.jobs = [(j.name, j.pod["name"], j.pod["node"], j.phase, j.reason,
                      j.reservation_name) for j in jobs]
        self.evicted = [(e.pod, e.namespace, e.node, e.reason) for e in evictor.evicted]
        self.reservations = sorted((r.name, r.phase, r.node) for r in rc.reservations.values())
        return {"planned_jobs": len(jobs), "tick_ms_host_wall": tick_ms,
                "source_nodes": len({j.pod["node"] for j in jobs}),
                "reservations": len(rc.reservations),
                "reserve_pods_placed": int((self.c.assignment >= 0).sum()) if self.c else 0,
                "evicted": evictor.total_evicted(), "succeeded": len(succeeded),
                "waiting": sum(1 for j in jobs if j.phase == mig.RUNNING),
                "pending_arbitration": sum(1 for j in jobs if j.phase == mig.PENDING),
                "reconcile_ms": reconcile_ms,
                "cycle_c": None if self.c is None else {
                    "encode_ms": self.c.encode_ms, "cycle_ms_host_wall": self.c.cycle_ms},
                "checks": "no eviction before its reservation is Available; every "
                          "reservation bound off its source node; evictions equal the "
                          "Succeeded jobs"}


# ---------------------------------------------------------------------------
# the daemons
# ---------------------------------------------------------------------------


def _healthz(port: int) -> Dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        return json.loads(r.read())


def _wait(what: str, predicate, timeout_s: float) -> float:
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(0.01)
    return _ms(t0)


def _new_threads(before) -> List[threading.Thread]:
    return [t for t in threading.enumerate() if t not in before and t.is_alive()]


def servers_leg(impl, base: str, view, node_dicts_fn: Callable):
    """``ManagerServer`` over ``view`` and a dry-run ``DeschedulerServer``
    (LowNodeLoad, one tick) over ``node_dicts_fn``, started together, each
    on its own lease file: elected, one tick, ``/healthz``, then both
    stopped with every thread they started ended."""
    before = set(threading.enumerate())
    servers = {
        "manager": (impl.manager_server.ManagerServer(
            view, lease_path=os.path.join(base, "manager-daemon.lease"),
            resync_seconds=3600.0), lambda s: s.reconciles),
        "descheduler": (impl.descheduler_server.DeschedulerServer(
            [lownodeload_profile(impl)], node_dicts_fn, lease_path=os.path.join(base, "descheduler.lease"),
            descheduling_interval=0.0, dry_run=True), lambda s: s.ticks),
    }
    out = {name: {} for name in servers}
    t0 = time.perf_counter()
    try:
        for server, _ in servers.values():
            server.start()
        for name, (server, ticked) in servers.items():
            out[name]["elected_ms"] = _wait(f"{name}: lease",
                                            lambda: server.elector.is_leader, SERVER_WAIT_S)
            out[name]["first_tick_ms"] = _wait(f"{name}: tick", lambda: ticked(server) >= 1,
                                               SERVER_WAIT_S)
            health = _healthz(server.http_port)
            if not health.get("leader") or not health.get("ok", True):
                raise AssertionError(f"{name}: /healthz {health}")
            out[name].update(ticks=ticked(server), healthz=health)
    finally:
        for name, (server, _) in servers.items():
            t1 = time.perf_counter()
            server.stop()
            out[name]["stop_ms"] = _ms(t1)
    # a request's handler thread may still be closing its connection
    try:
        _wait("servers: threads", lambda: not _new_threads(before), 5.0)
    except AssertionError:
        raise AssertionError("servers: threads alive after stop: "
                             f"{sorted(t.name for t in _new_threads(before))}") from None
    return {**out, "wall_ms": _ms(t0), "threads_after_stop": 0}
