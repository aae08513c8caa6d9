"""The benchmark's traffic: a seeded cluster and the closed bind loop.

A configuration file (``kbench/configs/<config>.json``) states a deployment
as its source defines it: node groups (count and allocatable), the pod
template of the pods it schedules (requests, limits, priority), how many
pods are bound before measuring (``init_pods``) and how many are pending in
each scheduling cycle (``pending_pods``), and whether the nodes report
usage metrics.  A traffic file (``kbench/traffic/<cell>.json``) states the
loop: ``lifetime_steps``, how many steps a bound batch stays running before
its pods are deleted.

One general generator reads both:

* :func:`build` makes the starting cluster from the seed.  Node groups are
  laid out in a seeded order; the init pods start bound, spread one a node
  (as a LeastAllocated scheduler spreads them) over nodes the seed draws;
  every one of the ``pending_pods`` pod slots holds a pending pod of the
  template.  The seed changes which nodes hold what, never how much: every
  seed gives the same sizes and the same work, in another order.
* :class:`BindLoop` closes the loop after each Assign as the Go plugin's
  Reserve and Bind would: a placed pod binds (its requests join its node's
  requested) and leaves the pending queue; a new pending pod of the
  template takes its slot, so the queue stays full; the batch bound
  ``lifetime_steps`` steps before is deleted (its requests leave the
  nodes).  The next Sync carries what changed.

Imports numpy only: the yardstick must not move when the program does.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional

import numpy as np

# the dense resource axis of the wire (``model/resources.py RESOURCE_AXIS``)
RESOURCES = (
    "cpu", "memory", "ephemeral-storage", "pods",
    "kubernetes.io/batch-cpu", "kubernetes.io/batch-memory",
    "kubernetes.io/mid-cpu", "kubernetes.io/mid-memory",
    "koordinator.sh/gpu-core", "koordinator.sh/gpu-memory-ratio",
    "koordinator.sh/gpu-memory", "koordinator.sh/rdma", "koordinator.sh/fpga",
)
R = len(RESOURCES)
RESOURCE_INDEX = {name: i for i, name in enumerate(RESOURCES)}
_CPU = RESOURCE_INDEX["cpu"]
_MEM = RESOURCE_INDEX["memory"]

# ---- the pod estimator (``model/snapshot.py estimate_pod``), copied ----

_PROD, _MID, _BATCH, _FREE, _NONE = range(5)
_CLASS_OF_BAND = {"koord-prod": _PROD, "koord-mid": _MID,
                  "koord-batch": _BATCH, "koord-free": _FREE}
_TRANSLATION = {
    _BATCH: {_CPU: RESOURCE_INDEX["kubernetes.io/batch-cpu"],
             _MEM: RESOURCE_INDEX["kubernetes.io/batch-memory"]},
    _MID: {_CPU: RESOURCE_INDEX["kubernetes.io/mid-cpu"],
           _MEM: RESOURCE_INDEX["kubernetes.io/mid-memory"]},
}
_ESTIMATOR_WEIGHTS = ("cpu", "memory")
_SCALING = {"cpu": 85, "memory": 70}
# the estimator's default by the slot it reads: a mid slot has none
_DEFAULT_REQUEST = {"cpu": 250, "kubernetes.io/batch-cpu": 250,
                    "memory": 200, "kubernetes.io/batch-memory": 200}


def _estimated_used(request: int, limit: int, default: int, factor: int) -> int:
    if limit > request:
        factor, quantity = 100, limit
    else:
        quantity = request
    if quantity == 0:
        return default
    estimated = int(math.floor(quantity * factor / 100 + 0.5))
    if limit > 0 and estimated > limit:
        estimated = limit
    return estimated


def estimate_pod(req: List[int], lim: List[int], band: Optional[str]) -> List[int]:
    """defaultEstimator.EstimatePod in the dense form of the port's
    ``estimate_pod``: the weighted native slots, read through the band's
    translated slot."""
    pc = _CLASS_OF_BAND.get(band or "", _NONE)
    out = [0] * R
    for name in _ESTIMATOR_WEIGHTS:
        idx = RESOURCE_INDEX[name]
        real = _TRANSLATION.get(pc, {}).get(idx, idx)
        out[idx] = _estimated_used(req[real], lim[real],
                                   _DEFAULT_REQUEST.get(RESOURCES[real], 0), _SCALING[name])
    return out


def _vector(quantities: Dict[str, int]) -> List[int]:
    out = [0] * R
    for name, v in quantities.items():
        out[RESOURCE_INDEX[name]] = int(v)
    return out


# ---- the cluster ----


class ClusterModel:
    """One step's cluster as the Sync states it: numpy arrays the loop
    replaces, never writes into, so that a kept step's model stays as it
    was (:meth:`snapshot`)."""

    def __init__(self, nalloc, nreq, nuse, fresh, preq, pest, priority, quota_rows: int = 0):
        self.nalloc, self.nreq, self.nuse = nalloc, nreq, nuse
        self.fresh = fresh
        self.preq, self.pest, self.priority = preq, pest, priority
        P = preq.shape[0]
        self.gang_id = np.full(P, -1, np.int64)
        self.gang_min = np.zeros(0, np.int64)
        self.quota_id = np.full(P, -1, np.int64)
        self.qrt = np.zeros((quota_rows, R), np.int64)
        self.quse = np.zeros((quota_rows, R), np.int64)
        self.qlim = np.zeros((quota_rows, R), np.int64)
        # no fused-term tensors: the reference reads these as absent
        self.tput = self.sens = self.accel = self.wclass = None

    def snapshot(self) -> "ClusterModel":
        out = object.__new__(ClusterModel)
        out.__dict__.update(self.__dict__)
        return out

    def pending_pods(self) -> int:
        """Pod slots that hold a pending pod: a non-zero request."""
        return int(self.preq.any(axis=1).sum())

    def running_pods(self) -> int:
        """Pods bound to nodes, counted by the ``pods`` resource."""
        return int(self.nreq[:, RESOURCE_INDEX["pods"]].sum())


def full_sync_kwargs(model: ClusterModel) -> dict:
    """The cold Sync: the whole cluster."""
    return dict(
        node_allocatable=model.nalloc, node_requested=model.nreq,
        node_usage=model.nuse, metric_fresh=[bool(b) for b in model.fresh],
        pod_requests=model.preq, pod_estimated=model.pest,
        priority=[int(v) for v in model.priority], gang_id=[int(v) for v in model.gang_id],
        quota_id=[int(v) for v in model.quota_id],
        gang_min_member=[int(v) for v in model.gang_min],
        quota_runtime=model.qrt, quota_used=model.quse, quota_limited=model.qlim,
    )


class Deployment:
    """A configuration file's cluster, read once."""

    def __init__(self, config: dict):
        self.groups = [(int(g["count"]), _vector(g["allocatable"])) for g in config["node_groups"]]
        self.nodes = sum(count for count, _ in self.groups)
        pod = config["pod_template"]
        self.pod_req = np.asarray(_vector(pod["requests"]), np.int64)
        lim = _vector(pod.get("limits", pod["requests"]))
        self.pod_est = np.asarray(estimate_pod(list(self.pod_req), lim, pod.get("band")), np.int64)
        self.pod_priority = int(pod.get("priority", 0))
        self.init_pods = int(config["init_pods"])
        self.pending_pods = int(config["pending_pods"])
        metrics = config["node_metrics"]
        self.metrics_reported = bool(metrics["reported"])
        self.usage = np.asarray(_vector(metrics.get("usage", {})), np.int64)


def build(config: dict, seed: int) -> ClusterModel:
    """The starting cluster of ``config`` from ``seed``."""
    d = Deployment(config)
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.tile(np.asarray(a, np.int64), (count, 1)) for count, a in d.groups])
    nalloc = rows[rng.permutation(d.nodes)]
    # init pods: one a node over seeded nodes, round after round
    order = rng.permutation(d.nodes)
    per_node = np.bincount(order[np.arange(d.init_pods) % d.nodes], minlength=d.nodes)
    nreq = per_node[:, None] * d.pod_req[None, :]
    nuse = np.tile(d.usage, (d.nodes, 1))
    fresh = np.full(d.nodes, d.metrics_reported)
    P = d.pending_pods
    preq = np.tile(d.pod_req, (P, 1))
    pest = np.tile(d.pod_est, (P, 1))
    priority = np.full(P, d.pod_priority, np.int64)
    return ClusterModel(nalloc, nreq, nuse, fresh, preq, pest, priority)


class BindLoop:
    """Reserve and Bind after each Assign, and the deletions of the loop
    (see the module's docstring).  Each bound pod runs for a number of
    cycles drawn from the seed, uniform over ``lifetime_steps`` (both ends
    included), then is deleted before the next cycle.  A pod bound after
    cycle ``c`` with lifetime 1 is on its node in cycle ``c + 1`` only."""

    def __init__(self, model: ClusterModel, lifetime_steps, seed: int):
        self.lo, self.hi = (int(v) for v in lifetime_steps)
        if not 1 <= self.lo <= self.hi:
            raise ValueError(f"lifetime_steps must be [lo, hi] with 1 <= lo <= hi, "
                             f"got {lifetime_steps}")
        self.rng = np.random.default_rng([seed, 1])
        self.running = model.nreq
        self.leaving: Dict[int, np.ndarray] = {}
        self.cycle = 0
        self.bound = 0

    def after_assign(self, model: ClusterModel, assignment, status) -> ClusterModel:
        """The cluster the next Sync states, given one Assign reply; the
        model of this step is left as it was."""
        assignment = np.asarray(assignment, np.int64)
        # a node the cluster does not have binds nothing (the program's
        # reply is judged after the window, not here)
        placed = np.flatnonzero((np.asarray(status) == 0) & (assignment >= 0)
                                & (assignment < model.nalloc.shape[0]) & model.preq.any(axis=1))
        lifetime = self.rng.integers(self.lo, self.hi + 1, placed.shape[0])
        running = self.running.copy()
        np.add.at(running, assignment[placed], model.preq[placed])
        for span in np.unique(lifetime):
            pods = placed[lifetime == span]
            # runs in cycles c+1 .. c+span, deleted before cycle c+span+1
            out = self.leaving.setdefault(self.cycle + 1 + int(span), np.zeros_like(running))
            np.add.at(out, assignment[pods], model.preq[pods])
        self.cycle += 1
        self.bound += int(placed.shape[0])
        gone = self.leaving.pop(self.cycle, None)
        if gone is not None:
            running -= gone
        self.running = running
        # every pending pod is of the template, so the pod that takes a bound
        # pod's slot leaves the queue's rows as they were
        out = model.snapshot()
        out.nreq = running
        return out


def sync_kwargs(before: ClusterModel, after: ClusterModel) -> dict:
    """The warm Sync from ``before`` to ``after``: the changed columns,
    whole (the client delta-encodes them against its acked baseline)."""
    kw: Dict[str, object] = {}
    for key, wire in (("nalloc", "node_allocatable"), ("nreq", "node_requested"),
                      ("nuse", "node_usage"), ("preq", "pod_requests"),
                      ("pest", "pod_estimated")):
        if getattr(after, key) is not getattr(before, key):
            kw[wire] = getattr(after, key)
    if after.priority is not before.priority:
        kw["priority"] = [int(v) for v in after.priority]
    return kw
