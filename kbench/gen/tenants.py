"""A co-location cluster in Kubernetes' and Koordinator's own objects, and
its closed bind loop: a second generator, for configurations that name it
(``"generator": "kbench/gen/tenants.py"``).

A configuration file states:

* ``node_groups``: as ``kbench/gen/cluster.py`` reads them; ``allocatable``
  may hold the batch and mid slots (``kubernetes.io/batch-cpu``, ...);
* ``pod_templates``: a list; each has a ``name``, a ``share`` of the
  pending queue (the shares sum to 1), ``requests`` and ``limits``, a
  ``band`` (``koord-prod``, ``koord-mid``, ``koord-batch``, ``koord-free``,
  or null) with a ``priority`` in that band's range, an optional ``quota``
  (an ElasticQuota group's name) and an optional ``gang_size`` (a PodGroup
  whose ``minMember`` is its size);
* ``quotas``: each ElasticQuota group's ``name``, its ``runtime`` per
  resource as the plugin's quota manager sends it, and ``limited``, the
  resources it declares (by default those of ``runtime``);
* ``init_pods`` (bound before the first cycle, of the templates by their
  shares, one a node over nodes the seed draws) and ``pending_pods``;
* ``node_metrics``: as ``kbench/gen/cluster.py`` reads them.

The queue is a fixed number of pod slots of each template: its share of
``pending_pods`` rounded by largest remainder, a whole number of gangs for
a gang template.  :class:`BindLoop` closes the loop after each Assign:

* a placed pod (status 0) binds: its requests join its node's requested
  and its group's ``used``; a gang binds whole, each member placed, or not
  at all;
* a pod refused, or held by its gang (status 1 or 2), stays pending;
* the slots of what bound are refilled together, each unit (a pod, or a
  gang with its PodGroup) of a template drawn from the seed among the
  units that left, so every template keeps its count in the queue;
* a bound unit runs for a number of cycles drawn from the seed, uniform
  over ``lifetime_steps``, then is deleted: its requests leave the node
  and the group.

The seed changes which nodes and slots hold what, never how much.  The
Sync carries the changed node and pod rows, ``gang_id``, ``quota_id`` and
``quota_used``.  Imports numpy and the generator's shared pieces
(``kbench/gen/cluster.py``), nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from kbench.gen import cluster
from kbench.gen.cluster import RESOURCE_INDEX, R, ClusterModel, _vector, estimate_pod
# the cold Sync states the whole cluster, quotas and PodGroups with it, as there
from kbench.gen.cluster import full_sync_kwargs  # noqa: F401

# Koordinator's priority classes (apis/extension/priority.go)
BAND_PRIORITY = {"koord-prod": (9000, 9999), "koord-mid": (7000, 7999),
                 "koord-batch": (5000, 5999), "koord-free": (3000, 3999)}


def _counts(shares: List[float], total: int) -> np.ndarray:
    """``total`` split by ``shares`` (largest remainder): each count within
    one of its share."""
    exact = np.asarray(shares, np.float64) * total
    counts = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[: total - int(counts.sum())]] += 1
    return counts


class Deployment:
    """A configuration file's co-location cluster, read once."""

    def __init__(self, config: dict):
        self.groups = [(int(g["count"]), _vector(g["allocatable"])) for g in config["node_groups"]]
        self.nodes = sum(count for count, _ in self.groups)
        self.quota_names = [q["name"] for q in config.get("quotas", [])]
        Q = len(self.quota_names)
        self.qrt = np.zeros((Q, R), np.int64)
        self.qlim = np.zeros((Q, R), np.int64)
        for i, q in enumerate(config.get("quotas", [])):
            self.qrt[i] = _vector(q["runtime"])
            for name in q.get("limited", list(q["runtime"])):
                self.qlim[i, RESOURCE_INDEX[name]] = 1
        templates = config["pod_templates"]
        shares = [float(t["share"]) for t in templates]
        if abs(sum(shares) - 1.0) > 1e-9:
            raise ValueError(f"the pod templates' shares sum to {sum(shares)}, not 1")
        self.names = [t["name"] for t in templates]
        self.req = np.asarray([_vector(t["requests"]) for t in templates], np.int64)
        self.est = np.asarray([estimate_pod(list(self.req[i]), _vector(t.get("limits", t["requests"])),
                                            t.get("band")) for i, t in enumerate(templates)],
                              np.int64)
        self.priority = np.asarray([int(t.get("priority", 0)) for t in templates], np.int64)
        self.quota = np.asarray([self.quota_names.index(t["quota"]) if t.get("quota") else -1
                                 for t in templates], np.int64)
        self.size = np.asarray([int(t.get("gang_size", 1)) for t in templates], np.int64)
        self.gang = np.asarray([t.get("gang_size") is not None for t in templates])
        for t, prio in zip(templates, self.priority):
            band = t.get("band")
            if band is not None and not BAND_PRIORITY[band][0] <= prio <= BAND_PRIORITY[band][1]:
                raise ValueError(f"template {t['name']!r}: priority {prio} is not in "
                                 f"{band}'s range {BAND_PRIORITY[band]}")
        self.pending_pods = int(config["pending_pods"])
        self.slots = _counts(shares, self.pending_pods)
        bad = [self.names[i] for i in range(len(templates)) if self.slots[i] % self.size[i]]
        if bad:
            raise ValueError(f"share x pending_pods is not a whole number of gangs for {bad}: "
                             f"{dict(zip(self.names, self.slots.tolist()))}")
        self.units = self.slots // self.size
        # PodGroup g belongs to template owner[g] for good: gang_min never changes
        self.owner = np.repeat(np.flatnonzero(self.gang), self.units[self.gang])
        self.init_pods = int(config["init_pods"])
        self.init_of = _counts(shares, self.init_pods)
        metrics = config["node_metrics"]
        self.metrics_reported = bool(metrics["reported"])
        self.usage = np.asarray(_vector(metrics.get("usage", {})), np.int64)


def _lay(d: Deployment, model: ClusterModel, slots: np.ndarray, units: np.ndarray,
         gangs: np.ndarray) -> None:
    """Units of the templates ``units``, in that order, over the sorted
    ``slots``; the gang units of a template take its PodGroups ``gangs``
    holds (in their order), one each."""
    gid = np.full(units.shape[0], -1, np.int64)
    for t in np.flatnonzero(d.gang):
        gid[units == t] = gangs[d.owner[gangs] == t]
    rows = np.repeat(units, d.size[units])
    model.template[slots] = rows
    model.preq[slots], model.pest[slots] = d.req[rows], d.est[rows]
    model.priority[slots], model.quota_id[slots] = d.priority[rows], d.quota[rows]
    model.gang_id[slots] = np.repeat(gid, d.size[units])


def build(config: dict, seed: int) -> ClusterModel:
    """The starting cluster of ``config`` from ``seed``: the Sync's arrays,
    with each slot's template (``template``) and the configuration
    (``deployment``) beside them."""
    d = Deployment(config)
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.tile(np.asarray(a, np.int64), (count, 1)) for count, a in d.groups])
    nalloc = rows[rng.permutation(d.nodes)]
    # init pods of the templates by share, one a node over seeded nodes
    order = rng.permutation(d.nodes)
    init_t = rng.permutation(np.repeat(np.arange(len(d.names)), d.init_of))
    nodes_of = order[np.arange(d.init_pods) % d.nodes]
    nreq = np.zeros((d.nodes, R), np.int64)
    np.add.at(nreq, nodes_of, d.req[init_t])
    quse = np.zeros_like(d.qrt)
    held = d.quota[init_t] >= 0
    np.add.at(quse, d.quota[init_t][held], d.req[init_t][held])
    P = d.pending_pods
    model = ClusterModel(nalloc, nreq, np.tile(d.usage, (d.nodes, 1)),
                         np.full(d.nodes, d.metrics_reported), np.zeros((P, R), np.int64),
                         np.zeros((P, R), np.int64), np.zeros(P, np.int64))
    model.deployment, model.template = d, np.zeros(P, np.int64)
    model.gang_min = d.size[d.owner]
    model.qrt, model.quse, model.qlim = d.qrt, quse, d.qlim
    units = rng.permutation(np.repeat(np.arange(len(d.names)), d.units))
    _lay(d, model, np.arange(P), units, np.arange(d.owner.shape[0]))
    return model


class BindLoop:
    """Reserve and Bind after each Assign, and the deletions of the loop
    (see the module's docstring)."""

    def __init__(self, model: ClusterModel, lifetime_steps, seed: int):
        self.lo, self.hi = (int(v) for v in lifetime_steps)
        if not 1 <= self.lo <= self.hi:
            raise ValueError(f"lifetime_steps must be [lo, hi] with 1 <= lo <= hi, "
                             f"got {lifetime_steps}")
        self.rng = np.random.default_rng([seed, 1])
        self.deployment = model.deployment
        self.leaving: Dict[int, tuple] = {}
        self.cycle = 0
        self.bound = 0

    def after_assign(self, model: ClusterModel, assignment, status) -> ClusterModel:
        """The cluster the next Sync states, given one Assign reply; the
        model of this step is left as it was."""
        d = self.deployment
        P = model.preq.shape[0]
        assignment = np.asarray(assignment, np.int64)
        ok = ((np.asarray(status) == 0) & (assignment >= 0)
              & (assignment < model.nalloc.shape[0]))
        # a unit is a gang's members or a lone pod's slot; it binds whole
        unit = np.where(model.gang_id >= 0, model.gang_id, model.gang_min.shape[0] + np.arange(P))
        _, inverse = np.unique(unit, return_inverse=True)
        whole = np.bincount(inverse, weights=(~ok).astype(np.float64)) == 0
        placed = np.flatnonzero(whole[inverse])
        self.cycle += 1
        out = model.snapshot()
        if placed.size:
            units, first = np.unique(inverse[placed], return_index=True)
            lifetime = self.rng.integers(self.lo, self.hi + 1, units.shape[0])
            life_of = lifetime[np.searchsorted(units, inverse[placed])]
            nodes, reqs, qids = assignment[placed], model.preq[placed], model.quota_id[placed]
            out.nreq = model.nreq.copy()
            out.quse = model.quse.copy()
            np.add.at(out.nreq, nodes, reqs)
            held = qids >= 0
            np.add.at(out.quse, qids[held], reqs[held])
            for span in np.unique(life_of):
                pick = life_of == span
                node_out, quota_out = self.leaving.setdefault(
                    self.cycle + int(span), (np.zeros_like(out.nreq), np.zeros_like(out.quse)))
                np.add.at(node_out, nodes[pick], reqs[pick])
                np.add.at(quota_out, qids[pick & held], reqs[pick & held])
            # the units that left, refilled from the seed over their slots
            freed, gangs = model.template[placed[first]], model.gang_id[placed[first]]
            for key in ("template", "preq", "pest", "priority", "quota_id", "gang_id"):
                setattr(out, key, getattr(model, key).copy())
            _lay(d, out, placed, self.rng.permutation(freed), gangs[gangs >= 0])
            self.bound += int(placed.shape[0])
        gone = self.leaving.pop(self.cycle, None)
        if gone is not None:
            out.nreq, out.quse = out.nreq - gone[0], out.quse - gone[1]
        return out


def sync_kwargs(before: ClusterModel, after: ClusterModel) -> dict:
    """The warm Sync from ``before`` to ``after``: ``kbench/gen/cluster.py``'s
    changed columns, and the groups' ``used`` and the slots' PodGroups and
    groups where they changed."""
    kw = cluster.sync_kwargs(before, after)
    if after.quse is not before.quse:
        kw["quota_used"] = after.quse
    for key in ("gang_id", "quota_id"):
        if getattr(after, key) is not getattr(before, key):
            kw[key] = [int(v) for v in getattr(after, key)]
    return kw


def running_band(config: dict, traffic: dict):
    """The running pods a window holds at every cycle.  Not every pending
    pod binds (quotas refuse, gangs wait), so the mean is not known from
    the counts: the traffic file's ``running_pods`` [lo, hi] where it
    states one, else the hard bounds, the init pods and the init pods and
    a full queue bound in each of the last ``lifetime_steps[1]`` cycles."""
    if "running_pods" in traffic:
        lo, hi = traffic["running_pods"]
        return int(lo), int(hi)
    init, pending = int(config["init_pods"]), int(config["pending_pods"])
    return init, init + pending * int(traffic["lifetime_steps"][1])
