"""The plain reference of the co-location configuration
(``kbench/configs/koord_colocation_4034n.json``): what every Score and
Assign reply of its cells must say, worked out from Koordinator's published
plugin semantics over the benchmark's own model of the cluster
(``kbench/gen/tenants.py``).  It imports nothing of the program and takes
nothing the program made.  These arguments are the ones
``kbench/reference/cycle.py`` computes with its defaults, so the replies
are that reference's (PyTorch int64 for the Score, NumPy for the Assign's
sequential loop), imported, not edited; :class:`Semantics` refuses a
``cycle`` block that would take it elsewhere.

This configuration's plugin arguments:

* **NodeResourcesFit**: Filter over all 13 resources of the wire's axis (a
  pod fits a node where, for every resource it requests, the node's
  requested plus the request is within its allocatable: ``cpu``,
  ``memory`` and ``pods`` for the prod band, the ``kubernetes.io/batch-*``
  slots for the batch band, the ``kubernetes.io/mid-*`` slots for the mid
  band); Score LeastAllocated over ``cpu`` and ``memory``, weight 1 each,
  a zero request counted as upstream's non-zero default (100m, 200Mi).
* **LoadAware**: Filter on the node's reported usage at thresholds cpu 65 %
  and memory 95 % (a stale metric passes); Score LeastAllocated of the
  usage plus the estimates of the pods placed this cycle plus the pod's own
  estimate, weight 1 each, 0 on a stale metric.  The estimate is
  ``defaultEstimator``'s, scaled cpu 85 % and memory 70 %, read through
  the band's slot (a batch pod's ``batch-cpu`` stands for its cpu): the
  generator computes it (``kbench/gen/cluster.py estimate_pod``) and the
  Sync carries it.
* **ElasticQuota**: a pod of a group is admitted where, on every resource
  the group limits, the group's used plus the pod's request is within its
  runtime; an admitted pod's request joins the group's used at once.
* **Coscheduling**: after the cycle, a placed member of a PodGroup with
  fewer placed members than its ``minMember`` waits (status 2).

Pods go in queue order, priority highest first, then by slot.

Where this departs from the Go plugins:

* The Coscheduling gate is applied once, after the whole cycle.  In the Go
  scheduler the placed members of a gang wait at Permit holding what they
  reserved, and are released when the gang times out or is rejected; here
  they keep their node capacity and their group's quota for the rest of
  the cycle, and the bind loop binds none of them.
* The ElasticQuota runtime is taken as the Sync states it; the quota
  tree's fair division between groups (min, max, shared weight) is the
  quota manager's and is not recomputed per pod.
* LoadAware's usage is the reported NodeMetric, constant over the run (the
  trace's usage, not the placed pods'), with no aggregated percentiles and
  no prod-only thresholds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from kbench.gen.cluster import ClusterModel
from kbench.reference import cycle as _cycle
from kbench.reference.cycle import (
    STATUS_ASSIGNED,
    STATUS_UNSCHEDULABLE,
    STATUS_WAIT_GANG,
    _vector,
)

LOADAWARE_THRESHOLDS = {"cpu": 65, "memory": 95}
LOADAWARE_WEIGHTS = {"cpu": 1, "memory": 1}
FIT_WEIGHTS = {"cpu": 1, "memory": 1}
NONZERO_REQUEST = {"cpu": 100, "memory": 200}


class Semantics(_cycle.Semantics):
    """This configuration's plugin arguments (the module's docstring) for
    a traffic file's ``cycle`` block: ``wave`` and ``top_m`` change how the
    program runs the cycle, never its result; it states no fused term."""

    def __init__(self, cycle: dict):
        unknown = set(cycle) - {"wave", "top_m"}
        if unknown:
            raise ValueError(f"the co-location reference has no semantics for {sorted(unknown)}")
        super().__init__(cycle)
        stated = {"la_thresholds": LOADAWARE_THRESHOLDS, "la_weights": LOADAWARE_WEIGHTS,
                  "fit_weights": FIT_WEIGHTS, "nonzero": NONZERO_REQUEST}
        for name, want in stated.items():
            if not np.array_equal(getattr(self, name), _vector(want)):
                raise ValueError(f"the cycle reference's {name} is not this configuration's")


def score_reply(model: ClusterModel, cycle: dict, top_k: int, precision: str = "int64",
                device="cpu"):
    """The flat Score reply (pod_index, counts, node_index, score) that the
    cluster in ``model`` must get, as numpy arrays: every pending pod's
    Filter and Score against every node, its ``top_k`` feasible nodes."""
    Semantics(cycle)
    return _cycle.score_reply(model, cycle, top_k, precision, device)


def assign_reply(model: ClusterModel, cycle: dict, precision: str = "int64", device="cpu"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Assign reply (assignment, status) that the cluster in ``model``
    must get: one scheduling cycle in queue order, each pod admitted by its
    group, Filtered and Scored against the state the pods before it left,
    placed on the first best node; then the Coscheduling gate."""
    Semantics(cycle)
    return _cycle.assign_reply(model, cycle, precision, device)


def cycle_counts(model: ClusterModel, assignment: np.ndarray, status: np.ndarray) -> dict:
    """What one cycle's reply counts, by this reference's model: pending
    pods placed (status 0), unschedulable (1) and held by their gang (2);
    the PodGroups with a held member (``gangs_held``); and the pods left
    unschedulable whose group, with the requests of every pod the cycle
    placed charged, lacks room for the pod's request in a dimension the
    group limits (``quota_bound``)."""
    assignment, status = np.asarray(assignment), np.asarray(status)
    used = np.asarray(model.quse, np.int64).copy()
    qid = np.asarray(model.quota_id, np.int64)
    charged = (assignment >= 0) & (qid >= 0)
    np.add.at(used, qid[charged], model.preq[charged])
    short = np.zeros(status.shape, bool)
    if used.shape[0]:
        q = np.clip(qid, 0, None)
        short = ((used[q] + model.preq > model.qrt[q]) & (model.qlim[q] != 0)).any(axis=1)
    gid = np.asarray(model.gang_id, np.int64)
    return {
        "placed": int((status == STATUS_ASSIGNED).sum()),
        "unschedulable": int((status == STATUS_UNSCHEDULABLE).sum()),
        "wait_gang": int((status == STATUS_WAIT_GANG).sum()),
        "gangs_held": int(np.unique(gid[(status == STATUS_WAIT_GANG) & (gid >= 0)]).shape[0]),
        "quota_bound": int(((status == STATUS_UNSCHEDULABLE) & (qid >= 0) & short).sum()),
    }
