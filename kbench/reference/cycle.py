"""The plain reference of what the window's replies must say.

Plain NumPy over the benchmark's own cluster model (``kbench/gen``): it reads
the cluster as the generator left it at a step and works out, from the
scheduler's published semantics, what the Score and the Assign replies of
that step must be.  It imports nothing of the program and takes nothing the
program made.

* **Score** (the Score plugin's stateless Filter + Score of every pending
  pod against every node, then its top-k): NodeResourcesFit (requests fit
  the node's free allocatable; LeastAllocated score over the non-zero
  requests), LoadAware (usage-threshold filter on fresh metrics; the
  LeastAllocated score of measured usage plus the pod's estimate, 0 on a
  stale metric), and, in a term configuration, the heterogeneity
  (throughput matrix), sensitivity (usage-weighted profile) and packing
  (MostAllocated) terms, each clamped to [0, weight * 100]; a term whose
  data the cluster lacks adds nothing, and packing needs none.  Every division
  is Go's int64 floor division.  The top-k is ordered by score, highest
  first, ties to the lower node index, and keeps feasible nodes only.
* **Assign** (one scheduling cycle): pods in queue order (priority
  highest first, then by slot), each Filtered and Scored against the node
  state the pods before it left (Reserve: their requests on the node and on
  their quota, their estimate on the node's LoadAware load), placed on the
  first best feasible node; the ElasticQuota admission on its declared
  dimensions; then the Coscheduling gate: a placed member of a gang with
  fewer placed members than its minimum waits (status 2).  The term scores
  and mask are those of the cycle's starting state.

Every pod slot of the synced cluster is a pending pod, empty slots
included (zero requests fit everywhere); the wire carries no validity flag.

The Score side is plain PyTorch on int64 tensors (on the card in a run, so
that a 10k x 2k Score takes milliseconds); the Assign's sequential loop is
NumPy on the host.  ``precision="float32"`` or ``"bfloat16"`` computes the
same function in that arithmetic (a division is ``floor(a / b)``; bfloat16
on the host rounds every operation's float32 result to bfloat16): the
benchmark's control (``kbench/control.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kbench.gen.cluster import RESOURCE_INDEX, R, ClusterModel

MAX_NODE_SCORE = 100
INT64_MIN = np.iinfo(np.int64).min
STATUS_ASSIGNED, STATUS_UNSCHEDULABLE, STATUS_WAIT_GANG = 0, 1, 2
# upstream GetNonzeroRequests defaults (milli-cpu, MiB) for the Fit score
NONZERO_REQUEST = {"cpu": 100, "memory": 200}
# bytes of one [rows, nodes] temporary the Score works in
CHUNK_BYTES = 64 << 20


def _vector(weights: Dict[str, int]) -> np.ndarray:
    out = np.zeros(R, np.int64)
    for name, w in weights.items():
        out[RESOURCE_INDEX[name]] = int(w)
    return out


class Semantics:
    """The plugin arguments of one cycle configuration: the scheduler's
    defaults (LoadAware weights cpu 1 memory 1, thresholds cpu 65 memory 95;
    NodeResourcesFit LeastAllocated, weights cpu 1 memory 1; both plugins
    weight 1), with the traffic file's ``cycle`` block on top: ``terms``
    turns on the three terms at weight 1 (packing weights cpu 1 memory 1),
    ``packing_headroom`` their packing mask."""

    def __init__(self, cycle: dict):
        unknown = set(cycle) - {"wave", "top_m", "terms", "packing_headroom"}
        if unknown:
            raise ValueError(f"the reference has no semantics for {sorted(unknown)}")
        self.fit_weights = _vector({"cpu": 1, "memory": 1})
        self.la_weights = _vector({"cpu": 1, "memory": 1})
        self.la_thresholds = _vector({"cpu": 65, "memory": 95})
        self.fit_plugin_weight = 1
        self.la_plugin_weight = 1
        self.terms = bool(cycle.get("terms", False))
        self.pack_weights = _vector({"cpu": 1, "memory": 1})
        self.headroom = _vector(dict(cycle.get("packing_headroom", {})))
        self.nonzero = _vector(NONZERO_REQUEST)


PRECISIONS = ("int64", "float32", "bfloat16")


def _round_bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


class _Arith:
    """The scorers' integer arithmetic over numpy arrays or torch tensors:
    exact int64 floor division, or a control's float arithmetic.  ``q``
    rounds a result to the precision where the array library has no such
    type (bfloat16 in numpy)."""

    def __init__(self, precision: str, lib):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.exact, self.lib = precision == "int64", lib
        self.q = _round_bf16 if (precision == "bfloat16" and lib is np) else (lambda x: x)
        if lib is np:
            self.dtype = {"int64": np.int64}.get(precision, np.float32)
        else:
            self.dtype = {"int64": torch.int64, "float32": torch.float32,
                          "bfloat16": torch.bfloat16}[precision]

    def div(self, a, b):
        return a // b if self.exact else self.q(self.lib.floor(a / b))

    def where(self, cond, a, b):
        return self.lib.where(cond, a, b)

    def least_requested(self, requested, capacity):
        empty = capacity == 0
        q = self.q
        score = self.div(q(q(capacity - requested) * MAX_NODE_SCORE), self.where(empty, 1, capacity))
        return self.where(empty | (requested > capacity), 0, score)

    def most_requested(self, requested, capacity):
        empty = capacity == 0
        capped = self.where(requested > capacity, capacity, requested)
        return self.where(empty, 0, self.div(self.q(capped * MAX_NODE_SCORE),
                                             self.where(empty, 1, capacity)))

    def percent(self, used, total):
        """round(used / total * 100) half away from zero; 0 where total is 0."""
        safe = self.where(total == 0, 1, total)
        q = self.q
        return self.where(total == 0, 0, self.div(q(q(200 * used) + safe), q(2 * safe)))


class Cluster:
    """One step's cluster, read from the generator's model, as tensors on
    ``device``: the stateless Filter and Score of every pod x node cell."""

    def __init__(self, model: ClusterModel, sem: Semantics, precision: str, device):
        self.sem, self.ar = sem, _Arith(precision, torch)
        dt = self.ar.dtype

        def t(a, dtype=dt):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        self.alloc, self.requested, self.usage = t(model.nalloc), t(model.nreq), t(model.nuse)
        self.fresh = t(model.fresh, torch.bool)
        self.preq, self.pest = t(model.preq), t(model.pest)
        self.sreq = t(np.where(model.preq == 0, sem.nonzero, model.preq))
        self.P, self.N = self.preq.shape[0], self.alloc.shape[0]
        # a term whose data the cluster lacks adds nothing; packing needs none
        self.het = self.sens = None
        if sem.terms and model.tput is not None:
            tput = np.asarray(model.tput, np.int64)
            C, A = tput.shape
            wclass = np.zeros(self.P, np.int64) if model.wclass is None else model.wclass
            accel = np.zeros(self.N, np.int64) if model.accel is None else model.accel
            self.het = (t(tput), t(np.clip(wclass, 0, C - 1), torch.int64),
                        t(np.clip(accel, 0, A - 1), torch.int64))
        if sem.terms and model.sens is not None:
            self.sens = t(model.sens)
        thr = t(sem.la_thresholds)
        pct = self.ar.percent(self.usage, self.alloc)
        exceeded = ((thr > 0) & (self.alloc > 0) & (pct >= thr)).any(dim=1)
        self.la_ok = ~exceeded | ~self.fresh

    def weighted(self, per_resource_of, weights: np.ndarray):
        """sum_r(score_r * w_r) // sum_r(w_r) over the weighted resources."""
        total = None
        for r in np.flatnonzero(weights):
            part = per_resource_of(int(r)) * int(weights[r])
            total = part if total is None else total + part
        if total is None:
            return 0
        return self.ar.div(total, int(weights.sum()))

    def chunks(self):
        step = max(1, CHUNK_BYTES // (8 * max(self.N, 1)))
        for start in range(0, self.P, step):
            yield slice(start, min(self.P, start + step))

    def terms(self, rows: slice):
        """(scores [rows, N], mask [rows, N] or None) of the enabled terms,
        against the cycle's starting state."""
        if not self.sem.terms:
            return None, None
        ar = self.ar
        # packing: MostAllocated of the placement
        out = self.weighted(lambda r: ar.most_requested(
            self.requested[None, :, r] + self.preq[rows, r][:, None], self.alloc[None, :, r]),
            self.sem.pack_weights).clamp(0, MAX_NODE_SCORE)
        if self.het is not None:
            tput, wclass, accel = self.het
            out = out + tput[wclass[rows][:, None], accel[None, :]].clamp(0, MAX_NODE_SCORE)
        if self.sens is not None:
            # sensitivity: the profile-weighted occupancy of the node
            empty = self.alloc == 0
            occ = ar.div(self.usage * MAX_NODE_SCORE, ar.where(empty, 1, self.alloc))
            occ = ar.where(empty, 0, occ.clamp(0, MAX_NODE_SCORE))
            s = self.sens[rows].clamp(0, MAX_NODE_SCORE)
            dot = (s[:, None, :] * occ[None, :, :]).sum(-1)
            contention = ar.div(dot, s.sum(-1).clamp(min=1)[:, None])
            out = out + (MAX_NODE_SCORE - contention).clamp(0, MAX_NODE_SCORE)
        mask = None
        head = self.sem.headroom
        if (head > 0).any():
            mask = torch.ones(out.shape, dtype=torch.bool, device=out.device)
            for r in np.flatnonzero(head > 0):
                post = self.requested[None, :, r] + self.preq[rows, r][:, None]
                mask &= post * 100 <= int(head[r]) * self.alloc[None, :, r]
        return out, mask

    def score_rows(self, rows: slice):
        """(scores [rows, N], feasible [rows, N]) of the Score plugin."""
        ar, sem = self.ar, self.sem
        preq = self.preq[rows]
        feasible = self.la_ok[None, :].expand(preq.shape[0], self.N).clone()
        for r in torch.nonzero((preq > 0).any(dim=0)).flatten().tolist():
            need = preq[:, r][:, None]
            feasible &= (need <= 0) | (self.requested[None, :, r] + need <= self.alloc[None, :, r])
        fit = self.weighted(lambda r: ar.least_requested(
            self.requested[None, :, r] + self.sreq[rows, r][:, None], self.alloc[None, :, r]),
            sem.fit_weights)
        la = self.weighted(lambda r: ar.least_requested(
            self.usage[None, :, r] + self.pest[rows, r][:, None], self.alloc[None, :, r]),
            sem.la_weights)
        scores = sem.fit_plugin_weight * fit + sem.la_plugin_weight * ar.where(
            self.fresh[None, :], la, 0)
        t_scores, t_mask = self.terms(rows)
        if t_scores is not None:
            scores = scores + t_scores
        if t_mask is not None:
            feasible &= t_mask
        return scores.expand(feasible.shape), feasible


def _top_k(scores: torch.Tensor, feasible: torch.Tensor, k: int):
    """(node [rows, k], ok [rows, k]): the k best cells of each row, by
    score (highest first) then node index (lowest first): one distinct int64
    key a cell, so the top-k has no ties."""
    n = scores.shape[1]
    idx = torch.arange(n, device=scores.device)
    key = torch.where(feasible, scores.long() + 1, 0) * n + (n - 1 - idx)
    top = torch.topk(key, min(k, n), dim=1, sorted=True).indices
    return top, torch.gather(feasible, 1, top)


def score_reply(model: ClusterModel, cycle: dict, top_k: int, precision: str = "int64",
                device="cpu"):
    """The flat Score reply (pod_index, counts, node_index, score) that the
    cluster in ``model`` must get, as numpy arrays."""
    c = Cluster(model, Semantics(cycle), precision, device)
    counts, nodes, values = [], [], []
    for rows in c.chunks():
        scores, feasible = c.score_rows(rows)
        idx, ok = _top_k(scores, feasible, top_k)
        counts.append(ok.sum(dim=1))
        nodes.append(idx[ok])
        values.append(torch.gather(scores, 1, idx)[ok].long())
    return (np.arange(c.P, dtype=np.int32), torch.cat(counts).cpu().numpy().astype(np.int32),
            torch.cat(nodes).cpu().numpy().astype(np.int32), torch.cat(values).cpu().numpy())


def assign_reply(model: ClusterModel, cycle: dict, precision: str = "int64", device="cpu"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Assign reply (assignment, status) that the cluster in ``model``
    must get: the term extras and the LoadAware mask on ``device``, the
    sequential loop in numpy."""
    sem = Semantics(cycle)
    c = Cluster(model, sem, precision, device)
    ar = _Arith(precision, np)
    dt, q = ar.dtype, ar.q
    extra_scores: Optional[np.ndarray] = None
    extra_mask: Optional[np.ndarray] = None
    if sem.terms:
        parts = [c.terms(rows) for rows in c.chunks()]
        extra_scores = torch.cat([s for s, _ in parts]).float().cpu().numpy().astype(dt)
        if parts[0][1] is not None:
            extra_mask = torch.cat([m for _, m in parts]).cpu().numpy()
    la_ok = c.la_ok.cpu().numpy()
    fresh = np.asarray(model.fresh, bool)
    preq = q(np.asarray(model.preq).astype(dt))
    pest = q(np.asarray(model.pest).astype(dt))
    sreq = q(np.where(model.preq == 0, sem.nonzero, model.preq).astype(dt))
    # node state as one contiguous column per resource
    alloc = [q(np.ascontiguousarray(model.nalloc[:, r]).astype(dt)) for r in range(R)]
    requested = [q(np.ascontiguousarray(model.nreq[:, r]).astype(dt)) for r in range(R)]
    usage = [q(np.ascontiguousarray(model.nuse[:, r]).astype(dt)) for r in range(R)]
    estimated = [np.zeros(c.N, dt) for _ in range(R)]
    qrt, quota_used = q(np.asarray(model.qrt).astype(dt)), q(np.asarray(model.quse).astype(dt))
    qlim = np.asarray(model.qlim) != 0
    Q = qrt.shape[0]
    fit_r, la_r = np.flatnonzero(sem.fit_weights), np.flatnonzero(sem.la_weights)
    fit_w, la_w = sem.fit_weights.astype(dt), sem.la_weights.astype(dt)
    fit_sum, la_sum = dt(fit_w.sum()), dt(la_w.sum())
    floor = INT64_MIN if ar.exact else -np.inf
    priority = np.asarray(model.priority, np.int64)
    quota_id = np.asarray(model.quota_id, np.int64)
    assignment = np.full(c.P, -1, np.int32)
    for p in sorted(range(c.P), key=lambda i: (-int(priority[i]), i)):
        req, qid = preq[p], int(quota_id[p])
        if 0 <= qid < Q and not ((q(quota_used[qid] + req) <= qrt[qid]) | ~qlim[qid]).all():
            continue
        feasible = la_ok.copy()
        for r in np.flatnonzero(req > 0):
            feasible &= q(requested[r] + req[r]) <= alloc[r]
        if extra_mask is not None:
            feasible &= extra_mask[p]
        if not feasible.any():
            continue
        fit = la = 0
        for r in fit_r:
            fit = q(fit + q(ar.least_requested(q(requested[r] + sreq[p, r]), alloc[r]) * fit_w[r]))
        for r in la_r:
            used = q(q(usage[r] + estimated[r]) + pest[p, r])
            la = q(la + q(ar.least_requested(used, alloc[r]) * la_w[r]))
        total = q(sem.fit_plugin_weight * ar.div(fit, fit_sum)
                  + sem.la_plugin_weight * np.where(fresh, ar.div(la, la_sum), 0))
        if extra_scores is not None:
            total = q(total + extra_scores[p])
        node = int(np.argmax(np.where(feasible, total, floor)))
        assignment[p] = node
        for r in range(R):
            requested[r][node] = q(requested[r][node] + req[r])
            estimated[r][node] = q(estimated[r][node] + pest[p, r])
        if 0 <= qid < Q:
            quota_used[qid] = q(quota_used[qid] + req)
    return assignment, gang_status(assignment, np.asarray(model.gang_id, np.int64),
                                   np.asarray(model.gang_min, np.int64))


def gang_status(assignment: np.ndarray, gang_id: np.ndarray, gang_min: np.ndarray):
    """Placed 0, unplaced 1, placed in a gang below its minimum 2."""
    status = np.where(assignment >= 0, STATUS_ASSIGNED, STATUS_UNSCHEDULABLE).astype(np.int32)
    G = gang_min.shape[0]
    placed = assignment >= 0
    in_gang = (gang_id >= 0) & (gang_id < G)
    counts = np.bincount(gang_id[in_gang & placed], minlength=G)
    short = np.zeros(assignment.shape, bool)
    short[in_gang] = counts[gang_id[in_gang]] < gang_min[gang_id[in_gang]]
    status[placed & short] = STATUS_WAIT_GANG
    return status
