"""Sequential greedy assignment: the port's oracle for the cycle kernel.

Counterpart of ``koordinator_tpu/solver/greedy.py``.  The reference
schedules one pod at a time (PreFilter -> Filter -> Score -> Reserve, the
next pod seeing the previous pod's Reserve); ``greedy_assign`` reproduces
that with an eager loop over pods in queue order, carrying (node_requested,
node_estimated, quota_used).  It runs on any device and is what the CUDA
cycle kernel is held against.

Queue order follows the Coscheduling QueueSort (``coscheduling.go:118``):
higher priority first, then stable by index; padding last.  Gang
all-or-nothing (Permit, ``coscheduling/core/core.go:308``) is applied after
the loop: pods of a gang below minMember are marked WAIT_GANG.

``score_all`` is the one statement of the stateless Filter+Score of every
(pod, node) cell, the Score RPC's tensor program (``score_cycle``): every
term reads one pod row and one node row, so the incremental rescore and
the sparse candidate engine get the same bits from gathered rows.  Node
tables are [N, ...] or rows gathered per pod ([P, C, ...]); the pod side
broadcasts as ``[P, 1, ...]``.  Pod rows are computed in chunks
(``by_pod_rows``), which bounds the [rows, N, R] temporaries and changes no
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from koordinator_tpu_torch.config import (
    DEFAULT_CYCLE_CONFIG,
    MOST_ALLOCATED,
    CycleConfig,
)
from koordinator_tpu_torch.constraints.gang import gang_satisfaction
from koordinator_tpu_torch.model.snapshot import MAX_NODE_SCORE, ClusterSnapshot, PriorityClass
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.obs.spans import stage
from koordinator_tpu_torch.ops.fit import fit_mask, nonzero_requests
from koordinator_tpu_torch.ops.loadaware import (
    loadaware_node_masks,
    select_score_usage,
)
from koordinator_tpu_torch.ops.scoring import (
    least_requested_score,
    most_requested_score,
    weighted_resource_score,
)

STATUS_ASSIGNED = 0
STATUS_UNSCHEDULABLE = 1
STATUS_WAIT_GANG = 2

INT64_MIN = torch.iinfo(torch.int64).min
INT64_MAX = torch.iinfo(torch.int64).max

# bytes of one [rows, cells, R] int64 temporary of the Score program; at 10k
# pods x 2k nodes one unchunked temporary is 2.08 GB
CHUNK_BYTES = 512 << 20


@dataclasses.dataclass(frozen=True)
class CycleResult:
    assignment: torch.Tensor  # i32[P] node index, -1 = none
    status: torch.Tensor  # i32[P]
    node_requested: Optional[torch.Tensor] = None  # i64[N, R] post-cycle
    node_estimated: Optional[torch.Tensor] = None  # i64[N, R] post-cycle
    quota_used: Optional[torch.Tensor] = None  # i64[Q, R] post-cycle
    # sequential wave rounds of a wave-batched cycle; None for a per-pod one
    rounds: Optional[torch.Tensor] = None
    # which code path produced the result: "cuda" (a cycle kernel), "scan"
    # (an eager per-pod loop in plain PyTorch) or "wave" (``wave_assign``)
    path: Optional[str] = None


def queue_order(priority: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pod visit order: priority desc, stable by index; padding last."""
    key = torch.where(
        valid, -priority.long(), torch.full_like(priority, INT64_MAX, dtype=torch.int64)
    )
    return torch.sort(key, stable=True).indices


@dataclasses.dataclass(frozen=True)
class NodeFilterInputs:
    """The per-node Filter/Score inputs a cycle needs besides its state."""

    node_ok_default: torch.Tensor  # bool[N] valid & LoadAware mask
    node_ok_prod: torch.Tensor  # bool[N] valid & prod LoadAware mask
    usage_default: torch.Tensor  # i64[N, R] score usage, non-prod pods
    usage_prod: torch.Tensor  # i64[N, R] score usage, prod pods
    # prod pods filter/score differently from the rest under this config
    prod_sensitive: bool


def node_filter_inputs(snapshot: ClusterSnapshot, cfg: CycleConfig) -> NodeFilterInputs:
    nodes = snapshot.nodes
    mask_default, mask_prod = loadaware_node_masks(nodes, cfg)
    if not cfg.enable_loadaware:
        mask_default = torch.ones_like(mask_default)
        mask_prod = mask_default
    usage_np, usage_prod = select_score_usage(nodes, cfg)
    prod_sensitive = cfg.enable_loadaware and (
        usage_prod is not None or bool(dict(cfg.loadaware.prod_usage_thresholds))
    )
    return NodeFilterInputs(
        node_ok_default=nodes.valid & mask_default,
        node_ok_prod=nodes.valid & mask_prod,
        usage_default=usage_np,
        usage_prod=usage_prod if usage_prod is not None else usage_np,
        prod_sensitive=prod_sensitive,
    )


def step_feasible_scores(
    node_requested: torch.Tensor,  # i64[N, R] carried
    node_estimated: torch.Tensor,  # i64[N, R] carried
    quota_used: torch.Tensor,  # i64[Q, R] carried
    alloc: torch.Tensor,  # i64[N, R]
    usage: torch.Tensor,  # i64[N, R]
    fresh: torch.Tensor,  # bool[N]
    node_ok: torch.Tensor,  # bool[N] valid & loadaware filter
    req: torch.Tensor,  # i64[R] one pod
    sreq: torch.Tensor,  # i64[R]
    est: torch.Tensor,  # i64[R]
    qid: int,
    is_valid: bool,
    qrt: torch.Tensor,  # i64[Q, R]
    qlim: torch.Tensor,  # bool[Q, R]
    cfg: CycleConfig,
):
    """One pod's Filter+Score against the node state -> (feasible[N],
    scores[N]).  The single statement of the per-pod step semantics; the
    CUDA kernel and its plain version repeat it."""
    fits = ((node_requested + req <= alloc) | (req <= 0)).all(-1)
    feasible = fits & node_ok
    if qid >= 0:
        quota_ok = ((quota_used[qid] + req <= qrt[qid]) | ~qlim[qid]).all()
        feasible = feasible & quota_ok
    if not is_valid:
        feasible = torch.zeros_like(feasible)

    dev = alloc.device
    total = torch.zeros(alloc.shape[0], dtype=torch.int64, device=dev)
    if cfg.enable_fit_score:
        t = node_requested + sreq
        if cfg.fit_scoring_strategy == MOST_ALLOCATED:
            per_res = most_requested_score(t, alloc)
        else:
            per_res = least_requested_score(t, alloc)
        total = total + cfg.fit_plugin_weight * weighted_resource_score(
            per_res, cfg.fit_weights_arr(dev)
        )
    if cfg.enable_loadaware:
        per_res = least_requested_score(usage + node_estimated + est, alloc)
        la = weighted_resource_score(per_res, cfg.loadaware_weights_arr(dev))
        la = torch.where(fresh, la, 0)
        total = total + cfg.loadaware_plugin_weight * la
    return feasible, total


def finish_cycle(
    snapshot: ClusterSnapshot,
    order: torch.Tensor,  # i64[P] queue order
    chosen_in_order: torch.Tensor,  # i32[P] node per queue slot, -1 = none
    node_requested: torch.Tensor,
    node_estimated: torch.Tensor,
    quota_used: torch.Tensor,
    path: str,
    rounds: Optional[torch.Tensor] = None,
) -> CycleResult:
    """Scatter the queue-order choices back to pod order and apply the
    gang all-or-nothing status."""
    pods = snapshot.pods
    assignment = torch.full_like(chosen_in_order, -1)
    assignment[order] = chosen_in_order
    status = torch.where(
        assignment >= 0,
        torch.tensor(STATUS_ASSIGNED, dtype=torch.int32, device=assignment.device),
        torch.tensor(STATUS_UNSCHEDULABLE, dtype=torch.int32, device=assignment.device),
    )
    assigned = (assignment >= 0) & pods.valid
    _, pod_gang_ok = gang_satisfaction(
        assignment, pods.valid, pods.gang_id, snapshot.gangs.min_member
    )
    status = torch.where(
        assigned & ~pod_gang_ok, torch.full_like(status, STATUS_WAIT_GANG), status
    )
    return CycleResult(
        assignment=assignment,
        status=status,
        node_requested=node_requested,
        node_estimated=node_estimated,
        quota_used=quota_used,
        rounds=rounds,
        path=path,
    )


def greedy_assign(
    snapshot: ClusterSnapshot,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    extra_mask: Optional[torch.Tensor] = None,  # bool[P, N] extra Filter
    extra_scores: Optional[torch.Tensor] = None,  # i64[P, N] extra Score
) -> CycleResult:
    """Sequential-parity greedy assignment of the whole pending batch, as
    an eager per-pod loop on the snapshot's device (``path="scan"``).

    The loop reads the pods' ids and flags on the host once; the carried
    state and every choice stay on the device, so the loop never waits for
    it.  A snapshot on the CPU runs the same loop in numpy
    (``_scan_on_host``).

    A snapshot placed on a mesh (``parallel/mesh.py``) runs the same scan
    partitioned over its node shards (``parallel.greedy_assign_sharded``,
    ``path="shard"``), what GSPMD does for the reference.
    """
    from koordinator_tpu_torch.parallel.mesh import is_sharded, snapshot_mesh

    if is_sharded(snapshot):
        from koordinator_tpu_torch.parallel.shard_assign import greedy_assign_sharded

        return greedy_assign_sharded(
            snapshot, snapshot_mesh(snapshot), cfg, extra_mask, extra_scores)
    pods = snapshot.pods
    dev = snapshot.nodes.allocatable.device

    # the plain cycle's stages stand where the kernel's do (solver/wide.py)
    with stage("prepare"):
        order = queue_order(pods.priority, pods.valid)
        score_requests = nonzero_requests(pods.requests)
        nf = node_filter_inputs(snapshot, cfg)
        is_prod = (pods.priority_class == int(PriorityClass.PROD)).tolist()
        quota_id = pods.quota_id.tolist()
        valid = pods.valid.tolist()

    scan = _scan_on_host if dev.type == "cpu" else _scan_on_device
    with stage("kernel"):
        chosen_in_order, node_requested, node_estimated, quota_used = scan(
            snapshot, cfg, order.tolist(), score_requests, nf, is_prod, quota_id, valid,
            extra_mask, extra_scores)
    with stage("finish"):
        return finish_cycle(
            snapshot, order, chosen_in_order, node_requested, node_estimated,
            quota_used, path="scan",
        )


def _scan_on_device(snapshot, cfg, order, score_requests, nf, is_prod, quota_id, valid,
                    extra_mask, extra_scores):
    """``greedy_assign``'s loop on the snapshot's device: one
    ``step_feasible_scores`` a pod in queue ``order``.  Returns the
    queue-order choices and the carried state."""
    pods, nodes, quotas = snapshot.pods, snapshot.nodes, snapshot.quotas
    node_requested = nodes.requested.clone()
    node_estimated = torch.zeros_like(nodes.requested)
    quota_used = quotas.used.clone()
    chosen_in_order = torch.full((len(order),), -1, dtype=torch.int32,
                                 device=nodes.allocatable.device)
    for i, p in enumerate(order):
        if not valid[p]:
            # an empty slot is feasible nowhere: it takes no node and
            # changes no state
            continue
        prod = nf.prod_sensitive and is_prod[p]
        feasible, scores = step_feasible_scores(
            node_requested,
            node_estimated,
            quota_used,
            nodes.allocatable,
            nf.usage_prod if prod else nf.usage_default,
            nodes.metric_fresh,
            nf.node_ok_prod if prod else nf.node_ok_default,
            pods.requests[p],
            score_requests[p],
            pods.estimated[p],
            quota_id[p],
            valid[p],
            quotas.runtime,
            quotas.limited,
            cfg,
        )
        if extra_mask is not None:
            feasible = feasible & extra_mask[p]
        if extra_scores is not None:
            scores = scores + extra_scores[p]
        masked = torch.where(feasible, scores, torch.full_like(scores, INT64_MIN))
        any_feasible = feasible.any()
        chosen = torch.where(any_feasible, masked.argmax(), -1)
        chosen_in_order[i] = chosen
        node = chosen.clamp(min=0).view(1)
        take = any_feasible.long()
        node_requested.index_add_(0, node, (pods.requests[p] * take)[None])
        node_estimated.index_add_(0, node, (pods.estimated[p] * take)[None])
        if quota_id[p] >= 0:
            quota_used[quota_id[p]] += pods.requests[p] * take
    return chosen_in_order, node_requested, node_estimated, quota_used


class _HostScores:
    """``ops/scoring.py``'s scorers in numpy against one node table:
    ``alloc``'s zero test and divisor, and each weight vector's sum, are
    taken once a cycle."""

    def __init__(self, alloc: np.ndarray):
        self.alloc = alloc
        self.empty = alloc == 0
        self.den = np.where(self.empty, 1, alloc)

    def least_requested(self, requested: np.ndarray) -> np.ndarray:
        score = ((self.alloc - requested) * MAX_NODE_SCORE) // self.den
        return np.where(self.empty | (requested > self.alloc), 0, score)

    def most_requested(self, requested: np.ndarray) -> np.ndarray:
        score = (np.minimum(requested, self.alloc) * MAX_NODE_SCORE) // self.den
        return np.where(self.empty, 0, score)

    @staticmethod
    def weighted(weights: np.ndarray):
        """``weighted_resource_score`` against ``weights``: an int64 dot
        product, which wraps as the sum of products does."""
        weight_sum = int(weights.sum())
        if weight_sum == 0:
            return lambda per_resource: np.zeros(per_resource.shape[:-1], np.int64)
        return lambda per_resource: (per_resource @ weights) // weight_sum


def _scan_on_host(snapshot, cfg, order, score_requests, nf, is_prod, quota_id, valid,
                  extra_mask, extra_scores):
    """``_scan_on_device`` for a snapshot on the CPU, in numpy: the step
    of ``step_feasible_scores`` op for op, on host arrays.  At a few dozen
    pods the CPU path is bound by the per-op cost of ``torch``'s dispatch,
    which numpy does not pay; the bits are the same
    (``tests/test_torch_cycle.py`` holds the two loops against each other).
    Returns the queue-order choices and the carried state as tensors."""
    pods, nodes, quotas = snapshot.pods, snapshot.nodes, snapshot.quotas

    def host(t):
        return None if t is None else t.numpy()

    alloc = host(nodes.allocatable)
    fresh = host(nodes.metric_fresh)
    requests, sreqs, estimated = host(pods.requests), host(score_requests), host(pods.estimated)
    qrt, qlim = host(quotas.runtime), host(quotas.limited)
    usage = {False: host(nf.usage_default), True: host(nf.usage_prod)}
    node_ok = {False: host(nf.node_ok_default), True: host(nf.node_ok_prod)}
    mask, extra = host(extra_mask), host(extra_scores)
    scores = _HostScores(alloc)
    fit_weighted = scores.weighted(host(cfg.fit_weights_arr()).astype(np.int64))
    la_weighted = scores.weighted(host(cfg.loadaware_weights_arr()).astype(np.int64))
    fit = (scores.most_requested if cfg.fit_scoring_strategy == MOST_ALLOCATED
           else scores.least_requested)

    node_requested = host(nodes.requested).copy()
    node_estimated = np.zeros_like(node_requested)
    quota_used = host(quotas.used).copy()
    chosen_in_order = np.full(len(order), -1, np.int32)
    for i, p in enumerate(order):
        if not valid[p]:
            continue
        prod = nf.prod_sensitive and is_prod[p]
        req, qid = requests[p], quota_id[p]
        feasible = ((node_requested + req <= alloc) | (req <= 0)).all(-1) & node_ok[prod]
        if qid >= 0 and not ((quota_used[qid] + req <= qrt[qid]) | ~qlim[qid]).all():
            continue
        total = np.zeros(alloc.shape[0], np.int64)
        if cfg.enable_fit_score:
            total = total + cfg.fit_plugin_weight * fit_weighted(fit(node_requested + sreqs[p]))
        if cfg.enable_loadaware:
            la = la_weighted(scores.least_requested(usage[prod] + node_estimated + estimated[p]))
            total = total + cfg.loadaware_plugin_weight * np.where(fresh, la, 0)
        if mask is not None:
            feasible = feasible & mask[p]
        if extra is not None:
            total = total + extra[p]
        if not feasible.any():
            continue
        chosen = int(np.where(feasible, total, INT64_MIN).argmax())
        chosen_in_order[i] = chosen
        node_requested[chosen] += req
        node_estimated[chosen] += estimated[p]
        if qid >= 0:
            quota_used[qid] += req
    return tuple(torch.from_numpy(a) for a in (
        chosen_in_order, node_requested, node_estimated, quota_used))


def cell_shape(snapshot: ClusterSnapshot):
    """Shape of the snapshot's cell grid: [P, N], or [P, C] for node rows
    gathered per pod."""
    return torch.broadcast_shapes(
        snapshot.pods.valid[:, None].shape, snapshot.nodes.valid.shape
    )


def _pod_rows(snapshot: ClusterSnapshot, rows: slice) -> ClusterSnapshot:
    """The snapshot restricted to the pod rows ``rows`` (views, no copy);
    node rows gathered per pod are restricted with them."""
    def cut(table):
        return dataclasses.replace(table, **{
            f.name: getattr(table, f.name)[rows]
            for f in dataclasses.fields(table)
            if isinstance(getattr(table, f.name), torch.Tensor)
        })

    nodes = snapshot.nodes
    if nodes.valid.dim() == 2:
        nodes = cut(nodes)
    return dataclasses.replace(snapshot, pods=cut(snapshot.pods), nodes=nodes)


def by_rows(fn, rows: int, row_bytes: int):
    """``fn(slice)`` (a tensor or a tuple of tensors of ``rows`` rows)
    computed over chunks of rows whose largest temporary, ``row_bytes`` a
    row, stays within ``CHUNK_BYTES``.  The caller's ``fn`` must compute
    each output row from its own input rows only; then the chunked result
    equals the unchunked one bit for bit."""
    step = max(1, CHUNK_BYTES // max(int(row_bytes), 1))
    if rows <= step:
        return fn(slice(0, rows))
    out = None
    for start in range(0, rows, step):
        sl = slice(start, min(rows, start + step))
        parts = fn(sl)
        single = isinstance(parts, torch.Tensor)
        if single:
            parts = (parts,)
        if out is None:
            out = tuple(
                torch.empty((rows,) + p.shape[1:], dtype=p.dtype, device=p.device)
                for p in parts
            )
        for o, p in zip(out, parts):
            o[sl] = p
    return out[0] if single else out


def by_pod_rows(fn, snapshot: ClusterSnapshot, cfg: CycleConfig):
    """``fn(snapshot, cfg)`` (a tuple of [P, ...] tensors) computed over
    chunks of pod rows whose [rows, cells, R] int64 temporaries stay within
    ``CHUNK_BYTES``.  Every cell reads its own pod row only, so the chunked
    result equals the unchunked one bit for bit."""
    P, R = snapshot.pods.requests.shape
    cells = max(int(snapshot.nodes.valid.shape[-1]), 1)
    return by_rows(lambda rows: fn(_pod_rows(snapshot, rows), cfg), P, cells * R * 8)


def _fit_score_requests(requests: torch.Tensor) -> torch.Tensor:
    return nonzero_requests(requests)


def _combined_scores(
    snapshot: ClusterSnapshot, cfg: CycleConfig, pod_score_requests: torch.Tensor
) -> torch.Tensor:
    """Weighted sum of the enabled plugin scores of every cell, against the
    snapshot's node state (no Reserve: the estimated load of pods placed in
    this cycle is zero)."""
    nodes, pods = snapshot.nodes, snapshot.pods
    dev = nodes.allocatable.device
    total = torch.zeros(cell_shape(snapshot), dtype=torch.int64, device=dev)
    if cfg.enable_fit_score:
        t = nodes.requested + pod_score_requests[:, None, :]
        if cfg.fit_scoring_strategy == MOST_ALLOCATED:
            per_res = most_requested_score(t, nodes.allocatable)
        else:
            per_res = least_requested_score(t, nodes.allocatable)
        total = total + cfg.fit_plugin_weight * weighted_resource_score(
            per_res, cfg.fit_weights_arr(dev)
        )
    if cfg.enable_loadaware:
        usage_sel, usage_prod = select_score_usage(nodes, cfg)
        if usage_prod is not None:
            is_prod = pods.priority_class == int(PriorityClass.PROD)
            usage_sel = torch.where(is_prod[:, None, None], usage_prod, usage_sel)
        est_used = usage_sel + pods.estimated[:, None, :]
        per_res = least_requested_score(est_used, nodes.allocatable)
        la = weighted_resource_score(per_res, cfg.loadaware_weights_arr(dev))
        la = torch.where(nodes.metric_fresh, la, torch.zeros_like(la))
        total = total + cfg.loadaware_plugin_weight * la
    return total


def _feasibility_block(snapshot: ClusterSnapshot, cfg: CycleConfig):
    from koordinator_tpu_torch.solver.terms import apply_term_masks

    pods, nodes = snapshot.pods, snapshot.nodes
    feasible = fit_mask(
        pods.requests, nodes.requested, nodes.allocatable, nodes.valid, pods.valid
    )
    if cfg.enable_loadaware:
        mask_default, mask_prod = loadaware_node_masks(nodes, cfg)
        is_prod = pods.priority_class == int(PriorityClass.PROD)
        feasible = feasible & torch.where(is_prod[:, None], mask_prod, mask_default)
    return (apply_term_masks(snapshot, cfg, feasible),)


def feasibility_mask(
    snapshot: ClusterSnapshot, cfg: CycleConfig = DEFAULT_CYCLE_CONFIG
) -> torch.Tensor:
    """The mask half of :func:`score_all`: requests fit, node validity,
    the LoadAware masks and every enabled term's mask, with no scoring
    arithmetic.  The sparse candidate engine sweeps it blockwise."""
    return by_pod_rows(_feasibility_block, snapshot, cfg)[0]


def _score_block(snapshot: ClusterSnapshot, cfg: CycleConfig):
    from koordinator_tpu_torch.solver.terms import apply_term_scores

    (feasible,) = _feasibility_block(snapshot, cfg)
    scores = _combined_scores(
        snapshot, cfg, _fit_score_requests(snapshot.pods.requests)
    )
    return apply_term_scores(snapshot, cfg, scores), feasible


def score_all(snapshot: ClusterSnapshot, cfg: CycleConfig = DEFAULT_CYCLE_CONFIG):
    """Stateless Filter+Score of every cell -> (scores i64[P, N], feasible
    bool[P, N]) on the snapshot's device: the reference's Filter+Score for
    each pending pod against the snapshot as it is (no Reserve within the
    batch), with the fused terms.  Composed of the mask half
    (:func:`feasibility_mask`) and the score half; the halves commute."""
    return by_pod_rows(_score_block, snapshot, cfg)


@devprof.boundary("solver.greedy.score_cycle")
def score_cycle(snapshot: ClusterSnapshot, cfg: CycleConfig = DEFAULT_CYCLE_CONFIG):
    """The Score RPC's full rescore: ``score_all`` over the whole
    snapshot.  Returns (scores i64[P, N], feasible bool[P, N]).

    A snapshot placed on a mesh computes each shard's [P, N] block on its
    own device (:func:`score_cycle_sharded`, no communication: every cell
    reads one pod row and one node row) and returns the blocks assembled
    on the mesh's lead device."""
    from koordinator_tpu_torch.parallel.mesh import is_sharded

    if is_sharded(snapshot):
        scores, feasible = score_cycle_sharded(snapshot, cfg)
        return scores.full(), feasible.full()
    return score_all(snapshot, cfg)


@devprof.boundary("solver.greedy.score_cycle_sharded")
def score_cycle_sharded(snapshot: ClusterSnapshot, cfg: CycleConfig = DEFAULT_CYCLE_CONFIG):
    """``score_all`` of a snapshot placed on a mesh, block by block: each
    mesh position scores its own pod rows against its own node rows.
    Returns (scores, feasible) as ``ShardedTensor``s split like the
    snapshot's pod rows (axis 0) and node rows (axis 1) — for the
    mesh-resident snapshot, ``parallel.mesh.score_sharding``."""
    from koordinator_tpu_torch.parallel.mesh import P, shard_map, snapshot_mesh, spec_tree

    specs = spec_tree(snapshot)
    cells = P(specs.pods.requests[0] if specs.pods.requests else None,
              specs.nodes.allocatable[0] if specs.nodes.allocatable else None)

    def block(snap_l):
        return score_all(snap_l, cfg)

    return shard_map(block, mesh=snapshot_mesh(snapshot), in_specs=(specs,),
                     out_specs=(cells, cells))(snapshot)
