"""Sparse candidate-set scoring: [P, C] instead of [P, N].

Counterpart of ``koordinator_tpu/solver/candidates.py``.
Score is served from a per-pod candidate list instead of the full pods x
nodes tensor:

* **feasibility pre-mask**: ``solver/greedy.py feasibility_mask`` swept
  over the node axis in power-of-two blocks, so the widest dense tensor is
  [P, B] for one block, never [P, N];
* **candidate lists**: each pod keeps its C lowest-indexed feasible nodes
  (C = ``cfg.candidate_width``), ascending, with the sentinel N in empty
  slots;
* **sparse scoring**: the cellwise ``score_all`` body over the gathered
  [P, C] cells (node rows gathered per pod); ``sparse_top_k`` maps winners
  back to node ids.

Exactness: a list is exact only if it holds every feasible node of its pod.
``count`` is each pod's true feasible total, and a pod with ``count > C``
makes the engine raise :class:`CandidateOverflow` at the count readback; it
never serves a truncated list.  Under that invariant the sparse reply
equals the dense one: the same feasible set, the same scores, and, because
the lists ascend, the same lower-index tie order.

Every index a scatter or gather takes is in range on the device: the pad
slots of the dirty-row buckets are sliced off by their host-known count,
and sentinel slots gather a clipped row whose result is masked off.

Over a pod mesh (``parallel/mesh.py pod_mesh``) the build, refresh and
scoring run pod-parallel with no communication: each shard sweeps its own
pod rows against the replicated node table, and the [P, C] results come
back split by pod rows (``ShardedTensor``s).  Over a node mesh the
pipelined build's counts pass splits its node blocks instead.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque

import numpy as np
import torch

from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.solver.greedy import feasibility_mask, score_all
from koordinator_tpu_torch.solver.incremental import _pad_rows, _upload_rows
from koordinator_tpu_torch.solver.score_kernel import _take_nodes, _take_pods
from koordinator_tpu_torch.solver.topk import masked_top_k

# Node-axis sweep width of the blocked feasibility pass (a power of two:
# node buckets are powers of two, so the blocks tile the axis).
_SWEEP_BLOCK = 1024

# Cold-build routing: from this many blocks on, the pipelined build runs
# (a counts pass, block pruning, host merges overlapped with the device's
# extraction of the next blocks); below it the serial sweep.
# KOORD_PARALLEL_BUILD=0 forces the serial build, =1 the pipelined one.
_PARALLEL_MIN_BLOCKS = 16

# extraction launches kept in flight ahead of the host merge
_PIPELINE_DEPTH = 4


class CandidateOverflow(RuntimeError):
    """A pod's feasible-node count exceeds the candidate width C: its list
    cannot hold every feasible node, so the engine refuses."""

    def __init__(self, width: int, max_feasible: int, pods: int):
        self.width = int(width)
        self.max_feasible = int(max_feasible)
        self.pods = int(pods)
        super().__init__(
            f"sparse candidate width {self.width} cannot hold every "
            f"feasible node: {self.pods} pod(s) have up to "
            f"{self.max_feasible} feasible nodes; raise "
            "--candidate-width (power of two) — the sparse engine "
            "refuses rather than silently degrade to a truncated "
            "candidate set"
        )


def check_candidate_overflow(count, width: int) -> None:
    """Raise :class:`CandidateOverflow` if any pod's exact feasible count
    exceeds ``width``.  ``count``: the host readback of a build's or
    refresh's ``count`` (a tensor on any device or an array)."""
    if isinstance(count, torch.Tensor):
        count = count.cpu().numpy()
    count = np.asarray(count)
    over = count > int(width)
    if bool(np.any(over)):
        raise CandidateOverflow(width, int(count.max()), int(np.count_nonzero(over)))


def _sweep_block(n: int, c: int) -> int:
    return min(int(n), max(int(c), _SWEEP_BLOCK))


def _merge_lowest(cand: torch.Tensor, new_idx: torch.Tensor) -> torch.Tensor:
    """The C lowest node indices of ``cand`` and ``new_idx`` (both with the
    sentinel N in empty slots, which sorts past every real index)."""
    C = cand.shape[1]
    return torch.sort(torch.cat([cand, new_idx], dim=1), dim=1).values[:, :C]


def _block_columns(snapshot, cfg, block: int, b: int) -> torch.Tensor:
    """One node block's candidate columns: i32[P, b], the global node index
    where feasible, the sentinel N elsewhere."""
    nodes = snapshot.nodes
    n = nodes.allocatable.shape[0]
    gidx = block * b + torch.arange(b, dtype=torch.int64, device=snapshot.device)
    sub = dataclasses.replace(snapshot, nodes=_take_nodes(nodes, gidx))
    feas = feasibility_mask(sub, cfg)  # [P, b]
    return torch.where(feas, gidx.int()[None, :], torch.full_like(feas, n, dtype=torch.int32))


@devprof.boundary("solver.candidates._build")
def _build(snapshot, *, cfg):
    """Serial blocked sweep over the node axis -> (cand i32[P, C] ascending
    with the sentinel N, count i64[P] exact)."""
    nodes, pods = snapshot.nodes, snapshot.pods
    n = nodes.allocatable.shape[0]
    p = pods.requests.shape[0]
    c = int(cfg.candidate_width)
    b = _sweep_block(n, c)
    dev = snapshot.device
    cand = torch.full((p, c), n, dtype=torch.int32, device=dev)
    count = torch.zeros(p, dtype=torch.int64, device=dev)
    for block in range(n // b):
        cols = _block_columns(snapshot, cfg, block, b)
        count = count + (cols < n).sum(-1)
        cand = _merge_lowest(cand, cols)
    return cand, count


def _count_carry(snapshot, cfg) -> torch.Tensor:
    n = snapshot.nodes.allocatable.shape[0]
    b = _sweep_block(n, int(cfg.candidate_width))
    return torch.stack([
        (_block_columns(snapshot, cfg, block, b) < n).sum(-1)
        for block in range(n // b)
    ])


@devprof.boundary("solver.candidates._count_blocks")
def _count_blocks(snapshot, cfg) -> torch.Tensor:
    """Exact feasible counts of every (block, pod): i64[NB, P], no merges."""
    return _count_carry(snapshot, cfg)


@devprof.boundary("solver.candidates._count_blocks_sharded")
def _count_blocks_sharded(snapshot, cfg, mesh) -> torch.Tensor:
    """The counts pass with the block axis split over a node mesh: each
    shard sweeps its own node rows' blocks (feasibility reads no node
    index, so the local rows suffice), and the stacked [NB, P] counts come
    out in global block order because shard d holds blocks
    [d*NB/D, (d+1)*NB/D).  Returned whole on the lead device."""
    from koordinator_tpu_torch.parallel.mesh import CLUSTER_AXIS, P, shard_map, spec_tree

    specs = spec_tree(snapshot)
    specs = dataclasses.replace(specs, nodes=dataclasses.replace(specs.nodes, **{
        f.name: P(CLUSTER_AXIS, *([None] * (getattr(snapshot.nodes, f.name).dim() - 1)))
        for f in dataclasses.fields(specs.nodes)
        if getattr(snapshot.nodes, f.name) is not None and f.name != "names"
    }))

    def body(snap_l):
        return _count_carry(snap_l, cfg)

    return shard_map(body, mesh=mesh, in_specs=(specs,),
                     out_specs=P(CLUSTER_AXIS, None))(snapshot).full()


def _merge_lowest_host(cand: np.ndarray, new_idx: np.ndarray) -> np.ndarray:
    """Host twin of :func:`_merge_lowest`: an exact integer sort."""
    c = cand.shape[1]
    return np.sort(np.concatenate([cand, new_idx], axis=1), axis=1)[:, :c]


def _build_pipelined(snapshot, cfg, node_mesh=None):
    """Pipelined cold build, equal to :func:`_build`:

    1. a counts pass gives each block's exact feasible count per pod;
    2. block j can reach pod p's C-prefix only if it holds a feasible node
       for p and fewer than C feasible nodes precede it, so every other
       block is skipped;
    3. the needed blocks' columns are extracted on the device
       ``_PIPELINE_DEPTH`` ahead of the host merge of earlier ones.

    The final lists are the C lowest feasible indices of each pod, and the
    int64 counts are exact in any order.  ``node_mesh``: the counts pass
    splits its blocks over it when each shard holds whole blocks."""
    from koordinator_tpu_torch.parallel.mesh import unshard_snapshot

    nodes, pods = snapshot.nodes, snapshot.pods
    n = nodes.allocatable.shape[0]
    p = pods.requests.shape[0]
    c = int(cfg.candidate_width)
    b = _sweep_block(n, c)
    sharded = snapshot
    snapshot = unshard_snapshot(snapshot)
    if (node_mesh is not None and node_mesh.size > 1
            and n % node_mesh.size == 0 and (n // node_mesh.size) % b == 0):
        counts = _count_blocks_sharded(sharded, cfg, node_mesh)
    else:
        counts = _count_blocks(snapshot, cfg)
    counts_np = counts.cpu().numpy()  # [NB, P]
    count = counts_np.sum(axis=0, dtype=np.int64)
    before = np.cumsum(counts_np, axis=0, dtype=np.int64) - counts_np
    needed = np.nonzero(np.any((counts_np > 0) & (before < c), axis=1))[0]
    cand = np.full((p, c), n, np.int32)
    inflight: deque = deque()
    for j in needed:
        inflight.append(_block_columns(snapshot, cfg, int(j), b))
        if len(inflight) >= _PIPELINE_DEPTH:
            cand = _merge_lowest_host(cand, inflight.popleft().cpu().numpy())
    while inflight:
        cand = _merge_lowest_host(cand, inflight.popleft().cpu().numpy())
    dev = snapshot.device
    return torch.from_numpy(cand).to(dev), torch.from_numpy(count).to(dev)


def _parallel_build_mode() -> str:
    return os.environ.get("KOORD_PARALLEL_BUILD", "auto")


def _check_sparse_cfg(cfg) -> None:
    if int(cfg.candidate_width) <= 0:
        raise ValueError(
            "sparse candidate scoring needs cfg.candidate_width > 0 "
            f"(got {cfg.candidate_width!r})"
        )


def _check_pod_mesh(snapshot, mesh) -> None:
    p = snapshot.pods.requests.shape[0]
    if p % mesh.size:
        raise ValueError(
            f"pod bucket {p} does not divide over {mesh.size} devices; "
            "resize the pod mesh to a power-of-two prefix"
        )


@devprof.boundary("solver.candidates._build_sharded")
def _build_sharded(snapshot, cfg, mesh):
    """The serial sweep on every pod shard of a pod mesh, against the
    replicated node table: (cand, count) split by pod rows."""
    from koordinator_tpu_torch.parallel.mesh import (
        POD_AXIS,
        P,
        shard_map,
        snapshot_pod_partition_specs,
    )

    def body(snap_l):
        return _build(snap_l, cfg=cfg)

    return shard_map(body, mesh=mesh, in_specs=(snapshot_pod_partition_specs(snapshot),),
                     out_specs=(P(POD_AXIS, None), P(POD_AXIS)))(snapshot)


def build_candidates(snapshot, cfg, mesh=None, node_mesh=None):
    """Cold build: (cand i32[P, C] ascending index lists with the sentinel
    N in empty slots, count i64[P] exact feasible totals), on the
    snapshot's device.  ``mesh``: a pod mesh runs the sweep pod-parallel
    (:func:`_build_sharded`; the results come back split by pod rows).
    Without one, from ``_PARALLEL_MIN_BLOCKS`` node blocks on the
    pipelined build runs, its counts pass split over ``node_mesh`` when
    one is given; ``KOORD_PARALLEL_BUILD`` (0/1/auto) overrides the
    routing.  A snapshot placed on a node mesh is read whole on its lead
    device, its counts pass on its shards.  Callers must
    :func:`check_candidate_overflow` the count before serving from the
    lists."""
    from koordinator_tpu_torch.parallel.mesh import check_mesh, unshard_snapshot

    _check_sparse_cfg(cfg)
    mesh, node_mesh = check_mesh(mesh), check_mesh(node_mesh)
    if mesh is not None and mesh.size > 1:
        _check_pod_mesh(snapshot, mesh)
        return _build_sharded(snapshot, cfg, mesh)
    n = snapshot.nodes.allocatable.shape[0]
    blocks = n // _sweep_block(n, int(cfg.candidate_width))
    mode = _parallel_build_mode()
    pipelined = (
        blocks >= _PARALLEL_MIN_BLOCKS if mode not in ("0", "1") else mode == "1"
    )
    if pipelined:
        return _build_pipelined(snapshot, cfg, node_mesh=node_mesh)
    return _build(unshard_snapshot(snapshot), cfg=cfg)


@devprof.boundary("solver.candidates._refresh")
def _refresh(snapshot, cand, count, node_idx, n_nodes, pod_idx, n_pods, cfg):
    """One exact merge-refresh:

    * dirty node columns: evict the dirty nodes from every list, subtract
      them from the counts, evaluate just their feasibility ([P, dB]) and
      merge the feasible ones back;
    * dirty pod rows: rebuilt from scratch by the serial sweep over the
      gathered pod rows.

    Precondition: the lists being advanced did not overflow, so every
    previously feasible dirty node is in its lists and the counts stay
    exact.  ``n_nodes``/``n_pods``: leading in-range slots of the padded
    index vectors; a row pass with nothing to scatter is skipped."""
    nodes, pods = snapshot.nodes, snapshot.pods
    n = nodes.allocatable.shape[0]
    p = pods.requests.shape[0]
    in_range = torch.arange(node_idx.shape[0], device=node_idx.device) < n_nodes
    dirty = torch.where(in_range, node_idx, torch.full_like(node_idx, n))
    member = (cand[:, :, None].long() == dirty[None, None, :]).any(-1) & (cand < n)
    count = count - member.sum(-1)
    cand = torch.where(member, torch.full_like(cand, n), cand)
    sub = dataclasses.replace(
        snapshot, nodes=_take_nodes(nodes, node_idx.clamp(0, n - 1))
    )
    feas_d = feasibility_mask(sub, cfg) & in_range[None, :]
    count = count + feas_d.sum(-1)
    new_idx = torch.where(feas_d, dirty.int()[None, :], torch.full_like(feas_d, n, dtype=torch.int32))
    cand = _merge_lowest(cand, new_idx)
    if n_pods:
        sub_pods = _take_pods(pods, pod_idx.clamp(0, p - 1))
        row_cand, row_count = _build(dataclasses.replace(snapshot, pods=sub_pods), cfg=cfg)
        rows = pod_idx[:n_pods]
        cand[rows] = row_cand[:n_pods]
        count[rows] = row_count[:n_pods]
    return cand, count


@devprof.boundary("solver.candidates._refresh_sharded")
def _refresh_sharded(snapshot, cand, count, node_rows, pod_rows, cfg, mesh):
    """The merge-refresh on every pod shard: the dirty node rows apply to
    every shard (the node table is whole on each), the dirty pod rows are
    rebased against each shard's pod offset on the host and rebuilt only
    on the shard that owns them."""
    from koordinator_tpu_torch.parallel.mesh import (
        POD_AXIS,
        P,
        axis_index,
        shard_map,
        snapshot_pod_partition_specs,
    )

    pod_rows = sorted(int(r) for r in pod_rows)

    def body(snap_l, cand_l, count_l):
        n = snap_l.nodes.allocatable.shape[0]
        p_loc = snap_l.pods.requests.shape[0]
        lo = axis_index(POD_AXIS) * p_loc
        mine = [r - lo for r in pod_rows if lo <= r < lo + p_loc]
        dev = snap_l.device
        node_idx, n_nodes = _upload_rows(_pad_rows(node_rows, n), n, dev)
        pod_idx, n_pods = _upload_rows(_pad_rows(mine, p_loc), p_loc, dev)
        return _refresh(snap_l, cand_l, count_l, node_idx, n_nodes, pod_idx, n_pods, cfg)

    cspec = P(POD_AXIS, None)
    return shard_map(
        body, mesh=mesh,
        in_specs=(snapshot_pod_partition_specs(snapshot), cspec, P(POD_AXIS)),
        out_specs=(cspec, P(POD_AXIS)),
    )(snapshot, cand, count)


def refresh_candidates(snapshot, cand, count, node_rows, pod_rows, cfg, mesh=None):
    """Advance (cand, count) past a warm delta: ``node_rows``/``pod_rows``
    are the unique dirty row sets.  Exact under the non-overflow
    precondition (:func:`_refresh`).  Returns new tensors; the ones given
    are not written.  ``mesh``: a pod mesh refreshes shard by shard
    (:func:`_refresh_sharded`)."""
    from koordinator_tpu_torch.parallel.mesh import check_mesh, gather, unshard_snapshot

    _check_sparse_cfg(cfg)
    mesh = check_mesh(mesh)
    if mesh is not None and mesh.size > 1:
        _check_pod_mesh(snapshot, mesh)
        return _refresh_sharded(snapshot, cand, count, node_rows, pod_rows, cfg, mesh)
    snapshot = unshard_snapshot(snapshot)
    n = snapshot.nodes.allocatable.shape[0]
    p = snapshot.pods.requests.shape[0]
    dev = snapshot.device
    node_idx, n_nodes = _upload_rows(_pad_rows(node_rows, n), n, dev)
    pod_idx, n_pods = _upload_rows(_pad_rows(pod_rows, p), p, dev)
    return _refresh(snapshot, gather(cand), gather(count), node_idx, n_nodes, pod_idx,
                    n_pods, cfg)


def _score_cells(snapshot, cand, cfg):
    n = snapshot.nodes.allocatable.shape[0]
    cand_l = cand.long()
    sub = dataclasses.replace(
        snapshot, nodes=_take_nodes(snapshot.nodes, cand_l.clamp(0, n - 1))
    )
    scores, feas = score_all(sub, cfg)
    return scores, feas & (cand_l < n)


@devprof.boundary("solver.candidates._score_sharded")
def _score_sharded(snapshot, cand, cfg, mesh):
    """The gathered cells of every pod shard, scored on that shard against
    the replicated node table: (scores, feasible) split by pod rows."""
    from koordinator_tpu_torch.parallel.mesh import (
        POD_AXIS,
        P,
        shard_map,
        snapshot_pod_partition_specs,
    )

    def body(snap_l, cand_l):
        return _score_cells(snap_l, cand_l, cfg)

    cspec = P(POD_AXIS, None)
    return shard_map(body, mesh=mesh,
                     in_specs=(snapshot_pod_partition_specs(snapshot), cspec),
                     out_specs=(cspec, cspec))(snapshot, cand)


@devprof.boundary("solver.candidates.score_candidates")
def score_candidates(snapshot, cand, cfg, mesh=None):
    """(scores i64[P, C], feasible bool[P, C]) of the gathered cells, the
    sparse engine's whole scoring cost, O(P x C): the cellwise
    ``score_all`` body on node rows gathered per pod.  Sentinel slots
    gather a clipped row and are forced infeasible.  ``mesh``: a pod mesh
    scores shard by shard (:func:`_score_sharded`)."""
    from koordinator_tpu_torch.parallel.mesh import check_mesh, gather, unshard_snapshot

    _check_sparse_cfg(cfg)
    mesh = check_mesh(mesh)
    if mesh is not None and mesh.size > 1:
        _check_pod_mesh(snapshot, mesh)
        return _score_sharded(snapshot, cand, cfg, mesh)
    return _score_cells(unshard_snapshot(snapshot), gather(cand), cfg)


def sparse_top_k(scores, feasible, cand, *, k, hi):
    """Serving top-k over the [P, C] cells, mapped back to node ids:
    (top_scores i64[P, k], top_node i32[P, k], ok bool[P, k]).  The lists
    ascend, so the lower-slot tie order is the dense lower-node order;
    non-ok slots report node 0."""
    from koordinator_tpu_torch.parallel.mesh import gather

    scores, feasible, cand = gather(scores), gather(feasible), gather(cand)
    ts, tc = masked_top_k(scores, feasible, k=k, hi=hi)
    tc = tc.long()
    ok = torch.gather(feasible, -1, tc)
    ti = torch.gather(cand, -1, tc).int()
    return ts, torch.where(ok, ti, torch.zeros_like(ti)), ok


def candidate_membership_mask(cand, num_nodes: int) -> torch.Tensor:
    """bool[P, N] membership mask of the candidate lists.  Sentinel slots
    set nothing; other indices follow JAX's ``mode="drop"`` rule (negative
    indices wrap once, what is still outside [0, N) is dropped)."""
    from koordinator_tpu_torch.parallel.mesh import gather

    cand = gather(cand)
    p, c = cand.shape
    n = int(num_nodes)
    cand_l = cand.long()
    cand_l = torch.where(cand_l < 0, cand_l + n, cand_l)
    keep = (cand_l >= 0) & (cand_l < n)
    rows = torch.arange(p, device=cand.device)[:, None].expand(p, c)
    # every slot writes: kept slots to their own cell, the rest to one
    # spare column past N that is cut off afterwards
    mask = torch.zeros((p, n + 1), dtype=torch.bool, device=cand.device)
    mask[rows, torch.where(keep, cand_l, torch.full_like(cand_l, n))] = True
    return mask[:, :n]
