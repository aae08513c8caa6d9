"""Incremental column/row rescore of the resident [P, N] score tensors.

Counterpart of ``koordinator_tpu/solver/incremental.py``.
A warm delta Sync touches a few node rows and pod rows; this module
recomputes only what they invalidated:

* **dirty columns**: gather the dirty node rows, score every pod against
  them (O(P x d)) and scatter the [P, d] block into the resident tensors;
* **dirty rows**: gather the dirty pod rows, score them against every node
  (O(d_p x N)) and scatter the [d_p, N] block.

Every cell of ``score_all`` reads one pod row and one node row, so
gather-score-scatter writes the same bits a full ``score_cycle`` would;
cells outside the dirty rows and columns keep the last launch's bits.

Row indices are padded to the power-of-two buckets of
``solver/resident.py`` (pad slots carry the out-of-range sentinel, as in
the reference); the pad slots, whose results the reference drops, are
sliced off by their host-known count before each scatter, so no
out-of-range index reaches the device.

``scores`` is updated in place (the reference donates it); ``feasible`` is
never written: the result holds a new tensor, because in-flight readbacks
may still hold the one given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.model.snapshot import pad_bucket
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.solver.greedy import score_all


def _take_nodes(nodes, idx):
    """NodeBatch with rows gathered at ``idx`` (in range by contract:
    callers clip).  ``idx`` of shape [d] gives [d, ...] leaves, [P, C]
    gives rows gathered per pod.  Optional leaves stay None; names stay."""
    take = lambda a: None if a is None else a[idx]  # noqa: E731
    return dataclasses.replace(
        nodes,
        allocatable=take(nodes.allocatable),
        requested=take(nodes.requested),
        usage=take(nodes.usage),
        metric_fresh=take(nodes.metric_fresh),
        valid=take(nodes.valid),
        agg_usage=take(nodes.agg_usage),
        agg_fresh=take(nodes.agg_fresh),
        prod_usage=take(nodes.prod_usage),
        accel_type=take(nodes.accel_type),
    )


def _take_pods(pods, idx):
    take = lambda a: None if a is None else a[idx]  # noqa: E731
    return dataclasses.replace(
        pods,
        requests=take(pods.requests),
        estimated=take(pods.estimated),
        priority_class=take(pods.priority_class),
        qos=take(pods.qos),
        priority=take(pods.priority),
        gang_id=take(pods.gang_id),
        quota_id=take(pods.quota_id),
        valid=take(pods.valid),
        workload_class=take(pods.workload_class),
        sensitivity=take(pods.sensitivity),
    )


def _pad_rows(rows, oob: int) -> np.ndarray:
    """Sorted row indices padded to the power-of-two bucket with the
    out-of-range sentinel ``oob``."""
    rows = np.asarray(sorted(int(r) for r in rows), np.int64)
    bucket = pad_bucket(max(len(rows), 1))
    out = np.full(bucket, oob, np.int64)
    out[: len(rows)] = rows
    return out


def _upload_rows(padded: np.ndarray, oob: int, device):
    """(padded indices on ``device``, count of leading in-range rows).
    Rows the reference would drop (at or past ``oob``) sort last, with the
    pad slots."""
    return torch.from_numpy(padded).to(device), int(np.count_nonzero(padded < oob))


def _rescore_body(snapshot, scores, feasible, node_idx, n_nodes, pod_idx, n_pods, cfg):
    """Column pass then row pass; the passes overlap on (dirty pod, dirty
    node) cells with identical values.  ``n_nodes``/``n_pods``: how many
    leading slots of the padded index vectors are scattered.  A pass with
    nothing to scatter is skipped: the reference computes it and drops
    every slot."""
    nodes, pods = snapshot.nodes, snapshot.pods
    n_rows = nodes.allocatable.shape[0]
    p_rows = pods.requests.shape[0]
    if n_nodes:
        sub_nodes = _take_nodes(nodes, node_idx.clamp(0, n_rows - 1))
        s_cols, f_cols = score_all(dataclasses.replace(snapshot, nodes=sub_nodes), cfg)
        cols = node_idx[:n_nodes]
        scores[:, cols] = s_cols[:, :n_nodes]
        feasible[:, cols] = f_cols[:, :n_nodes]
    if n_pods:
        sub_pods = _take_pods(pods, pod_idx.clamp(0, p_rows - 1))
        s_rows, f_rows = score_all(dataclasses.replace(snapshot, pods=sub_pods), cfg)
        rows = pod_idx[:n_pods]
        scores[rows] = s_rows[:n_pods]
        feasible[rows] = f_rows[:n_pods]
    return scores, feasible


@devprof.boundary("solver.incremental._rescore_sharded")
def _rescore_sharded(snapshot, scores, feasible, node_rows, pod_rows, cfg):
    """Shard-local incremental rescore over the cluster mesh: the score
    tensors are split by node columns (``parallel.mesh.score_sharding``),
    column j with node j's rows.  Each shard rebases the dirty node rows
    against its own column offset on the host, so a dirty column is
    written on exactly the shard that owns it; the row pass scores the
    dirty pod rows against each shard's own node rows and writes its own
    [d_p, N_local] block.  ``scores`` is written in place shard by shard;
    ``feasible`` comes back as new shards."""
    from koordinator_tpu_torch.parallel.mesh import axis_index, shard_map, spec_tree

    sharding = scores.sharding
    ax = sharding.spec[1]
    node_rows = sorted(int(r) for r in node_rows)
    pod_rows = sorted(int(r) for r in pod_rows)

    def body(snap_l, scores_l, feasible_l):
        p_rows, n_loc = scores_l.shape
        lo = axis_index(ax) * n_loc
        mine = [r - lo for r in node_rows if lo <= r < lo + n_loc]
        dev = scores_l.device
        node_idx, n_nodes = _upload_rows(_pad_rows(mine, n_loc), n_loc, dev)
        pod_idx, n_pods = _upload_rows(_pad_rows(pod_rows, p_rows), p_rows, dev)
        return _rescore_body(snap_l, scores_l, feasible_l.clone(), node_idx, n_nodes,
                             pod_idx, n_pods, cfg)

    return shard_map(
        body, mesh=sharding.mesh,
        in_specs=(spec_tree(snapshot), sharding.spec, feasible.sharding.spec),
        out_specs=(sharding.spec, sharding.spec),
    )(snapshot, scores, feasible)


@devprof.boundary("solver.incremental.rescore_dirty")
def rescore_dirty(snapshot, scores, feasible, node_rows, pod_rows, cfg, mesh=None):
    """Recompute the dirty columns and rows of the resident score tensors.

    ``scores``/``feasible``: the [P, N] tensors of the last full or
    incremental launch; ``node_rows``/``pod_rows``: the unique row indices
    the warm commits since then invalidated.  Returns ``(scores,
    feasible)``, equal to ``score_cycle(snapshot, cfg)`` bit for bit:
    ``scores`` is the given tensor, updated in place; ``feasible`` is a new
    tensor, and the one given is left as it was.

    Score tensors placed on a mesh (``ShardedTensor``s split by node
    columns, the snapshot placed on the same mesh) take the shard-local
    rescore, :func:`_rescore_sharded`.  ``mesh``: the mesh the caller
    expects them on; plain tensors with a given mesh of more than one
    device are refused."""
    from koordinator_tpu_torch.parallel.mesh import ShardedTensor, check_mesh

    mesh = check_mesh(mesh)
    if isinstance(scores, ShardedTensor):
        return _rescore_sharded(snapshot, scores, feasible, node_rows, pod_rows, cfg)
    if mesh is not None and mesh.size > 1:
        raise ValueError(
            "rescore_dirty: the score tensors are not placed on the given mesh "
            "(parallel.mesh.score_sharding)"
        )
    P, N = scores.shape
    node_idx, n_nodes = _upload_rows(_pad_rows(node_rows, N), N, scores.device)
    pod_idx, n_pods = _upload_rows(_pad_rows(pod_rows, P), P, scores.device)
    return _rescore_body(
        snapshot, scores, feasible.clone(), node_idx, n_nodes, pod_idx, n_pods, cfg
    )
