"""The Score program's cellwise Filter+Score, written in place.

``score_all``'s dense form (node tables of [N, ...]) as one statement:
:func:`score_cells` writes the ``(score, feasible)`` pair of a set of cells
into the caller's [P, N] tensors, at each cell's own position.  The cell
set is every cell (``score_cycle``'s full Score), the node rows
``node_idx[:n_nodes]`` against every pod row (the rescore's column pass),
the pod rows ``pod_idx[:n_pods]`` against every node row (its row pass),
or the cross of both.  Index vectors are those of
``solver/incremental.py _upload_rows``: int64, in range in their first
``n`` slots, which alone are read (all of them where ``n`` is None); the
rest may hold the sentinel.

Two paths, chosen on the host from the tensors' device alone:

* ``kernel`` (a CUDA tensor): one launch of the hand-written kernel in
  ``score_cuda.cu``, which computes every cell of the set in registers
  from the pod and node rows and writes its score and flag at its place,
  with no [rows, N, R] temporary, no [P, d] block and no scatter.  The
  row-sized operands (:func:`cell_operands`: the non-zero requests, the
  prod flag, the node masks and score usages) are prepared eagerly, O((P +
  N) R).  The enabled terms (``solver/terms.py``), which no kernel
  computes, are added to the written cells afterwards: an addition after
  the combined score and an AND after the mask, so the bits are the
  eager code's.  A launch the entry refuses raises; nothing falls back.
* ``plain`` (any other device): the eager body, ``solver/greedy.py
  _score_block`` (or ``_feasibility_block`` for the mask alone) over the
  cells' rows, written into the outputs.  :func:`score_cells_plain` is the
  same outside the launch ledger, on any device: the reference the tests
  and ``chip_smoke.py`` hold the kernel to.

``scores`` may be None: the mask-only variant (``feasibility_mask``) writes
``feasible`` alone.  Both outputs are written in place and nothing else is;
the caller owns them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.config import MOST_ALLOCATED
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import PriorityClass
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.ops.fit import nonzero_requests
from koordinator_tpu_torch.ops.loadaware import loadaware_node_masks, select_score_usage
from koordinator_tpu_torch.solver.greedy import _feasibility_block, _score_block, by_pod_rows
from koordinator_tpu_torch.solver.terms import _term_block, enabled_terms

KERNEL_SOURCE = "solver/score_cuda.cu"
# the kernel's parameter lists hold this many resources
MAX_KERNEL_R = 16

# the kernel's variants as the launch table counts them (``_build.launch``,
# with their cells): ``scores`` the Filter+Score, ``mask`` the mask-only one
VARIANTS = ("scores", "mask")

# Pc, Nc; params, pod_idx, node_idx, 5 pod and 7 node tables; ld; scores,
# feasible; vec_ok; stream
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 15 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])


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


@dataclasses.dataclass(frozen=True)
class CellOperands:
    """The kernel's row-sized operands, prepared eagerly from a snapshot."""

    requests: torch.Tensor  # i64[P, R]
    score_requests: torch.Tensor  # i64[P, R] ops/fit.py nonzero_requests
    estimated: torch.Tensor  # i64[P, R]
    pod_ok: torch.Tensor  # bool[P] valid
    is_prod: torch.Tensor  # bool[P] PriorityClass PROD
    allocatable: torch.Tensor  # i64[N, R]
    requested: torch.Tensor  # i64[N, R]
    usage: torch.Tensor  # i64[N, R] LoadAware score usage, non-prod pods
    usage_prod: torch.Tensor  # i64[N, R] the same for prod pods
    fresh: torch.Tensor  # bool[N] metric_fresh
    ok_default: torch.Tensor  # bool[N] valid & the LoadAware filter
    ok_prod: torch.Tensor  # bool[N] valid & the prod LoadAware filter


_POD_TABLES = ("requests", "score_requests", "estimated")
_POD_FLAGS = ("pod_ok", "is_prod")
_NODE_TABLES = ("allocatable", "requested", "usage", "usage_prod")
_NODE_FLAGS = ("fresh", "ok_default", "ok_prod")


def cell_operands(snapshot, cfg) -> CellOperands:
    """The row-sized half of ``score_all``'s dense form: what
    ``_feasibility_block`` and ``_combined_scores`` compute per pod row or
    per node row before they broadcast."""
    nodes, pods = snapshot.nodes, snapshot.pods
    ok_default = ok_prod = nodes.valid
    if cfg.enable_loadaware:
        mask_default, mask_prod = loadaware_node_masks(nodes, cfg)
        ok_default = nodes.valid & mask_default
        ok_prod = ok_default if mask_prod is mask_default else nodes.valid & mask_prod
    usage, usage_prod = select_score_usage(nodes, cfg)
    usage = usage.contiguous()
    return CellOperands(
        requests=pods.requests, score_requests=nonzero_requests(pods.requests),
        estimated=pods.estimated, pod_ok=pods.valid,
        is_prod=pods.priority_class == int(PriorityClass.PROD),
        allocatable=nodes.allocatable, requested=nodes.requested, usage=usage,
        usage_prod=usage if usage_prod is None else usage_prod.contiguous(),
        fresh=nodes.metric_fresh, ok_default=ok_default, ok_prod=ok_prod,
    )


def check_operands(ops: CellOperands, device) -> None:
    """Raise unless every operand is what the kernel reads: int64 [P, R]
    and [N, R] tables, bool [P] and [N] flags, on ``device``, row-major."""
    P, R = tuple(ops.requests.shape) if ops.requests.dim() == 2 else (-1, -1)
    N = ops.allocatable.shape[0] if ops.allocatable.dim() == 2 else -1
    if not 1 <= R <= MAX_KERNEL_R:
        raise ValueError(f"score_cells: {R} resources, the kernel takes 1 to {MAX_KERNEL_R}")
    for names, dtype, shape in ((_POD_TABLES, torch.int64, (P, R)), (_POD_FLAGS, torch.bool, (P,)),
                                (_NODE_TABLES, torch.int64, (N, R)),
                                (_NODE_FLAGS, torch.bool, (N,))):
        for name in names:
            t = getattr(ops, name)
            if t.dtype != dtype:
                raise TypeError(f"score_cells: {name} is {t.dtype}, want {dtype}")
            if tuple(t.shape) != shape or t.device != torch.device(device):
                raise ValueError(f"score_cells: {name} {tuple(t.shape)} on {t.device}, "
                                 f"want {shape} on {device}")
            if not t.is_contiguous():
                raise ValueError(f"score_cells: {name} is not contiguous")


def _wrap64(v: int) -> int:
    return (int(v) + (1 << 63)) % (1 << 64) - (1 << 63)


def _weighted_sum(enabled: bool, weights, plugin_weight):
    """One plugin's weighted sum as the kernel takes it: (resources of
    non-zero weight, their weights, divisor, plugin weight).  A plugin that
    is off, or whose weights sum to 0, adds 0 (``ops/scoring.py
    weighted_resource_score``): no resource, plugin weight 0."""
    total = _wrap64(sum(weights))
    if not enabled or total == 0:
        return [], [], 1, 0
    picked = [r for r, w in enumerate(weights) if w != 0]
    return picked, [_wrap64(weights[r]) for r in picked], max(total, 1), _wrap64(plugin_weight)


def kernel_params(cfg, num_resources: int) -> list:
    """The entry's parameter array (``score_cuda.cu koord_score_cells_launch``)
    from the config alone: R, n_fit, n_la, most, the divisors, the plugin
    weights, then the two resource lists and their weights, each padded to
    ``MAX_KERNEL_R``."""
    fit = _weighted_sum(cfg.enable_fit_score,
                        res.weights_vector(dict(cfg.fit_resource_weights)),
                        cfg.fit_plugin_weight)
    la = _weighted_sum(cfg.enable_loadaware,
                       res.weights_vector(dict(cfg.loadaware.resource_weights)),
                       cfg.loadaware_plugin_weight)
    if num_resources != res.NUM_RESOURCES:
        raise ValueError(f"score_cells: {num_resources} resources, the weights have "
                         f"{res.NUM_RESOURCES}")

    def pad(values):
        return list(values) + [0] * (MAX_KERNEL_R - len(values))

    return ([num_resources, len(fit[0]), len(la[0]),
             1 if cfg.fit_scoring_strategy == MOST_ALLOCATED else 0,
             fit[2], la[2], fit[3], la[3]]
            + pad(fit[0]) + pad(fit[1]) + pad(la[0]) + pad(la[1]))


def _cell_set(snapshot, feasible, scores, pod_idx, n_pods, node_idx, n_nodes) -> tuple:
    """Check the outputs and the index vectors; return (pod positions,
    node positions) of the cell set, host ints."""
    nodes, pods = snapshot.nodes, snapshot.pods
    if nodes.valid.dim() != 1:
        raise ValueError("score_cells: node tables of [N, ...]; rows gathered per pod "
                         "take solver/greedy.py score_all's eager body")
    P, N = pods.requests.shape[0], nodes.allocatable.shape[0]
    dev = snapshot.device
    for name, t, dtype in (("feasible", feasible, torch.bool), ("scores", scores, torch.int64)):
        if t is None and name == "scores":
            continue
        if t.dtype != dtype:
            raise TypeError(f"score_cells: {name} is {t.dtype}, want {dtype}")
        if tuple(t.shape) != (P, N) or t.device != dev:
            raise ValueError(f"score_cells: {name} {tuple(t.shape)} on {t.device}, want "
                             f"{(P, N)} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"score_cells: {name} is not contiguous")
    out = []
    for name, idx, n, rows in (("pod_idx", pod_idx, n_pods, P), ("node_idx", node_idx, n_nodes, N)):
        if idx is None:
            out.append(rows)
            continue
        if idx.dtype != torch.int64:
            raise TypeError(f"score_cells: {name} is {idx.dtype}, want torch.int64")
        if idx.dim() != 1 or idx.device != dev or not idx.is_contiguous():
            raise ValueError(f"score_cells: {name} {tuple(idx.shape)} on {idx.device}, want a "
                             f"contiguous vector on {dev}")
        n = idx.shape[0] if n is None else n
        if not 0 <= n <= idx.shape[0]:
            raise ValueError(f"score_cells: {n} leading {name} entries of {idx.shape[0]}")
        out.append(int(n))
    return tuple(out)


def _cells_snapshot(snapshot, pod_idx, n_pods, node_idx, n_nodes):
    """The snapshot restricted to the cell set's rows, in the set's order."""
    if node_idx is not None:
        snapshot = dataclasses.replace(
            snapshot, nodes=_take_nodes(snapshot.nodes, node_idx[:n_nodes]))
    if pod_idx is not None:
        snapshot = dataclasses.replace(snapshot, pods=_take_pods(snapshot.pods, pod_idx[:n_pods]))
    return snapshot


def _cell_index(pod_idx, n_pods, node_idx, n_nodes) -> tuple:
    """The outputs' index of the cell set: [rows, cols] of its block."""
    rows = slice(None) if pod_idx is None else pod_idx[:n_pods]
    cols = slice(None) if node_idx is None else node_idx[:n_nodes]
    if pod_idx is not None and node_idx is not None:
        return rows[:, None], cols[None, :]
    return rows, cols


def _plain_body(snapshot, cfg, feasible, scores, pod_idx, n_pods, node_idx, n_nodes) -> None:
    sub = _cells_snapshot(snapshot, pod_idx, n_pods, node_idx, n_nodes)
    ix = _cell_index(pod_idx, n_pods, node_idx, n_nodes)
    if scores is None:
        feasible[ix] = by_pod_rows(_feasibility_block, sub, cfg)[0]
        return
    s, f = by_pod_rows(_score_block, sub, cfg)
    scores[ix] = s
    feasible[ix] = f


def _add_terms(snapshot, cfg, feasible, scores, pod_idx, n_pods, node_idx, n_nodes) -> None:
    """Add the enabled terms to the cells the kernel wrote: their scores
    after the combined score, their masks ANDed after the mask, as
    ``_score_block`` applies them, so the bits are the same."""
    if not enabled_terms(cfg):
        return
    sub = _cells_snapshot(snapshot, pod_idx, n_pods, node_idx, n_nodes)
    ix = _cell_index(pod_idx, n_pods, node_idx, n_nodes)
    term_scores, term_mask = by_pod_rows(_term_block, sub, cfg)
    if scores is not None:
        scores[ix] += term_scores
    feasible[ix] &= term_mask


@devprof.boundary("solver.score_kernel.score_cells")
def score_cells(snapshot, cfg, feasible, scores=None, *, pod_idx=None, n_pods=None,
                node_idx=None, n_nodes=None) -> None:
    """Write the Filter+Score of the cell set (module docstring) into
    ``feasible`` bool[P, N] and, unless it is None, ``scores`` i64[P, N],
    in place, on the snapshot's device: the bits ``score_all`` gives those
    cells.  Raises on outputs or index vectors of another dtype, shape or
    device, or not contiguous; on the card also on such operands."""
    pc, nc = _cell_set(snapshot, feasible, scores, pod_idx, n_pods, node_idx, n_nodes)
    if pc == 0 or nc == 0:
        return
    if snapshot.device.type != "cuda":
        _plain_body(snapshot, cfg, feasible, scores, pod_idx, pc, node_idx, nc)
        return
    ops = cell_operands(snapshot, cfg)
    check_operands(ops, feasible.device)
    params = (ctypes.c_longlong * (8 + 4 * MAX_KERNEL_R))(
        *kernel_params(cfg, ops.requests.shape[1]))
    n = feasible.shape[1]
    vec_ok = 1 if (n % 2 == 0 and feasible.data_ptr() % 2 == 0
                   and (scores is None or scores.data_ptr() % 16 == 0)) else 0
    dev = feasible.device
    with torch.cuda.device(dev):
        _build.launch(
            "mask" if scores is None else "scores", KERNEL_SOURCE, "koord_score_cells_launch",
            _ARGTYPES, pc, nc, ctypes.addressof(params),
            None if pod_idx is None else pod_idx.data_ptr(),
            None if node_idx is None else node_idx.data_ptr(),
            *(getattr(ops, name).data_ptr() for name in _POD_TABLES + _POD_FLAGS),
            *(getattr(ops, name).data_ptr() for name in _NODE_TABLES + _NODE_FLAGS),
            n, None if scores is None else scores.data_ptr(), feasible.data_ptr(), vec_ok,
            torch.cuda.current_stream(dev).cuda_stream, cells=pc * nc)
    _add_terms(snapshot, cfg, feasible, scores, pod_idx, pc, node_idx, nc)


def score_cells_plain(snapshot, cfg, feasible, scores=None, *, pod_idx=None, n_pods=None,
                      node_idx=None, n_nodes=None) -> None:
    """The plain PyTorch version of :func:`score_cells`, on any device,
    outside the launch ledger: the same bits, written in the same place
    (module docstring), the reference the kernel is held to."""
    pc, nc = _cell_set(snapshot, feasible, scores, pod_idx, n_pods, node_idx, n_nodes)
    if pc and nc:
        _plain_body(snapshot, cfg, feasible, scores, pod_idx, pc, node_idx, nc)
