"""Fused scoring-term registry: heterogeneity, sensitivity and packing.

Counterpart of ``koordinator_tpu/solver/terms.py``.  Each term adds a
cellwise contribution to the (scores, feasible) pair of ``score_all``
(``solver/greedy.py``):

* **cellwise**: the contribution at (p, n) reads only pod row p, node row
  n and the replicated throughput matrix, so the incremental and sparse
  engines re-derive the same bits from gathered rows;
* **statically bounded**: each score clamps to ``[0, weight *
  MAX_NODE_SCORE]``, so :func:`terms_upper_bound` is a property of the
  config and needs no device reduction.

``term_extras`` materialises the same tensors once per Assign cycle, so
the sequential engines (the eager loop, ``wave_assign`` and the CUDA
cycle kernels, as ``xcomb``) consume the fused total through the
``extra_mask``/``extra_scores`` seam they already have.  A term whose
snapshot data is missing contributes nothing.

Every function takes node tables of [N, ...] or rows gathered per pod
([P, C, ...]); the pod side broadcasts as ``[P, 1, ...]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from koordinator_tpu_torch.model.snapshot import MAX_NODE_SCORE
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.ops.scoring import (
    most_requested_score,
    weighted_resource_score,
)
from koordinator_tpu_torch.solver.greedy import by_pod_rows, cell_shape


@dataclasses.dataclass(frozen=True)
class TermSpec:
    """One registered scoring term.

    ``enabled(cfg)``     whether the CycleConfig turns the term on;
    ``score(snap, cfg)`` cellwise i64[P, N] contribution, or None (no data);
    ``mask(snap, cfg)``  cellwise bool[P, N] feasibility mask, or None;
    ``upper_bound(cfg)`` static max of the score contribution;
    ``has_mask(cfg)``    whether ``mask`` returns a tensor under ``cfg``.
    """

    name: str
    enabled: Callable
    score: Callable
    mask: Callable
    upper_bound: Callable
    has_mask: Callable = staticmethod(lambda cfg: False)


def _clip_term(raw: torch.Tensor, weight: int) -> torch.Tensor:
    """The per-term clamp that makes the bound a config property."""
    return int(weight) * raw.long().clamp(0, MAX_NODE_SCORE)


# heterogeneity: Gavel-style throughput matrix (2008.09213)


def _het_score(snapshot, cfg):
    tput = snapshot.throughput
    if tput is None:
        return None
    pods, nodes = snapshot.pods, snapshot.nodes
    dev = tput.device
    C, A = tput.shape
    c = (
        pods.workload_class.long().clamp(0, C - 1)
        if pods.workload_class is not None
        else torch.zeros(pods.requests.shape[0], dtype=torch.int64, device=dev)
    )
    a = (
        nodes.accel_type.long().clamp(0, A - 1)
        if nodes.accel_type is not None
        else torch.zeros(nodes.valid.shape, dtype=torch.int64, device=dev)
    )
    raw = tput[c[:, None], a]  # [P, N] gather
    return _clip_term(raw, cfg.heterogeneity.weight)


# sensitivity: Synergy-style CPU/memory profiles (2110.06073)


def _sens_score(snapshot, cfg):
    sens = snapshot.pods.sensitivity
    if sens is None:
        return None
    nodes = snapshot.nodes
    alloc = nodes.allocatable.long()
    usage = nodes.usage.long()
    safe_cap = torch.where(alloc == 0, torch.ones_like(alloc), alloc)
    # occupancy percent per (node, resource), clamped: usage past
    # allocatable saturates at 100, an unallocatable resource reads empty
    occ = (usage * MAX_NODE_SCORE // safe_cap).clamp(0, MAX_NODE_SCORE)
    occ = torch.where(alloc == 0, torch.zeros_like(occ), occ)
    s = sens.long().clamp(0, MAX_NODE_SCORE)  # [P, R]
    s_sum = s.sum(-1)  # [P]
    # the reference's int64 einsum "pr,nr->pn" as an int64 multiply and sum
    # over R: exact by construction (each sum is at most R * 100 * 100), and
    # it runs on any device, where CUDA has no int64 matrix product; the
    # callers chunk pod rows, which bounds the [rows, N, R] temporary
    dot = (s[:, None, :] * occ).sum(-1)
    contention = dot // s_sum.clamp(min=1)[:, None]
    # an all-zero profile is insensitive: contention 0, full score
    raw = MAX_NODE_SCORE - contention
    return _clip_term(raw, cfg.sensitivity.weight)


# packing: bin-packing objective + headroom mask (2511.08373)


def _pack_score(snapshot, cfg):
    nodes, pods = snapshot.nodes, snapshot.pods
    t = nodes.requested + pods.requests[:, None, :]
    per_res = most_requested_score(t, nodes.allocatable)
    dev = nodes.allocatable.device
    raw = weighted_resource_score(per_res, cfg.packing.weights_arr(dev))
    return _clip_term(raw, cfg.packing.weight)


def _pack_masks(cfg) -> bool:
    """Whether the packing term contributes a mask: a config predicate."""
    return any(int(v) > 0 for _, v in cfg.packing.headroom)


def _pack_mask(snapshot, cfg):
    if not _pack_masks(cfg):
        return None
    nodes, pods = snapshot.nodes, snapshot.pods
    head = cfg.packing.headroom_arr(nodes.allocatable.device)  # 0 = unconstrained
    alloc = nodes.allocatable.long()
    post = nodes.requested.long() + pods.requests.long()[:, None, :]
    ok = post * 100 <= head * alloc
    return (ok | (head <= 0)).all(-1)


def _weight_bound(weight) -> int:
    return MAX_NODE_SCORE * int(weight)


TERMS: Tuple[TermSpec, ...] = (
    TermSpec(
        name="heterogeneity",
        enabled=lambda cfg: cfg.heterogeneity is not None,
        score=_het_score,
        mask=lambda snapshot, cfg: None,
        upper_bound=lambda cfg: _weight_bound(cfg.heterogeneity.weight),
    ),
    TermSpec(
        name="sensitivity",
        enabled=lambda cfg: cfg.sensitivity is not None,
        score=_sens_score,
        mask=lambda snapshot, cfg: None,
        upper_bound=lambda cfg: _weight_bound(cfg.sensitivity.weight),
    ),
    TermSpec(
        name="packing",
        enabled=lambda cfg: cfg.packing is not None,
        score=_pack_score,
        mask=_pack_mask,
        upper_bound=lambda cfg: _weight_bound(cfg.packing.weight),
        has_mask=_pack_masks,
    ),
)


def enabled_terms(cfg) -> Tuple[TermSpec, ...]:
    return tuple(t for t in TERMS if t.enabled(cfg))


def terms_upper_bound(cfg) -> int:
    """Static upper bound of the summed enabled-term contributions, the
    term half of ``solver/topk.py score_upper_bound``."""
    return sum(t.upper_bound(cfg) for t in enabled_terms(cfg))


def apply_term_scores(snapshot, cfg, scores):
    """Add every enabled term's cellwise score contribution to ``scores``."""
    for term in enabled_terms(cfg):
        s = term.score(snapshot, cfg)
        if s is not None:
            scores = scores + s
    return scores


def apply_term_masks(snapshot, cfg, feasible):
    """AND every enabled term's cellwise feasibility mask into ``feasible``."""
    for term in enabled_terms(cfg):
        m = term.mask(snapshot, cfg)
        if m is not None:
            feasible = feasible & m
    return feasible


def apply_terms(snapshot, cfg, scores, feasible):
    """Both halves: adds commute with adds and ANDs with ANDs, so running
    the halves apart changes no bit."""
    return (
        apply_term_scores(snapshot, cfg, scores),
        apply_term_masks(snapshot, cfg, feasible),
    )


def _term_block(snapshot, cfg):
    shape = cell_shape(snapshot)
    dev = snapshot.device
    scores = torch.zeros(shape, dtype=torch.int64, device=dev)
    feasible = torch.ones(shape, dtype=torch.bool, device=dev)
    return apply_terms(snapshot, cfg, scores, feasible)


@devprof.boundary("solver.terms.term_extras")
def term_extras(snapshot, cfg):
    """(extra_scores i64[P, N], extra_mask bool[P, N]) of the enabled terms,
    on the snapshot's device, for the Assign engines' extras seam.
    ``(None, None)`` with no term enabled; the mask is None when no enabled
    term masks.  Pod rows are computed in chunks (``greedy.by_pod_rows``)."""
    terms = enabled_terms(cfg)
    if not terms:
        return None, None
    scores, feasible = by_pod_rows(_term_block, snapshot, cfg)
    has_mask = any(t.has_mask(cfg) for t in terms)
    return scores, (feasible if has_mask else None)


def term_names(cfg) -> Tuple[str, ...]:
    """Names of the enabled terms."""
    return tuple(t.name for t in enabled_terms(cfg))


def default_term_config(base=None, packing_headroom=None):
    """A CycleConfig with all three terms enabled.  ``base`` seeds every
    other field; ``packing_headroom`` (resource -> max utilization percent)
    turns the packing mask on as well as its score."""
    from koordinator_tpu_torch.config import (
        CycleConfig,
        HeterogeneityTermArgs,
        PackingTermArgs,
        SensitivityTermArgs,
    )

    base = base if base is not None else CycleConfig()
    return dataclasses.replace(
        base,
        heterogeneity=HeterogeneityTermArgs(),
        sensitivity=SensitivityTermArgs(),
        packing=PackingTermArgs(
            headroom=packing_headroom if packing_headroom else ()
        ),
    )
