"""Serving top-k over the masked [P, N] score tensor.

Counterpart of ``koordinator_tpu/solver/topk.py``.  The Score reply is the
k-prefix of ``lax.top_k(where(feasible, scores, i64.min), k)``: descending
scores, ties broken toward the lower node index.  ``torch.topk`` promises
no order among ties, least of all on CUDA, so neither path here hands it a
tie:

* **in bound** (``hi`` from :func:`score_upper_bound` below 2^24, and every
  feasible score in ``[0, hi]``): one int64 key per cell,
  ``rank * N + (N - 1 - n)`` with ``rank = feasible ? score + 1 : 0``.
  Distinct cells have distinct keys, ordered as (masked score descending,
  index ascending); the key stays below ``2^24 * N``.
* **otherwise**: a stable descending sort of the masked int64 tensor,
  which keeps equal values in index order.

The values are gathered from the masked int64 tensor at the winning
indices on both paths, as in the reference.  Which path runs depends on the
data (the reference's ``lax.cond``): the in-bound test is one reduction
and one host read, the cost of a branch in eager PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from koordinator_tpu_torch.model.snapshot import MAX_NODE_SCORE
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.solver.greedy import INT64_MIN

# the reference's fast path ranks in float32, exact below 2^24; the port
# keeps its decision so that the two take the same path
_F32_EXACT = 1 << 24


def score_upper_bound(cfg) -> int:
    """Static upper bound of ``score_cycle``'s scores under ``cfg`` (every
    term clamps at zero, so scores are >= 0), the fused terms included."""
    from koordinator_tpu_torch.solver.terms import terms_upper_bound

    hi = 0
    if cfg.enable_fit_score:
        hi += MAX_NODE_SCORE * int(cfg.fit_plugin_weight)
    if cfg.enable_loadaware:
        hi += MAX_NODE_SCORE * int(cfg.loadaware_plugin_weight)
    return hi + terms_upper_bound(cfg)


@devprof.boundary("solver.topk.masked_top_k")
def masked_top_k(scores, feasible, *, k, hi):
    """(top_scores i64[..., k], top_idx i32[..., k]) of the masked score
    tensor, equal to ``lax.top_k(where(feasible, scores, i64.min), k)``
    (module docstring), on the tensors' device."""
    masked = torch.where(feasible, scores, torch.full_like(scores, INT64_MIN))
    n = scores.shape[-1]
    in_bound = (
        hi is not None
        and 0 <= hi
        and hi + 1 < _F32_EXACT
        # koordlint: disable=host-sync-in-jit(the path choice needs the in-bound test on the host, ROADMAP Queue C "The top-k branch's host read")
        and bool((((scores >= 0) & (scores <= hi)) | ~feasible).all())
    )
    if in_bound:
        rank = torch.where(feasible, scores + 1, torch.zeros_like(scores))
        idx = torch.arange(n, dtype=torch.int64, device=scores.device)
        ti = torch.topk(rank * n + (n - 1 - idx), k, dim=-1).indices
    else:
        ti = torch.sort(masked, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(masked, -1, ti), ti.int()


def masked_top_k_host(scores_np, feasible_np, k: int):
    """Host numpy twin of :func:`masked_top_k`: the same values, indices and
    tie order, no device involved (the reference's brownout ranking).

    A descending stable sort with lower-index ties is an ascending stable
    argsort of the order-reversed key; the int64 sentinel cannot be negated,
    so the key is made order-preserving in uint64 (``x ^ 2^63``) and
    reversed bitwise (``~``)."""
    scores_np = np.asarray(scores_np, np.int64)
    feasible_np = np.asarray(feasible_np, bool)
    masked = np.where(feasible_np, scores_np, np.iinfo(np.int64).min)
    biased = masked.view(np.uint64) ^ np.uint64(1 << 63)
    ti = np.argsort(~biased, axis=-1, kind="stable")[..., :k]
    ts = np.take_along_axis(masked, ti, axis=-1)
    return ts, ti.astype(np.int32)
