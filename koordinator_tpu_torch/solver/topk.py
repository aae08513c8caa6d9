"""Serving top-k over the masked [P, N] score tensor.

Counterpart of ``koordinator_tpu/solver/topk.py``.  The Score reply is the
k-prefix of ``lax.top_k(where(feasible, scores, i64.min), k)``: descending
scores, ties broken toward the lower node index.  :func:`masked_top_k`
takes one of three paths, chosen on the host from the tensors' device and
``k`` alone, before anything is launched (:func:`topk_path`):

* ``kernel`` (a CUDA tensor, ``k <= MAX_KERNEL_K``): one launch of the
  hand-written kernel in ``topk_cuda.cu``, which reads each row of
  ``scores`` and ``feasible`` once, forms the masked values in registers
  and selects each row's k best (value descending, column ascending).  It
  needs no bound on the scores, so nothing is read back on the host.  A
  launch the entry refuses raises; nothing falls back.
* ``sort`` (a CUDA tensor, larger ``k``: a caller asking for more than 32
  nodes a pod, or ``top_k`` 0 for all of them): the plain version below on
  the card.
* ``plain`` (any other device): the plain version.

:func:`masked_top_k_plain` is the plain version outside the launch ledger,
the reference the tests and ``chip_smoke.py`` hold the kernel to.

The plain version: ``torch.topk`` promises no order among ties, least of
all on CUDA, so neither of its branches hands it a tie:

* **in bound** (``hi`` from :func:`score_upper_bound` below 2^24, and every
  feasible score in ``[0, hi]``): one int64 key per cell,
  ``rank * N + (N - 1 - n)`` with ``rank = feasible ? score + 1 : 0``.
  Distinct cells have distinct keys, ordered as (masked score descending,
  index ascending); the key stays below ``2^24 * N``.
* **otherwise**: a stable descending sort of the masked int64 tensor,
  which keeps equal values in index order.

It gathers the values from the masked int64 tensor at the winning indices
on both branches, as the reference does.  Which branch runs depends on the
data (the reference's ``lax.cond``): the in-bound test is one reduction
and one host read, the cost of a branch in eager PyTorch (ROADMAP Queue C
"The top-k branch's host read"), which the kernel path does not pay.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.model.snapshot import MAX_NODE_SCORE
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.solver.greedy import INT64_MIN

KERNEL_SOURCE = "solver/topk_cuda.cu"
# the kernel's instances keep K = 8, 16 or 32 pairs a lane in registers;
# a smaller k runs the smallest that holds it
MAX_KERNEL_K = 32

_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5  # P, M, k; 4 tensors, stream

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


def topk_path(device, k: int) -> str:
    """The path :func:`masked_top_k` takes for tensors on ``device``:
    ``"kernel"``, ``"sort"`` or ``"plain"`` (module docstring)."""
    if torch.device(device).type != "cuda":
        return "plain"
    return "kernel" if k <= MAX_KERNEL_K else "sort"


def _kernel_operands(scores, feasible, k: int):
    """Check the kernel's operands; return them as the entry takes them,
    [P, M] row-major (a copy where the input is not), with the outputs."""
    if scores.dtype != torch.int64 or feasible.dtype != torch.bool:
        raise TypeError(f"masked_top_k: scores {scores.dtype} and feasible {feasible.dtype}, "
                        "want int64 and bool")
    if scores.shape != feasible.shape or scores.device != feasible.device:
        raise ValueError(f"masked_top_k: scores {tuple(scores.shape)} on {scores.device}, "
                         f"feasible {tuple(feasible.shape)} on {feasible.device}")
    m = scores.shape[-1]
    if not 1 <= k <= min(m, MAX_KERNEL_K):
        raise ValueError(f"masked_top_k: k={k} for rows of {m} cells")
    lead = tuple(scores.shape[:-1])
    p = math.prod(lead)
    top_s = torch.empty(lead + (k,), dtype=torch.int64, device=scores.device)
    top_i = torch.empty(lead + (k,), dtype=torch.int32, device=scores.device)
    return (p, m, scores.reshape(p, m).contiguous(), feasible.reshape(p, m).contiguous(),
            top_s, top_i)


@devprof.boundary("solver.topk.masked_top_k")
def masked_top_k(scores, feasible, *, k, hi):
    """(top_scores i64[..., k], top_idx i32[..., k]) of the masked score
    tensor, equal to ``lax.top_k(where(feasible, scores, i64.min), k)``
    (module docstring), on the tensors' device.  ``hi`` is read by the
    plain version only."""
    path = topk_path(scores.device, k)
    if path != "kernel":
        if path == "sort":
            # the plain version on the card, counted beside the kernel's launches
            _build.count("topk_sort")
        in_bound = (
            _bounded(hi)
            # koordlint: disable=host-sync-in-jit(the plain version's branch needs the in-bound test on the host; the kernel path has none, ROADMAP Queue C "The top-k branch's host read")
            and bool((((scores >= 0) & (scores <= hi)) | ~feasible).all())
        )
        return _ranked(scores, feasible, k, in_bound)
    p, m, s, f, top_s, top_i = _kernel_operands(scores, feasible, k)
    dev = scores.device
    with torch.cuda.device(dev):
        _build.launch("topk_kernel", KERNEL_SOURCE, "koord_topk_launch", _ARGTYPES,
                      p, m, k, s.data_ptr(), f.data_ptr(), top_s.data_ptr(), top_i.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    return top_s, top_i


def _bounded(hi) -> bool:
    """Whether ``hi`` admits the plain version's key (host values only)."""
    return hi is not None and 0 <= hi and hi + 1 < _F32_EXACT


def _ranked(scores, feasible, k, in_bound: bool):
    """The plain version's body: one key per cell where ``in_bound`` (every
    feasible score in ``[0, hi]``, ``hi`` below 2^24), else the stable sort."""
    masked = torch.where(feasible, scores, torch.full_like(scores, INT64_MIN))
    n = scores.shape[-1]
    if in_bound:
        rank = torch.where(feasible, scores + 1, torch.zeros_like(scores))
        idx = torch.arange(n, dtype=torch.int64, device=scores.device)
        ti = torch.topk(rank * n + (n - 1 - idx), k, dim=-1).indices
    else:
        ti = torch.sort(masked, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(masked, -1, ti), ti.int()


def masked_top_k_plain(scores, feasible, *, k, hi):
    """The plain PyTorch version of :func:`masked_top_k`, on any device,
    outside the launch ledger: the same values and indices (module
    docstring), the reference the kernel is held to."""
    in_bound = _bounded(hi) and bool((((scores >= 0) & (scores <= hi)) | ~feasible).all())
    return _ranked(scores, feasible, k, in_bound)


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
