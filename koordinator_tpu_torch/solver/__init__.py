"""The Assign cycle's entry point ``run_cycle``: its routes, the ladder of
cycle kernels on the card, and the ladder's demotion state.

Counterpart of ``koordinator_tpu/solver/__init__.py``.  On a CUDA snapshot
the cycle runs in one launch of a hand-written kernel: the int32 kernels
(``wide.py``: the wave-batched one when ``cfg.wave > 1``, else the per-pod
one) when the inputs fit them, else the dense int64 kernel (``dense.py``).  A rung whose build or
launch raises is demoted for its shape bucket with the reference's backoff
and the next rung runs; when every rung has failed or is demoted,
``run_cycle`` raises.  It never drops to a plain version on the card.

The Score side is exported here too, as in the reference: ``score_all``/
``score_cycle`` (``greedy.py``), ``masked_top_k``/``score_upper_bound``
(``topk.py``), ``rescore_dirty`` (``incremental.py``) and the sparse
candidate engine (``candidates.py``).  They are plain PyTorch on the
snapshot's device: the reference runs them as XLA programs, outside any
Pallas kernel.
"""

import logging
import threading
import weakref

import torch

from koordinator_tpu_torch.obs.spans import stage
from koordinator_tpu_torch.solver.greedy import (  # noqa: F401
    CycleResult,
    STATUS_ASSIGNED,
    STATUS_UNSCHEDULABLE,
    STATUS_WAIT_GANG,
    feasibility_mask,
    greedy_assign,
    queue_order,
    score_all,
    score_cycle,
    score_cycle_sharded,
    step_feasible_scores,
)
from koordinator_tpu_torch.solver.candidates import (  # noqa: F401
    CandidateOverflow,
    build_candidates,
    candidate_membership_mask,
    check_candidate_overflow,
    refresh_candidates,
    score_candidates,
    sparse_top_k,
)
from koordinator_tpu_torch.solver.incremental import rescore_dirty  # noqa: F401
from koordinator_tpu_torch.solver.terms import term_extras, terms_upper_bound
from koordinator_tpu_torch.solver.topk import (  # noqa: F401
    masked_top_k,
    masked_top_k_host,
    score_upper_bound,
)
from koordinator_tpu_torch.solver.dense import greedy_assign_dense  # noqa: F401
from koordinator_tpu_torch.solver.wave import wave_assign  # noqa: F401
from koordinator_tpu_torch.solver.wide import (  # noqa: F401
    EXTRA_SCORES_LIMIT,
    check_i32_bounds,
    extra_scores_peak,
    greedy_assign_wide,
    inputs_fit_i32,
)

_log = logging.getLogger(__name__)

# bucket (variant, N, P, has_extras, wave, top_m) -> [failures, cycles
# until the next retry].  Keyed by shape so that one oversized cycle does
# not demote normal ones; a demoted bucket retries after 4, 16, 64, then
# 256 cycles.
_FAILURES = {}
_LOCK = threading.Lock()
_RETRY_BASE = 4
_RETRY_CAP = 256
_DEMOTION_LISTENERS = []


def kernel_demotions():
    """Snapshot of demoted kernel buckets -> (failures, cycles until the
    next retry)."""
    with _LOCK:
        return {k: tuple(v) for k, v in _FAILURES.items()}


def _demoted(bucket) -> bool:
    """True while the bucket skips its kernel; counts down to the retry."""
    with _LOCK:
        state = _FAILURES.get(bucket)
        if state is None or state[1] <= 0:
            return False
        state[1] -= 1
        return True


def register_demotion_listener(cb):
    """``cb(bucket, failures)`` fires on every kernel demotion, after the
    backoff state is updated.  Held weakly; returns an unregister callable.
    A listener's exception is logged and swallowed."""
    try:
        ref = weakref.WeakMethod(cb)
    except TypeError:
        ref = weakref.ref(cb)
    with _LOCK:
        _DEMOTION_LISTENERS.append(ref)

    def unregister() -> None:
        with _LOCK:
            if ref in _DEMOTION_LISTENERS:
                _DEMOTION_LISTENERS.remove(ref)

    return unregister


def _notify_demotion(bucket, failures) -> None:
    with _LOCK:
        live = [ref() for ref in _DEMOTION_LISTENERS]
        _DEMOTION_LISTENERS[:] = [
            ref for ref, cb in zip(_DEMOTION_LISTENERS, live) if cb is not None
        ]
        live = [cb for cb in live if cb is not None]
    for cb in live:
        try:
            cb(bucket, failures)
        except Exception:
            _log.exception("demotion listener failed for bucket %r", bucket)


def _record_failure(bucket) -> None:
    with _LOCK:
        state = _FAILURES.setdefault(bucket, [0, 0])
        state[0] += 1
        state[1] = min(_RETRY_CAP, _RETRY_BASE ** min(state[0], 4))
        failures = state[0]
    # outside the lock: a listener may read kernel_demotions()
    _notify_demotion(bucket, failures)


def _record_success(bucket) -> None:
    with _LOCK:
        _FAILURES.pop(bucket, None)


def run_kernel_ladder(rungs, shape_key, fits_i32):
    """Run the first rung that is not skipped, not demoted and does not
    raise.

    ``rungs``: ``(variant, needs_i32, thunk)`` in order.  A rung that needs
    int32 inputs is skipped, not demoted, when ``fits_i32()`` is false: the
    condition depends on the data.  A rung whose thunk raises is demoted
    for its bucket ``(variant,) + shape_key``, logged with its traceback,
    reported to the demotion listeners, and the next rung runs.  Raises
    ``RuntimeError`` naming the buckets when no rung succeeded."""
    fits = None
    tried = []
    for variant, needs_i32, thunk in rungs:
        if needs_i32:
            if fits is None:
                fits = bool(fits_i32())
            if not fits:
                continue
        bucket = (variant,) + tuple(shape_key)
        if _demoted(bucket):
            tried.append((bucket, "demoted"))
            continue
        try:
            result = thunk()
        except Exception:
            _record_failure(bucket)
            _log.exception(
                "%s cycle kernel failed for %r; demoting this shape bucket "
                "(retry after %d cycles)",
                variant, bucket, kernel_demotions().get(bucket, (0, 0))[1],
            )
            tried.append((bucket, "failed"))
            continue
        _record_success(bucket)
        return result
    raise RuntimeError(
        f"no cycle kernel ran: {tried}; the port has no plain fallback on the card"
    )


def run_cycle(snapshot, cfg=None, extra_mask=None, extra_scores=None, i32_ok=None):
    """One scheduling cycle on the snapshot's device.

    * CPU snapshot: ``wave_assign`` when ``cfg.wave > 1`` and the extra
      scores (if any) are below 2^31, else ``greedy_assign``.
    * CUDA snapshot: the kernel ladder.  First the int32 kernel — the wave
      kernel when ``cfg.wave > 1``, else the per-pod wide kernel — taken
      only when the snapshot fits int32 and the extra scores are below
      2^29; then the dense int64 kernel, which takes every input.  A wave
      request that runs the dense kernel has ``rounds=None``.

    Every route gives the same placements and post-cycle state as the
    reference's ``run_cycle``.  ``i32_ok``: callers that already know
    whether the snapshot fits the int32 kernels pass it to skip the check.

    A snapshot placed on a mesh (``parallel/mesh.py``) is assembled on the
    mesh's lead device first: this is the single-device route.

    Fused scoring terms (``cfg.heterogeneity``/``sensitivity``/``packing``)
    are materialised once (``terms.term_extras``) and folded into
    ``extra_scores``/``extra_mask``, which every route already reads.
    Extras from terms alone are bounded by the config
    (``terms_upper_bound``), with no device reduction; with the caller's
    extras the bound is their peak plus the terms' bound.
    """
    from koordinator_tpu_torch.config import DEFAULT_CYCLE_CONFIG
    from koordinator_tpu_torch.parallel.mesh import unshard_snapshot

    if cfg is None:
        cfg = DEFAULT_CYCLE_CONFIG
    # a snapshot placed on a mesh runs whole on its lead device
    snapshot = unshard_snapshot(snapshot)
    caller_scores = extra_scores
    t_scores, t_mask = term_extras(snapshot, cfg)
    if t_scores is not None:
        extra_scores = t_scores if extra_scores is None else extra_scores + t_scores
    if t_mask is not None:
        extra_mask = t_mask if extra_mask is None else extra_mask & t_mask
    if caller_scores is None:
        scores_hi = None if extra_scores is None else terms_upper_bound(cfg)
    else:
        scores_hi = extra_scores_peak(caller_scores)
        if t_scores is not None:
            scores_hi += terms_upper_bound(cfg)
    args = (snapshot, cfg, extra_mask, extra_scores)
    if snapshot.device.type != "cuda":
        if cfg.wave > 1 and (scores_hi is None or scores_hi < 2**31):
            return wave_assign(*args, scores_hi=scores_hi)
        return greedy_assign(*args)

    has_extras = extra_mask is not None or extra_scores is not None
    shape_key = (snapshot.nodes.capacity, snapshot.pods.capacity, has_extras,
                 int(cfg.wave), int(cfg.top_m))

    def rung(fn, **kw):
        def thunk():
            result = fn(*args, **kw)
            # a fault during the run surfaces here, inside the ladder
            with stage("kernel_wait"):
                torch.cuda.synchronize(snapshot.device)
            return result
        return thunk

    def fits_i32():
        if scores_hi is not None and scores_hi >= EXTRA_SCORES_LIMIT:
            return False
        return i32_ok if i32_ok is not None else inputs_fit_i32(snapshot)

    # the ladder runs the int32 rung only after fits_i32() held
    wide_rung = rung(greedy_assign_wide, i32_ok=True, scores_hi=scores_hi)
    rungs = (
        ("wave" if cfg.wave > 1 else "wide", True, wide_rung),
        ("dense", False, rung(greedy_assign_dense)),
    )
    return run_kernel_ladder(rungs, shape_key, fits_i32)
