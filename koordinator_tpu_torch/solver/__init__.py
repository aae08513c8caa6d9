from koordinator_tpu_torch.solver.greedy import (  # noqa: F401
    CycleResult,
    STATUS_ASSIGNED,
    STATUS_UNSCHEDULABLE,
    STATUS_WAIT_GANG,
    greedy_assign,
    queue_order,
    step_feasible_scores,
)
from koordinator_tpu_torch.solver.dense import greedy_assign_dense  # noqa: F401


def run_cycle(snapshot, cfg=None, extra_mask=None, extra_scores=None):
    """One scheduling cycle on the snapshot's device.

    On a CUDA snapshot the whole cycle is one launch of the CUDA cycle
    kernel (``solver/dense.py``); on a CPU snapshot the eager oracle
    ``greedy_assign`` runs.  Both are bit-identical with the reference's
    ``run_cycle``.  A kernel build or launch error propagates to the caller:
    there is no fallback to another path.

    The fused scoring terms (``cfg.heterogeneity``/``sensitivity``/
    ``packing``) are not ported yet; a config that sets one is refused.
    """
    from koordinator_tpu_torch.config import DEFAULT_CYCLE_CONFIG

    if cfg is None:
        cfg = DEFAULT_CYCLE_CONFIG
    if cfg.has_terms:
        raise NotImplementedError(
            "fused scoring terms (heterogeneity/sensitivity/packing) are not "
            "ported to koordinator_tpu_torch yet"
        )
    if snapshot.device.type == "cuda":
        return greedy_assign_dense(
            snapshot, cfg, extra_mask=extra_mask, extra_scores=extra_scores
        )
    return greedy_assign(
        snapshot, cfg, extra_mask=extra_mask, extra_scores=extra_scores
    )
