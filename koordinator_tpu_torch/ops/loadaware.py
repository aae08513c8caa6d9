"""LoadAwareScheduling filter masks and score-usage selection.

Counterpart of ``koordinator_tpu/ops/loadaware.py`` (reference
``pkg/scheduler/plugins/loadaware/load_aware.go``: Filter :150-226, Score
:269-335).  Percentages are ``round(used/total*100)`` half away from zero,
reproduced in exact integer math.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.model.snapshot import PERCENTILES
from koordinator_tpu_torch.ops.scoring import (
    least_requested_score,
    weighted_resource_score,
)


def loadaware_scores(
    pod_estimated: torch.Tensor,  # i64[P, R] estimator output per pod
    node_usage: torch.Tensor,  # i64[N, R] measured usage (NodeMetric)
    node_estimated: torch.Tensor,  # i64[N, R] assign-cache estimated usage
    node_allocatable: torch.Tensor,  # i64[N, R]
    weights: torch.Tensor,  # i64[R]
    metric_fresh: torch.Tensor,  # bool[N]
) -> torch.Tensor:
    """LoadAware Score for all (pod, node) pairs -> i64[P, N] (reference
    Score :269-335): the weighted leastRequestedScore of measured usage +
    assign-cache estimate + the pod's estimate; 0 on a node without a fresh
    metric."""
    estimated_used = (
        node_usage[None, :, :] + node_estimated[None, :, :]
        + pod_estimated[:, None, :]
    )
    scores = least_requested_score(estimated_used, node_allocatable[None, :, :])
    score = weighted_resource_score(scores, weights)
    return torch.where(metric_fresh[None, :], score, torch.zeros_like(score))


def usage_percent(used: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """round(used/total*100) half-away-from-zero, exact integers: for
    non-negative ints floor((200*used + total) / (2*total)).  0 where total
    is 0."""
    used = used.long()
    total = total.long()
    safe_total = torch.where(total == 0, torch.ones_like(total), total)
    pct = (200 * used + safe_total) // (2 * safe_total)
    return torch.where(total == 0, torch.zeros_like(pct), pct)


def loadaware_filter_mask(
    node_usage: torch.Tensor,  # i64[N, R]
    node_allocatable: torch.Tensor,  # i64[N, R]
    thresholds: torch.Tensor,  # i64[R] percent, 0 = unchecked
    metric_fresh: torch.Tensor,  # bool[N]
) -> torch.Tensor:
    """Filter mask bool[N]; True = the node passes the thresholds.

    A resource with threshold 0 or zero allocatable is skipped; usage% >=
    threshold rejects the node; nodes without a fresh metric pass.
    """
    pct = usage_percent(node_usage, node_allocatable)
    checked = (thresholds[None, :] > 0) & (node_allocatable > 0)
    exceeded = (checked & (pct >= thresholds[None, :])).any(-1)
    return ~exceeded | ~metric_fresh


def loadaware_node_masks(nodes, cfg):
    """Per-node Filter masks -> (mask_default bool[N], mask_prod bool[N]).

    * with an aggregated profile, non-prod pods filter against the selected
      usage percentile and the profile's thresholds; a (node, percentile)
      cell with no data passes
    * PriorityProd pods with ProdUsageThresholds filter against the node's
      prod-pods usage instead of whole-node usage
    * an expired or missing NodeMetric always passes

    Node tables may carry leading axes beyond [N] (rows gathered per pod);
    the masks then have those axes.
    """
    dev = nodes.allocatable.device
    thr = cfg.loadaware_thresholds_arr(dev)
    agg = cfg.loadaware.aggregated
    if (
        agg is not None
        and dict(agg.usage_thresholds)
        and agg.usage_aggregation_type
        and nodes.agg_usage is not None
    ):
        a = PERCENTILES.index(agg.usage_aggregation_type)
        mask_default = loadaware_filter_mask(
            nodes.agg_usage[..., a, :], nodes.allocatable, thr, nodes.metric_fresh
        )
        if nodes.agg_fresh is not None:
            mask_default = mask_default | ~nodes.agg_fresh[..., a]
    else:
        mask_default = loadaware_filter_mask(
            nodes.usage, nodes.allocatable, thr, nodes.metric_fresh
        )
    if dict(cfg.loadaware.prod_usage_thresholds):
        # selected by config + pod class alone (load_aware.go:151); a node
        # with no prod-pods metrics passes, which zeros reproduce exactly
        pu = (
            nodes.prod_usage
            if nodes.prod_usage is not None
            else torch.zeros_like(nodes.usage)
        )
        mask_prod = loadaware_filter_mask(
            pu, nodes.allocatable, cfg.prod_thresholds_arr(dev), nodes.metric_fresh
        )
    else:
        mask_prod = mask_default
    return mask_default, mask_prod


def select_score_usage(nodes, cfg):
    """Score-phase usage -> (usage_nonprod i64[N, R], usage_prod or None).

    Non-prod pods score against the score-aggregation percentile when
    configured (plain NodeUsage for nodes without that percentile); prod
    pods score against the prod-pods usage when ScoreAccordingProdUsage is
    set (load_aware.go:291-327).
    """
    agg = cfg.loadaware.aggregated
    usage = nodes.usage
    if (
        agg is not None
        and agg.score_aggregation_type
        and nodes.agg_usage is not None
    ):
        a = PERCENTILES.index(agg.score_aggregation_type)
        sel = nodes.agg_usage[..., a, :]
        if nodes.agg_fresh is not None:
            sel = torch.where(nodes.agg_fresh[..., a, None], sel, usage)
        usage = sel
    prod = None
    if cfg.loadaware.score_according_prod_usage and nodes.prod_usage is not None:
        prod = nodes.prod_usage
    return usage, prod
