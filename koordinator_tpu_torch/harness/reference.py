"""Sequential CPU reference: an exact Python mirror of the reference's Go
scoring/filter/assignment semantics, used for parity testing the cycle
kernels and the Score path.

The port's own copy of ``koordinator_tpu/harness/reference.py``.

Mirrors (paths in the reference's Go tree):
* leastRequestedScore / scorer reduction —
  ``pkg/scheduler/plugins/loadaware/load_aware.go:378-397``.
* LoadAware Score composition — ``load_aware.go:269-335`` (estimator +
  assign-cache + measured usage), Filter — ``load_aware.go:173-224``.
* NodeResourcesFit LeastAllocated/MostAllocated — upstream semantics as in
  ``nodenumaresource/least_allocated.go`` / ``most_allocated.go``.
* The per-pod scheduling cycle with Reserve-time state mutation —
  assign-cache ``load_aware.go:260-267`` + NodeInfo requested accounting.

Everything is plain Python ints (arbitrary precision == int64 semantics for
these magnitudes), no numpy, so it is an independent oracle.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from koordinator_tpu_torch.config import CycleConfig, DEFAULT_CYCLE_CONFIG, MOST_ALLOCATED
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import MAX_NODE_SCORE
from koordinator_tpu_torch.ops.fit import NONZERO_MILLI_CPU, NONZERO_MEMORY

_CPU = res.RESOURCE_INDEX[res.CPU]
_MEM = res.RESOURCE_INDEX[res.MEMORY]


def least_requested_score(requested: int, capacity: int) -> int:
    if capacity == 0 or requested > capacity:
        return 0
    return ((capacity - requested) * MAX_NODE_SCORE) // capacity


def most_requested_score(requested: int, capacity: int) -> int:
    if capacity == 0:
        return 0
    if requested > capacity:
        requested = capacity
    return (requested * MAX_NODE_SCORE) // capacity


def weighted_score(per_res: Sequence[int], weights: Sequence[int]) -> int:
    weight_sum = sum(weights)
    if weight_sum == 0:
        return 0
    return sum(s * w for s, w in zip(per_res, weights)) // weight_sum


def usage_percent(used: int, total: int) -> int:
    """Go: int64(math.Round(float64(used)/float64(total)*100))."""
    if total == 0:
        return 0
    return int(math.floor(used / total * 100 + 0.5))


def nonzero_request(vec: Sequence[int]) -> List[int]:
    out = list(vec)
    if out[_CPU] == 0:
        out[_CPU] = NONZERO_MILLI_CPU
    if out[_MEM] == 0:
        out[_MEM] = NONZERO_MEMORY
    return out


class ReferenceCycle:
    """Sequential scheduling cycle over dense python-int state."""

    def __init__(
        self,
        node_allocatable: Sequence[Sequence[int]],
        node_requested: Sequence[Sequence[int]],
        node_usage: Sequence[Sequence[int]],
        metric_fresh: Sequence[bool],
        cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
        quota_runtime: Optional[Dict[int, List[int]]] = None,
        quota_used: Optional[Dict[int, List[int]]] = None,
        quota_limited: Optional[Dict[int, List[bool]]] = None,
        agg_usage: Optional[Sequence[Optional[Dict[str, Sequence[int]]]]] = None,
        prod_usage: Optional[Sequence[Sequence[int]]] = None,
    ):
        self.alloc = [list(v) for v in node_allocatable]
        self.requested = [list(v) for v in node_requested]
        self.usage = [list(v) for v in node_usage]
        self.estimated = [[0] * res.NUM_RESOURCES for _ in node_allocatable]
        self.fresh = list(metric_fresh)
        self.cfg = cfg
        self.quota_runtime = quota_runtime or {}
        self.quota_used = quota_used or {}
        self.quota_limited = quota_limited or {}
        self.la_weights = res.weights_vector(dict(cfg.loadaware.resource_weights))
        agg = cfg.loadaware.aggregated
        if agg is not None and dict(agg.usage_thresholds):
            thr_src = agg.usage_thresholds
        else:
            thr_src = cfg.loadaware.usage_thresholds
        self.la_thresholds = res.weights_vector(dict(thr_src))
        self.prod_thresholds = res.weights_vector(
            dict(cfg.loadaware.prod_usage_thresholds)
        )
        self.fit_weights = res.weights_vector(dict(cfg.fit_resource_weights))
        # per-node optional {"p50": vec, ...} aggregated usage and prod-pods
        # usage sum (load_aware.go:150-226,291-311)
        self.agg_usage = list(agg_usage) if agg_usage is not None else None
        self.prod_usage = (
            [list(v) for v in prod_usage] if prod_usage is not None else None
        )

    # --- Filter -----------------------------------------------------------
    def fit_ok(self, n: int, pod_req: Sequence[int]) -> bool:
        for r in range(res.NUM_RESOURCES):
            if pod_req[r] > 0 and self.requested[n][r] + pod_req[r] > self.alloc[n][r]:
                return False
        return True

    def loadaware_filter_ok(self, n: int, is_prod: bool = False) -> bool:
        # load_aware.go:150-258: prod pods with ProdUsageThresholds check
        # the prod-pods usage sum INSTEAD; aggregated profiles check the
        # selected percentile (missing aggregates pass); stale metric passes
        if not self.fresh[n]:
            return True
        if is_prod and any(self.prod_thresholds):
            # the prod branch is taken on config + pod class alone
            # (load_aware.go:151); no prod metrics -> pass
            # (filterProdUsage:227 returns nil on empty PodsMetric)
            if self.prod_usage is None:
                return True
            for r in range(res.NUM_RESOURCES):
                threshold = self.prod_thresholds[r]
                if threshold == 0 or self.alloc[n][r] == 0:
                    continue
                if (
                    usage_percent(self.prod_usage[n][r], self.alloc[n][r])
                    >= threshold
                ):
                    return False
            return True
        agg = self.cfg.loadaware.aggregated
        usage = self.usage[n]
        if (
            agg is not None
            and dict(agg.usage_thresholds)
            and agg.usage_aggregation_type
            and self.agg_usage is not None
        ):
            node_agg = self.agg_usage[n]
            if node_agg is None:
                return True  # getTargetAggregatedUsage nil -> pass
            usage = node_agg.get(agg.usage_aggregation_type)
            if usage is None:
                return True  # this percentile not reported -> pass
        for r in range(res.NUM_RESOURCES):
            threshold = self.la_thresholds[r]
            if threshold == 0 or self.alloc[n][r] == 0:
                continue
            if usage_percent(usage[r], self.alloc[n][r]) >= threshold:
                return False
        return True

    def quota_ok(self, qid: int, pod_req: Sequence[int]) -> bool:
        """Admission only on the quota's declared dimensions (elasticquota
        PreFilter checks used+request vs runtime per declared resource)."""
        if qid < 0 or qid not in self.quota_runtime:
            return True
        used = self.quota_used.setdefault(qid, [0] * res.NUM_RESOURCES)
        rt = self.quota_runtime[qid]
        # Declared-but-zero runtime dims must reject (the reference keeps
        # declared dims in the runtime list with explicit zeros; undeclared
        # dims fall open); callers pass quota_limited for that.
        limited = self.quota_limited.get(qid)
        if limited is None:
            limited = [v > 0 for v in rt]
        return all(
            used[r] + pod_req[r] <= rt[r]
            for r in range(res.NUM_RESOURCES)
            if limited[r]
        )

    # --- Score ------------------------------------------------------------
    def loadaware_score(
        self, n: int, pod_est: Sequence[int], is_prod: bool = False
    ) -> int:
        if not self.fresh[n]:
            return 0
        usage = self.usage[n]
        if (
            is_prod
            and self.cfg.loadaware.score_according_prod_usage
            and self.prod_usage is not None
        ):
            usage = self.prod_usage[n]
        else:
            agg = self.cfg.loadaware.aggregated
            if (
                agg is not None
                and agg.score_aggregation_type
                and self.agg_usage is not None
                and self.agg_usage[n] is not None
            ):
                # missing percentile -> plain NodeUsage
                usage = self.agg_usage[n].get(
                    agg.score_aggregation_type, self.usage[n]
                )
        per_res = [
            least_requested_score(
                usage[r] + self.estimated[n][r] + pod_est[r], self.alloc[n][r]
            )
            for r in range(res.NUM_RESOURCES)
        ]
        # scorer iterates only weighted resources (weight 0 excluded)
        return weighted_score(per_res, self.la_weights)

    def fit_score(self, n: int, pod_req_nonzero: Sequence[int]) -> int:
        score_fn = (
            most_requested_score
            if self.cfg.fit_scoring_strategy == MOST_ALLOCATED
            else least_requested_score
        )
        per_res = [
            score_fn(self.requested[n][r] + pod_req_nonzero[r], self.alloc[n][r])
            for r in range(res.NUM_RESOURCES)
        ]
        return weighted_score(per_res, self.fit_weights)

    def combined_score(
        self,
        n: int,
        pod_req: Sequence[int],
        pod_est: Sequence[int],
        is_prod: bool = False,
    ) -> int:
        total = 0
        if self.cfg.enable_fit_score:
            total += self.cfg.fit_plugin_weight * self.fit_score(
                n, nonzero_request(pod_req)
            )
        if self.cfg.enable_loadaware:
            total += self.cfg.loadaware_plugin_weight * self.loadaware_score(
                n, pod_est, is_prod
            )
        return total

    # --- One pod ----------------------------------------------------------
    def schedule_one(
        self,
        pod_req: Sequence[int],
        pod_est: Sequence[int],
        quota_id: int = -1,
        is_prod: bool = False,
    ) -> Tuple[int, List[int]]:
        """Filter+Score+Reserve for one pod; returns (node or -1, score row)."""
        n_nodes = len(self.alloc)
        scores = [0] * n_nodes
        best, best_score = -1, None
        quota_fits = self.quota_ok(quota_id, pod_req)
        for n in range(n_nodes):
            feasible = (
                quota_fits
                and self.fit_ok(n, pod_req)
                and (
                    not self.cfg.enable_loadaware
                    or self.loadaware_filter_ok(n, is_prod)
                )
            )
            s = self.combined_score(n, pod_req, pod_est, is_prod)
            scores[n] = s
            if feasible and (best_score is None or s > best_score):
                best, best_score = n, s
        if best >= 0:
            for r in range(res.NUM_RESOURCES):
                self.requested[best][r] += pod_req[r]
                self.estimated[best][r] += pod_est[r]
            if quota_id >= 0 and quota_id in self.quota_runtime:
                used = self.quota_used.setdefault(quota_id, [0] * res.NUM_RESOURCES)
                for r in range(res.NUM_RESOURCES):
                    used[r] += pod_req[r]
        return best, scores

    def schedule_batch(
        self,
        pod_requests: Sequence[Sequence[int]],
        pod_estimated: Sequence[Sequence[int]],
        priorities: Optional[Sequence[int]] = None,
        quota_ids: Optional[Sequence[int]] = None,
        is_prod: Optional[Sequence[bool]] = None,
    ) -> List[int]:
        """Sequential cycle over the batch in queue order (priority desc)."""
        n_pods = len(pod_requests)
        order = sorted(
            range(n_pods),
            key=lambda i: (-(priorities[i] if priorities else 0), i),
        )
        assignment = [-1] * n_pods
        for i in order:
            qid = quota_ids[i] if quota_ids else -1
            assignment[i], _ = self.schedule_one(
                pod_requests[i],
                pod_estimated[i],
                qid,
                bool(is_prod[i]) if is_prod is not None else False,
            )
        return assignment
