"""SLO evaluation over the ``koord_scorer_*`` histogram families.

A copy of ``koordinator_tpu/obs/slo.py`` (pure Python), reading the port's
``koordlet/metrics.py`` registry.

The trace-driven replay harness (``harness/trace.py``) turns the observability layer into a perf GATE: a replay does
not just populate histograms, it judges them against declarative SLO
specs and publishes pass/fail verdicts.  This
module is the judging half, and it deliberately has no harness
dependencies — the daemon's ``/healthz`` serves the SAME estimator over
the same registry, so the numbers an operator reads are the numbers
the gate judges.

Three layers:

* :func:`quantile_from_buckets` — Prometheus ``histogram_quantile``
  semantics over one series' cumulative bucket counts: rank
  ``q * count`` located in the first bucket whose cumulative count
  covers it, linearly interpolated from the bucket's lower bound (0
  for the first bucket).  Mass in the ``+Inf`` bucket estimates as the
  last FINITE bound — the estimator never invents a number above what
  the buckets can support (the Prometheus convention; alert thresholds
  should sit below the top finite bound for exactly this reason).
* :func:`histogram_quantile` — the same estimate over a FAMILY in a
  ``koordlet.metrics.MetricsRegistry``, with label-subset aggregation:
  passing ``labels={"rpc": "assign"}`` sums the bucket counts of every
  series whose labels contain that subset (e.g. all bands of the trace
  family), so per-band and per-RPC extractions read one seam.
* :class:`SloSpec` / :func:`evaluate_slos` — a declarative spec names
  a family, a label subset, a quantile and a threshold; a verdict
  carries the observed estimate, the window's sample count and a
  boolean ``ok``.  A spec whose series holds fewer than ``min_count``
  observations FAILS with ``reason="no data"`` — a gate that cannot
  see is a failed gate, never a silently green one.

:class:`SloWindow` adds the operator view: cumulative histograms only
grow, so it snapshots bucket counts per series and quantile-estimates
the DELTA since the previous call — ``/healthz``'s ``slo`` block is one
``advance()`` per scrape (the first call reports the since-boot
window).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

DEFAULT_QUANTILES = (0.5, 0.99)


def quantile_from_buckets(
    bounds: Sequence[float],
    cumulative: Sequence[int],
    q: float,
) -> Optional[float]:
    """Estimate quantile ``q`` from ``cumulative[i]`` = observations
    ``<= bounds[i]`` (ascending bounds, last one ``+Inf``).  Returns
    None for an empty series.  Monotone in ``q`` by construction."""
    if not bounds or not cumulative or len(bounds) != len(cumulative):
        return None
    total = cumulative[-1]
    if total <= 0:
        return None
    q = min(max(float(q), 0.0), 1.0)
    rank = q * total
    for i, bound in enumerate(bounds):
        if cumulative[i] >= rank:
            prev_cum = cumulative[i - 1] if i else 0
            if math.isinf(bound):
                # mass past the top finite bound: report that bound —
                # the estimator cannot support anything higher
                finite = [b for b in bounds if not math.isinf(b)]
                return finite[-1] if finite else None
            lower = bounds[i - 1] if i else 0.0
            in_bucket = cumulative[i] - prev_cum
            if in_bucket <= 0:
                return float(bound)
            return lower + (bound - lower) * (rank - prev_cum) / in_bucket
    return None  # unreachable with a +Inf bucket; defensive


def _matches(series_labels: Mapping[str, str],
             subset: Mapping[str, str]) -> bool:
    return all(series_labels.get(k) == v for k, v in subset.items())


def aggregate_buckets(
    registry,
    family: str,
    labels: Optional[Mapping[str, str]] = None,
) -> Tuple[Tuple[float, ...], List[int], int]:
    """Sum the cumulative bucket counts of every series of ``family``
    whose labels contain the ``labels`` subset.  Returns
    ``(bounds, cumulative, count)`` — empty bounds when no series
    matches (bounds are identical across one family's series, enforced
    at registration)."""
    subset = dict(labels or {})
    bounds: Tuple[float, ...] = ()
    summed: List[int] = []
    count = 0
    for s_labels, s_bounds, s_cum, _s_sum, s_count in registry.histogram_series(
        family
    ):
        if not _matches(s_labels, subset):
            continue
        if not bounds:
            bounds = s_bounds
            summed = [0] * len(bounds)
        for i, c in enumerate(s_cum):
            summed[i] += c
        count += s_count
    return bounds, summed, count


def histogram_quantile(
    registry,
    family: str,
    q: float,
    labels: Optional[Mapping[str, str]] = None,
) -> Optional[float]:
    """Quantile estimate over a registry family, aggregated across
    every series matching the ``labels`` subset (None/{} = the whole
    family)."""
    bounds, cumulative, _count = aggregate_buckets(registry, family, labels)
    return quantile_from_buckets(bounds, cumulative, q)


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative SLO: quantile ``quantile`` of ``family``
    (aggregated over the ``labels`` subset) must sit at or below
    ``threshold_ms``.  ``min_count`` observations must exist in the
    judged window, else the verdict fails with ``no data``."""

    name: str
    family: str
    quantile: float
    threshold_ms: float
    labels: Tuple[Tuple[str, str], ...] = ()
    min_count: int = 1

    def __post_init__(self):
        # accept a plain dict at construction; store the hashable form
        if isinstance(self.labels, Mapping):
            object.__setattr__(
                self, "labels", tuple(sorted(self.labels.items()))
            )

    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)


@dataclasses.dataclass
class SloVerdict:
    """One spec's judgement over one window."""

    spec: SloSpec
    observed_ms: Optional[float]
    count: int
    ok: bool
    reason: str = ""

    def to_doc(self) -> Dict[str, object]:
        """The JSON shape a replay's verdicts are published in."""
        return {
            "name": self.spec.name,
            "quantile": self.spec.quantile,
            "threshold_ms": self.spec.threshold_ms,
            "observed_ms": (
                None if self.observed_ms is None
                else round(float(self.observed_ms), 3)
            ),
            "count": int(self.count),
            "ok": bool(self.ok),
        }


def evaluate_slos(registry, specs: Sequence[SloSpec]) -> List[SloVerdict]:
    out: List[SloVerdict] = []
    for spec in specs:
        bounds, cumulative, count = aggregate_buckets(
            registry, spec.family, spec.labels_dict()
        )
        observed = quantile_from_buckets(bounds, cumulative, spec.quantile)
        if observed is None or count < spec.min_count:
            out.append(SloVerdict(
                spec, observed, count, ok=False,
                reason=f"no data ({count} < {spec.min_count} observations)",
            ))
        elif observed <= spec.threshold_ms:
            out.append(SloVerdict(spec, observed, count, ok=True))
        else:
            out.append(SloVerdict(
                spec, observed, count, ok=False,
                reason=(
                    f"p{spec.quantile * 100:g} {observed:.3f} ms > "
                    f"threshold {spec.threshold_ms:g} ms"
                ),
            ))
    return out


def slos_pass(verdicts: Sequence[SloVerdict]) -> bool:
    return bool(verdicts) and all(v.ok for v in verdicts)


class SloWindow:
    """Delta-window quantiles for the operator surface.  Cumulative
    histograms only grow, so this snapshots per-series bucket counts
    and estimates quantiles over the difference since the previous
    ``advance()`` — the ``/healthz`` ``slo`` block calls it once per
    request, making "last window" = "since the last scrape".  Series
    with no new observations in the window report ``count: 0`` with
    null quantiles (visible, not invented)."""

    def __init__(self, families: Sequence[str],
                 quantiles: Sequence[float] = DEFAULT_QUANTILES):
        self.families = tuple(families)
        self.quantiles = tuple(quantiles)
        # (family, labelkey) -> cumulative counts at the last advance
        self._prev: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Tuple[int, ...]] = {}

    @staticmethod
    def _series_key(labels: Mapping[str, str]) -> str:
        return ",".join(f"{k}={v}" for k, v in sorted(labels.items())) or "all"

    def advance(self, registry) -> Dict[str, Dict[str, Dict[str, object]]]:
        """``{family: {"k=v,...": {"p50": ms|null, "p99": ms|null,
        "count": n}}}`` over the window since the previous call (first
        call: since boot)."""
        out: Dict[str, Dict[str, Dict[str, object]]] = {}
        for family in self.families:
            fam_out: Dict[str, Dict[str, object]] = {}
            for labels, bounds, cum, _sum, _count in registry.histogram_series(
                family
            ):
                key = (family, tuple(sorted(labels.items())))
                prev = self._prev.get(key, (0,) * len(cum))
                delta = [c - p for c, p in zip(cum, prev)]
                self._prev[key] = tuple(cum)
                entry: Dict[str, object] = {"count": delta[-1] if delta else 0}
                for q in self.quantiles:
                    est = quantile_from_buckets(bounds, delta, q)
                    entry[f"p{q * 100:g}"] = (
                        None if est is None else round(est, 3)
                    )
                fam_out[self._series_key(labels)] = entry
            if fam_out:
                out[family] = fam_out
        return out
