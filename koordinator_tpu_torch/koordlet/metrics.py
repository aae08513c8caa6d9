"""Prometheus-style metrics registry with text exposition.

Reference: ``pkg/koordlet/metrics`` (CPI ``cpi.go``, PSI ``psi.go``,
cpu_suppress / cpu_burst / prediction gauges, common node labels
``common.go:26,79``) exposed on ``/metrics``
(``cmd/koordlet/main.go:82-90``).  No prometheus_client dependency: the
registry renders the text exposition format directly, which is all the
scrape path needs.

Family registration is IDEMPOTENT and kind-checked: every metric name
maps to exactly one family (counter, gauge or histogram), so a daemon
restart that re-registers its families cannot emit duplicate
``# HELP``/``# TYPE`` lines (the pre-fix render walked the counter and
gauge tables independently, and a name that had landed in both — e.g. a
family re-registered under a different kind across restarts — rendered
twice, which Prometheus rejects as a duplicate family).  Re-registering
the same name with a conflicting kind raises instead of silently
splitting the series.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# cycle latencies span sub-ms warm cycles to multi-second cold compiles
DEFAULT_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, float("inf"),
)


def _key(labels: Optional[Mapping[str, str]]) -> LabelKey:
    return tuple(sorted((labels or {}).items()))


def _render_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else f"{bound:g}"


def _norm_buckets(buckets: Sequence[float]) -> Tuple[float, ...]:
    """Prometheus requires the +Inf bucket (it must equal _count);
    custom bucket lists that omit it would silently drop over-top
    observations from every bucket and render an invalid histogram."""
    out = tuple(float(b) for b in buckets)
    if not out or not math.isinf(out[-1]):
        out = out + (float("inf"),)
    return out


class _Family:
    """One metric family: a kind, help text, and its labeled series."""

    __slots__ = ("kind", "help", "series", "buckets")

    def __init__(self, kind: str, help_text: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.kind = kind
        self.help = help_text
        # counter/gauge: LabelKey -> float
        # histogram:     LabelKey -> [bucket_counts..., sum, count]
        self.series: Dict[LabelKey, object] = {}
        self.buckets: Optional[Tuple[float, ...]] = (
            tuple(buckets) if buckets is not None else None
        )


class MetricsRegistry:
    """Counters, gauges and histograms with labels; render() emits the
    Prometheus text exposition format."""

    def __init__(self, common_labels: Optional[Mapping[str, str]] = None):
        # common node labels (common.go:26: node name merged into every
        # series)
        self.common = dict(common_labels or {})
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- registration (idempotent; the duplicate-family fix) --
    def _family_locked(self, name: str, kind: str,
                buckets: Optional[Sequence[float]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(
                kind,
                buckets=_norm_buckets(buckets) if buckets is not None else None,
            )
            self._families[name] = fam
        elif fam.kind == "":
            fam.kind = kind  # describe() created a kindless placeholder
        elif fam.kind != kind:
            raise ValueError(
                f"metric family {name!r} already registered as "
                f"{fam.kind}; cannot re-register as {kind} (duplicate "
                "# TYPE lines are invalid exposition)"
            )
        return fam

    def register(self, name: str, kind: str, help_text: str = "",
                 buckets: Optional[Sequence[float]] = None) -> None:
        """Declare a family up front.  Safe to call any number of times
        (daemon restarts re-register); a kind conflict raises."""
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric kind {kind!r}")
        with self._lock:
            fam = self._family_locked(
                name, kind,
                buckets=buckets if kind == "histogram" else None,
            )
            if help_text:
                fam.help = help_text
            if kind == "histogram" and buckets is not None:
                want = _norm_buckets(buckets)
                if fam.buckets is None:
                    fam.buckets = want
                elif fam.buckets != want and fam.series:
                    raise ValueError(
                        f"histogram {name!r} re-registered with different "
                        "buckets while series exist"
                    )
                else:
                    fam.buckets = want

    def describe(self, name: str, help_text: str) -> None:
        """Attach help text; kind is bound at first write/register."""
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                fam.help = help_text
            else:
                # remembered until the first write binds a kind
                self._families[name] = _Family("", help_text)

    def _bind_locked(self, name: str, kind: str) -> _Family:
        return self._family_locked(name, kind)

    # -- writes --
    def counter_add(
        self, name: str, value: float, labels: Optional[Mapping[str, str]] = None
    ) -> None:
        with self._lock:
            fam = self._bind_locked(name, "counter")
            k = _key({**self.common, **(labels or {})})
            fam.series[k] = fam.series.get(k, 0.0) + value

    def gauge_set(
        self, name: str, value: float, labels: Optional[Mapping[str, str]] = None
    ) -> None:
        with self._lock:
            self._bind_locked(name, "gauge").series[
                _key({**self.common, **(labels or {})})
            ] = value

    def histogram_observe(
        self, name: str, value: float, labels: Optional[Mapping[str, str]] = None
    ) -> None:
        with self._lock:
            fam = self._bind_locked(name, "histogram")
            if fam.buckets is None:
                fam.buckets = DEFAULT_BUCKETS_MS
            k = _key({**self.common, **(labels or {})})
            state = fam.series.get(k)
            if state is None:
                state = [0] * len(fam.buckets) + [0.0, 0]
                fam.series[k] = state
            for i, bound in enumerate(fam.buckets):
                if value <= bound:
                    state[i] += 1
            state[-2] += value  # _sum
            state[-1] += 1  # _count

    # -- reads (test/introspection seam) --
    def get(
        self, name: str, labels: Optional[Mapping[str, str]] = None
    ) -> Optional[float]:
        k = _key({**self.common, **(labels or {})})
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind not in ("counter", "gauge"):
                return None
            return fam.series.get(k)

    def get_histogram(
        self, name: str, labels: Optional[Mapping[str, str]] = None
    ) -> Optional[Tuple[int, float]]:
        """(count, sum) of one histogram series, or None."""
        k = _key({**self.common, **(labels or {})})
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind != "histogram":
                return None
            state = fam.series.get(k)
            if state is None:
                return None
            return int(state[-1]), float(state[-2])

    def histogram_series(
        self, name: str
    ) -> List[Tuple[Dict[str, str], Tuple[float, ...], Tuple[int, ...], float, int]]:
        """Every series of one histogram family as
        ``(labels, bucket_bounds, cumulative_counts, sum, count)`` —
        the read seam obs/slo.py's quantile estimator consumes.
        ``cumulative_counts[i]`` is observations ``<= bucket_bounds[i]``
        (the exposition's ``_bucket{le=...}`` semantics).  Copies are
        returned, so callers can diff windows without racing writers."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind != "histogram" or fam.buckets is None:
                return []
            n = len(fam.buckets)
            return [
                (dict(k), fam.buckets, tuple(state[:n]),
                 float(state[-2]), int(state[-1]))
                for k, state in fam.series.items()
            ]

    # -- the koordlet metric families (metrics/*.go) --
    def record_container_cpi(
        self, pod: str, container: str, cycles: float, instructions: float
    ) -> None:
        labels = {"pod": pod, "container": container}
        self.gauge_set("koordlet_container_cpi_cycles", cycles, labels)
        self.gauge_set("koordlet_container_cpi_instructions", instructions, labels)

    def record_psi(
        self, resource: str, level: str, avg10: float, labels=None
    ) -> None:
        self.gauge_set(
            "koordlet_psi_avg10",
            avg10,
            {**(labels or {}), "resource": resource, "level": level},
        )

    def record_be_suppress(self, cpu_cores_milli: float) -> None:
        self.gauge_set("koordlet_be_suppress_cpu_cores", cpu_cores_milli / 1000.0)

    def record_cpu_burst(self, pod: str, container: str, burst_us: float) -> None:
        self.gauge_set(
            "koordlet_container_cpu_burst_us",
            burst_us,
            {"pod": pod, "container": container},
        )

    def record_prediction(self, key: str, peak: float) -> None:
        self.gauge_set("koordlet_prediction_peak", peak, {"key": key})

    def render(self) -> str:
        """Prometheus text exposition (the /metrics body).  Every family
        renders exactly once — one # HELP, one # TYPE — regardless of
        how many times it was registered."""
        out: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if not fam.kind or not fam.series:
                    continue  # described but never written
                if fam.help:
                    out.append(f"# HELP {name} {fam.help}")
                out.append(f"# TYPE {name} {fam.kind}")
                if fam.kind == "histogram":
                    for k in sorted(fam.series):
                        state = fam.series[k]
                        for i, bound in enumerate(fam.buckets):
                            lk = k + (("le", _fmt_le(bound)),)
                            out.append(
                                f"{name}_bucket{_render_labels(lk)} "
                                f"{state[i]}"
                            )
                        out.append(
                            f"{name}_sum{_render_labels(k)} {state[-2]:g}"
                        )
                        out.append(
                            f"{name}_count{_render_labels(k)} {state[-1]}"
                        )
                else:
                    for k in sorted(fam.series):
                        out.append(
                            f"{name}{_render_labels(k)} {fam.series[k]:g}"
                        )
        return "\n".join(out) + "\n"

    # -- WSGI /metrics endpoint (main.go:82-90) --
    def wsgi_app(self, environ, start_response):
        body = self.render().encode()
        start_response(
            "200 OK",
            [("Content-Type", "text/plain; version=0.0.4"),
             ("Content-Length", str(len(body)))],
        )
        return [body]
