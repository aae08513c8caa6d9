"""Cycle telemetry of the scorer seam: a copy of ``koordinator_tpu/obs``.

Three layers, composed by :class:`CycleTelemetry` (one per
ScorerServicer):

* **spans** (obs/spans.py) — a monotonic span recorder with explicit
  cycle ids ("c<epoch>-<seq>", correlating with "s<epoch>-<gen>"
  snapshot ids and echoed to clients in AssignReply.cycle_id).  Records
  host-side stages (Sync decode, delta scatter, dispatch, readback) and
  device-derived stats the solver already returns (rounds, path) after
  the caller read them back; and, while the launch ledger is on or a
  Profile window open, each RPC's stage spans ``server.<rpc>.<stage>``
  on one Unix-anchored clock.
* **metrics** (obs/scorer_metrics.py) — the koord_scorer_* Prometheus
  families over koordlet/metrics.py.
* **flight** (obs/flight.py) — a ring buffer of the last K cycles'
  records + config knobs + snapshot ids, dumped as schema-validated
  JSON under a state directory on cycle error, kernel demotion, or
  SIGUSR1.

The port compiles no programs at run time, so the reference's jit
cache-miss feed has no counterpart here; kernel demotions feed the
metrics and the flight recorder through
``solver.register_demotion_listener``.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from koordinator_tpu_torch.obs.export import (  # noqa: F401
    SpanExporter,
    resolve_export_dir,
)
from koordinator_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    validate_flight_dump,
)
from koordinator_tpu_torch.obs.scorer_metrics import ScorerMetrics
from koordinator_tpu_torch.obs.spans import (  # noqa: F401
    ClientTraceOp,
    CycleScope,
    SpanRecorder,
    TraceSpan,
)

logger = logging.getLogger(__name__)


def _config_knobs(cfg) -> Dict[str, object]:
    """The CycleConfig knobs worth reconstructing a bad cycle from."""
    if cfg is None:
        return {}
    return {
        "wave": int(getattr(cfg, "wave", 1)),
        "top_m": int(getattr(cfg, "top_m", 0)),
        "fit_scoring_strategy": getattr(cfg, "fit_scoring_strategy", ""),
        "enable_loadaware": bool(getattr(cfg, "enable_loadaware", False)),
        "enable_fit_score": bool(getattr(cfg, "enable_fit_score", False)),
    }


class CycleTelemetry:
    """Spans + scorer metrics + flight recorder, wired to the process
    feed of kernel demotions (solver.register_demotion_listener)."""

    def __init__(
        self,
        epoch: str = "",
        cfg=None,
        state_dir: Optional[str] = None,
        capacity: int = 64,
        registry=None,
        trace_export: Optional[str] = None,
    ):
        self.spans = SpanRecorder(epoch=epoch)
        self.metrics = ScorerMetrics(registry=registry)
        self.registry = self.metrics.registry
        self.flight = FlightRecorder(
            capacity=capacity, state_dir=state_dir,
            config={"epoch": epoch, **_config_knobs(cfg)},
        )
        # distributed-trace export: completed TraceSpans
        # flow recorder -> trace_sink -> exporter as OTLP-shaped JSON
        # lines under the export dir ("<state-dir>/traces" by default
        # when --trace-export / KOORD_TRACE_EXPORT turns it on).  With
        # no exporter the sink still feeds the span-count family —
        # spans only exist when a client stamped a trace_id, so the
        # counter is exact either way.
        self.exporter: Optional[SpanExporter] = None
        directory = resolve_export_dir(trace_export, state_dir)
        if directory is not None:
            self.exporter = SpanExporter(
                directory,
                on_drop=self.metrics.count_trace_export_dropped,
            )
        self.spans.trace_sink = self._sink_trace_span
        self._unhooks = []
        self._install_feeds()

    def _sink_trace_span(self, record) -> None:
        self.metrics.count_trace_span(str(record.get("kind") or "unknown"))
        if self.exporter is not None:
            self.exporter.export(record)

    # -- process-wide feeds --
    def _install_feeds(self) -> None:
        from koordinator_tpu_torch import solver

        self._unhooks.append(
            solver.register_demotion_listener(self.on_demotion)
        )

    def close(self) -> None:
        """Unhook the process-wide feeds (tests; daemons run for life)
        and close the span exporter handle."""
        for unhook in self._unhooks:
            try:
                unhook()
            except Exception:  # best-effort teardown; one failed unhook must not keep the rest hooked
                logger.warning("telemetry unhook failed", exc_info=True)
        self._unhooks = []
        if self.exporter is not None:
            self.exporter.close()

    # -- event sinks --
    def on_demotion(self, bucket, failures) -> None:
        """Kernel demotions are PROCESS-global (solver module state) and
        this fires on the demoting thread, which may not be this
        telemetry's servicer thread — so only thread-safe sinks here:
        the locked registry and the RLock'd flight recorder.  Never the
        span recorder (unlocked by design; owned by the RPC thread).
        The demoted bucket rides the dump itself."""
        self.metrics.count_demotion()
        self.flight.dump(
            "demotion",
            extra={
                "bucket": "/".join(map(str, bucket)),
                "failures": int(failures),
            },
        )

    def record_sync(self, info, snapshot_id: str, epoch: str,
                    generation: int) -> None:
        self.metrics.record_sync(info)
        self.metrics.set_snapshot(epoch, generation)
        spans = self.spans
        spans.current(snapshot_id=snapshot_id)
        spans.note("sync_path", info.get("path"))

    def commit_cycle(
        self,
        latency_ms: float,
        path: str,
        wave: int = 1,
        rounds: Optional[int] = None,
    ) -> Dict[str, object]:
        """Close the current cycle: metrics + flight ring."""
        self.metrics.observe_cycle(latency_ms, path, wave, rounds=rounds)
        spans = self.spans
        spans.note("path", path)
        spans.note("latency_ms", round(float(latency_ms), 3))
        if rounds is not None:
            spans.note("rounds", int(rounds))
        record = spans.commit()
        self.flight.record(record)
        return record

    # -- per-RPC scopes (exact records under concurrency) --
    def begin_rpc_scope(
        self,
        snapshot_id: Optional[str] = None,
        cycle_id: Optional[str] = None,
        adopt_pending: bool = True,
        trace_id: Optional[str] = None,
    ):
        """A private cycle for one RPC (see obs/spans.py CycleScope).
        The correlating RPC of a Sync→Score→Assign flow adopts the
        pending cycle atomically; concurrent siblings mint fresh ones
        and can no longer relabel or stamp it.  ``trace_id`` stamps
        the distributed-trace correlation onto the cycle record
        so flight dumps and assembled trees cross-reference."""
        return self.spans.open_scope(
            snapshot_id=snapshot_id, cycle_id=cycle_id,
            adopt_pending=adopt_pending, trace_id=trace_id,
        )

    def commit_scope(
        self,
        scope,
        latency_ms: float,
        path: str,
        wave: int = 1,
        rounds: Optional[int] = None,
    ) -> Dict[str, object]:
        """`commit_cycle`, scoped: metrics + the scope's own record into
        the flight ring.  The recorder's pending cycle is untouched."""
        self.metrics.observe_cycle(latency_ms, path, wave, rounds=rounds)
        scope.note("path", path)
        scope.note("latency_ms", round(float(latency_ms), 3))
        if rounds is not None:
            scope.note("rounds", int(rounds))
        record = scope.commit()
        self.flight.record(record)
        return record

    def abort_scope(
        self, scope, stage: str, exc: BaseException, dump: bool = True
    ) -> None:
        """`abort_cycle`, scoped.  ``dump=False`` records the failed
        cycle in the ring without a disk dump — the client-protocol
        conditions (a displaced Assign) that must stay visible in the
        records but must not churn the dump directory."""
        if dump:
            self.metrics.count_cycle_error(stage)
        record = scope.commit(error=f"{stage}: {exc!r:.300}")
        self.flight.record(record)
        if dump:
            self.flight.dump("cycle-error")

    def abort_cycle(self, stage: str, exc: BaseException) -> None:
        """An UNEXPECTED failure on the cycle pipeline: count it, commit
        the partial record with the error attached, and dump the ring
        for the post-mortem.  Client-rejectable errors (a malformed
        frame bounced by validation) must NOT come here — they are
        counted via ``metrics.count_cycle_error`` alone, so a looping
        bad client can neither churn the ring/dump directory nor commit
        a pending cycle out from under another client's correlation."""
        self.metrics.count_cycle_error(stage)
        record = self.spans.commit(error=f"{stage}: {exc!r:.300}")
        self.flight.record(record)
        self.flight.dump("cycle-error")

    # Sync/Score-only streams (e.g. a non-leader replica whose Assign
    # is refused) never reach commit_cycle; without a backstop their
    # spans pile onto one immortal pending cycle and the flight ring
    # stays empty forever.  Past this many buffered spans the pending
    # cycle is committed as a backlog record at the next frame boundary.
    PENDING_COMMIT_SPANS = 64

    def flush_backlog(self) -> None:
        spans = self.spans
        # pending_spans() is atomic on the recorder (the coalescer's
        # batch leaders call this concurrently with Sync commits)
        if spans.pending_spans() >= self.PENDING_COMMIT_SPANS:
            spans.note("backlog", True)
            self.flight.record(spans.commit())
