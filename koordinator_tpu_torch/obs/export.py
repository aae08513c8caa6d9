"""Span export: completed distributed-trace spans as OTLP-shaped JSON
lines.

Every process that participates in a request — the bridge daemon, each
follower, each pooled client — appends its completed spans
(``obs/spans.py TraceSpan.to_record`` dicts) to its OWN file under one
export directory (``--state-dir/traces`` on the daemon;
``--trace-export`` / ``KOORD_TRACE_EXPORT`` names the directory
everywhere else).  ``python -m koordinator_tpu_torch.obs.assemble`` then
merges the per-process files into whole-request trees offline — no
collector service, no network hop on the serving path.

Contract (the flight-recorder discipline applied to spans):

* **Off the serving path.**  ``export()`` is an ENQUEUE (~µs): one
  background writer thread per exporter does the JSON encode, the
  append and the flush — measured at tens of µs per span, which a
  10-span request cycle must not pay inline.  Span ends already run
  only on RPC bodies and readback closures, never inside a launch
  section.
* **Bounded.**  A file past ``max_bytes`` stops growing and a queue
  past ``max_queue`` stops accepting: further spans DROP with a
  counter (``koord_scorer_trace_export_dropped_total``), never an
  error on the serving path.
* **Rate-limited.**  A span storm past ``max_per_s`` (a misbehaving
  client looping traced requests) drops at enqueue with the same
  counter instead of turning the export file into the bottleneck.
* **Crash-visible.**  The writer flushes each drained batch to the OS,
  and it drains EAGERLY (woken per enqueue), so an in-process leader
  kill loses at most the µs-old tail; ``close()`` joins the writer
  after draining everything queued.

A handle must be ``close()``d; ``export()`` after close
drops, it never raises.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import uuid
from typing import Dict, Optional

from koordinator_tpu_torch.obs.lockwitness import witness_condition

logger = logging.getLogger(__name__)

EXPORT_VERSION = 1

# a span line is ~300-600 bytes; 64 MiB holds ~10^5 spans — a bound on
# disk, not on any realistic replay
DEFAULT_MAX_BYTES = 64 << 20
# spans per second before the limiter sheds (per-process; the serving
# path emits a handful per RPC, so this only fires on a runaway loop)
DEFAULT_MAX_PER_S = 2000.0
# spans queued for the writer before new ones drop (a wedged disk must
# cost spans, not memory)
DEFAULT_MAX_QUEUE = 4096


def export_dir(state_dir: Optional[str]) -> Optional[str]:
    """The daemon's default export location: ``<state-dir>/traces``
    (the flight-dump convention)."""
    if not state_dir:
        return None
    return os.path.join(state_dir, "traces")


def resolve_export_dir(
    trace_export, state_dir: Optional[str] = None
) -> Optional[str]:
    """One resolution rule for every surface (servicer, clients, the
    daemon flag): an explicit directory wins; the boolean-ish values
    "1"/"true"/"yes" (and the bare-flag empty string) mean "the default
    location under state_dir"; ``False`` (or "0"/"off"/"false"/"none")
    forces tracing OFF even when the env is set — the oracle/baseline
    sides of a measured replay need that; unset (None) falls back to
    the ``KOORD_TRACE_EXPORT`` env (same parse).  Returns the export
    directory or None (off)."""
    if trace_export is None:
        trace_export = os.environ.get("KOORD_TRACE_EXPORT") or None
    if trace_export is None or trace_export is False:
        return None
    text = str(trace_export).strip().lower()
    if text in ("0", "off", "false", "none"):
        return None
    if text in ("", "1", "true", "yes"):
        resolved = export_dir(state_dir)
        if resolved is None:
            # tracing was ASKED for but there is no state dir to
            # default under (the client shims have none): exporting
            # nothing silently would leave every assembled trace
            # incomplete and the operator debugging the assembler —
            # say so, once per construction site
            logger.warning(
                "trace export requested (%r) but this process has no "
                "state dir to default under; span export DISABLED — "
                "pass an explicit directory (KOORD_TRACE_EXPORT=/path "
                "or trace_export=/path)",
                trace_export,
            )
        return resolved
    return str(trace_export)


class SpanExporter:
    """Append-only JSON-lines span sink for ONE process, drained by a
    background writer thread.

    The file name carries the pid and a nonce so concurrent processes
    sharing an export directory (leader + followers + client shims —
    the assembly's whole point) never interleave writes.  Thread-safe;
    failures degrade to the drop counter, never to a serving error.
    ``exported`` counts spans ACCEPTED for write; enqueue-time drops
    (closed/rate/queue) return False, writer-side drops
    (bytes/encode/io) are visible in ``dropped`` after ``close()``
    drains."""

    def __init__(
        self,
        directory: str,
        service: str = "koord-scorer",
        max_bytes: int = DEFAULT_MAX_BYTES,
        max_per_s: float = DEFAULT_MAX_PER_S,
        max_queue: int = DEFAULT_MAX_QUEUE,
        on_export=None,
        on_drop=None,
        clock=time.monotonic,
    ):
        self.directory = directory
        self.service = service
        self.max_bytes = int(max_bytes)
        self.max_per_s = float(max_per_s)
        self.max_queue = int(max_queue)
        # observability seams (CycleTelemetry wires the
        # koord_scorer_trace_spans_total / _export_dropped_total
        # families); on_export fires at enqueue (cheap counter bump),
        # on_drop from whichever side dropped
        self.on_export = on_export
        self.on_drop = on_drop
        self._clock = clock
        self._cond = witness_condition("obs.export.SpanExporter._cond")
        self._queue: collections.deque = collections.deque()
        self._writer: Optional[threading.Thread] = None
        self._closed = False
        # writer-thread-only I/O state (single consumer)
        self._fh = None
        self._bytes = 0
        # token bucket for the rate limit: refills at max_per_s, burst
        # of one second's worth
        self._tokens = self.max_per_s
        self._last_refill = clock()
        self.path = os.path.join(
            directory,
            f"spans-{os.getpid()}-{uuid.uuid4().hex[:8]}.jsonl",
        )
        self.exported = 0
        self.dropped = 0

    def _drop(self, reason: str) -> bool:
        # under _cond from export(), lock-free from the writer — the
        # counter is advisory, the hook (a locked registry) is not
        self.dropped += 1
        if self.on_drop is not None:
            try:
                self.on_drop(reason)
            except Exception:  # a metrics hook must never fail the span path
                logger.warning("span-export drop hook failed", exc_info=True)
        return False

    def export(self, record: Dict[str, object]) -> bool:
        """Enqueue one completed span record for the writer (~µs on
        the serving path); returns False when it was dropped at
        enqueue (closed handle, rate limit, full queue).  Writer-side
        failures (byte bound, unencodable record, I/O) drop with a
        counter instead of surfacing here."""
        with self._cond:
            if self._closed:
                return self._drop("closed")
            now = self._clock()
            self._tokens = min(
                self.max_per_s,
                self._tokens + (now - self._last_refill) * self.max_per_s,
            )
            self._last_refill = now
            if self._tokens < 1.0:
                return self._drop("rate")
            if len(self._queue) >= self.max_queue:
                return self._drop("queue")
            self._tokens -= 1.0
            self._queue.append(record)
            self.exported += 1
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._drain_loop,
                    name="koord-span-export",
                    daemon=True,
                )
                self._writer.start()
            self._cond.notify_all()
            if self.on_export is not None:
                try:
                    self.on_export(str(record.get("kind") or "unknown"))
                except Exception:  # a metrics hook must never fail the span path
                    logger.warning(
                        "span-export count hook failed", exc_info=True
                    )
            return True

    # -- writer thread --
    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    # not a poll: every enqueue and close() notifies;
                    # the timeout is a deadlock backstop only
                    self._cond.wait(timeout=1.0)
                batch = list(self._queue)
                self._queue.clear()
                closed = self._closed
            if batch:
                self._write_batch(batch)
            if closed and not batch:
                return

    def _write_batch(self, batch) -> None:
        lines = []
        for record in batch:
            if self._bytes >= self.max_bytes:
                self._drop("bytes")
                continue
            try:
                line = json.dumps(
                    dict(record, resource={
                        "service": self.service,
                        "pid": os.getpid(),
                        "version": EXPORT_VERSION,
                    }),
                    sort_keys=True,
                ) + "\n"
            except (TypeError, ValueError):
                self._drop("encode")
                continue
            self._bytes += len(line)
            lines.append(line)
        if not lines:
            return
        try:
            if self._fh is None:
                os.makedirs(self.directory, exist_ok=True)
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write("".join(lines))
            # per-batch flush to the OS: an in-process leader kill must
            # not eat the spans the post-mortem assembly needs
            self._fh.flush()
        except OSError:
            for _ in lines:
                self._drop("io")

    def close(self) -> None:
        """Drain the queue, stop the writer and close the file.
        Idempotent; an export after close drops with reason "closed"
        instead of raising on a dead file handle."""
        with self._cond:
            self._closed = True
            writer = self._writer
            self._cond.notify_all()
        if writer is not None:
            writer.join(timeout=10.0)
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                logger.warning("span exporter close failed", exc_info=True)

    def __enter__(self) -> "SpanExporter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
