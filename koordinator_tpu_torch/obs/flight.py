"""Flight recorder: the last K cycles, reconstructable after the fact.

A ring buffer of committed cycle records (obs/spans.py
``CycleSpans.to_record()`` dicts) plus the config knobs and snapshot
ids that produced them.  On a cycle error, a kernel demotion, or
SIGUSR1, the whole ring is dumped as ONE schema-validated JSON file
under the daemon's ``--state-dir`` (``<state-dir>/flight/``) — so a bad
cycle is diagnosable from the artifact, not from whatever happened to
be in the log buffer (the BENCH_r05 class: a regression that was only
caught because a run timed out).

The dump schema is enforced by :func:`validate_flight_dump` (stdlib
only, mirroring bench.py's ``_validate_artifact`` convention): a
malformed dump is suppressed with a log line rather than archived as a
diagnosis.  Writes are atomic (tmp + rename) so a crash mid-dump never
leaves a torn JSON file.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import time
from typing import Dict, List, Optional

from koordinator_tpu_torch.obs.lockwitness import witness_rlock

logger = logging.getLogger(__name__)

FLIGHT_DUMP_VERSION = 1
DEFAULT_CAPACITY = 64
# dump-file churn guard: misbehaving triggers (a demotion storm) must
# not fill the state dir; oldest dumps are pruned past this count
MAX_DUMPS_KEPT = 32

_NUMBER = (int, float)


def _finite(v) -> bool:
    return (
        isinstance(v, _NUMBER)
        and not isinstance(v, bool)
        and v == v
        and v not in (float("inf"), float("-inf"))
    )


def _check_span(span, where: str, problems: List[str]) -> None:
    if not isinstance(span, dict):
        problems.append(f"{where} is not an object")
        return
    name = span.get("name")
    if not isinstance(name, str) or not name:
        problems.append(f"{where}.name must be a non-empty string")
    if not _finite(span.get("start_ms")) or span.get("start_ms") < 0:
        problems.append(f"{where}.start_ms must be a finite number >= 0")
    dur = span.get("dur_ms")
    if dur is not None and (not _finite(dur) or dur < 0):
        problems.append(
            f"{where}.dur_ms must be null or a finite number >= 0"
        )


def _check_cycle(cyc, where: str, problems: List[str]) -> None:
    if not isinstance(cyc, dict):
        problems.append(f"{where} is not an object")
        return
    cid = cyc.get("cycle_id")
    if not isinstance(cid, str) or not cid:
        problems.append(f"{where}.cycle_id must be a non-empty string")
    sid = cyc.get("snapshot_id")
    if sid is not None and not isinstance(sid, str):
        problems.append(f"{where}.snapshot_id must be null or a string")
    # distributed-trace correlation: the trace id of the
    # request the cycle served, when the client sent one — nullable,
    # never any other type
    tid = cyc.get("trace_id")
    if tid is not None and not isinstance(tid, str):
        problems.append(f"{where}.trace_id must be null or a string")
    if not _finite(cyc.get("started_unix")):
        problems.append(f"{where}.started_unix must be a finite number")
    err = cyc.get("error")
    if err is not None and not isinstance(err, str):
        problems.append(f"{where}.error must be null or a string")
    spans = cyc.get("spans")
    if not isinstance(spans, list):
        problems.append(f"{where}.spans must be a list")
    else:
        for i, span in enumerate(spans):
            _check_span(span, f"{where}.spans[{i}]", problems)
    notes = cyc.get("notes")
    if not isinstance(notes, dict):
        problems.append(f"{where}.notes must be an object")
    else:
        for k, v in notes.items():
            if v is not None and not isinstance(v, (str, int, float, bool)):
                problems.append(
                    f"{where}.notes[{k!r}] must be a JSON scalar or null"
                )


def validate_flight_dump(doc) -> List[str]:
    """Schema over a flight dump document; returns problems (empty =
    valid).  The writer validates before writing; tests validate the
    written file — both through this ONE function."""
    if not isinstance(doc, dict):
        return ["dump is not a JSON object"]
    problems: List[str] = []
    if doc.get("version") != FLIGHT_DUMP_VERSION:
        problems.append(f"version must be {FLIGHT_DUMP_VERSION}")
    reason = doc.get("reason")
    if not isinstance(reason, str) or not reason:
        problems.append("reason must be a non-empty string")
    if not _finite(doc.get("dumped_at_unix")):
        problems.append("dumped_at_unix must be a finite number")
    if not isinstance(doc.get("config"), dict):
        problems.append("config must be an object")
    dropped = doc.get("dropped_cycles")
    if not isinstance(dropped, int) or isinstance(dropped, bool) or dropped < 0:
        problems.append("dropped_cycles must be an int >= 0")
    extra = doc.get("extra")
    if extra is not None:
        if not isinstance(extra, dict):
            problems.append("extra must be an object")
        else:
            for k, v in extra.items():
                if v is not None and not isinstance(v, (str, int, float, bool)):
                    problems.append(
                        f"extra[{k!r}] must be a JSON scalar or null"
                    )
    cycles = doc.get("cycles")
    if not isinstance(cycles, list):
        problems.append("cycles must be a list")
    else:
        for i, cyc in enumerate(cycles):
            _check_cycle(cyc, f"cycles[{i}]", problems)
    return problems


class FlightRecorder:
    """Ring of the last ``capacity`` cycle records; ``dump()`` persists
    them.  Thread-safe: the SIGUSR1 handler and the serve threads race
    on the ring."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        state_dir: Optional[str] = None,
        config: Optional[Dict[str, object]] = None,
        wall_clock=time.time,
    ):
        self.capacity = int(capacity)
        self.state_dir = state_dir
        # config knobs frozen into every dump (CycleConfig wave/top_m,
        # strategy names — whatever the owner deems reconstruction-worthy)
        self.config: Dict[str, object] = dict(config or {})
        self._wall_clock = wall_clock
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        # RLock, not Lock: the SIGUSR1 handler runs on the main thread
        # between bytecodes and may interrupt record() while it holds
        # the lock — a non-reentrant lock would deadlock the dump
        self._lock = witness_rlock("obs.flight.FlightRecorder._lock")
        self._dump_seq = 0
        self.dropped = 0  # cycles that fell off the ring, for the dump
        # per-reason dump rate limit: a flood of one trigger (a client
        # looping bad frames, a demotion storm) must not stall serving
        # on disk I/O per event NOR churn real post-mortem dumps out of
        # the pruned directory.  sigusr1 is exempt — the operator asked.
        self.min_dump_interval_s = 10.0
        self._last_dump: Dict[str, float] = {}
        self.dumps_suppressed = 0

    def record(self, cycle_record: Dict[str, object]) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(cycle_record)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> List[Dict[str, object]]:
        """Oldest-first copy of the ring (the dump body)."""
        with self._lock:
            return list(self._ring)

    def document(
        self, reason: str, extra: Optional[Dict[str, object]] = None
    ) -> Dict[str, object]:
        doc = {
            "version": FLIGHT_DUMP_VERSION,
            "reason": reason,
            "dumped_at_unix": self._wall_clock(),
            "config": dict(self.config),
            "dropped_cycles": self.dropped,
            "cycles": self.snapshot(),
        }
        if extra:
            doc["extra"] = dict(extra)
        return doc

    def dump(
        self, reason: str, extra: Optional[Dict[str, object]] = None
    ) -> Optional[str]:
        """Write the ring under ``<state_dir>/flight/``; returns the
        path, or None when no state dir is configured, the document
        fails its own schema, or the write fails (a diagnostics dump
        must never take the serving path down with it).  ``extra``
        carries trigger-specific scalars (e.g. the demoted bucket)."""
        if not self.state_dir:
            return None
        if reason != "sigusr1":
            now = time.monotonic()
            with self._lock:
                last = self._last_dump.get(reason)
                if last is not None and now - last < self.min_dump_interval_s:
                    self.dumps_suppressed += 1
                    return None
        doc = self.document(reason, extra=extra)
        problems = validate_flight_dump(doc)
        if problems:
            logger.error(
                "flight dump (%s) failed schema validation, suppressed: %s",
                reason, "; ".join(problems),
            )
            return None
        flight_dir = os.path.join(self.state_dir, "flight")
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        name = f"koord-flight-{int(doc['dumped_at_unix'])}-{seq:04d}-{reason}.json"
        path = os.path.join(flight_dir, name)
        try:
            os.makedirs(flight_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            self._prune(flight_dir)
        except OSError as exc:
            logger.error("flight dump (%s) write failed: %s", reason, exc)
            return None
        # stamp the rate limit only AFTER a successful write: a failed
        # attempt (ENOSPC, permissions) must not close the post-mortem
        # window for the retry that would have succeeded
        with self._lock:
            self._last_dump[reason] = time.monotonic()
        return path

    @staticmethod
    def _prune(flight_dir: str) -> None:
        try:
            dumps = sorted(
                f for f in os.listdir(flight_dir)
                if f.startswith("koord-flight-") and f.endswith(".json")
            )
            for stale in dumps[:-MAX_DUMPS_KEPT]:
                os.unlink(os.path.join(flight_dir, stale))
        except OSError:
            logger.warning(
                "flight dump pruning failed in %s", flight_dir, exc_info=True
            )

    def install_sigusr1(self) -> bool:
        """Dump on SIGUSR1 (operator: ``kill -USR1 <daemon pid>``).
        Returns False off the main thread (signal.signal's constraint) —
        callers treat that as "no signal trigger", not an error."""
        def _on_sigusr1(signum, frame):
            self.dump("sigusr1")

        try:
            signal.signal(signal.SIGUSR1, _on_sigusr1)
        except ValueError:
            return False
        return True
