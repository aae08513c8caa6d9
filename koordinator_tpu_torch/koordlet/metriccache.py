"""Metric cache: in-process time-series store with percentile aggregation.

Reference: ``pkg/koordlet/metriccache`` — an embedded Prometheus TSDB plus
an in-memory KV (``metric_cache.go:56``, ``tsdb_storage.go:105``), queried
with AVG/P50/P90/P95/P99/latest/count aggregations by the nodemetric
reporter and the qos strategies.

Array-first shape: samples land in flat numpy ring buffers per (metric,
labels) series — aggregation over a window is one vectorized reduction, and
whole series can be handed to the batched kernels without per-sample
boxing.  Durability mirrors the TSDB directory with an optional npz
snapshot (``save``/``load``).
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import os
import struct
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

# Metric names (reference metriccache/metric_resources.go)
NODE_CPU_USAGE = "node_cpu_usage"  # cores
NODE_MEMORY_USAGE = "node_memory_usage"  # bytes
POD_CPU_USAGE = "pod_cpu_usage"
POD_MEMORY_USAGE = "pod_memory_usage"
CONTAINER_CPU_USAGE = "container_cpu_usage"
CONTAINER_MEMORY_USAGE = "container_memory_usage"
CONTAINER_CPI_CYCLES = "container_cpi_cycles"
CONTAINER_CPI_INSTRUCTIONS = "container_cpi_instructions"
NODE_PSI_CPU_SOME_AVG10 = "node_psi_cpu_some_avg10"
NODE_PSI_MEM_SOME_AVG10 = "node_psi_mem_some_avg10"
NODE_PSI_IO_SOME_AVG10 = "node_psi_io_some_avg10"
BE_CPU_USAGE = "be_cpu_usage"
SYS_CPU_USAGE = "sys_cpu_usage"
COLD_PAGE_BYTES = "cold_page_bytes"
DEVICE_UTIL = "device_util"
DEVICE_MEMORY_USED = "device_memory_used"

AGG_AVG = "AVG"
AGG_P50 = "P50"
AGG_P90 = "P90"
AGG_P95 = "P95"
AGG_P99 = "P99"
AGG_LATEST = "latest"
AGG_COUNT = "count"
AGG_MAX = "max"
AGG_MIN = "min"


def _series_key(metric: str, labels: Mapping[str, str]) -> Tuple:
    return (metric,) + tuple(sorted(labels.items()))


@dataclasses.dataclass
class _Series:
    ts: np.ndarray  # f64[cap]
    values: np.ndarray  # f64[cap]
    head: int = 0  # next write index
    count: int = 0

    def append(self, ts: float, value: float) -> None:
        cap = len(self.ts)
        self.ts[self.head] = ts
        self.values[self.head] = value
        self.head = (self.head + 1) % cap
        self.count = min(self.count + 1, cap)

    def window(self, start: float, end: float) -> np.ndarray:
        ts = self.ts[: self.count]
        vals = self.values[: self.count]
        sel = (ts >= start) & (ts <= end)
        return vals[sel], ts[sel]


class MetricCache:
    """Thread-safe ring-buffer TSDB analog."""

    def __init__(self, capacity_per_series: int = 4096):
        self._cap = capacity_per_series
        self._series: Dict[Tuple, _Series] = {}
        self._kv: Dict[str, object] = {}
        self._lock = threading.Lock()

    # -- TSDB face --

    def append(
        self,
        metric: str,
        value: float,
        *,
        ts: float,
        labels: Optional[Mapping[str, str]] = None,
    ) -> None:
        key = _series_key(metric, labels or {})
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = _Series(
                    ts=np.zeros(self._cap), values=np.zeros(self._cap)
                )
                self._series[key] = s
            s.append(ts, value)

    def query(
        self,
        metric: str,
        *,
        start: float,
        end: float,
        agg: str = AGG_AVG,
        labels: Optional[Mapping[str, str]] = None,
    ) -> Optional[float]:
        """Aggregate one series over [start, end]; None when empty
        (the reference degrades on missing metrics, e.g. LoadAware
        score-0 and noderesource degradeCalculate)."""
        key = _series_key(metric, labels or {})
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return None
            vals, ts = s.window(start, end)
        if len(vals) == 0:
            return None
        if agg == AGG_AVG:
            return float(vals.mean())
        if agg == AGG_LATEST:
            return float(vals[np.argmax(ts)])
        if agg == AGG_COUNT:
            return float(len(vals))
        if agg == AGG_MAX:
            return float(vals.max())
        if agg == AGG_MIN:
            return float(vals.min())
        if agg in (AGG_P50, AGG_P90, AGG_P95, AGG_P99):
            q = {AGG_P50: 50, AGG_P90: 90, AGG_P95: 95, AGG_P99: 99}[agg]
            # lower-interpolation percentile matches the Prometheus
            # histogram-free quantile the reference effectively computes
            return float(np.percentile(vals, q, method="lower"))
        raise ValueError(f"unknown aggregation {agg}")

    def series_labels(self, metric: str) -> List[Dict[str, str]]:
        """All label sets currently stored for ``metric``."""
        with self._lock:
            return [
                dict(key[1:])
                for key in self._series
                if key[0] == metric
            ]

    # -- in-memory KV face (metric_cache.go Get/Set) --

    def set(self, key: str, value: object) -> None:
        with self._lock:
            self._kv[key] = value

    def get(self, key: str) -> Optional[object]:
        with self._lock:
            return self._kv.get(key)

    # -- persistence (tsdb_storage.go directory analog) --

    def save(self, path: str) -> None:
        with self._lock:
            arrays = {}
            index = []
            for i, (key, s) in enumerate(self._series.items()):
                arrays[f"ts_{i}"] = s.ts[: s.count]
                arrays[f"v_{i}"] = s.values[: s.count]
                index.append(repr(key))
            # host-only string array for the npz index — no device
            # value ever enters this cache, so nothing can block here
            arrays["index"] = np.array(index)  # koordlint: disable=lock-held-dispatch(host-only strings; no device value enters this cache)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **arrays)

    def load(self, path: str) -> bool:
        try:
            data = np.load(path, allow_pickle=False)
        except OSError:
            return False
        import ast

        with self._lock:
            for i, key_repr in enumerate(data["index"]):
                key = ast.literal_eval(str(key_repr))
                ts = data[f"ts_{i}"]
                vals = data[f"v_{i}"]
                s = _Series(ts=np.zeros(self._cap), values=np.zeros(self._cap))
                for t, v in zip(ts[-self._cap :], vals[-self._cap :]):
                    s.append(float(t), float(v))
                self._series[tuple(key)] = s
        return True


# ---------------------------------------------------------------------------
# Durable storage: WAL segments (tsdb_storage.go analog)
# ---------------------------------------------------------------------------

# record layout: u32 key-id, f64 ts, f64 value (little-endian)
_REC = struct.Struct("<Iqd")  # ts stored as int64 milliseconds
_KEYDEF = 0xFFFFFFFF  # key-id sentinel: record body is a key definition


class PersistentMetricCache(MetricCache):
    """MetricCache whose appends land in append-only WAL segments and whose
    constructor replays them — a koordlet restart keeps the NodeMetric
    aggregation window intact (the role the reference's embedded Prometheus
    TSDB directory plays, ``metriccache/tsdb_storage.go:105``).

    Segments rotate at ``segment_bytes``; on rotation, segments whose
    newest sample is older than ``retention_seconds`` are deleted (TSDB
    block retention).  Records are fixed-width binary; series keys are
    interned once per segment stream via key-definition records, so the
    steady-state write is 20 bytes per sample.

    Durability contract: every append is flushed (survives process
    restart); sealed segments are fsync'd at rotation (survive host
    crash).  The tail of the *active* segment rides the page cache and
    can lose recent samples to power loss — same trade the reference's
    head-block WAL makes before TSDB block cut.
    """

    def __init__(
        self,
        directory: str,
        capacity_per_series: int = 4096,
        segment_bytes: int = 4 << 20,
        retention_seconds: float = 24 * 3600.0,
    ):
        super().__init__(capacity_per_series=capacity_per_series)
        self.directory = directory
        self.segment_bytes = segment_bytes
        self.retention_seconds = retention_seconds
        self._key_ids: Dict[Tuple, int] = {}
        self._next_key = 0
        self._segment_newest: Dict[str, float] = {}
        self._segment_valid_bytes: Dict[str, int] = {}
        os.makedirs(directory, exist_ok=True)
        self._replay()
        # startup retention sweep: a crash-looping daemon that never fills
        # a segment would otherwise accumulate WAL files forever
        newest_any = max(self._segment_newest.values(), default=0.0)
        self._sweep(newest_any)
        existing = self._segments()
        last_index = (
            int(existing[-1].rsplit("-", 1)[1].split(".")[0])
            if existing
            else -1
        )
        if existing and os.path.getsize(existing[-1]) >= segment_bytes:
            # the last segment is full but the writer died before rotating:
            # it is being sealed implicitly here, so give it the same fsync
            # a normal rotation would have
            with open(existing[-1], "rb") as fh:
                os.fsync(fh.fileno())
        if (
            existing
            and os.path.getsize(existing[-1]) < segment_bytes
        ):
            # reuse the under-sized active segment (its key table is
            # already interned and its ids match the replayed _key_ids).
            # A torn tail from a crash mid-write MUST be truncated first:
            # appending after partial-record garbage would shift the
            # fixed-stride replay off alignment on the next restart.
            valid = self._segment_valid_bytes.get(existing[-1])
            if valid is not None and valid < os.path.getsize(existing[-1]):
                with open(existing[-1], "r+b") as fh:
                    fh.truncate(valid)
            self._seg_index = last_index
            self._fh = open(existing[-1], "ab")
        else:
            self._seg_index = last_index + 1
            self._fh = open(self._segment_path(self._seg_index), "ab")
            # re-intern the key table into the fresh segment so every
            # segment is self-describing (replay never needs another one)
            for key, kid in sorted(
                self._key_ids.items(), key=lambda kv: kv[1]
            ):
                self._fh.write(self._keydef_record(kid, key))
            self._fh.flush()

    # -- write path --
    def append(self, metric, value, *, ts, labels=None):
        super().append(metric, value, ts=ts, labels=labels)
        key = _series_key(metric, labels or {})
        with self._lock:
            kid = self._key_ids.get(key)
            if kid is None:
                kid = self._next_key
                self._next_key += 1
                self._key_ids[key] = kid
                self._fh.write(self._keydef_record(kid, key))
            self._fh.write(_REC.pack(kid, int(ts * 1000), float(value)))
            self._fh.flush()
            seg = self._segment_path(self._seg_index)
            self._segment_newest[seg] = max(
                self._segment_newest.get(seg, 0.0), float(ts)
            )
            if self._fh.tell() >= self.segment_bytes:
                self._rotate(float(ts))

    def close(self):
        with self._lock:
            self._fh.close()

    # -- internals --
    def _segment_path(self, index: int) -> str:
        return os.path.join(self.directory, f"segment-{index:08d}.wal")

    def _segments(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.directory, "segment-*.wal")))

    @staticmethod
    def _keydef_record(kid: int, key: Tuple) -> bytes:
        blob = repr(key).encode()
        return _REC.pack(_KEYDEF, kid, float(len(blob))) + blob

    def _rotate(self, now: float):
        # fsync before sealing: flush() alone leaves the segment in the
        # page cache, so a host crash (not just a process restart) could
        # drop the tail of an otherwise "durable" sealed segment.
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._seg_index += 1
        self._fh = open(self._segment_path(self._seg_index), "ab")
        for key, kid in sorted(self._key_ids.items(), key=lambda kv: kv[1]):
            self._fh.write(self._keydef_record(kid, key))
        self._fh.flush()
        # fsync the directory AFTER creating the new segment so its dirent
        # (and the sealed predecessor's) survives a host crash
        dirfd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._sweep(now)

    def _sweep(self, now: float):
        """Drop whole segments whose newest sample has aged out (TSDB
        block retention)."""
        active = self._segment_path(getattr(self, "_seg_index", -1))
        for seg in self._segments():
            if seg == active:
                continue
            newest = self._segment_newest.get(seg)
            if newest is not None and now - newest > self.retention_seconds:
                os.unlink(seg)
                self._segment_newest.pop(seg, None)

    def _replay(self):
        for seg in self._segments():
            keymap: Dict[int, Tuple] = {}
            newest = 0.0
            try:
                with open(seg, "rb") as fh:
                    data = fh.read()
            except OSError:
                continue
            off = 0
            valid_off = 0
            while off + _REC.size <= len(data):
                kid, ts_ms, value = _REC.unpack_from(data, off)
                off += _REC.size
                if kid == _KEYDEF:
                    blob_len = int(value)
                    blob = data[off : off + blob_len]
                    off += blob_len
                    try:
                        key = tuple(ast.literal_eval(blob.decode()))
                    except (ValueError, SyntaxError):
                        break  # torn key record: stop at the tear
                    keymap[ts_ms] = key  # ts field carries the key id here
                    if key not in self._key_ids:
                        self._key_ids[key] = self._next_key
                        self._next_key += 1
                    valid_off = off
                    continue
                key = keymap.get(kid)
                valid_off = off
                if key is None:
                    continue  # unknown id (foreign tear): skip
                ts = ts_ms / 1000.0
                newest = max(newest, ts)
                metric = key[0]
                labels = dict(key[1:])
                MetricCache.append(self, metric, value, ts=ts, labels=labels)
            self._segment_newest[seg] = newest
            self._segment_valid_bytes[seg] = valid_off
