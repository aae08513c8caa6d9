"""The traced run's device window: a ``torch.profiler`` window over part of
the measured window, read back from its chrome trace.

The window opens and closes between two steps.  Its digest gives the device
busy time (the union of kernel, memcpy and memset intervals inside the
profiler's span), the time of each device operation by name, and the idle
time inside the span split by the RPC the servicer was handling on the host
(``kbench.sync``, ``kbench.score``, ``kbench.assign``; ``between_calls``
otherwise).  The servicer handles RPCs on a thread the profiler does not
record, so those spans are noted by the wall clock (:meth:`Window.note`)
and placed on the trace's timeline, whose ``ts`` counts microseconds from
``baseTimeNanoseconds`` of the same clock.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_PREFIX = "kbench."
BETWEEN = "between_calls"


class Window:
    """One profiler window; ``digest()`` after ``stop()``."""

    def __init__(self, out_dir: str, on_card: bool = True):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._path = os.path.join(out_dir, "kbench_trace.json")
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        self._prof = profile(activities=activities)
        self._sync = torch.cuda.synchronize if on_card else (lambda: None)
        self.open = False
        self._spans: List[Tuple[int, int, str]] = []

    def start(self) -> None:
        self._sync()
        self._prof.__enter__()
        self.open = True

    def stop(self) -> None:
        self._sync()
        self._prof.__exit__(None, None, None)
        self.open = False

    def note(self, name: str, start_ns: int, end_ns: int) -> None:
        """A host span (``time.time_ns()`` at both ends) while the window is open."""
        if self.open:
            self._spans.append((start_ns, end_ns, name))

    def digest(self) -> dict:
        """The window's digest, read after the measured window closed."""
        self._prof.export_chrome_trace(self._path)
        try:
            with open(self._path) as f:
                doc = json.load(f)
        finally:
            os.unlink(self._path)
        base = int(doc.get("baseTimeNanoseconds", 0))
        doc.setdefault("traceEvents", []).extend(
            {"ph": "X", "cat": "user_annotation", "name": name, "ts": (a - base) / 1e3,
             "dur": (b - a) / 1e3} for a, b, name in self._spans)
        return digest(doc)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def digest(doc: dict) -> dict:
    """The window's numbers, in seconds, from a chrome trace document."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    span = next((e for e in events if e.get("cat") == "Trace"
                 or str(e.get("name", "")).startswith("PyTorch Profiler")), None)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if span is not None:
        lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    elif events:
        lo = min(float(e["ts"]) for e in events)
        hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    else:
        lo = hi = 0.0
    busy = _union([(max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])))
                   for e in device])
    ops: Dict[str, List[float]] = {}
    for e in device:
        name = "memcpy" if e["cat"] == "gpu_memcpy" else (
            "memset" if e["cat"] == "gpu_memset" else str(e.get("name", "")))
        entry = ops.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += float(e["dur"]) / 1e6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), str(e["name"]))
                  for e in events if e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(HOST_PREFIX))
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    cursor = lo
    for a, b in busy + [(hi, hi)]:
        if a > cursor:
            mid = (cursor + a) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = host[i][2] if i >= 0 and host[i][1] > mid else BETWEEN
            idle[label] = idle.get(label, 0.0) + (a - cursor) / 1e6
        cursor = max(cursor, b)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "ops": ops,
        "idle_by_host": idle,
    }


def breakdown(dig: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time, and the idle time by what the host was doing."""
    ops = sorted(dig["ops"].items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(dig["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name, v[1]] for name, v in ops],
            "idle_gaps": [[name, s] for name, s in idle]}


def kernel_mean_ms(dig: dict, match) -> Tuple[int, float]:
    """(launches, mean ms) of the device operations whose name ``match``
    accepts; (0, 0.0) when none ran."""
    count, total = 0, 0.0
    for name, (n, seconds) in dig["ops"].items():
        if match(name):
            count += n
            total += seconds
    return count, (total / count * 1e3 if count else 0.0)
