"""Device-time truth: the port's launch ledger.

Counterpart of ``koordinator_tpu/obs/devprof.py``, restated for torch.
Every launch site of the serving path registers here with
:func:`boundary`, and the ledger captures, per boundary:

* **build truth** — the port compiles no program at run time; its cold
  path is a hand kernel's build or load by ``_build.py build`` that
  misses the in-process cache.  A boundary launch that builds or loads a
  kernel records the build's seconds under (boundary, shape signature)
  with ``backend="cuda"``; a build by a boundary that already built once
  is an attributed retrace.  ``flops`` stays None: the port has no cost
  model, as the reference's exception path has none.
* **execution truth** — per-launch device time, sampled 1 launch in N
  (``configure(sample=N)``; 0 = off): on a CUDA launch, two CUDA events
  on the launch's stream around the call, and only that one launch waits
  on its end event (the span between the events, so it also holds any
  gap while the host enqueues the launch's work); on the CPU, the host
  wall around the call, labelled ``backend="cpu"``.

The ledger feeds the ``koord_scorer_devprof_*`` metric families, the
``device_us``/``compiled``/``build_ms`` attributes on the servicer's
launch and Assign spans (``obs/assemble.py`` renders the split), the
``health_block``, and the report CLI::

    python -m koordinator_tpu_torch.obs.devprof <state-dir>

Beside the launch boundaries the ledger keeps **stage rows**: the
serving path's stages of each RPC, ``server.<rpc>.<stage>``, from a
frame's bytes to its reply (``obs/spans.py`` says where each is taken).
While the ledger is on, every closed stage adds one occurrence to its
row: ``launches`` and ``sampled`` count the occurrences and
``device_us_total`` sums the stage's microseconds on its own clock, the
host's ``perf_counter_ns`` wall (``backend: "host"``) or, for the two
``device`` stages, the card's span between a CUDA event pair
(``backend: "cuda"``; on the CPU the host wall, ``backend: "cpu"``, as a
CPU launch is timed).  Each stage row carries ``kind: "stage"``.  They
appear in ``summary()["boundaries"]`` beside the launch rows, and under
their own heading in ``health_block`` and the report; ``boundaries()``,
the metric families and the notes stay the launch boundaries'.  A stage
holding a launch boundary (``rescore_dirty`` inside
``server.score.dispatch``, the cycle kernel inside
``server.assign.kernel``) holds that launch's measurement too, its
synchronise included.  With the ledger off a stage records nothing.

The contract, as in the reference:

* ``sample == 0`` (the default) is bit-inert: the wrapper's first
  statement after one comparison is the tail call ``fn(*args, **kwargs)``.
* Only the outermost boundary on a thread is measured: a thread-local
  depth counter (the counterpart of the reference's
  ``_trace_state_clean()``) steps aside for nested launches such as
  ``term_extras`` inside ``score_cycle``.
* Capture is exception-gated: a failure in the ledger never fails a
  launch.

Boundary names are ``solver.<module>.<function>`` of the port, which are
the reference's names where the port has the same function
(``solver.greedy.score_cycle``, ``solver.topk.masked_top_k``,
``solver.candidates._build``/``_count_blocks``/``_refresh``).  The
others stand where the reference's stand: ``solver.wide.cycle_wide_cuda``
(K2) and ``solver.wide.wave_cycle_cuda`` (K3) for
``solver.pallas_cycle._run_cycle``, ``solver.dense.cycle_dense_cuda``
(K1) for ``solver.pallas_dense._run_cycle_dense``,
``solver.resident.apply_flat_delta`` for ``_scatter_flat``,
``solver.incremental.rescore_dirty`` for ``_rescore``,
``solver.terms.term_extras`` for ``_term_extras_jit`` and
``solver.candidates.score_candidates`` for ``_score``.

:func:`capture_profile` is the admin plane's ``torch.profiler`` window.
Its ``trace.json`` also holds the host stage spans closed while the
window was open, as complete events on one track per handler thread,
placed on the trace's own timeline: each idle stretch of the card lies
under the stage the host was in.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
import logging
import os
import statistics
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from koordinator_tpu_torch import _build

__all__ = [
    "boundary",
    "boundaries",
    "configure",
    "reset",
    "enabled",
    "drain_notes",
    "summary",
    "health_block",
    "dump",
    "record_stage",
    "capture_profile",
    "format_report",
    "LEDGER_FILENAME",
    "PROFILE_TRACE",
]

logger = logging.getLogger(__name__)

LEDGER_FILENAME = "devprof.json"

# the chrome trace capture_profile writes into its capture directory
PROFILE_TRACE = "trace.json"

# flush the on-disk ledger every this many sampled launches (builds
# always flush at once — they are rare and load-bearing)
_FLUSH_EVERY = 32

# device-time samples kept per boundary for the summary's quantiles
_SAMPLES_KEPT = 4096

# signature strings are labels on ledger rows; a pathological repr must
# not bloat them
_SIG_MAX = 160


class _Entry:
    """One (boundary, signature) row of the build ledger, with the
    reference's keys.  The cost and memory keys (``flops``,
    ``bytes_accessed``, ``temp_bytes``, ``argument_bytes``,
    ``output_bytes``) stay None: the port has no cost model."""

    __slots__ = ("boundary", "sig", "backend", "source", "compile_ms",
                 "flops", "bytes_accessed", "temp_bytes", "argument_bytes",
                 "output_bytes", "first_seen_s")

    def __init__(self, boundary: str, sig: str):
        self.boundary = boundary
        self.sig = sig
        self.backend: Optional[str] = None
        self.source: Optional[str] = None
        self.compile_ms: Optional[float] = None
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.temp_bytes: Optional[int] = None
        self.argument_bytes: Optional[int] = None
        self.output_bytes: Optional[int] = None
        self.first_seen_s = time.time()

    def to_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


class _BoundaryStats:
    """Cumulative per-boundary launch/device-time accounting, with the
    last ``_SAMPLES_KEPT`` device-time samples for the quantiles."""

    __slots__ = ("launches", "sampled", "device_us_total", "compiles",
                 "samples")

    def __init__(self):
        self.launches = 0
        self.sampled = 0
        self.device_us_total = 0.0
        self.compiles = 0
        self.samples = collections.deque(maxlen=_SAMPLES_KEPT)

    def to_dict(self) -> dict:
        kept = sorted(self.samples)
        return {
            "launches": self.launches,
            "sampled": self.sampled,
            "device_us_total": self.device_us_total,
            "compiles": self.compiles,
            "device_us_p50": statistics.median(kept) if kept else None,
            "device_us_p99": _quantile(kept, 0.99),
        }


class _StageStats(_BoundaryStats):
    """A stage row: every occurrence is a launch and a sample, its
    microseconds on the stage's clock (``backend``); it builds nothing."""

    __slots__ = ("backend",)

    def __init__(self, backend: str):
        super().__init__()
        self.backend = backend

    def to_dict(self) -> dict:
        row = super().to_dict()
        del row["compiles"]
        return {"kind": "stage", "backend": self.backend, **row}


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    """The nearest-rank quantile of ``sorted_vals``, or None."""
    if not sorted_vals:
        return None
    rank = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals) + 0.5) - 1))
    return sorted_vals[rank]


class LaunchLedger:
    """Process-global registry of launch boundaries and their capture
    state.  One instance lives at module scope; tests get a fresh one via
    :func:`reset`.  All mutation happens under one lock: boundaries fire
    from the servicer's RPC threads concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._boundaries: Dict[str, _BoundaryStats] = {}
        self._stages: Dict[str, _StageStats] = {}
        self._entries: Dict[tuple, _Entry] = {}  # (boundary, sig) -> row
        self._retraces: List[dict] = []  # attributed rebuild events
        self.sample = 0
        self._metrics_ref: Optional[Callable[[], Any]] = None
        self.state_dir: Optional[str] = None
        self._counter = 0  # global launch counter driving 1-in-N
        self._unflushed = 0
        self._tls = threading.local()

    # -- registration --
    def register(self, name: str) -> None:
        with self._lock:
            self._boundaries.setdefault(name, _BoundaryStats())

    def boundaries(self) -> List[str]:
        with self._lock:
            return sorted(self._boundaries)

    # -- configuration --
    def configure(self, sample: Optional[int] = None, metrics=None,
                  state_dir: Optional[str] = None) -> None:
        import weakref

        with self._lock:
            if sample is not None:
                self.sample = max(0, int(sample))
            if metrics is not None:
                # a weakref: the ledger is process-global and must never
                # pin a servicer's metrics past its lifetime
                self._metrics_ref = weakref.ref(metrics)
            if state_dir is not None:
                self.state_dir = str(state_dir)

    def _metrics(self):
        ref = self._metrics_ref
        return None if ref is None else ref()

    # -- the wrapper's accounting primitives --
    def should_sample(self) -> bool:
        """1-in-N gate over the global launch counter (all boundaries
        share one counter so a quiet boundary still gets samples)."""
        with self._lock:
            self._counter += 1
            return self.sample > 0 and self._counter % self.sample == 0

    def note_launch(self, name: str) -> None:
        with self._lock:
            st = self._boundaries.setdefault(name, _BoundaryStats())
            st.launches += 1

    def record_compile(self, name: str, sig: str, backend: str,
                       compile_ms: float, source: Optional[str] = None) -> None:
        """One kernel build or load inside boundary ``name``."""
        with self._lock:
            st = self._boundaries.setdefault(name, _BoundaryStats())
            retrace = st.compiles > 0
            st.compiles += 1
            e = self._entries.setdefault((name, sig), _Entry(name, sig))
            e.backend = backend
            e.source = source
            e.compile_ms = compile_ms
            if retrace:
                # not "a build happened" but "THIS boundary built again,
                # for THIS shape"
                self._retraces.append({
                    "boundary": name,
                    "sig": sig,
                    "backend": backend,
                    "source": source,
                    "compile_ms": compile_ms,
                    "at_s": time.time(),
                })
        m = self._metrics()
        if m is not None:
            try:
                m.devprof_compile(name, backend, compile_ms)
                if retrace:
                    m.devprof_retrace(name)
            except Exception:  # a telemetry sink's drift must not break a launch; the ledger already recorded the build
                logger.debug("devprof metrics sink failed", exc_info=True)
        self._flush()

    def record_device_time(self, name: str, device_us: float) -> None:
        with self._lock:
            st = self._boundaries.setdefault(name, _BoundaryStats())
            st.sampled += 1
            st.device_us_total += device_us
            st.samples.append(device_us)
            self._unflushed += 1
            flush = self._unflushed >= _FLUSH_EVERY
        m = self._metrics()
        if m is not None:
            try:
                m.devprof_device_us(name, device_us)
            except Exception:  # a telemetry sink's drift must not break a launch; the ledger already recorded the sample
                logger.debug("devprof metrics sink failed", exc_info=True)
        if flush:
            self._flush()

    def record_stage(self, name: str, us: float, backend: str) -> None:
        """One closed stage ``name`` of ``us`` microseconds on its clock
        (``backend``); nothing while the ledger is off."""
        if self.sample <= 0:
            return
        with self._lock:
            st = self._stages.get(name)
            if st is None:
                st = self._stages[name] = _StageStats(backend)
            st.launches += 1
            st.sampled += 1
            st.device_us_total += us
            st.samples.append(us)

    # -- per-thread launch notes (span attribution seam) --
    def push_note(self, note: dict) -> None:
        notes = getattr(self._tls, "notes", None)
        if notes is None:
            notes = self._tls.notes = []
        notes.append(note)

    def drain_notes(self) -> List[dict]:
        notes = getattr(self._tls, "notes", None)
        if not notes:
            return []
        out = list(notes)
        notes.clear()
        return out

    # -- views --
    def summary(self) -> dict:
        """The report view: build ledger + per-boundary cumulative device
        time and quantiles + attributed retraces."""
        with self._lock:
            entries = [e.to_dict() for e in self._entries.values()]
            bounds = {
                n: st.to_dict() for n, st in self._boundaries.items()
            }
            bounds.update((n, st.to_dict()) for n, st in self._stages.items())
            retraces = list(self._retraces)
            sample = self.sample
        entries.sort(key=lambda d: (d["boundary"], d["sig"]))
        return {
            "sample": sample,
            "backend": _backend_platform(),
            "boundaries": bounds,
            "entries": entries,
            "retraces": retraces,
        }

    def health_block(self, top: int = 3) -> dict:
        """The /healthz ``device`` block: platform, device count, the
        build ledger summary, the top boundaries by cumulative device
        time, and the top stage rows by cumulative time."""
        with self._lock:
            compiles = sum(st.compiles for st in self._boundaries.values())
            compile_ms = sum(
                e.compile_ms or 0.0 for e in self._entries.values()
            )
            ranked = sorted(
                (
                    (n, st) for n, st in self._boundaries.items()
                    if st.device_us_total > 0
                ),
                key=lambda kv: kv[1].device_us_total,
                reverse=True,
            )[:top]
            stages = sorted(
                self._stages.items(), key=lambda kv: kv[1].device_us_total,
                reverse=True,
            )[:top]
            stages = [
                {
                    "stage": n,
                    "backend": st.backend,
                    "us_total": round(st.device_us_total, 1),
                    "count": st.launches,
                }
                for n, st in stages
            ]
            retraces = len(self._retraces)
            sample = self.sample
            registered = len(self._boundaries)
        return {
            "platform": _backend_platform(),
            "device_count": _device_count(),
            "sample": sample,
            "registered_boundaries": registered,
            "compiles": compiles,
            "compile_ms_total": round(compile_ms, 3),
            "retraces": retraces,
            "top": [
                {
                    "boundary": n,
                    "device_us_total": round(st.device_us_total, 1),
                    "sampled": st.sampled,
                    "launches": st.launches,
                }
                for n, st in ranked
            ],
            "stages": stages,
        }

    # -- persistence --
    def dump(self, state_dir: Optional[str] = None) -> Optional[str]:
        """Write the ledger as ``<state-dir>/devprof.json`` (the report
        CLI's input).  Returns the path, or None without a state dir."""
        target = state_dir or self.state_dir
        if not target:
            return None
        path = os.path.join(target, LEDGER_FILENAME)
        doc = self.summary()
        tmp = path + ".tmp"
        try:
            os.makedirs(target, exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            return None
        with self._lock:
            self._unflushed = 0
        return path

    def _flush(self) -> None:
        if self.state_dir:
            self.dump()


# -- module-level singleton --

_LEDGER = LaunchLedger()

# every decorated boundary's name: module scope, not ledger state —
# decoration happens once per import, and reset() re-registers from here
_BOUNDARY_NAMES: List[str] = []

# the boundary depth and the kernel builds seen inside the outermost
# boundary, per thread
_TLS = threading.local()


def _on_build(source: str, defines, seconds: float) -> None:
    """``_build.py``'s listener: a build on a thread inside a measured
    boundary is that launch's."""
    if getattr(_TLS, "depth", 0):
        _TLS.builds.append((source, tuple(defines), float(seconds)))


_build.add_build_listener(_on_build)


def reset() -> None:
    """Fresh ledger (tests), with every decorated boundary registered.
    Already-wrapped callables keep working: the wrapper resolves the
    singleton per call."""
    global _LEDGER
    _LEDGER = LaunchLedger()
    for name in _BOUNDARY_NAMES:
        _LEDGER.register(name)


def configure(sample: Optional[int] = None, metrics=None,
              state_dir: Optional[str] = None) -> None:
    _LEDGER.configure(sample=sample, metrics=metrics, state_dir=state_dir)


def enabled() -> bool:
    return _LEDGER.sample > 0


def boundaries() -> List[str]:
    return _LEDGER.boundaries()


def drain_notes() -> List[dict]:
    """Pop this thread's launch notes (span attribution).  Cheap when
    devprof is off — the wrapper never pushes then."""
    return _LEDGER.drain_notes()


def summary() -> dict:
    return _LEDGER.summary()


def health_block(top: int = 3) -> dict:
    return _LEDGER.health_block(top=top)


def dump(state_dir: Optional[str] = None) -> Optional[str]:
    return _LEDGER.dump(state_dir)


def record_stage(name: str, us: float, backend: str = "host") -> None:
    """One closed stage span's row in the ledger (``obs/spans.py`` calls
    this); nothing while the ledger is off."""
    _LEDGER.record_stage(name, us, backend)


# -- environment probes --

def _backend_platform() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def _device_count() -> int:
    """The devices of ``_backend_platform()``: the CUDA devices, else the
    one CPU device torch runs on."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1


# -- signatures --

def _leaves(obj, out: list, depth: int = 0) -> None:
    """Tensor and array leaves of ``obj`` (dataclasses, sequences and
    dicts walked to three levels); anything else a short repr."""
    import torch

    if isinstance(obj, torch.Tensor) or (
        hasattr(obj, "shape") and hasattr(obj, "dtype")
    ):
        out.append(f"{obj.dtype}[{','.join(str(d) for d in obj.shape)}]")
    elif depth < 3 and dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out, depth + 1)
    elif depth < 3 and isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out, depth + 1)
    elif depth < 3 and isinstance(obj, dict):
        for v in obj.values():
            _leaves(v, out, depth + 1)
    elif obj is not None:
        r = repr(obj)
        out.append(r if len(r) <= 40 else r[:37] + "...")


def shape_signature(args: tuple, kwargs: dict) -> str:
    """dtype[shape] per tensor leaf, short reprs for the rest, keying the
    build ledger; past ``_SIG_MAX`` characters cut and hashed."""
    parts: list = []
    _leaves((args, kwargs), parts)
    sig = ";".join(parts)
    if len(sig) > _SIG_MAX:
        digest = hashlib.sha1(sig.encode()).hexdigest()[:8]
        sig = sig[: _SIG_MAX - 12] + "...#" + digest
    return sig


def _launch_device(args: tuple, kwargs: dict):
    """The device of the first tensor found in the arguments (a tensor,
    or an object's ``device`` attribute, or a dataclass's tensor field),
    else the CPU."""
    import torch

    for obj in list(args) + list(kwargs.values()):
        if isinstance(obj, torch.Tensor):
            return obj.device
        dev = getattr(obj, "device", None)
        if isinstance(dev, torch.device):
            return dev
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if isinstance(v, torch.Tensor):
                    return v.device
    return torch.device("cpu")


class _Timer:
    """CUDA events on the launch's stream for a CUDA launch, the host
    wall otherwise."""

    def __init__(self, args: tuple, kwargs: dict):
        import torch

        device = _launch_device(args, kwargs)
        self.backend = device.type if device.type == "cuda" else "cpu"
        if self.backend == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        else:
            self._t0 = time.perf_counter()

    def stop_us(self) -> float:
        import torch

        if self.backend == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            end.synchronize()  # only this sampled launch waits
            return self._start.elapsed_time(end) * 1e3
        return (time.perf_counter() - self._t0) * 1e6


# -- the decorator --

def boundary(name: str):
    """Register a launch boundary with the ledger::

        @devprof.boundary("solver.greedy.score_cycle")
        def score_cycle(snapshot, cfg=DEFAULT_CYCLE_CONFIG): ...

    Off (``sample == 0``): one comparison, then the tail call.  Nested
    under another boundary on the same thread: the tail call too; only
    the outermost launch is measured."""

    def deco(fn):
        _LEDGER.register(name)
        _BOUNDARY_NAMES.append(name)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            led = _LEDGER
            if led.sample <= 0:
                return fn(*args, **kwargs)  # bit-inert fast path
            if getattr(_TLS, "depth", 0):
                return fn(*args, **kwargs)  # nested under an outer boundary
            return _measured(led, name, fn, args, kwargs)

        wrapper.__wrapped__ = fn
        wrapper.devprof_boundary = name
        return wrapper

    return deco


def _measured(led: LaunchLedger, name: str, fn, args: tuple, kwargs: dict):
    """One outermost launch with the ledger on."""
    timer = None
    try:
        led.note_launch(name)
        if led.should_sample():
            timer = _Timer(args, kwargs)
    except Exception:  # the ledger degrades to an unmeasured launch, never a failed one
        logger.debug("devprof capture failed before %s", name, exc_info=True)
        timer = None
    _TLS.depth = 1
    _TLS.builds = []
    try:
        out = fn(*args, **kwargs)
    finally:
        _TLS.depth = 0
        builds, _TLS.builds = _TLS.builds, []
    try:
        _capture(led, name, args, kwargs, timer, builds)
    except Exception:  # a failure in the ledger never fails the launch it measured
        logger.debug("devprof capture failed after %s", name, exc_info=True)
    return out


def _capture(led: LaunchLedger, name: str, args: tuple, kwargs: dict,
             timer: Optional[_Timer], builds: list) -> None:
    if builds:
        # this launch built or loaded a kernel: its time holds the build,
        # so it records build truth and no device sample
        sig = shape_signature(args, kwargs)
        build_ms = 0.0
        for source, defines, seconds in builds:
            ms = seconds * 1e3
            build_ms += ms
            led.record_compile(
                name, sig, "cuda", ms,
                source=" ".join((source,) + tuple(f"-D{d}" for d in defines)),
            )
        led.push_note({
            "boundary": name, "sig": sig, "compiled": True,
            "build_ms": build_ms, "device_us": None, "backend": "cuda",
            "flops": None,
        })
        return
    if timer is not None:
        device_us = timer.stop_us()
        led.record_device_time(name, device_us)
        led.push_note({
            "boundary": name, "compiled": False, "build_ms": None,
            "device_us": device_us, "backend": timer.backend,
            "flops": None,
        })


# -- on-demand profiler capture (admin plane) --

def capture_profile(state_dir: str, window_ms: int = 1000) -> str:
    """Open a ``torch.profiler`` window (CPU and, where there is a card,
    CUDA activities) for ``window_ms`` and return its capture directory
    under ``state_dir`` at once — the admin method 5 (Profile) seam.  The
    window runs on a background thread, which starts the profiler, sleeps
    the window, stops it and writes the chrome trace as
    ``<dir>/trace.json`` (renamed into place when complete).  CUDA
    activity is traced process-wide, whichever thread launches.  The
    host stage spans closed from this call until the window stops
    (``obs/spans.py``) join the trace as complete events, one track per
    handler thread, on the trace's timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from koordinator_tpu_torch.obs import spans

    out_dir = os.path.join(
        state_dir, "devprof_trace", f"capture-{os.getpid()}-{time.time_ns()}"
    )
    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    # opened before the window's thread starts, so an RPC that follows
    # this call at once is kept
    cap = spans.open_capture()

    def _window():
        try:
            try:
                with profile(activities=activities) as prof:
                    time.sleep(max(0, int(window_ms)) / 1e3)
            finally:
                spans.close_capture(cap)
            tmp = os.path.join(out_dir, PROFILE_TRACE + ".tmp")
            prof.export_chrome_trace(tmp)
            _add_stage_tracks(tmp, cap)
            os.replace(tmp, os.path.join(out_dir, PROFILE_TRACE))
        except Exception:  # an admin-plane capture failure is logged; the daemon serves on
            logger.exception("devprof profile capture into %s failed", out_dir)

    threading.Thread(target=_window, daemon=True, name="devprof-capture").start()
    return out_dir


def _add_stage_tracks(path: str, cap) -> None:
    """Add the captured stage spans to the chrome trace at ``path`` as
    complete events (``cat: "server_stage"``) of this process, one track
    per handler thread (its native id, named ``server stages: <thread>``),
    at ``ts`` microseconds from the trace's ``baseTimeNanoseconds``."""
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    tracks = {}
    for name, start_ns, end_ns, tid, thread in cap.spans:
        tracks[tid] = thread
        events.append({
            "ph": "X", "cat": "server_stage", "name": name, "pid": pid,
            "tid": tid, "ts": (start_ns - base) / 1e3,
            "dur": (end_ns - start_ns) / 1e3,
        })
    for tid, thread in tracks.items():
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"server stages: {thread}"},
        })
    if cap.overflow:
        doc["serverStagesDropped"] = cap.overflow
    with open(path, "w") as fh:
        json.dump(doc, fh)


# -- report CLI --

def _fmt_num(v, scale=1.0, suffix="") -> str:
    if v is None:
        return "-"
    return f"{v / scale:,.1f}{suffix}"


def format_report(doc: dict, top: int = 10) -> str:
    """Render a dumped ledger: the build ledger (one row per
    boundary+signature with its build ms and source), the
    top-N-by-cumulative-device-time table with each boundary's p50 and
    p99 device µs, and the stage rows by cumulative time."""
    lines = []
    backend = doc.get("backend") or "unknown"
    lines.append(
        f"devprof ledger — backend={backend} sample={doc.get('sample')}"
    )
    lines.append("")
    lines.append("build ledger:")
    lines.append(
        f"  {'boundary':<36} {'build_ms':>10}  {'source':<40}  sig"
    )
    for e in doc.get("entries", []):
        lines.append(
            f"  {e['boundary']:<36} "
            f"{_fmt_num(e.get('compile_ms')):>10}  "
            f"{e.get('source') or '-':<40}  {e.get('sig', '')}"
        )
    if not doc.get("entries"):
        lines.append("  (no builds captured)")
    lines.append("")
    lines.append(f"top boundaries by cumulative device time (top {top}):")
    lines.append(
        f"  {'boundary':<36} {'device_ms':>10} {'p50_us':>10} "
        f"{'p99_us':>10} {'sampled':>8} {'launches':>9} {'builds':>7}"
    )
    rows = doc.get("boundaries", {})
    ranked = sorted(
        ((n, st) for n, st in rows.items() if st.get("kind") != "stage"),
        key=lambda kv: kv[1].get("device_us_total", 0.0),
        reverse=True,
    )
    for name, st in ranked[:top]:
        lines.append(
            f"  {name:<36} "
            f"{st.get('device_us_total', 0.0) / 1e3:>10,.2f} "
            f"{_fmt_num(st.get('device_us_p50')):>10} "
            f"{_fmt_num(st.get('device_us_p99')):>10} "
            f"{st.get('sampled', 0):>8} {st.get('launches', 0):>9} "
            f"{st.get('compiles', 0):>7}"
        )
    if not ranked:
        lines.append("  (no launches recorded)")
    stages = sorted(
        ((n, st) for n, st in rows.items() if st.get("kind") == "stage"),
        key=lambda kv: kv[0],
    )
    if stages:
        lines.append("")
        lines.append("stage spans by RPC (ms on each stage's clock):")
        lines.append(
            f"  {'stage':<36} {'total_ms':>10} {'p50_us':>10} "
            f"{'p99_us':>10} {'count':>8}  clock"
        )
        for name, st in stages:
            lines.append(
                f"  {name:<36} "
                f"{st.get('device_us_total', 0.0) / 1e3:>10,.2f} "
                f"{_fmt_num(st.get('device_us_p50')):>10} "
                f"{_fmt_num(st.get('device_us_p99')):>10} "
                f"{st.get('launches', 0):>8}  {st.get('backend', '-')}"
            )
    retraces = doc.get("retraces", [])
    if retraces:
        lines.append("")
        lines.append(f"attributed rebuilds ({len(retraces)}):")
        for r in retraces:
            lines.append(
                f"  {r['boundary']}  +{_fmt_num(r.get('compile_ms'))} ms"
                f"  {r.get('source') or ''}  sig={r.get('sig', '')}"
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.obs.devprof",
        description="Print the launch ledger dumped under a state "
        "directory (kernel builds, top boundaries by cumulative device "
        "time, stage spans by RPC).",
    )
    ap.add_argument("state_dir", help="a state directory (or any "
                    f"directory holding {LEDGER_FILENAME}, or the file)")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the device-time table (default 10)")
    args = ap.parse_args(argv)
    path = args.state_dir
    if os.path.isdir(path):
        path = os.path.join(path, LEDGER_FILENAME)
    if not os.path.exists(path):
        print(f"devprof: no ledger at {path} (configure a sample > 0 with "
              "a state_dir, or call devprof.dump())", file=sys.stderr)
        return 2
    with open(path) as fh:
        doc = json.load(fh)
    print(format_report(doc, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
