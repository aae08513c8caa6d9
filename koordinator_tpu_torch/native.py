"""ctypes bindings for the native runtime shims (native/koordnative.cpp).

The reference's native boundaries are cgo: libpfm4 perf groups
(reference ``pkg/koordlet/util/perf_group/perf_group_linux.go``) and NVML.
Here one C++ shared library carries the perf CPI group, a batched
small-file reader for the collectors, and the snapshot delta encoder.

This module compiles ``native/koordnative.cpp`` alone with ``g++`` at first
use (never at import) into ``koordinator_tpu_torch/_build/`` (listed in
``.gitignore``), as a library whose name carries a digest of the source and
the flags, so an edited source is rebuilt and a built one reused; it
writes nothing into ``native/``.  ``build_info()`` keeps the build's
seconds and compiler output.  Every caller treats ``available() == False``
as "feature off", the same way the reference gates perf collection behind
a feature gate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PACKAGE_DIR)
_SOURCE = os.path.join(_REPO_ROOT, "native", "koordnative.cpp")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_info: Dict[str, object] = {}


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libkoordnative-{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile the source into ``path`` (through a temporary name, so a
    concurrent loader never sees half a library); records the seconds and
    the compiler's output in ``_build_info``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, _SOURCE],
            capture_output=True,
            text=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        _build_info.update(built=False, seconds=time.perf_counter() - t0, log=str(exc))
        return False
    _build_info.update(
        built=proc.returncode == 0,
        seconds=time.perf_counter() - t0,
        log=proc.stdout + proc.stderr,
    )
    if proc.returncode != 0:
        return False
    os.replace(tmp, path)
    return True


def build_info() -> Dict[str, object]:
    """The library's path, whether this process compiled it, the compile's
    seconds (0.0 when a built library was reused) and the compiler's
    output; ``error`` when it could not be loaded."""
    _load()
    return dict(_build_info)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
        except OSError as exc:
            _build_info.update(built=False, seconds=0.0, log="", error=str(exc))
            return None
        _build_info.update(path=path, built=False, seconds=0.0, log="")
        if not os.path.exists(path) and not _build(path):
            _build_info["error"] = "g++ failed"
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            _build_info["error"] = str(exc)
            return None
        lib.koord_perf_open_cpi_group.restype = ctypes.c_int
        lib.koord_perf_open_cpi_group.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.koord_perf_read_cpi.restype = ctypes.c_int
        lib.koord_perf_read_cpi.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.koord_perf_close.argtypes = [ctypes.c_int]
        lib.koord_perf_open_single.restype = ctypes.c_int
        lib.koord_perf_open_single.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_uint,
            ctypes.c_ulonglong,
            ctypes.c_int,
        ]
        lib.koord_perf_read_single.restype = ctypes.c_int
        lib.koord_perf_read_single.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.koord_read_files.restype = ctypes.c_int
        lib.koord_read_files.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int,
        ]
        lib.koord_delta_encode_i64.restype = ctypes.c_longlong
        lib.koord_delta_encode_i64.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_longlong,
        ]
        lib.koord_delta_apply_i64.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_longlong,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# perf CPI group
# ---------------------------------------------------------------------------


class PerfCPIGroup:
    """Grouped cycles+instructions counters (perf_group_linux.go analog).

    ``target`` is a pid, or a cgroup-dir fd when ``is_cgroup=True`` (the
    perf cgroup mode the reference uses per container).
    """

    def __init__(self, target: int, *, cpu: int = -1, is_cgroup: bool = False):
        lib = _load()
        if lib is None:
            raise OSError("native library unavailable")
        fd = lib.koord_perf_open_cpi_group(target, cpu, 1 if is_cgroup else 0)
        if fd < 0:
            raise OSError(-fd, os.strerror(-fd))
        self._fd = fd
        self._lib = lib

    def read(self) -> Tuple[int, int]:
        out = (ctypes.c_uint64 * 2)()
        rc = self._lib.koord_perf_read_cpi(self._fd, out)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return int(out[0]), int(out[1])

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.koord_perf_close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# raw perf_event_attr constants for PerfSingleReader (linux/perf_event.h)
PERF_TYPE_HARDWARE = 0
PERF_TYPE_SOFTWARE = 1
PERF_COUNT_HW_CPU_CYCLES = 0
PERF_COUNT_HW_INSTRUCTIONS = 1
PERF_COUNT_HW_CACHE_MISSES = 3
PERF_COUNT_SW_CPU_CLOCK = 0
PERF_COUNT_SW_TASK_CLOCK = 1
PERF_COUNT_SW_PAGE_FAULTS = 2
PERF_COUNT_SW_CONTEXT_SWITCHES = 3


class PerfSingleReader:
    """Non-grouped single-event perf reader (the reference's
    ``pkg/koordlet/util/perf/`` hodgesds/perf-utils path; the grouped CPI
    reader above covers ``perf_group``).  ``target`` is a pid, or a cgroup
    dir fd with ``is_cgroup=True``."""

    def __init__(
        self,
        target: int,
        event_type: int = PERF_TYPE_SOFTWARE,
        config: int = PERF_COUNT_SW_TASK_CLOCK,
        cpu: int = -1,
        is_cgroup: bool = False,
    ):
        lib = _load()
        if lib is None:
            raise OSError("native library unavailable")
        fd = lib.koord_perf_open_single(
            target, cpu, event_type, config, 1 if is_cgroup else 0
        )
        if fd < 0:
            raise OSError(-fd, os.strerror(-fd))
        self._fd = fd
        self._lib = lib

    def read(self) -> int:
        out = ctypes.c_uint64()
        rc = self._lib.koord_perf_read_single(
            self._fd, ctypes.byref(out)
        )
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return int(out.value)

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.koord_perf_close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_self_cpi() -> Optional[Tuple[int, int]]:
    """(cycles, instructions) for the current process, or None when perf
    is unavailable (kernel.perf_event_paranoid, containers, non-Linux)."""
    try:
        with PerfCPIGroup(0) as g:
            return g.read()
    except OSError:
        return None


# ---------------------------------------------------------------------------
# batched file reader
# ---------------------------------------------------------------------------


def read_files(paths: Sequence[str], *, max_per_file: int = 4096) -> List[Optional[str]]:
    """Read many small files in one native call; None per failed file.
    Pure-Python fallback when the library is absent."""
    lib = _load()
    if lib is None:
        out: List[Optional[str]] = []
        for p in paths:
            try:
                with open(p) as f:
                    out.append(f.read(max_per_file - 1))
            except OSError:
                out.append(None)
        return out
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    n = len(paths)
    buf = ctypes.create_string_buffer(n * max_per_file)
    sizes = (ctypes.c_longlong * n)()
    lib.koord_read_files(blob, len(blob), n, buf, sizes, max_per_file)
    out = []
    for i in range(n):
        if sizes[i] < 0:
            out.append(None)
        else:
            start = i * max_per_file
            out.append(buf.raw[start : start + sizes[i]].decode(errors="replace"))
    return out


# ---------------------------------------------------------------------------
# snapshot delta codec
# ---------------------------------------------------------------------------


def delta_encode(prev: np.ndarray, next_: np.ndarray, *, max_changes: Optional[int] = None):
    """(indices i64[m], values i64[m]) of changed elements, or None when the
    delta exceeds ``max_changes`` (fall back to full transfer).  Numpy
    fallback without the library."""
    prev = np.ascontiguousarray(prev.reshape(-1), dtype=np.int64)
    next_ = np.ascontiguousarray(next_.reshape(-1), dtype=np.int64)
    assert prev.shape == next_.shape
    cap = max_changes if max_changes is not None else prev.size
    lib = _load()
    if lib is None:
        idx = np.flatnonzero(prev != next_)
        if len(idx) > cap:
            return None
        return idx.astype(np.int64), next_[idx]
    idx = np.empty(cap, dtype=np.int64)
    val = np.empty(cap, dtype=np.int64)
    m = lib.koord_delta_encode_i64(
        prev.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        next_.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        prev.size,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        val.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
    )
    if m < 0:
        return None
    return idx[:m].copy(), val[:m].copy()


def delta_apply(base: np.ndarray, idx: np.ndarray, val: np.ndarray) -> None:
    """In-place base[idx] = val (flat indexing)."""
    flat = base.reshape(-1)
    lib = _load()
    if lib is None:
        flat[idx] = val
        return
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=np.int64)
    lib.koord_delta_apply_i64(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        val.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx),
    )
