"""Build the port's CUDA kernels from the sources in the package, at first use.

Each ``.cu`` source has a plain C entry point; it is compiled by ``nvcc``
into a shared library under ``koordinator_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``.  The library's name carries a
hash of the source, of the package headers it includes (``#include
"..."``, followed recursively) and of the flags, ``-D`` defines included,
so an edited source or header is rebuilt and a built one is reused.
Sources include no PyTorch headers, which keeps a build to seconds.  A
failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


# the define of a source's instrumented build (its phase clocks)
PHASE_CLOCK = ("KOORD_PHASE_CLOCK",)


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class _Built:
    """One loaded library with its build record."""

    def __init__(self, lib, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds  # 0.0 when a built library was reused
        self.log = log  # nvcc's output (ptxas register/spill report)


_LOCK = threading.Lock()
_SOURCE_LOCKS = {}
_LOADED = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(src: Path) -> list:
    """The files ``src`` includes with ``#include "..."`` that exist beside
    it, and theirs in turn, each once, in order of first inclusion."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        for name in _INCLUDE.findall(path.read_text()):
            inc = (path.parent / name).resolve()
            if inc.exists() and inc not in seen:
                seen.append(inc)
                todo.append(inc)
    return seen


def source_digest(src: Path, flags) -> str:
    """Hash of the source, its local includes and the compiler flags."""
    h = hashlib.sha256(src.read_bytes())
    for inc in local_includes(src):
        h.update(inc.name.encode() + b"\0" + inc.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(source: str, defines=()) -> _Built:
    """Compile (if needed) and load ``source``, a path relative to the
    package, with ``-D`` for each of ``defines`` (a variant such as an
    instrumented build; each variant is its own library).  Thread-safe,
    and two sources build in parallel from two threads; each variant is
    loaded once per process."""
    defines = tuple(defines)
    key = (source, defines)
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(key, threading.Lock())
    with lock:
        if key in _LOADED:
            return _LOADED[key]
        src = PACKAGE_DIR / source
        flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        digest = source_digest(src, flags)
        BUILD_DIR.mkdir(exist_ok=True)
        out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}) for {src}:\n"
                    f"{' '.join(cmd)}\n{log}"
                )
            log_path.write_text(log)
            os.replace(tmp, out)
        log = log_path.read_text() if log_path.exists() else ""
        built = _Built(ctypes.CDLL(str(out)), out, seconds, log)
        _LOADED[key] = built
        return built


def entry(source: str, name: str, argtypes, defines=()):
    """The C entry point ``name`` of ``source``'s build with ``defines``,
    its ``argtypes`` set and returning the cudaError_t as an int."""
    fn = getattr(build(source, defines).lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def read_counters(source: str, name: str, count: int) -> tuple:
    """Call the instrumented build's counter entry ``name(unsigned long
    long* out)``, which copies ``count`` device counters (its phase clocks)
    to ``out`` and resets them; raise on a CUDA error."""
    fn = entry(source, name, [ctypes.c_void_p], PHASE_CLOCK)
    out = (ctypes.c_ulonglong * count)()
    err = fn(out)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return tuple(int(v) for v in out)
