"""Build the port's CUDA kernels from the sources in the package, at first use.

Each ``.cu`` source has a plain C entry point; it is compiled by ``nvcc``
into a shared library under ``koordinator_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``.  The library's name carries a
hash of the source, so an edited source is rebuilt and a built one is
reused.  Sources include no PyTorch headers, which keeps a build to
seconds.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def build(source: str) -> _Built:
    """Compile (if needed) and load ``source``, a path relative to the
    package.  Thread-safe, and two sources build in parallel from two
    threads; each source is loaded once per process."""
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source in _LOADED:
            return _LOADED[source]
        src = PACKAGE_DIR / source
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(exist_ok=True)
        out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
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
        _LOADED[source] = built
        return built
