"""Kernel prewarm: take the cold path's builds off the first launches.

Counterpart of ``koordinator_tpu/obs/prewarm.py``.  The reference replays
pickled abstract signatures through ``fn.lower().compile()``; the port
compiles no program at run time, and its cold path is the ``nvcc`` build
and load of each ``(source, defines)`` kernel variant by ``_build.py
build`` (seconds each on the card).  So the port's prewarm:

* records, as JSON under ``<state-dir>/prewarm.json`` (no pickle), every
  kernel variant this process built or loaded — :func:`record_build` is
  the daemon's ``_build`` build listener, :func:`dump` adds every variant
  loaded at a stop;
* at the next boot, and again on a follower's promotion, a
  :class:`PrewarmRunner` thread rebuilds and loads that set with
  ``_build.build`` while the daemon already serves.  A launch needing a
  variant the runner has not reached builds it inline, as an unprewarmed
  boot does: prewarm is an accelerant, never a gate;
* a first boot on the card, with no record yet, starts the builds of
  ``BOOT_DEFAULT`` (:func:`build_boot_default`), the sources every Score
  and every default Assign launch, each on a thread of its own: side by
  side, the Score's two ``nvcc`` runs hide under the cycle kernel's, where
  inline the first Score and the first Assign would pay them one after
  the other.  A launch that needs one waits on its build under way.

Progress shows in the ``koord_scorer_prewarm_*`` metric families and the
/healthz ``prewarm`` block (:meth:`PrewarmRunner.stats`, the reference's
keys; its "compiled" counts variants built or loaded).

The two tables below map the reference's onto the port's launch ledger
boundaries (``obs/devprof.py``): every registered boundary is in exactly
one of them.  ``PREWARM_BOUNDARIES`` launch a hand kernel, whose build is
what the runner replays; ``PREWARM_EXCLUDED`` run plain PyTorch on the
device and build nothing, or launch a kernel only through a nested
boundary that ``PREWARM_BOUNDARIES`` lists.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from koordinator_tpu_torch import _build

__all__ = [
    "PREWARM_BOUNDARIES",
    "PREWARM_EXCLUDED",
    "PREWARM_FILENAME",
    "BOOT_DEFAULT",
    "PrewarmRunner",
    "build_boot_default",
    "dump",
    "load",
    "record_build",
]

logger = logging.getLogger(__name__)

PREWARM_FILENAME = "prewarm.json"

# the sources a record-less boot builds: the Score's top-k
# (``solver/topk.py``), its Filter+Score (``solver/score_kernel.py``) and
# K1/K2 (``solver/dense.py``, ``solver/wide.py``), each ``KERNEL_SOURCE``
# with no defines
BOOT_DEFAULT = ("solver/topk_cuda.cu", "solver/score_cuda.cu", "solver/cycle_cuda.cu")

# boundaries whose launch builds a kernel variant (K1, K2, K3, the top-k,
# the Score's Filter+Score), on the card
PREWARM_BOUNDARIES = (
    "solver.dense.cycle_dense_cuda",
    "solver.wide.cycle_wide_cuda",
    "solver.wide.wave_cycle_cuda",
    "solver.topk.masked_top_k",
    "solver.score_kernel.score_cells",
)

_PLAIN = "plain PyTorch on the device: nothing to build"
_NESTED = ("launches the Score's Filter+Score through the nested boundary "
           "solver.score_kernel.score_cells, whose row replays the build")
PREWARM_EXCLUDED: Dict[str, str] = {
    "parallel.shard_assign._assign_sharded": _PLAIN,
    "parallel.shard_assign._cycle_operands": _PLAIN,
    "parallel.shard_assign._assign_waves": _PLAIN,
    "solver.candidates._build": _NESTED,
    "solver.candidates._build_sharded": _NESTED,
    "solver.candidates._count_blocks": _NESTED,
    "solver.candidates._count_blocks_sharded": _NESTED,
    "solver.candidates._refresh": _NESTED,
    "solver.candidates._refresh_sharded": _NESTED,
    "solver.candidates._score_sharded": _PLAIN,
    "solver.candidates.score_candidates": _PLAIN,
    "solver.greedy.score_cycle": _NESTED,
    "solver.greedy.score_cycle_sharded": _NESTED,
    "solver.incremental._rescore_sharded": _NESTED,
    "solver.incremental.rescore_dirty": _NESTED,
    "solver.resident._scatter_flat_sharded": _PLAIN,
    "solver.resident.apply_flat_delta": _PLAIN,
    "solver.terms.term_extras": _PLAIN,
}

_FILE_LOCK = threading.Lock()


def _path(state_dir: str) -> str:
    return os.path.join(state_dir, PREWARM_FILENAME)


def load(state_dir: str) -> List[dict]:
    """The recorded variants, ``[{"source", "defines"}]`` in record order;
    an absent or unreadable file is an empty set."""
    try:
        with open(_path(state_dir)) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return []
    out = []
    for rec in doc.get("variants", []):
        if isinstance(rec, dict) and isinstance(rec.get("source"), str):
            out.append({"source": rec["source"],
                        "defines": [str(d) for d in rec.get("defines", [])]})
    return out


def _write(state_dir: str, records: List[dict]) -> str:
    """Atomically replace the record file (tempfile + rename)."""
    os.makedirs(state_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=state_dir, prefix=".prewarm.")
    with os.fdopen(fd, "w") as fh:
        json.dump({"variants": records}, fh, indent=1)
    os.replace(tmp, _path(state_dir))
    return _path(state_dir)


def _merge(state_dir: str, variants) -> str:
    with _FILE_LOCK:
        records = load(state_dir)
        seen = {(r["source"], tuple(r["defines"])) for r in records}
        for source, defines in variants:
            key = (source, tuple(defines))
            if key not in seen:
                seen.add(key)
                records.append({"source": source, "defines": list(defines)})
        return _write(state_dir, records)


def record_build(state_dir: str, source: str, defines) -> None:
    """Add one variant to the record: the daemon's ``_build`` build
    listener, so a variant is on record from its first build, crash or
    not."""
    _merge(state_dir, [(source, tuple(defines))])


def dump(state_dir: str) -> str:
    """Add every variant loaded in this process to the record; returns
    the file's path."""
    return _merge(state_dir, _build.loaded_variants())


def build_boot_default(state_dir: str, device=None) -> List[threading.Thread]:
    """On a card daemon whose ``state_dir`` holds no record yet, start the
    build of each ``BOOT_DEFAULT`` source on a thread of its own; returns
    the started threads (none on the CPU or where a record exists, which
    the :class:`PrewarmRunner` replays instead)."""
    if load(state_dir) or not (device is None or str(device).startswith("cuda")):
        return []
    threads = [threading.Thread(target=_boot_build, args=(source,), daemon=True,
                                name="koord-boot-build") for source in BOOT_DEFAULT]
    for t in threads:
        t.start()
    return threads


def _boot_build(source: str) -> None:
    try:
        _build.build(source)
    except Exception:  # an accelerant: the launch that needs the source builds it inline and fails there visibly
        logger.exception("boot build of %s failed", source)


class PrewarmRunner:
    """Rebuild a recorded variant set on a background thread.

    One-shot: :meth:`start` spawns the thread, :meth:`stats` is the
    /healthz ``prewarm`` block, :meth:`wait` the barrier.  ``device``: on
    a CPU daemon no kernel ever launches, so every record is skipped."""

    def __init__(self, state_dir: str, metrics=None, device=None):
        self.state_dir = str(state_dir)
        self._metrics = metrics
        self._cuda = device is None or str(device).startswith("cuda")
        self._lock = threading.Lock()
        self._state = "idle"  # idle -> running -> done
        self._total = 0
        self._replayable = 0
        self._compiled = 0
        self._skipped = 0
        self._failed = 0
        self._compile_ms_total = 0.0
        self._elapsed_ms: Optional[float] = None
        self.failures: List[str] = []
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PrewarmRunner":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="koord-prewarm"
        )
        with self._lock:
            self._state = "running"
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout=timeout if timeout is not None else 1.0)

    def _replayable_record(self, rec: dict) -> bool:
        return self._cuda and (_build.PACKAGE_DIR / rec["source"]).is_file()

    def _run(self) -> None:
        t0 = time.perf_counter()
        try:
            records = load(self.state_dir)
            replayable = [r for r in records if self._replayable_record(r)]
            with self._lock:
                self._total = len(records)
                self._replayable = len(replayable)
            for _ in range(len(records) - len(replayable)):
                self._count("skipped")
            pending = len(replayable)
            self._gauge(pending)
            for rec in replayable:
                if self._stop.is_set():
                    break
                c0 = time.perf_counter()
                try:
                    # koordlint: disable=retrace-hazard(replays the keys this daemon's own launches built and recorded, ROADMAP Queue C "The prewarm replays recorded build keys")
                    _build.build(rec["source"], tuple(rec["defines"]))
                except Exception as exc:  # a variant that no longer builds costs its slot; the live path builds inline and fails there visibly
                    logger.exception("prewarm of %s %s failed",
                                     rec["source"], rec["defines"])
                    with self._lock:
                        self.failures.append(f"{rec['source']} {rec['defines']}: {exc}")
                    self._count("failed")
                else:
                    ms = (time.perf_counter() - c0) * 1e3
                    with self._lock:
                        self._compiled += 1
                        self._compile_ms_total += ms
                    m = self._metrics
                    if m is not None:
                        m.count_prewarm("compiled")
                        m.add_prewarm_compile_ms(ms)
                pending -= 1
                self._gauge(pending)
        finally:
            with self._lock:
                self._state = "done"
                self._elapsed_ms = (time.perf_counter() - t0) * 1e3
            self._gauge(0)
            self._done.set()

    def _count(self, result: str) -> None:
        with self._lock:
            if result == "skipped":
                self._skipped += 1
            elif result == "failed":
                self._failed += 1
        if self._metrics is not None:
            self._metrics.count_prewarm(result)

    def _gauge(self, pending: int) -> None:
        if self._metrics is not None:
            self._metrics.set_prewarm_pending(max(0, int(pending)))

    def stats(self) -> dict:
        """The /healthz ``prewarm`` block."""
        with self._lock:
            return {
                "state": self._state,
                "total": self._total,
                "replayable": self._replayable,
                "compiled": self._compiled,
                "skipped": self._skipped,
                "failed": self._failed,
                "compile_ms_total": round(self._compile_ms_total, 3),
                "elapsed_ms": (
                    round(self._elapsed_ms, 3)
                    if self._elapsed_ms is not None else None
                ),
            }
