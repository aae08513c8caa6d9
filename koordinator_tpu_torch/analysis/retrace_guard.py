"""Runtime guard: assert a warm stream stays inside a rebuild budget.

Counterpart of ``koordinator_tpu/analysis/retrace_guard.py``, with the
same names and contract: wrap a warm Sync/Score/Assign stream in
``retrace_guard(budget=0)`` and :class:`RetraceBudgetExceeded` fails it
with the observed counts.  The port never traces or compiles a program
on its warm path, so what it counts is its own two cold-path events.
Its counterpart of a "compile" is a hand-kernel build or load by
``_build.py build`` that misses the in-process cache (reported through
``_build.add_build_listener``); its counterpart of a "trace" is a kernel
demotion of ``run_cycle``'s ladder (``solver.register_demotion_listener``,
the events ``solver.kernel_demotions`` keeps), which sends a cycle down a
rung it did not take warm.  The budget covers both, so at 0 the measured
pass of a replay builds nothing and demotes nothing.  Builds and
demotions on any thread of the process count.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator


class RetraceBudgetExceeded(AssertionError):
    pass


class RetraceCounter:
    """Counts kernel demotions (``traces``) and kernel builds or loads
    (``compiles``) between ``start()`` and ``stop()``."""

    def __init__(self):
        self.traces = 0
        self.compiles = 0
        self._lock = threading.Lock()
        self._unhooks = []

    def _on_demotion(self, bucket, failures) -> None:
        with self._lock:
            self.traces += 1

    def _on_build(self, source, defines, seconds) -> None:
        with self._lock:
            self.compiles += 1

    def start(self) -> None:
        from koordinator_tpu_torch import _build, solver

        self._unhooks = [
            solver.register_demotion_listener(self._on_demotion),
            _build.add_build_listener(self._on_build),
        ]

    def stop(self) -> None:
        for unhook in self._unhooks:
            unhook()
        self._unhooks = []


@contextlib.contextmanager
def retrace_guard(budget: int = 0) -> Iterator[RetraceCounter]:
    """Fail with :class:`RetraceBudgetExceeded` when more than ``budget``
    kernel demotions and builds happen inside the block.  Warm up every
    route the block will take before entering: the guard asserts steady
    state, not first use."""
    counter = RetraceCounter()
    counter.start()
    try:
        yield counter
    finally:
        counter.stop()
    if counter.traces + counter.compiles > budget:
        raise RetraceBudgetExceeded(
            f"retrace budget exceeded: {counter.traces} kernel demotion(s) "
            f"and {counter.compiles} kernel build(s) inside a budget-"
            f"{budget} block — the warm stream left its warmed routes"
        )
