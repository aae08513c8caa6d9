"""Runtime lock witness: FreeBSD WITNESS / Go lockrank for
the serving tier.

Copy of ``koordinator_tpu/obs/lockwitness.py``.  The static half
(``analysis/lockgraph.py``) derives the port's lock partial order from
the AST (``analysis/LOCKORDER.md``); this module validates it against
REAL interleavings.  Under ``KOORD_LOCK_WITNESS=1`` (or an explicit
:func:`install`), the ``witness_lock``/``witness_rlock``/
``witness_condition`` factories — which every threaded-tier creation
site routes through — return instrumented wrappers instead of plain
``threading`` primitives.  Each wrapper

* tracks the per-thread HELD-SET (a ``threading.local`` stack, so the
  bookkeeping itself takes no lock on the hot path);
* records every first-seen acquisition edge ``held -> acquired``;
* raises :class:`LockOrderInversion` the moment a new edge closes a
  cycle against the statically derived order *or* against the edges
  already observed this run — the two-sided check: a static A->B plus
  an observed B->A is a deadlock two threads can schedule, whether or
  not lint saw the B->A path.

``Condition.wait`` is modelled faithfully: the identity leaves the
held-set for the duration of the wait (other threads acquire freely)
and the re-acquire re-records edges against whatever the thread still
holds — exactly the release/re-acquire semantics the static pass
models.

Same-identity nesting (two ``_Subscriber._cond`` instances, an RLock
re-entry) is "dup ok", matching the static pass: identities collapse
instances, so a self-edge carries no order information.

With the env var unset and no install, the factories return plain
``threading`` objects — zero overhead, byte-identical behavior.  The
factory NAME STRINGS are drift-checked by ``lockorder-doc-drift``
against the derived identities, so the witness and the graph can never
disagree about what a lock is called.

Distinct observed edges feed the
``koord_scorer_lock_witness_edges_total`` counter (label ``result``:
``observed`` | ``inversion``) once a registry is attached — the
servicer attaches its own when witness mode is on.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

ENV = "KOORD_LOCK_WITNESS"

_TRUTHY = ("1", "true", "yes", "on")

_INSTALL_LOCK = threading.Lock()
_STATE: Optional["_WitnessState"] = None


class LockOrderInversion(RuntimeError):
    """A thread acquired locks in an order that closes a cycle against
    the derived partial order — a schedulable deadlock."""


class _Held:
    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 1


class _WitnessState:
    def __init__(self, order_edges: Iterable[Tuple[str, str]]):
        self.static_order: Dict[str, Set[str]] = {}
        for a, b in order_edges:
            self.static_order.setdefault(a, set()).add(b)
        # guards observed/inversions/metrics (NOT the held-set, which is
        # thread-local); deliberately a plain lock outside its own
        # bookkeeping — the witness must not witness itself
        self._lock = threading.Lock()
        self.observed: Dict[Tuple[str, str], int] = {}
        self.inversions: List[dict] = []
        # edges flagged as inversions: reported (once) but EXCLUDED
        # from the order _reaches_locked walks — admitting them would
        # poison the legal direction into "inverting" right back
        self._inverted: Set[Tuple[str, str]] = set()
        self.metrics = None
        self._tls = threading.local()

    # -- held-set -----------------------------------------------------
    def held(self) -> List[_Held]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    # -- order check --------------------------------------------------
    def _reaches_locked(self, src: str, dst: str) -> bool:
        """Path src => dst over static order + observed edges; caller
        holds ``self._lock`` (the ``observed`` iteration needs it)."""
        seen: Set[str] = set()
        frontier = [src]
        while frontier:
            node = frontier.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            frontier.extend(self.static_order.get(node, ()))
            frontier.extend(
                b for (a, b) in self.observed
                if a == node and (a, b) not in self._inverted
            )
        return False

    def note_acquire(self, name: str) -> None:
        stack = self.held()
        for entry in stack:
            if entry.name == name:
                entry.count += 1  # reentrant / same-identity: dup ok
                return
        stack.append(_Held(name))
        if len(stack) > 1:
            try:
                self._record_edges([e.name for e in stack[:-1]], name)
            except LockOrderInversion:
                stack.pop()  # wrapper releases the inner lock and re-raises
                raise

    def note_release(self, name: str) -> None:
        stack = self.held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == name:
                stack[i].count -= 1
                if stack[i].count == 0:
                    del stack[i]
                return

    def note_wait_release(self, name: str) -> int:
        """Condition.wait: the identity fully leaves the held-set (the
        stdlib releases every recursion level); returns the saved
        depth for the re-acquire."""
        stack = self.held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == name:
                count = stack[i].count
                del stack[i]
                return count
        return 0

    def note_wait_reacquire(self, name: str, count: int) -> None:
        stack = self.held()
        entry = _Held(name)
        entry.count = max(1, count)
        stack.append(entry)
        if len(stack) > 1:
            try:
                self._record_edges([e.name for e in stack[:-1]], name)
            except LockOrderInversion:
                stack.pop()
                raise

    def _record_edges(self, held_names: List[str], dst: str) -> None:
        fresh_inversion = None
        with self._lock:
            for src in held_names:
                key = (src, dst)
                if key in self.observed:
                    self.observed[key] += 1
                    continue
                # first sighting: the two-sided check BEFORE admitting
                # the edge — a path dst => src makes (src, dst) close a
                # cycle
                inverted = self._reaches_locked(dst, src)
                self.observed[key] = 1
                if inverted:
                    self._inverted.add(key)
                    detail = {
                        "edge": key,
                        "held": list(held_names),
                        "thread": threading.current_thread().name,
                    }
                    self.inversions.append(detail)
                    if self.metrics is not None:
                        self.metrics.count_lock_witness_edge("inversion")
                    fresh_inversion = detail
                elif self.metrics is not None:
                    self.metrics.count_lock_witness_edge("observed")
        if fresh_inversion is not None:
            raise LockOrderInversion(
                f"lock-order inversion: thread "
                f"{fresh_inversion['thread']!r} acquired {dst!r} while "
                f"holding {fresh_inversion['held']} but the derived "
                f"order (static graph + observed edges) already orders "
                f"{dst!r} before {fresh_inversion['edge'][0]!r} — two "
                "threads can deadlock on this; see "
                "koordinator_tpu_torch/analysis/LOCKORDER.md"
            )

    def attach_metrics(self, metrics) -> None:
        """Late attach replays the distinct edges recorded so far, so
        the counter is exact regardless of attach order."""
        with self._lock:
            self.metrics = metrics
            for key in self.observed:
                result = (
                    "inversion"
                    if any(i["edge"] == key for i in self.inversions)
                    else "observed"
                )
                metrics.count_lock_witness_edge(result)


# ---------------------------------------------------------------------------
# lifecycle


def env_enabled() -> bool:
    return os.environ.get(ENV, "").strip().lower() in _TRUTHY


def installed() -> bool:
    return _STATE is not None


def enabled() -> bool:
    """Witness mode on?  Either installed programmatically (tests) or
    requested via KOORD_LOCK_WITNESS=1 (daemons)."""
    return installed() or env_enabled()


def install(order_edges: Optional[Iterable[Tuple[str, str]]] = None,
            metrics=None) -> None:
    """Arm the witness.  ``order_edges`` defaults to the statically
    derived repo order (one AST pass — debug-mode startup cost)."""
    global _STATE
    with _INSTALL_LOCK:
        if order_edges is None:
            order_edges = _repo_order()
        state = _WitnessState(order_edges)
        if metrics is not None:
            state.metrics = metrics
        _STATE = state


def uninstall() -> None:
    global _STATE
    with _INSTALL_LOCK:
        _STATE = None


def _repo_order() -> Set[Tuple[str, str]]:
    from koordinator_tpu_torch.analysis import lockgraph
    from koordinator_tpu_torch.analysis.core import find_repo_root

    return lockgraph.static_order(find_repo_root(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def _active_state() -> Optional[_WitnessState]:
    if _STATE is not None:
        return _STATE
    if env_enabled():
        install()
        return _STATE
    return None


def attach_metrics(metrics) -> None:
    state = _STATE
    if state is not None:
        state.attach_metrics(metrics)


def observed_edges() -> Dict[Tuple[str, str], int]:
    state = _STATE
    if state is None:
        return {}
    with state._lock:
        return dict(state.observed)


def inversions() -> List[dict]:
    state = _STATE
    if state is None:
        return []
    with state._lock:
        return list(state.inversions)


# ---------------------------------------------------------------------------
# the instrumented primitives


class _WitnessMixin:
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class WitnessLock(_WitnessMixin):
    def __init__(self, name: str, state: _WitnessState):
        self.name = name
        self._state = state
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._state.note_acquire(self.name)
            except LockOrderInversion:
                self._inner.release()
                raise
        return got

    def release(self) -> None:
        self._state.note_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()


class WitnessRLock(_WitnessMixin):
    def __init__(self, name: str, state: _WitnessState):
        self.name = name
        self._state = state
        self._inner = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._state.note_acquire(self.name)
            except LockOrderInversion:
                self._inner.release()
                raise
        return got

    def release(self) -> None:
        self._state.note_release(self.name)
        self._inner.release()


class WitnessCondition(_WitnessMixin):
    """Wraps a ``threading.Condition`` (its default RLock); ``wait``
    leaves the held-set for the park and re-records edges on wakeup."""

    def __init__(self, name: str, state: _WitnessState):
        self.name = name
        self._state = state
        self._inner = threading.Condition()

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            try:
                self._state.note_acquire(self.name)
            except LockOrderInversion:
                self._inner.release()
                raise
        return got

    def release(self) -> None:
        self._state.note_release(self.name)
        self._inner.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        depth = self._state.note_wait_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            self._state.note_wait_reacquire(self.name, depth)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # re-implemented over wait() so the held-set bookkeeping holds
        # for every park, matching the stdlib's loop
        import time

        result = predicate()
        if result:
            return result
        endtime = None if timeout is None else time.monotonic() + timeout
        while not result:
            remaining = None
            if endtime is not None:
                remaining = endtime - time.monotonic()
                if remaining <= 0:
                    break
            self.wait(remaining)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


# ---------------------------------------------------------------------------
# the factories (the only API creation sites use)


def witness_lock(name: str):
    """``threading.Lock()`` unless witness mode is armed.  ``name`` must
    equal the statically derived identity — lint drift-checks it."""
    state = _active_state()
    if state is None:
        return threading.Lock()
    return WitnessLock(name, state)


def witness_rlock(name: str):
    state = _active_state()
    if state is None:
        return threading.RLock()
    return WitnessRLock(name, state)


def witness_condition(name: str):
    state = _active_state()
    if state is None:
        return threading.Condition()
    return WitnessCondition(name, state)
