"""lock-held-dispatch: blocking device readbacks under a state lock.

The coalescing dispatch engine (bridge/coalesce.py, bridge/server.py)
exists because a daemon that holds ONE servicer lock across every RPC
body — including the device dispatch and the blocking readback — queues
sixteen parallel Score workers single-file behind a single transfer.
The invariant is lexical and therefore checkable: a
``with <...state lock...>:`` block must never contain a blocking
device->host transfer.  Capture references under the lock; launch and
read back outside it (the device-dispatch queue serializes launches).

The port's blocking readbacks:

* ``.cpu()``, ``.numpy()``, ``.tolist()`` and ``.item()`` on a tensor;
* ``torch.cuda.synchronize()``, ``Event.synchronize()``,
  ``Stream.synchronize()`` and ``Event.elapsed_time()`` (every
  ``.synchronize()``/``.elapsed_time()`` call);
* ``np.asarray``/``np.array``/``np.copy`` of a tensor;

and the reference's JAX spellings (``.block_until_ready()``,
``jax.device_get``), so one rule reads both packages' idioms.  A
receiver cannot be typed statically: a ``.tolist()`` of a host array
under the lock trips the rule as a tensor's would.

Scope: with-blocks whose context expression's terminal attribute names
a state/servicer lock (``_state_lock``, ``state_lock``,
``_servicer_lock``, or a bare ``_lock`` — the pre-split servicer's
spelling).  Nested function *definitions* inside the block are skipped:
a closure defined under the lock does not run under it.  Host-only
registries that guard plain dict/list state under a ``_lock`` never
trip the rule because they perform no device readbacks; a with-block
that legitimately must read back under a lock carries a reasoned
``# koordlint: disable=lock-held-dispatch(<reason>)``.

The **pipeline seam**: the dispatcher's launch critical section
(functions carrying the ``@launch_section`` decorator from
bridge/coalesce.py, and with-blocks on a ``*_launch_lock``) must only
capture state and dispatch device work asynchronously — a blocking
readback inside it stalls every queued launch exactly the way the old
single lock did, un-pipelining the engine silently.  Nested defs
inside a launch-section function are exempt: that is precisely where
the readback closure (the only code allowed to block) lives.

**Through calls** (``check_graph``, run over the whole program by
``run_repo``): a call inside any of those scopes is followed into the
functions the lock graph's resolver names (``lockgraph``), the
closures they define included (a closure built by a callee may run in
its extent, as the kernel ladder's rung thunks do), and is flagged at
the call site when it reaches a readback only a device value makes:
``.cpu()``, ``.numpy()``, a ``synchronize``, ``.elapsed_time()``,
``.block_until_ready()``, ``jax.device_get``.  The spellings a host
array shares (``np.asarray``, ``.tolist()``, ``.item()``) count only
lexically: the port's host staging uses them on numpy values, and a
receiver cannot be typed.  A callee that is itself a launch section
is checked on its own body.  Calls through receivers the resolver
cannot name (parameters, containers) stay unseen.  The port's Assign
holds the launch lock for its whole cycle (ROADMAP Queue C "The
servicer"), and its kernel ladder synchronizes each rung there, so
``_assign_cycle``'s ``run_cycle`` call carries a reasoned tag.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from koordinator_tpu_torch.analysis.core import SourceFile, Violation
from koordinator_tpu_torch.analysis.lockgraph import (
    _iter_funcs,
    _resolve_callable,
    _walk_own,
    build_graph,
)

RULE = "lock-held-dispatch"

_NP_MODULES = ("np", "numpy", "onp", "_np")
_NP_SYNC_FUNCS = ("asarray", "array", "copy")
_JAX_MODULES = ("jax",)
# tensor -> host copies and waits on the device
_TENSOR_READBACKS = ("cpu", "numpy", "tolist", "item")
_DEVICE_WAITS = ("synchronize", "elapsed_time", "block_until_ready")
_LOCK_NAMES = ("_state_lock", "state_lock", "_servicer_lock", "_lock")
# the pipelined dispatcher's launch critical section
_LAUNCH_LOCK_NAMES = ("_launch_lock", "launch_lock")
_LAUNCH_DECORATOR = "launch_section"
# what a call is followed to: the readbacks a host array cannot make
_DEVICE_ONLY = (
    ".cpu()", ".numpy()", "torch.cuda.synchronize()", ".synchronize()",
    ".elapsed_time()", ".block_until_ready()", "jax.device_get()",
)


def _terminal_name(node: ast.AST) -> str:
    """The last segment of a Name/Attribute chain (``self.x._lock`` ->
    "_lock"); '' for anything else (calls like ``maybe_span(...)``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _root_module(node: ast.AST) -> str:
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_state_lock_with(node: ast.With) -> bool:
    return any(
        _terminal_name(item.context_expr) in _LOCK_NAMES
        for item in node.items
    )


def _is_launch_lock_with(node: ast.With) -> bool:
    return any(
        _terminal_name(item.context_expr) in _LAUNCH_LOCK_NAMES
        for item in node.items
    )


def _is_launch_section_def(node: ast.AST) -> bool:
    """A function carrying the ``@launch_section`` marker (bare name or
    attribute form, e.g. ``@coalesce.launch_section``) runs under the
    dispatcher's launch lock."""
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    return any(
        _terminal_name(dec) == _LAUNCH_DECORATOR
        for dec in node.decorator_list
    )


def _walk_skip_defs(nodes) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/class
    definitions (a closure defined under the lock runs elsewhere)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                   ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _blocking_call(sub: ast.AST) -> str:
    """Name of the blocking device->host transfer this Call performs,
    or '' for anything else."""
    if not isinstance(sub, ast.Call):
        return ""
    fn = sub.func
    if isinstance(fn, ast.Attribute) and (
        _root_module(fn) in _NP_MODULES and fn.attr in _NP_SYNC_FUNCS
    ):
        return f"np.{fn.attr}()"
    if isinstance(fn, ast.Attribute) and fn.attr in _TENSOR_READBACKS:
        return f".{fn.attr}()"
    if isinstance(fn, ast.Attribute) and fn.attr in _DEVICE_WAITS:
        if fn.attr == "synchronize" and _root_module(fn) == "torch":
            return "torch.cuda.synchronize()"
        return f".{fn.attr}()"
    if isinstance(fn, ast.Attribute) and (
        _root_module(fn) in _JAX_MODULES and fn.attr == "device_get"
    ):
        return "jax.device_get()"
    return ""


_STATE_MSG = (
    "{flagged} while the servicer state lock is held serializes every "
    "RPC behind one device->host transfer; capture references under "
    "the lock and read back outside it (the device-dispatch queue "
    "orders launches)"
)
_LAUNCH_MSG = (
    "{flagged} inside the dispatcher's launch critical section stalls "
    "every queued launch behind one device->host transfer — the "
    "pipeline un-pipelines silently; launch sections capture + "
    "dispatch asynchronously, only the readback closure (a nested "
    "def, exempt) may block"
)


def check(source: SourceFile) -> List[Violation]:
    # a blocking call can sit under BOTH scopes at once (a state-lock
    # with-block nested inside a launch-section def); one flagged line
    # is one violation, so dedup on (path, line) keeping the first
    # (outermost) scope's message
    out: List[Violation] = []
    seen: set = set()
    for node in ast.walk(source.tree):
        if isinstance(node, ast.With) and _is_state_lock_with(node):
            body, msg = node.body, _STATE_MSG
        elif isinstance(node, ast.With) and _is_launch_lock_with(node):
            body, msg = node.body, _LAUNCH_MSG
        elif _is_launch_section_def(node):
            body, msg = node.body, _LAUNCH_MSG
        else:
            continue
        for sub in _walk_skip_defs(body):
            flagged = _blocking_call(sub)
            if flagged:
                key = (source.path, sub.lineno)
                if key in seen:
                    continue
                seen.add(key)
                out.append(
                    Violation(
                        rule=RULE,
                        path=source.path,
                        line=sub.lineno,
                        message=msg.format(flagged=flagged),
                    )
                )
    return out


def _scopes(fn_node: ast.AST) -> Iterator[Tuple[List[ast.stmt], str]]:
    """The lock scopes of one function's own body: a launch-section
    body, and its state-lock and launch-lock with-blocks (nested defs
    are their own units)."""
    if _is_launch_section_def(fn_node):
        yield fn_node.body, _LAUNCH_MSG
    for node in _walk_own(fn_node):
        if isinstance(node, ast.With) and _is_state_lock_with(node):
            yield node.body, _STATE_MSG
        elif isinstance(node, ast.With) and _is_launch_lock_with(node):
            yield node.body, _LAUNCH_MSG


_Reach = Optional[Tuple[str, str, int, Tuple[str, ...]]]


def _reaches(graph, fn, memo: Dict[int, _Reach], stack: set) -> _Reach:
    """``(readback, path, line, chain)`` of the first device-only
    readback ``fn`` reaches, itself, through a closure it defines, or
    through a call the resolver names; None when it reaches none."""
    key = id(fn.node)
    if key in memo:
        return memo[key]
    if key in stack or _is_launch_section_def(fn.node):
        return None
    stack.add(key)
    units = [fn]
    todo = list(fn.nested.values())
    while todo:
        unit = todo.pop()
        units.append(unit)
        todo.extend(unit.nested.values())
    found: _Reach = None
    calls = []
    for unit in units:
        for node in _walk_own(unit.node):
            flagged = _blocking_call(node)
            if flagged in _DEVICE_ONLY:
                found = (flagged, unit.module.path, node.lineno,
                         (unit.qualname,))
                break
            if isinstance(node, ast.Call):
                calls.append((unit, node))
        if found:
            break
    for unit, call in calls if found is None else ():
        for target in _resolve_callable(graph, unit, call.func):
            deeper = _reaches(graph, target, memo, stack)
            if deeper is not None:
                flagged, path, line, chain = deeper
                found = (flagged, path, line, (unit.qualname,) + chain)
                break
        if found:
            break
    stack.discard(key)
    memo[key] = found
    return found


def check_graph(graph) -> List[Violation]:
    """The call-following half of the rule over a whole program
    (``lockgraph.build_graph``): each call inside a lock scope that
    reaches a device-only readback, flagged at the call."""
    memo: Dict[int, _Reach] = {}
    out: List[Violation] = []
    seen: set = set()
    for mod_name in sorted(graph.modules):
        mod = graph.modules[mod_name]
        for fn in sorted(_iter_funcs(mod), key=lambda f: f.node.lineno):
            for body, msg in _scopes(fn.node):
                for sub in _walk_skip_defs(body):
                    if not isinstance(sub, ast.Call) or _blocking_call(sub):
                        continue  # the lexical check owns a direct readback
                    key = (mod.path, sub.lineno)
                    if key in seen:
                        continue
                    for target in _resolve_callable(graph, fn, sub.func):
                        hit = _reaches(graph, target, memo, set())
                        if hit is None:
                            continue
                        flagged, path, line, chain = hit
                        seen.add(key)
                        out.append(Violation(
                            rule=RULE, path=mod.path, line=sub.lineno,
                            message=msg.format(flagged=(
                                f"{ast.unparse(sub.func)}(), reaching "
                                f"{flagged} at {path}:{line} through "
                                f"{' -> '.join(chain)},")),
                        ))
                        break
    return out


def check_sources(sources: Dict[str, str]) -> List[Violation]:
    """Test seam: the call-following half over synthetic sources."""
    return check_graph(build_graph(sources))
