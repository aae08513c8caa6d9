"""koordlint rule: ``unbounded-wait``.

The degradation ladder's premise is that a fault degrades service
instead of hanging it — and an UNBOUNDED wait is exactly where a fault
turns into a hang nobody can distinguish from a deadlock.  Two shapes,
both with a named production failure mode:

* ``<x>.wait()`` with no timeout — a ``threading.Condition`` or
  ``Event`` wait that a lost notify (or a crashed peer that will never
  set the event) parks FOREVER.  The repo convention is the
  coalescer's backstop: ``cond.wait(timeout=1.0)`` inside the state
  re-check loop — a lost notify is a bug this recovers from at 1 Hz,
  not a hang.  Deliberate forever-parks (a main thread idling behind
  daemon threads) take a reasoned disable tag.
* a client RPC stub call with no ``timeout=``/``deadline=`` kwarg — a
  hung daemon then hangs every caller, and the propagated-deadline
  machinery (``deadline_ms`` on the wire, evicted server-side
  before a launch slot) never gets to run because the transport itself
  never gives up.  The rule recognizes the repo's stub idiom: a call
  whose callee is named ``stub`` or ends in ``_stub``, unless the callee
  is a module-level def of the same file that returns a
  ``functools.partial`` — a stub factory binding a connection and a
  method, invoked with ``timeout=`` later.

Shapes NOT flagged: ``wait(x)`` with any argument (a bounded wait,
however long, surfaces in a stack sample as progress), ``wait_for``
with a timeout kwarg, and computed receivers that merely contain
"wait" in a longer method name.

Suppression::

    threading.Event().wait()  # koordlint: disable=unbounded-wait(main thread parks forever by design; daemon threads own the work)
"""

from __future__ import annotations

import ast
from typing import List, Set

from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "unbounded-wait"

_DEADLINE_KWARGS = {"timeout", "deadline"}


def _is_stub_callee(fn) -> bool:
    """The repo's client idiom: locals named ``stub`` (client.py's
    ``stub(request)``) or helper results bound as ``*_stub``."""
    if isinstance(fn, ast.Name):
        name = fn.id
    elif isinstance(fn, ast.Attribute):
        name = fn.attr
    else:
        return False
    return name == "stub" or name.endswith("_stub")


def _partial_factories(tree: ast.AST) -> Set[str]:
    """Module-level defs that return a ``functools.partial``: stub
    FACTORIES (the port's ``_stub(channel, method)``), whose positional
    arguments bind a connection and a method, not a request.  The
    deadline is passed where the partial is invoked."""
    out: Set[str] = set()
    for node in getattr(tree, "body", ()):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Return)
                    and isinstance(sub.value, ast.Call)
                    and _callee_name(sub.value.func) == "partial"):
                out.add(node.name)
    return out


def _callee_name(fn) -> str:
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def check(source: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    factories = _partial_factories(source.tree)
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        kwarg_names = {k.arg for k in node.keywords if k.arg}
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr == "wait"
            and not node.args
            and not kwarg_names & _DEADLINE_KWARGS
            and not any(k.arg is None for k in node.keywords)
        ):
            out.append(Violation(
                rule=RULE,
                path=source.path,
                line=node.lineno,
                message=(
                    ".wait() with no timeout parks this thread forever "
                    "on a lost notify or a peer that died; use the "
                    "backstop idiom (wait(timeout=1.0) inside the "
                    "state re-check loop) or tag a deliberate "
                    "forever-park with a reasoned disable"
                ),
            ))
            continue
        if (
            _is_stub_callee(fn)
            and not (isinstance(fn, ast.Name) and fn.id in factories)
            # an RPC invocation passes the request positionally; a
            # zero-arg call is a stub FACTORY (``self._score_stub()``)
            and node.args
            and not kwarg_names & _DEADLINE_KWARGS
            and not any(k.arg is None for k in node.keywords)
        ):
            out.append(Violation(
                rule=RULE,
                path=source.path,
                line=node.lineno,
                message=(
                    "client RPC stub call without a timeout/deadline "
                    "kwarg: a hung daemon hangs every caller and the "
                    "propagated per-RPC deadline never applies; pass "
                    "timeout= (seconds) on every stub invocation"
                ),
            ))
    return out
