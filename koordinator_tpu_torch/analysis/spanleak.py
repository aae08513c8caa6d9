"""span-leak: every ``begin_span`` must end on ALL exit paths.

The obs span recorder (obs/spans.py) exposes a raw
``begin_span(name) -> handle`` / ``end_span(handle)`` pair for call
sites where the context-manager form can't be used (e.g. a span whose
recorder may be None).  A raw ``begin_span`` whose ``end_span`` only
runs on the happy path leaks the span whenever the stage raises — the
flight recorder then shows a stage that "never finished" on every
cycle AFTER the bad one, which is exactly the misleading artifact a
post-mortem tool must not produce.

Accepted shapes (anything else is a violation):

* ``with recorder.span("stage"): ...`` — the context-manager form
  (no raw begin/end at the call site at all; preferred).
* ``h = r.begin_span("x")`` immediately followed by a ``try:`` whose
  ``finally:`` calls ``end_span`` (the canonical raw form).
* ``begin_span`` anywhere inside a ``try`` whose ``finally`` calls
  ``end_span``.
* ``begin_span`` inside an ``__enter__`` whose class's ``__exit__``
  calls ``end_span`` (the context-manager *implementation* pattern —
  obs/spans.py itself).

The rule extends over the distributed-tracing API:

* ``start_trace_span(...)`` mints an exportable span that MUST be
  ended or aborted on every exit — a leaked TraceSpan never exports,
  so the assembled tree silently loses the very RPC a post-mortem is
  looking for.  Accepted shapes: the with-block form (TraceSpan is a
  context manager), ``return start_trace_span(...)`` (a factory hands
  ownership to its caller — ``ScorerServicer._start_rpc_span``), or an
  enclosing function that demonstrably closes both paths — ``.end(``/
  ``.abort(`` in some ``finally:``, or ``.abort(`` in an except
  handler plus an ``.end(`` on the fall-through.
* a ``SpanExporter(...)`` handle must be CLOSED: with-block,
  ``return``-factory, ``.close(`` in a protecting ``finally:``, or
  assignment to ``self.<attr>`` inside a class whose ``close`` method
  calls ``.close(`` (the CycleTelemetry/ScorerClient lifetime shape).

Suppressible per line like every rule:
``# koordlint: disable=span-leak(<reason>)``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "span-leak"


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _contains_call(node: ast.AST, name: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _call_name(sub) == name:
            return True
    return False


def _ends_in_finally(try_node: ast.Try) -> bool:
    return any(_contains_call(stmt, "end_span") for stmt in try_node.finalbody)


def _parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _in_protected_try(node: ast.AST, parents) -> bool:
    """Inside a Try (body/handlers/orelse — not the finally itself)
    whose finalbody ends the span."""
    child = node
    while child in parents:
        parent = parents[child]
        if isinstance(parent, ast.Try) and _ends_in_finally(parent):
            # `child` is the Try's direct child on the ancestor path;
            # anywhere but the finalbody itself counts as protected
            if child not in parent.finalbody:
                return True
        child = parent
    return False


def _followed_by_protected_try(node: ast.AST, parents) -> bool:
    """The canonical raw form: the begin_span statement's NEXT sibling
    is a Try whose finally ends the span."""
    stmt = node
    while stmt in parents and not isinstance(stmt, ast.stmt):
        stmt = parents[stmt]
    if not isinstance(stmt, ast.stmt) or stmt not in parents:
        return False
    block_owner = parents[stmt]
    for field in ("body", "orelse", "finalbody"):
        block = getattr(block_owner, field, None)
        if isinstance(block, list) and stmt in block:
            i = block.index(stmt)
            if i + 1 < len(block):
                nxt = block[i + 1]
                return isinstance(nxt, ast.Try) and _ends_in_finally(nxt)
            return False
    # statements inside an except handler live on the handler, not the Try
    if isinstance(block_owner, ast.excepthandler):
        block = block_owner.body
        if stmt in block:
            i = block.index(stmt)
            if i + 1 < len(block):
                nxt = block[i + 1]
                return isinstance(nxt, ast.Try) and _ends_in_finally(nxt)
    return False


def _in_enter_with_exit(node: ast.AST, parents) -> bool:
    """The CM implementation pattern: begin in __enter__, end in the
    same class's __exit__."""
    child = node
    func: Optional[ast.AST] = None
    while child in parents:
        parent = parents[child]
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = parent
            break
        child = parent
    if func is None or func.name != "__enter__" or func not in parents:
        return False
    cls = parents[func]
    if not isinstance(cls, ast.ClassDef):
        return False
    for stmt in cls.body:
        if (
            isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
            and stmt.name == "__exit__"
            and _contains_call(stmt, "end_span")
        ):
            return True
    return False


def _enclosing_function(node: ast.AST, parents) -> Optional[ast.AST]:
    child = node
    while child in parents:
        parent = parents[child]
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return parent
        child = parent
    return None


def _is_returned(node: ast.AST, parents) -> bool:
    """``return <call>(...)`` — a factory transfers ownership to its
    caller (ScorerServicer._start_rpc_span is the canonical one)."""
    return isinstance(parents.get(node), ast.Return)


def _in_with_items(node: ast.AST, parents) -> bool:
    """The call is a with-statement's context expression (directly or
    under the withitem): the CM protocol ends/closes it."""
    child = node
    while child in parents:
        parent = parents[child]
        if isinstance(parent, ast.withitem):
            return True
        if isinstance(parent, ast.stmt):
            return False
        child = parent
    return False


def _attr_call_in(node: ast.AST, *names: str) -> bool:
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in names
        ):
            return True
    return False


def _function_closes_span(func: ast.AST) -> bool:
    """The enclosing function demonstrably closes BOTH paths of a
    TraceSpan: ``.end(``/``.abort(`` in some finally, or ``.abort(``
    in an except handler plus an ``.end(`` on the fall-through."""
    finally_close = False
    handler_abort = False
    end_anywhere = False
    for sub in ast.walk(func):
        if isinstance(sub, ast.Try):
            if any(
                _attr_call_in(s, "end", "abort") for s in sub.finalbody
            ):
                finally_close = True
            for handler in sub.handlers:
                if any(
                    _attr_call_in(s, "abort", "end")
                    for s in handler.body
                ):
                    handler_abort = True
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "end"
        ):
            end_anywhere = True
    return finally_close or (handler_abort and end_anywhere)


def _assigned_to_self_with_close(node: ast.AST, parents) -> bool:
    """``self.x = SpanExporter(...)`` inside a class whose ``close``
    method calls ``.close(`` — the long-lived handle shape
    (CycleTelemetry, ScorerClient)."""
    parent = parents.get(node)
    if not (
        isinstance(parent, ast.Assign)
        and len(parent.targets) == 1
        and isinstance(parent.targets[0], ast.Attribute)
        and isinstance(parent.targets[0].value, ast.Name)
        and parent.targets[0].value.id == "self"
    ):
        return False
    child: ast.AST = parent
    while child in parents:
        up = parents[child]
        if isinstance(up, ast.ClassDef):
            return any(
                isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and stmt.name == "close"
                and _attr_call_in(stmt, "close")
                for stmt in up.body
            )
        child = up
    return False


def _in_try_closing(node: ast.AST, parents, *names: str) -> bool:
    """Inside (or immediately followed by) a Try whose finally calls
    one of ``names`` — the close-in-finally shape for handles."""
    child = node
    while child in parents:
        parent = parents[child]
        if isinstance(parent, ast.Try) and child not in parent.finalbody:
            if any(_attr_call_in(s, *names) for s in parent.finalbody):
                return True
        child = parent
    # the begin-then-try sibling shape
    stmt = node
    while stmt in parents and not isinstance(stmt, ast.stmt):
        stmt = parents[stmt]
    if isinstance(stmt, ast.stmt) and stmt in parents:
        owner = parents[stmt]
        for field in ("body", "orelse", "finalbody"):
            block = getattr(owner, field, None)
            if isinstance(block, list) and stmt in block:
                i = block.index(stmt)
                if i + 1 < len(block) and isinstance(block[i + 1], ast.Try):
                    return any(
                        _attr_call_in(s, *names)
                        for s in block[i + 1].finalbody
                    )
    return False


def check(source: SourceFile) -> List[Violation]:
    parents = _parents(source.tree)
    out: List[Violation] = []
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name == "begin_span":
            if _in_protected_try(node, parents):
                continue
            if _followed_by_protected_try(node, parents):
                continue
            if _in_enter_with_exit(node, parents):
                continue
            out.append(
                Violation(
                    rule=RULE,
                    path=source.path,
                    line=node.lineno,
                    message=(
                        "begin_span() without a guaranteed end_span() on "
                        "every exit: an exception here leaks the span into "
                        "every later flight record.  Use "
                        "`with recorder.span(...)`, or follow begin_span "
                        "immediately with try/finally calling end_span"
                    ),
                )
            )
        elif name == "start_trace_span":
            if _is_returned(node, parents) or _in_with_items(node, parents):
                continue
            func = _enclosing_function(node, parents)
            if func is not None and _function_closes_span(func):
                continue
            out.append(
                Violation(
                    rule=RULE,
                    path=source.path,
                    line=node.lineno,
                    message=(
                        "start_trace_span() without end()/abort() on "
                        "every exit: a leaked TraceSpan never exports, "
                        "so the assembled trace silently loses this "
                        "RPC.  Use `with ... as span:`, return it from "
                        "a factory, or abort in an except handler and "
                        "end on the fall-through"
                    ),
                )
            )
        elif name == "SpanExporter":
            if _is_returned(node, parents) or _in_with_items(node, parents):
                continue
            if _assigned_to_self_with_close(node, parents):
                continue
            if _in_try_closing(node, parents, "close"):
                continue
            out.append(
                Violation(
                    rule=RULE,
                    path=source.path,
                    line=node.lineno,
                    message=(
                        "SpanExporter() handle is never closed on this "
                        "path: close it in a finally, use the with-"
                        "block form, or hold it on self in a class "
                        "whose close() closes it"
                    ),
                )
            )
    return out
