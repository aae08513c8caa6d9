"""koordlint rule: ``unguarded-shared-state``.

Guarded-state inference, the static shadow of ``go test -race``: if a
class owns a lock and writes an instance attribute under it at one or
more sites, every OTHER access to that attribute in the same class is
presumed to need the lock too — a brownout widen-memoization race and
a breaker verdict race of the serving tier were both exactly this shape,
found by hand before this rule existed.

Mechanics per class (classes that create no ``threading.Lock/RLock/
Condition`` — plain or through the ``obs.lockwitness`` factories — are
out of scope):

* an attribute is GUARDED when a non-init method writes it inside a
  ``with self._lock:`` block (any of the class's locks counts — the
  rule checks locked-vs-lockfree, not which lock; the lock-order graph
  owns the which-lock question) or after a lexical ``.acquire()``;
* a lock-free WRITE to a guarded attribute outside ``__init__``/
  ``__post_init__`` always trips — two writers race regardless of how
  atomic each store is;
* a lock-free READ trips only when some write MUTATES the value in
  place (``self.x[k] = v``, ``self.x.append(...)`` and friends):
  iterating a dict/list another thread is mutating throws; reading an
  attribute that is only ever REBOUND (``self.x = new`` /
  ``self.x += 1``) observes a consistent value under the GIL — the
  immutable-rebinding / atomic-read exemptions the repo already leans
  on (brownout memo swaps, stats counters read by scrapes).

Exemptions, matching repo convention:

* ``__init__`` / ``__post_init__`` writes (construction happens-before
  publication);
* methods named ``*_locked`` (the caller-holds-the-lock convention
  lock-held-dispatch already keys on);
* nested functions and lambdas (closures run under the dispatcher's
  locks elsewhere — the lock graph models those seams);
* everything else needs a REASONED suppression:
  ``# koordlint: disable=unguarded-shared-state(reason: ...)`` — the
  suppression audit (``--suppressions``) fails tags without a reason.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "unguarded-shared-state"

_LOCK_KINDS = ("Lock", "RLock", "Condition")
_FACTORIES = ("witness_lock", "witness_rlock", "witness_condition")

# receiver-mutating method names: a call ``self.x.append(...)`` edits
# the object in place, so lock-free readers can observe a torn
# iteration (RuntimeError) — unlike a rebind, which swaps atomically
_MUTATORS = frozenset((
    "append", "appendleft", "add", "insert", "extend", "update", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "sort",
    "reverse", "setdefault", "__setitem__", "__delitem__",
))

_INIT_METHODS = ("__init__", "__post_init__")


def _terminal_name(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _is_lock_creation(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    term = _terminal_name(value.func)
    return term in _LOCK_KINDS or term in _FACTORIES


def _self_attr(expr: ast.AST) -> Optional[str]:
    """``self.x`` -> ``x``."""
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


class _Access:
    __slots__ = ("attr", "line", "locked", "kind", "init")

    def __init__(self, attr: str, line: int, locked: bool, kind: str,
                 init: bool):
        self.attr = attr
        self.line = line
        self.locked = locked
        self.kind = kind  # "read" | "rebind" | "mutate"
        self.init = init


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attribute names bound to lock objects anywhere in the class."""
    out: Set[str] = set()
    for item in cls.body:
        if (isinstance(item, ast.Assign) and len(item.targets) == 1
                and isinstance(item.targets[0], ast.Name)
                and _is_lock_creation(item.value)):
            out.add(item.targets[0].id)
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(item):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and _is_lock_creation(node.value)):
                attr = _self_attr(node.targets[0])
                if attr is not None:
                    out.add(attr)
    return out


def _held_expr(expr: ast.AST, locks: Set[str]) -> bool:
    """Is this with-item / acquire receiver one of the class locks?"""
    attr = _self_attr(expr)
    return attr is not None and attr in locks


def check(source: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(source.tree):
        if isinstance(node, ast.ClassDef):
            out.extend(_check_class(source, node))
    # dedup (nested classes walked twice by ast.walk are not, but keep
    # the lockdispatch convention anyway)
    seen: Set[tuple] = set()
    uniq: List[Violation] = []
    for v in out:
        key = (v.path, v.line, v.message)
        if key not in seen:
            seen.add(key)
            uniq.append(v)
    uniq.sort(key=lambda v: (v.path, v.line))
    return uniq


def _check_class(source: SourceFile, cls: ast.ClassDef) -> List[Violation]:
    locks = _lock_attrs(cls)
    if not locks:
        return []
    accesses: List[_Access] = []
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name.endswith("_locked"):
            continue  # caller-holds-the-lock convention
        init = item.name in _INIT_METHODS
        _collect(item.body, locks, held=False, init=init, out=accesses)

    guarded: Set[str] = {
        a.attr for a in accesses
        if a.locked and not a.init and a.kind in ("rebind", "mutate")
    } - locks
    if not guarded:
        return []
    mutated: Set[str] = {
        a.attr for a in accesses if a.kind == "mutate"
    }
    out: List[Violation] = []
    for a in accesses:
        if a.attr not in guarded or a.locked or a.init:
            continue
        if a.kind in ("rebind", "mutate"):
            out.append(Violation(
                RULE, source.path, a.line,
                f"lock-free write to {cls.name}.{a.attr}, which "
                f"{cls.name} elsewhere writes under its lock — two "
                "writers race; take the lock here or suppress with the "
                "reason the race is benign",
            ))
        elif a.attr in mutated:
            out.append(Violation(
                RULE, source.path, a.line,
                f"lock-free read of {cls.name}.{a.attr}, which is "
                "mutated in place under the lock elsewhere — an "
                "iteration here can see a mid-mutation structure; take "
                "the lock, snapshot under it, or suppress with a reason",
            ))
    return out


def _collect(stmts: List[ast.stmt], locks: Set[str], held: bool,
             init: bool, out: List[_Access]) -> None:
    """Walk one statement block tracking whether a class lock is held
    lexically (``with self._lock:`` or after ``self._lock.acquire()``)."""
    acquired_here = False
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue  # closures run elsewhere; the lock graph owns them
        now_held = held or acquired_here
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = now_held
            for item in stmt.items:
                _scan_expr(item.context_expr, locks, now_held, init, out)
                if _held_expr(item.context_expr, locks):
                    inner = True
            _collect(list(stmt.body), locks, inner, init, out)
            continue
        for expr in ast.iter_child_nodes(stmt):
            if isinstance(expr, ast.expr):
                _scan_expr(expr, locks, now_held, init, out)
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                _scan_target(target, locks, now_held, init, out)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            _scan_target(stmt.target, locks, now_held, init, out,
                         aug=isinstance(stmt, ast.AugAssign))
        elif isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                _scan_target(target, locks, now_held, init, out)
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                _collect(list(sub), locks, now_held, init, out)
        for handler in getattr(stmt, "handlers", ()) or ():
            _collect(list(handler.body), locks, now_held, init, out)
        if _acquires_lock(stmt, locks):
            acquired_here = True


def _acquires_lock(stmt: ast.stmt, locks: Set[str]) -> bool:
    for node in ast.walk(stmt):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
                and _held_expr(node.func.value, locks)):
            return True
    return False


def _scan_target(target: ast.AST, locks: Set[str], held: bool,
                 init: bool, out: List[_Access], aug: bool = False) -> None:
    attr = _self_attr(target)
    if attr is not None:
        if attr not in locks:
            out.append(_Access(attr, target.lineno, held, "rebind", init))
        return
    if isinstance(target, ast.Subscript):
        attr = _self_attr(target.value)
        if attr is not None and attr not in locks:
            out.append(_Access(attr, target.lineno, held, "mutate", init))
        else:
            _scan_expr(target, locks, held, init, out)
        return
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            _scan_target(elt, locks, held, init, out)


def _scan_expr(expr: ast.AST, locks: Set[str], held: bool, init: bool,
               out: List[_Access]) -> None:
    """Record reads (and mutator-call mutations) of self attributes."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                recv = _self_attr(func.value)
                if recv is not None and recv not in locks:
                    kind = ("mutate" if func.attr in _MUTATORS
                            else "read")
                    out.append(_Access(recv, node.lineno, held, kind, init))
                    stack.extend(node.args)
                    stack.extend(kw.value for kw in node.keywords)
                    continue
            stack.extend(ast.iter_child_nodes(node))
            continue
        attr = _self_attr(node)
        if attr is not None:
            if attr not in locks and not isinstance(
                    getattr(node, "ctx", None), (ast.Store, ast.Del)):
                out.append(_Access(attr, node.lineno, held, "read", init))
            continue
        stack.extend(ast.iter_child_nodes(node))
