"""koordlint whole-program pass: the lock-order graph.

The reference Koordinator runs its concurrency surface under ``go test
-race``; this module is the static half of our equivalent.  It walks
EVERY repo Python file at once and

* inventories each ``threading.Lock/RLock/Condition`` creation site
  (plain or through the ``obs.lockwitness`` factories) into a canonical
  identity — ``module.Class.attr`` for instance locks,
  ``module.name`` for module-level locks, ``module.func.name`` for
  function-locals;
* derives nested-acquisition edges: a ``with``-block (or a lexical
  ``.acquire()``) on lock A whose body acquires — directly, or through
  a call resolved via the module-local + cross-module method table —
  lock B yields the ordering edge A -> B.  ``Condition.wait`` is
  modelled as release + re-acquire (the re-acquire re-asserts the
  enclosing held-set's edges, tagged so the doc shows the wait seam);
* understands the repo's two higher-order dispatch seams: a
  ``@launch_section`` body runs under the coalescer launch lock, and a
  callable handed to ``run_exclusive``/``run_pipelined`` executes with
  that same lock held;
* emits the derived partial order into the GENERATED
  ``koordinator_tpu_torch/analysis/LOCKORDER.md`` (the port's own
  table: the reference's ``docs/LOCKORDER.md`` orders the reference's
  locks) and drift-lints it in both directions (the
  metricsdoc pattern: a derived edge missing from the doc, a doc row
  no pass derives, and byte-level staleness all fail);
* fails lint on any cycle in the derived order (``lock-order-cycle``)
  — the static deadlock signal the runtime witness
  (``obs/lockwitness.py``) then validates against real interleavings.

Known approximations, chosen deliberately and validated by the witness:

* ``.acquire()`` holds for the REST of the enclosing block (releases
  are not tracked) — over-approximate, so it can only add edges, never
  hide one;
* calls through unresolvable receivers (parameters, heterogeneous
  collections) contribute no edges — the runtime witness covers those
  interleavings;
* two instances of the same identity (three followers' ``_state_lock``)
  collapse onto one node; identity self-edges are ignored (the
  FreeBSD-witness "dup ok" convention).

All graph functions take a ``{relpath: source}`` mapping so tests can
seed synthetic multi-module programs; ``check_repo`` reads the real
tree.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from koordinator_tpu_torch.analysis.core import (
    PACKAGE,
    Violation,
    scanned_files,
)

CYCLE_RULE = "lock-order-cycle"
DRIFT_RULE = "lockorder-doc-drift"

MD_PATH = os.path.join(PACKAGE, "analysis", "LOCKORDER.md")

_LOCK_KINDS = ("Lock", "RLock", "Condition")
_WITNESS_FACTORIES = {
    "witness_lock": "Lock",
    "witness_rlock": "RLock",
    "witness_condition": "Condition",
}

# The witness's own bookkeeping primitives are the instrumentation
# layer, not part of the serving tier's order — the witness must not
# witness itself, statically or at runtime.
_EXCLUDED_MODULES = frozenset(("obs.lockwitness",))

# The repo's higher-order dispatch seams.  A ``@launch_section`` body
# executes under the coalescer launch lock (the decorator is the
# marker lock-held-dispatch already keys on); a callable argument to
# ``run_exclusive``/``run_pipelined`` runs with that lock held.  Both
# are applied only when the referenced identity exists in the
# inventory, so seeded fixtures without a coalescer are unaffected.
_LAUNCH_LOCK_ID = "bridge.coalesce.CoalescingDispatcher._launch_lock"
_SECTION_DECORATORS = {"launch_section": _LAUNCH_LOCK_ID}
_HIGHER_ORDER_SEAMS = {
    "run_exclusive": _LAUNCH_LOCK_ID,
    "run_pipelined": _LAUNCH_LOCK_ID,
}

_THREADING_SENTINEL = ("<threading>", None)

# Method names too generic for the unique-method fallback: calls on
# unresolvable receivers (locals, untyped parameters) resolve through
# the cross-module method table only when exactly ONE class defines the
# name AND the name cannot be a stdlib-collection/IO method — a
# ``frames.append(...)`` on a plain list must never resolve to some
# class's ``append``.
_GENERIC_METHODS = frozenset((
    "append", "add", "get", "put", "pop", "push", "close", "stop",
    "start", "run", "join", "send", "sendall", "recv", "write", "read",
    "update", "clear", "copy", "items", "keys", "values", "extend",
    "remove", "discard", "insert", "index", "count", "sort", "reverse",
    "acquire", "release", "locked", "wait", "notify", "notify_all",
    "submit", "result", "cancel", "set", "unset", "reset", "info",
    "debug", "warning", "error", "exception", "format", "encode",
    "decode", "strip", "split", "splitlines", "setdefault", "flush",
    "seek", "tell", "observe", "record", "emit", "check", "name",
))


def module_name(rel_path: str) -> str:
    """``koordinator_tpu_torch/bridge/server.py`` -> ``bridge.server``;
    ``chip_smoke.py`` -> ``chip_smoke``; package __init__ collapses onto
    the package name.  The identities are the reference's for the same
    module, so the two lock orders compare row for row."""
    parts = rel_path.replace(os.sep, "/").split("/")
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[0] == PACKAGE:
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else PACKAGE


@dataclasses.dataclass
class LockSite:
    identity: str
    kind: str  # Lock | RLock | Condition
    path: str
    line: int
    witness_name: Optional[str]  # string handed to a witness_* factory


@dataclasses.dataclass
class Edge:
    src: str
    dst: str
    path: str
    line: int
    via: str


class _Func:
    def __init__(self, node, module: "_Module", qualname: str,
                 cls: Optional["_Class"]):
        self.node = node
        self.module = module
        self.qualname = qualname  # "Class.meth", "func", "func.inner"
        self.cls = cls
        self.nested: Dict[str, "_Func"] = {}
        self.local_locks: Dict[str, str] = {}  # var name -> identity


class _Class:
    def __init__(self, name: str, module: "_Module", node: ast.ClassDef):
        self.name = name
        self.module = module
        self.node = node
        self.methods: Dict[str, _Func] = {}
        self.lock_attrs: Dict[str, str] = {}  # attr -> identity
        self.attr_types: Dict[str, Tuple[str, str]] = {}  # attr -> class ref
        self.base_refs: List[Tuple[str, str]] = []  # resolved after pass 1

    def mro(self, graph: "LockGraph") -> Iterable["_Class"]:
        seen: Set[Tuple[str, str]] = set()
        stack = [self]
        while stack:
            cls = stack.pop(0)
            key = (cls.module.name, cls.name)
            if key in seen:
                continue
            seen.add(key)
            yield cls
            for ref in cls.base_refs:
                base = graph.classes.get(ref)
                if base is not None:
                    stack.append(base)


class _Module:
    def __init__(self, path: str, name: str, tree: ast.Module):
        self.path = path
        self.name = name
        self.tree = tree
        # alias -> (module, symbol|None); symbol None means the alias IS
        # the module.  ("<threading>", None) marks the stdlib threading
        # module itself.
        self.imports: Dict[str, Tuple[str, Optional[str]]] = {}
        self.classes: Dict[str, _Class] = {}
        self.functions: Dict[str, _Func] = {}
        self.module_locks: Dict[str, str] = {}  # name -> identity


class LockGraph:
    def __init__(self) -> None:
        self.locks: Dict[str, LockSite] = {}
        self.edges: Dict[Tuple[str, str], Edge] = {}
        self.modules: Dict[str, _Module] = {}
        self.classes: Dict[Tuple[str, str], _Class] = {}
        self.violations: List[Violation] = []  # inventory-level findings
        # method name -> defining classes (the cross-module method table)
        self.method_index: Dict[str, List[_Class]] = {}

    def adjacency(self) -> Dict[str, Set[str]]:
        adj: Dict[str, Set[str]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, set()).add(dst)
        return adj


# ---------------------------------------------------------------------------
# helpers


def _terminal_name(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _strip_pkg(dotted: str) -> str:
    if dotted == PACKAGE:
        return ""
    if dotted.startswith(PACKAGE + "."):
        return dotted[len(PACKAGE) + 1:]
    return dotted


def _import_target(module: _Module, node: ast.AST) -> None:
    """Record import aliases for later cross-module resolution."""
    if isinstance(node, ast.Import):
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            if alias.name == "threading":
                module.imports[name] = _THREADING_SENTINEL
            elif alias.asname:
                module.imports[alias.asname] = (_strip_pkg(alias.name), None)
            else:
                # ``import a.b.c`` binds ``a``; dotted chains through it
                # are resolved attribute by attribute, which we skip.
                module.imports[name] = (_strip_pkg(alias.name.split(".")[0]),
                                        None)
    elif isinstance(node, ast.ImportFrom):
        src = node.module or ""
        if node.level:
            # relative import: anchor on this module's package
            pkg = module.name.split(".")
            pkg = pkg[: len(pkg) - node.level] if node.level <= len(pkg) else []
            src = ".".join(pkg + ([src] if src else []))
        else:
            src = _strip_pkg(src)
        for alias in node.names:
            bound = alias.asname or alias.name
            if src == "threading" or (not src and alias.name == "threading"):
                if alias.name in _LOCK_KINDS:
                    module.imports[bound] = ("<threading>", alias.name)
                continue
            module.imports[bound] = (src, alias.name)


def _creation_kind(
    call: ast.Call, module: _Module
) -> Optional[Tuple[str, Optional[str], bool]]:
    """``(kind, witness_name, is_factory)`` if ``call`` creates a lock.

    Recognizes ``threading.Lock()`` (module alias resolved through the
    import table), a bare imported ``Lock()``, and the
    ``obs.lockwitness`` factory forms ``witness_lock("identity")``.
    """
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _LOCK_KINDS:
        if (isinstance(f.value, ast.Name)
                and module.imports.get(f.value.id) == _THREADING_SENTINEL):
            return (f.attr, None, False)
    if isinstance(f, ast.Name):
        ref = module.imports.get(f.id)
        if ref is not None and ref[0] == "<threading>" and ref[1] in _LOCK_KINDS:
            return (ref[1], None, False)
    term = _terminal_name(f)
    if term in _WITNESS_FACTORIES:
        name = _const_str(call.args[0]) if call.args else None
        return (_WITNESS_FACTORIES[term], name, True)
    return None


def _iter_funcs(module: _Module) -> Iterable[_Func]:
    stack: List[_Func] = list(module.functions.values())
    for cls in module.classes.values():
        stack.extend(cls.methods.values())
    while stack:
        fn = stack.pop()
        yield fn
        stack.extend(fn.nested.values())


# ---------------------------------------------------------------------------
# pass 1: symbol tables + inventory


def build_graph(sources: Dict[str, str]) -> LockGraph:
    graph = LockGraph()
    for path in sorted(sources):
        if module_name(path) in _EXCLUDED_MODULES:
            continue
        try:
            tree = ast.parse(sources[path], filename=path)
        except SyntaxError:
            continue  # parse errors belong to the per-file rules
        mod = _Module(path, module_name(path), tree)
        graph.modules[mod.name] = mod
        for node in tree.body:
            _import_target(mod, node)
        _collect_module(graph, mod)
    _resolve_bases(graph)
    for cls in graph.classes.values():
        for meth in cls.methods:
            graph.method_index.setdefault(meth, []).append(cls)
    _build_edges(graph)
    return graph


def _collect_module(graph: LockGraph, mod: _Module) -> None:
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name) and isinstance(node.value, ast.Call):
                made = _creation_kind(node.value, mod)
                if made:
                    identity = f"{mod.name}.{target.id}"
                    _record_lock(graph, identity, made, mod.path,
                                 node.lineno)
                    mod.module_locks[target.id] = identity
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = _Func(node, mod, node.name, None)
            mod.functions[node.name] = fn
            _collect_func(graph, fn)
        elif isinstance(node, ast.ClassDef):
            cls = _Class(node.name, mod, node)
            mod.classes[node.name] = cls
            graph.classes[(mod.name, cls.name)] = cls
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = _Func(item, mod, f"{cls.name}.{item.name}", cls)
                    cls.methods[item.name] = fn
                    _collect_func(graph, fn)
                elif (isinstance(item, ast.Assign) and len(item.targets) == 1
                      and isinstance(item.targets[0], ast.Name)
                      and isinstance(item.value, ast.Call)):
                    made = _creation_kind(item.value, mod)
                    if made:
                        attr = item.targets[0].id
                        identity = f"{mod.name}.{cls.name}.{attr}"
                        _record_lock(graph, identity, made, mod.path,
                                     item.lineno)
                        cls.lock_attrs[attr] = identity


def _collect_func(graph: LockGraph, fn: _Func) -> None:
    """Inventory creations + attr types inside one function body, and
    register nested defs (closures get their own summary units)."""
    mod = fn.module
    for node in _walk_own(fn.node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested = _Func(node, mod, f"{fn.qualname}.{node.name}", fn.cls)
            fn.nested[node.name] = nested
            _collect_func(graph, nested)
            continue
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(node.value, ast.Call):
            continue
        made = _creation_kind(node.value, mod)
        if made is not None:
            if (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self" and fn.cls is not None):
                identity = f"{mod.name}.{fn.cls.name}.{target.attr}"
                _record_lock(graph, identity, made, mod.path, node.lineno)
                fn.cls.lock_attrs.setdefault(target.attr, identity)
            elif isinstance(target, ast.Name):
                identity = f"{mod.name}.{fn.qualname}.{target.id}"
                _record_lock(graph, identity, made, mod.path, node.lineno)
                fn.local_locks[target.id] = identity
            continue
        # attr type: self.x = ClassName(...) / self.x = mod.ClassName(...)
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self" and fn.cls is not None):
            ref = _class_ref(mod, node.value.func)
            if ref is not None:
                fn.cls.attr_types.setdefault(target.attr, ref)


def _walk_own(fn_node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body; nested function/class bodies are yielded as
    single nodes (callers recurse explicitly), lambda bodies skipped."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _class_ref(mod: _Module, func: ast.AST) -> Optional[Tuple[str, str]]:
    """Resolve a constructor expression to ``(module, ClassName)``."""
    if isinstance(func, ast.Name):
        if func.id in mod.classes:
            return (mod.name, func.id)
        ref = mod.imports.get(func.id)
        if ref is not None and ref[1] is not None:
            return (ref[0], ref[1])
    elif isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        ref = mod.imports.get(func.value.id)
        if ref is not None and ref[1] is None and ref[0] != "<threading>":
            return (ref[0], func.attr)
    return None


def _record_lock(graph: LockGraph, identity: str,
                 made: Tuple[str, Optional[str], bool],
                 path: str, line: int) -> None:
    kind, witness_name, is_factory = made
    site = LockSite(identity, kind, path, line, witness_name)
    graph.locks.setdefault(identity, site)
    if is_factory and witness_name != identity:
        got = repr(witness_name) if witness_name is not None else "no name"
        graph.violations.append(Violation(
            DRIFT_RULE, path, line,
            f"witness factory passes {got} but the derived identity is "
            f"{identity!r} — the runtime witness and the static graph "
            "must agree on lock names",
        ))


def _resolve_bases(graph: LockGraph) -> None:
    for cls in graph.classes.values():
        for base in cls.node.bases:
            ref = _class_ref(cls.module, base)
            if ref is not None:
                cls.base_refs.append(ref)


# ---------------------------------------------------------------------------
# resolution


def _resolve_lock(graph: LockGraph, fn: _Func,
                  expr: ast.AST) -> Optional[str]:
    """Resolve an expression to an inventoried lock identity."""
    mod = fn.module
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        if expr.value.id == "self" and fn.cls is not None:
            for cls in fn.cls.mro(graph):
                if expr.attr in cls.lock_attrs:
                    return cls.lock_attrs[expr.attr]
            return None
        ref = mod.imports.get(expr.value.id)
        if ref is not None and ref[1] is None and ref[0] != "<threading>":
            other = graph.modules.get(ref[0])
            if other is not None:
                return other.module_locks.get(expr.attr)
        return None
    if isinstance(expr, ast.Name):
        probe: Optional[_Func] = fn
        while probe is not None:
            if expr.id in probe.local_locks:
                return probe.local_locks[expr.id]
            probe = _enclosing(probe)
        if expr.id in mod.module_locks:
            return mod.module_locks[expr.id]
        ref = mod.imports.get(expr.id)
        if ref is not None and ref[1] is not None and ref[0] in graph.modules:
            return graph.modules[ref[0]].module_locks.get(ref[1])
    return None


def _enclosing(fn: _Func) -> Optional[_Func]:
    """Parent function of a nested def (resolved by qualname)."""
    if "." not in fn.qualname:
        return None
    parent_qual = fn.qualname.rsplit(".", 1)[0]
    mod = fn.module
    candidates: List[_Func] = list(_iter_funcs(mod))
    for cand in candidates:
        if cand.qualname == parent_qual and cand is not fn:
            return cand
    return None


def _resolve_callable(graph: LockGraph, fn: _Func,
                      expr: ast.AST) -> List[_Func]:
    """Resolve a callable-position expression to function units."""
    mod = fn.module
    if isinstance(expr, ast.Lambda):
        shim = _Func(expr, mod, f"{fn.qualname}.<lambda>", fn.cls)
        shim.local_locks = dict(fn.local_locks)
        return [shim]
    if isinstance(expr, ast.Name):
        probe: Optional[_Func] = fn
        while probe is not None:
            if expr.id in probe.nested:
                return [probe.nested[expr.id]]
            probe = _enclosing(probe)
        if expr.id in mod.functions:
            return [mod.functions[expr.id]]
        ctor = _ctor_targets(graph, _class_ref(mod, expr))
        if ctor:
            return ctor
        ref = mod.imports.get(expr.id)
        if ref is not None and ref[1] is not None and ref[0] in graph.modules:
            other = graph.modules[ref[0]]
            if ref[1] in other.functions:
                return [other.functions[ref[1]]]
        return []
    if isinstance(expr, ast.Attribute):
        base = expr.value
        if isinstance(base, ast.Name):
            if base.id == "self" and fn.cls is not None:
                for cls in fn.cls.mro(graph):
                    if expr.attr in cls.methods:
                        return [cls.methods[expr.attr]]
                return []
            ref = mod.imports.get(base.id)
            if ref is not None and ref[1] is None and ref[0] in graph.modules:
                other = graph.modules[ref[0]]
                if expr.attr in other.functions:
                    return [other.functions[expr.attr]]
                if expr.attr in other.classes:
                    return _ctor_targets(graph, (other.name, expr.attr))
                return []
            return _unique_method(graph, expr.attr)
        # self.attr.meth() through the attr-type table
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self" and fn.cls is not None):
            for cls in fn.cls.mro(graph):
                ref = cls.attr_types.get(base.attr)
                if ref is not None:
                    target_cls = graph.classes.get(ref)
                    if target_cls is not None:
                        for tc in target_cls.mro(graph):
                            if expr.attr in tc.methods:
                                return [tc.methods[expr.attr]]
                    return []
            return _unique_method(graph, expr.attr)
    return []


def _unique_method(graph: LockGraph, name: str) -> List[_Func]:
    """Cross-module method-table fallback for unresolvable receivers:
    resolve only when exactly one class program-wide defines ``name``
    and the name cannot belong to a stdlib collection."""
    if name in _GENERIC_METHODS or name.startswith("__"):
        return []
    owners = graph.method_index.get(name, ())
    if len(owners) == 1:
        return [owners[0].methods[name]]
    return []


def _ctor_targets(graph: LockGraph,
                  ref: Optional[Tuple[str, str]]) -> List[_Func]:
    if ref is None:
        return []
    cls = graph.classes.get(ref)
    if cls is None:
        return []
    for c in cls.mro(graph):
        if "__init__" in c.methods:
            return [c.methods["__init__"]]
    return []


# ---------------------------------------------------------------------------
# may-acquire summaries


def _summary(graph: LockGraph, fn: _Func, memo: Dict[int, Set[str]],
             stack: Set[int]) -> Set[str]:
    key = id(fn.node)
    if key in memo:
        return memo[key]
    if key in stack:
        return set()
    stack.add(key)
    acquired: Set[str] = set()
    for node in _walk_own(fn.node):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                lock = _resolve_lock(graph, fn, item.context_expr)
                if lock is not None:
                    acquired.add(lock)
        elif isinstance(node, ast.Call):
            acquired.update(_call_acquires(graph, fn, node, memo, stack))
    stack.discard(key)
    memo[key] = acquired
    return acquired


def _call_acquires(graph: LockGraph, fn: _Func, call: ast.Call,
                   memo: Dict[int, Set[str]],
                   stack: Set[int]) -> Set[str]:
    out: Set[str] = set()
    term = _terminal_name(call.func)
    if term == "acquire" and isinstance(call.func, ast.Attribute):
        lock = _resolve_lock(graph, fn, call.func.value)
        if lock is not None:
            out.add(lock)
            return out
    for target in _resolve_callable(graph, fn, call.func):
        out.update(_summary(graph, target, memo, stack))
    seam = _HIGHER_ORDER_SEAMS.get(term or "")
    if seam is not None and seam in graph.locks:
        out.add(seam)
        for arg in _seam_fn_args(call):
            for target in _resolve_callable(graph, fn, arg):
                out.update(_summary(graph, target, memo, stack))
    return out


def _seam_fn_args(call: ast.Call) -> List[ast.AST]:
    args: List[ast.AST] = list(call.args)
    args.extend(kw.value for kw in call.keywords if kw.value is not None)
    return args


# ---------------------------------------------------------------------------
# pass 2: edges


def _build_edges(graph: LockGraph) -> None:
    memo: Dict[int, Set[str]] = {}
    for mod_name in sorted(graph.modules):
        mod = graph.modules[mod_name]
        for fn in sorted(_iter_funcs(mod), key=lambda f: f.node.lineno):
            held: List[str] = []
            for deco in getattr(fn.node, "decorator_list", ()):
                section = _SECTION_DECORATORS.get(_terminal_name(deco) or "")
                if section is not None and section in graph.locks:
                    held.append(section)
            _walk_block(graph, fn, list(fn.node.body), held, memo)


def _record_edge(graph: LockGraph, held: Sequence[str], dst: str,
                 path: str, line: int, via: str) -> None:
    for src in held:
        if src == dst:
            continue  # reentrancy / same-identity instances: dup ok
        graph.edges.setdefault((src, dst), Edge(src, dst, path, line, via))


def _walk_block(graph: LockGraph, fn: _Func, stmts: List[ast.stmt],
                held: List[str], memo: Dict[int, Set[str]]) -> None:
    base_depth = len(held)
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue  # summarized separately; runs elsewhere
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                _scan_exprs(graph, fn, [item.context_expr], held, memo)
                lock = _resolve_lock(graph, fn, item.context_expr)
                if lock is not None:
                    _record_edge(graph, held, lock, fn.module.path,
                                 item.context_expr.lineno, "nested with")
                    held.append(lock)
                    pushed += 1
            _walk_block(graph, fn, list(stmt.body), held, memo)
            del held[len(held) - pushed:]
            continue
        # expressions hanging off this statement (test/iter/value/...)
        exprs = [v for v in ast.iter_child_nodes(stmt)
                 if isinstance(v, ast.expr)]
        acquired = _scan_exprs(graph, fn, exprs, held, memo)
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                _walk_block(graph, fn, list(sub), held, memo)
        for handler in getattr(stmt, "handlers", ()) or ():
            _walk_block(graph, fn, list(handler.body), held, memo)
        # a lexical .acquire() holds for the REST of this block
        held.extend(acquired)
    del held[base_depth:]


def _scan_exprs(graph: LockGraph, fn: _Func, exprs: Sequence[ast.AST],
                held: List[str], memo: Dict[int, Set[str]]) -> List[str]:
    """Record edges for every call inside ``exprs``; returns locks taken
    by lexical ``.acquire()`` calls (to be held for the rest of the
    enclosing block)."""
    acquired: List[str] = []
    stack: List[ast.AST] = list(exprs)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
        if not isinstance(node, ast.Call):
            continue
        term = _terminal_name(node.func)
        if term == "acquire" and isinstance(node.func, ast.Attribute):
            lock = _resolve_lock(graph, fn, node.func.value)
            if lock is not None:
                _record_edge(graph, held, lock, fn.module.path,
                             node.lineno, ".acquire()")
                acquired.append(lock)
            continue
        if term == "wait" and isinstance(node.func, ast.Attribute):
            lock = _resolve_lock(graph, fn, node.func.value)
            if (lock is not None and lock in held
                    and graph.locks[lock].kind == "Condition"):
                # wait releases ONLY the condition: everything else the
                # thread holds — including locks taken AFTER entering
                # the cond block — stays held across the park, so the
                # re-acquire orders every one of them before the cond
                # (the held-after-cond case is the classic hidden
                # inversion against a plain ``with cond:`` elsewhere)
                outer = [h for h in held if h != lock]
                _record_edge(graph, outer, lock, fn.module.path,
                             node.lineno, "Condition.wait reacquire")
                continue
        stk: Set[int] = set()
        dsts: Set[str] = set()
        for target in _resolve_callable(graph, fn, node.func):
            dsts.update(_summary(graph, target, memo, stk))
        via = f"calls {term}()" if term else "call"
        for dst in sorted(dsts):
            _record_edge(graph, held, dst, fn.module.path, node.lineno, via)
        seam = _HIGHER_ORDER_SEAMS.get(term or "")
        if seam is not None and seam in graph.locks:
            _record_edge(graph, held, seam, fn.module.path, node.lineno,
                         f"calls {term}()")
            for arg in _seam_fn_args(node):
                for target in _resolve_callable(graph, fn, arg):
                    for dst in sorted(_summary(graph, target, memo, set())):
                        _record_edge(
                            graph, [seam], dst, fn.module.path, node.lineno,
                            f"runs under {term}()")
                        _record_edge(graph, held, dst, fn.module.path,
                                     node.lineno, f"calls {term}()")
    return acquired


# ---------------------------------------------------------------------------
# cycles


def find_cycles(graph: LockGraph) -> List[Violation]:
    """Tarjan SCC over the derived order; every non-trivial component is
    a potential deadlock and fails ``lock-order-cycle``."""
    adj = graph.adjacency()
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp: List[str] = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                sccs.append(sorted(comp))

    for v in sorted(set(adj) | {d for ds in adj.values() for d in ds}):
        if v not in index:
            strongconnect(v)

    out: List[Violation] = []
    for comp in sccs:
        cycle = _concrete_cycle(adj, comp)
        hops = []
        for a, b in zip(cycle, cycle[1:]):
            edge = graph.edges[(a, b)]
            hops.append(f"{a} -> {b} ({edge.path}:{edge.line}, {edge.via})")
        first = graph.edges[(cycle[0], cycle[1])]
        out.append(Violation(
            CYCLE_RULE, first.path, first.line,
            "lock-order cycle: " + "; ".join(hops)
            + " — two threads entering from different ends deadlock; "
            "break the cycle or restructure so one order holds globally",
        ))
    return out


def _concrete_cycle(adj: Dict[str, Set[str]],
                    comp: List[str]) -> List[str]:
    """One concrete cycle through an SCC, for the violation message."""
    members = set(comp)
    start = comp[0]
    path = [start]
    seen = {start}
    node = start
    while True:
        nxt = sorted(n for n in adj.get(node, ()) if n in members)
        if not nxt:
            return [start, start]
        step = next((n for n in nxt if n == start), None)
        if step is not None:
            path.append(start)
            return path
        step = next((n for n in nxt if n not in seen), nxt[0])
        if step in seen:
            # close on the first repeat
            return path[path.index(step):] + [step]
        path.append(step)
        seen.add(step)
        node = step


# ---------------------------------------------------------------------------
# LOCKORDER.md generation + drift lint


_HEADER = """# Lock order — GENERATED, do not edit

Derived by `koordinator_tpu_torch/analysis/lockgraph.py` over the
port and `chip_smoke.py`; regenerate with
`python -m koordinator_tpu_torch.analysis --write-lockorder`.  The
`lockorder-doc-drift` rule fails lint when this file and the derived
graph disagree in either direction; `lock-order-cycle` fails on any
cycle, and the runtime witness (`KOORD_LOCK_WITNESS=1`,
`koordinator_tpu_torch/obs/lockwitness.py`) raises on any real
interleaving that contradicts an order below.

An edge "A before B" means some code path acquires B while holding A;
the partial order is everything deadlock-freedom requires — two
threads may never close a cycle against it.
"""


def generate_lockorder_md(graph: LockGraph) -> str:
    lines = [_HEADER]
    lines.append("## Inventory\n")
    lines.append("| lock | kind | defined at |")
    lines.append("| --- | --- | --- |")
    for identity in sorted(graph.locks):
        site = graph.locks[identity]
        lines.append(
            f"| `{identity}` | {site.kind} | {site.path}:{site.line} |"
        )
    lines.append("")
    lines.append("## Acquisition order (A before B)\n")
    lines.append("| first | then | witnessed at | via |")
    lines.append("| --- | --- | --- | --- |")
    for key in sorted(graph.edges):
        e = graph.edges[key]
        lines.append(
            f"| `{e.src}` | `{e.dst}` | {e.path}:{e.line} | {e.via} |"
        )
    lines.append("")
    return "\n".join(lines)


def parse_doc_rows(
    md_text: str,
) -> Tuple[Dict[str, Tuple[str, int]], Dict[Tuple[str, str], int]]:
    """``(locks, edges)`` parsed back out of a LOCKORDER.md body:
    ``locks[identity] = (kind, line)``; ``edges[(a, b)] = line``."""
    import re

    lock_re = re.compile(r"^\|\s*`([^`]+)`\s*\|\s*(\w+)\s*\|\s*[^|`]+\|$")
    edge_re = re.compile(r"^\|\s*`([^`]+)`\s*\|\s*`([^`]+)`\s*\|")
    locks: Dict[str, Tuple[str, int]] = {}
    edges: Dict[Tuple[str, str], int] = {}
    for lineno, line in enumerate(md_text.splitlines(), start=1):
        stripped = line.strip()
        m = edge_re.match(stripped)
        if m:
            edges[(m.group(1), m.group(2))] = lineno
            continue
        m = lock_re.match(stripped)
        if m and m.group(2) in _LOCK_KINDS:
            locks[m.group(1)] = (m.group(2), lineno)
    return locks, edges


def diff_lockorder_doc(graph: LockGraph, md_text: Optional[str],
                       md_path: str = MD_PATH) -> List[Violation]:
    if md_text is None:
        return [Violation(
            DRIFT_RULE, md_path, 0,
            f"{md_path} not found — the generated lock order is "
            "the contract the runtime witness enforces; run "
            "`python -m koordinator_tpu_torch.analysis --write-lockorder`",
        )]
    doc_locks, doc_edges = parse_doc_rows(md_text)
    out: List[Violation] = []
    for identity in sorted(graph.locks):
        site = graph.locks[identity]
        doc = doc_locks.get(identity)
        if doc is None:
            out.append(Violation(
                DRIFT_RULE, site.path, site.line,
                f"lock {identity!r} is inventoried but missing from the "
                f"{md_path} inventory table — regenerate with "
                "--write-lockorder",
            ))
        elif doc[0] != site.kind:
            out.append(Violation(
                DRIFT_RULE, md_path, doc[1],
                f"lock {identity!r} documented as {doc[0]} but created as "
                f"{site.kind} — regenerate with --write-lockorder",
            ))
    for identity, (_kind, lineno) in sorted(doc_locks.items()):
        if identity not in graph.locks:
            out.append(Violation(
                DRIFT_RULE, md_path, lineno,
                f"doc inventories lock {identity!r} that no creation site "
                "defines — regenerate with --write-lockorder",
            ))
    for key in sorted(graph.edges):
        if key not in doc_edges:
            e = graph.edges[key]
            out.append(Violation(
                DRIFT_RULE, e.path, e.line,
                f"derived order {key[0]} -> {key[1]} is missing from the "
                f"{md_path} order table — regenerate with "
                "--write-lockorder",
            ))
    for key, lineno in sorted(doc_edges.items()):
        if key not in graph.edges:
            out.append(Violation(
                DRIFT_RULE, md_path, lineno,
                f"doc orders {key[0]} -> {key[1]} but no code path "
                "derives that edge — regenerate with --write-lockorder",
            ))
    if not out and md_text != generate_lockorder_md(graph):
        out.append(Violation(
            DRIFT_RULE, md_path, 0,
            "generated content is stale (sites or prose moved even "
            "though the row sets match) — regenerate with "
            "--write-lockorder",
        ))
    return out


# ---------------------------------------------------------------------------
# repo entry points


def collect_sources(root: str) -> Dict[str, str]:
    """``{relpath: source}`` of every file ``run_repo`` scans."""
    sources: Dict[str, str] = {}
    for path in scanned_files(root):
        with open(path, "r", encoding="utf-8") as f:
            sources[os.path.relpath(path, root)] = f.read()
    return sources


def check_sources(sources: Dict[str, str],
                  md_text: Optional[str]) -> List[Violation]:
    """Test seam: cycles + witness-name drift + doc drift over synthetic
    sources."""
    graph = build_graph(sources)
    out = list(graph.violations)
    out.extend(find_cycles(graph))
    out.extend(diff_lockorder_doc(graph, md_text))
    return out


def check_repo(root: str,
               graph: Optional[LockGraph] = None) -> List[Violation]:
    """Cycles, witness-name drift and LOCKORDER.md drift of the tree
    under ``root``; ``graph``: its lock graph, where already built."""
    graph = graph or repo_graph(root)
    out = list(graph.violations)
    out.extend(find_cycles(graph))
    md_path = os.path.join(root, MD_PATH)
    md_text: Optional[str] = None
    if os.path.exists(md_path):
        with open(md_path, "r", encoding="utf-8") as f:
            md_text = f.read()
    out.extend(diff_lockorder_doc(graph, md_text))
    return out


def repo_graph(root: str) -> LockGraph:
    return build_graph(collect_sources(root))


def static_order(root: str) -> Set[Tuple[str, str]]:
    """The derived edge set of the port's tree under ``root``, for the
    runtime witness."""
    return set(repo_graph(root).edges)


def write_lockorder(root: str) -> str:
    """Regenerate the port's LOCKORDER.md in place; returns the path."""
    graph = repo_graph(root)
    path = os.path.join(root, MD_PATH)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(generate_lockorder_md(graph))
    return path
