"""Recognise the port's device programs and the build keys of their kernels.

Counterpart of ``koordinator_tpu/analysis/jitscope.py``.  The reference's
device program is a jitted function, and its retrace key is the jit's
static and donated arguments.  The port compiles nothing at run time: its
device programs are

* a function registered with the launch ledger,
  ``@devprof.boundary("<name>")`` (``obs/devprof.py``): its body runs
  eagerly on every call and enqueues device work on the caller's stream;
* a function that launches a hand-written kernel: it takes the C entry
  point with ``_build.entry(source, name, argtypes, defines)``
  (``_build.py``) and calls it with a CUDA stream
  (``torch.cuda.current_stream(...).cuda_stream``), the port's launch
  convention.  A function that takes an entry and passes no stream calls a
  host-only query (the ``koord_*_plan`` occupancy entries), which launches
  nothing.

A kernel's build key is ``(source, defines)``: each distinct ``defines``
is one more ``nvcc`` build and one more library in the process, the port's
form of a retrace.  ``defines_arg`` finds that argument on
``_build.entry``/``_build.build`` calls and on any call that passes
``defines=``.

Flow-insensitive and module-local by design, like the reference: a device
program imported from another module is seen in its own module.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

# the ``_build`` entry points that key a kernel variant, and the index of
# their positional ``defines`` argument
_BUILD_CALLS = {"entry": 3, "build": 1}


def attr_chain(node: ast.AST) -> tuple:
    """All names along an attribute chain: ``self.telemetry.spans.note``
    -> ("self", "telemetry", "spans", "note")."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def boundary_call(deco: ast.AST) -> Optional[ast.Call]:
    """``@devprof.boundary(...)`` (or a bare ``@boundary(...)`` from a
    ``from ... import boundary``), else None."""
    if not isinstance(deco, ast.Call):
        return None
    f = deco.func
    if isinstance(f, ast.Attribute) and f.attr == "boundary":
        return deco
    if isinstance(f, ast.Name) and f.id == "boundary":
        return deco
    return None


def boundary_name(deco: ast.AST) -> Optional[str]:
    """The string-literal name of a boundary decorator, else None."""
    call = boundary_call(deco)
    if call is None or not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


def is_boundary_def(node: ast.AST) -> bool:
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
        boundary_call(d) is not None for d in node.decorator_list
    )


def build_call(node: ast.AST) -> Optional[str]:
    """``"entry"``/``"build"`` for a ``_build.entry(...)``/``_build.build(...)``
    call (or the bare names inside ``_build.py``), else None."""
    if not isinstance(node, ast.Call):
        return None
    chain = attr_chain(node.func)
    if len(chain) == 2 and chain[0] == "_build" and chain[1] in _BUILD_CALLS:
        return chain[1]
    if len(chain) == 1 and chain[0] in _BUILD_CALLS and chain[0] == "entry":
        return chain[0]
    return None


def defines_arg(call: ast.Call) -> Optional[ast.AST]:
    """The ``defines`` argument of a build-keying call: the positional slot
    of ``_build.entry``/``_build.build``, or a ``defines=`` keyword on any
    call (a launch wrapper forwarding its variant).  None when absent or
    passed through ``*args``."""
    for kw in call.keywords:
        if kw.arg == "defines":
            return kw.value
    kind = build_call(call)
    if kind is None:
        return None
    pos = _BUILD_CALLS[kind]
    if any(isinstance(a, ast.Starred) for a in call.args[: pos + 1]):
        return None
    if len(call.args) > pos:
        return call.args[pos]
    return None


def _mentions_stream(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in ("cuda_stream", "current_stream"):
            return True
    return False


def launches_kernel(func: ast.AST) -> bool:
    """True when ``func`` takes a kernel entry (``_build.entry``) and hands
    a CUDA stream to a call: the port's launch convention.  An entry
    called with no stream is a host-only query."""
    takes_entry = False
    streams = False
    for node in scope_walk(func, into_closures=True):
        if build_call(node) == "entry":
            takes_entry = True
        elif isinstance(node, ast.Call) and any(
            _mentions_stream(a) for a in list(node.args) + [k.value for k in node.keywords]
        ):
            streams = True
        elif isinstance(node, ast.Assign) and _mentions_stream(node.value):
            streams = True
    return takes_entry and streams


def scope_walk(scope: ast.AST, into_closures: bool = False) -> Iterator[ast.AST]:
    """Walk a function/module scope without descending into nested
    function DEFINITIONS — nested defs are their own scopes, and nested
    device programs get their own pass, so walking into them
    double-reports and mis-attributes violations.

    ``into_closures=True`` descends into nested defs that are not
    registered boundaries: a closure inside a device program (a rung's
    thunk, a readback helper) runs as part of its launch, so the rules
    that read a device program's body must see it; only nested
    registered boundaries stay excluded."""
    stack = list(scope.body) if hasattr(scope, "body") else []
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if into_closures and not is_boundary_def(node):
                stack.extend(node.body)
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def device_programs(tree: ast.AST, nodes=None) -> List[ast.FunctionDef]:
    """Every device program DEFINITION in a module, outermost first.  A
    def nested in a device program that is itself a kernel launcher but not
    a boundary is part of its parent's scope (``scope_walk``), not listed
    again."""
    out: List[ast.FunctionDef] = []
    entries = any(build_call(n) == "entry" for n in (nodes or ast.walk(tree)))

    def visit(node: ast.AST, inside: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                program = is_boundary_def(child) or (
                    entries and not inside and launches_kernel(child))
                if program:
                    out.append(child)
                visit(child, inside or program)
            else:
                visit(child, inside)

    visit(tree, False)
    return out


def module_constants(tree: ast.AST) -> set:
    """Module-level names bound once to a literal or to another constant
    (``PHASE_CLOCK = ("KOORD_PHASE_CLOCK",)``): a build key made from them
    is the same on every call."""
    out: set = set()
    counts: dict = {}
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                counts[t.id] = counts.get(t.id, 0) + 1
    for node in tree.body:
        value = getattr(node, "value", None)
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            if isinstance(t, ast.Name) and counts[t.id] == 1 and value is not None \
                    and is_constant_expr(value, out):
                out.add(t.id)
    return out


def is_constant_expr(node: ast.AST, constants: set) -> bool:
    """A literal, a tuple/list of them, a module constant, an upper-case
    attribute of a module (``_build.PHASE_CLOCK``), or a ``+`` of these."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(is_constant_expr(e, constants) for e in node.elts)
    if isinstance(node, ast.Name):
        return node.id in constants
    if isinstance(node, ast.Attribute):
        return node.attr.isupper() and isinstance(node.value, ast.Name)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return is_constant_expr(node.left, constants) and is_constant_expr(
            node.right, constants)
    return False


def enclosing_functions(tree: ast.AST) -> dict:
    """id(node) -> the innermost function definition holding it (absent at
    module level), from one walk of the module."""
    out: dict = {}

    def visit(node: ast.AST, func) -> None:
        for child in ast.iter_child_nodes(node):
            if func is not None:
                out[id(child)] = func
            visit(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)

    visit(tree, None)
    return out


def params(func: ast.AST) -> List[str]:
    a = func.args
    out = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        out.append(a.vararg.arg)
    if a.kwarg:
        out.append(a.kwarg.arg)
    return out
