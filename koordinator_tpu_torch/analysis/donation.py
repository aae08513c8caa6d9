"""Rule ``donation-safety``: no stale alias of a tensor written in place.

Counterpart of ``koordinator_tpu/analysis/donation.py``; the rule id is
the reference's.  The reference donates the pre-delta resident buffer to
its scatter, so a later read of the donated name touches freed memory.
The port has no donation: its writers update the resident tensor IN
PLACE, and the caller's reference is the updated tensor
(``solver/resident.py apply_flat_delta``; ``solver/incremental.py
rescore_dirty`` on its ``scores``).  Reading the written name afterwards
is the intended use.  What goes wrong instead is an ALIAS: a name bound
before the call to the tensor itself, a view, a slice or a reshape of it
(``old = buf``, ``row = buf[i]``, ``flat = buf.view(-1)``) still reads as
the pre-delta value in the code after the call, yet sees the post-delta
bits.  The rule flags two things:

1. **A stale alias.**  In one function scope, a read of such an alias
   strictly after a call that writes the aliased tensor in place, unless
   the alias was re-bound first (on the call line counts, the
   ``x = f(x)`` idiom).  ``.clone()``/``.copy()``/``.detach().clone()``
   are copies, not aliases.  An augmented assignment of the alias
   (``old += 1``) reads it.  The writers are the known cross-module ones
   below, by name, and every module-local function that writes into one
   of its own parameters (``p[...] = v``, ``p.copy_(...)``, any in-place
   ``*_`` method) — a module-local def of a known writer's name declares
   its own contract.
2. **An undrained writer.**  A known writer called under ``bridge/``
   outside the class that defines ``ResidentState.commit_donates`` and
   from a scope that never calls ``commit_donates``: in-flight launches
   may still hold the tensor it writes, and the commit rule (ROADMAP
   Queue C, "The resident state's commit rule") is what drains them.
   The state class's own methods are exempt: ``commit_donates`` decides
   for exactly their writes, and ``commit_sync`` is documented to run
   drained per its verdict.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional

from koordinator_tpu_torch.analysis import jitscope
from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "donation-safety"


@dataclasses.dataclass(frozen=True)
class _Writer:
    """A function that writes some of its arguments in place, by
    (positional parameter order, written parameter names)."""

    positional: tuple
    written: frozenset


# the port's in-place writers whose definitions live in ANOTHER module
# than their call sites, by callable name
_KNOWN_WRITERS = {
    # solver/resident.py: scatters the delta into the resident tensor
    "apply_flat_delta": _Writer(("arr", "idx", "val", "mesh"), frozenset({"arr"})),
    # solver/incremental.py: scatters the dirty rows and columns into the
    # resident scores; feasible is cloned, never written
    "rescore_dirty": _Writer(
        ("snapshot", "scores", "feasible", "node_rows", "pod_rows", "cfg", "mesh"),
        frozenset({"scores"})),
}

# calls that return a view or the tensor itself
_ALIAS_METHODS = ("view", "view_as", "reshape", "flatten", "ravel", "narrow",
                  "select", "expand", "expand_as", "squeeze", "unsqueeze",
                  "transpose", "permute", "t", "unflatten", "as_strided",
                  "diagonal", "unbind", "split", "chunk", "detach", "contiguous")
_ALIAS_ATTRS = ("T", "mT", "data")


def _root_alias(value: ast.AST) -> Optional[str]:
    """The name ``value`` aliases (the tensor, a view, slice or reshape of
    it), else None."""
    while True:
        if isinstance(value, ast.Name):
            return value.id
        if isinstance(value, ast.Subscript):
            value = value.value
        elif isinstance(value, ast.Attribute) and value.attr in _ALIAS_ATTRS:
            value = value.value
        elif (isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute)
              and value.func.attr in _ALIAS_METHODS):
            value = value.func.value
        else:
            return None


def _local_writers(nodes, called: set) -> Dict[str, _Writer]:
    """Module-local functions, among those ``called`` by name, that write
    into one of their parameters."""
    out: Dict[str, _Writer] = {}
    for node in nodes:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) or \
                node.name not in called:
            continue
        a = node.args
        pos = tuple(p.arg for p in a.posonlyargs + a.args)
        names = set(pos) | {p.arg for p in a.kwonlyargs}
        written = set()
        for sub in jitscope.scope_walk(node, into_closures=True):
            targets = []
            if isinstance(sub, (ast.Assign, ast.AugAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                targets = [t for t in targets if isinstance(t, ast.Subscript)]
                roots = [_root_alias(t) for t in targets]
            elif (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                  and sub.func.attr.endswith("_") and not sub.func.attr.startswith("_")):
                roots = [_root_alias(sub.func.value)]
            else:
                continue
            written |= {r for r in roots if r in names}
        out[node.name] = _Writer(pos, frozenset(written))
    return out


def _written_args(call: ast.Call, writer: _Writer) -> List[str]:
    out = []
    for i, p in enumerate(writer.positional):
        if p in writer.written and i < len(call.args) and isinstance(call.args[i], ast.Name):
            out.append(call.args[i].id)
    for kw in call.keywords:
        if kw.arg in writer.written and isinstance(kw.value, ast.Name):
            out.append(kw.value.id)
    return out


def _stale_aliases(source: SourceFile, writers: Dict[str, _Writer]) -> List[Violation]:
    out: List[Violation] = []
    funcs = jitscope.enclosing_functions(source.tree)
    scopes = {}
    for node in source.nodes:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
                node.func.id in writers:
            scope = funcs.get(id(node), source.tree)
            scopes[id(scope)] = scope
    for scope in scopes.values():
        loads: List[ast.Name] = []
        stores: List[ast.Name] = []
        calls: List[ast.Call] = []
        aliases: List[tuple] = []  # (alias name, aliased name, line)
        aug_target_ids = set()
        for node in jitscope.scope_walk(scope):
            if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
                aug_target_ids.add(id(node.target))
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                    node.targets[0], ast.Name):
                root = _root_alias(node.value)
                if root is not None and root != node.targets[0].id:
                    aliases.append((node.targets[0].id, root, node.lineno))
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load) or id(node) in aug_target_ids:
                    loads.append(node)
                else:
                    stores.append(node)
            elif isinstance(node, ast.Call):
                calls.append(node)
        for call in calls:
            if not isinstance(call.func, ast.Name):
                continue
            writer = writers.get(call.func.id)
            if writer is None or not writer.written:
                continue
            end = call.end_lineno or call.lineno
            end_col = call.end_col_offset or 0
            own = {id(n) for n in ast.walk(call)}
            for written in _written_args(call, writer):
                for alias, root, bound_at in aliases:
                    if root != written or bound_at > call.lineno:
                        continue
                    rebinds = [s.lineno for s in stores
                               if s.id == alias and s.lineno >= call.lineno]
                    horizon = min(rebinds) if rebinds else None
                    for load in loads:
                        if load.id != alias or id(load) in own:
                            continue
                        after = load.lineno > end or (
                            load.lineno == end and load.col_offset > end_col)
                        if not after or (horizon is not None and load.lineno >= horizon):
                            continue
                        out.append(Violation(
                            rule=RULE, path=source.path, line=load.lineno,
                            message=f"'{alias}' aliases '{written}' (bound on line "
                            f"{bound_at}), which {call.func.id}() on line "
                            f"{call.lineno} writes in place: it now holds the "
                            "post-write values, not the ones it was bound to "
                            "(clone before the call, or re-bind after it)",
                        ))
    return out


def _undrained(source: SourceFile) -> List[Violation]:
    if "bridge" not in source.path.replace("\\", "/").split("/"):
        return []
    out: List[Violation] = []

    def visit(node: ast.AST, owner: bool, drained: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, any(
                    isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and b.name == "commit_donates" for b in child.body), False)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                decides = any(
                    isinstance(c, ast.Call)
                    and jitscope.attr_chain(c.func)[-1:] == ("commit_donates",)
                    for c in ast.walk(child))
                visit(child, owner, drained or decides)
            else:
                if (isinstance(child, ast.Call) and isinstance(child.func, ast.Name)
                        and child.func.id in _KNOWN_WRITERS and not owner and not drained):
                    out.append(Violation(
                        rule=RULE, path=source.path, line=child.lineno,
                        message=f"{child.func.id}() writes a resident tensor in "
                        "place from a scope that never decided the drain through "
                        "ResidentState.commit_donates: in-flight launches may "
                        "still hold that tensor (ROADMAP Queue C, \"The resident "
                        "state's commit rule\")",
                    ))
                visit(child, owner, drained)

    visit(source.tree, False, False)
    return out


def check(source: SourceFile) -> List[Violation]:
    # the known writers apply everywhere EXCEPT where the module defines
    # the name itself: a local def's own writes are the truth there
    writers = dict(_KNOWN_WRITERS)
    called = {n.func.id for n in source.nodes
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    local = _local_writers(source.nodes, called)
    for name in local:
        writers.pop(name, None)
    writers.update({k: v for k, v in local.items() if v.written})
    return _stale_aliases(source, writers) + _undrained(source)
