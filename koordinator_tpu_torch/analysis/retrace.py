"""Rule ``retrace-hazard``: what silently mints another kernel variant.

Counterpart of ``koordinator_tpu/analysis/retrace.py``; the rule id is the
reference's.  The port compiles nothing at run time, so its "retrace" is
a new kernel VARIANT: ``_build.build`` keys every ``nvcc`` build and
loaded library by ``(source, defines)`` (``_build.py``), and each
distinct ``defines`` is one more build of seconds on the card and one
more library in the process.  A variant must therefore be chosen from
configuration known at import, never from a call's data.  The shapes,
numbered as the reference's:

1. Control flow on a device value moved to ``host-sync-in-jit``: in
   PyTorch a Python ``if`` on a tensor does not retrace, it syncs.
2. ``defines`` built from a call's data.  The ``defines`` argument of
   ``_build.entry``/``_build.build`` (and any ``defines=`` a launch
   wrapper forwards) must be a literal, a module constant
   (``_build.PHASE_CLOCK``) or the enclosing function's own ``defines``
   parameter passed through unchanged — the call sites of that function
   are then checked in turn.  A ``*args`` splat is not resolved.
3. A name or string payload in a build key or in the kernel ladder's
   demotion bucket key (``solver/__init__.py run_kernel_ladder``'s
   ``shape_key``): an object name or a formatted string there mints one
   variant, or one demotion bucket, per distinct value — the reference's
   name-tuple retrace in the port's idiom.
4. ``wave``, ``top_m``, a mesh, a device count or a shard width (and the
   incremental rescore's dirty counts) interpolated into ``defines``
   rather than passed as a launch argument: one build per distinct width.
   ``solver/wide.py wave_cycle_cuda`` passes ``W`` and ``M`` as arguments
   of the launch entry, the clean form.  A per-shard body
   (``local_map``/``shard_map``) taking a mesh knob as a parameter is
   flagged too: the port's per-shard bodies (``parallel/shard_assign.py``
   and the sharded solver entries) close over the mesh instead.
5. An unfrozen or unhashable ``CycleConfig`` term config: unchanged from
   the reference.  ``CycleConfig`` keys the servicer's Assign memo and
   rides every launch wrapper, so every dataclass reachable from its
   field annotations must be ``frozen=True``, carry no mutable default,
   and pass each mapping-typed field through ``_freeze`` in
   ``__post_init__``.
6. A candidate count or width in ``defines``: the sparse engine pads its
   candidate list to ``C`` with out-of-range sentinels
   (``solver/candidates.py``), so neither ever keys a build.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from koordinator_tpu_torch.analysis import jitscope
from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "retrace-hazard"

_NAMEY = ("name", "names")


def _is_namey(field: str) -> bool:
    return field in _NAMEY or any(
        field.endswith("_" + suffix) for suffix in _NAMEY
    )


# cycle-batching knobs that select loop structure (shape 4)
_WAVE_STATIC_PARAMS = ("wave", "top_m")

# mesh-partitioning knobs: the mesh, the device count and the shard width
# select the partitioned program structure (shape 4)
_MESH_STATIC_PARAMS = (
    "mesh", "device_count", "n_devices", "num_devices",
    "n_shards", "num_shards", "shard_width",
)

# incremental-rescore knobs: dirty counts vary per delta; the rows ride
# bucket-padded index vectors (solver/incremental.py), never a key
_DIRTY_STATIC_PARAMS = (
    "n_dirty", "num_dirty", "dirty_count", "dirty_width",
    "n_dirty_nodes", "n_dirty_pods",
)

# sparse candidate knobs (shape 6): pad the candidate list, don't key
# a build on its count
_CAND_STATIC_PARAMS = (
    "num_candidates", "n_candidates", "candidate_count",
    "candidate_width", "cand_width", "c_width",
)

_KNOB_MESSAGES = (
    (_WAVE_STATIC_PARAMS,
     "the wave width selects the kernel's loop structure, so each distinct "
     "value builds and loads another variant; pass it as a launch argument "
     "(solver/wide.py wave_cycle_cuda passes W and M)"),
    (_MESH_STATIC_PARAMS,
     "the mesh/device-count/shard width selects the partitioned program, so "
     "each distinct value builds another variant; pass it as a launch "
     "argument"),
    (_DIRTY_STATIC_PARAMS,
     "delta sizes vary per Sync, so a dirty count in a build key builds a "
     "variant per distinct value; pad the dirty-index vector to a power-of-two "
     "bucket instead (solver/incremental.py)"),
    (_CAND_STATIC_PARAMS,
     "candidate counts vary with every feasibility change and the width is "
     "configuration: pad the candidate list, don't trace the count "
     "(solver/candidates.py pads to C with out-of-range sentinels)"),
)


def _mentioned(node: ast.AST) -> List[str]:
    """Names and attribute names an expression reads, in source order."""
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.append(sub.attr)
    return out


def _formats_text(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.JoinedStr):
            return True
        if isinstance(sub, ast.Call):
            fn = sub.func
            if (isinstance(fn, ast.Name) and fn.id in ("str", "repr")) or (
                    isinstance(fn, ast.Attribute) and fn.attr in ("format", "join")):
                return True
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod) and isinstance(
                sub.left, ast.Constant) and isinstance(sub.left.value, str):
            return True
    return False


def _bound_values(scope: ast.AST, name: str) -> List[ast.AST]:
    """The values ``name`` is assigned in ``scope`` (its own body)."""
    out = []
    for node in jitscope.scope_walk(scope):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            out.append(node.value)
    return out


def _defines_findings(source: SourceFile, call: ast.Call, expr: ast.AST,
                      scope: ast.AST, func: Optional[ast.AST],
                      constants: Set[str]) -> List[Violation]:
    if func is not None and isinstance(expr, ast.Name) and expr.id in jitscope.params(func):
        return []  # forwarded unchanged: the call sites are checked
    if jitscope.is_constant_expr(expr, constants):
        return []
    values = [expr]
    if isinstance(expr, ast.Name) and func is not None:
        bound = _bound_values(scope, expr.id)
        if bound:
            if all(jitscope.is_constant_expr(v, constants) for v in bound):
                return []
            values = bound
    where = f"the build key of {'.'.join(jitscope.attr_chain(call.func)) or 'a call'}()"
    out = []
    mentioned = [m for v in values for m in _mentioned(v)]
    seen = set()
    for name in mentioned:
        for knobs, why in _KNOB_MESSAGES:
            if name in knobs and name not in seen:
                seen.add(name)
                out.append(Violation(
                    rule=RULE, path=source.path, line=call.lineno,
                    message=f"'{name}' is interpolated into defines, {where}: {why}",
                ))
    if out:
        return out
    if any(_is_namey(m) for m in mentioned):
        return [Violation(
            rule=RULE, path=source.path, line=call.lineno,
            message=f"a name payload in defines, {where}: each distinct name "
            "builds and loads another kernel variant (the name-tuple retrace); "
            "keep names on the host",
        )]
    if any(_formats_text(v) for v in values):
        return [Violation(
            rule=RULE, path=source.path, line=call.lineno,
            message=f"a formatted string payload in defines, {where}: each "
            "distinct value builds another kernel variant; choose the variant "
            "from a module constant",
        )]
    return [Violation(
        rule=RULE, path=source.path, line=call.lineno,
        message=f"defines built from a call's data, {where}: each distinct "
        "value builds and loads another kernel variant; take it from a literal "
        "or a module constant, or forward the caller's own defines parameter",
    )]


def _build_keys(source: SourceFile, funcs: dict) -> List[Violation]:
    """Shapes 2, 3, 4 and 6 on every ``defines`` argument."""
    constants = jitscope.module_constants(source.tree)
    out: List[Violation] = []
    for node in source.nodes:
        if not isinstance(node, ast.Call):
            continue
        expr = jitscope.defines_arg(node)
        if expr is None:
            continue
        func = funcs.get(id(node))
        out.extend(_defines_findings(source, node, expr, func or source.tree, func,
                                     constants))
    return out


def _bucket_keys(source: SourceFile, funcs: dict) -> List[Violation]:
    """Shape 3 on the kernel ladder's demotion bucket key."""
    out: List[Violation] = []
    for node in source.nodes:
        if not (isinstance(node, ast.Call)
                and jitscope.attr_chain(node.func)[-1:] == ("run_kernel_ladder",)):
            continue
        key = next((kw.value for kw in node.keywords if kw.arg == "shape_key"),
                   node.args[1] if len(node.args) > 1 else None)
        values = [key] if key is not None else []
        if isinstance(key, ast.Name):
            values = _bound_values(funcs.get(id(node)) or source.tree, key.id) or values
        for value in values:
            elts = value.elts if isinstance(value, (ast.Tuple, ast.List)) else [value]
            for elt in elts:
                chain = jitscope.attr_chain(elt)
                if (chain and _is_namey(chain[-1])) or _formats_text(elt):
                    out.append(Violation(
                        rule=RULE, path=source.path, line=elt.lineno,
                        message="an object-name or string payload in the "
                        "kernel ladder's demotion bucket key: each distinct "
                        "name mints a bucket of its own, so one oversized "
                        "cycle's demotion never applies to the next (the "
                        "name-tuple retrace); key buckets on shapes",
                    ))
    return out


def _shard_body_knobs(source: SourceFile) -> List[Violation]:
    """Mesh knobs in a per-shard body's parameter list (shape 4): operands
    of ``local_map``/``shard_map`` are per-shard tensors, so a body taking
    ``mesh``/``n_devices``/... as a parameter receives the partitioning
    configuration as data.  Resolution is lexically scoped: the body
    resolves among the defs of the call's own scope first, then the
    module's."""

    def scope_defs_and_calls(scope_body):
        defs, calls = {}, []
        stack = list(scope_body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node
                continue
            if isinstance(node, ast.Call):
                calls.append(node)
            stack.extend(ast.iter_child_nodes(node))
        return defs, calls

    if "local_map" not in source.text and "shard_map" not in source.text:
        return []
    module_defs, _ = scope_defs_and_calls(source.tree.body)
    scopes = [source.tree] + [
        n for n in source.nodes
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    out: List[Violation] = []
    seen = set()
    for scope in scopes:
        defs, calls = scope_defs_and_calls(scope.body)
        for node in calls:
            chain = jitscope.attr_chain(node.func)
            name = chain[-1] if chain else ""
            if not (name.endswith("shard_map") or name in ("shard_map_compat", "local_map")):
                continue
            if not node.args or not isinstance(node.args[0], ast.Name):
                continue
            body = defs.get(node.args[0].id) or module_defs.get(node.args[0].id)
            if body is None or id(body) in seen:
                continue
            seen.add(id(body))
            for pname in jitscope.params(body):
                if pname in _MESH_STATIC_PARAMS:
                    out.append(Violation(
                        rule=RULE, path=source.path, line=body.lineno,
                        message=f"per-shard body {body.name}() takes '{pname}' "
                        "as a parameter: local_map/shard_map operands are "
                        "per-shard tensors, so the mesh/device-count/shard "
                        "width would ride as data; bind it through the "
                        "device_mesh/mesh argument or the closure instead",
                    ))
    return out


# annotation identifiers that mean "this field is a mapping and must be
# frozen to a sorted tuple before it can key a memo or a launch"
_MAPPINGY_TYPES = {"ResMap", "Mapping", "MutableMapping", "Dict", "dict"}


def _annotation_names(ann) -> Set[str]:
    """Identifier names mentioned by a field annotation — handles
    Name/Attribute/Subscript forms and string annotations ("X | None")."""
    import re as _re

    if ann is None:
        return set()
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return set(_re.findall(r"[A-Za-z_][A-Za-z0-9_]*", ann.value))
    names: Set[str] = set()
    for node in ast.walk(ann):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    return names


def _dataclass_frozen(cls: ast.ClassDef):
    """(is_dataclass, frozen) from the decorator list."""
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = target.attr if isinstance(target, ast.Attribute) else (
            target.id if isinstance(target, ast.Name) else ""
        )
        if name != "dataclass":
            continue
        frozen = False
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                    frozen = bool(kw.value.value)
        return True, frozen
    return False, False


def _frozen_fields(cls: ast.ClassDef) -> Set[str]:
    """Field names ``__post_init__`` re-binds through ``_freeze``:
    ``object.__setattr__(self, "field", _freeze(...))``."""
    out: Set[str] = set()
    for node in cls.body:
        if not (
            isinstance(node, ast.FunctionDef)
            and node.name == "__post_init__"
        ):
            continue
        for call in ast.walk(node):
            if not (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "__setattr__"
                and len(call.args) == 3
                and isinstance(call.args[1], ast.Constant)
                and isinstance(call.args[1].value, str)
            ):
                continue
            value = call.args[2]
            if (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "_freeze"
            ):
                out.add(call.args[1].value)
    return out


def _term_config_classes(source: SourceFile):
    """The CycleConfig dataclass plus every module-local dataclass
    reachable from its field annotations (the fused scoring-term configs,
    LoadAwareArgs, ...).  Empty when the file defines no CycleConfig."""
    classes = {
        n.name: n for n in source.nodes
        if isinstance(n, ast.ClassDef)
    }
    if "CycleConfig" not in classes:
        return {}
    reach = {}
    queue = ["CycleConfig"]
    while queue:
        name = queue.pop()
        if name in reach:
            continue
        cls = classes.get(name)
        if cls is None:
            continue
        reach[name] = cls
        for node in cls.body:
            if isinstance(node, ast.AnnAssign):
                for ref in _annotation_names(node.annotation):
                    if ref in classes and ref not in reach:
                        queue.append(ref)
    return reach


def _term_config_fields(source: SourceFile) -> List[Violation]:
    """Rule shape 5: CycleConfig and its term configs are
    configuration keys — unfrozen dataclasses, mutable field
    defaults, and mapping-typed fields that never pass through
    ``_freeze`` in ``__post_init__`` all fail lint."""
    out: List[Violation] = []
    for name, cls in _term_config_classes(source).items():
        is_dc, frozen = _dataclass_frozen(cls)
        if not is_dc:
            continue  # a plain class is not a config dataclass
        if not frozen:
            out.append(Violation(
                rule=RULE, path=source.path, line=cls.lineno,
                message=(
                    f"config dataclass {name} reachable from CycleConfig "
                    "is not frozen=True: CycleConfig keys the Assign memo "
                    "and rides every launch wrapper, so every nested config "
                    "must be immutable and hashable"
                ),
            ))
        freezes = _frozen_fields(cls)
        for node in cls.body:
            if not isinstance(node, ast.AnnAssign) or not isinstance(
                node.target, ast.Name
            ):
                continue
            field = node.target.id
            if isinstance(node.value, (ast.List, ast.Dict, ast.Set,
                                       ast.ListComp, ast.DictComp,
                                       ast.SetComp)):
                out.append(Violation(
                    rule=RULE, path=source.path, line=node.lineno,
                    message=(
                        f"{name}.{field} has a mutable "
                        f"{type(node.value).__name__.lower()} default: "
                        "term-config fields must be hashable (freeze "
                        "mappings to sorted tuples via _freeze)"
                    ),
                ))
            ann_names = _annotation_names(node.annotation)
            if ann_names & _MAPPINGY_TYPES and field not in freezes:
                # a default that is already a _freeze(...) call AND
                # never reassigned is equally safe only if callers
                # cannot pass a raw dict — they can, so the
                # __post_init__ freeze is required regardless
                out.append(Violation(
                    rule=RULE, path=source.path, line=node.lineno,
                    message=(
                        f"{name}.{field} is mapping-typed but "
                        "__post_init__ never passes it through "
                        "_freeze: a caller-supplied dict makes the "
                        "config unhashable as a memo key "
                        "(mappings must go through _freeze)"
                    ),
                ))
    return out


def check(source: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    funcs = jitscope.enclosing_functions(source.tree)
    out.extend(_build_keys(source, funcs))
    out.extend(_bucket_keys(source, funcs))
    out.extend(_shard_body_knobs(source))
    out.extend(_term_config_fields(source))
    return out
