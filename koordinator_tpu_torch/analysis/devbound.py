"""Rule ``unregistered-jit-boundary``: every kernel launch on the serving
path registers with the launch ledger (``obs/devprof.py``).

Counterpart of ``koordinator_tpu/analysis/devbound.py``; the rule id is
the reference's.  In the port a "jit boundary" is a function that
launches a hand-written kernel: it takes the C entry point with
``_build.entry(...)`` and calls it with a CUDA stream
(``analysis/jitscope.py launches_kernel``).  A launch the ledger does not
see escapes its build records, its sampled device time, the /metrics
families and the /healthz ``device`` block.  Lexically and
module-locally, as in the reference, under ``solver/``, ``bridge/`` and
``parallel/``:

1. every def that launches a kernel carries ``@devprof.boundary("<name>")``;
2. the boundary decorator is the OUTERMOST one (first in the list):
   decorators apply bottom-up, so a wrapper above the boundary would run
   outside the ledger's timing and build attribution;
3. the boundary name is a string literal (the ledger keys, the prewarm
   tables and ``prewarm-drift`` all key on a static name);
4. a module-level ``name = _build.entry(...)`` launch handle is flagged
   outright, as the reference flags the ``jax.jit(fn)`` call form: the
   handle cannot carry the decorator (and builds at import);
5. a per-shard launch (``local_map``/``shard_map``) outside any device
   program is its own unattributed launch.  The port's sites are
   ``parallel/mesh.py shard_map``'s callers (``parallel/shard_assign.py``,
   the sharded scatter, rescore, score and candidate builds): each calls it
   inside its own registered boundary.

**Host-only entries are classified, not flagged.**  A def that takes an
entry with ``_build.entry`` but hands no CUDA stream to any call queries
the host (the ``koord_*_plan`` occupancy entries of ``solver/wide.py``
and ``solver/dense.py``): it enqueues nothing on a stream, so it has no
device time to attribute.  Every launch entry of the port takes the
caller's stream as its last argument, which is what makes the split
visible to the AST.

Modules outside the serving path (harness, obs, tests) are out of scope.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from koordinator_tpu_torch.analysis import jitscope
from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "unregistered-jit-boundary"

# directory parts that mark a module as serving-path
_SCOPE_PARTS = {"solver", "parallel", "bridge"}

# the per-shard launchers: torch's DTensor ``local_map`` and the
# reference's spellings
_SHARD_NAMES = {"local_map", "shard_map", "shard_map_compat", "_shard_map"}


def _in_scope(path: str) -> bool:
    parts = set(path.replace("\\", "/").split("/"))
    return bool(parts & _SCOPE_PARTS)


def _check_def(path: str, node: ast.FunctionDef) -> List[Violation]:
    calls = [(i, jitscope.boundary_call(d)) for i, d in enumerate(node.decorator_list)]
    calls = [(i, c) for i, c in calls if c is not None]
    if not calls:
        return [Violation(
            rule=RULE, path=path, line=node.lineno,
            message=f"{node.name}() launches a kernel (an _build.entry called "
            "with a CUDA stream) with no @devprof.boundary(...) registration: "
            "its builds and device time escape the launch ledger.  Register "
            "it, or suppress with a reason if it never runs on the "
            "Score/Assign path",
        )]
    out: List[Violation] = []
    at, call = calls[0]
    if at != 0:
        out.append(Violation(
            rule=RULE, path=path, line=node.lineno,
            message=f"{node.name}(): @devprof.boundary is not the outermost "
            "decorator — the decorators above it run outside the ledger's "
            "timing and build attribution.  Move the boundary to the top",
        ))
    if jitscope.boundary_name(call) is None:
        out.append(Violation(
            rule=RULE, path=path, line=node.lineno,
            message=f"{node.name}(): devprof.boundary name must be a string "
            "literal — the ledger, the prewarm tables and this lint all key "
            "on a static boundary name",
        ))
    return out


def _shard_calls(nodes) -> List[ast.Call]:
    out = []
    for n in nodes:
        if isinstance(n, ast.Call):
            chain = jitscope.attr_chain(n.func)
            if chain and chain[-1] in _SHARD_NAMES:
                out.append(n)
    return out


def check(source: SourceFile) -> List[Violation]:
    if not _in_scope(source.path):
        return []
    out: List[Violation] = []
    registered = []
    entries = any(jitscope.build_call(n) == "entry" for n in source.nodes)
    for node in source.nodes:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if jitscope.is_boundary_def(node):
            registered.append(node)
            out.extend(_check_def(source.path, node))
        elif entries and jitscope.launches_kernel(node):
            out.extend(_check_def(source.path, node))
    for node in source.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                jitscope.build_call(node.value) == "entry":
            out.append(Violation(
                rule=RULE, path=source.path, line=node.lineno,
                message="module-level _build.entry(...) launch handle: it "
                "cannot carry a @devprof.boundary registration (and builds "
                "the kernel at import) — take the entry inside a decorated "
                "launch function, or suppress with a reason",
            ))
    inside: Set[Tuple[int, int]] = set()
    for node in registered:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                inside.add((sub.lineno, sub.col_offset))
    for call in _shard_calls(source.nodes):
        if (call.lineno, call.col_offset) in inside:
            continue
        out.append(Violation(
            rule=RULE, path=source.path, line=call.lineno,
            message="per-shard launch (local_map/shard_map) outside any "
            "registered device program: its device time has no ledger "
            "attribution.  Wrap it in a @devprof.boundary function, or "
            "suppress with a reason",
        ))
    return out
