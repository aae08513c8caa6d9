"""koordlint rule: ``prewarm-drift``.

Counterpart of ``koordinator_tpu/analysis/prewarmdrift.py``; the rule id
is the reference's.  The port's prewarm (``obs/prewarm.py``) rebuilds the
kernel variants a daemon recorded, and its two tables map every launch
ledger boundary to a verdict: ``PREWARM_BOUNDARIES`` launch a hand kernel
whose ``nvcc`` build the runner replays, ``PREWARM_EXCLUDED`` run plain
PyTorch on the device and build nothing.  A ``@devprof.boundary``
registration that neither table names is a boundary whose builds nobody
decided about: if it launches a kernel, every boot pays that build cold.
This rule makes the coverage static, diffing every registration in the
port against the two tables, in BOTH directions:

* a registered boundary absent from both tables flags the registration
  line (decide: replayable, or excluded with a reason);
* a boundary listed in BOTH tables flags the prewarm.py entry (the
  tables partition the boundary space — one name, one verdict);
* a table entry naming a boundary no ``@devprof.boundary`` registers
  flags the prewarm.py entry (a renamed or deleted boundary left a
  stale row behind).

All diff functions take source TEXT so tests can seed one-sided
regressions; ``check_repo`` walks the port's tree.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from koordinator_tpu_torch.analysis.core import PACKAGE, Violation, iter_python_files
from koordinator_tpu_torch.analysis.jitscope import boundary_name

RULE = "prewarm-drift"

PREWARM_PATH = os.path.join(PACKAGE, "obs", "prewarm.py")


def parse_boundary_registrations(
    py_text: str,
) -> List[Tuple[str, int]]:
    """``(boundary_name, line)`` for every ``@devprof.boundary``
    decorator with a string-literal name in one file's source text.
    (AST-based, so a decorator spelled inside a docstring example does
    not count — only real registrations do.)"""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(ast.parse(py_text)):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for deco in node.decorator_list:
            name = boundary_name(deco)
            if name is not None:
                out.append((name, node.lineno))
    return out


def parse_prewarm_tables(
    prewarm_text: str,
) -> Tuple[Dict[str, int], Dict[str, int]]:
    """``(replayable, excluded)`` name->line maps parsed from
    obs/prewarm.py source text: the ``PREWARM_BOUNDARIES`` tuple and
    the keys of the ``PREWARM_EXCLUDED`` dict."""
    replayable: Dict[str, int] = {}
    excluded: Dict[str, int] = {}
    tree = ast.parse(prewarm_text)
    for node in tree.body:
        targets = (
            node.targets
            if isinstance(node, ast.Assign)
            else [node.target] if isinstance(node, ast.AnnAssign) else []
        )
        names = {t.id for t in targets if isinstance(t, ast.Name)}
        value = getattr(node, "value", None)
        if "PREWARM_BOUNDARIES" in names and isinstance(
            value, (ast.Tuple, ast.List)
        ):
            for elt in value.elts:
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    replayable[elt.value] = elt.lineno
        elif "PREWARM_EXCLUDED" in names and isinstance(value, ast.Dict):
            for key in value.keys:
                if isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    excluded[key.value] = key.lineno
    return replayable, excluded


def diff_prewarm(
    registrations: List[Tuple[str, str, int]],
    prewarm_text: str,
    prewarm_path: str = PREWARM_PATH,
) -> List[Violation]:
    """Diff ``(name, path, line)`` boundary registrations against the
    prewarm tables, both directions."""
    replayable, excluded = parse_prewarm_tables(prewarm_text)
    if not replayable and not excluded:
        return [Violation(
            RULE, prewarm_path, 0,
            "no PREWARM_BOUNDARIES / PREWARM_EXCLUDED entries parsed "
            "from the prewarm module — the tables moved; update "
            "prewarmdrift.py's parser with them",
        )]
    out: List[Violation] = []
    registered = {name for name, _, _ in registrations}
    for name, path, line in sorted(registrations):
        in_replay = name in replayable
        in_excluded = name in excluded
        if not in_replay and not in_excluded:
            out.append(Violation(
                RULE, path, line,
                f"boundary {name!r} is registered with the launch "
                f"ledger but absent from both prewarm tables in "
                f"{prewarm_path} — if it launches a kernel, every boot "
                "pays that build cold.  "
                "Add it to PREWARM_BOUNDARIES, or to PREWARM_EXCLUDED "
                "with the reason it cannot replay",
            ))
        elif in_replay and in_excluded:
            out.append(Violation(
                RULE, prewarm_path, replayable[name],
                f"boundary {name!r} appears in BOTH PREWARM_BOUNDARIES "
                "and PREWARM_EXCLUDED — the tables partition the "
                "boundary space; keep exactly one verdict",
            ))
    for name, line in sorted(replayable.items()):
        if name not in registered:
            out.append(Violation(
                RULE, prewarm_path, line,
                f"PREWARM_BOUNDARIES lists {name!r} but no "
                "@devprof.boundary registration mints that name — a "
                "renamed or deleted boundary left a stale replay row; "
                "remove it or fix the name",
            ))
    for name, line in sorted(excluded.items()):
        if name not in registered:
            out.append(Violation(
                RULE, prewarm_path, line,
                f"PREWARM_EXCLUDED lists {name!r} but no "
                "@devprof.boundary registration mints that name — a "
                "renamed or deleted boundary left a stale exclusion; "
                "remove it or fix the name",
            ))
    return out


def repo_registrations(root: str) -> List[Tuple[str, str, int]]:
    """``(name, path, line)`` of every boundary registration in the port."""
    registrations: List[Tuple[str, str, int]] = []
    for path in iter_python_files(os.path.join(root, PACKAGE)):
        rel = os.path.relpath(path, root)
        try:
            with open(path, "r", encoding="utf-8") as f:
                pairs = parse_boundary_registrations(f.read())
        except (OSError, SyntaxError):
            continue
        registrations.extend((name, rel, line) for name, line in pairs)
    return registrations


def check_repo(root: str) -> List[Violation]:
    prewarm_abs = os.path.join(root, PREWARM_PATH)
    if not os.path.exists(prewarm_abs):
        return [Violation(
            RULE, PREWARM_PATH, 0,
            "obs/prewarm.py not found — the prewarm tables are the "
            "contract the boundary registrations diff against",
        )]
    with open(prewarm_abs, "r", encoding="utf-8") as f:
        prewarm_text = f.read()
    return diff_prewarm(repo_registrations(root), prewarm_text)
