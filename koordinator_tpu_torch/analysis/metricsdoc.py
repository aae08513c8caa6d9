"""koordlint rule: ``metrics-doc-drift``.

The ``koord_scorer_*`` family table in ``docs/OBSERVABILITY.md`` is the
operator contract — dashboards, alert rules and the SLO-gate runbooks
are written against it, and the port exports the same families as the
reference.  This rule makes the sync STATIC, the wire-contract shape
applied to observability: the families registered in the port's
``obs/scorer_metrics.py`` (the ``_FAMILIES`` table, names resolved
through the module-level constants) are diffed against the markdown
table's rows, in BOTH directions, with the declared kind
(counter/gauge/histogram) cross-checked.

* a family registered but absent from the doc table flags the
  ``_FAMILIES`` entry's line (the metric shipped undocumented — no
  operator will ever alert on it);
* a table row naming a family that is not registered flags the doc
  line (the doc promises a series the daemon never exports — a
  dashboard of NaNs);
* a kind mismatch flags the doc line (a histogram documented as a
  gauge breaks every ``_bucket``/``_count`` query written from it).

All diff functions take source TEXT so tests can seed one-sided
regressions (the wire-contract convention); ``check_repo`` reads the
two real files.  The doc is read only: a family the port alone exports
would need a table of its own beside ``analysis/LOCKORDER.md``.  A
family the reference alone exports is named in ``REFERENCE_ONLY`` with
the reason the port has no such series; its doc row is not a promise
of the port's, and registering it in the port is drift.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.analysis.core import Violation

RULE = "metrics-doc-drift"

PY_PATH = os.path.join("koordinator_tpu_torch", "obs", "scorer_metrics.py")
MD_PATH = os.path.join("docs", "OBSERVABILITY.md")

_PREFIX = "koord_scorer_"

# documented families the reference exports and the port does not
REFERENCE_ONLY = {
    "koord_scorer_jit_cache_miss_total":
        "jit cache misses; the port compiles no program at run time, and "
        "its kernel builds are the koord_scorer_devprof_* families'",
}
_KINDS = ("counter", "gauge", "histogram")

# one markdown table row: | `koord_scorer_x` | kind | ... (the family
# reference table in docs/OBSERVABILITY.md)
_MD_ROW_RE = re.compile(
    r"^\|\s*`(" + _PREFIX + r"\w+)`\s*\|\s*(\w+)\s*\|"
)


def parse_registered_families(
    py_text: str,
) -> List[Tuple[str, str, int]]:
    """``(family_name, kind, line)`` for every ``_FAMILIES`` entry in
    obs/scorer_metrics.py source text.  Entry names may be module-level
    string constants (the convention) or inline string literals."""
    tree = ast.parse(py_text)
    consts: Dict[str, str] = {}
    families_node: Optional[ast.AST] = None
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        if isinstance(node.value, ast.Constant) and isinstance(
            node.value.value, str
        ):
            consts[target.id] = node.value.value
        elif target.id == "_FAMILIES":
            families_node = node.value
    out: List[Tuple[str, str, int]] = []
    if not isinstance(families_node, (ast.Tuple, ast.List)):
        return out
    for entry in families_node.elts:
        if not isinstance(entry, (ast.Tuple, ast.List)) or len(entry.elts) < 2:
            continue
        name_node, kind_node = entry.elts[0], entry.elts[1]
        if isinstance(name_node, ast.Name):
            name = consts.get(name_node.id)
        elif isinstance(name_node, ast.Constant) and isinstance(
            name_node.value, str
        ):
            name = name_node.value
        else:
            name = None
        kind = (
            kind_node.value
            if isinstance(kind_node, ast.Constant)
            and isinstance(kind_node.value, str)
            else None
        )
        if name and kind:
            out.append((name, kind, entry.lineno))
    return out


def parse_documented_families(md_text: str) -> List[Tuple[str, str, int]]:
    """``(family_name, kind, line)`` for every ``koord_scorer_*`` row of
    the markdown family table."""
    out: List[Tuple[str, str, int]] = []
    for lineno, line in enumerate(md_text.splitlines(), start=1):
        m = _MD_ROW_RE.match(line.strip())
        if m:
            out.append((m.group(1), m.group(2), lineno))
    return out


def diff_metrics_doc(
    py_text: str,
    md_text: str,
    py_path: str = PY_PATH,
    md_path: str = MD_PATH,
) -> List[Violation]:
    registered = parse_registered_families(py_text)
    documented = parse_documented_families(md_text)
    if not registered:
        return [Violation(
            RULE, py_path, 0,
            "no _FAMILIES entries parsed from the scorer metrics module "
            "— the registration table moved; update metricsdoc.py's "
            "parser with it",
        )]
    if not documented:
        return [Violation(
            RULE, md_path, 0,
            "no koord_scorer_* rows parsed from the family table — the "
            "doc table moved or was deleted; the operator contract must "
            "stay diffable",
        )]
    out: List[Violation] = []
    doc_by_name = {name: (kind, line) for name, kind, line in documented}
    reg_by_name = {name: (kind, line) for name, kind, line in registered}
    for name, kind, line in registered:
        doc = doc_by_name.get(name)
        if name in REFERENCE_ONLY:
            out.append(Violation(
                RULE, py_path, line,
                f"family {name!r} is registered, but REFERENCE_ONLY says "
                f"the port exports no such series: {REFERENCE_ONLY[name]}",
            ))
        elif doc is None:
            out.append(Violation(
                RULE, py_path, line,
                f"family {name!r} ({kind}) is registered but missing "
                f"from the {md_path} family table — an undocumented "
                "metric is invisible to every dashboard and alert rule",
            ))
        elif doc[0] != kind:
            out.append(Violation(
                RULE, md_path, doc[1],
                f"family {name!r} documented as {doc[0]!r} but "
                f"registered as {kind!r} — _bucket/_count queries "
                "written from the doc would break",
            ))
    for name, kind, line in documented:
        if kind not in _KINDS:
            out.append(Violation(
                RULE, md_path, line,
                f"family {name!r} documents unknown kind {kind!r} "
                f"(expected one of {', '.join(_KINDS)})",
            ))
        if name not in reg_by_name and name not in REFERENCE_ONLY:
            out.append(Violation(
                RULE, md_path, line,
                f"family {name!r} is documented but never registered in "
                f"{py_path} — the doc promises a series the daemon does "
                "not export",
            ))
    return out


def check_repo(root: str) -> List[Violation]:
    def read(rel: str) -> Optional[str]:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return f.read()

    py_text = read(PY_PATH)
    if py_text is None:
        return [Violation(RULE, PY_PATH, 0, "scorer_metrics.py not found")]
    md_text = read(MD_PATH)
    if md_text is None:
        return [Violation(
            RULE, MD_PATH, 0,
            "docs/OBSERVABILITY.md not found — the family table is the "
            "operator contract the registered metrics diff against",
        )]
    return diff_metrics_doc(py_text, md_text)
