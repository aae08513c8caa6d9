"""Shared koordlint infrastructure over the port: violations,
suppressions, the runner.

Suppression syntax (line-scoped, on the offending line or the line just
above it):

    risky_thing()  # koordlint: disable=bare-retry(status poll, not a retry)
    # koordlint: disable=broad-except(reason: probe must never raise)
    except Exception:

Multiple rules separate with commas; an optional parenthesised reason is
encouraged (and required for the rules in ``suppressions.REASON_REQUIRED``).  Tags
never suppress whole files — a blanket-suppressed file would hide new
regressions behind an old annotation.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

PACKAGE = "koordinator_tpu_torch"
SCAN_ROOTS = (PACKAGE,)
EXTRA_FILES = ("chip_smoke.py",)

# '#' for Python, '//' for Go sources (wire-contract tags live in wire.go)
_DISABLE_RE = re.compile(r"(?:#|//)\s*koordlint:\s*disable=(.*)$")
# one rule token: name, optional (reason), flexible whitespace
_RULE_TOKEN_RE = re.compile(r"\s*([a-z0-9\-]+)\s*(\([^)]*\))?\s*")


def _parse_rule_list(tail: str) -> Set[str]:
    """Strict sequential tokenizer: rule[,rule...] with optional
    parenthesised reasons.  Scanning STOPS at the first non-token text,
    so words inside a reason (or trailing prose) can never leak into
    the suppressed-rule set."""
    rules: Set[str] = set()
    i = 0
    while i < len(tail):
        m = _RULE_TOKEN_RE.match(tail, i)
        if not m or not m.group(1):
            break
        rules.add(m.group(1))
        i = m.end()
        if i < len(tail) and tail[i] == ",":
            i += 1
        else:
            break
    return rules


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def parse_suppressions(text: str, lang: str = "python") -> Dict[int, Set[str]]:
    """Map line number -> set of rule names disabled on that line.

    For Python sources the tags are extracted from REAL comment tokens
    (via tokenize), so a string literal or docstring that merely
    mentions ``koordlint: disable=`` — the rule messages themselves do —
    can never register a phantom suppression.  Non-Python sources (Go,
    for wire-contract tags) fall back to a per-line regex."""
    out: Dict[int, Set[str]] = {}

    def record(lineno: int, comment: str) -> None:
        m = _DISABLE_RE.search(comment)
        if m:
            rules = _parse_rule_list(m.group(1))
            if rules:
                out[lineno] = rules

    if lang == "python":
        import io
        import tokenize

        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    record(tok.start[0], tok.string)
            return out
        except (tokenize.TokenError, IndentationError, SyntaxError):
            out.clear()  # unparseable: per-line fallback below
    for lineno, line in enumerate(text.splitlines(), start=1):
        record(lineno, line)
    return out


class SourceFile:
    """One parsed Python file handed to every AST rule."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.suppressions = parse_suppressions(text)
        self._nodes: Optional[List[ast.AST]] = None

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree, walked once for all the rules."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def suppressed(self, rule: str, line: int) -> bool:
        # the offending line, or a dedicated comment line just above it
        for at in (line, line - 1):
            if rule in self.suppressions.get(at, ()):
                return True
        return False


def _filter(source: SourceFile, violations: Iterable[Violation]) -> List[Violation]:
    return [
        v for v in violations if not source.suppressed(v.rule, v.line)
    ]


def run_rules_on_source(
    path: str, text: str, rules: Optional[Sequence[str]] = None,
    honor_suppressions: bool = True,
) -> List[Violation]:
    """Run the AST rules over one file's source text (the unit-test seam:
    seeded-regression fixtures feed synthetic sources through here).
    ``honor_suppressions=False`` returns the RAW findings — the
    suppression audit diffs them against the live tags to spot stale
    annotations."""
    from koordinator_tpu_torch.analysis import (
        bareretry,
        devbound,
        donation,
        excepts,
        guards,
        hostsync,
        lockdispatch,
        retrace,
        spanleak,
        unboundedwait,
    )

    try:
        source = SourceFile(path, text)
    except SyntaxError as exc:
        return [
            Violation(
                rule="parse-error",
                path=path,
                line=exc.lineno or 0,
                message=f"cannot parse: {exc.msg}",
            )
        ]
    out: List[Violation] = []
    table = {
        "donation-safety": donation.check,
        "retrace-hazard": retrace.check,
        "host-sync-in-jit": hostsync.check,
        "broad-except": excepts.check,
        "span-leak": spanleak.check,
        "lock-held-dispatch": lockdispatch.check,
        "bare-retry": bareretry.check,
        "unbounded-wait": unboundedwait.check,
        "unguarded-shared-state": guards.check,
        "unregistered-jit-boundary": devbound.check,
    }
    for rule, fn in table.items():
        if rules is not None and rule not in rules:
            continue
        found = fn(source)
        out.extend(found if not honor_suppressions
                   else _filter(source, found))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def iter_python_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [
            d for d in dirnames
            if d != "__pycache__" and not d.startswith(".")
        ]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def scanned_files(root: str) -> List[str]:
    """Every Python file the pass reads: the port's package, then
    ``chip_smoke.py`` (the port's end-to-end check, where the reference has
    ``bench.py``)."""
    paths: List[str] = []
    for rel in SCAN_ROOTS:
        scan_root = os.path.join(root, rel)
        if os.path.isdir(scan_root):
            paths.extend(iter_python_files(scan_root))
    paths.extend(p for p in (os.path.join(root, rel) for rel in EXTRA_FILES)
                 if os.path.exists(p))
    return paths


def find_repo_root(start: Optional[str] = None) -> str:
    """Nearest ancestor containing the koordinator_tpu_torch package."""
    here = os.path.abspath(start or os.getcwd())
    probe = here
    while True:
        if os.path.isdir(os.path.join(probe, PACKAGE)):
            return probe
        parent = os.path.dirname(probe)
        if parent == probe:
            return here
        probe = parent


def run_repo(
    root: Optional[str] = None,
    rules: Optional[Sequence[str]] = None,
    honor_suppressions: bool = True,
    graph=None,
) -> List[Violation]:
    """The full pass: AST rules over every Python file of the port and
    ``chip_smoke.py``, plus the cross-language wire-contract diff, the
    metrics-vs-doc table diff, the boundaries-vs-prewarm-tables diff and
    the whole-program passes over the lock
    graph (cycles, LOCKORDER.md drift, and lock-held-dispatch through
    calls).  ``graph``: the lock graph of ``root`` where the caller
    already built it (``suppressions.lint_pass``).  Returns sorted
    violations."""
    from koordinator_tpu_torch.analysis import (
        lockdispatch,
        lockgraph,
        metricsdoc,
        prewarmdrift,
        wire_contract,
    )

    root = root or find_repo_root(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    out: List[Violation] = []
    for path in scanned_files(root):
        out.extend(_run_file(path, root, rules, honor_suppressions))
    if rules is None or "wire-contract" in rules:
        out.extend(_filter_file_comments(
            root, wire_contract.check_repo(root), honor_suppressions))
    if rules is None or "metrics-doc-drift" in rules:
        out.extend(_filter_file_comments(
            root, metricsdoc.check_repo(root), honor_suppressions))
    if rules is None or "prewarm-drift" in rules:
        out.extend(_filter_file_comments(
            root, prewarmdrift.check_repo(root), honor_suppressions))
    graph_rules = {lockgraph.CYCLE_RULE, lockgraph.DRIFT_RULE,
                   lockdispatch.RULE}
    if rules is None or graph_rules & set(rules):
        graph = graph or lockgraph.repo_graph(root)
        found = lockgraph.check_repo(root, graph)
        found.extend(lockdispatch.check_graph(graph))
        found = [v for v in found if rules is None or v.rule in rules]
        out.extend(_filter_file_comments(root, found, honor_suppressions))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def _filter_file_comments(
    root: str, violations: Iterable[Violation],
    honor_suppressions: bool = True,
) -> List[Violation]:
    """Line-suppression for the repo-wide rules (wire-contract points at
    Go sources, the lock-graph rules at Python ones): honor
    ``// koordlint: disable=<rule>`` / ``# koordlint: ...`` on the
    flagged line or the line above.  Line-0 violations (message-level
    drift like a never-emitted field, a codec class gone or a stale
    generated doc) are deliberately NOT suppressible — the fix there is
    the wire edit or a regen, and the ``_ALLOWED_UNDECODED`` allowlist
    covers legitimate one-sided reads."""
    if not honor_suppressions:
        return list(violations)
    cache: Dict[str, Dict[int, Set[str]]] = {}
    out: List[Violation] = []
    for v in violations:
        if v.line > 0:
            if v.path not in cache:
                path = os.path.join(root, v.path)
                lang = "python" if v.path.endswith(".py") else "go"
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        cache[v.path] = parse_suppressions(f.read(), lang=lang)
                except OSError:
                    cache[v.path] = {}
            sups = cache[v.path]
            if any(
                v.rule in sups.get(at, ()) for at in (v.line, v.line - 1)
            ):
                continue
        out.append(v)
    return out


def _run_file(path: str, root: str, rules: Optional[Sequence[str]],
              honor_suppressions: bool = True) -> List[Violation]:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    rel = os.path.relpath(path, root)
    return run_rules_on_source(rel, text, rules, honor_suppressions)
