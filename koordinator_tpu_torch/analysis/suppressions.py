"""Suppression audit: every live ``koordlint: disable=``
tag, accountable.

``python -m koordinator_tpu_torch.analysis --suppressions`` lists each tag
with file:line, rule and reason.  Two conditions fail the audit:

* **missing reason** — rules in ``REASON_REQUIRED`` (broad-except and
  unguarded-shared-state suppress *races/eaten errors*, so the
  annotation must say why the hazard is not real; lock-held-dispatch
  marks a readback that stalls every queued launch, so the tag must
  say why this one may; unregistered-jit-boundary, host-sync-in-jit and
  donation-safety mark a launch the ledger misses, a device wait and a
  write in-flight launches may see, so the tag cites the ROADMAP entry
  that accounts for it) carry a parenthesised reason;
* **stale** — the suppressed rule no longer fires on the annotated
  line (the raw, unsuppressed pass finds nothing there): the code
  moved or was fixed, and a tag pinned to nothing will silently
  blanket whatever lands on that line next.  Prune it.

A tag on line N covers violations on N and N+1 (the line-above
convention), so staleness checks both.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from koordinator_tpu_torch.analysis.core import (
    _DISABLE_RE,
    _RULE_TOKEN_RE,
    Violation,
    _filter_file_comments,
    find_repo_root,
    run_repo,
    scanned_files,
)

RULE = "suppression-audit"

# rules whose suppressions MUST carry a reason
REASON_REQUIRED = frozenset((
    "broad-except", "unguarded-shared-state", "lock-held-dispatch",
    "unregistered-jit-boundary", "host-sync-in-jit", "donation-safety",
))


@dataclasses.dataclass(frozen=True)
class Tag:
    path: str
    line: int
    rule: str
    reason: Optional[str]


def parse_tags(path: str, text: str, lang: str = "python") -> List[Tag]:
    """Every ``koordlint: disable=`` tag in one source, WITH reasons
    (core.parse_suppressions discards them)."""
    out: List[Tag] = []

    def record(lineno: int, comment: str) -> None:
        m = _DISABLE_RE.search(comment)
        if not m:
            return
        tail = m.group(1)
        i = 0
        while i < len(tail):
            tok = _RULE_TOKEN_RE.match(tail, i)
            if not tok or not tok.group(1):
                break
            reason = tok.group(2)
            out.append(Tag(
                path, lineno, tok.group(1),
                reason[1:-1].strip() if reason else None,
            ))
            i = tok.end()
            if i < len(tail) and tail[i] == ",":
                i += 1
            else:
                break

    if lang == "python":
        import io
        import tokenize

        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    record(tok.start[0], tok.string)
            return out
        except (tokenize.TokenError, IndentationError, SyntaxError):
            out.clear()
    for lineno, line in enumerate(text.splitlines(), start=1):
        record(lineno, line)
    return out


def collect_repo_tags(root: str) -> List[Tag]:
    """Tags across everything ``run_repo`` scans: the port's package,
    chip_smoke.py and the Go wire sources (wire-contract tags live
    there)."""
    tags: List[Tag] = []
    paths: List[Tuple[str, str]] = [
        (p, "python") for p in scanned_files(root)]
    go_root = os.path.join(root, "go")
    if os.path.isdir(go_root):
        for dirpath, dirnames, filenames in os.walk(go_root):
            dirnames[:] = [d for d in dirnames if not d.startswith(".")]
            for name in sorted(filenames):
                if name.endswith(".go"):
                    paths.append((os.path.join(dirpath, name), "go"))
    for path, lang in paths:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        tags.extend(parse_tags(os.path.relpath(path, root), text, lang))
    return tags


def audit(root: Optional[str] = None) -> Tuple[List[Tag], List[Violation]]:
    """``(tags, problems)``: every live tag plus the audit failures
    (missing reason on a reason-required rule, stale tag)."""
    lint = lint_pass(root)
    return lint.tags, lint.problems


@dataclasses.dataclass
class LintPass:
    findings: List[Violation]  # what run_repo reports
    tags: List[Tag]
    problems: List[Violation]  # what audit reports
    graph: object  # the derived lockgraph.LockGraph


def lint_pass(root: Optional[str] = None) -> LintPass:
    """``run_repo`` and ``audit`` in one walk of the tree: one raw pass,
    filtered through the tags for the findings, and one lock graph."""
    from koordinator_tpu_torch.analysis import lockgraph

    root = root or find_repo_root()
    graph = lockgraph.repo_graph(root)
    raw = run_repo(root=root, honor_suppressions=False, graph=graph)
    tags = collect_repo_tags(root)
    findings = _filter_file_comments(root, raw)
    return LintPass(findings, tags, _problems(tags, raw), graph)


def _problems(tags: List[Tag], raw: List[Violation]) -> List[Violation]:
    fired: Dict[Tuple[str, str], Set[int]] = {}
    for v in raw:
        fired.setdefault((v.path, v.rule), set()).add(v.line)
    problems: List[Violation] = []
    for tag in tags:
        if tag.rule in REASON_REQUIRED and not tag.reason:
            problems.append(Violation(
                RULE, tag.path, tag.line,
                f"suppression of {tag.rule!r} carries no reason — "
                "reason-required rules hide races/eaten errors, so the "
                "tag must say why the hazard is not real: "
                f"# koordlint: disable={tag.rule}(reason: ...)",
            ))
        lines = fired.get((tag.path, tag.rule), ())
        if tag.line not in lines and tag.line + 1 not in lines:
            problems.append(Violation(
                RULE, tag.path, tag.line,
                f"stale suppression: {tag.rule!r} no longer fires on "
                "this line (or the line below) — the code moved or was "
                "fixed; prune the tag before it blankets whatever lands "
                "here next",
            ))
    problems.sort(key=lambda v: (v.path, v.line, v.message))
    return problems


def format_report(tags: List[Tag], problems: List[Violation]) -> str:
    lines: List[str] = []
    for tag in sorted(tags, key=lambda t: (t.path, t.line, t.rule)):
        reason = tag.reason if tag.reason else "NO REASON"
        lines.append(f"{tag.path}:{tag.line}: {tag.rule} — {reason}")
    lines.append(f"{len(tags)} live suppression(s)")
    if problems:
        lines.append("")
        for p in problems:
            lines.append(p.format())
        lines.append(f"AUDIT FAILED: {len(problems)} problem(s)")
    else:
        lines.append("audit clean: no stale tags, no missing reasons")
    return "\n".join(lines)
