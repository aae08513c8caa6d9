"""koordlint rule: ``bare-retry``.

A retry loop that sleeps a FIXED constant has three production failure
modes the shared policy (replication/retry.py) exists
to close: synchronized wake-ups re-arrive as a thundering herd at the
moment a restarted peer is coldest (no jitter), a dead peer is polled
at full rate forever (no exponential cap), and the loop turns an
outage into an indistinguishable-from-deadlock hang (no deadline
budget).  The replication subscriber once redialed on a bare 50 ms
sleep; it paces through ``BackoffPolicy`` now.

Shape flagged: inside a ``while``/``for`` loop that also contains an
``except`` handler (the retry-loop signature — the loop is eating
failures and going around again), a call to ``time.sleep(<numeric
literal>)`` (or a bare ``sleep(<literal>)`` from ``from time import
sleep``).  Computed delays (``sleep(backoff.delay_ms(i) / 1000)``,
``event.wait(...)``) are not flagged — the rule targets the provably
fixed cadence, not every pause.

Deliberate fixed-cadence poll loops (a parent-liveness watch, a status
file poll) suppress with a reason::

    time.sleep(0.5)  # koordlint: disable=bare-retry(parent-liveness poll, not a retry)
"""

from __future__ import annotations

import ast
from typing import List

from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "bare-retry"


def _is_sleep_call(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "sleep":
        return isinstance(fn.value, ast.Name) and fn.value.id == "time"
    if isinstance(fn, ast.Name) and fn.id == "sleep":
        return True
    return False


def _fixed_delay(node: ast.Call):
    """The numeric literal a sleep call pins, or None when computed."""
    if not node.args or node.keywords:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(
        arg.value, (int, float)
    ) and not isinstance(arg.value, bool):
        return arg.value
    return None


def check(source: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    seen = set()
    for loop in ast.walk(source.tree):
        if not isinstance(loop, (ast.While, ast.For)):
            continue
        has_except = any(
            isinstance(n, ast.ExceptHandler) for n in ast.walk(loop)
        )
        if not has_except:
            continue
        for n in ast.walk(loop):
            if not (isinstance(n, ast.Call) and _is_sleep_call(n)):
                continue
            delay = _fixed_delay(n)
            if delay is None:
                continue
            if n.lineno in seen:
                continue  # nested loops both walk the same call
            seen.add(n.lineno)
            out.append(Violation(
                rule=RULE,
                path=source.path,
                line=n.lineno,
                message=(
                    f"retry loop sleeps a fixed {delay}s — no jitter, "
                    "no exponential cap, no deadline budget; pace it "
                    "through replication.retry.BackoffPolicy (or tag a "
                    "deliberate fixed-cadence poll with a reasoned "
                    "disable)"
                ),
            ))
    return out
