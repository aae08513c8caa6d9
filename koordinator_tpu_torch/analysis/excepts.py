"""broad-except: no silently swallowed errors.

A ``except Exception:`` (or bare ``except:`` / ``except BaseException:``)
handler passes when it demonstrably surfaces the failure:

* it re-raises (``raise`` anywhere in the handler body), or
* it logs (a call to ``log``/``logger``/``logging`` machinery, incl.
  ``.exception()``/``.error()``/…, and the module-private ``_log``
  logger the port's modules keep), or
* it binds the exception (``as exc``) and actually USES the bound name —
  building a 500 body, an error reply, an errs list all count, or
* the ``except`` line carries
  ``# koordlint: disable=broad-except(<reason>)``.

Anything else swallows the error with no trace — the class of handler
that turns device faults into silent cold-path demotions.
"""

from __future__ import annotations

import ast
from typing import List

from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "broad-except"

_LOG_ATTRS = ("exception", "error", "warning", "warn", "info", "debug",
              "log", "critical", "fatal")
_LOG_ROOTS = ("log", "logger", "logging")


def _is_log_root(name: str) -> bool:
    """``log``/``logger``/``logging`` and any ``log*`` name, with one
    leading underscore allowed: the port's modules log through a
    module-private ``_log``."""
    name = name[1:] if name.startswith("_") else name
    return name in _LOG_ROOTS or name.startswith("log")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    if isinstance(t, ast.Name):
        return t.id in ("Exception", "BaseException")
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, ast.Name) and e.id in ("Exception", "BaseException")
            for e in t.elts
        )
    return False


def _surfaces(handler: ast.ExceptHandler) -> bool:
    bound = handler.name
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if bound and node.id == bound:
                return True
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _LOG_ATTRS:
                root = fn.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Call):
                    # logging.getLogger(...).exception(...)
                    return True
                if isinstance(root, ast.Name) and _is_log_root(root.id):
                    return True
        # sys.exc_info() / traceback use also surfaces
        if isinstance(node, ast.Attribute) and node.attr == "exc_info":
            return True
    return False


def check(source: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad(node):
            continue
        if _surfaces(node):
            continue
        out.append(
            Violation(
                rule=RULE,
                path=source.path,
                line=node.lineno,
                message=(
                    "broad except swallows the error silently: re-raise, "
                    "log it, surface the bound exception, or tag with "
                    "# koordlint: disable=broad-except(<reason>)"
                ),
            )
        )
    return out
