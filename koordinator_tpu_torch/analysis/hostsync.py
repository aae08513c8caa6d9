"""Rule ``host-sync-in-jit``: a device program that blocks the host on
the device.

Counterpart of ``koordinator_tpu/analysis/hostsync.py``; the rule id is
the reference's.  In the port a device program is a registered launch
boundary or a kernel launcher (``analysis/jitscope.py``).  It runs
eagerly, so nothing here fails at trace time as in JAX: a host read of a
device value simply waits for every launch queued before it, and turns a
pipelined launch into a round trip on every call.  Inside a device
program's scope (closures included, nested boundaries excluded) the rule
flags:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` on anything;
* ``np.asarray``/``np.array``/``np.copy`` of a tensor expression;
* ``int()``/``float()``/``bool()`` of a tensor expression;
* ``torch.cuda.synchronize()`` and ``<event or stream>.synchronize()``;
* a Python ``if``/``while``/``assert`` whose test is a tensor expression:
  an implicit ``.item()``.  This is the reference ``retrace-hazard``
  shape 1 (control flow on a traced value): in PyTorch it does not
  retrace, it syncs, so it lives here;
* the obs span API's ``.note()`` of a tensor expression (the note holds
  a live device value that its recorder reads on the host), and
  ``print()`` of one.

A *tensor expression* mentions ``torch``, a parameter annotated as a
tensor, or a name the scope bound to a tensor expression, or reduces
(``.all()``, ``.any()``, ``.sum()``, ``.max()``, ...) anything that is not
host numpy (a name bound from an ``np.*`` call or ``.numpy()``).  Host metadata
is not a tensor expression: ``x.shape``, ``x.ndim``, ``x.dtype``,
``x.device``, ``x.numel()``, ``x.dim()``, ``x.size()``, ``x.data_ptr()``,
``x.is_contiguous()``, ``len(x)`` and ``x is None`` are read without the
device, so ``int(x.shape[0])`` and ``if x.numel():`` stay legal.

Unlike the reference, a span itself inside a boundary is legal: the body
runs on every call, so ``with spans.span(...)`` times each launch's host
side rather than a trace.  Deliberate host reads (a branch that needs the
value, a ladder's synchronize) carry a reasoned tag citing the ROADMAP
entry that documents them.
"""

from __future__ import annotations

import ast
from typing import List, Set

from koordinator_tpu_torch.analysis import jitscope
from koordinator_tpu_torch.analysis.core import SourceFile, Violation

RULE = "host-sync-in-jit"

_NP_MODULES = ("np", "numpy", "onp", "_np")
_NP_SYNC_FUNCS = ("asarray", "array", "copy")
_READBACK_METHODS = ("item", "tolist", "cpu", "numpy")
# reads of a tensor that never touch the device
_HOST_ATTRS = ("shape", "ndim", "dtype", "device", "is_cuda", "layout", "cuda_stream")
# reductions whose result is a device scalar when the receiver is a tensor
_REDUCTIONS = ("all", "any", "sum", "max", "min", "amax", "amin", "prod", "mean",
               "count_nonzero", "nonzero", "argmax", "argmin", "equal")
_HOST_METHODS = ("numel", "dim", "size", "data_ptr", "is_contiguous",
                 "element_size", "nelement", "stride", "get_device")
_OBS_RECEIVERS = ("obs", "spans", "telemetry", "recorder", "span_recorder", "scope")


class _Tensors:
    """Which expressions of one device program are tensor expressions."""

    def __init__(self, func: ast.AST):
        self.names: Set[str] = set()
        self.host: Set[str] = set()
        a = func.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.annotation is not None and any(
                isinstance(n, (ast.Name, ast.Attribute))
                and jitscope.attr_chain(n)[-1:] == ("Tensor",)
                for n in ast.walk(p.annotation)
            ):
                self.names.add(p.arg)
        # bind names to tensor expressions until nothing changes
        assigns = [n for n in jitscope.scope_walk(func, into_closures=True)
                   if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
        for node in assigns:
            if node.value is not None and self._numpy(node.value):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                self.host |= {n.id for t in targets for n in ast.walk(t)
                              if isinstance(n, ast.Name)}
        changed = True
        while changed:
            changed = False
            for node in assigns:
                if node.value is None or not self.mentions(node.value):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id not in self.names:
                            self.names.add(n.id)
                            changed = True

    def _numpy(self, node: ast.AST) -> bool:
        """An ``np.*`` call or a ``.numpy()``/``.tolist()`` readback: host data."""
        if isinstance(node, ast.Call):
            chain = jitscope.attr_chain(node.func)
            if chain[:1] and chain[0] in _NP_MODULES:
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in _READBACK_METHODS:
                return True
        if isinstance(node, ast.Name):
            return node.id in self.host
        if isinstance(node, (ast.BinOp, ast.Compare, ast.UnaryOp, ast.Subscript)):
            return any(self._numpy(c) for c in ast.iter_child_nodes(node)
                       if isinstance(c, ast.expr)) and not any(
                self.mentions(c) for c in ast.iter_child_nodes(node) if isinstance(c, ast.expr))
        return False

    def mentions(self, node: ast.AST) -> bool:
        """True when ``node`` reads a device value."""
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return False
            return self.mentions(node.value)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _HOST_METHODS:
                return False
            if isinstance(fn, ast.Name) and fn.id in ("len", "int", "float", "bool", "str"):
                return False  # a host value (the conversion itself is flagged)
            if isinstance(fn, ast.Attribute) and fn.attr in _READBACK_METHODS:
                return False  # already on the host (and flagged itself)
            if isinstance(fn, ast.Attribute) and fn.attr in _REDUCTIONS and not \
                    self._numpy(fn.value):
                return True
            return any(self.mentions(c) for c in ast.iter_child_nodes(node))
        if isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return any(self.mentions(o) for o in operands)
        if isinstance(node, ast.Name):
            return node.id == "torch" or (node.id in self.names and node.id not in self.host)
        if isinstance(node, (ast.Lambda, ast.FunctionDef)):
            return False
        return any(self.mentions(c) for c in ast.iter_child_nodes(node))


def _violation(path, node, what, func) -> Violation:
    return Violation(
        rule=RULE, path=path, line=node.lineno,
        message=f"{what} inside device program {func.name}() blocks the host "
        "on every launch queued before it; keep the value on the device, "
        "hoist the read to the caller, or tag a deliberate read with its "
        "ROADMAP entry",
    )


def check(source: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for func in jitscope.device_programs(source.tree, source.nodes):
        tensors = _Tensors(func)
        for node in jitscope.scope_walk(func, into_closures=True):
            if isinstance(node, (ast.If, ast.While, ast.Assert)):
                if tensors.mentions(node.test):
                    kind = type(node).__name__.lower()
                    out.append(_violation(
                        source.path, node, f"Python {kind} on a tensor value "
                        "(an implicit .item())", func))
                continue
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            chain = jitscope.attr_chain(fn)
            if isinstance(fn, ast.Attribute) and fn.attr in _READBACK_METHODS:
                out.append(_violation(source.path, node, f".{fn.attr}()", func))
            elif isinstance(fn, ast.Attribute) and fn.attr == "synchronize":
                out.append(_violation(source.path, node, f"{'.'.join(chain)}()", func))
            elif (isinstance(fn, ast.Attribute) and fn.attr in _NP_SYNC_FUNCS
                  and chain[:1] and chain[0] in _NP_MODULES
                  and node.args and tensors.mentions(node.args[0])):
                out.append(_violation(source.path, node,
                                      f"np.{fn.attr}() of a tensor", func))
            elif (isinstance(fn, ast.Name) and fn.id in ("int", "float", "bool")
                  and node.args and tensors.mentions(node.args[0])):
                out.append(_violation(source.path, node,
                                      f"{fn.id}() of a tensor", func))
            elif (isinstance(fn, ast.Attribute) and fn.attr == "note"
                  and any(seg in _OBS_RECEIVERS for seg in chain[:-1])
                  and any(tensors.mentions(a) for a in node.args[1:])):
                out.append(_violation(source.path, node,
                                      "obs .note() of a tensor value", func))
            elif (isinstance(fn, ast.Name) and fn.id == "print"
                  and any(tensors.mentions(a) for a in node.args)):
                out.append(_violation(source.path, node,
                                      "print() of a tensor", func))
    return out
