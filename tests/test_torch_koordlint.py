"""koordlint over the port (``koordinator_tpu_torch/analysis/``) under
tier-1, held against the reference's own lint.

The generic rules' cases of ``tests/test_koordlint.py`` run through both
packages: the reference test module is loaded a second time with its
imports bound to the port and its repo reads pointed at the port's files
(``bridge/state.py``, ``replication/codec.py``, ``bridge/wirecheck.py``,
``analysis/LOCKORDER.md``; ``scorer.proto`` and the Go sources are the
contract both sides read).  The reference's cases run in groups, each
from its own ``tests/test_torch_koordlint_<group>.py``.  The port's own
cases follow here: the readbacks of the port's idiom under a lock, the
same readbacks reached through a call, the port's ``_log`` logger, the
stub factory shape, and the gate itself — ``run_repo`` over the port
finds nothing and the suppression audit is clean.  The codec
(``bridge/wire.py``) against the proto is in
``tests/test_torch_koordlint_mirror.py``.
"""

import contextlib
import functools
import inspect
import itertools
import os
import re
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.analysis import RULES, lockdispatch, lockgraph
from koordinator_tpu_torch.analysis.core import run_repo, run_rules_on_source
from koordinator_tpu_torch.parallel.mesh import snapshot_leaves, visible_devices
from koordinator_tpu_torch.solver import greedy_assign_dense, greedy_assign_wide
from koordinator_tpu_torch import _build
from koordinator_tpu_torch.obs import devprof
from test_torch_devprof import BOUNDARIES as PORT_BOUNDARIES
from test_torch_constraints import _ON_CPU, PACKAGES

TESTS = Path(__file__).resolve().parent
REPO = str(TESTS.parent)
PORT = "koordinator_tpu_torch"

# the port's files in place of the reference's where a case reads the tree
_PORT_READS = (
    (re.compile(r'read\("koordinator_tpu",(\s*)"(bridge|replication)",(\s*)'
                r'"(state|codec|wirecheck)\.py"\)'),
     r'read("koordinator_tpu_torch",\1"\2",\3"\4.py")'),
    (re.compile(r'read\("docs", "LOCKORDER\.md"\)'),
     'read("koordinator_tpu_torch", "analysis", "LOCKORDER.md")'),
    # the port's codec stands where the reference's generated scorer_pb2
    # stands
    (re.compile(r'wire_contract\.check_pb2_descriptor\(sources\["proto"\]\)'),
     'wire_contract.check_codec_messages(sources["proto"], '
     'read("koordinator_tpu_torch", "bridge", "wire.py"))'),
)


# entry points beside ``_ON_CPU`` that take a device: the port binding runs
# them on the CPU (a mesh built without devices spans the CPU's forced
# host-platform devices, as ``jax.devices()`` does under tests/conftest.py)
_PORT_ON_CPU = ("SchedulerServer", "make_mesh", "cluster_mesh", "pod_mesh",
                "RawUdsServer", "serve_raw_uds", "serve_uds", "make_server",
                "generators.quota_colocation_snapshot", "encode_quota_lists",
                "TraceReplay", "overload_band_storm")


def _plain_kernel(entry):
    """A Pallas entry point's counterpart: the port's kernel entry, which
    runs the kernel's plain version on a CPU snapshot (``interpret=`` has
    nothing to choose there)."""
    def call(*args, interpret=False, **kwargs):
        return entry(*args, **kwargs)
    return call


def _lax_top_k(x, k):
    """``lax.top_k``, the reference's oracle, over a port tensor's host
    copy (a JAX function takes no torch tensor)."""
    from jax import lax

    return lax.top_k(np.asarray(x), k)


def _kernel_like(fn):
    """A ``jax.jit`` function's counterpart in the port's idiom: a torch
    function whose first call for each argument signature builds a kernel
    variant, as a kernel wrapper's ``_build.build`` does for a new variant,
    and whose later calls find it built.  The build is reported to
    ``_build``'s listeners, with the seconds the first call took."""
    built = set()

    @functools.wraps(fn)
    def call(*args, **kwargs):
        sig = devprof.shape_signature(args, kwargs)
        if sig in built:
            return fn(*args, **kwargs)
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        built.add(sig)
        for listener in list(_build._BUILD_LISTENERS):
            listener("kernel_like.cu", (f"SIG={sig}",), time.perf_counter() - start)
        return out

    return call


# the JAX objects a reference case speaks of, and the port's counterparts
# its edits below name (ROADMAP Queue C "The in-process mesh"): K2 and K3
# stand where the reference's Pallas wide kernel stands, K1 where its
# dense one stands
_PORT_NAMES = {
    "_kernel_like": _kernel_like,
    "_lax_top_k": _lax_top_k,
    "_port_boundaries": frozenset(PORT_BOUNDARIES),
    "_plain_wide": _plain_kernel(greedy_assign_wide),
    "_plain_dense": _plain_kernel(greedy_assign_dense),
    "_visible_devices": lambda: visible_devices("cpu"),
    "_mesh_scope": contextlib.nullcontext,
    "_tree_leaves": snapshot_leaves,
    "_tree_flatten": lambda snap: (snapshot_leaves(snap), None),
    "torch": torch,
}

# the device list, the mesh scope and the sharding specs of the reference's
# mesh cases (``jax.devices()``, ``with mesh:``, ``jax.sharding``)
_MESH_EDITS = (
    ("jax.devices()", "_visible_devices()"),
)

# ``jnp.ones/zeros/full/asarray`` take their dtype positionally,
# ``torch``'s by keyword: ``(shape or data[, fill], dtype)`` becomes
# ``(shape or data[, fill], dtype=dtype)``
_POSITIONAL_DTYPE = (
    re.compile(r"(jnp\.(?:ones|zeros|full|asarray)\((?:[^()]|\([^()]*\))*?), "
               r"(bool|jnp\.\w+)\)"),
    r"\1, dtype=\2)",
)

# ``jnp.zeros/full(...)`` with a numpy dtype given positionally: ``torch``
# takes the same dtype by keyword, as its own
_NP_POSITIONAL_DTYPE = (
    re.compile(r"(jnp\.(?:ones|zeros|full|asarray)\((?:[^()]|\([^()]*\))*?), np\.(\w+)\)"),
    r"\1, dtype=jnp.\2)",
)

# the reference's oracle ``lax.top_k`` over the port's tensors
_LAX_TOP_K = (re.compile(r"\blax\.top_k\("), "_lax_top_k(")

# the reference's Pallas kernels and their demotion store, and the port's
# kernels (run as their plain versions on the CPU) and the ladder's store
_PALLAS_IMPORTS = (
    ("from koordinator_tpu_torch.solver.pallas_cycle import greedy_assign_pallas as _wide",
     "_wide = _plain_wide"),
    ("from koordinator_tpu_torch.solver.pallas_dense import greedy_assign_dense as _dense",
     "_dense = _plain_dense"),
)

# edits a reference module needs to run on the port, each a stated
# difference (ROADMAP Queue C): ``torch.full`` takes its dtype by keyword,
# where ``jnp.full`` takes it third; the mesh cases name the port's mesh
# objects (``_PORT_NAMES``), its arrays (``torch.as_tensor``) and the
# kernel ladder's demotion store
_PORT_EDITS = {
    "test_e2e_smoke": (
        ("POLICY_SINGLE_NUMA_NODE, jnp.int32", "POLICY_SINGLE_NUMA_NODE, dtype=jnp.int32"),
    ),
    "test_parallel": _MESH_EDITS + (
        ("    with mesh:\n", "    with _mesh_scope(mesh):\n"),
        ("jax.numpy.asarray(", "torch.as_tensor("),
        ("jax.numpy.int64", "torch.int64"),
    ),
    "test_mesh_resident": _MESH_EDITS + (
        ("from jax.sharding import PartitionSpec as P",
         "from koordinator_tpu_torch.parallel.mesh import PartitionSpec as P"),
        ("jax.tree_util.tree_leaves(", "_tree_leaves("),
        ("jax.tree_util.tree_flatten(", "_tree_flatten("),
    ),
    "test_bridge": _MESH_EDITS + (
        ("from koordinator_tpu_torch.bridge import ScorerClient, serve_uds",
         "from koordinator_tpu_torch.bridge.client import ScorerClient\n"
         "from koordinator_tpu_torch.bridge.server import serve_uds"),
        ("solver._PALLAS_LOCK", "solver._LOCK"),
        ("solver._PALLAS_FAILURES", "solver._FAILURES"),
        # a qualified entry point, given the CPU as ``_ON_CPU`` gives a bare one
        ("udsserver.RawUdsServer(sock_path)", "_on_cpu(udsserver.RawUdsServer)(sock_path)"),
    ),
    # the oracle, ``jnp``'s functional ``.at[].set`` and scalar constructor
    "test_score_incremental": _MESH_EDITS + (
        _LAX_TOP_K,
        ("feasible.at[7, :].set(False)", "feasible.index_fill(0, jnp.tensor([7]), False)"),
        ("jnp.int64(2 ** 40)", "jnp.tensor(2 ** 40, dtype=jnp.int64)"),
    ),
    "test_parity_fuzz": _MESH_EDITS,
    "test_terms": _MESH_EDITS + (_LAX_TOP_K,),
    # K2 through its plain version for the Pallas wide kernel; a fresh
    # ``jax.jit`` inside the guard is a torch function that builds a kernel,
    # which the port's guard counts as a build (``compiles``): its
    # ``traces`` are the ladder's demotions
    # (``koordinator_tpu_torch/analysis/retrace_guard.py``)
    "test_resident_warm": _MESH_EDITS + (
        ("from koordinator_tpu_torch.solver.pallas_cycle import greedy_assign_pallas",
         "greedy_assign_pallas = _plain_wide"),
        ("jax.jit(lambda x: x + 1)(jnp.zeros(3))\n        assert counter.traces > 0",
         "_kernel_like(lambda x: x + 1)(jnp.zeros(3))\n        assert counter.compiles > 0"),
        ("before = counter.traces\n        jax.jit(lambda x: x - 1)(jnp.zeros(5))",
         "before = counter.compiles\n        _kernel_like(lambda x: x - 1)(jnp.zeros(5))"),
        ("# after stop(): not counted\n        assert counter.traces == before",
         "# after stop(): not counted\n        assert counter.compiles == before"),
    ),
    "test_solver": (
        ("solver.pallas_demotions()", "solver.kernel_demotions()"),
    ),
    # positional dtypes, and a functional ``.at[...].set``, which is
    # ``index_fill`` in ``torch``
    "test_framework": (
        _POSITIONAL_DTYPE,
        ("m.at[:, 0].set(False)", "m.index_fill(1, jnp.tensor([0]), False)"),
        ("s.at[:, 1].set(100)", "s.index_fill(1, jnp.tensor([1]), 100)"),
    ),
    "test_scoring": (_POSITIONAL_DTYPE,),
    "test_services_daemon": (_POSITIONAL_DTYPE,),
    # ``torch`` makes a scalar with ``tensor``, where ``jnp`` calls the dtype
    "test_wave": (
        _POSITIONAL_DTYPE,
        ("jnp.int64(s), feas, jnp.int64(i)",
         "jnp.tensor(s, dtype=jnp.int64), feas, jnp.tensor(i, dtype=jnp.int64)"),
        ("jnp.int32(-1), jnp.bool_(True)", "jnp.tensor(-1, dtype=jnp.int32), jnp.tensor(True)"),
    ),
    "test_pallas_cycle": _PALLAS_IMPORTS,
    "test_loadaware_profiles": _MESH_EDITS + (
        ("from koordinator_tpu_torch.solver.pallas_cycle import greedy_assign_pallas",
         "greedy_assign_pallas = _plain_wide"),
        ("from jax.sharding import Mesh", "from koordinator_tpu_torch.parallel.mesh import Mesh"),
    ),
    # the port's launch notes name a kernel's build ``build_ms``, where the
    # reference's name an XLA compile ``compile_ms``
    "test_trace_export": (
        ('"compile_ms": 312.5', '"build_ms": 312.5'),
        ('"compile=312.50ms"', '"build=312.50ms"'),
    ),
    # a test function under a launch boundary is a torch function that
    # builds a kernel on a new signature (``_kernel_like``), where the
    # reference's is a ``jax.jit`` program that compiles; the port's builds
    # are CUDA kernels, recorded ``backend="cuda"``, its report names them a
    # build ledger and a boundary's second build a rebuild, and its serving
    # boundaries stand where the reference's stand (``obs/devprof.py``)
    "test_devprof": (
        ("    @jax.jit\n", "    @_kernel_like\n"),
        ('assert entry["backend"] == "cpu"', 'assert entry["backend"] == "cuda"'),
        ('assert ev["backend"] == "cpu"', 'assert ev["backend"] == "cuda"'),
        ('"compile ledger:"', '"build ledger:"'),
        ('"attributed retraces (1):"', '"attributed rebuilds (1):"'),
        ('"koordinator_tpu_torch.solver.pallas_cycle",\n            '
         '"koordinator_tpu_torch.solver.pallas_dense",',
         '"koordinator_tpu_torch.solver.wide",\n            "koordinator_tpu_torch.solver.dense",'),
        ("assert found == _EXPECTED", "assert found == _port_boundaries"),
    ),
    "test_prewarm": (
        ("    @jax.jit\n", "    @_kernel_like\n"),
    ),
    # the port compiles no program for a fresh ``jax.jit`` to miss on
    "test_obs": (
        ("jax.jit(lambda x: x * 3 + 1)(jnp.arange(7))", "(lambda x: x * 3 + 1)(jnp.arange(7))"),
    ),
    # ``torch.full`` takes its size as a tuple, where ``jnp.full`` takes an int
    "test_candidates": _MESH_EDITS + (
        _POSITIONAL_DTYPE,
        _NP_POSITIONAL_DTYPE,
        (re.compile(r"jnp\.full\(p, "), "jnp.full((p,), "),
        ("sparse_top_k(s_sp, f_sp, cand, k=k, hi=hi)",
         "sparse_top_k(torch.as_tensor(s_sp), torch.as_tensor(f_sp), cand, k=k, hi=hi)"),
    ),
}


def _fixture(fn=None, *, scope="function", autouse=False, params=None, **_):
    """``pytest.fixture`` in a rebound module: the function stays plain
    and carries its scope, ``autouse`` and ``params`` for ``run_case``."""
    def mark(f):
        f._fixture = types.SimpleNamespace(scope=scope, autouse=autouse, params=params)
        return f
    return mark(fn) if callable(fn) else mark


@functools.lru_cache(maxsize=None)
def rebound(name: str, package: str) -> types.ModuleType:
    """The reference test module ``tests/<name>.py`` bound to ``package``.

    Its fixtures become plain functions (``run_case`` drives them), and
    ``from test_x import ...`` takes the names from ``test_x`` bound to
    the same package.  For the port, every ``koordinator_tpu`` import
    points at the port, ``pb2`` at the port's codec, ``jax.numpy`` at
    ``torch``, the repo reads above at the port's files, the module's
    ``_PORT_EDITS`` made, and every entry point that takes a device is
    given ``device="cpu"``."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    src = re.sub(r"(?m)^(\s*)@pytest\.fixture(.*)\n", r"\1@_fixture\2\n", src)
    # a parenthesised import from a sibling test module, on one line
    src = re.sub(r"(?m)^(\s*)from (test_\w+) import \(([^)]*)\)",
                 lambda m: f"{m.group(1)}from {m.group(2)} import "
                           + ", ".join(n.strip() for n in m.group(3).split(",") if n.strip()),
                 src)
    src = re.sub(r"(?m)^(\s*)from (test_\w+) import (.+)$",
                 lambda m: f"{m.group(1)}{m.group(3)} = _names({m.group(2)!r}, "
                           f"{m.group(3)!r})", src)
    if package == PORT:
        src = src.replace("from koordinator_tpu.bridge.codegen import pb2",
                          "from koordinator_tpu_torch.bridge import wire as pb2")
        # the rest of the reference's codegen shim (``method_path``) is the
        # codec module's too
        src = src.replace("from koordinator_tpu.bridge.codegen import",
                          "from koordinator_tpu.bridge.wire import")
        for pattern, repl in _PORT_READS:
            src = pattern.sub(repl, src)
        src = src.replace("koordinator_tpu.", "koordinator_tpu_torch.")
        src = src.replace("from koordinator_tpu import", "from koordinator_tpu_torch import")
        src = src.replace("import jax.numpy as jnp", "import torch as jnp")
        for before, after in _PORT_EDITS.get(name, ()):
            if isinstance(before, re.Pattern):
                src, count = before.subn(after, src)
                assert count, (name, before.pattern)
                continue
            assert before in src, (name, before)
            src = src.replace(before, after)
        src = re.sub(r"(?<![\w.])(%s)\(" % "|".join(map(re.escape, _ON_CPU + _PORT_ON_CPU)),
                     r"_on_cpu(\1)(", src)
    module = types.ModuleType(f"{name}__{package}")
    module.__file__ = str(path)
    module._on_cpu = lambda fn: functools.partial(fn, device="cpu")
    module._fixture = _fixture
    if package == PORT:
        module.__dict__.update(_PORT_NAMES)

    def names(other, listed):
        bound = rebound(other, package)
        got = tuple(getattr(bound, n.strip()) for n in listed.split(","))
        return got if len(got) > 1 else got[0]

    module._names = names
    exec(compile(src, str(path), "exec"), module.__dict__)
    return module


def _parametrize_marks(fn, owner):
    """The ``parametrize`` marks on a test and on its class, in the order
    their indices are given to ``run_case``."""
    marks = list(getattr(fn, "pytestmark", ())) + list(getattr(owner, "pytestmark", ()))
    return [m for m in marks if m.name == "parametrize"]


def _spec(obj):
    """What ``_fixture`` recorded on ``obj``, or None for a non-fixture."""
    return getattr(obj, "_fixture", None)


def _fixture_params(mod, instance, fn):
    """The names of the test's parameters that are fixtures with
    ``params`` (each case runs once for each of their values)."""
    return [name for name in inspect.signature(fn).parameters
            if (spec := _spec(getattr(instance, name, None) or getattr(mod, name, None)))
            and spec.params is not None]


def _parameters(mark, index):
    names = mark.args[0]
    names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
    value = mark.args[1][index]
    value = value.values if hasattr(value, "values") and hasattr(value, "marks") else value
    return dict(zip(names, value)) if len(names) > 1 else {names[0]: value}


def run_case(module, cls, method, package, *, param=(), shared=None, **given):
    """One test method of a rebound reference module (a module-level test
    function when ``cls`` is empty).

    ``param`` indexes each ``parametrize`` mark of the test and its class,
    and the values are taken from the rebound module, so each package's
    case gets its own objects.  Each parameter is taken from ``given``
    (pytest's own fixtures, or a case's parameters), else from the class's
    or the module's fixture of that name, called with its own parameters
    resolved the same way; a fixture with ``params`` is given a
    ``request`` whose ``param`` is the value ``given`` names.  The
    module's and the class's ``autouse`` fixtures run first.  A generator
    fixture runs to its yield and is closed after the case, or, when its
    scope is ``class`` or ``module`` and the caller passes a ``shared``
    dict, is kept there for the next case of the same file (the caller
    closes it with ``close_shared``)."""
    mod = rebound(module, package)
    owner = getattr(mod, cls) if cls else None
    instance = owner() if cls else None
    fn = getattr(instance, method) if cls else getattr(mod, method)
    marks = _parametrize_marks(fn, owner)
    for mark, index in zip(marks, param):
        given = {**_parameters(mark, index), **given}
    for name, index in zip(_fixture_params(mod, instance, fn), param[len(marks):]):
        given = {name: _spec(getattr(mod, name)).params[index], **given}
    open_fixtures = []

    def value_of(name):
        fixture = getattr(instance, name, None) or getattr(mod, name, None)
        spec = _spec(fixture)
        if name in given and (spec is None or spec.params is None):
            return given[name]
        key = (module, package, cls if spec and spec.scope == "class" else "", name)
        keep = shared is not None and spec is not None and spec.scope in ("class", "module")
        if keep and key in shared:
            return shared[key][0]
        extra = {}
        if spec is not None and spec.params is not None:
            extra["request"] = types.SimpleNamespace(param=given[name])
        value = resolve(fixture, extra)
        gen = value if inspect.isgenerator(value) else None
        if gen is not None:
            value = next(gen)
        if keep:
            shared[key] = (value, gen)
        elif gen is not None:
            open_fixtures.append(gen)
        return value

    def resolve(fixture, extra=None):
        kwargs = dict(extra or {})
        for name in inspect.signature(fixture).parameters:
            if name not in kwargs:
                kwargs[name] = value_of(name)
        return fixture(**kwargs)

    try:
        autouse = [name for name, obj in list(vars(mod).items())
                   + (list(vars(owner).items()) if owner else [])
                   if (spec := _spec(obj)) and spec.autouse]
        for name in autouse:
            value_of(name)
        resolve(fn)
    finally:
        for gen in reversed(open_fixtures):
            next(gen, None)


def close_shared(shared):
    """Close the class- and module-scoped fixtures ``run_case`` kept."""
    for _value, gen in reversed(list(shared.values())):
        if gen is not None:
            next(gen, None)
    shared.clear()


def file_cases(name):
    """Every case of the reference test module ``tests/<name>.py``, in
    source order: ``(name, class, method, param)``, the class empty for a
    module-level test and ``param`` one index into each ``parametrize``
    mark (see ``run_case``)."""
    module = rebound(name, "koordinator_tpu")
    own = [(n, obj) for n, obj in vars(module).items()
           if getattr(obj, "__module__", None) == module.__name__]
    tests = [("", n, obj, None) for n, obj in own
             if n.startswith("test_") and inspect.isfunction(obj)]
    tests += [(cls_name, n, fn, cls) for cls_name, cls in own
              if cls_name.startswith("Test") and inspect.isclass(cls)
              for n, fn in vars(cls).items() if n.startswith("test_") and callable(fn)]
    cases = []
    for cls_name, method, fn, owner in tests:
        sizes = [len(m.args[1]) for m in _parametrize_marks(fn, owner)]
        sizes += [len(_spec(getattr(module, name)).params)
                  for name in _fixture_params(module, owner, fn)]
        for param in itertools.product(*(range(n) for n in sizes)):
            cases.append((name, cls_name, method, param))
    return cases


def case_name(case):
    """A case's test id: ``Class::method`` and its parameter indices."""
    _module, cls, method, param = case
    label = f"{cls}::{method}" if cls else method
    return label + (f"[{'-'.join(map(str, param))}]" if param else "")


def reference_cases(name, classes, skip=()):
    module = rebound(name, "koordinator_tpu")
    return [
        (name, cls_name, method)
        for cls_name in classes
        for method in sorted(vars(getattr(module, cls_name)))
        if method.startswith("test_") and (cls_name, method) not in skip
    ]


# The reference classes that run on both packages, in groups of at most 40
# parametrised tests
# (20 cases on two packages): each group runs from
# ``tests/test_torch_koordlint_<group>.py``, so no test file grows past
# the size the tier-1 run's per-file scheduling keeps balanced.
GROUPS = {
    "spans": ("TestSpanLeak", "TestSpanLeakTraceAPI"),
    "dispatch": ("TestLockHeldDispatch", "TestBareRetry", "TestBroadExcept"),
    "waits": ("TestUnboundedWait", "TestUnguardedSharedState", "TestSuppressionParsing"),
    "lockorder": ("TestLockOrderCycle", "TestLockOrderDocDrift", "TestSuppressionAudit"),
    "wire": ("TestWireContract",),
    "mirror": ("TestWirecheckMessageMirror", "TestMetricsDocDrift"),
    # the two classes of the device-discipline rules that carry no JAX
    # idiom; the other five are mirrored in the port's idiom
    # (tests/test_torch_koordlint_devrules.py)
    "device": ("TestTermConfigRule", "TestPrewarmDrift"),
}
GENERIC_CLASSES = tuple(cls for classes in GROUPS.values() for cls in classes)
# the stale-regen case probes the generated scorer_pb2 by field NAME with a
# duplicated field number; the port's codec is diffed by number, and
# test_torch_koordlint_mirror.py's test_a_field_only_the_proto_has_fails is
# its counterpart
NOT_PORTED = {("TestWireContract", "test_stale_pb2_caught")}


def group_cases(group):
    """The reference cases of one group: ``(module, class, method)``."""
    return reference_cases("test_koordlint", GROUPS[group], NOT_PORTED)


def test_the_reference_cases_are_collected():
    cases = reference_cases("test_koordlint", GENERIC_CLASSES, NOT_PORTED)
    assert len(cases) >= 100
    assert {c[1] for c in cases} == set(GENERIC_CLASSES)
    for group in GROUPS:
        assert (TESTS / f"test_torch_koordlint_{group}.py").exists()
        assert len(PACKAGES) * len(group_cases(group)) <= 40


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


def lint(src: str, rules=None):
    return run_rules_on_source("fixture.py", textwrap.dedent(src), rules)


def read(*parts: str) -> str:
    with open(os.path.join(REPO, *parts), "r", encoding="utf-8") as f:
        return f.read()


class TestPortReadbacksUnderALock:
    """lock-held-dispatch knows the port's blocking readbacks."""

    @pytest.mark.parametrize("call", [
        "snap.scores.cpu()", "snap.scores.numpy()", "snap.assignment.tolist()",
        "snap.rounds.item()", "torch.cuda.synchronize()", "done.synchronize()",
        "start.elapsed_time(end)", "np.asarray(snap.scores)", "np.array(snap.scores)",
    ])
    def test_readback_under_the_state_lock_caught(self, call):
        out = lint(f"""
        import numpy as np
        import torch

        class Servicer:
            def score(self, done, start, end):
                with self._state_lock:
                    snap = self.state.snapshot()
                    got = {call}
                return got
        """, ["lock-held-dispatch"])
        assert [(v.rule, v.line) for v in out] == [("lock-held-dispatch", 9)]
        assert "state lock" in out[0].message

    def test_readback_in_a_launch_section_caught(self):
        out = lint("""
        import torch
        from koordinator_tpu_torch.bridge.coalesce import launch_section

        class Servicer:
            @launch_section
            def _assign_launch(self, snap):
                chosen = self.cycle(snap)
                torch.cuda.synchronize()
                return chosen.cpu()
        """, ["lock-held-dispatch"])
        assert [v.line for v in out] == [9, 10]
        assert all("launch critical section" in v.message for v in out)

    def test_readback_closure_and_capture_outside_are_clean(self):
        assert lint("""
        import torch

        class Servicer:
            def assign(self):
                with self._state_lock:
                    snap = self.state.snapshot()

                    def readback():
                        return snap.assignment.cpu().tolist()
                torch.cuda.synchronize()
                return self.dispatch.run_pipelined(lambda: readback), snap.rounds.item()
        """, ["lock-held-dispatch"]) == []


class TestReadbackThroughACall:
    """lock-held-dispatch follows a call made under a lock into the
    functions the lock graph resolves, and flags the call when it reaches
    a readback only a device value makes."""

    @staticmethod
    def through(src):
        return lockdispatch.check_sources({
            "koordinator_tpu_torch/solver/cycle.py": textwrap.dedent("""
                import numpy as np
                import torch

                def run_cycle(snap):
                    def rung(fn):
                        def thunk():
                            out = fn(snap)
                            torch.cuda.synchronize(snap.device)
                            return out
                        return thunk
                    return ladder([rung(launch)])

                def host_rows(rows):
                    return np.asarray(rows).tolist()
                """),
            "koordinator_tpu_torch/bridge/servicer.py": textwrap.dedent(src),
        })

    def test_a_ladder_synchronize_under_a_launch_section_caught(self):
        got = self.through("""
            from koordinator_tpu_torch.bridge.coalesce import launch_section
            from koordinator_tpu_torch.solver.cycle import run_cycle

            class Servicer:
                @launch_section
                def _assign_cycle(self, snap):
                    return run_cycle(snap)
            """)
        assert [(v.path, v.line) for v in got] == [("koordinator_tpu_torch/bridge/servicer.py", 8)]
        assert "run_cycle(), reaching torch.cuda.synchronize() at " \
            "koordinator_tpu_torch/solver/cycle.py:9 through run_cycle.rung.thunk" in got[0].message
        assert "launch critical section" in got[0].message

    def test_a_device_wait_two_calls_down_under_the_state_lock_caught(self):
        got = self.through("""
            class Servicer:
                def _flush(self, snap):
                    return self._copy(snap)

                def _copy(self, snap):
                    return snap.scores.cpu()

                def score(self, snap):
                    with self._state_lock:
                        return self._flush(snap)
            """)
        assert [v.line for v in got] == [11]
        assert "through Servicer._flush -> Servicer._copy" in got[0].message
        assert "state lock" in got[0].message

    def test_host_spellings_count_only_lexically(self):
        assert self.through("""
            from koordinator_tpu_torch.solver.cycle import host_rows

            class Servicer:
                def rows(self, rows):
                    with self._state_lock:
                        return host_rows(rows)
            """) == []

    def test_a_callee_launch_section_is_checked_on_its_own(self):
        got = self.through("""
            import torch
            from koordinator_tpu_torch.bridge.coalesce import launch_section

            class Servicer:
                @launch_section
                def _launch(self, snap):
                    return self._cycle(snap)

                @launch_section
                def _cycle(self, snap):
                    def readback():
                        return snap.assignment.cpu()
                    torch.cuda.synchronize()
                    return readback
            """)
        assert got == []  # the direct synchronize is the lexical check's

    def test_the_port_raw_pass_flags_the_assign_cycle_and_the_tag_holds(self):
        raw = [v for v in run_repo(root=REPO, rules=["lock-held-dispatch"],
                                   honor_suppressions=False)]
        # the shard Assign's readback inside its demotion guard, tagged as
        # in the reference; and the host-only npz index the metric cache
        # builds under its lock, tagged as in the reference
        assert sorted((v.path, "run_cycle(), reaching torch.cuda.synchronize()" in v.message,
                       "_assign_shard(), reaching .numpy()" in v.message)
                      for v in raw) == [(f"{PORT}/bridge/server.py", False, True),
                                        (f"{PORT}/bridge/server.py", True, False),
                                        (f"{PORT}/koordlet/metriccache.py", False, False)]
        assert run_repo(root=REPO, rules=["lock-held-dispatch"]) == []


class TestPortLogger:
    """broad-except counts the port's module-private ``_log`` as logging."""

    def test_private_log_exception_counts(self):
        assert lint("""
        import logging

        _log = logging.getLogger(__name__)

        def notify(listeners):
            for cb in listeners:
                try:
                    cb()
                except Exception:
                    _log.exception("listener failed")
        """, ["broad-except"]) == []

    def test_a_private_non_logger_does_not_count(self):
        got = lint("""
        def notify(listeners, _stats):
            for cb in listeners:
                try:
                    cb()
                except Exception:
                    _stats.error()
        """, ["broad-except"])
        assert [(v.rule, v.line) for v in got] == [("broad-except", 6)]


class TestStubFactory:
    """unbounded-wait sees through a stub factory that returns a partial
    (the client's ``_stub(channel, method)``), not through an invocation."""

    def test_partial_factory_is_clean(self):
        assert lint("""
        import functools

        def _stub(channel, method):
            return functools.partial(channel.call, method)

        class Client:
            def __init__(self, channel):
                self._sync = _stub(channel, "Sync")

            def sync(self, request):
                return self._sync(request, timeout=5.0)
        """, ["unbounded-wait"]) == []

    def test_a_stub_invocation_without_a_deadline_is_caught(self):
        got = lint("""
        import functools

        def _stub(channel, method):
            return functools.partial(channel.call, method)

        class Client:
            def sync(self, request):
                stub = _stub(self.channel, "Sync")
                return stub(request)
        """, ["unbounded-wait"])
        assert [(v.rule, v.line) for v in got] == [("unbounded-wait", 10)]

    def test_a_non_partial_stub_helper_is_still_an_invocation(self):
        got = lint("""
        def _stub(channel, request):
            return channel.call("Sync", request)

        def sync(channel, request):
            return _stub(channel, request)
        """, ["unbounded-wait"])
        assert [(v.rule, v.line) for v in got] == [("unbounded-wait", 6)]


class TestPortIsClean:
    """The gate: koordlint over the port finds nothing."""

    def test_run_repo_over_the_port_is_empty(self):
        violations = run_repo(root=REPO)
        assert violations == [], "\n" + "\n".join(v.format() for v in violations)

    def test_the_one_pass_agrees_with_run_repo_and_the_audit(self, tmp_path):
        from koordinator_tpu_torch.analysis import suppressions

        pkg = tmp_path / PORT
        pkg.mkdir()
        (pkg / "mod.py").write_text(textwrap.dedent("""
            def first(cb):
                try:
                    cb()
                except Exception:  # koordlint: disable=broad-except(a listener may fail)
                    pass

            def second(cb):
                try:
                    cb()
                except Exception:
                    pass

            x = 1  # koordlint: disable=broad-except(nothing here)
            """))
        root = str(tmp_path)
        got = suppressions.lint_pass(root)
        findings = run_repo(root=root)
        assert ("broad-except", 11) in {(v.rule, v.line) for v in findings}
        assert got.findings == findings
        tags, problems = suppressions.audit(root)
        assert (got.tags, got.problems) == (tags, problems)
        assert [(p.line, "stale" in p.message) for p in problems] == [(14, True)]
        assert set(got.graph.edges) == lockgraph.static_order(root)

    def test_cli(self, tmp_path, monkeypatch, capsys):
        from koordinator_tpu_torch.analysis.__main__ import main

        assert main(["--list-rules"]) == 0
        assert capsys.readouterr().out.split() == list(RULES)
        assert main(["--rules", "no-such-rule"]) == 2
        # the default root is the package's checkout, not the cwd
        monkeypatch.chdir(tmp_path)
        assert main(["--rules", "wire-contract,metrics-doc-drift"]) == 0

    def test_scan_covers_the_port_and_chip_smoke_only(self):
        from koordinator_tpu_torch.analysis.core import scanned_files

        rel = {os.path.relpath(p, REPO) for p in scanned_files(REPO)}
        assert "chip_smoke.py" in rel
        assert f"{PORT}/analysis/lockgraph.py" in rel
        assert all(p == "chip_smoke.py" or p.startswith(PORT + "/") for p in rel)

    def test_the_ported_rules_only(self):
        assert set(RULES) == {
            "broad-except", "span-leak", "lock-held-dispatch", "bare-retry",
            "unbounded-wait", "wire-contract", "metrics-doc-drift", "lock-order-cycle",
            "lockorder-doc-drift", "unguarded-shared-state", "donation-safety",
            "retrace-hazard", "host-sync-in-jit", "unregistered-jit-boundary",
            "prewarm-drift"}
        assert len(RULES) == len(set(RULES)) == 15
        for rule in RULES:
            run_rules_on_source("f.py", "", [rule])

    def test_the_derived_graph_is_the_ports(self):
        graph = lockgraph.repo_graph(REPO)
        assert len(graph.locks) >= 30 and len(graph.edges) >= 20
        assert all(not site.path.startswith("koordinator_tpu/") for site in graph.locks.values())
        # the port's launch lock orders before its own solver lock
        assert ("bridge.coalesce.CoalescingDispatcher._launch_lock",
                "solver._LOCK") in graph.edges
        assert lockgraph.find_cycles(graph) == []
        assert graph.violations == []

    def test_the_cli_runs_with_jax_and_the_reference_blocked(self):
        code = (
            "import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'koordinator_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['koordlint', '--rules', 'wire-contract,metrics-doc-drift,"
            "lock-order-cycle,lockorder-doc-drift']\n"
            "try:\n"
            "    runpy.run_module('koordinator_tpu_torch.analysis', run_name='__main__')\n"
            "except SystemExit as exc:\n"
            "    sys.exit(exc.code)\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
