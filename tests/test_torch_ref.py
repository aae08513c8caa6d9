"""The reference's core test files held against the port, case by case.

Each ``tests/test_torch_ref_<group>.py`` loads the reference test modules
of its group through ``tests/test_torch_koordlint.py rebound()`` (once
bound to the JAX package, once to the port) and runs every case of them
on both packages with ``run_case``: pytest's own fixtures come from the
calling test, a parametrised case runs once for each of its parameters,
and a class- or module-scoped fixture is kept for the file's later cases
(``shared``).  A case the port cannot run because its subject is XLA
itself stands in its file's ``NOT_PORTED`` with the reason.  Here: every
case of the reference files is loaded by exactly one group file or named
in exactly one ``NOT_PORTED``, at most 20 are named, and each group file
holds at most 40 tests.
"""

import importlib
import inspect
import re
import sys

import pytest

from test_torch_koordlint import (
    TESTS,
    _parametrize_marks,
    case_name,
    close_shared,
    file_cases,
    rebound,
    run_case,
)

# the reference files the groups load, in main-path order
REFERENCE_FILES = (
    "test_solver", "test_snapshot", "test_resources", "test_loadaware_profiles",
    "test_plugin_seam", "test_native_bridge", "test_coalesce", "test_journal",
    "test_services_daemon", "test_framework", "test_reservation", "test_chaos_trace",
    "test_obs", "test_trace_export", "test_devprof", "test_prewarm",
    "test_pallas_cycle", "test_wave", "test_scoring",
)

# each group file's reference modules, with the classes it takes of each
# (None: every case of the module)
GROUPS = {
    "solver": (("test_solver", None), ("test_resources", None)),
    "model": (("test_snapshot", None), ("test_loadaware_profiles", None)),
    "pallas": (("test_pallas_cycle", ("TestPallasCycleParity",)),),
    "wave": (("test_pallas_cycle", ("TestPallasWaveParity",)), ("test_wave", None)),
    "scoring": (("test_scoring", None), ("test_plugin_seam", None)),
    "native": (("test_native_bridge", None),
               ("test_coalesce", ("TestDispatcherMechanics", "TestPipelineMechanics"))),
    "coalesce": (("test_coalesce", ("TestAdaptiveGatherWindow", "TestCoalescedScoreParity",
                                    "TestInterleavedStress", "TestAssignMemo")),),
    "memo": (("test_coalesce", ("TestScoreMemo", "TestDonationSafetyInFlight",
                                "TestUdsReplySendmsg")),
             ("test_chaos_trace", None)),
    "journal": (("test_journal", None),),
    "daemon": (("test_services_daemon", ("TestAPIService", "TestConfigAPI", "TestDaemonWiring",
                                         "TestMetricsRegistry", "TestAuditHTTP")),),
    "framework": (("test_services_daemon", ("TestK8sAdaptorPlugins", "TestKoordletCLI",
                                            "TestDebugScoresRuntimeSetter")),
                  ("test_framework", None)),
    "reservation": (("test_reservation", None),),
    "obs": (("test_obs", ("TestSpanRecorder", "TestMetricsRegistryFamilies",
                          "TestUdsMalformedFrames", "TestDaemonMetricsEndpoint")),
            ("test_trace_export", ("TestFlightDumpTraceIdSchema",))),
    "telemetry": (("test_obs", ("TestServicerTelemetry",)),
                  ("test_trace_export", ("TestEndToEnd",))),
    "flight": (("test_obs", ("TestFlightRecorder",)), ("test_trace_export", ("TestTraceSpan",))),
    "export": (("test_trace_export", ("TestSpanExporter", "TestAssembler")),
               ("test_prewarm", None)),
    "devprof": (("test_devprof", None),),
}

NOT_PORTED_CAP = 20


def group_cases(group, not_ported=None):
    """The cases ``(module, class, method, param)`` of ``group``, less the
    ones its file names in ``not_ported`` (keyed ``(module, class,
    method)``)."""
    not_ported = not_ported or {}
    return [case for name, classes in GROUPS[group] for case in file_cases(name)
            if (classes is None or case[1] in classes) and case[:3] not in not_ported]


def case_id(case):
    return f"{case[0]}::{case_name(case)}"


@pytest.fixture(scope="module")
def shared():
    """The class- and module-scoped fixtures of one group file's cases."""
    kept = {}
    yield kept
    close_shared(kept)


def run_reference_case(case, package, shared, **builtins):
    module, cls, method, param = case
    run_case(module, cls, method, package, param=param, shared=shared, **builtins)


def _tests_in(module):
    """The tests pytest collects from ``module``: each ``test_`` function
    once for each combination of its parameters."""
    count = 0
    for name, fn in vars(module).items():
        if name.startswith("test_") and inspect.isfunction(fn):
            sizes = [len(m.args[1]) for m in _parametrize_marks(fn, None)]
            n = 1
            for size in sizes:
                n *= size
            count += n
    return count


def check_group_file(module_name):
    """A group file holds at most 40 tests, and every case its
    ``NOT_PORTED`` names is still a test of its reference file."""
    module = sys.modules[module_name]
    assert _tests_in(module) <= 40, (module_name, _tests_in(module))
    for (name, cls, method), reason in module.NOT_PORTED.items():
        ref = rebound(name, "koordinator_tpu")
        owner = getattr(ref, cls) if cls else ref
        assert callable(getattr(owner, method, None)), (name, cls, method)
        text = (TESTS / f"{name}.py").read_text()
        assert re.search(rf"(?m)^\s*def {method}\(", text), (name, method)
        assert reason.strip()


def _group_modules():
    return {group: importlib.import_module(f"test_torch_ref_{group}") for group in GROUPS}


def test_every_reference_case_is_loaded_once_or_named():
    modules = _group_modules()
    loaded = [case for module in modules.values() for case in module.CASES]
    named = [key for module in modules.values() for key in module.NOT_PORTED]
    assert len(loaded) == len(set(loaded))
    assert len(named) == len(set(named)) <= NOT_PORTED_CAP
    every = [case for name in REFERENCE_FILES for case in file_cases(name)]
    assert sorted(loaded + [c for c in every if c[:3] in set(named)]) == sorted(every)
    assert not {c[:3] for c in loaded} & set(named)
    # each group takes only whole classes of the files it names, and each
    # class of a reference file is in exactly one group
    for group, module in modules.items():
        assert module.CASES == group_cases(group, module.NOT_PORTED)
        assert {key[0] for key in module.NOT_PORTED} <= {name for name, _ in GROUPS[group]}
    owners = [(name, cls) for entries in GROUPS.values() for name, classes in entries
              for cls in (classes or {c[1] for c in file_cases(name)})]
    assert len(owners) == len(set(owners))


def test_the_groups_cover_the_reference_files():
    named = []
    for entries in GROUPS.values():
        named += [name for name, _ in entries if name not in named]
    assert set(named) == set(REFERENCE_FILES)
    for group in GROUPS:
        assert (TESTS / f"test_torch_ref_{group}.py").exists()
