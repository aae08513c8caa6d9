"""The reference's core test files held against the port, case by case.

Each ``tests/test_torch_ref_<group>.py`` loads the reference test modules
of its group through ``tests/test_torch_koordlint.py rebound()`` (once
bound to the JAX package, once to the port) and runs every case of them
on both packages with ``run_case``: pytest's own fixtures come from the
calling test, a parametrised case runs once for each of its parameters,
and a class- or module-scoped fixture is kept for the file's later cases
(``shared``).  A case the port cannot run because its subject is XLA
itself stands in its file's ``NOT_PORTED`` with the reason.  The mesh
cases of five of the files are loaded by ``tests/test_torch_mesh_cases.py``
instead, and every group leaves them out case by case.  Here: every case
of the reference files is loaded by exactly one group file or by the
mesh-cases file, or named in exactly one ``NOT_PORTED``; at most 20 are
named; each group file holds at most 40 tests; and every reference file a
port test's docstring names is loaded by some port test.
"""

import ast
import importlib
import inspect
import re
import sys

import pytest

from test_torch_koordlint import (
    TESTS,
    _fixture_params,
    _parameters,
    _parametrize_marks,
    case_name,
    close_shared,
    file_cases,
    rebound,
    run_case,
)
from test_torch_mesh_cases import CASES as MESH_CASES

# the reference files the groups load, in main-path order
REFERENCE_FILES = (
    "test_solver", "test_snapshot", "test_resources", "test_loadaware_profiles",
    "test_plugin_seam", "test_native_bridge", "test_coalesce", "test_journal",
    "test_services_daemon", "test_framework", "test_reservation", "test_chaos_trace",
    "test_obs", "test_trace_export", "test_devprof", "test_prewarm",
    "test_pallas_cycle", "test_wave", "test_scoring",
    "test_terms", "test_score_incremental", "test_resident_warm", "test_candidates",
    "test_bridge", "test_deviceshare", "test_wirecheck", "test_replication",
    "test_degrade", "test_autoscale", "test_slo", "test_trace",
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
    # the Score and Sync path (the mesh cases of these files are loaded by
    # tests/test_torch_mesh_cases.py, and every group leaves them out)
    "terms": (("test_terms", ("TestNumpyOracleParity",)),),
    "terms_wave": (("test_terms", ("TestAssignWaveParity", "TestDirtyAttribution",
                                   "TestTermConfigSurface")),),
    "terms_serving": (("test_terms", ("TestServingBound", "TestTermTraceEvents",
                                      "TestMeshParity")),),
    "incremental": (("test_score_incremental", ("TestParityFuzz", "TestDirtyMechanics",
                                                "TestMaskedTopK", "TestScoreMemoSeam")),),
    "candidates": (("test_candidates", None),
                   ("test_score_incremental", ("TestFollowerIncremental",
                                               "TestIncrementalRetraceBudget"))),
    "warm": (("test_resident_warm", ("TestWarmParityFuzz", "TestResidentMechanics",
                                     "TestEpochContinuity")),),
    "bridge": (("test_bridge", None),
               ("test_resident_warm", ("TestRetraceBudget", "TestCompileCacheSmoke"))),
    # the device plugin, the codec's checker and the host tiers
    "deviceshare": (("test_deviceshare", ("TestNormalization", "TestFit", "TestScore",
                                          "TestAllocateMinors")),),
    "deviceshare_tables": (("test_deviceshare", ("TestPartitionTables", "TestJointAllocation",
                                                 "TestMixedTypeRequests")),),
    "wirecheck": (("test_wirecheck", ("TestDecodeAgainstProtobufRuntime",
                                      "TestReencodeByteParity",
                                      "TestPluginSimEncodingParity")),),
    "wirecheck_delta": (("test_wirecheck", ("TestDeltaFrameNegatives",)),),
    "replication_codec": (("test_replication", ("TestFrameCodec", "TestAdmission",
                                                "TestExport")),),
    "replication_fencing": (("test_replication", ("TestReplicaFencing",
                                                  "TestFollowerTargetParsing",
                                                  "TestUdsTransport")),),
    "replication_tier": (("test_replication", ("TestLossyFuzzParity", "TestFollowerRetrace",
                                               "TestThreeFollowerStorm",
                                               "TestReplicaAwareClient",
                                               "TestClientRetryAndFailover",
                                               "TestSchedulerServerRoles")),),
    "degrade": (("test_degrade", ("TestBandLadder", "TestShedFractionKnobs",
                                  "TestDeadlinePropagation")),),
    "degrade_breaker": (("test_degrade", ("TestCircuitBreaker",)),),
    "degrade_storm": (("test_degrade", ("TestOverloadBandStorm", "TestWireFields")),),
    "autoscale": (("test_autoscale", ("TestPolicy", "TestDecision", "TestTick")),),
    "autoscale_spawn": (("test_autoscale", ("TestRegistrySignals", "TestAutoscaleWave",
                                            "TestSpawnToReady")),),
    "slo": (("test_slo", None),),
    "trace": (("test_trace", None),),
}

NOT_PORTED_CAP = 20


def _case_parameters(case):
    """A case's parameters by name: each ``parametrize`` mark's value at
    the case's index, then each fixture's with ``params``."""
    name, cls, method, param = case
    module = rebound(name, "koordinator_tpu")
    owner = getattr(module, cls) if cls else None
    fn = getattr(owner, method) if cls else getattr(module, method)
    marks = _parametrize_marks(fn, owner)
    got = {}
    for mark, index in zip(marks, param):
        got.update(_parameters(mark, index))
    for fixture, index in zip(_fixture_params(module, owner, fn), param[len(marks):]):
        got[fixture] = getattr(module, fixture)._fixture.params[index]
    return got


def mesh_loaded():
    """The cases ``tests/test_torch_mesh_cases.py`` loads, keyed as
    ``file_cases`` keys them (it gives each its parameters by name)."""
    keys = []
    for name, cls, method, params in MESH_CASES:
        found = [case for case in file_cases(name) if case[1:3] == (cls, method)
                 and _case_parameters(case) == params]
        assert len(found) == 1, (name, cls, method, params, found)
        keys += found
    return keys


def group_cases(group, not_ported=None):
    """The cases ``(module, class, method, param)`` of ``group``, less the
    ones its file names in ``not_ported`` (keyed ``(module, class,
    method)``) and the mesh cases ``tests/test_torch_mesh_cases.py``
    loads."""
    not_ported = not_ported or {}
    mesh = set(mesh_loaded())
    return [case for name, classes in GROUPS[group] for case in file_cases(name)
            if (classes is None or case[1] in classes) and case[:3] not in not_ported
            and case not in mesh]


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
    mesh = mesh_loaded()
    named = [key for module in modules.values() for key in module.NOT_PORTED]
    assert len(loaded) == len(set(loaded))
    assert len(mesh) == len(set(mesh)) == len(MESH_CASES)
    assert len(named) == len(set(named)) <= NOT_PORTED_CAP
    # the group files and the mesh-cases file together load every case of
    # every reference file once, but those named
    assert len(REFERENCE_FILES) == len(set(REFERENCE_FILES))
    every = [case for name in REFERENCE_FILES for case in file_cases(name)]
    assert sorted(loaded + mesh + [c for c in every if c[:3] in set(named)]) == sorted(every)
    assert not {c[:3] for c in loaded + mesh} & set(named)
    # each group takes only whole classes of the files it names, less the
    # mesh cases, and each class of a reference file is in exactly one group
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


def _named_as_mirrored(path):
    """The reference test files a port test file's docstring names: each
    ``test_<name>.py`` of ``tests/`` that is not the port's."""
    doc = ast.get_docstring(ast.parse(path.read_text())) or ""
    return {name for name in re.findall(r"\btest_(\w+)\.py\b", doc)
            if not name.startswith("torch_") and (TESTS / f"test_{name}.py").exists()}


# where a port test names a reference file it loads: a loader's first
# argument, a group's ``(file, classes)`` entry, a module constant, a
# ``(file, class, method)`` case, or an import of the reference module
_LOADS = re.compile(r'\b(?:rebound|run_case|reference_cases|param_cases|file_cases)\(\s*'
                    r'"(test_\w+)"'
                    r'|\(\s*"(test_\w+)",\s*(?:None|\(|"Test)'
                    r'|\bNAME = "(test_\w+)"'
                    r'|^\s*(?:from (test_\w+) import|import (test_\w+))', re.M)


def _loaded_by_a_port_test():
    """The reference test files some port test loads (``_LOADS``)."""
    names = set()
    for path in TESTS.glob("test_torch_*.py"):
        names |= {name for found in _LOADS.findall(path.read_text()) for name in found
                  if name and not name.startswith("test_torch_")
                  and (TESTS / f"{name}.py").exists()}
    return {name[len("test_"):] for name in names}


def test_every_reference_file_a_port_test_names_is_loaded():
    loaded = _loaded_by_a_port_test()
    # the reference's bench.py budgets: the port has no bench.py
    unloaded = {"bench_budget"}
    missing = {}
    for path in sorted(TESTS.glob("test_torch_*.py")):
        named = _named_as_mirrored(path) - loaded - unloaded
        if named:
            missing[path.name] = sorted(named)
    assert missing == {}
