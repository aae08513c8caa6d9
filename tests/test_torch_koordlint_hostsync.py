"""The ``host-sync-in-jit`` and ``unregistered-jit-boundary`` cases of
``tests/test_koordlint.py`` (``TestHostSyncInJit``, ``TestHostSyncObsAPI``,
``TestUnregisteredJitBoundary``) mirrored in the port's idiom, as
``tests/test_torch_koordlint_devrules.py`` mirrors the donation and
retrace cases; the check that every reference case of the seven
device-discipline classes is rebound or mirrored; and one seeded
regression per rule in the port's real tree.

A device program here is a ``@devprof.boundary`` function or a kernel
launcher (an ``_build.entry`` called with a CUDA stream).  In PyTorch a
span inside a boundary runs on every call, so it is legal; the obs API's
hazard is a ``.note()`` of a live tensor value.
"""

import textwrap
from pathlib import Path

import pytest

from koordinator_tpu_torch.analysis import prewarmdrift, suppressions
from koordinator_tpu_torch.analysis.core import run_rules_on_source
from test_torch_koordlint import GROUPS, PORT, REPO, reference_cases
from test_torch_koordlint_devrules import H, MIRRORS as DEVRULES_MIRRORS, Mirror

B = ("unregistered-jit-boundary",)
SOLVER = f"{PORT}/solver/fixture.py"

_LAUNCHER_HEAD = """
import functools
import torch
from koordinator_tpu_torch import _build
from koordinator_tpu_torch.obs import devprof
"""


def _launcher(src):
    """A serving-path fixture: the imports above, then ``src``."""
    return _LAUNCHER_HEAD + textwrap.dedent(src)


HOSTSYNC = {
    "test_all_four_sync_shapes": Mirror("""
        import numpy as np, torch
        from koordinator_tpu_torch.obs import devprof
        @devprof.boundary("solver.fixture.f")
        def f(x: torch.Tensor):
            y = np.asarray(x)
            z = x.item()
            w = int(torch.max(x))
            torch.cuda.synchronize()
            return y, z, w
        """, tuple(("host-sync-in-jit", n) for n in (6, 7, 8, 9)), H),
    "test_closure_scanned_once_nested_jit_not_double_reported": Mirror("""
        import numpy as np, torch
        from koordinator_tpu_torch.obs import devprof
        @devprof.boundary("solver.fixture.outer")
        def outer(x: torch.Tensor):
            def step(v):
                bad = v.cpu()
                return bad
            return [step(r) for r in x]

        @devprof.boundary("solver.fixture.parent")
        def parent(x: torch.Tensor):
            @devprof.boundary("solver.fixture.inner")
            def inner(y: torch.Tensor):
                return np.asarray(y)
            return inner(x)
        """, (("host-sync-in-jit", 7), ("host-sync-in-jit", 15)), H,
        contains=(("outer()", 1), ("inner()", 1))),
    "test_host_side_int_is_clean": Mirror("""
        import torch
        from koordinator_tpu_torch.obs import devprof
        @devprof.boundary("solver.fixture.f")
        def f(x: torch.Tensor, k):
            n = int(x.shape[0])
            m = int(SomeEnum.PROD)
            return x[:n] + m
        """, (), H),
}

OBS = {
    "test_obs_calls_in_jit_caught": Mirror("""
        import torch
        from koordinator_tpu_torch.obs import devprof
        @devprof.boundary("solver.fixture.cycle")
        def cycle(x: torch.Tensor, spans):
            spans.note("peak", x.max())
            try:
                y = x + 1
            finally:
                spans.note("y", y)
            with spans.span("scale", rows=int(y.sum())):
                y = y * 2
            spans.note("rounds", y)
            return y
        """, tuple(("host-sync-in-jit", n) for n in (6, 10, 11, 13)), H,
        contains=(("obs .note() of a tensor value", 3),)),
    "test_telemetry_receiver_chain_caught": Mirror("""
        import torch
        from koordinator_tpu_torch.obs import devprof
        @devprof.boundary("solver.fixture.cycle")
        def cycle(x: torch.Tensor, self):
            self.telemetry.spans.note("path", x.argmax())
            return x
        """, (("host-sync-in-jit", 6),), H),
    "test_obs_outside_jit_is_clean": Mirror("""
        def serve(recorder, snap):
            with recorder.span("dispatch"):
                result = run_cycle(snap)
            recorder.note("path", result.assignment.sum())
            return result
        """, (), H),
    "test_unrelated_span_named_method_is_clean": Mirror("""
        import torch
        from koordinator_tpu_torch.obs import devprof
        @devprof.boundary("solver.fixture.f")
        def f(x: torch.Tensor, tree):
            with tree.span(x):
                y = x * 2
            tree.note(y)
            return y
        """, (), H),
}

DEVBOUND = {
    "test_unregistered_jitted_def_fires": Mirror(_launcher("""
        def _launch(inp):
            fn = _build.entry("solver/cycle_cuda.cu", "koord_cycle_launch", [])
            return fn(inp.data_ptr(), torch.cuda.current_stream().cuda_stream)
        """), (("unregistered-jit-boundary", 7),), B, SOLVER,
        contains=(("no @devprof.boundary", 1),)),
    "test_registered_jitted_def_is_clean": Mirror(_launcher("""
        @devprof.boundary("solver.fixture._launch")
        def _launch(inp):
            fn = _build.entry("solver/cycle_cuda.cu", "koord_cycle_launch", [])
            return fn(inp.data_ptr(), torch.cuda.current_stream().cuda_stream)
        """), (), B, SOLVER),
    "test_boundary_below_jit_fires_order_violation": Mirror(_launcher("""
        @functools.lru_cache(maxsize=None)
        @devprof.boundary("solver.fixture._launch")
        def _launch(inp):
            fn = _build.entry("solver/cycle_cuda.cu", "koord_cycle_launch", [])
            return fn(inp.data_ptr(), torch.cuda.current_stream().cuda_stream)
        """), (("unregistered-jit-boundary", 9),), B, SOLVER,
        contains=(("not the outermost", 1),)),
    "test_non_literal_boundary_name_fires": Mirror(_launcher("""
        NAME = "solver.fixture._launch"

        @devprof.boundary(NAME)
        def _launch(inp):
            fn = _build.entry("solver/cycle_cuda.cu", "koord_cycle_launch", [])
            return fn(inp.data_ptr(), torch.cuda.current_stream().cuda_stream)
        """), (("unregistered-jit-boundary", 10),), B, SOLVER,
        contains=(("string literal", 1),)),
    "test_jit_call_form_assignment_fires": Mirror(_launcher("""
        _LAUNCH = _build.entry("solver/cycle_cuda.cu", "koord_cycle_launch", [])
        """), (("unregistered-jit-boundary", 7),), B, SOLVER,
        contains=(("module-level", 1),)),
    "test_shard_map_outside_jit_fires": Mirror("""
        from torch.distributed.tensor.experimental import local_map

        def helper(mesh, x):
            return local_map(
                lambda a: a, out_placements=None, in_placements=None, device_mesh=mesh,
            )(x)
        """, (("unregistered-jit-boundary", 5),), B, SOLVER,
        contains=(("per-shard launch", 1),)),
    "test_shard_map_inside_registered_jit_is_clean": Mirror("""
        from torch.distributed.tensor.experimental import local_map
        from koordinator_tpu_torch.obs import devprof

        @devprof.boundary("solver.fixture._sharded")
        def _sharded(x, *, mesh):
            return local_map(
                lambda a: a, out_placements=None, in_placements=None, device_mesh=mesh,
            )(x)
        """, (), B, SOLVER),
    "test_out_of_scope_module_is_exempt": Mirror(_launcher("""
        def scenario_kernel(inp):
            fn = _build.entry("solver/cycle_cuda.cu", "koord_cycle_launch", [])
            return fn(inp.data_ptr(), torch.cuda.current_stream().cuda_stream)
        """), (), B, f"{PORT}/harness/fixture.py"),
    "test_suppression_with_reason_is_honored": Mirror(_launcher("""
        # koordlint: disable=unregistered-jit-boundary(reason: a cold-path migration helper, never on the serving path)
        def _migrate(inp):
            fn = _build.entry("solver/cycle_cuda.cu", "koord_cycle_launch", [])
            return fn(inp.data_ptr(), torch.cuda.current_stream().cuda_stream)
        """), (), B, SOLVER),
}

MIRRORS = {
    **{("TestHostSyncInJit", m): case for m, case in HOSTSYNC.items()},
    **{("TestHostSyncObsAPI", m): case for m, case in OBS.items()},
    **{("TestUnregisteredJitBoundary", m): case for m, case in DEVBOUND.items()},
}
# a reference case whose torch counterpart is a check of the port's rule
# set rather than a fixture
CHECKS = {("TestUnregisteredJitBoundary", "test_reason_required_for_suppression")}
DEVICE_CLASSES = ("TestDonationSafety", "TestRetraceHazard", "TestTermConfigRule",
                  "TestHostSyncInJit", "TestHostSyncObsAPI", "TestUnregisteredJitBoundary",
                  "TestPrewarmDrift")


@pytest.mark.parametrize("ref", sorted(MIRRORS), ids=["::".join(k) for k in sorted(MIRRORS)])
def test_torch_case(ref):
    MIRRORS[ref].run()


def test_reason_required_for_suppression():
    assert "unregistered-jit-boundary" in suppressions.REASON_REQUIRED


def test_a_host_only_entry_is_classified_not_flagged():
    """An entry taken and called with no CUDA stream (the ``koord_*_plan``
    occupancy queries) launches nothing: no boundary is needed."""
    Mirror(_launcher("""
        def plan(inp):
            fn = _build.entry("solver/cycle_cuda.cu", "koord_cycle_plan", [])
            return read_plan(fn, inp.shape[0])
        """), (), B, SOLVER).run()


def test_a_launch_through_the_launch_table_is_a_device_program():
    """``_build.launch`` takes the entry itself: handed a CUDA stream it
    launches, and needs a boundary; ``_build.call`` with no stream (a plan
    query) launches nothing."""
    Mirror(_launcher("""
        def _launch(inp):
            _build.launch("k", "solver/cycle_cuda.cu", "koord_cycle_launch", [],
                          inp.data_ptr(), torch.cuda.current_stream().cuda_stream)

        def plan(inp):
            return _build.call("solver/cycle_cuda.cu", "koord_cycle_plan", [], inp.shape[0])
        """), (("unregistered-jit-boundary", 7),), B, SOLVER,
        contains=(("_launch()", 1),)).run()


def test_a_launch_table_define_built_from_a_call_argument_fires():
    Mirror(_launcher("""
        @devprof.boundary("solver.fixture._launch")
        def _launch(inp, wave):
            _build.launch("k", "solver/cycle_cuda.cu", "koord_cycle_launch", [],
                          inp.data_ptr(), torch.cuda.current_stream().cuda_stream,
                          defines=(f"WAVE={wave}",))
        """), (("retrace-hazard", 9),), ("retrace-hazard",), SOLVER,
        contains=(("'wave'", 1),)).run()


def test_every_reference_case_is_rebound_or_mirrored():
    """The 59 cases of the seven device-discipline classes: the two
    classes without a JAX idiom run on both packages (group ``device``),
    every other case has a torch case of its own."""
    cases = {(c[1], c[2]) for c in reference_cases("test_koordlint", DEVICE_CLASSES)}
    assert len(cases) == 59
    rebound = {c for c in cases if c[0] in GROUPS["device"]}
    mirrored = set(MIRRORS) | set(DEVRULES_MIRRORS) | CHECKS
    assert cases - rebound == mirrored
    assert not rebound & mirrored


# -- seeded regressions in the port's real tree --

def _edit(rel, old, new):
    text = (Path(REPO) / rel).read_text()
    assert text.count(old) == 1, (rel, old)
    return text, text.replace(old, new)


def _fires(rel, old, new, rule):
    """``rule`` is clean on the file as it is and fires on the edit."""
    text, edited = _edit(rel, old, new)
    assert run_rules_on_source(rel, text, [rule]) == []
    got = run_rules_on_source(rel, edited, [rule])
    assert got and all(v.rule == rule for v in got), got
    return got


def test_a_deleted_boundary_decorator_fires():
    got = _fires(f"{PORT}/solver/wide.py",
                 '@devprof.boundary("solver.wide.cycle_wide_cuda")\n', "",
                 "unregistered-jit-boundary")
    assert ["cycle_wide_cuda()" in v.message for v in got] == [True]


def test_a_dropped_prewarm_row_fires():
    rel = f"{PORT}/obs/prewarm.py"
    text, edited = _edit(rel, '    "solver.wide.wave_cycle_cuda",\n', "")
    regs = prewarmdrift.repo_registrations(REPO)
    assert prewarmdrift.diff_prewarm(regs, text) == []
    got = prewarmdrift.diff_prewarm(regs, edited)
    assert [(v.path, "solver.wide.wave_cycle_cuda" in v.message) for v in got] == [
        (f"{PORT}/solver/wide.py", True)]


def test_an_item_in_score_cycle_fires():
    got = _fires(f"{PORT}/solver/greedy.py", "    return score_all(snapshot, cfg)\n",
                 "    scores, feasible = score_all(snapshot, cfg)\n"
                 "    _ = scores.sum().item()\n"
                 "    return scores, feasible\n", "host-sync-in-jit")
    assert len(got) == 1 and "score_cycle()" in got[0].message


def test_a_define_built_from_wave_fires():
    got = _fires(f"{PORT}/solver/wide.py",
                 'rounds.data_ptr(),\n'
                 '                      torch.cuda.current_stream(dev).cuda_stream, defines=defines)',
                 'rounds.data_ptr(),\n'
                 '                      torch.cuda.current_stream(dev).cuda_stream,\n'
                 '                      defines=tuple(defines) + (f"KOORD_WAVE={wave}",))',
                 "retrace-hazard")
    assert len(got) == 1 and "'wave'" in got[0].message


def test_a_pre_delta_alias_read_after_apply_flat_delta_fires():
    got = _fires(f"{PORT}/bridge/state.py",
                 "                return apply_flat_delta(dev_arr, update[1], update[2], mesh=mesh)\n",
                 "                before = dev_arr.view(-1)\n"
                 "                out = apply_flat_delta(dev_arr, update[1], update[2], mesh=mesh)\n"
                 "                self._pre_delta_sum = before.sum()\n"
                 "                return out\n", "donation-safety")
    assert len(got) == 1 and "'before' aliases 'dev_arr'" in got[0].message


# -- the multi-device path's real sites (``parallel/``): shape 5 of
#    unregistered-jit-boundary and shape 4 of retrace-hazard --

SHARD_ASSIGN = f"{PORT}/parallel/shard_assign.py"


@pytest.mark.parametrize("boundary,calls", [("_assign_waves", 2), ("_assign_sharded", 2)])
def test_a_shard_map_outside_its_boundary_fires(boundary, calls):
    got = _fires(SHARD_ASSIGN, f'@devprof.boundary("parallel.shard_assign.{boundary}")\n', "",
                 "unregistered-jit-boundary")
    assert len(got) == calls
    assert all("per-shard launch (local_map/shard_map)" in v.message for v in got)


@pytest.mark.parametrize("knob", ["mesh", "n_shards"])
def test_a_mesh_knob_in_a_per_shard_body_fires(knob):
    got = _fires(SHARD_ASSIGN, "    def apply_body(nreq, nest, choices, committed, preq, pest):\n",
                 f"    def apply_body(nreq, nest, choices, committed, preq, pest, {knob}=None):\n",
                 "retrace-hazard")
    assert len(got) == 1 and f"apply_body() takes '{knob}'" in got[0].message
