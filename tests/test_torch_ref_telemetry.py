"""The reference's ``tests/test_obs.py::TestServicerTelemetry`` and
``tests/test_trace_export.py::TestEndToEnd`` (one traced tier shared by its
cases, as the reference's module-scoped fixture shares it) on both
packages; and the real cycle's families in the port's idiom.

Each case runs through the rebinding of ``tests/test_torch_koordlint.py``
(``tests/test_torch_ref.py`` says how).
"""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_ref import (  # noqa: F401  (``shared`` is a fixture)
    case_id,
    check_group_file,
    group_cases,
    run_reference_case,
    shared,
)
from test_torch_koordlint import rebound
from koordinator_tpu_torch.bridge import wire

NOT_PORTED = {
    ("test_obs", "TestServicerTelemetry", "test_real_cycle_populates_scorer_families"):
        "asserts that the first cycle's XLA compiles show as jit cache misses; the port "
        "compiles no program at run time (mirrored below without it)",
}
CASES = group_cases("telemetry", NOT_PORTED)


def test_the_file_holds_at_most_forty_tests():
    check_group_file(__name__)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, shared, tmp_path, tmp_path_factory, monkeypatch,
                        capsys):
    run_reference_case(case, package, shared, tmp_path=tmp_path,
                       tmp_path_factory=tmp_path_factory, monkeypatch=monkeypatch,
                       capsys=capsys)


def test_a_real_cycle_populates_the_scorer_families(tmp_path):
    """``TestServicerTelemetry::test_real_cycle_populates_scorer_families``
    in the port's idiom: the same servicer, cycle and families, and no
    jit cache miss, since the port compiles nothing at run time."""
    ref = rebound("test_obs", "koordinator_tpu_torch")
    sv, _state, reply = ref._servicer(str(tmp_path))
    rep = sv.assign(wire.AssignRequest(snapshot_id=reply.snapshot_id))
    reg = sv.telemetry.registry
    count, total = reg.get_histogram("koord_scorer_cycle_latency_ms",
                                     {"path": rep.path, "wave": "1"})
    assert count == 1 and total > 0
    assert reg.get("koord_scorer_cycles_total", {"path": rep.path}) == 1
    assert reg.get("koord_scorer_sync_total", {"kind": "full"}) == 1
    assert reg.get("koord_scorer_snapshot_generation") == 1
    text = reg.render()
    assert "koord_scorer_jit_cache_miss_total" not in text
    assert text.count("# TYPE koord_scorer_cycle_latency_ms histogram") == 1
