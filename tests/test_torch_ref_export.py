"""The reference's ``tests/test_trace_export.py`` cases of the span
exporter and the assembler, and ``tests/test_prewarm.py``, on both
packages.  A test function under a launch boundary is, on the port's leg,
a torch function that builds a kernel on a new signature
(``test_torch_koordlint.py _kernel_like``), where the reference's is a
``jax.jit`` program.

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

# the XLA ahead-of-time capture and its replay: the port compiles no
# program at run time, and its prewarm rebuilds kernel variants instead
# (``obs/prewarm.py``, held by ``tests/test_torch_daemon.py``)
_AOT_CAPTURE = ("XLA AOT capture and replay of pickled jax.ShapeDtypeStruct signatures "
                "(devprof.configure(capture=), replay_records, load_replays, load_prewarm, "
                "dump_prewarm, prewarm.pkl)")

NOT_PORTED = {
    ("test_prewarm", cls, method): _AOT_CAPTURE for cls, method in (
        ("TestCaptureRoundTrip", "test_capture_records_abstract_specs_in_hot_order"),
        ("TestCaptureRoundTrip", "test_new_signature_flushes_prewarm_pkl_synchronously"),
        ("TestCaptureRoundTrip", "test_unpicklable_static_degrades_to_non_replayable"),
        ("TestCaptureRoundTrip", "test_load_replays_merges_without_forgetting"),
        ("TestCaptureRoundTrip", "test_missing_or_corrupt_file_is_an_empty_set"),
        ("TestBitInertOff", "test_off_path_records_nothing"),
        ("TestPrewarmRunner", "test_replays_prior_incarnation_across_reset"),
        ("TestPrewarmRunner", "test_replay_set_survives_the_next_dump"),
        ("TestPrewarmRunner", "test_unresolvable_and_corrupt_records_are_counted"),
        ("TestJournalRecoverWithPrewarm", "test_recover_with_prewarm_matches_serial_restart"),
    )
}
CASES = group_cases("export", NOT_PORTED)


def test_the_file_holds_at_most_forty_tests():
    check_group_file(__name__)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, shared, tmp_path, tmp_path_factory, monkeypatch,
                        capsys):
    run_reference_case(case, package, shared, tmp_path=tmp_path,
                       tmp_path_factory=tmp_path_factory, monkeypatch=monkeypatch,
                       capsys=capsys)
