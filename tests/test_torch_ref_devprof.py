"""The reference's ``tests/test_devprof.py`` (the launch ledger) on both
packages.  A test function under a launch boundary is, on the port's leg,
a torch function that builds a kernel on a new signature
(``test_torch_koordlint.py _kernel_like``), where the reference's is a
``jax.jit`` program that compiles; ``_PORT_EDITS["test_devprof"]`` states
the rest.

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

NOT_PORTED = {
    ("test_devprof", "TestNestedTraceBypass", "test_boundary_under_a_live_trace_is_unmeasured"):
        "fails in the reference on every run; the port measures only the outermost "
        "boundary (obs/devprof.py), which tests/test_torch_devprof.py pins; a rebound "
        "reference leg would add a known failure",
}
CASES = group_cases("devprof", NOT_PORTED)


def test_the_file_holds_at_most_forty_tests():
    check_group_file(__name__)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, shared, tmp_path, tmp_path_factory, monkeypatch,
                        capsys):
    run_reference_case(case, package, shared, tmp_path=tmp_path,
                       tmp_path_factory=tmp_path_factory, monkeypatch=monkeypatch,
                       capsys=capsys)
