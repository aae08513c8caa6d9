"""The reference's ``tests/test_degrade.py::TestCircuitBreaker`` on both
packages (``bridge/server.py``'s circuit breaker and ``bridge/client.py``).

Each case runs through the rebinding of ``tests/test_torch_koordlint.py``
(``tests/test_torch_ref.py`` says how).
"""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_koordlint import rebound
from test_torch_ref import (  # noqa: F401  (``shared`` is a fixture)
    case_id,
    check_group_file,
    group_cases,
    run_reference_case,
    shared,
)

NOT_PORTED = {}
CASES = group_cases("degrade_breaker", NOT_PORTED)


@pytest.fixture(scope="module")
def warm():
    """A Score, a delta Sync and a Score on each package before the cases.
    ``test_brownout_serves_degraded_within_bound`` runs that sequence
    inside the breaker's 60 ms cooldown; the JAX package compiles its
    delta-Sync program on the first such Sync (about 70 ms on the CPU), and
    the reference's case fails run on its own.  A process that ran earlier
    files has compiled it; this file warms it up itself."""
    for package in PACKAGES:
        ref = rebound("test_degrade", package)
        sv = ref.servicer()
        ref._score(sv)
        sv.sync(ref._delta_sync_request())
        ref._score(sv)
        sv.telemetry.close()


def test_the_file_holds_at_most_forty_tests():
    check_group_file(__name__)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, shared, warm, tmp_path, tmp_path_factory, monkeypatch,
                        capsys):
    run_reference_case(case, package, shared, tmp_path=tmp_path,
                       tmp_path_factory=tmp_path_factory, monkeypatch=monkeypatch,
                       capsys=capsys)
