"""The reference's ``tests/test_autoscale.py`` policy, decision and tick
cases on both packages (``replication/autoscale.py``).

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

NOT_PORTED = {}
CASES = group_cases("autoscale", NOT_PORTED)


def test_the_file_holds_at_most_forty_tests():
    check_group_file(__name__)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, shared, tmp_path, tmp_path_factory, monkeypatch,
                        capsys):
    run_reference_case(case, package, shared, tmp_path=tmp_path,
                       tmp_path_factory=tmp_path_factory, monkeypatch=monkeypatch,
                       capsys=capsys)
