"""The reference's ``tests/test_terms.py`` Assign and dirty cases on both
packages: ``TestAssignWaveParity`` (the terms folded into the cycle's
extras, K2 and K3 on the port's leg through their plain versions),
``TestDirtyAttribution`` (the term rescore's dirty rows) and
``TestTermConfigSurface``.

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
CASES = group_cases("terms_wave", NOT_PORTED)


def test_the_file_holds_at_most_forty_tests():
    check_group_file(__name__)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, shared, tmp_path, tmp_path_factory, monkeypatch,
                        capsys):
    run_reference_case(case, package, shared, tmp_path=tmp_path,
                       tmp_path_factory=tmp_path_factory, monkeypatch=monkeypatch,
                       capsys=capsys)
