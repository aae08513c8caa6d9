"""The lock-order cycle and LOCKORDER.md drift rules' and the suppression audit's cases of
``tests/test_koordlint.py`` on both packages, through the rebinding of
``tests/test_torch_koordlint.py`` (group ``lockorder``)."""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_koordlint import group_cases, run_case

CASES = group_cases("lockorder")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c[1:]) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, capsys):
    run_case(module, cls, method, package, tmp_path=tmp_path, capsys=capsys)
