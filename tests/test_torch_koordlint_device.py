"""The term-config shape of ``retrace-hazard`` (``TestTermConfigRule``) and
the ``prewarm-drift`` rule (``TestPrewarmDrift``): their cases of
``tests/test_koordlint.py`` on both packages, through the rebinding of
``tests/test_torch_koordlint.py`` (group ``device``).  Neither class
carries a JAX idiom; the port's rules read the same fixtures, and
``TestPrewarmDrift``'s repo cases read the port's tree."""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_koordlint import group_cases, run_case

CASES = group_cases("device")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c[1:]) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, capsys):
    run_case(module, cls, method, package, tmp_path=tmp_path, capsys=capsys)
