"""The reference's control-plane cases of group ``runtime`` of
``tests/test_torch_controlplane.py`` on both packages, through the rebinding
of ``tests/test_torch_koordlint.py``."""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_controlplane import group_cases
from test_torch_koordlint import run_case

CASES = group_cases("runtime")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, monkeypatch):
    run_case(module, cls, method, package, tmp_path=tmp_path, monkeypatch=monkeypatch)
