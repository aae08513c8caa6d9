"""The cases of the QoS strategy, runtime hook, prediction, PLEG, audit, daemon and resctrl classes of ``tests/test_koordlet.py`` on both packages, through the rebinding of
``tests/test_torch_koordlint.py`` (group ``qos`` of
``tests/test_torch_koordlet.py``)."""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_koordlet import group_cases
from test_torch_koordlint import run_case

CASES = group_cases("qos")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, monkeypatch):
    run_case(module, cls, method, package, tmp_path=tmp_path, monkeypatch=monkeypatch)
