"""The cases of the node agent's sysfs, metric cache, collectors, NodeMetric report, executor and CPU suppression classes of ``tests/test_koordlet.py`` on both packages, through the rebinding of
``tests/test_torch_koordlint.py`` (group ``agent`` of
``tests/test_torch_koordlet.py``)."""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_koordlet import group_cases
from test_torch_koordlint import run_case

CASES = group_cases("agent")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, monkeypatch):
    run_case(module, cls, method, package, tmp_path=tmp_path, monkeypatch=monkeypatch)
