"""The cases of ``tests/test_device_annotation_e2e.py``, the CRI proxy, docker proxy and remote hook classes of ``tests/test_servers_ha.py`` and the runtime proxy class of ``tests/test_webhook_features_proxy.py`` on both packages, through the rebinding of
``tests/test_torch_koordlint.py`` (group ``proxy`` of
``tests/test_torch_koordlet.py``)."""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_koordlet import group_cases
from test_torch_koordlint import run_case

CASES = group_cases("proxy")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, monkeypatch):
    run_case(module, cls, method, package, tmp_path=tmp_path, monkeypatch=monkeypatch)
