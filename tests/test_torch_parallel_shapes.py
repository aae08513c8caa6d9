"""The awkward shapes and the tight capacity of ``tests/test_parallel.py``
(``TestWaveAwkwardShapes``, ``TestWaveTightCapacity``) through both
packages: non-power-of-two meshes, one-node shards, a wave wider than the
pods left, and identical pods racing for one-pod nodes.  The port runs
them on CPU meshes of the same sizes (``tests/test_torch_parallel.py``
says how the reference module is rebound)."""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_koordlint import run_case
from test_torch_parallel import case_id, param_cases

CASES = param_cases("test_parallel", ("TestWaveAwkwardShapes", "TestWaveTightCapacity"))


def test_the_reference_cases_are_collected():
    assert len(CASES) == 19
    assert len(PACKAGES) * len(CASES) <= 40


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package):
    module, cls, method, params = case
    run_case(module, cls, method, package, **params)
