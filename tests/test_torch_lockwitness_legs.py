"""The three integration legs of ``tests/test_lockwitness.py`` on both
packages, the witness armed on each package's derived order: the
chaos-trace replay, the witnessed servicer's replies byte-equal to the
plain ones, and the three-follower storm (the rebinding is
``tests/test_torch_lockwitness.py``'s)."""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_lockwitness import run_witness_case, witness_cases

CASES = witness_cases(legs=True)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c[1:]) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, monkeypatch):
    run_witness_case(module, cls, method, package, tmp_path, monkeypatch)
