"""The reference's ``tests/test_bridge.py`` (the seam through the client,
less its two mesh cases, loaded by ``tests/test_torch_mesh_cases.py``) and
``tests/test_resident_warm.py``'s ``TestRetraceBudget`` (less its mesh
case) and ``TestCompileCacheSmoke`` on both packages.  A retrace budget is
the port's build ledger: no kernel built and no demotion.

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

# the subject is XLA's persistent compilation cache: a second process
# finds the first's compiled cycle (``KOORD_XLA_CACHE``,
# ``configure_compilation_cache``); the port builds no kernel on the CPU,
# and the card's counterpart (a second boot reusing the kernel build
# directory) is ``chip_smoke.py``'s ``coldstart`` line
_XLA_CACHE = "XLA's persistent compilation cache (jax_compilation_cache_dir)"
NOT_PORTED = {
    ("test_resident_warm", "TestCompileCacheSmoke", "test_second_process_reuses_cache_entry"):
        _XLA_CACHE + ": a second process reuses the first's compiled cycle",
    ("test_resident_warm", "TestCompileCacheSmoke",
     "test_configure_compilation_cache_env_override_wins"):
        _XLA_CACHE + ": KOORD_XLA_CACHE wins over configure_compilation_cache",
}
CASES = group_cases("bridge", NOT_PORTED)


def test_the_file_holds_at_most_forty_tests():
    check_group_file(__name__)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, shared, tmp_path, tmp_path_factory, monkeypatch,
                        capsys):
    run_reference_case(case, package, shared, tmp_path=tmp_path,
                       tmp_path_factory=tmp_path_factory, monkeypatch=monkeypatch,
                       capsys=capsys)
