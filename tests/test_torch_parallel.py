"""The port's multi-device path (``koordinator_tpu_torch/parallel/``) held
against the JAX package.

The reference's ``tests/test_parallel.py`` runs through both packages: the
reference module is loaded a second time bound to the port
(``test_torch_koordlint.rebound``; its edits in ``_PORT_EDITS`` name the
port's mesh objects), and its 8-device cases run on an 8-shard CPU mesh
(``[torch.device("cpu")] * 8``, the count ``visible_devices("cpu")`` reads
from the forced host platform the test configuration exports).  This file
holds the module-level cases and ``TestWaveRounds``;
``test_torch_parallel_shapes.py`` the awkward shapes and the tight
capacity; ``test_torch_parallel_parity.py`` the seeded parity of both
packages' sharded cycles.
"""

import pytest

from test_torch_constraints import PACKAGES
from test_torch_koordlint import rebound, run_case


def param_cases(name, classes):
    """``(module, class, method, params)`` of every case of the reference
    module ``tests/<name>.py`` in ``classes`` (``""`` for its module-level
    functions), one per parametrize combination."""
    module = rebound(name, "koordinator_tpu")
    out = []
    for cls_name in classes:
        owner = getattr(module, cls_name) if cls_name else module
        fns = vars(owner) if cls_name else {
            k: v for k, v in vars(module).items() if callable(v)}
        for method in sorted(fns):
            if not method.startswith("test_"):
                continue
            combos = [{}]
            for mark in getattr(fns[method], "pytestmark", []):
                if mark.name != "parametrize":
                    continue
                names = [n.strip() for n in mark.args[0].split(",")]
                combos = [
                    {**c, **dict(zip(names, v if len(names) > 1 else (v,)))}
                    for c in combos for v in mark.args[1]
                ]
            out.extend((name, cls_name, method, c) for c in combos)
    return out


def case_id(case):
    module, cls, method, params = case
    tail = "-".join(str(v) for v in params.values())
    return "::".join(p for p in (module, cls, method) if p) + (f"[{tail}]" if tail else "")


CASES = param_cases("test_parallel", ("", "TestWaveRounds"))


def test_the_reference_cases_are_collected():
    assert len(CASES) == 13
    assert len(PACKAGES) * len(CASES) <= 40


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package):
    module, cls, method, params = case
    run_case(module, cls, method, package, **params)
