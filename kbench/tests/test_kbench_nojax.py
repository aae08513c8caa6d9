"""The run's check for JAX and the JAX package, on both sides."""

import sys
import types

import pytest

from kbench import run


@pytest.mark.parametrize("name, found", [
    ("jax", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]), ("flax.linen", ["flax"]),
    ("koordinator_tpu", ["koordinator_tpu"]), ("koordinator_tpu.solver", ["koordinator_tpu"]),
    ("koordinator_tpu_torch.solver", []), ("jax_like", []), ("koordinator_tpux", []),
])
def test_top_level_names_compared_whole(monkeypatch, name, found):
    for key in [k for k in sys.modules if k.split(".")[0] in run.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == found


def test_the_harness_loads_no_jax():
    import subprocess

    code = ("import sys, kbench.run, kbench.serve, kbench.control, kbench.gen.tenants, "
            "koordinator_tpu_torch.bridge.server, koordinator_tpu_torch.bridge.client;"
            "from kbench.run import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(run.manifest.ROOT))
    assert out.stdout.strip() == "[]"
