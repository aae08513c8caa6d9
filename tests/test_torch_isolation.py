"""The PyTorch port runs where JAX is absent: it imports neither ``jax`` nor
the JAX package, and ``chip_smoke.py`` refuses to run without a CUDA card or
without the port beside it."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "koordinator_tpu_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "koordinator_tpu")


def test_no_source_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


_ISOLATED = r"""
import json, sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import koordinator_tpu_torch
import koordinator_tpu_torch.solver
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.config import CycleConfig
from koordinator_tpu_torch.solver import run_cycle
snap = generators.quota_colocation_snapshot(pods=24, nodes=6, device="cpu")[0]
res = run_cycle(snap)
wave = run_cycle(snap, CycleConfig(wave=8, top_m=2))
loaded = sorted(m for m in sys.modules
                if m == "koordinator_tpu" or m.startswith("koordinator_tpu."))
print(json.dumps({"placed": int((res.assignment >= 0).sum()), "path": res.path,
                  "wave_path": wave.path, "wave_rounds": int(wave.rounds) > 0,
                  "same": bool((wave.assignment == res.assignment).all()),
                  "port_modules": sorted(m for m in sys.modules
                                         if m.startswith("koordinator_tpu_torch.solver.")),
                  "reference_modules": loaded}))
"""


def test_port_runs_a_cycle_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATED], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ported = got.pop("port_modules")
    assert got == {"placed": 24, "path": "scan", "wave_path": "wave", "wave_rounds": True,
                   "same": True, "reference_modules": []}
    for mod in ("dense", "greedy", "wave", "wide"):
        assert f"koordinator_tpu_torch.solver.{mod}" in ported


def test_chip_smoke_needs_the_port_beside_it(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        # on a card the script runs for real; its no-card branch is what
        # this test covers, so check only that it is there
        assert "torch.cuda.is_available()" in (REPO / "chip_smoke.py").read_text()
        return
    code = (
        "import sys, runpy; sys.modules['jax'] = None; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr
