"""A short run of each cell on the card: ``correct`` true and the result's
shape.  Runs where CUDA is present: ``python -m pytest kbench/tests -m card``."""

import json
import subprocess
import sys

import pytest

from kbench import manifest


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "kbench.run", "--workload", cell, "--seed", "2147483659",
         "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=str(manifest.ROOT), check=False)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
