"""The reference's mesh cases outside ``test_parallel.py`` and
``test_mesh_resident.py``, through both packages (the reference module
rebound as ``tests/test_torch_parallel.py`` says):

* ``test_bridge.py``: the mesh-backed Assign (``path="shard"``, equal to
  the single-device sidecar, a 1-device mesh honoured) and the shard
  fault's fallback and demotion;
* ``test_candidates.py``: the pod-mesh build/score parity and the pod-mesh
  refresh against a cold rebuild;
* ``test_score_incremental.py``: the shard-local incremental rescore fuzz;
* ``test_terms.py``: the warm term stream on a mesh against one device;
* ``test_resident_warm.py``: the warm mesh-resident stream with no build.

``test_parity_fuzz.py``'s sharded-wave fuzz imports the Pallas kernels at
module level, so it runs here in parity form: its fuzzed snapshots through
the reference's ``greedy_assign`` and the port's ``greedy_assign_waves`` on
an 8-shard CPU mesh, all five arrays exact.
"""

import pytest
import torch

from koordinator_tpu.solver import greedy_assign as j_greedy
from koordinator_tpu_torch.parallel import greedy_assign_waves, make_mesh

from test_torch_constraints import PACKAGES
from test_torch_cycle import assert_cycle_equal
from test_torch_koordlint import run_case
from test_torch_parallel import case_id
from test_torch_wave import fuzz_pair

CASES = [
    ("test_bridge", "TestMultiChipServing", "test_mesh_backed_assign_matches_single_chip", {}),
    ("test_bridge", "TestMultiChipServing", "test_shard_fault_falls_back_and_demotes", {}),
    ("test_candidates", "TestDenseParity", "test_pod_mesh_parity", {}),
    ("test_candidates", "TestDirtyRefreshExactness", "test_refresh_equals_cold_rebuild",
     {"use_mesh": True}),
    *(("test_score_incremental", "TestParityFuzz",
       "test_mesh_sharded_incremental_matches_oracle", {"seed": s}) for s in (0, 1)),
    *(("test_terms", "TestMeshParity", "test_warm_term_stream_mesh_vs_single_chip",
       {"devices": d, "seed": s}) for d in (1, 8) for s in (0, 1)),
    ("test_resident_warm", "TestRetraceBudget",
     "test_warm_mesh_sharded_stream_is_retrace_free", {}),
]


def test_the_cases_stay_within_a_file_of_forty():
    assert len(PACKAGES) * len(CASES) + 4 <= 40


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, tmp_path, monkeypatch):
    module, cls, method, params = case
    run_case(module, cls, method, package, tmp_path=tmp_path, monkeypatch=monkeypatch,
             **params)


@pytest.mark.parametrize("seed", range(4))
def test_scan_waves_parity_fuzz(seed):
    js, ts, jcfg, tcfg = fuzz_pair(seed + 100)
    want = j_greedy(js, jcfg)
    got, rounds = greedy_assign_waves(ts, make_mesh([torch.device("cpu")] * 8), tcfg)
    assert_cycle_equal(got, want, f"seed {seed + 100}")
    assert rounds >= 1
