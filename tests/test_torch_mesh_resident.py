"""The mesh-resident snapshot of the port (``bridge/state.py`` on a
``parallel.cluster_mesh``) held against the JAX package.

The reference's ``tests/test_mesh_resident.py`` runs through both packages
(its 8-device cases on an 8-shard CPU mesh; ``tests/test_torch_parallel.py``
says how it is rebound): byte-identical Sync/Score/Assign replies against
the single-device servicer, the shard-local warm path against a cold
mesh-resident rebuild, the placement policy leaf by leaf, and the daemon's
``--mesh`` rounding.  The port's own cases follow: every shard is its own
allocation even where the mesh names one device eight times, a node delta
writes its owning shard and no other, a pod delta every replica alike.
"""

import hashlib

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.server import ScorerServicer
from koordinator_tpu_torch.bridge.state import numpy_to_tensor
from koordinator_tpu_torch.parallel import cluster_mesh
from koordinator_tpu_torch.parallel.mesh import ShardedTensor, snapshot_leaves

from test_torch_constraints import PACKAGES
from test_torch_koordlint import rebound, run_case
from test_torch_parallel import case_id, param_cases

CASES = param_cases("test_mesh_resident", (
    "TestMeshParityFuzz", "TestShardLocalDelta", "TestShardingSpecs",
    "TestPow2DeviceCount", "TestMeshResidentState"))
CPU = torch.device("cpu")


def test_the_reference_cases_are_collected():
    assert len(CASES) == 16
    assert len(PACKAGES) * len(CASES) <= 40


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, tmp_path):
    module, cls, method, params = case
    run_case(module, cls, method, package, tmp_path=tmp_path, **params)


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

_random_state, _full_sync_request = (
    getattr(rebound("test_resident_warm", "koordinator_tpu_torch"), n)
    for n in ("_random_state", "_full_sync_request"))


def digests(x: ShardedTensor):
    return [hashlib.sha256(s.numpy().tobytes()).hexdigest() for s in x.shards]


def meshed_servicer(state):
    sv = ScorerServicer(mesh=cluster_mesh([CPU] * 8), mesh_resident=True, device="cpu")
    sv.sync(_full_sync_request(state))
    sv.state.snapshot()  # resident: the next delta is warm
    return sv


def test_every_shard_is_its_own_allocation():
    rng = np.random.RandomState(5)
    sv = meshed_servicer(_random_state(rng, n_nodes=9, n_pods=12, with_quota=True))
    snap = sv.state.snapshot()
    for leaf in snapshot_leaves(snap):
        assert isinstance(leaf, ShardedTensor) and len(leaf.shards) == 8
        assert len({s.data_ptr() for s in leaf.shards}) == 8
    assert snap.nodes.allocatable.shards[0].shape[0] == snap.nodes.allocatable.shape[0] // 8


def test_a_node_delta_writes_its_owning_shard_only():
    rng = np.random.RandomState(11)
    state = _random_state(rng, n_nodes=13, n_pods=12, with_quota=False)
    sv = meshed_servicer(state)
    usage = sv.state.snapshot().nodes.usage
    n_loc = usage.shape[0] // 8
    for node in (0, 5, 12):
        before = digests(usage)
        prev = state["node_usage"].copy()
        state["node_usage"][node, 1] += 7
        req = wire.SyncRequest()
        req.nodes.usage.CopyFrom(numpy_to_tensor(state["node_usage"], prev))
        sv.sync(req)
        assert sv.state.last_sync_path == "warm"
        after = digests(sv.state.snapshot().nodes.usage)
        changed = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
        assert changed == [node // n_loc]
        np.testing.assert_array_equal(
            np.asarray(sv.state.snapshot().nodes.usage)[:13], state["node_usage"])


def test_a_pod_delta_writes_every_replica_alike():
    rng = np.random.RandomState(12)
    state = _random_state(rng, n_nodes=8, n_pods=12, with_quota=False)
    sv = meshed_servicer(state)
    prev = state["pod_requests"].copy()
    state["pod_requests"][3, 0] += 5
    req = wire.SyncRequest()
    req.pods.requests.CopyFrom(numpy_to_tensor(state["pod_requests"], prev))
    sv.sync(req)
    assert sv.state.last_sync_path == "warm"
    requests = sv.state.snapshot().pods.requests
    assert len(set(digests(requests))) == 1
    np.testing.assert_array_equal(requests.shards[5].numpy()[:12], state["pod_requests"])
