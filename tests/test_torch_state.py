"""The port's ResidentState (``koordinator_tpu_torch/bridge/state.py``)
against the reference's, on the same Sync frames.

Each frame is built once, serialized, and decoded by each side's own codec.
After every Sync the port's ``snapshot()`` must equal the reference's leaf
for leaf (as numpy: same shapes, dtypes and values), with the same
``last_sync_path``; where the reference rejects a frame the port raises the
same error and both states stay as they were.  Every value is an integer,
so the comparison is exact."""

import os

import numpy as np
import pytest

from koordinator_tpu.bridge.codegen import pb2
from koordinator_tpu.bridge.state import ResidentState as RefState
from koordinator_tpu.bridge.state import numpy_to_tensor as ref_tensor
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.plugin_sim import (
    NUM_AXES, ResidentMirror, build_sync, node_vectors,
)
from koordinator_tpu_torch.bridge.state import ResidentState
from koordinator_tpu_torch.model.snapshot import SNAPSHOT_FIELDS

R = 13
TESTDATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "go", "scorerclient", "testdata",
)


def leaves(snap):
    """{"table.field": numpy array or None} of a snapshot of either
    package (reference leaves are jax arrays, the port's torch tensors)."""
    def host(a):
        if a is None:
            return None
        return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)

    out = {}
    for table, (_, fields) in SNAPSHOT_FIELDS.items():
        obj = getattr(snap, table)
        for f in fields:
            out[f"{table}.{f}"] = host(getattr(obj, f))
        assert getattr(obj, "names") == ()
    out["throughput"] = host(snap.throughput)
    return out


def assert_same_leaves(got, want, where):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        if w is None:
            assert g is None, f"{where}: {key} present in the port only"
            continue
        assert g is not None, f"{where}: {key} missing in the port"
        assert g.shape == w.shape, f"{where}: {key} shape {g.shape} != {w.shape}"
        assert g.dtype == w.dtype, f"{where}: {key} dtype {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {key}")


class Pair:
    """The two states, fed the same bytes."""

    def __init__(self):
        self.ref = RefState()
        self.port = ResidentState(device="cpu")

    def sync(self, raw: bytes, where: str, materialize=True):
        err_ref = err_port = None
        try:
            info_ref = self.ref.apply_sync(pb2.SyncRequest.FromString(raw))
        except ValueError as exc:
            err_ref = str(exc)
        try:
            info_port = self.port.apply_sync(wire.SyncRequest.FromString(raw))
        except ValueError as exc:
            err_port = str(exc)
        assert err_port == err_ref, where
        if err_ref is None:
            assert info_port == info_ref, where
        assert self.port.last_sync_path == self.ref.last_sync_path, where
        for key in ("node_bucket", "pod_bucket", "node_names", "pod_names"):
            assert getattr(self.port, key) == getattr(self.ref, key), (where, key)
        if materialize and self.ref.node_alloc is not None:
            self.check(where)
        return err_ref

    def check(self, where):
        assert_same_leaves(leaves(self.port.snapshot()),
                           leaves(self.ref.snapshot()), where)
        assert self.port.i32_fits() == self.ref.i32_fits(), where


def test_plugin_fixture_stream():
    pair = Pair()
    for n in (1, 2):
        with open(os.path.join(TESTDATA, f"plugin_sync{n}_request.bin"), "rb") as f:
            assert pair.sync(f.read(), f"plugin sync {n}") is None
    assert pair.port.last_sync_path == "warm"


def test_golden_fixture_sync():
    pair = Pair()
    with open(os.path.join(TESTDATA, "sync_request.bin"), "rb") as f:
        assert pair.sync(f.read(), "golden sync") is None


@pytest.mark.parametrize("seed", range(4))
def test_plugin_sim_stream(seed):
    """The Go plugin's frames: a full sync, then delta syncs as a few
    nodes' committed load moves, a node joining (full, names again), and
    freshness flips."""
    rng = np.random.RandomState(seed)
    n_nodes = 6
    alloc = [8000, 16384, 0, 110] + [0] * (NUM_AXES - 4)
    table = [[f"node-{i}", list(alloc), [1000, 1024, 0, 5] + [0] * (NUM_AXES - 4)]
             for i in range(n_nodes)]
    metrics = {}
    mirror = ResidentMirror()
    pair = Pair()
    for cycle in range(10):
        action = rng.rand()
        if action < 0.5:
            for _ in range(rng.randint(1, 3)):
                row = table[rng.randint(len(table))][2]
                row[0] = int(rng.randint(500, 4000))
        elif action < 0.65:
            table.append([f"node-{len(table)}", list(alloc), [0] * NUM_AXES])
        elif action < 0.85:
            name = table[rng.randint(len(table))][0]
            metrics[name] = [int(rng.randint(0, 3000))] + [0] * (NUM_AXES - 1)
        names, a, r, u, fresh = node_vectors([tuple(t) for t in table], metrics)
        delta = mirror.valid and mirror.names == names
        raw = build_sync(mirror, delta, names, a, r, u, fresh,
                         f"pod-{cycle}", [500, 512, 0, 1] + [0] * (NUM_AXES - 4), 0)
        assert pair.sync(raw, f"seed {seed} cycle {cycle}",
                         materialize=rng.rand() < 0.8) is None
        mirror.names, mirror.alloc, mirror.requested, mirror.usage = names, a, r, u
        mirror.valid = True


# -- seeded random delta sequences (tests/test_resident_warm.py's fuzz,
#    widened to every synced tensor and column) --

def _random_state(rng, n_nodes, n_pods, with_quota, with_terms):
    state = {
        "node_alloc": rng.randint(4000, 64000, (n_nodes, R)).astype(np.int64),
        "node_requested": rng.randint(0, 2000, (n_nodes, R)).astype(np.int64),
        "node_usage": rng.randint(0, 3000, (n_nodes, R)).astype(np.int64),
        "node_fresh": rng.rand(n_nodes) > 0.2,
        "pod_requests": rng.randint(1, 4000, (n_pods, R)).astype(np.int64),
        "pod_estimated": rng.randint(1, 4000, (n_pods, R)).astype(np.int64),
        "pod_priority": rng.randint(0, 9999, n_pods).astype(np.int64),
        "pod_gang": np.where(rng.rand(n_pods) > 0.5,
                             rng.randint(0, 2, n_pods), -1).astype(np.int32),
        "pod_quota": -np.ones(n_pods, np.int32),
        "gang_min": np.asarray([2, 3], np.int32),
    }
    if with_quota:
        q = 3
        state["quota_runtime"] = rng.randint(5000, 500000, (q, R)).astype(np.int64)
        state["quota_used"] = rng.randint(0, 4000, (q, R)).astype(np.int64)
        state["quota_limited"] = (rng.rand(q, R) > 0.5).astype(np.int64)
        state["pod_quota"] = np.where(rng.rand(n_pods) > 0.4,
                                      rng.randint(0, q, n_pods), -1).astype(np.int32)
    if with_terms:
        state["node_agg"] = rng.randint(0, 3000, (n_nodes, 4, R)).astype(np.int64)
        state["node_agg_fresh"] = (rng.rand(n_nodes, 4) > 0.3).astype(np.int64)
        state["node_prod"] = rng.randint(0, 2000, (n_nodes, R)).astype(np.int64)
        state["node_accel"] = rng.randint(0, 3, n_nodes).astype(np.int32)
        state["pod_workload"] = rng.randint(0, 4, n_pods).astype(np.int32)
        state["pod_sensitivity"] = rng.randint(0, 101, (n_pods, R)).astype(np.int64)
        state["term_throughput"] = rng.randint(0, 101, (4, 3)).astype(np.int64)
    return state


_TENSOR_PATHS = {
    "node_alloc": ("nodes", "allocatable"), "node_requested": ("nodes", "requested"),
    "node_usage": ("nodes", "usage"), "node_agg": ("nodes", "agg_usage"),
    "node_agg_fresh": ("nodes", "agg_fresh"), "node_prod": ("nodes", "prod_usage"),
    "pod_requests": ("pods", "requests"), "pod_estimated": ("pods", "estimated"),
    "pod_sensitivity": ("pods", "sensitivity"), "quota_runtime": ("quotas", "runtime"),
    "quota_used": ("quotas", "used"), "quota_limited": ("quotas", "limited"),
    "term_throughput": ("terms", "throughput"),
}
_COLUMN_PATHS = {
    "node_fresh": ("nodes", "metric_fresh"), "pod_priority": ("pods", "priority"),
    "pod_gang": ("pods", "gang_id"), "pod_quota": ("pods", "quota_id"),
    "gang_min": ("gangs", "min_member"), "node_accel": ("nodes", "accel_type"),
    "pod_workload": ("pods", "workload_class"),
}


def _wire_tensor(req, key):
    table, field = _TENSOR_PATHS[key]
    return getattr(getattr(req, table), field)


def _full_request(state):
    req = pb2.SyncRequest()
    for key in _TENSOR_PATHS:
        if state.get(key) is not None:
            _wire_tensor(req, key).CopyFrom(ref_tensor(state[key]))
    for key, (table, field) in _COLUMN_PATHS.items():
        if state.get(key) is not None:
            getattr(getattr(req, table), field).extend(
                bool(v) if key == "node_fresh" else int(v) for v in state[key])
    return req


def _mutate(rng, state):
    """One step: a node resize (full tensors, omitted companions), a bad
    frame (duplicate delta index, or a companion still shaped for the old
    table), or sparse deltas on random tensors plus column churn.  Returns
    (request, whether the frame is expected to be rejected)."""
    req = pb2.SyncRequest()
    choice = rng.rand()
    if choice < 0.1:
        n_new = int(rng.randint(3, 12))
        state["node_alloc"] = rng.randint(4000, 64000, (n_new, R)).astype(np.int64)
        state["node_requested"] = rng.randint(0, 2000, (n_new, R)).astype(np.int64)
        state["node_usage"] = rng.randint(0, 3000, (n_new, R)).astype(np.int64)
        for key in ("node_alloc", "node_requested", "node_usage"):
            _wire_tensor(req, key).CopyFrom(ref_tensor(state[key]))
        # omitted companions reset to their defaults on both sides
        state["node_fresh"] = np.ones(n_new, bool)
        for key in ("node_agg", "node_agg_fresh", "node_prod", "node_accel"):
            state[key] = None
        return req, False
    if choice < 0.15:
        arr = state["node_requested"]
        t = _wire_tensor(req, "node_requested")
        t.shape.extend(arr.shape)
        t.delta_idx = np.asarray([0, 0], "<i8").tobytes()
        t.delta_val = np.asarray([1, 2], "<i8").tobytes()
        return req, True
    if choice < 0.2:
        n = state["node_alloc"].shape[0] + 2
        _wire_tensor(req, "node_alloc").CopyFrom(
            ref_tensor(rng.randint(4000, 64000, (n, R)).astype(np.int64)))
        # old-shaped usage riding the resize frame
        _wire_tensor(req, "node_usage").CopyFrom(ref_tensor(state["node_usage"]))
        return req, True
    for key in ("node_requested", "node_usage", "node_agg", "pod_requests",
                "pod_estimated", "pod_sensitivity", "quota_used",
                "term_throughput"):
        arr = state.get(key)
        if arr is None or rng.rand() > 0.45:
            continue
        prev = arr.copy()
        cells = rng.randint(1, max(2, arr.size // 6))
        idx = rng.choice(arr.size, size=cells, replace=False)
        arr.reshape(-1)[idx] = rng.randint(0, 5000 if key != "term_throughput" else 101,
                                           cells)
        _wire_tensor(req, key).CopyFrom(ref_tensor(arr, prev))
    for key, frac in (("node_fresh", 0.2), ("pod_priority", 0.15),
                      ("node_accel", 0.15), ("pod_workload", 0.15)):
        if state.get(key) is None or rng.rand() > frac:
            continue
        col = state[key]
        if key == "node_fresh":
            state[key] = rng.rand(len(col)) > 0.2
        elif key == "pod_priority":
            state[key] = rng.randint(0, 9999, len(col)).astype(np.int64)
        else:
            state[key] = rng.randint(0, 4, len(col)).astype(np.int32)
        table, field = _COLUMN_PATHS[key]
        getattr(getattr(req, table), field).extend(
            bool(v) if key == "node_fresh" else int(v) for v in state[key])
    return req, False


@pytest.mark.parametrize("seed", range(8))
def test_random_delta_sequences(seed):
    rng = np.random.RandomState(seed)
    state = _random_state(rng, n_nodes=int(rng.randint(4, 10)),
                          n_pods=int(rng.randint(8, 24)),
                          with_quota=bool(seed % 2), with_terms=seed >= 4)
    pair = Pair()
    assert pair.sync(_full_request(state).SerializeToString(), "first") is None
    paths, rejected = set(), 0
    for cycle in range(14):
        req, bad = _mutate(rng, state)
        err = pair.sync(req.SerializeToString(), f"seed {seed} cycle {cycle}",
                        materialize=rng.rand() < 0.85)
        assert (err is not None) == bad, (seed, cycle, err)
        rejected += bad
        paths.add(pair.port.last_sync_path)
        pair.check(f"seed {seed} cycle {cycle} after")
    assert "warm" in paths


def test_export_sync_request_round_trips():
    rng = np.random.RandomState(21)
    state = _random_state(rng, 5, 9, with_quota=True, with_terms=True)
    pair = Pair()
    pair.sync(_full_request(state).SerializeToString(), "first")
    raw = pair.port.export_sync_request().SerializeToString()
    assert raw == pair.ref.export_sync_request().SerializeToString()
    fresh = Pair()
    fresh.sync(raw, "exported")
    assert_same_leaves(leaves(fresh.port.snapshot()),
                       leaves(pair.port.snapshot()), "export")


def test_first_sync_without_tensors_rejected():
    pair = Pair()
    assert "first Sync" in pair.sync(pb2.SyncRequest().SerializeToString(), "empty")
    assert pair.port.node_alloc is None


def test_full_upload_binds_a_new_tensor():
    """A full re-upload of unchanged geometry never writes into the
    resident tensor: a launched batch holding the old one keeps its
    values.  A delta writes in place (and so drains first)."""
    rng = np.random.RandomState(4)
    state = _random_state(rng, 4, 8, with_quota=False, with_terms=False)
    st = ResidentState(device="cpu")
    st.apply_sync(wire.SyncRequest.FromString(_full_request(state).SerializeToString()))
    old = st.snapshot().nodes.requested
    before = old.clone()
    req = wire.SyncRequest()
    req.nodes.requested.CopyFrom(
        wire.Tensor.FromString(ref_tensor(state["node_requested"] + 1).SerializeToString()))
    staged = st.stage_sync(req)
    assert not st.commit_donates(staged)
    st.commit_sync(staged)
    assert st.last_sync_path == "warm"
    assert st.snapshot().nodes.requested is not old
    assert bool((old == before).all())
    prev = state["node_requested"] + 1
    nxt = prev.copy()
    nxt[0, 0] += 5
    req = wire.SyncRequest()
    req.nodes.requested.CopyFrom(
        wire.Tensor.FromString(ref_tensor(nxt, prev).SerializeToString()))
    staged = st.stage_sync(req)
    assert st.commit_donates(staged)
    resident = st.snapshot().nodes.requested
    st.commit_sync(staged)
    assert st.snapshot().nodes.requested is resident
    assert int(resident[0, 0]) == int(nxt[0, 0])


def test_mesh_is_refused():
    class Mesh:
        size = 4

    # a mesh the port cannot shard over (not a parallel.mesh.Mesh)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ResidentState(mesh=Mesh(), device="cpu")
