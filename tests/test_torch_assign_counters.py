"""An Assign's counters (``bridge/server.py ASSIGN_COUNTERS``) on the CPU:
``placed``, ``unschedulable``, ``wait_gang``, ``gangs_held``,
``quota_bound`` and ``run_pods`` on the cycle's record and on the launch
ledger's counter rows ``server.assign.count.<name>``, each equal to a plain
recount from the Sync's tables and the Assign's reply; and a cluster with
no gang and no quota counts zeros for both without the device
reduction."""

import numpy as np
import pytest

from koordinator_tpu_torch.bridge import server as server_mod
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.server import ASSIGN_COUNTERS, ScorerServicer
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.obs import devprof


@pytest.fixture(autouse=True)
def fresh_ledger():
    devprof.reset()
    yield
    devprof.reset()


def _array(tensor) -> np.ndarray:
    return np.frombuffer(tensor.data, "<i8").reshape(tuple(tensor.shape))


def _assign(lists, sample=1):
    """One Sync and one Assign of ``lists`` on a CPU servicer: (the Sync
    request, the reply's assignment and status, the notes of the cycle's
    record, the ledger's counter rows)."""
    req, _ = build_sync_request(*lists)
    sv = ScorerServicer(device="cpu", trace_export=False, devprof_sample=sample)
    try:
        sync = sv.sync(req)
        reply = sv.assign(wire.AssignRequest(snapshot_id=sync.snapshot_id))
        record = sv.telemetry.flight.snapshot()[-1]["notes"]
    finally:
        sv.telemetry.close()
    rows = {n: r for n, r in devprof.summary()["boundaries"].items()
            if r.get("kind") == "counter"}
    return req, np.asarray(reply.assignment), np.asarray(reply.status), record, rows


def identical_pods():
    """A quota cluster whose pending pods are all one template: one run."""
    nodes, pods, gangs, quotas = generators.quota_colocation(seed=5, pods=160, nodes=6,
                                                             tenants=4)
    return nodes, [{**pods[0], "name": f"same-{i}"} for i in range(len(pods))], gangs, quotas


def recount(req, assignment, status) -> dict:
    """The six counts in plain numpy, from the Sync's own tables: the
    groups' used after the cycle is their synced used plus the requests of
    every pod the cycle placed (held members included); the run pods are
    the pods, in queue order (priority down, then slot), whose requests and
    estimates equal the previous pod's, in runs of three or more (the score
    requests follow the requests, and the servicer's default configuration
    gives no pod the prod split, so those rows are the whole key)."""
    P = assignment.shape[0]
    requests = _array(req.pods.requests)[:P]
    estimated = _array(req.pods.estimated)[:P]
    priority = list(req.pods.priority)
    order = sorted(range(P), key=lambda p: -priority[p])
    rows = [(tuple(requests[p]), tuple(estimated[p])) for p in order]
    gang = np.asarray(list(req.pods.gang_id) or [-1] * P)
    quota = np.asarray(list(req.pods.quota_id) or [-1] * P)
    out = {"placed": int((status == 0).sum()), "unschedulable": int((status == 1).sum()),
           "wait_gang": int((status == 2).sum()),
           "gangs_held": len({int(g) for g in gang[status == 2] if g >= 0}),
           "quota_bound": 0, "run_pods": 0}
    length = 1
    for prev, row in zip(rows, rows[1:]):
        length = length + 1 if row == prev else 1
        out["run_pods"] += (length >= 3) + (length == 3)
    if req.quotas.runtime.shape:
        runtime, used = _array(req.quotas.runtime), _array(req.quotas.used).copy()
        limited = _array(req.quotas.limited) != 0
        for p in np.flatnonzero((assignment >= 0) & (quota >= 0)):
            used[quota[p]] += requests[p]
        for p in np.flatnonzero((status == 1) & (quota >= 0)):
            q = quota[p]
            out["quota_bound"] += bool(((used[q] + requests[p] > runtime[q]) & limited[q]).any())
    return out


@pytest.mark.parametrize("scenario, lists", [
    ("gang_batch", lambda: generators.gang_batch(seed=3, pods=96, nodes=3, min_member=8)),
    ("quota_colocation", lambda: generators.quota_colocation(seed=5, pods=160, nodes=6,
                                                             tenants=4)),
    ("identical_pods", identical_pods),
])
def test_the_counters_equal_a_plain_recount(scenario, lists):
    req, assignment, status, record, rows = _assign(lists())
    want = recount(req, assignment, status)
    assert {name: record[name] for name in ASSIGN_COUNTERS} == want
    assert {name: rows[f"server.assign.count.{name}"]["total"] for name in ASSIGN_COUNTERS} == want
    for name in ASSIGN_COUNTERS:
        row = rows[f"server.assign.count.{name}"]
        assert row["launches"] == row["sampled"] == 1
        assert row["device_us_total"] == row["total"]
    assert want["placed"] + want["unschedulable"] + want["wait_gang"] == assignment.shape[0]
    # each scenario shows its mechanism
    if scenario == "gang_batch":
        assert want["gangs_held"] > 0 and want["wait_gang"] >= want["gangs_held"]
    elif scenario == "identical_pods":
        assert want["run_pods"] == assignment.shape[0] - 1
    else:
        assert want["quota_bound"] > 0 and want["gangs_held"] == 0


def test_no_gang_and_no_quota_counts_zeros_with_no_device_work(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the gang and quota reduction ran on a cluster with neither")

    monkeypatch.setattr(server_mod, "gang_quota_counts", refuse)
    lists = generators.loadaware_joint(seed=2, pods=48, nodes=8)
    assert not lists[2] and not lists[3]
    req, assignment, status, record, rows = _assign(lists)
    assert record["gangs_held"] == record["quota_bound"] == 0
    assert record["placed"] == int((status == 0).sum()) > 0
    assert rows["server.assign.count.quota_bound"]["total"] == 0
    assert rows["server.assign.count.gangs_held"]["total"] == 0


def test_the_ledger_off_records_no_counter_but_the_record_has_them():
    req, assignment, status, record, rows = _assign(
        generators.gang_batch(seed=3, pods=96, nodes=3, min_member=8), sample=0)
    assert rows == {}
    assert {name: record[name] for name in ASSIGN_COUNTERS} == recount(req, assignment, status)


def test_the_report_and_health_block_list_the_counters(tmp_path):
    import json

    _assign(generators.gang_batch(seed=3, pods=96, nodes=3, min_member=8))
    health = devprof.health_block(top=50)
    assert {c["counter"] for c in health["counters"]} == {
        f"server.assign.count.{name}" for name in ASSIGN_COUNTERS}
    assert not [t for t in health["top"] if t["boundary"].startswith("server.")]
    assert devprof.dump(str(tmp_path))
    text = devprof.format_report(json.loads((tmp_path / devprof.LEDGER_FILENAME).read_text()),
                                 top=50)
    launches, _, counters = text.partition("counters by RPC")
    assert "server.assign.count." not in launches
    assert "server.assign.count.wait_gang" in counters
