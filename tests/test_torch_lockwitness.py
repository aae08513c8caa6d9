"""The port's runtime lock witness (``koordinator_tpu_torch/obs/lockwitness.py``)
armed on the order the port's own static pass derives, held against the
reference's.

Every case of ``tests/test_lockwitness.py`` runs through both packages (the
reference module loaded a second time bound to the port, entry points on
the CPU): the held-set bookkeeping, the two-sided inversion check, and the
three integration legs (``tests/test_torch_lockwitness_legs.py``) — the
chaos-trace replay, the witnessed servicer's replies byte-equal to the
plain ones, and the three-follower storm — each with ``install()``
loading the derived order of its own package.  The
port's own cases pin the repair: ``install()`` with no edges loads the
non-empty order of ``analysis/lockgraph.py``, and a static edge of that
order observed the other way round raises.
"""

import pytest

from koordinator_tpu_torch.analysis import lockgraph
from koordinator_tpu_torch.obs import lockwitness as lw
from koordinator_tpu_torch.obs.scorer_metrics import LOCK_WITNESS_EDGES, ScorerMetrics
from test_torch_constraints import PACKAGES
from test_torch_koordlint import REPO, rebound, run_case

NAME = "test_lockwitness"
# the integration legs run from tests/test_torch_lockwitness_legs.py, so
# neither file grows past 40 parametrised tests
LEGS = ("TestWitnessedChaosTrace", "TestWitnessedReplicationStorm")


def witness_cases(legs):
    """The reference's cases, ``(module, class, method)``: the
    integration legs, or (``legs`` false) every other class."""
    return [
        (NAME, cls_name, method)
        for cls_name, cls in sorted(vars(rebound(NAME, "koordinator_tpu")).items())
        if isinstance(cls, type) and cls_name.startswith("Test")
        and (cls_name in LEGS) == legs
        for method in sorted(vars(cls))
        if method.startswith("test_")
    ]


def run_witness_case(module, cls, method, package, tmp_path, monkeypatch):
    try:
        run_case(module, cls, method, package, tmp_path=tmp_path, monkeypatch=monkeypatch)
    finally:
        rebound(module, package).lw.uninstall()


CASES = witness_cases(legs=False)


def test_the_reference_cases_are_collected():
    assert len(CASES) >= 15
    assert {c[1] for c in CASES} >= {"TestInversion", "TestConditionWait"}
    assert {c[1] for c in witness_cases(legs=True)} == set(LEGS)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c[1:]) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, monkeypatch):
    run_witness_case(module, cls, method, package, tmp_path, monkeypatch)


@pytest.fixture
def armed():
    """The witness armed on the port's derived order; always disarmed."""
    lw.install()
    try:
        yield lw._STATE
    finally:
        lw.uninstall()


def test_install_without_edges_loads_the_derived_order(armed):
    derived = lockgraph.static_order(REPO)
    assert derived
    got = {(a, b) for a, bs in armed.static_order.items() for b in bs}
    assert got == derived


def test_a_static_edge_observed_reversed_raises(armed):
    # the static pass derives Sync's lock before the state lock
    # (bridge/server.py nests them)
    first = "bridge.server.ScorerServicer._sync_lock"
    then = "bridge.server.ScorerServicer._state_lock"
    assert (first, then) in lockgraph.static_order(REPO)
    a, b = lw.witness_lock(first), lw.witness_lock(then)
    with a, b:  # the derived order itself is admitted
        pass
    with b:
        with pytest.raises(lw.LockOrderInversion,
                           match="koordinator_tpu_torch/analysis/LOCKORDER.md"):
            a.acquire()
    assert [inv["edge"] for inv in lw.inversions()] == [(then, first)]
    assert not a._inner.locked()


def test_a_transitive_static_path_raises(armed):
    # _sync_lock -> _launch_lock (run_exclusive) and _launch_lock ->
    # solver._LOCK (run_pipelined): solver._LOCK then _sync_lock inverts
    # through the path, though no single edge names both
    order = lockgraph.static_order(REPO)
    first, mid, last = ("bridge.server.ScorerServicer._sync_lock",
                        "bridge.coalesce.CoalescingDispatcher._launch_lock", "solver._LOCK")
    assert (first, mid) in order and (mid, last) in order and (first, last) not in order
    solver_lock, sync_lock = lw.witness_lock(last), lw.witness_lock(first)
    with solver_lock:
        with pytest.raises(lw.LockOrderInversion):
            sync_lock.acquire()


def test_inversions_count_on_the_metric(armed):
    metrics = ScorerMetrics()
    lw.attach_metrics(metrics)
    a = lw.witness_lock("replication.leader.ReplicationPublisher._lock")
    b = lw.witness_lock("replication.leader._Subscriber._cond")
    with b:
        with pytest.raises(lw.LockOrderInversion):
            a.acquire()
    assert metrics.registry.get(LOCK_WITNESS_EDGES, {"result": "inversion"}) == 1
    assert not metrics.registry.get(LOCK_WITNESS_EDGES, {"result": "observed"})
