"""The generator: the cluster from the seed, and the bind loop's steady state."""

import numpy as np
import pytest

from kbench import manifest

CELL = manifest.load_cell("basic5k.bind")
# the configuration's generator, as the harness loads it
GEN = CELL.generator
RESOURCE_INDEX, BindLoop, build = GEN.RESOURCE_INDEX, GEN.BindLoop, GEN.build
full_sync_kwargs, sync_kwargs = GEN.full_sync_kwargs, GEN.sync_kwargs
PODS = RESOURCE_INDEX["pods"]


def test_the_deployment_as_its_source_states_it():
    model = build(CELL.config, 2**31 + 17)
    assert model.nalloc.shape == (5000, 13) and model.preq.shape == (10000, 13)
    assert (model.nalloc[:, RESOURCE_INDEX["cpu"]] == 4000).all()
    assert (model.nalloc[:, RESOURCE_INDEX["memory"]] == 32768).all()
    assert (model.nalloc[:, PODS] == 110).all()
    # every slot a pending pod-default pod; the init pods bound one a node
    assert model.pending_pods() == 10000
    assert (model.preq[:, RESOURCE_INDEX["cpu"]] == 100).all()
    assert model.running_pods() == 1000 and model.nreq[:, PODS].max() == 1
    assert model.fresh.all() and not model.nuse.any()


def test_the_seed_moves_the_work_but_not_its_amount():
    a, b = build(CELL.config, 7), build(CELL.config, 2**31 + 7)
    again = build(CELL.config, 7)
    assert np.array_equal(a.nreq, again.nreq)
    assert not np.array_equal(a.nreq, b.nreq)
    assert (a.nreq.sum(axis=0) == b.nreq.sum(axis=0)).all()
    assert np.array_equal(np.sort(a.nalloc, axis=0), np.sort(b.nalloc, axis=0))


def _spread(model, step):
    """A placement of every pending pod that a LeastAllocated cycle might make."""
    n = model.nalloc.shape[0]
    return (np.arange(model.preq.shape[0]) * 7 + step) % n, np.zeros(model.preq.shape[0])


def test_the_loop_holds_the_running_pods_in_the_band():
    from kbench.run import running_band

    model = build(CELL.config, 99)
    loop = BindLoop(model, CELL.traffic["lifetime_steps"], 99)
    lo, hi = running_band(CELL)
    for step in range(60):
        before = model
        model = loop.after_assign(model, *_spread(model, step))
        if step >= 3:
            assert lo <= model.running_pods() <= hi
        assert model.pending_pods() == 10000
        # the queue refills with the template: only the nodes change on the wire
        assert list(sync_kwargs(before, model)) == ["node_requested"]
    assert loop.bound == 60 * 10000


def test_a_placed_pod_binds_and_an_unplaced_one_stays_pending():
    model = build(CELL.config, 5)
    loop = BindLoop(model, [1, 1], 5)
    assignment = np.full(10000, -1)
    status = np.ones(10000)
    assignment[:3], status[:3] = [10, 10, 11], 0
    after = loop.after_assign(model, assignment, status)
    added = after.nreq - model.nreq
    assert added[10, PODS] == 2 and added[11, PODS] == 1 and added[:, PODS].sum() == 3
    # lifetime 1: the three run one cycle, then leave
    again = loop.after_assign(after, np.full(10000, -1), np.ones(10000))
    assert np.array_equal(again.nreq, model.nreq)
    assert after.pending_pods() == 10000


def test_the_model_of_a_step_stays_as_it_was():
    model = build(CELL.config, 3)
    kept = model.nreq.copy()
    loop = BindLoop(model, [1, 3], 3)
    loop.after_assign(model, *_spread(model, 0))
    assert np.array_equal(model.nreq, kept)
    assert set(full_sync_kwargs(model)) >= {"node_allocatable", "node_requested", "pod_requests"}


def test_lifetimes_must_be_a_range():
    model = build(CELL.config, 1)
    with pytest.raises(ValueError):
        BindLoop(model, [0, 2], 1)
