"""The co-location generator (``kbench/gen/tenants.py``) and a configuration
that names it and its own copy of the reference: the loop's invariants,
and a replay of the program on the CPU held against that reference."""

import json

import numpy as np
import pytest

from kbench import manifest, run
from kbench.tests.test_kbench_loader import spread_assign
from kbench.tests.test_kbench_reference import replay

# a test-only configuration: in no cell of BENCHMARK.json
CONFIG = json.loads((manifest.PACKAGE / "tests" / "tenants_tiny.json").read_text())
GEN = manifest.load_module(CONFIG["generator"])
R_ = GEN.RESOURCE_INDEX
# each quota group's resources are its own templates' alone, so a group's
# used is the nodes' requested of those resources
GROUP_RESOURCES = {0: ("cpu", "memory"),
                   1: ("kubernetes.io/batch-cpu", "kubernetes.io/batch-memory")}


def tenants_cell(tmp_path=None, **traffic) -> manifest.Cell:
    """The test configuration as a cell, with the loop of ``basic5k.bind``;
    with ``tmp_path``, its reference is a copy of its own there."""
    config = dict(CONFIG)
    if tmp_path is not None:
        own = tmp_path / "tenants_reference.py"
        own.write_text((manifest.ROOT / CONFIG["reference"]).read_text())
        config["reference"] = str(own)
    base = manifest.load_cell("basic5k.bind")
    return manifest.Cell(name="tenants_tiny.bind", chips=1, config=config,
                         traffic=dict(base.traffic, **traffic), end_to_end=base.end_to_end,
                         per_layer=[])


def _steps(seed, steps, assign=spread_assign):
    model = GEN.build(CONFIG, seed)
    loop = GEN.BindLoop(model, [1, 3], seed)
    yield model, loop
    for step in range(steps):
        before = model
        model = loop.after_assign(model, *assign(model, step))
        yield model, before


def test_each_groups_used_is_the_requests_of_its_bound_pods():
    for model, _ in _steps(5, 40):
        for q, names in GROUP_RESOURCES.items():
            for name in names:
                assert model.quse[q, R_[name]] == model.nreq[:, R_[name]].sum(), (q, name)


def test_a_gang_binds_whole_or_not_at_all():
    model = GEN.build(CONFIG, 11)
    loop = GEN.BindLoop(model, [1, 1], 11)
    P = model.preq.shape[0]
    gang = int(model.gang_id[model.gang_id >= 0][0])
    members = np.flatnonzero(model.gang_id == gang)
    assignment, status = np.arange(P) % model.nalloc.shape[0], np.zeros(P, np.int64)
    status[members[0]] = 1
    assignment[members[0]] = -1
    after = loop.after_assign(model, assignment, status)
    # every slot but the gang's binds and is refilled; the gang waits whole
    assert loop.bound == P - members.shape[0]
    assert (after.gang_id[members] == gang).all()
    assert np.array_equal(after.template[members], model.template[members])
    assert after.running_pods() == model.running_pods() + P - members.shape[0]
    # the whole gang placed: it binds, and its PodGroup is laid anew
    status[members[0]], assignment[members[0]] = 0, 0
    again = loop.after_assign(after, assignment, status)
    assert loop.bound == 2 * P - members.shape[0]
    assert (np.bincount(again.gang_id[again.gang_id >= 0]) == 4).all()


def test_the_template_shares_hold_within_one_pod():
    d = GEN.Deployment(CONFIG)
    shares = np.asarray([t["share"] for t in CONFIG["pod_templates"]])
    assert (np.abs(d.slots - shares * d.pending_pods) < 1).all()
    for model, _ in _steps(3, 30):
        assert np.array_equal(np.bincount(model.template, minlength=len(shares)), d.slots)
        # each PodGroup: its template's size, all of that template
        for g, size in enumerate(model.gang_min):
            members = model.gang_id == g
            assert members.sum() == size
            assert np.unique(model.template[members]).shape[0] == 1
        assert model.pending_pods() == d.pending_pods


def test_two_seeds_give_the_same_counts():
    a, b = GEN.build(CONFIG, 7), GEN.build(CONFIG, 2**31 + 7)
    assert not np.array_equal(a.template, b.template)
    assert np.array_equal(np.bincount(a.template), np.bincount(b.template))
    assert np.array_equal(a.gang_min, b.gang_min)
    assert np.array_equal(a.quse, b.quse)
    assert np.array_equal(a.nreq.sum(axis=0), b.nreq.sum(axis=0))
    assert np.array_equal(np.sort(a.nalloc, axis=0), np.sort(b.nalloc, axis=0))


def test_the_sync_carries_the_pod_rows_gangs_and_quotas():
    steps = _steps(9, 1)
    first, _ = next(steps)
    assert {"gang_id", "quota_id", "gang_min_member", "quota_runtime", "quota_used",
            "quota_limited"} <= set(GEN.full_sync_kwargs(first))
    after, before = next(steps)
    assert set(GEN.sync_kwargs(before, after)) == {
        "node_requested", "pod_requests", "pod_estimated", "priority", "gang_id", "quota_id",
        "quota_used"}
    assert GEN.sync_kwargs(after, after) == {}


@pytest.mark.parametrize("change, match", [
    ({"pending_pods": 94}, "whole number of gangs"),
    ({"pod_templates": [dict(CONFIG["pod_templates"][0], priority=100)]
      + CONFIG["pod_templates"][1:]}, "not in koord-prod's range"),
    ({"pod_templates": [dict(CONFIG["pod_templates"][0], share=0.6)]
      + CONFIG["pod_templates"][1:]}, "sum to"),
])
def test_a_deployment_it_cannot_make_is_refused(change, match):
    with pytest.raises(ValueError, match=match):
        GEN.build(dict(CONFIG, **change), 1)


def _quota_refusals(model, status) -> int:
    """Pods refused whose group's used, as the cycle left it when their
    turn came (queue order: priority highest first, then slot), plus their
    request passes the group's runtime on a declared resource."""
    used = model.quse.copy()
    refused = 0
    for p in sorted(range(status.shape[0]), key=lambda i: (-int(model.priority[i]), i)):
        q = int(model.quota_id[p])
        if q < 0:
            continue
        if status[p] == 1:
            refused += bool(((used[q] + model.preq[p] > model.qrt[q]) & (model.qlim[q] != 0)).any())
        else:
            used[q] += model.preq[p]
    return refused


def test_the_program_replays_a_tenants_cluster_as_the_reference(tmp_path):
    cell = tenants_cell(tmp_path)
    assert cell.reference.__file__ == str(tmp_path / "tenants_reference.py")
    assert cell.generator is GEN
    refusals = held = 0
    bands = set()
    for score, assign, model in replay(cell, 271828, 64):
        assert run.compare(score, assign, model, cell) == {"score": 0, "assign": 0}
        status = np.asarray(assign[1])
        refusals += _quota_refusals(model, status)
        held += int((status == 2).sum())
        bands |= {CONFIG["pod_templates"][t]["band"] for t in model.template[status == 0]}
    assert refusals > 0 and held > 0
    assert bands == {t["band"] for t in CONFIG["pod_templates"]}


def test_a_tenants_run_is_correct_through_the_harness(tmp_path):
    cell = tenants_cell(tmp_path, check_steps=6, warmup_steps=4)
    result = run.run(cell, seed=2**31 + 99, seconds=1.5, traced=False, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["steps_compared"]["value"] >= 6
    # without running_pods in the traffic file, the hard band
    assert run.running_band(cell) == (8, 8 + 96 * 3)
    assert run.running_band(tenants_cell(running_pods=[40, 60])) == (40, 60)


@pytest.mark.card
def test_a_tenants_run_is_correct_on_the_card(card, tmp_path):
    cell = tenants_cell(tmp_path, check_steps=6, warmup_steps=4)
    result = run.run(cell, seed=2**31 + 7, seconds=3.0, traced=False, device="cuda")
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
