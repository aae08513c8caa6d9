"""The Score program's Filter+Score written in place
(``solver/score_kernel.py score_cells``).

On the CPU: the wrapper's plain version equals the eager body of
``score_all`` (``solver/greedy.py _score_block``) over the full grid and
over column, row and crossed index vectors with sentinel padding, bit for
bit, and leaves every other cell as it was; the wrapper refuses outputs,
index vectors and operands it cannot take; ``rescore_dirty`` through it
equals a full ``score_cycle`` of the updated snapshot and leaves the
``feasible`` it was given as it was.

On the card (``card`` marker, skipped elsewhere): the kernel
(``solver/score_cuda.cu``) against the plain version on the same CUDA
tensors over seeded random snapshots: least and most allocated, LoadAware
with and without prod usage, stale metrics, zero capacity and requests
over capacity, values above 2^31, invalid and padded rows, zero weights,
terms on, both index forms, one launch each.  This file imports no JAX and
carries its own ``card`` fixture, so on the card it also runs without the
suite's conftest::

    python -m pytest tests/test_torch_score_kernel.py -m card --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.config import AggregatedArgs, CycleConfig, LoadAwareArgs
from koordinator_tpu_torch.harness import generators as g
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import PERCENTILES, snapshot_from_numpy
from koordinator_tpu_torch.solver import greedy, incremental, score_kernel
from koordinator_tpu_torch.solver.incremental import _pad_rows, _upload_rows
from koordinator_tpu_torch.solver.terms import default_term_config

R = res.NUM_RESOURCES
CPU, MEM = res.RESOURCE_INDEX[res.CPU], res.RESOURCE_INDEX[res.MEMORY]

CONFIGS = {
    "least_allocated": CycleConfig(),
    "most_allocated": CycleConfig(fit_scoring_strategy="MostAllocated"),
    "prod_usage": CycleConfig(loadaware=LoadAwareArgs(
        score_according_prod_usage=True, prod_usage_thresholds={res.CPU: 60, res.MEMORY: 70})),
    "aggregated": CycleConfig(loadaware=LoadAwareArgs(aggregated=AggregatedArgs(
        usage_thresholds={res.CPU: 70}, usage_aggregation_type="p95",
        score_aggregation_type="p90"))),
    "zero_weights": CycleConfig(
        fit_resource_weights={res.CPU: 3, res.MEMORY: 0, res.PODS: 1, res.BATCH_CPU: 2},
        loadaware=LoadAwareArgs(resource_weights={res.CPU: 0, res.MEMORY: 0}),
        fit_plugin_weight=2, loadaware_plugin_weight=3),
    "no_loadaware": CycleConfig(enable_loadaware=False, fit_scoring_strategy="MostAllocated"),
    "no_fit_score": CycleConfig(enable_fit_score=False),
    "terms": default_term_config(packing_headroom={res.CPU: 90, res.MEMORY: 95}),
}

# the largest value a scale draws: a real cluster's, past 2^31 (the
# kernel's 64-bit division), and near 2^61 (the int64 products wrap)
SCALES = {"real": 1 << 20, "above_2_31": 1 << 40, "wrapping": 1 << 61}


def random_snapshot(seed, pods, nodes, *, top=1 << 20, pad_pods=3, pad_nodes=5, device="cpu"):
    """A snapshot drawn from ``seed``: capacities with zeros, requested and
    usage up to 130 % of them, stale metrics, prod and aggregated usage,
    sparse pod requests (zero cpu or memory takes the non-zero defaults),
    every priority class, invalid real rows and padded rows at the end."""
    rng = np.random.default_rng(seed)
    P, N = pods + pad_pods, nodes + pad_nodes
    alloc = rng.integers(1, top, (N, R))
    alloc[rng.random((N, R)) < 0.1] = 0

    def share(base, hi, shape):
        return (base * rng.uniform(0, hi, shape)).astype(np.int64)

    usage = share(alloc, 1.3, (N, R))
    req = rng.integers(1, max(top // 8, 2), (P, R))
    req[rng.random((P, R)) < 0.6] = 0
    leaves = {
        "nodes": {
            "allocatable": alloc, "requested": share(alloc, 1.2, (N, R)), "usage": usage,
            "metric_fresh": rng.random(N) < 0.7,
            "valid": (np.arange(N) < nodes) & (rng.random(N) < 0.95),
            "agg_usage": share(alloc[:, None, :], 1.2, (N, len(PERCENTILES), R)),
            "agg_fresh": rng.random((N, len(PERCENTILES))) < 0.8,
            "prod_usage": share(usage, 1.0, (N, R)),
        },
        "pods": {
            "requests": req, "estimated": share(req, 1.5, (P, R)),
            "priority_class": rng.integers(0, 5, P).astype(np.int32),
            "qos": np.zeros(P, np.int32), "priority": rng.integers(0, 10, P).astype(np.int32),
            "gang_id": np.full(P, -1, np.int32), "quota_id": np.full(P, -1, np.int32),
            "valid": (np.arange(P) < pods) & (rng.random(P) < 0.95),
        },
        "gangs": {"min_member": np.zeros(1, np.int32), "valid": np.zeros(1, bool)},
        "quotas": {"runtime": np.zeros((1, R), np.int64), "used": np.zeros((1, R), np.int64),
                   "limited": np.zeros((1, R), bool), "valid": np.zeros(1, bool)},
    }
    snap = snapshot_from_numpy(leaves, device=device)
    return g.with_term_tensors(snap, seed=seed)


def eager(snap, cfg):
    """``score_all``'s eager body over the whole grid."""
    return greedy.by_pod_rows(greedy._score_block, snap, cfg)


def garbage(snap, seed):
    """Outputs of the grid's shape filled with values no cell computes."""
    rng = np.random.default_rng(seed)
    shape = (snap.pods.capacity, snap.nodes.capacity)
    return (torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, shape)).to(snap.device),
            torch.from_numpy(rng.random(shape) < 0.5).to(snap.device))


def index_forms(snap, seed):
    """Each cell set's keyword arguments with its (rows, cols) mask: the
    full grid, dirty columns, dirty rows and their cross, the index vectors
    padded with the sentinel as ``rescore_dirty`` pads them."""
    rng = np.random.default_rng(seed)
    P, N = snap.pods.capacity, snap.nodes.capacity
    rows = sorted(rng.choice(P, size=max(1, P // 5), replace=False).tolist())
    cols = sorted(rng.choice(N, size=max(1, N // 4), replace=False).tolist())
    pod_idx, n_pods = _upload_rows(_pad_rows(rows, P), P, snap.device)
    node_idx, n_nodes = _upload_rows(_pad_rows(cols, N), N, snap.device)
    in_rows, in_cols = np.zeros(P, bool), np.zeros(N, bool)
    in_rows[rows] = in_cols[cols] = True
    every_row, every_col = np.ones(P, bool), np.ones(N, bool)
    return {
        "full": ({}, every_row, every_col),
        "cols": ({"node_idx": node_idx, "n_nodes": n_nodes}, every_row, in_cols),
        "rows": ({"pod_idx": pod_idx, "n_pods": n_pods}, in_rows, every_col),
        "cross": ({"pod_idx": pod_idx, "n_pods": n_pods, "node_idx": node_idx,
                   "n_nodes": n_nodes}, in_rows, in_cols),
    }


def assert_cells(name, got, want, before, rows, cols):
    """``got`` holds ``want`` on the cell set and ``before`` elsewhere."""
    cell = torch.from_numpy(rows[:, None] & cols[None, :]).to(got.device)
    expect = torch.where(cell, want, before)
    assert torch.equal(got, expect), f"{name}: {int((got != expect).sum())} cells differ"


# -- the plain version on the CPU --

@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_the_plain_version_equals_the_eager_body_on_the_full_grid(cfg_name):
    cfg = CONFIGS[cfg_name]
    snap = random_snapshot(3, pods=37, nodes=29)
    want_s, want_f = eager(snap, cfg)
    scores, feasible = garbage(snap, 1)
    score_kernel.score_cells_plain(snap, cfg, feasible, scores)
    assert torch.equal(scores, want_s) and torch.equal(feasible, want_f)
    _, mask = garbage(snap, 2)
    score_kernel.score_cells_plain(snap, cfg, mask)
    assert torch.equal(mask, greedy.by_pod_rows(greedy._feasibility_block, snap, cfg)[0])
    got_s, got_f = greedy.score_all(snap, cfg)
    assert torch.equal(got_s, want_s) and torch.equal(got_f, want_f)
    assert torch.equal(greedy.feasibility_mask(snap, cfg), want_f)


@pytest.mark.parametrize("form", ["cols", "rows", "cross"])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_the_plain_version_writes_the_index_forms_in_place(cfg_name, form):
    cfg = CONFIGS[cfg_name]
    snap = random_snapshot(5, pods=41, nodes=23)
    want_s, want_f = eager(snap, cfg)
    kwargs, rows, cols = index_forms(snap, 7)[form]
    before_s, before_f = garbage(snap, 4)
    scores, feasible = before_s.clone(), before_f.clone()
    score_kernel.score_cells(snap, cfg, feasible, scores, **kwargs)
    assert_cells(f"{form} scores", scores, want_s, before_s, rows, cols)
    assert_cells(f"{form} feasible", feasible, want_f, before_f, rows, cols)
    mask = before_f.clone()
    score_kernel.score_cells_plain(snap, cfg, mask, **kwargs)
    assert_cells(f"{form} mask", mask, want_f, before_f, rows, cols)


def test_an_empty_cell_set_writes_nothing():
    snap = random_snapshot(6, pods=9, nodes=7)
    scores, feasible = garbage(snap, 6)
    before = scores.clone(), feasible.clone()
    idx = torch.full((4,), snap.nodes.capacity, dtype=torch.int64)
    score_kernel.score_cells(snap, CycleConfig(), feasible, scores, node_idx=idx, n_nodes=0)
    assert torch.equal(scores, before[0]) and torch.equal(feasible, before[1])


def test_the_wrapper_refuses_what_the_kernel_cannot_take():
    snap = random_snapshot(8, pods=11, nodes=13, pad_pods=0, pad_nodes=0)
    cfg = CycleConfig()
    P, N = snap.pods.capacity, snap.nodes.capacity
    ok_s = torch.zeros((P, N), dtype=torch.int64)
    ok_f = torch.zeros((P, N), dtype=torch.bool)
    idx = torch.arange(3, dtype=torch.int64)
    cases = [
        (TypeError, "scores is torch.int32", {"scores": ok_s.int()}),
        (TypeError, "feasible is torch.uint8", {"feasible": ok_f.to(torch.uint8)}),
        (ValueError, r"feasible \(11, 12\)", {"feasible": ok_f[:, :12]}),
        (ValueError, "scores is not contiguous",
         {"scores": torch.zeros((N, P), dtype=torch.int64).t()}),
        (ValueError, "on meta", {"feasible": torch.zeros((P, N), dtype=torch.bool,
                                                         device="meta")}),
        (TypeError, "node_idx is torch.int32", {"node_idx": idx.int(), "n_nodes": 2}),
        (ValueError, "4 leading pod_idx", {"pod_idx": idx, "n_pods": 4}),
        (ValueError, "node_idx", {"node_idx": torch.arange(6, dtype=torch.int64)[::2],
                                  "n_nodes": 1}),
    ]
    for error, match, change in cases:
        args = {"feasible": ok_f, "scores": ok_s, **change}
        with pytest.raises(error, match=match):
            score_kernel.score_cells(snap, cfg, **args)
        with pytest.raises(error, match=match):
            score_kernel.score_cells_plain(snap, cfg, **args)
    gathered = dataclasses.replace(snap, nodes=score_kernel._take_nodes(
        snap.nodes, torch.zeros((P, 4), dtype=torch.int64)))
    with pytest.raises(ValueError, match=r"rows gathered per pod"):
        score_kernel.score_cells(gathered, cfg, torch.zeros((P, 4), dtype=torch.bool))
    # the operands the card path prepares, each broken in turn
    ops = score_kernel.cell_operands(snap, cfg)
    score_kernel.check_operands(ops, torch.device("cpu"))
    for error, match, change in (
        (TypeError, "requests is torch.int32", {"requests": ops.requests.int()}),
        (TypeError, "fresh is torch.uint8", {"fresh": ops.fresh.to(torch.uint8)}),
        (ValueError, "usage_prod", {"usage_prod": ops.usage_prod[:-1]}),
        (ValueError, "allocatable is not contiguous",
         {"allocatable": ops.allocatable.t().contiguous().t()}),
        (ValueError, "ok_prod", {"ok_prod": ops.ok_prod.to("meta")}),
        (ValueError, "resources", {"requests": torch.zeros((P, 17), dtype=torch.int64)}),
    ):
        with pytest.raises(error, match=match):
            score_kernel.check_operands(dataclasses.replace(ops, **change),
                                        torch.device("cpu"))


def test_the_kernel_parameters_come_from_the_config_alone():
    def params(cfg):
        p = score_kernel.kernel_params(cfg, R)
        m = score_kernel.MAX_KERNEL_R
        return p[:8], p[8:8 + p[1]], p[8 + m:8 + m + p[1]], p[8 + 2 * m:8 + 2 * m + p[2]], \
            p[8 + 3 * m:8 + 3 * m + p[2]]

    head, fit_r, fit_w, la_r, la_w = params(CycleConfig())
    assert head == [R, 2, 2, 0, 2, 2, 1, 1]
    assert (fit_r, fit_w) == ([CPU, MEM], [1, 1]) and (la_r, la_w) == ([CPU, MEM], [1, 1])
    head, fit_r, fit_w, la_r, _ = params(CONFIGS["zero_weights"])
    # a resource of weight 0 is left out of the sum; a plugin whose weights
    # sum to 0 adds 0 everywhere
    assert head == [R, 3, 0, 0, 6, 1, 2, 0]
    assert sorted(fit_r) == sorted([CPU, res.RESOURCE_INDEX[res.PODS],
                                    res.RESOURCE_INDEX[res.BATCH_CPU]]) and la_r == []
    assert params(CONFIGS["most_allocated"])[0][3] == 1
    assert params(CycleConfig(enable_fit_score=False, enable_loadaware=False))[0] == [
        R, 0, 0, 0, 1, 1, 0, 0]
    with pytest.raises(ValueError, match="12 resources"):
        score_kernel.kernel_params(CycleConfig(), 12)


def delta(snap, rng, n_nodes, n_pods):
    """Move ``n_nodes`` node rows' requested and usage and ``n_pods`` pod
    rows' requests, in place; returns the rows."""
    N, P = snap.nodes.capacity, snap.pods.capacity
    node_rows = sorted(rng.choice(N, size=n_nodes, replace=False).tolist())
    pod_rows = sorted(rng.choice(P, size=n_pods, replace=False).tolist())
    for t in (snap.nodes.requested, snap.nodes.usage):
        t[node_rows] = (snap.nodes.allocatable[node_rows]
                        * torch.from_numpy(rng.uniform(0, 1.1, (n_nodes, R))).to(t.device)).long()
    snap.pods.requests[pod_rows, CPU] = torch.from_numpy(
        rng.choice([0, 250, 8000], n_pods)).to(snap.device)
    return node_rows, pod_rows


def check_rescore(snap, cfg, seed):
    """``rescore_dirty`` after a delta equals a full ``score_cycle``: the
    scores written in place, a new feasible, the given one unchanged."""
    rng = np.random.default_rng(seed)
    scores, feasible = greedy.score_cycle(snap, cfg)
    node_rows, pod_rows = delta(snap, rng, n_nodes=5, n_pods=4)
    given = feasible.clone()
    out_s, out_f = incremental.rescore_dirty(snap, scores, feasible, node_rows, pod_rows, cfg)
    want_s, want_f = greedy.score_cycle(snap, cfg)
    assert out_s is scores, "the resident scores are written in place"
    assert out_f is not feasible
    assert torch.equal(out_s, want_s) and torch.equal(out_f, want_f)
    assert torch.equal(feasible, given), "the feasible given is left as it was"


@pytest.mark.parametrize("cfg_name", ["least_allocated", "prod_usage", "terms"])
def test_rescore_dirty_equals_a_full_score_cycle(cfg_name):
    check_rescore(random_snapshot(9, pods=31, nodes=19), CONFIGS[cfg_name], seed=9)


# -- the kernel on the card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    _build.reset_launch_counts()
    return torch.device("cuda")


def assert_kernel_equals_plain(snap, cfg, kwargs, what, seed, mask_only=False):
    """One launch against the plain version on the same CUDA tensors."""
    before_s, before_f = garbage(snap, seed)
    scores = None if mask_only else before_s.clone()
    feasible = before_f.clone()
    variant = "mask" if mask_only else "scores"
    launches = _build.launch_counts(*score_kernel.VARIANTS)
    score_kernel.score_cells(snap, cfg, feasible, scores, **kwargs)
    torch.cuda.synchronize()
    assert _build.launch_counts(*score_kernel.VARIANTS) == \
        {**launches, variant: launches[variant] + 1}, what
    want_s = None if mask_only else before_s.clone()
    want_f = before_f.clone()
    score_kernel.score_cells_plain(snap, cfg, want_f, want_s, **kwargs)
    assert torch.equal(feasible, want_f), f"{what}: feasible"
    if not mask_only:
        assert torch.equal(scores, want_s), f"{what}: scores"


@pytest.mark.card
@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_the_kernel_equals_the_plain_version(card, cfg_name, scale):
    cfg = CONFIGS[cfg_name]
    snap = random_snapshot(11, pods=301, nodes=517, top=SCALES[scale], device=card)
    for form, (kwargs, _, _) in index_forms(snap, 12).items():
        assert_kernel_equals_plain(snap, cfg, kwargs, f"{cfg_name} {scale} {form}", seed=13)
        assert_kernel_equals_plain(snap, cfg, kwargs, f"{cfg_name} {scale} {form} mask",
                                   seed=14, mask_only=True)


@pytest.mark.card
@pytest.mark.parametrize("pods, nodes", [(1, 1), (2, 255), (3, 257), (64, 1), (130, 1023)])
def test_ragged_tiles_and_odd_rows(card, pods, nodes):
    """Grids whose node count is odd (the scalar stores) or ends inside a
    tile, and a single cell."""
    snap = random_snapshot(pods + nodes, pods=pods, nodes=nodes, pad_pods=0, pad_nodes=0,
                           device=card)
    for form, (kwargs, _, _) in index_forms(snap, 15).items():
        assert_kernel_equals_plain(snap, CycleConfig(), kwargs, f"{pods} x {nodes} {form}",
                                   seed=16)


@pytest.mark.card
def test_the_servicers_padded_grid_and_the_cell_count(card):
    """The servicer's buckets for 10,000 pods x 5,000 nodes, the padding
    invalid: one launch over 16,384 x 8,192 cells, counted."""
    snap = random_snapshot(17, pods=10_000, nodes=5_000, pad_pods=6_384, pad_nodes=3_192,
                           device=card)
    assert_kernel_equals_plain(snap, CycleConfig(), {}, "padded 16384 x 8192", seed=18)
    assert _build.launch_counts("scores_cells", "mask_cells") == \
        {"scores_cells": 16_384 * 8_192, "mask_cells": 0}


@pytest.mark.card
@pytest.mark.parametrize("cfg_name", ["least_allocated", "prod_usage", "terms"])
def test_rescore_dirty_on_the_card(card, cfg_name):
    check_rescore(random_snapshot(19, pods=300, nodes=700, device=card), CONFIGS[cfg_name],
                  seed=19)
    # the full Score and the two passes, each one launch
    assert _build.launch_counts(*score_kernel.VARIANTS) == {"scores": 4, "mask": 0}
