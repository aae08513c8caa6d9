"""The plain count of the per-pod kernels' run pods (``solver/greedy.py
run_pod_count``: the pods after the first of every run of three or more
valid pods with equal rows) on the CPU: on the card test's queues
(``test_torch_cycle_card.CASES``) it equals a loop over the queue and the
count each case fixes, and every plain path (``greedy_assign``,
``greedy_assign_dense``, ``greedy_assign_wide``) reports it on its
``CycleResult``; a wave-batched cycle reports none."""

import pytest
import torch

from koordinator_tpu_torch.config import CycleConfig
from koordinator_tpu_torch.solver import (
    dense,
    greedy_assign,
    greedy_assign_dense,
    greedy_assign_wide,
    run_cycle,
)
from koordinator_tpu_torch.solver.greedy import run_pod_count

from test_torch_cycle_card import CASES, edited

# the CPU's plain cycles run these at their full size in seconds; the
# 16,384-node case only counts
SMALL = [c for c in CASES if c.resident]


def loop_count(inp) -> int:
    """Valid pods, in queue order, whose rows equal the previous valid
    pod's, in runs of three or more such pods; none with extra scores."""
    if inp.xcomb is None:
        keys = [(inp.preq[p].tolist(), inp.psreq[p].tolist(), inp.pest[p].tolist(),
                 int(inp.pprod[p])) for p in range(inp.pvalid.shape[0]) if inp.pvalid[p]]
    else:
        keys = []
    count, length = 0, 1  # the current run's pods
    for prev, key in zip([None] + keys, keys):
        length = length + 1 if key == prev else 1
        count += (length >= 3) + (length == 3)  # the third pod brings the second in
    return count


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_the_count_equals_a_loop_over_the_queue(case):
    snap, cfg, xm, xs = case.build("cpu")
    inp = edited(case, dense.prepare_cycle_inputs(snap, cfg, xm, xs))
    got = dense.inputs_run_pods(inp)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1,)
    assert int(got) == loop_count(inp) == case.runs(int((inp.pvalid != 0).sum()))


@pytest.mark.parametrize("case", [c for c in SMALL if c.edit is None],
                         ids=[c.name for c in SMALL if c.edit is None])
def test_every_plain_path_reports_the_count(case):
    snap, cfg, xm, xs = case.build("cpu")
    want = loop_count(dense.prepare_cycle_inputs(snap, cfg, xm, xs))
    paths = [greedy_assign(snap, cfg, xm, xs), greedy_assign_dense(snap, cfg, xm, xs),
             run_cycle(snap, cfg, xm, xs)]
    if case.k2:
        paths.append(greedy_assign_wide(snap, cfg, xm, xs))
    for result in paths:
        assert int(result.run_pods) == want, result.path


def test_a_wave_cycle_has_no_run_pods():
    snap, cfg, _, _ = CASES[0].build("cpu")
    assert run_cycle(snap, CycleConfig(wave=8, top_m=2)).run_pods is None


def test_extras_pairs_and_an_empty_queue_count_none():
    rows = torch.ones((4, 3), dtype=torch.int64)
    ones = torch.ones(4, dtype=torch.uint8)
    assert int(run_pod_count(rows, rows, rows, ones * 0, ones, extras=False)) == 3
    pairs = torch.tensor([[1], [1], [2], [2]])
    assert int(run_pod_count(pairs, pairs, pairs, ones * 0, ones, extras=False)) == 0
    assert int(run_pod_count(rows, rows, rows, ones * 0, ones, extras=True)) == 0
    empty = rows[:0]
    assert int(run_pod_count(empty, empty, empty, ones[:0], ones[:0], extras=False)) == 0
