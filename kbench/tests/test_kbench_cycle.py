"""A traffic file's ``cycle`` block reaches the program whole: the terms
and the packing mask score alike in the program and the reference, and a
key the program cannot take stops the servicer's process before it serves."""

import tempfile

import numpy as np
import pytest

from kbench import run, serve
from kbench.tests.test_kbench_reference import replay

TERMS = {"wave": 1, "top_m": 4, "terms": True, "packing_headroom": {"cpu": 500}}


def test_the_terms_and_the_packing_mask_reach_the_program(tiny_cell):
    cell = tiny_cell("basic5k.bind", nodes=24, pending=96, init=8, cycle=TERMS)
    plain = dict(cell.traffic, cycle={"wave": 1, "top_m": 4})
    moved = 0
    for score, assign, model in replay(cell, 161803, 16):
        assert run.compare(score, assign, model, cell) == {"score": 0, "assign": 0}
        # the terms change the replies: the comparison is not of the plain cycle
        without = cell.reference.assign_reply(model, plain["cycle"])[0]
        moved += int((np.asarray(assign[0]) != without).sum())
    assert moved > 0


def test_the_cycle_block_maps_to_the_program_with_the_references_weights():
    cfg = serve.cycle_config(TERMS)
    assert (cfg.wave, cfg.top_m) == (1, 4)
    assert cfg.heterogeneity.weight == cfg.sensitivity.weight == cfg.packing.weight == 1
    assert dict(cfg.packing.resource_weights) == {"cpu": 1, "memory": 1}
    assert dict(cfg.packing.headroom) == {"cpu": 500}
    plain = serve.cycle_config({"wave": 32, "top_m": 4})
    assert (plain.wave, plain.has_terms) == (32, False)


@pytest.mark.parametrize("cycle, match", [
    ({"wave": 1, "top_m": 4, "preemption": True}, "no mapping"),
    ({"wave": 1, "top_m": 4, "packing_headroom": {"cpu": 80}}, "needs terms"),
])
def test_a_cycle_key_the_program_cannot_take_is_refused(cycle, match):
    with pytest.raises(ValueError, match=match):
        serve.cycle_config(cycle)


def test_the_servicer_refuses_to_start_on_an_unknown_key(tiny_cell):
    cell = tiny_cell("basic5k.bind", cycle={"wave": 1, "top_m": 4, "preemption": True})
    served = run.Served(cell, "cpu", False, tempfile.mkdtemp(prefix="kbt-"))
    try:
        with pytest.raises(RuntimeError, match="ended"):
            served.ready()
        assert served.proc.wait(timeout=60) != 0
    finally:
        served.close()
