"""The plain reference against the port's CPU path, reply for reply, over
the bind loop."""

import numpy as np
import pytest

from kbench import run
from kbench.reference import cycle as reference


def replay(cell, seed, steps):
    """The program's replies to ``steps`` cycles of the cell's loop, on the
    CPU, with the model at each cycle, through the configuration's
    generator as the harness loads it."""
    import tempfile

    t, gen = cell.traffic, cell.generator
    model = gen.build(cell.config, seed)
    loop = gen.BindLoop(model, t["lifetime_steps"], seed)
    served = run.Served(cell, "cpu", False, tempfile.mkdtemp(prefix="kbt-")).ready()
    try:
        client = served.client
        kwargs = gen.full_sync_kwargs(model)
        for _ in range(steps):
            client.sync(**kwargs)
            score = client.score_flat(top_k=t["top_k"])
            assign = client.assign()[:2]
            yield score, assign, model
            after = loop.after_assign(model, *assign)
            kwargs, model = gen.sync_kwargs(model, after), after
    finally:
        served.close()


@pytest.mark.parametrize("name", ["basic5k.bind", "basic5k.bind_wave"])
def test_reference_equals_the_cpu_path_over_64_steps(tiny_cell, name):
    cell = tiny_cell(name, nodes=24, pending=96, init=8)
    checked = placed = 0
    for score, assign, model in replay(cell, 314159, 64):
        assert run.compare(score, assign, model, cell) == {"score": 0, "assign": 0}
        placed += int((np.asarray(assign[1]) == 0).sum())
        checked += 1
    assert checked == 64 and placed > 0


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, kbench.reference.cycle, kbench.gen.cluster, kbench.gen.tenants, "
            "kbench.control;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'koordinator_tpu_torch', 'koordinator_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(run.manifest.ROOT))
    assert out.stdout.strip() == "[]"


def test_top_k_orders_ties_by_node_index():
    import torch

    scores = torch.tensor([[5, 7, 7, 1, 7]])
    feasible = torch.tensor([[True, True, False, True, True]])
    idx, ok = reference._top_k(scores, feasible, 4)
    assert idx.tolist() == [[1, 4, 0, 3]]
    assert ok.tolist() == [[True, True, True, True]]


def test_gang_below_its_minimum_waits():
    status = reference.gang_status(np.array([3, 4, -1, 2, 0]), np.array([0, 0, 0, 1, -1]),
                                   np.array([3, 1]))
    assert status.tolist() == [2, 2, 1, 0, 0]


def test_a_full_node_is_infeasible():
    cell = run.manifest.load_cell("basic5k.bind")
    model = cell.generator.build(dict(cell.config, node_groups=[dict(cell.config["node_groups"][0], count=4)],
                       pending_pods=3, init_pods=0), 1)
    model.nreq = model.nalloc.copy()
    model.nreq[2] = 0
    assignment, status = reference.assign_reply(model, cell.traffic["cycle"])
    assert assignment.tolist() == [2, 2, 2] and status.tolist() == [0, 0, 0]
