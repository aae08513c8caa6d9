"""The port's reservation lifecycle controller
(``scheduler/reservation_controller.py``), held against the JAX package.

The reference's own cases (``tests/test_reservation_controller.py``) run
through both packages (the reference module loaded a second time with its
imports bound to the port, encoders on the CPU); a seeded stream of
lifecycle events then drives both controllers and every phase, condition,
reserve pod and ``active_reservations()`` row is compared exactly, and the
rows the port's controller leaves active encode to the same
``ReservationTable`` in both packages, with the same restored free space.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.model.reservation import encode_reservations as j_encode
from koordinator_tpu.ops.reservation import restored_node_free as j_restored
from koordinator_tpu.scheduler import reservation_controller as jrc
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.reservation import encode_reservations as t_encode
from koordinator_tpu_torch.ops.reservation import restored_node_free as t_restored
from koordinator_tpu_torch.scheduler import reservation_controller as trc
from test_torch_constraints import PACKAGES, plain, reference_cases, run_reference_case

CASES = reference_cases("test_reservation_controller")


def test_the_reference_cases_are_collected():
    assert len(CASES) >= 12


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path):
    run_reference_case(module, cls, method, package, tmp_path)


NODES = [f"node-{i}" for i in range(6)]
Gi = 1 << 30


def drive(mod, seed):
    """A seeded stream of reservation events through ``mod``'s controller:
    (every call's return, the final store, active rows, a node that
    disappears part-way)."""
    rng = np.random.default_rng(seed)
    clock = [0.0]
    gone = set()
    pods = {n: [] for n in NODES}
    ctl = mod.ReservationController(
        node_exists=lambda n: n not in gone,
        pods_on_node=lambda n: pods[n],
        gc_duration=50.0,
        clock=lambda: clock[0],
    )
    log = []
    for k in range(10):
        ctl.create(mod.Reservation(
            name=f"r{k}",
            requests={"cpu": f"{int(rng.integers(1, 8)) * 1000}m",
                      "memory": int(rng.integers(1, 16)) * Gi},
            owners=[{"label_selector": {"app": f"a{k % 3}"}}],
            ttl_seconds=float(rng.integers(10, 120)) if rng.random() < 0.8 else None,
            expires_at=float(rng.integers(30, 150)) if rng.random() < 0.2 else None,
            allocate_once=bool(rng.random() < 0.3),
            allocate_policy=["Default", "Aligned", "Restricted"][k % 3],
            priority=int(rng.integers(0, 100)),
        ))
    for step in range(40):
        clock[0] = float(step * 4)
        op = int(rng.integers(0, 7))
        name = f"r{int(rng.integers(0, 10))}"
        node = NODES[int(rng.integers(0, len(NODES)))]
        if op == 0:
            log.append(("reserve_pods", ctl.pending_reserve_pods()))
        elif op == 1:
            ctl.on_reserve_pod_assigned(name, node)
            log.append(("assigned", name, node))
        elif op == 2:
            pods[node].append({"name": f"pod-{step}", "reservation_allocated": name,
                               "requests": {"cpu": "500m", "memory": Gi}})
            ctl.sync(name)
            log.append(("owner", name))
        elif op == 3:
            ctl.sync_all()
            log.append(("sync_all",))
        elif op == 4:
            log.append(("gc", ctl.gc()))
        elif op == 5 and step > 20:
            gone.add(node)
            log.append(("node_gone", node))
        else:
            log.append(("active", ctl.active_reservations()))
    return log, plain(ctl.reservations), ctl.active_reservations()


@pytest.mark.parametrize("seed", range(6))
def test_lifecycle_streams_match(seed):
    want = drive(jrc, seed)
    got = drive(trc, seed)
    assert got == want
    phases = {r["phase"] for r in want[1].values()}
    assert len(phases) >= 2, phases


def _pods():
    return [{"name": f"p{i}", "labels": {"app": f"a{i % 3}"}} for i in range(7)]


@pytest.mark.parametrize("seed", [1, 2])
def test_active_rows_encode_the_same_table(seed):
    """What the port's controller leaves active, encoded in both packages:
    the same table and the same restored free space."""
    _, _, rows = drive(trc, seed)
    assert rows
    pods = _pods()
    jt = j_encode(rows, pods, NODES)
    tt = t_encode(rows, pods, NODES, device="cpu")
    for field in dataclasses.fields(tt):
        a, b = getattr(jt, field.name), getattr(tt, field.name)
        if isinstance(b, torch.Tensor):
            assert np.array_equal(np.asarray(a), b.numpy()), field.name
        else:
            assert a == b, field.name
    rng = np.random.default_rng(seed)
    alloc = rng.integers(8, 64, (len(NODES), res.NUM_RESOURCES)).astype(np.int64) * 1000
    requested = (alloc * rng.uniform(0.0, 0.9, alloc.shape)).astype(np.int64)
    want = np.asarray(j_restored(jnp.asarray(alloc), jnp.asarray(requested), jt))
    got = t_restored(torch.as_tensor(alloc), torch.as_tensor(requested), tt).numpy()
    assert np.array_equal(got, want)
