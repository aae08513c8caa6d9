"""The per-pod cycle kernels K2 and K1 (``solver/cycle_cuda.cu``) on the
card, exact against their plain versions (``wide.cycle_wide_reference``,
``dense.cycle_dense_reference``) in all five ``CycleResult`` arrays, on
queues that take the kernels' run path (a pod whose rows equal the
previous valid pod's, in a run of three or more, reuses that pod's
scores) and queues that bypass it; the
kernel's ``run_pods`` equals the plain count of the same inputs
(``dense.inputs_run_pods``).

Runs where CUDA is present and skips elsewhere; this file imports no JAX
and carries its own ``card`` fixture, so on the card it also runs without
the suite's conftest::

    python -m pytest tests/test_torch_cycle_card.py -m card --noconftest -q

The queues (``CASES``) are built on any device; ``tests/test_torch_run_pods.py``
holds the plain count to them on the CPU.
"""

import dataclasses
from typing import Callable, Optional

import pytest
import torch

from koordinator_tpu_torch.config import AggregatedArgs, CycleConfig, LoadAwareArgs
from koordinator_tpu_torch.harness import generators as g
from koordinator_tpu_torch.model import encode_snapshot
from koordinator_tpu_torch.solver import dense, greedy, wide

pytestmark = pytest.mark.card

FIELDS = ("assignment", "status", "node_requested", "node_estimated", "quota_used")
PROD_CFG = CycleConfig(loadaware=LoadAwareArgs(
    prod_usage_thresholds={"cpu": 55, "memory": 80},
    score_according_prod_usage=True,
    aggregated=AggregatedArgs(usage_thresholds={"cpu": 60, "memory": 90},
                              usage_aggregation_type="p95", score_aggregation_type="p90"),
))


def node(i, cpu="8000m", memory=32 << 30):
    return {"name": f"node-{i}", "allocatable": {"cpu": cpu, "memory": memory, "pods": 110}}


def pod(i, cpu="500m", memory=1 << 30, priority=100, **kw):
    return {"name": f"pod-{i}", "requests": {"cpu": cpu, "memory": memory, "pods": 1},
            "priority": priority, **kw}


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    # dev -> (snapshot, cfg, extra_mask, extra_scores)
    build: Callable
    # the cycle inputs as the kernels take them -> edited inputs
    edit: Optional[Callable] = None
    k2: bool = True  # the int32 kernel takes the inputs
    resident: bool = True  # the node slices fit in shared memory
    # the plain count, where the case fixes it (P valid pods)
    runs: Optional[Callable[[int], int]] = None


def _snap(nodes, pods, gangs=(), quotas=(), dev="cpu"):
    return encode_snapshot(nodes, pods, list(gangs), list(quotas), node_bucket=len(nodes),
                           device=dev)


def _identical(n_nodes, n_pods, cfg=CycleConfig(), **pod_kw):
    def build(dev):
        return (_snap([node(i) for i in range(n_nodes)],
                      [pod(p, **pod_kw) for p in range(n_pods)], dev=dev), cfg, None, None)
    return build


def _broken(dev):
    pods = [pod(p) for p in range(400)]
    pods[150] = pod(150, cpu="700m")
    return _snap([node(i) for i in range(200)], pods, dev=dev), CycleConfig(), None, None


def _three_bands(dev):
    """Three templates at three priorities, interleaved in the slots: the
    queue order makes them three runs."""
    shapes = (("500m", 1 << 30, 9000), ("1500m", 2 << 30, 7000), ("250m", 512 << 20, 5000))
    pods = [pod(p, cpu=shapes[p % 3][0], memory=shapes[p % 3][1], priority=shapes[p % 3][2])
            for p in range(450)]
    return _snap([node(i) for i in range(100)], pods, dev=dev), CycleConfig(), None, None


def _flip_prod(inp):
    pprod = inp.pprod.clone()
    pprod[[120, 121, 300]] ^= 1
    return dataclasses.replace(inp, pprod=pprod)


def _holes(inp):
    pvalid = inp.pvalid.clone()
    pvalid[[0, 10, 11, 12, 200, 399]] = 0
    return dataclasses.replace(inp, pvalid=pvalid)


def _quota_mid_run(dev):
    """One template under two ElasticQuota groups, alternating: the small
    group blocks its pods part-way through the run, the other admits."""
    quotas = [{"name": "small", "runtime": {"cpu": "4000m", "memory": 64 << 30}, "used": {}},
              {"name": "large", "runtime": {"cpu": "400000m", "memory": 4 << 40}, "used": {}}]
    pods = [pod(p, quota=("small", "large")[p % 2]) for p in range(300)]
    return (_snap([node(i) for i in range(64)], pods, quotas=quotas, dev=dev), CycleConfig(),
            None, None)


def _run_starts_blocked(dev):
    """One template, the first pod and every other one in a group with no
    cpu left: the run starts from a pod its quota blocked."""
    quotas = [{"name": "empty", "runtime": {"cpu": "0m", "memory": 64 << 30}, "used": {}},
              {"name": "large", "runtime": {"cpu": "400000m", "memory": 4 << 40}, "used": {}}]
    pods = [pod(p, quota=("empty", "large")[p % 2]) for p in range(200)]
    return (_snap([node(i) for i in range(64)], pods, quotas=quotas, dev=dev), CycleConfig(),
            None, None)


def _quota_full_steps(dev):
    """Pods of distinct rows under two groups, alternating: the small
    group blocks pods that take the full step."""
    quotas = [{"name": "small", "runtime": {"cpu": "4000m", "memory": 64 << 30}, "used": {}},
              {"name": "large", "runtime": {"cpu": "400000m", "memory": 4 << 40}, "used": {}}]
    pods = [pod(p, cpu=f"{400 + p}m", quota=("small", "large")[p % 2]) for p in range(300)]
    return (_snap([node(i) for i in range(64)], pods, quotas=quotas, dev=dev), CycleConfig(),
            None, None)


def _fill_up(dev):
    """Eight nodes of four pods each and 100 pods: the run ends in -1s."""
    return (_snap([node(i, cpu="2000m") for i in range(8)], [pod(p) for p in range(100)],
                  dev=dev), CycleConfig(), None, None)


def _most_allocated(dev):
    nodes = [node(i, cpu=("8000m", "16000m")[i % 2], memory=(32 << 30, 64 << 30)[i % 2])
             for i in range(120)]
    return (_snap(nodes, [pod(p) for p in range(500)], dev=dev),
            CycleConfig(fit_scoring_strategy="MostAllocated"), None, None)


def _device_memory(dev):
    """16,384 nodes: slices too large for shared memory."""
    nodes = g.quota_colocation(seed=3, pods=1, nodes=16384)[0]
    return _snap(nodes, [pod(p) for p in range(96)], dev=dev), CycleConfig(), None, None


def _beyond_int32(dev):
    """Memory beyond the int32 kernels' bound: K1 only."""
    nodes = [node(i, memory=1 << 45) for i in range(64)]
    pods = [pod(p, memory=1 << 40) for p in range(200)]
    return _snap(nodes, pods, dev=dev), CycleConfig(), None, None


def _xcomb(dev):
    snap = _snap([node(i) for i in range(64)], [pod(p) for p in range(200)], dev=dev)
    gen = torch.Generator(device="cpu").manual_seed(5)
    shape = (snap.pods.capacity, snap.nodes.capacity)
    mask = (torch.rand(shape, generator=gen) < 0.8).to(dev)
    scores = torch.randint(0, 50, shape, generator=gen).to(dev)
    return snap, CycleConfig(), mask, scores


def _pairs(dev):
    """Pods in equal pairs: no run of three, so every pod takes the full
    step."""
    pods = [pod(p, cpu=f"{100 + p // 2}m") for p in range(200)]
    return _snap([node(i) for i in range(64)], pods, dev=dev), CycleConfig(), None, None


def _distinct(dev):
    pods = [pod(p, cpu=f"{100 + p}m") for p in range(200)]
    return _snap([node(i) for i in range(64)], pods, dev=dev), CycleConfig(), None, None


CASES = [
    Case("identical_300_nodes", _identical(300, 600), runs=lambda P: P - 1),
    Case("identical_1000_nodes", _identical(1000, 400), runs=lambda P: P - 1),
    Case("five_nodes_fewer_than_ctas", _identical(5, 64), runs=lambda P: P - 1),
    Case("broken_by_one_pod", _broken, runs=lambda P: P - 3),
    Case("three_runs_by_priority", _three_bands, runs=lambda P: P - 3),
    Case("flipped_prod_bit", _identical(200, 400, cfg=PROD_CFG), edit=_flip_prod,
         runs=lambda P: P - 6),
    Case("invalid_inside_a_run", _identical(200, 400), edit=_holes, runs=lambda P: P - 1),
    Case("quota_blocks_mid_run", _quota_mid_run, runs=lambda P: P - 1),
    Case("quota_blocks_full_steps", _quota_full_steps, runs=lambda P: 0),
    Case("run_starts_blocked", _run_starts_blocked, runs=lambda P: P - 1),
    Case("nodes_fill_up", _fill_up, runs=lambda P: P - 1),
    Case("most_allocated", _most_allocated, runs=lambda P: P - 1),
    Case("device_memory_16384_nodes", _device_memory, resident=False, runs=lambda P: P - 1),
    Case("k1_beyond_int32", _beyond_int32, k2=False, runs=lambda P: P - 1),
    Case("xcomb", _xcomb, runs=lambda P: 0),
    Case("run_length_one", _distinct, runs=lambda P: 0),
    Case("equal_pairs", _pairs, runs=lambda P: 0),
]


def edited(case, inp):
    return inp if case.edit is None else case.edit(inp)


def kernel_and_plain(case, kernel, dev):
    """(the kernel's CycleResult, the plain version's, the kernel's cluster
    plan, the inputs) on ``case``'s inputs; each result's ``run_pods``
    set."""
    snap, cfg, xm, xs = case.build(dev)
    runs = torch.zeros(1, dtype=torch.int32, device=dev)
    if kernel == "K2":
        inp = edited(case, wide.prepare_wide_inputs(snap, cfg, xm, xs))
        got = wide.wide_result(snap, inp, wide.cycle_wide_cuda(inp, cfg, run_pods=runs)
                               + (None,), "cuda", runs)
        want = wide.wide_result(snap, inp, wide.cycle_wide_reference(inp, cfg) + (None,),
                                "plain", dense.inputs_run_pods(inp))
        return got, want, wide.wide_plan(inp), inp
    inp = edited(case, dense.prepare_cycle_inputs(snap, cfg, xm, xs))

    def result(outs, path, run_pods):
        chosen, nreq, nest, quse = outs
        return greedy.finish_cycle(snap, inp.order, chosen, nreq.t().contiguous(),
                                   nest.t().contiguous(), quse, path=path, run_pods=run_pods)

    got = result(dense.cycle_dense_cuda(inp, cfg, run_pods=runs), "cuda", runs)
    want = result(dense.cycle_dense_reference(inp, cfg), "plain", dense.inputs_run_pods(inp))
    return got, want, dense.cycle_plan(inp), inp


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", ["K2", "K1"])
@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_the_kernel_equals_its_plain_version(card, case, kernel):
    if kernel == "K2" and not case.k2:
        pytest.skip("the int32 kernel refuses these inputs; K1 takes them")
    got, want, plan, inp = kernel_and_plain(case, kernel, card)
    torch.cuda.synchronize()
    assert bool(plan["resident"]) == case.resident, plan
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f"{case.name} {kernel}: {f} differs"
    assert int(got.run_pods) == int(want.run_pods), (int(got.run_pods), int(want.run_pods))
    if case.runs is not None:
        assert int(got.run_pods) == case.runs(int((inp.pvalid != 0).sum()))
