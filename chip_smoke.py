#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Assign cycle on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. the card's name and power limit, torch and CUDA versions;
2. build the cycle kernel from ``koordinator_tpu_torch/solver/cycle_cuda.cu``;
3. the kernel (``greedy_assign_dense`` on CUDA) against the port's plain
   ``greedy_assign`` on the same CUDA snapshot, exactly, on every case of
   ``build_cases``;
4. the headline: ``run_cycle`` on the 10k-pod x 2k-node quota_colocation
   snapshot, with the launch counter read around that one call, exact
   parity against ``greedy_assign``, and warm timings (CUDA events and host
   wall, median of 7);
5. the reference anchor: the digest of the cycle on a fixed mid-size
   snapshot against ``harness/anchor.py``'s constant, which a CPU test
   recomputes from the JAX reference;
6. a ``kernels`` JSON line, the card line, then the result line.

Imports nothing of JAX and nothing of the JAX package.  Needs one CUDA card
and exits non-zero without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# No int64 rate is published; the non-tensor fp32 rate is the nearest peak.
PEAK_OPS_PER_S = 67e12
TIMED_RUNS = 7


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, runs=TIMED_RUNS):
    """Median (CUDA-event ms, host-wall ms) over ``runs`` calls of ``fn``."""
    import torch

    ev, wall = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - w0) * 1e3)
        ev.append(start.elapsed_time(end))
    return statistics.median(ev), statistics.median(wall)


FIELDS = ("assignment", "status", "node_requested", "node_estimated", "quota_used")


def assert_same(name, got, want):
    import torch

    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{name}: {f} differs between kernel and plain version")


def build_cases(dev):
    """(name, snapshot, cfg, extra_mask, extra_scores) for phase 3."""
    import numpy as np
    import torch

    from koordinator_tpu_torch.config import AggregatedArgs, CycleConfig, LoadAwareArgs
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.model import encode_snapshot

    def enc(lists):
        return encode_snapshot(*lists, device=dev)

    quota_small = g.quota_colocation_snapshot(pods=512, nodes=128, device=dev)[0]
    nodes, pods, gangs, quotas = g.loadaware_joint(seed=5, pods=1000, nodes=200)
    ext = encode_snapshot(g.with_usage_extensions(nodes, seed=5), pods, gangs, quotas,
                          device=dev)
    prod_cfg = CycleConfig(loadaware=LoadAwareArgs(
        prod_usage_thresholds={"cpu": 55, "memory": 80},
        score_according_prod_usage=True,
        aggregated=AggregatedArgs(usage_thresholds={"cpu": 60, "memory": 90},
                                  usage_aggregation_type="p95",
                                  score_aggregation_type="p90"),
    ))
    rng = np.random.RandomState(11)
    P, N = quota_small.pods.capacity, quota_small.nodes.capacity
    xmask = torch.from_numpy(rng.uniform(size=(P, N)) > 0.25).to(dev)
    xscores = torch.from_numpy(rng.randint(0, 60, size=(P, N)).astype(np.int64)).to(dev)
    return [
        ("spark_colocation", enc(g.spark_colocation()), CycleConfig(), None, None),
        ("loadaware_joint_1kx200", enc(g.loadaware_joint()), CycleConfig(), None, None),
        ("gang_batch_5kx500", enc(g.gang_batch()), CycleConfig(), None, None),
        ("quota_colocation_512x128", quota_small, CycleConfig(), None, None),
        ("most_allocated", quota_small,
         CycleConfig(fit_scoring_strategy="MostAllocated"), None, None),
        ("loadaware_disabled", quota_small, CycleConfig(enable_loadaware=False),
         None, None),
        ("prod_usage_and_aggregated", ext, prod_cfg, None, None),
        ("scarce_capacity", enc(g.loadaware_joint(seed=7, pods=600, nodes=4)),
         CycleConfig(), None, None),
        ("extra_mask_and_scores", quota_small, CycleConfig(), xmask, xscores),
    ]


def cycle_bound_ms(inp) -> tuple:
    """The least time the card could take for one cycle on ``inp``: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its integer operations over the peak rate.
    Operations count this run's data: for every valid pod and every node,
    two per requested resource (Fit), six per Fit-weighted and seven per
    LoadAware-weighted resource (score), and four for the argmax and sums."""
    tensors = [inp.preq, inp.psreq, inp.pest, inp.qid, inp.pvalid, inp.pprod,
               inp.alloc, inp.req0, inp.usage, inp.flags, inp.qrt, inp.qlim,
               inp.quse0, inp.weights]
    if inp.uprod.data_ptr() != inp.usage.data_ptr():
        tensors.append(inp.uprod)
    if inp.xcomb is not None:
        tensors.append(inp.xcomb)
    in_bytes = sum(t.numel() * t.element_size() for t in tensors)
    out_bytes = (inp.preq.shape[0] * 4 + 2 * inp.alloc.numel() * 8
                 + inp.quse0.numel() * 8)
    valid = inp.pvalid != 0
    requested = int(((inp.preq > 0) & valid[:, None]).sum())
    n_valid_pods = int(valid.sum())
    N = inp.alloc.shape[1]
    w_fit = int((inp.weights[0] != 0).sum())
    w_la = int((inp.weights[1] != 0).sum())
    ops = N * (2 * requested + n_valid_pods * (6 * w_fit + 7 * w_la + 4))
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU",
              file=sys.stderr)
        return 1

    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.harness.anchor import (
        ANCHOR_RECIPE, ANCHOR_SHA256, cycle_digest,
    )
    from koordinator_tpu_torch.solver import dense, greedy_assign, run_cycle
    from koordinator_tpu_torch.config import CycleConfig

    # phase 1
    card = card_line()
    dev = torch.device("cuda")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # phase 2
    built = _build.build(dense.KERNEL_SOURCE)
    print(f"build: {built.path.name} in {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    # phase 3
    for name, snap, cfg, xm, xs in build_cases(dev):
        got = dense.greedy_assign_dense(snap, cfg, extra_mask=xm, extra_scores=xs)
        want = greedy_assign(snap, cfg, extra_mask=xm, extra_scores=xs)
        torch.cuda.synchronize()
        if got.path != "cuda":
            raise AssertionError(f"{name}: kernel path not taken ({got.path})")
        assert_same(name, got, want)
        placed = int((got.assignment >= 0).sum())
        print(f"parity {name}: exact, {placed}/{snap.num_pods} placed")

    # phase 4: the main path, with the launch counters read around it
    cfg = CycleConfig()
    t0 = time.perf_counter()
    snap = g.quota_colocation_snapshot(device=dev)[0]
    encode_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    dense.reset_launches()
    result = run_cycle(snap, cfg)
    torch.cuda.synchronize()
    launches = dense.LAUNCHES
    if launches < 1:
        raise AssertionError("the headline cycle did not launch the cycle kernel")
    if result.path != "cuda":
        raise AssertionError(f"headline cycle took path {result.path}")
    oracle = greedy_assign(snap, cfg)
    torch.cuda.synchronize()
    assert_same("headline", result, oracle)
    assigned = int((result.assignment >= 0).sum())
    cycle_ev, cycle_wall = cuda_time(lambda: run_cycle(snap, cfg))

    inp = dense.prepare_cycle_inputs(snap, cfg)
    kernel_out = dense.cycle_dense_cuda(inp, cfg)
    kernel_ms, _ = cuda_time(lambda: dense.cycle_dense_cuda(inp, cfg))
    plain_ms, _ = cuda_time(lambda: dense.cycle_dense_reference(inp, cfg), runs=1)
    plain_out = dense.cycle_dense_reference(inp, cfg)
    max_abs_err = max(
        int((a.long() - b.long()).abs().max()) for a, b in zip(kernel_out, plain_out)
    )
    if max_abs_err != 0:
        raise AssertionError(f"kernel vs plain version: max abs err {max_abs_err}")
    bound_ms, bound_by = cycle_bound_ms(inp)
    print(json.dumps({"headline": {
        "snapshot": "quota_colocation 10000 pods x 2000 nodes, 16 tenants, seed 0",
        "assigned": assigned, "pods": snap.num_pods, "nodes": snap.num_nodes,
        "encode_s": encode_s, "cycle_ms_cuda_events": cycle_ev,
        "cycle_ms_host_wall": cycle_wall, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "timed_runs": TIMED_RUNS,
        "parity": "exact vs greedy_assign",
    }}))

    # phase 5
    anchor = g.quota_colocation_snapshot(**ANCHOR_RECIPE, device=dev)[0]
    ar = run_cycle(anchor, cfg)
    digest = cycle_digest(ar.assignment.cpu(), ar.status.cpu())
    if digest != ANCHOR_SHA256:
        raise AssertionError(f"anchor digest {digest} != {ANCHOR_SHA256}")
    print(f"anchor: {ANCHOR_RECIPE} digest matches the reference ({digest[:16]})")

    # phase 6
    print(json.dumps({"kernels": [{
        "name": "cycle_dense",
        "route": "cuda",
        "source": "koordinator_tpu_torch/solver/cycle_cuda.cu",
        "replaces": "koordinator_tpu/solver/pallas_dense.py:114",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "parity": "exact",
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
