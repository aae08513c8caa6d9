#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Assign cycle on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. the card's name and power limit, torch and CUDA versions;
2. build the three cycle kernels from their two sources, and the
   instrumented build of each source (``-DKOORD_PHASE_CLOCK``), one
   ``nvcc`` per build, all started together: K1 and K2
   (``solver/cycle_cuda.cu``, one templated per-pod body instantiated in
   int64 and int32) and K3 (``solver/cycle_wide_cuda.cu``); build seconds,
   ptxas registers and spills of each kernel, and a failure on any spill
   byte;
3. every kernel against its plain version on the card, exactly, on every
   case of ``build_cases``: K1 (``greedy_assign_dense``) against
   ``greedy_assign``; K2 (``greedy_assign_wide`` at wave 1) and K3 (at
   (wave, top_m) = (8, 2) and (32, 4)) against ``cycle_wide_reference`` and
   ``wave_cycle_reference``, all five ``CycleResult`` arrays and K3's
   rounds; then K3 under MostAllocated at (8, 4) and on the contention
   case, and K1 on extra scores beyond the int32 kernels' range (which
   ``greedy_assign_wide`` refuses); then the cases of ``cluster_cases``,
   which exercise the cluster layer of K1, K2 and K3 (fewer nodes than
   CTAs, a node count that is no multiple of the cluster size, identical
   nodes whose ties cross slice borders, MostAllocated, and node slices too
   large for shared memory, which take the device-memory path: each
   kernel's plan must agree), each kernel exact against its plain version,
   K3's rounds included;
4. the headlines on the 10k-pod x 2k-node quota_colocation snapshot, each
   path driven through ``run_cycle`` on the inputs that select its kernel,
   with every launch count set to 0 just before it and read just after,
   exact against ``greedy_assign``, no demotion and no other kernel
   launched, timed (CUDA events and host wall, median of 7), its kernel
   timed alone and its plain version once: K2's path ``run_cycle(snap)``,
   K3's path ``run_cycle(snap, CycleConfig(wave=32, top_m=4))``, K1's path
   ``run_cycle(snap, extra_mask=..., extra_scores=...)`` with extra scores
   up to 2^31 (and the wave request on them, which K1 also takes); the
   ``headline``, ``wave_headline`` and ``dense_headline`` lines carry each
   cluster plan (cluster size, shared bytes per CTA, occupancy at 8 and 16
   CTAs), K2's and K1's microseconds per pod step in Filter/Score,
   staging, barrier and merge, and K3's phase-A, merge and phase-B
   microseconds per round, from the instrumented builds of the same
   sources; the ``headline`` line also carries K1's kernel time on the
   same default inputs, which K2 must not exceed for the ladder's K2-first
   order to hold;
5. the reference anchors: the digest of the per-pod (K2 and K1) and of the
   wave cycle on a fixed mid-size snapshot against ``harness/anchor.py``'s
   constant, and the wave cycle's rounds against the reference kernel's,
   both recomputed from the JAX reference by a CPU test;
6. ``score_headline``: the Score RPC's device side on the headline snapshot,
   under the default and the term configuration: ``score_cycle``, then
   ``masked_top_k(k=32, hi=score_upper_bound(cfg))``, then the [P, 32]
   readback, each timed (median of 7, CUDA events and host wall) with the
   peak device memory; the card's (scores, feasible) equal the CPU path's
   on 256 sampled pod rows, its top-k equals ``masked_top_k_host`` of its
   own full readback, and at the anchor recipe both top-k digests equal
   the JAX-derived constants;
7. ``terms_cycle``: ``run_cycle`` under the term configuration at the
   headline, which takes K2, and with ``wave=32, top_m=4``, which takes K3,
   each exact against ``greedy_assign`` on the term extras and each kernel
   against its plain version, no demotion and no other kernel; the cost of
   ``term_extras`` apart; the term cycle's digest at the anchor recipe;
8. ``incremental``: a seeded warm delta (64 dirty node rows, 16 dirty pod
   rows) through ``apply_flat_delta``, then ``rescore_dirty``, equal bit for
   bit to a full ``score_cycle`` of the updated snapshot, under both
   configurations, each step timed;
9. ``sparse``: the candidate engine at 2^21 nodes x 512 pods, width 256
   (cold build on the pipelined route, a refresh after a 64-node delta,
   ``score_candidates`` + ``sparse_top_k``, timed), and at 4,096 nodes its
   top-k equal to the dense ``score_cycle`` + ``masked_top_k``, its refreshed
   lists equal to a fresh build, and an overflowing width refused;
10. the seconds of each phase, a ``kernels`` JSON line, the card line, then
    the result line;
11. (run before phase 10's lines) ``bridge``: the serving seam at the
    headline through the raw-UDS transport (``bridge/udsserver.py``): a full
    Sync from ``harness/golden.build_sync_request`` whose resident snapshot
    equals ``encode_snapshot``'s, the first Assign (K2 launched exactly once,
    no demotion) equal to phase 4's ``run_cycle``, three warm delta Syncs
    (each under 1 % of the full frame) with Assigns equal to ``run_cycle``
    on the updated snapshot, a Score and a warm incremental Score equal to
    the in-process ``score_cycle`` + ``masked_top_k``, three cold cycles, an
    8-client x 16 Score storm equal to the serial reply, Assigns on K3 and
    K1 through the servicer, the Go plugin's flow equal to the fixtures'
    ``expected.json``, no protobuf runtime loaded, and, where ``grpc``
    imports, the gRPC transport on the golden fixtures; each RPC timed
    against its in-process call;
12. (run before phase 10's lines) ``trace``: the reference's accelerator
    trace (``harness/anchor.py TRACE_ANCHOR_CFG``: 512 nodes x 2,048 pod
    slots, 96 events; its digest against the constant a CPU test
    recomputes from the JAX package) replayed by ``TraceReplay`` through
    the port's ``ScorerClient``: over the raw framing (97 parity checks
    against the serial oracle, no build and no demotion in the measured
    pass, exactly one K2 launch per Assign, the engine's K2 launches of
    the cold step and of every 8th event exact against
    ``cycle_wide_reference`` on the CPU on their own inputs, one Sync
    carrying a tensor per event that changes one, the SLO verdicts,
    p50/p99 per RPC and per band); over gRPC where ``grpc`` imports (three
    K2 launches held the same way); a ledger pass (``devprof_sample=1``,
    the engine alone: per-boundary sampled spans, and their sum per RPC
    over its host wall); a Profile pass (admin method 5 over the
    socket opens a ``torch.profiler`` window over about 20 steps: the
    device busy share and its split by kernel family); an exported pass
    assembled with no incomplete trace; and the trace at the headline
    cluster size (2,000 nodes x 10,000 pod slots, 24 events, 25 parity
    checks, three K2 launches held against the plain version).  Every
    pass checks the engine's Syncs by kind.  The ``kernels`` line carries each kernel's launches on the
    trace path (``trace_launches``);
13. (run before phase 10's lines) ``extras``: the extended-plugin Assign
    cycle (the reference's ``bench.py --config extras``): at the anchor
    recipe the composed mask and scores and the cycle on K2 and on K1 equal
    the JAX-derived digests; at 10,000 pods x 2,000 nodes the NUMA,
    Reservation and DeviceShare plugins composed by the FrameworkExtender
    (timed, with its peak device memory), their mask and scores equal to
    the CPU path on 1,024 pod rows spread across the pods,
    ``FrameworkExtender.run_cycle`` launching K2 once and, with
    ``i32_ok=False``, K1 once, both exact against one plain run (each
    cycle timed), then the Reserve and PreBind hooks (cpusets on every
    node's topology, LSR on every 16th pod from the third; device minors; reservation
    annotations) equal to the CPU path's, timed, with the CUDA launches a
    ``torch.profiler`` window counts during them; the ``kernels`` line
    carries the launches (``extras_launches``);
14. (run before phase 10's lines) ``rebalance``: the LowNodeLoad leg (the
    reference's ``bench.py --config rebalance``): at the anchor recipe the
    dry-run plan of ``balance`` on the card's placements equals the
    JAX-derived digest; at the headline ``run_cycle(snap)`` (K2 once,
    exact) places the pods and ``balance`` plans evictions, timed
    (``rebalance_launches`` on the ``kernels`` line).

Imports nothing of JAX and nothing of the JAX package.  Needs one CUDA card
and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# No integer rate is published; the non-tensor fp32 rate is the nearest peak.
PEAK_OPS_PER_S = 67e12
TIMED_RUNS = 7
WAVE_CFG = {"wave": 32, "top_m": 4}
# K1's headline: extra scores in [0, EXTRA_HI), beyond the int32 kernels'
# 2^29, on 90 % of the (pod, node) pairs
EXTRA_HI = 2**31


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


def timed_once(fn):
    """(CUDA-event ms, result) of one call of ``fn``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


FIELDS = ("assignment", "status", "node_requested", "node_estimated", "quota_used")


def assert_same(name, got, want):
    import torch

    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{name}: {f} differs between kernel and plain version")


def max_abs_err(outs, refs) -> int:
    return max(int((a.long() - b.long()).abs().max())
               for a, b in zip(outs, refs) if a is not None)


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


def contention_case(dev):
    """16 one-pod nodes and 12 identical pods: every wave degrades to
    single commits (``tests/test_pallas_cycle.py``)."""
    from koordinator_tpu_torch.model import encode_snapshot

    nodes = [{"name": f"tight-{i}",
              "allocatable": {"cpu": "1000m", "memory": 1 << 30, "pods": 110}}
             for i in range(16)]
    pods = [{"name": f"pod-{p}",
             "requests": {"cpu": "900m", "memory": 512 << 20, "pods": 1}}
            for p in range(12)]
    return encode_snapshot(nodes, pods, [], [], device=dev)


def identical_nodes_case(dev, nodes, pods):
    """``nodes`` identical nodes and ``pods`` pods of three shapes: every
    pod's scores tie across the nodes, so each argmax and top-M crosses the
    slice borders of the cluster kernels."""
    from koordinator_tpu_torch.model import encode_snapshot

    node_list = [{"name": f"same-{i}",
                  "allocatable": {"cpu": "8000m", "memory": 32 << 30, "pods": 110}}
                 for i in range(nodes)]
    shapes = (("500m", 1 << 30), ("1500m", 2 << 30), ("250m", 512 << 20))
    pod_list = [{"name": f"pod-{p}",
                 "requests": {"cpu": shapes[p % 3][0], "memory": shapes[p % 3][1], "pods": 1}}
                for p in range(pods)]
    return encode_snapshot(node_list, pod_list, [], [], node_bucket=nodes, device=dev)


def cluster_cases(dev):
    """(name, snapshot, cfg, resident) for the cluster layer of K1 and K3:
    ``resident`` is whether the node slices must fit in shared memory (the
    last case is built to overflow it and take the device-memory path)."""
    from koordinator_tpu_torch.config import CycleConfig
    from koordinator_tpu_torch.harness import generators as g

    most = CycleConfig(fit_scoring_strategy="MostAllocated")
    q5 = g.quota_colocation_snapshot(pods=64, nodes=5, device=dev)[0]
    q37 = g.quota_colocation_snapshot(pods=300, nodes=37, device=dev)[0]
    same = identical_nodes_case(dev, nodes=40, pods=200)
    big = g.quota_colocation_snapshot(pods=256, nodes=16384, device=dev)[0]
    return [
        ("five_nodes", q5, CycleConfig(), True),
        ("37_nodes", q37, CycleConfig(), True),
        ("37_nodes_most_allocated", q37, most, True),
        ("identical_40_nodes", same, CycleConfig(), True),
        ("identical_40_nodes_most_allocated", same, most, True),
        ("device_memory_16384_nodes", big, CycleConfig(), False),
    ]


def extras_beyond_int32(snap, seed):
    """(extra_mask, extra_scores) on the snapshot's device, made from
    ``seed``: 90 % of the (pod, node) pairs admitted, scores uniform in
    [0, EXTRA_HI), past the int32 kernels' 2^29, so ``run_cycle`` takes K1."""
    import torch

    dev = snap.nodes.allocatable.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (snap.pods.capacity, snap.nodes.capacity)
    mask = torch.rand(shape, generator=gen, device=dev) < 0.9
    scores = torch.randint(0, EXTRA_HI, shape, generator=gen, device=dev)
    return mask, scores


def wide_parity(name, snap, cfg, xm, xs):
    """K2 (``cfg.wave <= 1``) or K3 through ``greedy_assign_wide`` on the
    card against the plain version on the same inputs: the five arrays and
    the rounds.  Returns the kernel's result."""
    import torch

    from koordinator_tpu_torch.solver import wide

    got = wide.greedy_assign_wide(snap, cfg, extra_mask=xm, extra_scores=xs)
    inp = wide.prepare_wide_inputs(snap, cfg, xm, xs)
    if cfg.wave > 1:
        outs = wide.wave_cycle_reference(inp, cfg, cfg.wave, cfg.top_m)
    else:
        outs = wide.cycle_wide_reference(inp, cfg) + (None,)
    want = wide.wide_result(snap, inp, outs, path="plain")
    torch.cuda.synchronize()
    if got.path != "cuda":
        raise AssertionError(f"{name}: kernel path not taken ({got.path})")
    assert_same(name, got, want)
    if (got.rounds is None) != (want.rounds is None) or (
        got.rounds is not None and int(got.rounds) != int(want.rounds)
    ):
        raise AssertionError(f"{name}: rounds {got.rounds} != plain {want.rounds}")
    return got


def wave_phase_split(inp, cfg):
    """K3's round split, from one run of the instrumented build of its
    source: the leader's clock64 cycles of phase A (with the staging and
    the barrier), the merge and phase B (with its barrier) split the run's
    CUDA-event time; the staging and phase B's re-keys are shown apart."""
    import torch

    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.solver import wide

    def run():
        return wide.wave_cycle_cuda(inp, cfg, cfg.wave, cfg.top_m, defines=_build.PHASE_CLOCK)

    run()
    torch.cuda.synchronize()
    wide.wave_phase_cycles()  # drop the warm-up's counts
    ms, out = timed_once(run)
    a, m, b, staging, rekey = wide.wave_phase_cycles()
    rounds = int(out[4][0])
    total = max(a + m + b, 1)
    us = ms * 1e3

    def per_round(cycles):
        return us * cycles / total / rounds

    return {"rounds": rounds, "instrumented_kernel_ms": ms,
            "phase_a_us_per_round": per_round(a), "merge_us_per_round": per_round(m),
            "phase_b_us_per_round": per_round(b),
            "staging_in_phase_a_us_per_round": per_round(staging),
            "rekeys_in_phase_b_us_per_round": per_round(rekey),
            "leader_cycles_per_us": total / us}


def pod_split(kernel, counters, inp, cfg):
    """K1's or K2's pod step split, from one run of the instrumented build
    of its source (``kernel``, its wrapper; ``counters``, its counter
    read): rank 0's clock64 cycles of quota and Filter/Score, of staging
    the next pod, of the warp reduction and cluster barrier, and of the
    merge and Reserve split the run's CUDA-event time over the valid
    pods."""
    import torch

    from koordinator_tpu_torch import _build

    def run():
        return kernel(inp, cfg, defines=_build.PHASE_CLOCK)

    run()
    torch.cuda.synchronize()
    counters()  # drop the warm-up's counts
    ms, _ = timed_once(run)
    parts = counters()
    pods = int((inp.pvalid != 0).sum())
    total = max(sum(parts), 1)
    us = ms * 1e3
    names = ("score_us_per_pod", "stage_us_per_pod", "barrier_us_per_pod",
             "merge_reserve_us_per_pod")
    out = {name: us * v / total / pods for name, v in zip(names, parts)}
    return {"instrumented_kernel_ms": ms, **out, "rank0_cycles_per_us": total / us}


def _io_bytes(inp) -> int:
    """Bytes of a cycle's inputs read once and its outputs written once."""
    tensors = [inp.preq, inp.psreq, inp.pest, inp.qid, inp.pvalid, inp.pprod,
               inp.alloc, inp.req0, inp.usage, inp.flags, inp.qrt, inp.qlim,
               inp.quse0, inp.weights]
    if inp.uprod.data_ptr() != inp.usage.data_ptr():
        tensors.append(inp.uprod)
    if inp.xcomb is not None:
        tensors.append(inp.xcomb)
    in_bytes = sum(t.numel() * t.element_size() for t in tensors)
    out_bytes = (inp.preq.shape[0] * 4 + 2 * inp.alloc.numel() * inp.alloc.element_size()
                 + inp.quse0.numel() * inp.quse0.element_size())
    return in_bytes + out_bytes


def _cell_ops(inp):
    """(integer operations of one pod x node Filter+Score cell, averaged
    over this run's valid pods, valid pods): two per requested resource
    (Fit), six per Fit-weighted and seven per LoadAware-weighted resource
    (score), two for the extra mask and score, four for the argmax and
    sums."""
    valid = inp.pvalid != 0
    requested = int(((inp.preq > 0) & valid[:, None]).sum())
    n_valid_pods = int(valid.sum())
    w_fit = int((inp.weights[0] != 0).sum())
    w_la = int((inp.weights[1] != 0).sum())
    extras = 2 if inp.xcomb is not None else 0
    per_cell = 2 * requested / max(n_valid_pods, 1) + 6 * w_fit + 7 * w_la + extras + 4
    return per_cell, n_valid_pods


def _bound(byte_count, ops):
    t_bytes = byte_count / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cycle_bound_ms(inp, extra_out_bytes=0) -> tuple:
    """The least time the card could take for one cycle's function on
    ``inp``: the larger of its bytes over the memory rate and its integer
    operations over the peak rate.  Operations count what this run's
    outputs need: every valid pod scored once against every node
    (``_cell_ops``).  The same for K1, K2 and K3, which compute the same
    placements; K3's extra phase-A and re-key cells are its own work, not
    the function's, and are reported apart.  ``extra_out_bytes``: K3's
    rounds word."""
    per_cell, n_valid_pods = _cell_ops(inp)
    return _bound(_io_bytes(inp) + extra_out_bytes,
                  n_valid_pods * inp.alloc.shape[1] * per_cell)


def map_snapshot(snap, fn):
    """``snap`` with ``fn`` applied to every tensor (``.cpu()``,
    ``.clone()``)."""
    import torch

    def table(t):
        return dataclasses.replace(t, **{
            f.name: fn(getattr(t, f.name)) for f in dataclasses.fields(t)
            if isinstance(getattr(t, f.name), torch.Tensor)})

    return dataclasses.replace(
        snap, nodes=table(snap.nodes), pods=table(snap.pods), gangs=table(snap.gangs),
        quotas=table(snap.quotas),
        throughput=None if snap.throughput is None else fn(snap.throughput))


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def snapshot_bytes(snap) -> int:
    """Bytes of the pod and node tables a Score reads once."""
    n, p = snap.nodes, snap.pods
    return tensor_bytes(n.allocatable, n.requested, n.usage, n.metric_fresh, n.valid,
                        n.agg_usage, n.agg_fresh, n.prod_usage, n.accel_type,
                        p.requests, p.estimated, p.priority_class, p.valid,
                        p.workload_class, p.sensitivity, snap.throughput)


def score_phase(card, label, snap, cfg, k, anchor_snap, anchor_digest):
    """The ``score_headline`` entry of one configuration (phase 6)."""
    import numpy as np
    import torch

    from koordinator_tpu_torch.harness.anchor import topk_digest
    from koordinator_tpu_torch.solver import (
        masked_top_k, masked_top_k_host, score_all, score_cycle, score_upper_bound,
    )
    from koordinator_tpu_torch.solver.incremental import _take_pods

    hi = score_upper_bound(cfg)

    def score_once():
        scores, feasible = score_cycle(snap, cfg)
        top_s, top_i = masked_top_k(scores, feasible, k=k, hi=hi)
        return top_s.cpu(), top_i.cpu()

    score_once()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    scores, feasible = score_cycle(snap, cfg)
    top_s, top_i = masked_top_k(scores, feasible, k=k, hi=hi)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_bytes
    steps = {
        "score_cycle": cuda_time(lambda: score_cycle(snap, cfg)),
        "masked_top_k": cuda_time(lambda: masked_top_k(scores, feasible, k=k, hi=hi)),
        # masked_top_k's branch: one reduction and its host read
        "in_bound_check": cuda_time(lambda: bool(
            (((scores >= 0) & (scores <= hi)) | ~feasible).all())),
        "readback": cuda_time(lambda: (top_s.cpu(), top_i.cpu())),
        "score_whole": cuda_time(score_once),
    }
    # the card's cells against the CPU path on sampled pod rows, all columns
    P = snap.pods.capacity
    rows = np.sort(np.random.default_rng(0).choice(P, size=min(256, P), replace=False))
    cpu_snap = map_snapshot(snap, lambda t: t.cpu())
    cpu_rows = dataclasses.replace(
        cpu_snap, pods=_take_pods(cpu_snap.pods, torch.from_numpy(rows)))
    want_s, want_f = score_all(cpu_rows, cfg)
    rows_d = torch.from_numpy(rows).to(scores.device)
    if not (torch.equal(scores[rows_d].cpu(), want_s)
            and torch.equal(feasible[rows_d].cpu(), want_f)):
        raise AssertionError(f"score_headline {label}: card and CPU path differ")
    host_s, host_i = masked_top_k_host(scores.cpu().numpy(), feasible.cpu().numpy(), k)
    if not (np.array_equal(top_s.cpu().numpy(), host_s)
            and np.array_equal(top_i.cpu().numpy(), host_i)):
        raise AssertionError(f"score_headline {label}: top-k differs from the host twin")
    a_s, a_f = score_cycle(anchor_snap, cfg)
    digest = topk_digest(*(t.cpu() for t in masked_top_k(a_s, a_f, k=k, hi=hi)))
    if digest != anchor_digest:
        raise AssertionError(f"score_headline {label}: anchor top-k {digest} != {anchor_digest}")
    bound_bytes = snapshot_bytes(snap) + tensor_bytes(scores, feasible)
    return {
        "path": "score_cycle + masked_top_k + readback", "config": label, "k": k, "hi": hi,
        **{f"{name}_ms_cuda_events": ev for name, (ev, _) in steps.items()},
        **{f"{name}_ms_host_wall": wall for name, (_, wall) in steps.items()},
        "peak_device_bytes": peak, "feasible_cells": int(feasible.sum()),
        "score_cycle_bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
        "score_cycle_bound_by": "bytes", "score_cycle_bytes": bound_bytes,
        "timed_runs": TIMED_RUNS,
        "parity": f"{len(rows)} sampled pod rows exact vs the CPU path; top-k exact vs "
                  "masked_top_k_host of the full readback; anchor top-k digest matches",
        "card": card,
    }


def incremental_phase(card, label, snap, cfg, seed):
    """The ``incremental`` entry of one configuration (phase 8): a warm
    delta of 64 node rows (the reference's probe rows) and 16 pod rows,
    on a copy of ``snap``."""
    import numpy as np
    import torch

    from koordinator_tpu_torch.solver import rescore_dirty, score_cycle
    from koordinator_tpu_torch.solver.resident import apply_flat_delta

    snap = map_snapshot(snap, lambda t: t.clone())
    N, R = snap.nodes.requested.shape
    n_real = snap.num_nodes
    node_rows = np.unique((np.arange(64) * max(1, n_real // 64)) % n_real)
    rng = np.random.default_rng(seed)
    pod_rows = np.sort(rng.choice(snap.num_pods, size=16, replace=False))
    alloc = snap.nodes.allocatable.cpu().numpy()
    deltas = []  # (tensor, flat idx, values)
    for field, cols, frac in (("requested", (0, 1), 0.5), ("usage", (0, 1), 0.9)):
        idx = np.asarray([r * R + c for r in node_rows for c in cols], np.int64)
        val = (alloc.reshape(-1)[idx] * rng.uniform(0, frac, len(idx))).astype(np.int64)
        deltas.append((getattr(snap.nodes, field), idx, val))
    idx = np.asarray([r * R for r in pod_rows], np.int64)
    deltas.append((snap.pods.requests, idx, rng.choice([250, 1000, 8000], len(idx))))

    scores, feasible = score_cycle(snap, cfg)

    def apply():
        for arr, i, v in deltas:
            apply_flat_delta(arr, i, v)

    apply()  # the same values again are a no-op: the timed runs repeat it
    given = feasible.clone()
    scores, feasible_new = rescore_dirty(snap, scores, feasible, node_rows, pod_rows, cfg)
    full_s, full_f = score_cycle(snap, cfg)
    if not (torch.equal(scores, full_s) and torch.equal(feasible_new, full_f)):
        raise AssertionError(f"incremental {label}: rescore_dirty != a full score_cycle")
    if not torch.equal(feasible, given):
        raise AssertionError(f"incremental {label}: rescore_dirty wrote the feasible given")
    changed = int((feasible_new != feasible).sum())
    times = {
        "apply_flat_delta": cuda_time(apply),
        "rescore_dirty": cuda_time(
            lambda: rescore_dirty(snap, scores, feasible_new, node_rows, pod_rows, cfg)),
        "full_score_cycle": cuda_time(lambda: score_cycle(snap, cfg)),
    }
    return {
        "config": label, "dirty_node_rows": len(node_rows), "dirty_pod_rows": len(pod_rows),
        "delta_values": int(sum(len(i) for _, i, _ in deltas)),
        "feasible_cells_changed": changed,
        **{f"{name}_ms_cuda_events": ev for name, (ev, _) in times.items()},
        **{f"{name}_ms_host_wall": wall for name, (_, wall) in times.items()},
        "timed_runs": TIMED_RUNS, "parity": "exact vs a full score_cycle", "card": card,
    }


def sparse_phase(card, dev):
    """The ``sparse`` line (phase 9)."""
    import numpy as np
    import torch

    from koordinator_tpu_torch.config import CycleConfig
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.model.snapshot import snapshot_from_numpy
    from koordinator_tpu_torch.solver import (
        CandidateOverflow, build_candidates, check_candidate_overflow, masked_top_k,
        refresh_candidates, score_candidates, score_cycle, score_upper_bound, sparse_top_k,
    )
    from koordinator_tpu_torch.solver import candidates as cmod
    from koordinator_tpu_torch.solver.resident import apply_flat_delta

    width, k = 256, 32
    cfg = CycleConfig(candidate_width=width)
    hi = score_upper_bound(cfg)

    def sparse_once(snap, cand):
        s, f = score_candidates(snap, cand, cfg)
        ts, ti, _ok = sparse_top_k(s, f, cand, k=k, hi=hi)
        return ts.cpu(), ti.cpu()

    def delta64(snap, cand, seed):
        """Close 32 listed nodes and open 32 others (requested cpu)."""
        rng = np.random.default_rng(seed)
        listed = np.unique(cand.cpu().numpy())
        listed = listed[listed < snap.nodes.capacity]
        closed = rng.choice(listed, 32, replace=False)
        opened = rng.choice(np.setdiff1d(np.arange(snap.nodes.capacity), listed), 32,
                            replace=False)
        rows = np.concatenate([closed, opened])
        R = snap.nodes.requested.shape[1]
        apply_flat_delta(snap.nodes.requested, rows * R,
                         np.concatenate([np.full(32, 31_800), np.zeros(32)]).astype(np.int64))
        return sorted(rows.tolist())

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # the scale point: 2^21 nodes x 512 pods
    t0 = time.perf_counter()
    big = snapshot_from_numpy(g.sparse_leaves(1 << 21, 512, n_open=width // 2, seed=16),
                              device=dev)
    encode_s = time.perf_counter() - t0
    blocks = big.nodes.capacity // cmod._sweep_block(big.nodes.capacity, width)
    if not blocks >= cmod._PARALLEL_MIN_BLOCKS or cmod._parallel_build_mode() != "auto":
        raise AssertionError(f"sparse: {blocks} blocks do not take the pipelined build")
    build_ms, (cand, count) = timed_once(lambda: build_candidates(big, cfg))
    check_candidate_overflow(count, width)
    if int(count.min()) != width // 2:
        raise AssertionError(f"sparse: feasible counts {int(count.min())}..{int(count.max())}")
    score_ev, score_wall = cuda_time(lambda: sparse_once(big, cand))
    rows = delta64(big, cand, seed=16)
    refresh_ms, refreshed = timed_once(
        lambda: refresh_candidates(big, cand, count, rows, [], cfg))
    if not same(refreshed, build_candidates(big, cfg)):
        raise AssertionError("sparse: refreshed lists at 2^21 differ from a fresh build")

    # where the dense path fits: 4,096 nodes x 512 pods
    mid = snapshot_from_numpy(g.sparse_leaves(4096, 512, n_open=width // 2, seed=17),
                              device=dev)
    cand_m, count_m = build_candidates(mid, cfg)
    check_candidate_overflow(count_m, width)
    dense = masked_top_k(*score_cycle(mid, cfg), k=k, hi=hi)
    if not same((t.cpu() for t in dense), sparse_once(mid, cand_m)):
        raise AssertionError("sparse: top-k differs from the dense score_cycle + masked_top_k")
    dense_ev, _ = cuda_time(lambda: [t.cpu() for t in masked_top_k(
        *score_cycle(mid, cfg), k=k, hi=hi)])
    sparse_mid_ev, _ = cuda_time(lambda: sparse_once(mid, cand_m))
    rows_m = delta64(mid, cand_m, seed=17)
    if not same(refresh_candidates(mid, cand_m, count_m, rows_m, [], cfg),
                build_candidates(mid, cfg)):
        raise AssertionError("sparse: refreshed lists differ from a fresh build")
    narrow = dataclasses.replace(cfg, candidate_width=64)
    try:
        check_candidate_overflow(build_candidates(mid, narrow)[1], 64)
    except CandidateOverflow as exc:
        refused = str(exc).split(":")[0]
    else:
        raise AssertionError("sparse: 128 feasible nodes fit a width of 64")
    table_bytes = big.nodes.allocatable.numel() * big.nodes.allocatable.element_size()
    return {
        "nodes": big.nodes.capacity, "pods": big.pods.capacity, "width": width, "k": k,
        "n_open": width // 2, "blocks": blocks, "encode_s": encode_s,
        "cold_build_ms": build_ms, "refresh_64_nodes_ms": refresh_ms,
        "score_topk_readback_ms_cuda_events": score_ev,
        "score_topk_readback_ms_host_wall": score_wall,
        "mid_4096_dense_score_topk_ms": dense_ev, "mid_4096_sparse_score_topk_ms": sparse_mid_ev,
        "node_table_bytes_each": table_bytes, "overflow_refused": refused,
        "timed_runs": TIMED_RUNS,
        "parity": "mid: sparse top-k == dense, refresh == fresh build; 2^21: refresh == "
                  "fresh build; width 64 < 128 feasible refused",
        "card": card,
    }


class UdsClient:
    """A raw-UDS client of the seam (``bridge/udsserver.py`` framing) with a
    timeout on every socket operation.  ``split`` holds the last call's
    host-clock split in ms: request encode and send, the server's time
    until the reply's header arrived, the payload's transfer, and the
    reply's decode."""

    def __init__(self, path):
        import socket

        self.conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.conn.settimeout(300)
        self.conn.connect(path)
        self.split = {}

    def call(self, method, msg, reply_cls):
        import struct

        t0 = time.perf_counter()
        body = msg.SerializeToString()
        self.conn.sendall(struct.pack(">BI", method, len(body)) + body)
        t1 = time.perf_counter()
        status, length = struct.unpack(">BI", self._recv(5))
        t2 = time.perf_counter()
        payload = self._recv(length)
        t3 = time.perf_counter()
        if status != 0:
            raise AssertionError(f"RPC {method} failed: {payload.decode()}")
        reply = reply_cls.FromString(payload)
        t4 = time.perf_counter()
        self.split = {"encode_send_ms": (t1 - t0) * 1e3, "server_ms": (t2 - t1) * 1e3,
                      "transfer_ms": (t3 - t2) * 1e3, "decode_ms": (t4 - t3) * 1e3}
        return reply

    def _recv(self, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = self.conn.recv(min(n - len(buf), 1 << 22))
            if not chunk:
                raise AssertionError("the seam closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def close(self):
        self.conn.close()


def rpc_timed(fn):
    """(result, CUDA-event ms, host-wall ms) of one call.  The events are
    recorded on the caller's thread; the server thread's launches go to the
    same default stream, so the event span covers them."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - w0) * 1e3


def median_split(splits):
    """Per-key medians of ``UdsClient.split`` dicts."""
    return {k: statistics.median(d[k] for d in splits) for k in splits[0]}


def seam_cost(rpc, in_process):
    """One RPC's timing entry: medians of the RPC's (event, wall) samples and
    of the in-process call's, and the host-wall difference (the seam's
    cost: codec, socket, servicer, telemetry)."""
    ev = statistics.median(e for e, _ in rpc)
    wall = statistics.median(w for _, w in rpc)
    ip_ev = statistics.median(e for e, _ in in_process)
    ip_wall = statistics.median(w for _, w in in_process)
    return {"rpc_ms_cuda_events": ev, "rpc_ms_host_wall": wall,
            "in_process_ms_cuda_events": ip_ev, "in_process_ms_host_wall": ip_wall,
            "seam_ms_host_wall": wall - ip_wall, "rpc_samples": len(rpc),
            "in_process_samples": len(in_process)}


def resident_vs_encoded(res, enc):
    """Hold the resident snapshot a full Sync built against
    ``encode_snapshot`` of the same cluster, leaf for leaf.  Four
    differences are by design, as in the reference: the resident snapshot
    carries no names and no ``qos`` (neither rides the wire), its
    ``priority`` is int64 (the wire's type), its gang and quota tables are
    not padded to a power-of-two bucket (the encoder's extra rows are
    invalid and zero), and a LoadAware profile the Sync did not carry is
    absent where the encoder holds zeros.  Returns the number of leaves
    compared."""
    import torch

    from koordinator_tpu_torch.model.snapshot import SNAPSHOT_FIELDS

    compared = 0
    for table, (_, fields) in SNAPSHOT_FIELDS.items():
        for f in fields:
            if table == "pods" and f == "qos":
                continue
            a, b = getattr(getattr(res, table), f), getattr(getattr(enc, table), f)
            if a is None:
                if b is not None and b.any():
                    raise AssertionError(f"bridge: {table}.{f} missing from the resident "
                                         "snapshot")
                continue
            if b is None:
                raise AssertionError(f"bridge: {table}.{f} present on one side only")
            if a.device != b.device:
                raise AssertionError(f"bridge: {table}.{f} on {a.device} vs {b.device}")
            if table == "pods" and f == "priority":
                b = b.long()
            if table in ("gangs", "quotas"):
                rows = a.shape[0]
                if b.shape[0] < rows or b[rows:].any():
                    raise AssertionError(f"bridge: {table}.{f} padding rows differ")
                b = b[:rows]
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"bridge: resident {table}.{f} != encode_snapshot's")
            compared += 1
    if (res.throughput is None) != (enc.throughput is None):
        raise AssertionError("bridge: throughput present on one side only")
    return compared


def grpc_fixture_check(dev, tmp):
    """Where ``grpc`` is installed: the gRPC transport on the card answers
    the golden fixtures' three requests (``go/scorerclient/testdata``) with
    the fixtures' replies, timings pinned as ``go/gen_fixtures.py`` pins
    them, and the Assign's ``path`` the port's own label."""
    import os

    import grpc

    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.bridge.server import SERVICE, ScorerServicer, make_server

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "go", "scorerclient",
                        "testdata")

    def load(name):
        with open(os.path.join(data, name), "rb") as f:
            return f.read()

    sv = ScorerServicer(device=dev)
    sv._epoch = sv.telemetry.spans.epoch = "0601den0"
    server = make_server(servicer=sv)
    path = os.path.join(tmp, "grpc.sock")
    server.add_insecure_port(f"unix://{path}")
    server.start()
    channel = grpc.insecure_channel(f"unix://{path}")
    try:
        def rpc(name, req_file, reply_cls):
            call = channel.unary_unary(
                f"/{SERVICE}/{name}", request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=reply_cls.FromString)
            return call(wire.MESSAGES[[m.__name__ for m in wire.MESSAGES].index(
                name + "Request")].FromString(load(req_file)), timeout=300)

        sync = rpc("Sync", "sync_request.bin", wire.SyncReply)
        score = rpc("Score", "score_request.bin", wire.ScoreReply)
        assign = rpc("Assign", "assign_request.bin", wire.AssignReply)
    finally:
        channel.close()
        server.stop(None)
    score.build_ms = 0.125
    want = wire.AssignReply.FromString(load("assign_reply.bin"))
    want.path, want.cycle_ms = assign.path, assign.cycle_ms
    same = (sync.SerializeToString() == load("sync_reply.bin")
            and score.SerializeToString() == load("score_reply.bin")
            and assign == want and assign.path == "cuda")
    if not same:
        raise AssertionError("bridge: the gRPC transport's replies differ from the fixtures")
    return {"fixture_replies": "equal (Assign path 'cuda', the fixture's 'scan')",
            "assign_path": assign.path}


def bridge_phase(card, dev, snap, lists, headline):
    """The ``bridge`` line (phase 11): the serving seam at the headline,
    through the raw-UDS transport, every reply exact against the in-process
    call."""
    import json as _json
    import os
    import tempfile
    import threading

    import numpy as np
    import torch

    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.bridge.plugin_sim import GoPluginSim, NUM_AXES
    from koordinator_tpu_torch.bridge.server import ScorerServicer
    from koordinator_tpu_torch.bridge.state import ResidentState, numpy_to_tensor
    from koordinator_tpu_torch.bridge.udsserver import (
        METHOD_ASSIGN, METHOD_SCORE, METHOD_SYNC, RawUdsServer,
    )
    from koordinator_tpu_torch.config import CycleConfig
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.harness.golden import build_sync_request
    from koordinator_tpu_torch.solver import (
        dense, kernel_demotions, masked_top_k, run_cycle, score_cycle, score_upper_bound,
        wide,
    )

    node_list, pod_list, gangs, quotas = lists
    P, N = len(pod_list), len(node_list)
    K = 32
    tmp = tempfile.mkdtemp()
    servers = []
    line = {"snapshot": f"quota_colocation {P} pods x {N} nodes, 16 tenants, seed 0",
            "transport": "raw UDS (bridge/udsserver.py)", "card": card}
    try:
        import grpc  # noqa: F401
        line["grpc_importable"] = True
    except ImportError:
        line["grpc_importable"] = False
    exact = {}

    def start(name, **kw):
        path = os.path.join(tmp, f"{name}.sock")
        srv = RawUdsServer(path, servicer=ScorerServicer(device=dev, **kw)).start()
        servers.append(srv)
        return srv, UdsClient(path)

    def counts():
        return {"cycle_dense": dense.LAUNCHES, **wide.LAUNCHES}

    def reset():
        torch.cuda.synchronize()
        dense.reset_launches()
        wide.reset_launches()

    def same_placements(reply, want):
        return (list(reply.assignment) == want.assignment[:P].cpu().tolist()
                and list(reply.status) == want.status[:P].cpu().tolist())

    def in_process_cycle(s, cfg=CycleConfig()):
        def once():
            r = run_cycle(s, cfg)
            return r.assignment.cpu(), r.status.cpu()
        return [rpc_timed(once)[1:] for _ in range(TIMED_RUNS)]

    try:
        # the full Sync
        t0 = time.perf_counter()
        req, _ = build_sync_request(node_list, pod_list, gangs, quotas,
                                    node_bucket=N, pod_bucket=P)
        payload = req.SerializeToString()
        line["build_sync_request_s"] = time.perf_counter() - t0
        line["full_sync_bytes"] = len(payload)
        srv, cli = start("main")
        sync, ev, wall = rpc_timed(lambda: cli.call(METHOD_SYNC, req, wire.SyncReply))
        full_sync = [(ev, wall)]
        if (sync.nodes, sync.pods) != (N, P):
            raise AssertionError(f"bridge: sync reply {sync}")

        def sync_in_process(msg):
            st = ResidentState(device=dev)
            return rpc_timed(lambda: st.apply_sync(wire.SyncRequest.FromString(
                msg.SerializeToString())))[1:]

        full_sync_ip = [sync_in_process(req) for _ in range(3)]

        # the first Assign: K2, exactly one launch, no demotion
        reset()
        first, ev, wall = rpc_timed(lambda: cli.call(
            METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sync.snapshot_id), wire.AssignReply))
        launches = counts()
        if launches != {"cycle_dense": 0, "cycle_wide": 1, "wave_cycle": 0} or kernel_demotions():
            raise AssertionError(f"bridge: first Assign launched {launches}, "
                                 f"demotions {kernel_demotions()}")
        exact["first_assign_vs_phase4_run_cycle"] = same_placements(first, headline)
        if first.path != "cuda" or not exact["first_assign_vs_phase4_run_cycle"]:
            raise AssertionError(f"bridge: first Assign (path {first.path}) differs from "
                                 "phase 4's run_cycle")
        line["first_assign"] = {"rpc_ms_cuda_events": ev, "rpc_ms_host_wall": wall,
                                "launches": launches, "path": first.path,
                                "note": "includes the cold snapshot build"}
        line["resident_leaves_compared"] = resident_vs_encoded(srv.servicer.state.snapshot(),
                                                               snap)
        exact["resident_snapshot_vs_encode_snapshot"] = True

        # three warm delta Syncs, each moving the cpu of three nodes, each
        # followed by an Assign
        cur = map_snapshot(snap, lambda t: t.clone())
        prev = np.frombuffer(req.nodes.requested.data, "<i8").reshape(N, -1).copy()
        delta_rpc, assign_rpc, delta_bytes, assign_split = [], [], [], []
        warm_launches = dict.fromkeys(counts(), 0)
        for rep in range(3):
            nxt = prev.copy()
            nxt[:3, 0] += 500 + rep
            warm = wire.SyncRequest()
            warm.nodes.requested.CopyFrom(numpy_to_tensor(nxt, prev))
            delta_bytes.append(warm.ByteSize())
            if delta_bytes[-1] * 100 >= len(payload):
                raise AssertionError(f"bridge: delta frame {delta_bytes[-1]} B is not under "
                                     f"1 % of the full {len(payload)} B")
            s2, ev, wall = rpc_timed(lambda: cli.call(METHOD_SYNC, warm, wire.SyncReply))
            delta_rpc.append((ev, wall))
            if srv.servicer.state.last_sync_path != "warm":
                raise AssertionError("bridge: the delta Sync did not land warm")
            reset()
            reply, ev, wall = rpc_timed(lambda: cli.call(
                METHOD_ASSIGN, wire.AssignRequest(snapshot_id=s2.snapshot_id),
                wire.AssignReply))
            assign_rpc.append((ev, wall))
            assign_split.append(dict(cli.split))
            for kernel, n in counts().items():
                warm_launches[kernel] += n
            cur.nodes.requested[:3, 0] = torch.from_numpy(nxt[:3, 0]).to(dev)
            if not same_placements(reply, run_cycle(cur)):
                raise AssertionError(f"bridge: warm Assign {rep} != in-process run_cycle")
            prev = nxt
        exact["warm_assigns_vs_run_cycle"] = True
        st_ip = ResidentState(device=dev)
        st_ip.apply_sync(wire.SyncRequest.FromString(payload))
        st_ip.snapshot()
        ip_delta = []
        for rep in range(TIMED_RUNS):
            base = np.asarray(st_ip.node_requested)
            nxt = base.copy()
            nxt[:3, 0] += 1
            msg = wire.SyncRequest()
            msg.nodes.requested.CopyFrom(numpy_to_tensor(nxt, base))
            ip_delta.append(rpc_timed(lambda: st_ip.apply_sync(
                wire.SyncRequest.FromString(msg.SerializeToString())))[1:])
        line["delta_sync"] = {**seam_cost(delta_rpc, ip_delta), "bytes": delta_bytes,
                              "full_bytes": len(payload)}
        line["warm_assign"] = {**seam_cost(assign_rpc, in_process_cycle(cur)),
                               "launches": warm_launches,
                               "client_split": median_split(assign_split)}

        # the Score RPC, then a warm Score after a 64-node delta
        hi = score_upper_bound(CycleConfig())

        def score_in_process(s):
            scores, feasible = score_cycle(s)
            ts, ti = masked_top_k(scores, feasible, k=K, hi=hi)
            ok = torch.gather(feasible, 1, ti.long())
            return ts.cpu().numpy(), ti.cpu().numpy(), ok.cpu().numpy()

        def flat_equal(reply, s):
            ts, ti, ok = score_in_process(s)
            f = reply.flat
            return (np.frombuffer(f.pod_index, "<i4").tolist() == list(range(P))
                    and np.frombuffer(f.counts, "<i4").tolist() == ok[:P].sum(1).tolist()
                    and f.node_index == ti[:P][ok[:P]].astype("<i4").tobytes()
                    and f.score == ts[:P][ok[:P]].astype("<i8").tobytes())

        sid = s2.snapshot_id
        score, ev, wall = rpc_timed(lambda: cli.call(METHOD_SCORE, wire.ScoreRequest(
            snapshot_id=sid, top_k=K, flat=True), wire.ScoreReply))
        exact["score_vs_in_process"] = flat_equal(score, cur)
        if not exact["score_vs_in_process"]:
            raise AssertionError("bridge: Score reply != in-process score_cycle + masked_top_k")
        line["first_score"] = {"rpc_ms_cuda_events": ev, "rpc_ms_host_wall": wall,
                               "reply_bytes": score.ByteSize()}
        rows = np.arange(64) * (N // 64)
        nxt = prev.copy()
        nxt[rows, 1] += 1024
        warm = wire.SyncRequest()
        warm.nodes.requested.CopyFrom(numpy_to_tensor(nxt, prev))
        s3 = cli.call(METHOD_SYNC, warm, wire.SyncReply)
        cur.nodes.requested[torch.from_numpy(rows).to(dev), 1] = torch.from_numpy(
            nxt[rows, 1]).to(dev)
        def incr_launches():
            text = srv.servicer.telemetry.metrics.registry.render()
            return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                       if ln.startswith('koord_scorer_score_incr_total{result="incr"}'))

        incr_before = incr_launches()
        iscore, ev, wall = rpc_timed(lambda: cli.call(METHOD_SCORE, wire.ScoreRequest(
            snapshot_id=s3.snapshot_id, top_k=K, flat=True), wire.ScoreReply))
        if incr_launches() != incr_before + 1:
            raise AssertionError("bridge: the warm Score did not take the incremental engine")
        exact["incremental_score_vs_full_rescore"] = flat_equal(iscore, cur)
        if not exact["incremental_score_vs_full_rescore"]:
            raise AssertionError("bridge: incremental Score != a full rescore")
        line["incremental_score"] = {"rpc_ms_cuda_events": ev, "rpc_ms_host_wall": wall,
                                     "dirty_node_rows": 64, "engine": "incr"}
        prev = nxt

        # the cold Assign: the resident state replaced, a full Sync, an Assign
        cold_sync, cold_assign = [], []
        reset()
        for _ in range(3):
            srv.servicer.state = ResidentState(device=dev)
            sc, ev, wall = rpc_timed(lambda: cli.call(METHOD_SYNC, req, wire.SyncReply))
            cold_sync.append((ev, wall))
            reply, ev, wall = rpc_timed(lambda: cli.call(
                METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sc.snapshot_id),
                wire.AssignReply))
            cold_assign.append((ev, wall))
            if not same_placements(reply, headline):
                raise AssertionError("bridge: cold Assign != phase 4's run_cycle")
        cold_launches = counts()
        exact["cold_assigns_vs_run_cycle"] = True
        line["full_sync"] = seam_cost(full_sync + cold_sync, full_sync_ip)

        def cold_in_process():
            st = ResidentState(device=dev)
            st.apply_sync(wire.SyncRequest.FromString(payload))
            r = run_cycle(st.snapshot(), CycleConfig(), i32_ok=st.i32_fits())
            return r.assignment.cpu(), r.status.cpu()

        line["cold_assign"] = {
            **seam_cost(cold_assign, [rpc_timed(cold_in_process)[1:] for _ in range(3)]),
            "launches": cold_launches,
            "note": "the RPC excludes the Sync's decode, the in-process call includes it"}
        cli.close()

        # the storm: 8 clients x 16 Scores, memo and incremental engine off
        srv_b, cli_b = start("storm", score_memo=False, score_incr=False)
        sb = cli_b.call(METHOD_SYNC, req, wire.SyncReply)
        score_req = wire.ScoreRequest(snapshot_id=sb.snapshot_id, top_k=K, flat=True)
        serial, score_split = [], []
        for _ in range(TIMED_RUNS):
            serial.append(rpc_timed(
                lambda: cli_b.call(METHOD_SCORE, score_req, wire.ScoreReply)))
            score_split.append({**cli_b.split, "server_build_ms": serial[-1][0].build_ms})
        want = serial[0][0]
        want.build_ms = 0.0
        exact["score_serial_vs_in_process"] = flat_equal(want, snap)
        if not exact["score_serial_vs_in_process"]:
            raise AssertionError("bridge: serial Score != in-process")
        line["score"] = {**seam_cost([r[1:] for r in serial],
                                     [rpc_timed(lambda: score_in_process(snap))[1:]
                                      for _ in range(TIMED_RUNS)]),
                         "client_split": median_split(score_split),
                         "reply_bytes": want.ByteSize()}
        cli_b.close()
        before = srv_b.servicer.dispatch.stats()
        replies, errors = [], []
        barrier = threading.Barrier(8)

        def client():
            c = UdsClient(srv_b.path)
            try:
                barrier.wait(timeout=120)
                for _ in range(16):
                    replies.append(c.call(METHOD_SCORE, score_req, wire.ScoreReply))
            except Exception as exc:  # surfaced below
                errors.append(exc)
            finally:
                c.close()

        threads = [threading.Thread(target=client) for _ in range(8)]
        w0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("bridge: a storm client did not finish")
        storm_s = time.perf_counter() - w0
        if errors or len(replies) != 128:
            raise AssertionError(f"bridge: storm errors {errors[:3]}, {len(replies)} replies")
        for r in replies:
            r.build_ms = 0.0
        exact["storm_vs_serial"] = all(r == want for r in replies)
        if not exact["storm_vs_serial"]:
            raise AssertionError("bridge: a storm reply differs from the serial reply")
        after = srv_b.servicer.dispatch.stats()
        line["storm"] = {"clients": 8, "requests": after["requests"] - before["requests"],
                         "batches": after["batches"] - before["batches"],
                         "max_occupancy": after["max_occupancy"], "wall_s": storm_s,
                         "scores_per_s": 128 / storm_s}

        # K3 and K1 through the same servicer
        srv_w, cli_w = start("wave", cfg=CycleConfig(**WAVE_CFG))
        sw = cli_w.call(METHOD_SYNC, req, wire.SyncReply)
        reset()
        reply, ev, wall = rpc_timed(lambda: cli_w.call(
            METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sw.snapshot_id), wire.AssignReply))
        k3 = counts()
        if k3 != {"cycle_dense": 0, "cycle_wide": 0, "wave_cycle": 1} or not same_placements(
                reply, headline):
            raise AssertionError(f"bridge: wave Assign launched {k3} or differs")
        line["wave_assign"] = {**seam_cost([(ev, wall)], in_process_cycle(
            snap, CycleConfig(**WAVE_CFG))), "launches": k3}
        cli_w.close()
        big = [dict(n) for n in node_list]
        big[0] = dict(big[0], allocatable=dict(big[0]["allocatable"], memory=1 << 45))
        req_x, _ = build_sync_request(big, pod_list, gangs, quotas, node_bucket=N, pod_bucket=P)
        snap_x, _ = g.encode_quota_lists(big, pod_list, gangs, quotas, node_bucket=N,
                                         pod_bucket=P, device=dev)
        srv_x, cli_x = start("int64")
        sx = cli_x.call(METHOD_SYNC, req_x, wire.SyncReply)
        reset()
        reply, ev, wall = rpc_timed(lambda: cli_x.call(
            METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sx.snapshot_id), wire.AssignReply))
        k1 = counts()
        if k1 != {"cycle_dense": 1, "cycle_wide": 0, "wave_cycle": 0} or not same_placements(
                reply, run_cycle(snap_x)):
            raise AssertionError(f"bridge: int64 Assign launched {k1} or differs")
        exact["wave_and_int64_assigns_vs_run_cycle"] = True
        line["int64_assign"] = {**seam_cost([(ev, wall)], in_process_cycle(snap_x)),
                                "launches": k1,
                                "cluster": "node 0 with 32 TiB of memory, past the int32 "
                                           "kernels' score bound"}
        cli_x.close()

        # the Go plugin's flow
        srv_p = RawUdsServer(os.path.join(tmp, "plugin.sock"),
                             servicer=ScorerServicer(device=dev)).start()
        servers.append(srv_p)

        def vec(cpu=0, mem=0, pods=0):
            v = [0] * NUM_AXES
            v[0], v[1], v[3] = cpu, mem, pods
            return v

        alloc = vec(cpu=8000, mem=16384, pods=110)
        nodes1 = [(f"plugin-node-{i}", alloc, vec(cpu=1000, mem=1024, pods=5))
                  for i in range(4)]
        nodes2 = list(nodes1)
        nodes2[2] = ("plugin-node-2", alloc, vec(cpu=1500, mem=1536, pods=6))
        sim = GoPluginSim(srv_p.path)
        sim.metrics = {"plugin-node-0": vec(cpu=500, mem=512)}
        pod_vec = vec(cpu=500, mem=512, pods=1)
        sim.pre_score(nodes1, "plugin-pod-1", pod_vec)
        got = sim.pre_score(nodes2, "plugin-pod-2", pod_vec)
        sim._drop_client()
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "go",
                               "scorerclient", "testdata", "expected.json")) as f:
            flow = _json.load(f)["plugin_flow"]
        want_flow = {flow["names"][n]: s for n, s in zip(flow["score2_reply"]["node_index"],
                                                         flow["score2_reply"]["score"])}
        exact["plugin_flow_vs_expected_json"] = got == want_flow
        if not exact["plugin_flow_vs_expected_json"]:
            raise AssertionError(f"bridge: plugin flow scores {got} != {want_flow}")
        if ([m for m, _ in sim.sent_frames] != [1, 2, 1, 2]
                or srv_p.servicer.state.last_sync_path != "warm"):
            raise AssertionError(f"bridge: plugin flow frames {sim.sent_frames}")
        line["plugin_flow"] = {"frames": sim.sent_frames, "scores": got}
        # everything above ran on the port's codec: the protobuf runtime,
        # installed or not, must not have been loaded
        line["protobuf_loaded_by_the_seam"] = "google.protobuf" in sys.modules
        if line["protobuf_loaded_by_the_seam"]:
            raise AssertionError("bridge: the seam loaded the protobuf runtime")
        if line["grpc_importable"]:
            line["grpc"] = grpc_fixture_check(dev, tmp)
            exact["grpc_fixture_replies"] = True
    finally:
        for srv in servers:
            srv.stop()
    if not all(exact.values()):
        raise AssertionError(f"bridge: not exact: {exact}")
    line["exact"] = exact
    line["timed_runs"] = TIMED_RUNS
    return line


def nearest_rank(values, q):
    """The nearest-rank quantile ``q`` of ``values``."""
    vals = sorted(values)
    return vals[min(len(vals) - 1, max(0, int(q * len(vals) + 0.5) - 1))]


def replay_latency(report):
    """Exact p50 and p99 in ms of each RPC of a replay's measured pass, and
    of the whole step per band, from its timeline."""
    per_rpc = {"sync": [], "score": [], "assign": [], "cycle": []}
    per_band = {}
    for cyc in report.timeline:
        for span in cyc["spans"]:
            per_rpc[span["name"]].append(span["dur_ms"])
        per_rpc["cycle"].append(cyc["notes"]["latency_ms"])
        per_band.setdefault(cyc["notes"]["band"], []).append(cyc["notes"]["latency_ms"])

    def q(vals):
        return {"p50": statistics.median(vals), "p99": nearest_rank(vals, 0.99),
                "n": len(vals)}

    return {"rpc": {k: q(v) for k, v in per_rpc.items()},
            "band": {k: q(v) for k, v in sorted(per_band.items())}}


# the port's kernels and op families, by CUDA kernel name, for the Profile
# pass's busy-time split (first match wins)
KERNEL_FAMILIES = (
    ("K3 wave_cycle_kernel", ("wave_cycle_kernel",)),
    ("K1/K2 cycle_kernel", ("cycle_kernel",)),
    ("torch sort/topk", ("sort", "Sort", "topk", "radix", "bitonic")),
    ("torch reduce", ("reduce_kernel", "Reduce")),
    ("torch index/scatter/gather", ("index", "scatter", "gather", "Index", "Scatter")),
    ("torch cat/copy", ("CatArray", "copy_kernel", "Copy")),
    ("torch elementwise", ("elementwise", "Elementwise")),
)


def profile_busy(doc):
    """The device busy share of a chrome trace: the union of its kernel,
    memcpy and memset intervals over the profiler's window, and the share
    of that busy time in each kernel family."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    window = [e for e in events if e.get("cat") == "Trace"
              or str(e.get("name", "")).startswith("PyTorch Profiler")]
    span = window[0] if window else None
    lo = float(span["ts"]) if span else min(float(e["ts"]) for e in events)
    hi = (float(span["ts"]) + float(span["dur"]) if span
          else max(float(e["ts"]) + float(e.get("dur", 0)) for e in events))
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not gpu:
        raise AssertionError("trace: the profiler recorded no kernel, memcpy or memset "
                             "(is CUPTI tracing the card?)")
    intervals = sorted((max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])))
                       for e in gpu)
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b in intervals:
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    fam_us, names = {}, {}
    for e in gpu:
        name = str(e.get("name", ""))
        if e["cat"] == "gpu_memcpy":
            fam = "memcpy"
        elif e["cat"] == "gpu_memset":
            fam = "memset"
        else:
            fam = next((f for f, keys in KERNEL_FAMILIES if any(k in name for k in keys)),
                       "other kernels")
        fam_us[fam] = fam_us.get(fam, 0.0) + float(e["dur"])
        names[name[:80]] = names.get(name[:80], 0.0) + float(e["dur"])
    total = sum(fam_us.values())
    return {
        "window_ms": (hi - lo) / 1e3, "window_from": "profiler span" if span else "events",
        "busy_ms": busy / 1e3, "busy_share": busy / (hi - lo), "gpu_events": len(gpu),
        "family_share_of_kernel_time": {k: v / total for k, v in sorted(
            fam_us.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
            names.items(), key=lambda kv: -kv[1])[:8]},
    }


# the RPC whose path runs each launch boundary, for every boundary the
# port registers (devprof's names); a boundary missing here fails the
# ledger pass
BOUNDARY_RPC = {
    "solver.resident.apply_flat_delta": "sync",
    "solver.greedy.score_cycle": "score", "solver.topk.masked_top_k": "score",
    "solver.incremental.rescore_dirty": "score",
    "solver.candidates._build": "score", "solver.candidates._count_blocks": "score",
    "solver.candidates._refresh": "score", "solver.candidates.score_candidates": "score",
    "solver.wide.cycle_wide_cuda": "assign", "solver.wide.wave_cycle_cuda": "assign",
    "solver.dense.cycle_dense_cuda": "assign", "solver.terms.term_extras": "assign",
}


class K2Tap:
    """Holds K2 against its plain version on a replay's own launches.

    Inside ``with``, ``wide.cycle_wide_cuda`` is wrapped: each launch
    numbered in ``keep`` (0-based, in launch order from entry) keeps a
    device copy of its inputs and outputs, made on the launch's stream, so
    the replay never waits for it.  ``check`` then runs
    ``cycle_wide_reference`` on the CPU on each kept launch's inputs and
    fails on any difference in its four outputs."""

    def __init__(self, keep):
        self.keep = frozenset(keep)
        self.records = {}
        self.seen = 0

    def __enter__(self):
        from koordinator_tpu_torch.solver import wide

        self._wide, self._launch = wide, wide.cycle_wide_cuda

        def tapped(inp, cfg, defines=()):
            i, self.seen = self.seen, self.seen + 1
            if i not in self.keep:
                return self._launch(inp, cfg, defines)
            held = tensors_to(inp, lambda t: t.clone())
            outs = self._launch(inp, cfg, defines)
            self.records[i] = (held, cfg, tuple(o.clone() for o in outs))
            return outs

        wide.cycle_wide_cuda = tapped
        return self

    def __exit__(self, *exc):
        self._wide.cycle_wide_cuda = self._launch
        return False

    def check(self, name):
        import torch

        if set(self.records) != self.keep:
            raise AssertionError(f"trace {name}: K2 launches {sorted(self.keep - set(self.records))}"
                                 f" of {sorted(self.keep)} never ran ({self.seen} launches)")
        t0 = time.perf_counter()
        err = 0
        for i, (inp, cfg, outs) in sorted(self.records.items()):
            want = self._wide.cycle_wide_reference(tensors_to(inp, lambda t: t.cpu()), cfg)
            got = tuple(o.cpu() for o in outs)
            for field, a, b in zip(("chosen", "nreq", "nest", "quse"), got, want):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise AssertionError(f"trace {name}: K2 launch {i} {field} is "
                                         f"{a.dtype}{list(a.shape)}, plain {b.dtype}{list(b.shape)}")
            err = max(err, max_abs_err(got, want))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"trace {name}: K2 launch {i} differs from its plain "
                                     f"version (max abs err {max_abs_err(got, want)})")
        return {"launches_held": sorted(self.keep), "of_launches": self.seen,
                "plain": "cycle_wide_reference on the CPU", "max_abs_err": err,
                "plain_s": time.perf_counter() - t0}


def tensors_to(inp, move):
    """``inp`` (a ``CycleInputs``) with ``move`` applied to each tensor."""
    import torch

    return dataclasses.replace(inp, **{
        f.name: move(getattr(inp, f.name)) for f in dataclasses.fields(inp)
        if isinstance(getattr(inp, f.name), torch.Tensor)})


def trace_phase(card, dev):
    """The ``trace`` line (phase 12): the trace replay through the port's
    ScorerClient on the card, engine against the serial oracle."""
    import os
    import socket
    import struct
    import tempfile

    import torch

    from koordinator_tpu_torch.bridge.server import ScorerServicer
    from koordinator_tpu_torch.bridge.udsserver import METHOD_PROFILE, RawUdsServer
    from koordinator_tpu_torch.harness.anchor import (
        TRACE_ANCHOR_CFG, TRACE_ANCHOR_SHA256, TRACE_HEADLINE_CFG, TRACE_HEADLINE_SHA256,
    )
    from koordinator_tpu_torch.harness.trace import (
        TraceConfig, TraceReplay, default_slo_specs, generate_trace, tensor_sync_events,
    )
    from koordinator_tpu_torch.obs import devprof
    from koordinator_tpu_torch.obs.assemble import assemble
    from koordinator_tpu_torch.obs.scorer_metrics import SYNC_TOTAL, TRACE_CYCLE
    from koordinator_tpu_torch.obs.slo import evaluate_slos, slos_pass
    from koordinator_tpu_torch.solver import dense, kernel_demotions, wide

    line = {"card": card, "transport": "raw UDS through ScorerClient('raw://...')"}

    def counts():
        return {"cycle_dense": dense.LAUNCHES, **wide.LAUNCHES}

    def reset():
        torch.cuda.synchronize()
        dense.reset_launches()
        wide.reset_launches()

    tensor_events = {}

    def checked(name, trace, report, oracle=True):
        """Parity on every step, no build and no demotion in the measured
        pass, and the warm path really ran: every event that changes a
        tensor column committed a Sync that carried a tensor, and deltas
        among them reached ``apply_flat_delta``; the pass's summary."""
        steps = len(trace.events) + 1
        if oracle and report.parity_checks != steps:
            raise AssertionError(f"trace {name}: {report.parity_checks} parity checks, "
                                 f"want {steps}")
        if report.retraces or report.builds or kernel_demotions():
            raise AssertionError(f"trace {name}: {report.builds} builds, {report.retraces} "
                                 f"demotions in the measured pass ({kernel_demotions()})")
        if trace.digest() not in tensor_events:
            tensor_events[trace.digest()] = tensor_sync_events(trace)
        syncs = {kind: int(report.registry.get(SYNC_TOTAL, {"kind": kind}) or 0)
                 for kind in ("full", "delta", "mixed", "scalar")}
        syncs["events_changing_a_tensor"] = tensor_events[trace.digest()]
        if (syncs["full"] + syncs["delta"] + syncs["mixed"] != 1 + syncs["events_changing_a_tensor"]
                or syncs["delta"] + syncs["mixed"] == 0
                or syncs["full"] + syncs["delta"] + syncs["mixed"] + syncs["scalar"] != steps):
            raise AssertionError(f"trace {name}: the engine's Syncs by kind {syncs}: want one "
                                 "full, then one carrying a tensor per event that changes one")
        return {"events": report.events_replayed, "parity_checks": report.parity_checks,
                "builds": report.builds, "demotions": report.retraces, "syncs": syncs,
                "wall_ms": report.wall_ms, "latency_ms": replay_latency(report)}

    def held(name, trace, steps, **kw):
        """A replay (warm-up and oracle on: one engine and one oracle
        Assign a step, each one K2 launch) whose engine K2 launches of the
        measured pass at ``steps`` (0 = the cold step) are held against the
        plain version."""
        first = 2 * (len(trace.events) + 1)  # the warm-up pass's launches
        with K2Tap(first + 2 * s for s in steps) as tap:
            report = TraceReplay(trace, **kw).run()
        return report, tap.check(name)

    # 1. the reference's accelerator trace, raw transport
    trace = generate_trace(TraceConfig(**TRACE_ANCHOR_CFG))
    if trace.digest() != TRACE_ANCHOR_SHA256:
        raise AssertionError(f"trace digest {trace.digest()} != {TRACE_ANCHOR_SHA256}")
    line["trace"] = {**TRACE_ANCHOR_CFG, "digest": trace.digest(), "top_k": 8,
                     "cycle_config": "default"}
    reset()
    report, k2_plain = held("main", trace, range(0, len(trace.events) + 1, 8), transport="raw")
    launches = counts()
    want = 2 * 2 * (len(trace.events) + 1)  # two passes, engine and oracle
    if launches != {"cycle_dense": 0, "cycle_wide": want, "wave_cycle": 0}:
        raise AssertionError(f"trace: Assigns launched {launches}, want {want} K2 launches")
    main = checked("main", trace, report)
    verdicts = evaluate_slos(report.registry, default_slo_specs(trace.bands()))
    main.update(launches=launches, launches_note=(
        "2 passes (warm-up, measured) x 97 steps x 2 servicers, one K2 launch per Assign"),
        slo=[v.to_doc() for v in verdicts], slo_pass=slos_pass(verdicts),
        k2_vs_plain=k2_plain)
    line["raw"] = main

    # 2. the same replay over gRPC, where grpc imports
    try:
        import grpc  # noqa: F401
        line["grpc_importable"] = True
    except ImportError:
        line["grpc_importable"] = False
    if line["grpc_importable"]:
        grpc_report, grpc_plain = held("grpc", trace, (0, 48, 96), transport="grpc")
        line["grpc"] = dict(checked("grpc", trace, grpc_report), k2_vs_plain=grpc_plain)

    # 3. the ledger: every launch timed, the engine alone
    devprof.reset()
    t_start = time.time()
    ledger = TraceReplay(trace, transport="raw", warmup=False, oracle=False,
                         engine_kw={"devprof_sample": 1}).run()
    setup_ms = (ledger.timeline[0]["started_unix"] - t_start) * 1e3
    summary = devprof.summary()
    devprof.configure(sample=0)
    devprof.reset()
    led = checked("ledger", trace, ledger, oracle=False)
    top = sorted(((n, b) for n, b in summary["boundaries"].items() if b["sampled"]),
                 key=lambda nb: -nb[1]["device_us_total"])
    unmapped = sorted(set(summary["boundaries"]) - set(BOUNDARY_RPC))
    if unmapped:
        raise AssertionError(f"trace ledger: boundaries with no RPC: {unmapped}")
    # the cold step and every event on both sides of the ratio
    host_ms = dict(ledger.cold_ms)
    for labels, _bounds, _cum, total, _count in ledger.registry.histogram_series(TRACE_CYCLE):
        if labels["rpc"] in host_ms:
            host_ms[labels["rpc"]] += total
    span_ms = {rpc: 0.0 for rpc in host_ms}
    for name, b in top:
        span_ms[BOUNDARY_RPC[name]] += b["device_us_total"] / 1e3
    led.update(
        boundaries=[{"boundary": n, "rpc": BOUNDARY_RPC[n], "launches": b["launches"],
                     "sampled": b["sampled"], "device_us_p50": b["device_us_p50"],
                     "device_us_p99": b["device_us_p99"],
                     "device_ms_total": b["device_us_total"] / 1e3} for n, b in top],
        span_share_of_host_wall={rpc: span_ms[rpc] / host_ms[rpc] for rpc in span_ms},
        span_ms=span_ms, host_ms=host_ms, cold_ms=ledger.cold_ms,
        note=("every outermost launch boundary timed with CUDA events on its stream; a "
              "span of a boundary of several ops holds the host's enqueue gaps between "
              "them, so it is an upper bound on device time, and the device metric is the "
              "profile pass's busy share; both sums cover the cold step and the "
              f"{len(trace.events)} events"),
    )
    line["ledger"] = led

    # 4. the Profile admin method over the socket, then a replay in its window
    tmp = tempfile.mkdtemp()
    step_ms = main["latency_ms"]["rpc"]["cycle"]["p50"]

    def profile_admin(payload):
        window = int(payload.strip().decode("ascii")) if payload.strip() else 1000
        return devprof.capture_profile(tmp, window_ms=window).encode()

    admin_path = os.path.join(tmp, "admin.sock")
    admin = RawUdsServer(admin_path, servicer=ScorerServicer(device=dev),
                         admin_handlers={METHOD_PROFILE: profile_admin}).start()

    def open_window(window_ms):
        """Admin method 5 over the socket: the capture directory."""
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(60)
        try:
            conn.connect(admin_path)
            body = str(window_ms).encode()
            conn.sendall(struct.pack(">BI", METHOD_PROFILE, len(body)) + body)
            buf = b""
            while len(buf) < 5 or len(buf) < 5 + struct.unpack(">BI", buf[:5])[1]:
                chunk = conn.recv(1 << 16)
                if not chunk:
                    raise AssertionError("trace: the admin socket closed")
                buf += chunk
        finally:
            conn.close()
        status, n = struct.unpack(">BI", buf[:5])
        if status != 0:
            raise AssertionError(f"trace: Profile failed: {buf[5:5 + n].decode()}")
        return buf[5:5 + n].decode()

    def written(capture):
        path = os.path.join(capture, devprof.PROFILE_TRACE)
        deadline = time.monotonic() + 300
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise AssertionError(f"trace: no profiler trace at {path}")
            time.sleep(0.2)
        return path

    # the window covers the replay's set-up (servers, full Sync, cold step)
    # as the ledger pass took it, then about 20 steps; a second attempt
    # takes the set-up the first one saw under the profiler
    window_ms = int(setup_ms + 20 * step_ms) + 1
    try:
        for attempt in range(2):
            capture = open_window(window_ms)
            t_call = time.time()
            prof_report = TraceReplay(trace, transport="raw", warmup=False,
                                      oracle=False).run()
            trace_path = written(capture)
            in_window = sum(1 for c in prof_report.timeline
                            if t_call <= c["started_unix"] <= t_call + window_ms / 1e3)
            if in_window >= 15:
                break
            first_ms = (prof_report.timeline[0]["started_unix"] - t_call) * 1e3
            window_ms = int(first_ms + 20 * step_ms) + 1
    finally:
        admin.stop()
        admin.servicer.telemetry.close()
    if in_window < 10:
        raise AssertionError(f"trace: {in_window} events started in the {window_ms} ms "
                             "profiler window")
    prof = checked("profile", trace, prof_report, oracle=False)
    with open(trace_path) as f:
        busy = profile_busy(json.load(f))
    line["profile"] = {"requested_window_ms": window_ms, "attempts": attempt + 1,
                       "events_started_in_window": in_window, "replay": prof, **busy,
                       "note": "window opened over the socket just before a replay: its "
                               "set-up (servers, full Sync, cold step), then its first events"}

    # 5. the exported pass, assembled
    export = os.path.join(tmp, "spans")
    exp_report = TraceReplay(trace, transport="raw", warmup=False, oracle=False,
                             trace_export=export).run()
    exp = checked("exported", trace, exp_report, oracle=False)
    assembly = assemble([export])
    exp.update(traces=len(assembly.traces), spans=len(assembly.spans_by_id),
               incomplete=len(assembly.incomplete), orphans=len(assembly.orphan_spans),
               malformed_lines=assembly.malformed_lines)
    if exp["incomplete"] or exp["orphans"] or exp["traces"] != 3 * (len(trace.events) + 1):
        raise AssertionError(f"trace: assembled {exp}")
    line["exported"] = exp

    # 6. the trace at the headline cluster size
    big = generate_trace(TraceConfig(**TRACE_HEADLINE_CFG))
    if big.digest() != TRACE_HEADLINE_SHA256:
        raise AssertionError(f"headline trace digest {big.digest()} != {TRACE_HEADLINE_SHA256}")
    reset()
    big_report, big_plain = held("headline", big, (0, len(big.events) // 2, len(big.events)),
                                 transport="raw")
    big_line = checked("headline", big, big_report)
    big_line.update(launches=counts(), k2_vs_plain=big_plain)
    if big_line["launches"]["cycle_wide"] != 2 * 2 * (len(big.events) + 1):
        raise AssertionError(f"trace headline: launches {big_line['launches']}")
    line["headline"] = {**TRACE_HEADLINE_CFG, "digest": big.digest(), **big_line}
    return line, launches["cycle_wide"]


# The hooks pass of the ``extras`` line: QoS LSR on every LSR_EVERY-th pod
# from the third (the headline's pods are LS or BE, which bind no cpuset;
# pods 0, 8, 16, ... carry the scenario's GPU requests and affinity), so
# NUMA Reserve runs the cpuset accumulator on real placements.
LSR_EVERY = 16
# Pod rows of the full-size composition held against the CPU path.
EXTRAS_CPU_ROWS = 1024


def node_topologies(nodes):
    """{node index: CPUTopology}, 2 sockets x 1 NUMA node, sized by the
    node's CPU; nodes of one size share one topology."""
    from koordinator_tpu_torch.model import resources as res
    from koordinator_tpu_torch.model.topology import CPUTopology

    built, out = {}, {}
    for i, nd in enumerate(nodes):
        cores = res.parse_quantity(nd["allocatable"]["cpu"], res.CPU) // 1000
        if cores not in built:
            built[cores] = CPUTopology.build(2, 1, max(cores // 4, 1), 2)
        out[i] = built[cores]
    return out


def with_lsr(snap):
    """``snap`` with QoS LSR on every ``LSR_EVERY``-th pod from the third."""
    from koordinator_tpu_torch.model.snapshot import QoSClass

    qos = snap.pods.qos.clone()
    qos[3::LSR_EVERY] = int(QoSClass.LSR)
    return dataclasses.replace(snap, pods=dataclasses.replace(snap.pods, qos=qos))


def run_hooks(snap, tables, topologies, result, window=None):
    """The Reserve and PreBind hooks of the three plugins for ``result``'s
    placements, on a fresh context of ``tables`` (the Reservation plugin's
    nomination computed first, outside the hooks), inside ``window`` (a
    context manager) when given.  Returns the context, the patches, the
    pods whose Reserve failed, and the hooks' host wall ms."""
    import contextlib

    import torch

    from koordinator_tpu_torch.harness.extras_scenario import (
        extended_plugins, extras_context,
    )
    from koordinator_tpu_torch.scheduler.framework import FrameworkExtender

    fx = FrameworkExtender(extended_plugins())
    failures = []
    fx.register_error_handler(lambda ctx, p, exc: failures.append(p) or True)
    ctx = extras_context(snap, *tables, cpu_topologies=topologies)
    next(pl for pl in fx.plugins if pl.name == "Reservation").score(ctx)
    on_card = snap.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    with window or contextlib.nullcontext():
        t0 = time.perf_counter()
        fx.run_reserve(ctx, result)
        patches = fx.pre_bind_patches(ctx, result)
        if on_card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return ctx, patches, failures, ms


def hooks_view(ctx, patches, failures):
    """What the hooks produced, as host objects to compare."""
    return {"cpusets": ctx.state.get("cpuset_allocations", {}),
            "devices": ctx.state.get("device_allocations", {}),
            "minors": ctx.extras.get("device_minors", {}), "patches": patches,
            "failures": failures}


def launch_counts(prof):
    """(CUDA kernel launch calls, device ops: kernels and copies) that a
    finished ``torch.profiler`` window recorded."""
    from torch.autograd import DeviceType

    launches = sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)
    device_ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return launches, device_ops


def extras_phase(card, dev, counted, only):
    """The ``extras`` line (phase 13) and the kernels' launches on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from koordinator_tpu_torch.harness.anchor import (
        ANCHOR_RECIPE, EXTRAS_ANCHOR_SHA256, EXTRAS_TENSORS_SHA256, cycle_digest,
        extras_digest,
    )
    from koordinator_tpu_torch.harness.extras_scenario import (
        extended_plugins, extras_context, extras_snapshot, plugin_extra_tensors,
    )
    from koordinator_tpu_torch.scheduler.framework import FrameworkExtender
    from koordinator_tpu_torch.solver import greedy, greedy_assign, run_cycle

    def framework():
        fx = FrameworkExtender(extended_plugins())
        fx.register_error_handler(lambda ctx, p, exc: True)
        return fx

    # the anchor recipe: tensors and both cycles against the JAX digests
    snap_a, *tables_a, _, _ = extras_snapshot(**ANCHOR_RECIPE, device=dev)
    m_a, s_a = plugin_extra_tensors(snap_a, *tables_a)
    if extras_digest(m_a.cpu(), s_a.cpu()) != EXTRAS_TENSORS_SHA256:
        raise AssertionError("extras anchor: the composed tensors' digest differs")
    for name, kw in (("K2", {}), ("K1", {"i32_ok": False})):
        res_a = framework().run_cycle(extras_context(snap_a, *tables_a), **kw)
        digest = cycle_digest(res_a.assignment.cpu(), res_a.status.cpu())
        if res_a.path != "cuda" or digest != EXTRAS_ANCHOR_SHA256:
            raise AssertionError(f"extras anchor on {name}: digest {digest}")

    # full size
    t0 = time.perf_counter()
    snap, zones, policy, devices, rsv, nodes, pods = extras_snapshot(device=dev)
    tables = (zones, policy, devices, rsv)
    encode_s = time.perf_counter() - t0
    P, N = snap.pods.capacity, snap.nodes.capacity
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mask, scores = plugin_extra_tensors(snap, *tables)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    comp_ev, comp_wall = cuda_time(lambda: plugin_extra_tensors(snap, *tables))
    # the bound: the outputs written once and the tables read once
    out_bytes = tensor_bytes(mask, scores)
    in_bytes = tensor_bytes(
        snap.pods.requests, snap.nodes.valid, zones.allocatable, zones.requested,
        zones.valid, devices.total, devices.free, devices.dev_type, devices.valid,
        rsv.node_index, rsv.allocatable, rsv.allocated, rsv.declared, rsv.allocate_policy,
        rsv.order, rsv.unschedulable, rsv.valid, rsv.matched, rsv.affinity_required,
    ) + policy.nbytes
    comp_bound, comp_bound_by = _bound(out_bytes + in_bytes, 0)

    # the composition against the CPU path on pod rows spread across [0, P)
    rows = torch.linspace(0, P - 1, EXTRAS_CPU_ROWS).round().long()
    if len(set(rows.tolist())) != EXTRAS_CPU_ROWS:
        raise AssertionError("extras: sampled pod rows repeat")
    snap_cpu = map_snapshot(snap, lambda t: t.cpu())
    rsv_cpu = rsv.to("cpu")
    sub = greedy._pod_rows(snap_cpu, rows)
    sub_rsv = dataclasses.replace(rsv_cpu, matched=rsv_cpu.matched[rows],
                                  affinity_required=rsv_cpu.affinity_required[rows])
    t0 = time.perf_counter()
    m_cpu, s_cpu = plugin_extra_tensors(sub, zones.to("cpu"), policy, devices.to("cpu"),
                                        sub_rsv)
    cpu_rows_s = time.perf_counter() - t0
    if not (torch.equal(m_cpu, mask[rows].cpu()) and torch.equal(s_cpu, scores[rows].cpu())):
        raise AssertionError("extras: the card's mask or scores differ from the CPU path")

    # the cycle through the FrameworkExtender, on K2 and on K1, each against
    # one plain run; the hooks' Reserve failures are claimed by a handler
    oracle = greedy_assign(snap, extra_mask=mask, extra_scores=scores)
    torch.cuda.synchronize()
    launches = {}
    results = {}
    for name, kernel, kw in (("K2", "cycle_wide", {}),
                             ("K1", "cycle_dense", {"i32_ok": False})):
        fx = framework()
        result, counts = counted(f"extras {name}", oracle, lambda: fx.run_cycle(
            extras_context(snap, *tables), **kw))
        launches[name] = only(f"the extras cycle on {name}", counts, kernel)
        results[name] = result
    k2_ev, k2_wall = cuda_time(lambda: run_cycle(snap, extra_mask=mask, extra_scores=scores))
    k1_ev, k1_wall = cuda_time(lambda: run_cycle(snap, extra_mask=mask, extra_scores=scores,
                                                 i32_ok=False))
    result = results["K2"]

    # the hooks on the card against the CPU path, on the same placements
    topo = node_topologies(nodes)
    snap_h = with_lsr(snap)
    hooks_ms = []
    for _ in range(TIMED_RUNS):
        ctx, patches, failures, ms = run_hooks(snap_h, tables, topo, result)
        hooks_ms.append(ms)
    card_view = hooks_view(ctx, patches, failures)
    result_cpu = dataclasses.replace(result, assignment=result.assignment.cpu(),
                                     status=result.status.cpu())
    tables_cpu = (zones.to("cpu"), policy, devices.to("cpu"), rsv_cpu)
    ctx_c, patches_c, failures_c, cpu_hooks_ms = run_hooks(
        with_lsr(snap_cpu), tables_cpu, topo, result_cpu)
    if hooks_view(ctx_c, patches_c, failures_c) != card_view:
        raise AssertionError("extras: the card's Reserve/PreBind results differ from the CPU path")
    with_profile = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run_hooks(snap_h, tables, topo, result, window=with_profile)
    hook_launches, hook_device_ops = launch_counts(with_profile)
    placed = int((result.assignment >= 0).sum())
    if hook_launches >= 100:
        raise AssertionError(f"extras hooks: {hook_launches} kernel launches for {placed} pods")

    kinds = {}
    for patch in patches.values():
        for k in patch["annotations"]:
            kinds[k] = kinds.get(k, 0) + 1
    line = {
        "path": "FrameworkExtender([NodeNUMAResource, Reservation, DeviceShare]).run_cycle",
        "snapshot": f"quota_colocation {P} pods x {N} nodes, seed 0, extras_scenario seed 0",
        "anchor": f"{ANCHOR_RECIPE}: tensors, K2 and K1 digests match the reference",
        "encode_s": encode_s, "pods": P, "nodes": N,
        "masked_cells": int((~mask).sum()), "scored_cells": int((scores > 0).sum()),
        "composition_ms_cuda_events": comp_ev, "composition_ms_host_wall": comp_wall,
        "composition_bound_ms": comp_bound, "composition_bound_by": comp_bound_by,
        "composition_out_bytes": out_bytes, "composition_in_bytes": in_bytes,
        "composition_peak_bytes": peak,
        "composition_peak_over_resident_bytes": peak - before,
        "cpu_rows_checked": EXTRAS_CPU_ROWS, "cpu_rows_s": cpu_rows_s,
        "assigned": placed, "launches": launches,
        "cycle_k2_ms_cuda_events": k2_ev, "cycle_k2_ms_host_wall": k2_wall,
        "cycle_k1_ms_cuda_events": k1_ev, "cycle_k1_ms_host_wall": k1_wall,
        "hooks_ms_host_wall": statistics.median(hooks_ms), "hooks_cpu_path_ms": cpu_hooks_ms,
        "hooks_kernel_launches": hook_launches, "hooks_device_ops": hook_device_ops,
        "cpusets": len(card_view["cpusets"]), "device_allocations": len(card_view["devices"]),
        "reserve_failures": len(failures), "patches": len(patches), "annotations": kinds,
        "parity": "tensors exact vs the CPU path; K2 and K1 exact vs one greedy_assign; "
                  "hooks equal to the CPU path",
        "timed_runs": TIMED_RUNS, "card": card,
    }
    return line, launches


def rebalance_phase(card, dev, counted, only, snap, lists, oracle):
    """The ``rebalance`` line (phase 14) and K2's launches on it."""
    import torch

    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.harness.anchor import (
        ANCHOR_RECIPE, REBALANCE_ANCHOR_SHA256, plan_digest,
    )
    from koordinator_tpu_torch.harness.rebalance import placed_node_dicts, plan_rebalance
    from koordinator_tpu_torch.solver import run_cycle

    anchor, a_nodes, a_pods, *_ = g.quota_colocation_snapshot(**ANCHOR_RECIPE, device=dev)
    a_res = run_cycle(anchor)
    a_plan = plan_rebalance(placed_node_dicts(a_nodes, a_pods, a_res.assignment.tolist()))
    if a_res.path != "cuda" or plan_digest(a_plan) != REBALANCE_ANCHOR_SHA256:
        raise AssertionError("rebalance anchor: the plan's digest differs from the reference's")

    nodes, pods = lists[0], lists[1]
    result, counts = counted("rebalance cycle", oracle, lambda: run_cycle(snap))
    k2 = only("the rebalance cycle", counts, "cycle_wide")
    t0 = time.perf_counter()
    node_dicts = placed_node_dicts(nodes, pods, result.assignment.tolist())
    dicts_ms = (time.perf_counter() - t0) * 1e3
    times, plan = [], []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        plan = plan_rebalance(node_dicts)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {
        "path": "run_cycle(snap) -> placed_node_dicts -> balance(dry_run, pool low 20/20, "
                "high 50/50)",
        "anchor": f"{ANCHOR_RECIPE}: {len(a_plan)} planned evictions, digest matches",
        "assigned": int((result.assignment >= 0).sum()), "launches": {"K2": k2},
        "node_dicts_ms_host_wall": dicts_ms,
        "balance_ms_host_wall": statistics.median(times),
        "planned_evictions": len(plan),
        "source_nodes": len({p["node"] for p in plan}),
        "timed_runs": TIMED_RUNS, "card": card,
    }, k2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU",
              file=sys.stderr)
        return 1

    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.harness.anchor import (
        ANCHOR_RECIPE, ANCHOR_SHA256, TERM_ANCHOR_HEADROOM, TERM_ANCHOR_SEED,
        TERM_ANCHOR_SHA256, TERM_TOPK_ANCHOR_SHA256, TOPK_ANCHOR_K, TOPK_ANCHOR_SHA256,
        WAVE_ANCHOR_CFG, WAVE_ANCHOR_ROUNDS, cycle_digest,
    )
    from koordinator_tpu_torch.solver import (
        dense, greedy_assign, kernel_demotions, run_cycle, wide,
    )
    from koordinator_tpu_torch.solver.terms import default_term_config, term_extras
    from koordinator_tpu_torch.config import CycleConfig

    phase_s = {}
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    # phase 1
    card = card_line()
    dev = torch.device("cuda")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    phase_done("1_card")

    # phase 2: one nvcc per build, all started together
    builds = ((dense.KERNEL_SOURCE, ()), (wide.KERNEL_SOURCE, ()),
              (dense.KERNEL_SOURCE, _build.PHASE_CLOCK), (wide.KERNEL_SOURCE, _build.PHASE_CLOCK))
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: _build.build(*b), builds))
    for (_, defines), built_one in zip(builds, built):
        print(f"build: {built_one.path.name} {' '.join(defines)} in {built_one.seconds:.2f} s")
        for line in built_one.log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}")
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", built_one.log)]
        if not spills or any(spills):
            raise AssertionError(f"{built_one.path.name}: ptxas spill bytes {spills}")
    phase_done("2_build")

    # phase 3
    cases = build_cases(dev)
    for name, snap, cfg, xm, xs in cases:
        got = dense.greedy_assign_dense(snap, cfg, extra_mask=xm, extra_scores=xs)
        want = greedy_assign(snap, cfg, extra_mask=xm, extra_scores=xs)
        torch.cuda.synchronize()
        if got.path != "cuda":
            raise AssertionError(f"{name}: kernel path not taken ({got.path})")
        assert_same(name, got, want)
        placed = int((got.assignment >= 0).sum())
        rounds = []
        for wave, top_m in ((1, cfg.top_m), (8, 2), (32, 4)):
            res = wide_parity(f"{name} wave={wave}",
                              snap, dataclasses.replace(cfg, wave=wave, top_m=top_m), xm, xs)
            if res.rounds is not None:
                rounds.append(int(res.rounds))
        print(f"parity {name}: K1, K2, K3 exact, {placed}/{snap.num_pods} placed, "
              f"K3 rounds (8,2) {rounds[0]} (32,4) {rounds[1]}")
    quota_small = cases[3][1]
    for name, snap, cfg in (
        ("most_allocated_wave", quota_small,
         CycleConfig(fit_scoring_strategy="MostAllocated", wave=8, top_m=4)),
        ("contention_tight_nodes", contention_case(dev), CycleConfig(wave=8, top_m=2)),
    ):
        res = wide_parity(name, snap, cfg, None, None)
        placed = int((res.assignment >= 0).sum())
        print(f"parity {name}: K3 exact, {placed}/{snap.num_pods} placed, "
              f"rounds {int(res.rounds)}")
    xm, xs = extras_beyond_int32(quota_small, seed=12)
    got = dense.greedy_assign_dense(quota_small, CycleConfig(), extra_mask=xm, extra_scores=xs)
    want = greedy_assign(quota_small, CycleConfig(), extra_mask=xm, extra_scores=xs)
    torch.cuda.synchronize()
    if got.path != "cuda":
        raise AssertionError(f"extras_beyond_int32: kernel path not taken ({got.path})")
    assert_same("extras_beyond_int32", got, want)
    try:
        wide.greedy_assign_wide(quota_small, CycleConfig(), extra_mask=xm, extra_scores=xs)
    except ValueError:
        pass
    else:
        raise AssertionError("greedy_assign_wide took extra scores beyond 2^29")
    print(f"parity extras_beyond_int32: K1 exact, "
          f"{int((got.assignment >= 0).sum())}/{quota_small.num_pods} placed; "
          "the int32 entry refuses them")
    for name, snap, cfg, resident in cluster_cases(dev):
        got = dense.greedy_assign_dense(snap, cfg)
        want = greedy_assign(snap, cfg)
        torch.cuda.synchronize()
        if got.path != "cuda":
            raise AssertionError(f"{name}: kernel path not taken ({got.path})")
        assert_same(name, got, want)
        inp_w = wide.prepare_wide_inputs(snap, cfg)
        plans = {"K1": dense.cycle_plan(dense.prepare_cycle_inputs(snap, cfg)),
                 "K2": wide.wide_plan(inp_w), "K3": wide.wave_plan(inp_w, 32, 4)}
        for kernel, plan in plans.items():
            if bool(plan["resident"]) != resident:
                raise AssertionError(f"{name}: {kernel} plan {plan}, want resident={resident}")
        rounds = []
        for wave, top_m in ((1, cfg.top_m), (8, 2), (32, 4)):
            res = wide_parity(f"{name} wave={wave}",
                              snap, dataclasses.replace(cfg, wave=wave, top_m=top_m), None, None)
            if res.rounds is not None:
                rounds.append(int(res.rounds))
        print(f"parity {name}: K1, K2, K3 exact, {int((got.assignment >= 0).sum())}/"
              f"{snap.num_pods} placed on {snap.num_nodes} nodes, K3 rounds (8,2) {rounds[0]} "
              f"(32,4) {rounds[1]}; K1 plan {plans['K1']}; K2 plan {plans['K2']}; "
              f"K3 plan {plans['K3']}")
    phase_done("3_parity")

    # phase 4: the headline snapshot
    t0 = time.perf_counter()
    snap, *cluster_lists, _ = g.quota_colocation_snapshot(device=dev)
    encode_s = time.perf_counter() - t0
    cfg = CycleConfig()
    cfg_w = CycleConfig(**WAVE_CFG)
    oracle = greedy_assign(snap, cfg)
    torch.cuda.synchronize()
    snapshot_desc = "quota_colocation 10000 pods x 2000 nodes, 16 tenants, seed 0"

    def counted(name, want, call):
        """``call()`` with every launch count set to 0 just before it;
        exact against ``want``, no demotion.  Returns (result,
        {kernel: launches})."""
        torch.cuda.synchronize()
        dense.reset_launches()
        wide.reset_launches()
        out = call()
        torch.cuda.synchronize()
        counts = {"cycle_dense": dense.LAUNCHES, **wide.LAUNCHES}
        if out.path != "cuda" or kernel_demotions():
            raise AssertionError(f"{name}: path {out.path}, demotions {kernel_demotions()}")
        assert_same(name, out, want)
        return out, counts

    def drive(name, want, *args, **kw):
        return counted(name, want, lambda: run_cycle(*args, **kw))

    def only(name, counts, kernel):
        if counts[kernel] < 1 or sum(counts.values()) != counts[kernel]:
            raise AssertionError(f"{name} did not run on {kernel} alone: {counts}")
        return counts[kernel]

    def kernel_vs_plain(name, kernel, plain, *args, **kw):
        """(kernel ms, plain ms, max abs err) on the same inputs."""
        out = kernel(*args, **kw)
        ms, _ = cuda_time(lambda: kernel(*args, **kw))
        plain_ms, plain_out = timed_once(lambda: plain(*args, **kw))
        err = max_abs_err(out, plain_out)
        if err != 0:
            raise AssertionError(f"{name} vs plain version: max abs err {err}")
        return ms, plain_ms, err

    # K2's path: run_cycle with the default config (the inputs fit int32)
    result, counts = drive("headline", oracle, snap, cfg)
    k2_launches = only("the headline", counts, "cycle_wide")
    cycle_ev, cycle_wall = cuda_time(lambda: run_cycle(snap, cfg))
    inp_2 = wide.prepare_wide_inputs(snap, cfg)
    k2_ms, k2_plain_ms, k2_err = kernel_vs_plain(
        "K2", wide.cycle_wide_cuda, wide.cycle_wide_reference, inp_2, cfg)
    k2_bound, k2_bound_by = cycle_bound_ms(inp_2)
    # K1 alone on the same default inputs: the rung K2 runs before
    inp_1 = dense.prepare_cycle_inputs(snap, cfg)
    k1_no_extras_ms, _ = cuda_time(lambda: dense.cycle_dense_cuda(inp_1, cfg))
    print(json.dumps({"headline": {
        "path": "run_cycle(snap)", "kernel": "cycle_wide", "snapshot": snapshot_desc,
        "assigned": int((result.assignment >= 0).sum()), "pods": snap.num_pods,
        "nodes": snap.num_nodes, "encode_s": encode_s, "cycle_ms_cuda_events": cycle_ev,
        "cycle_ms_host_wall": cycle_wall, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound, "k1_kernel_ms_same_inputs": k1_no_extras_ms,
        "cluster": wide.wide_plan(inp_2),
        "pod_split": pod_split(wide.cycle_wide_cuda, wide.wide_phase_cycles, inp_2, cfg),
        "timed_runs": TIMED_RUNS, "parity": "exact vs greedy_assign",
    }}))

    # K3's path: the wave-batched run_cycle
    result_w, counts = drive("wave headline", oracle, snap, cfg_w)
    k3_launches = only("the wave headline", counts, "wave_cycle")
    if result_w.rounds is None:
        raise AssertionError("the wave headline has no rounds")
    w_ev, w_wall = cuda_time(lambda: run_cycle(snap, cfg_w))
    inp_w = wide.prepare_wide_inputs(snap, cfg_w)
    stats = {}
    k3_ms, k3_plain_ms, k3_err = kernel_vs_plain(
        "K3", wide.wave_cycle_cuda,
        lambda *a, **kw: wide.wave_cycle_reference(*a, **kw, stats=stats),
        inp_w, cfg_w, **WAVE_CFG)
    k3_bound, k3_bound_by = cycle_bound_ms(inp_w, extra_out_bytes=4)
    split = wave_phase_split(inp_w, cfg_w)
    if split["rounds"] != int(result_w.rounds):
        raise AssertionError(f"instrumented K3 rounds {split['rounds']} != {int(result_w.rounds)}")
    print(json.dumps({"wave_headline": {
        "path": "run_cycle(snap, CycleConfig(wave=32, top_m=4))", "kernel": "wave_cycle",
        "snapshot": snapshot_desc, "assigned": int((result_w.assignment >= 0).sum()),
        "rounds": int(result_w.rounds), "cycle_ms_cuda_events": w_ev,
        "cycle_ms_host_wall": w_wall, "kernel_ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound, "work": stats, "timed_runs": TIMED_RUNS,
        "cluster": wide.wave_plan(inp_w, **WAVE_CFG), "phase_split": split,
        "parity": "exact vs greedy_assign",
    }}))

    # K1's path: extra scores beyond the int32 kernels' range
    xm, xs = extras_beyond_int32(snap, seed=0)
    oracle_x = greedy_assign(snap, cfg, extra_mask=xm, extra_scores=xs)
    result_x, counts = drive("dense headline", oracle_x, snap, cfg,
                             extra_mask=xm, extra_scores=xs)
    k1_launches = only("the dense headline", counts, "cycle_dense")
    # a wave request on the same inputs takes K1 too, without rounds
    result_xw, counts = drive("dense headline, wave request", oracle_x, snap, cfg_w,
                              extra_mask=xm, extra_scores=xs)
    only("the wave request beyond int32", counts, "cycle_dense")
    if result_xw.rounds is not None:
        raise AssertionError("a wave request on K1 reported rounds")
    x_ev, x_wall = cuda_time(lambda: run_cycle(snap, cfg, extra_mask=xm, extra_scores=xs))
    inp_x = dense.prepare_cycle_inputs(snap, cfg, xm, xs)
    k1_ms, k1_plain_ms, k1_err = kernel_vs_plain(
        "K1", dense.cycle_dense_cuda, dense.cycle_dense_reference, inp_x, cfg)
    k1_bound, k1_bound_by = cycle_bound_ms(inp_x)
    print(json.dumps({"dense_headline": {
        "path": "run_cycle(snap, extra_mask=90%, extra_scores in [0, 2^31))",
        "kernel": "cycle_dense", "snapshot": snapshot_desc,
        "assigned": int((result_x.assignment >= 0).sum()), "cycle_ms_cuda_events": x_ev,
        "cycle_ms_host_wall": x_wall, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound, "kernel_ms_without_extras": k1_no_extras_ms,
        "cluster": dense.cycle_plan(inp_x),
        "pod_split": pod_split(dense.cycle_dense_cuda, dense.phase_cycles, inp_x, cfg),
        "timed_runs": TIMED_RUNS, "parity": "exact vs greedy_assign",
    }}))
    phase_done("4_headline")

    # phase 5
    anchor = g.quota_colocation_snapshot(**ANCHOR_RECIPE, device=dev)[0]
    for name, ar in (("K2", run_cycle(anchor, cfg)),
                     ("K1", dense.greedy_assign_dense(anchor, cfg))):
        digest = cycle_digest(ar.assignment.cpu(), ar.status.cpu())
        if ar.path != "cuda" or digest != ANCHOR_SHA256:
            raise AssertionError(f"{name} anchor digest {digest} != {ANCHOR_SHA256}")
    aw = run_cycle(anchor, CycleConfig(**WAVE_ANCHOR_CFG))
    wave_digest = cycle_digest(aw.assignment.cpu(), aw.status.cpu())
    if aw.path != "cuda" or wave_digest != ANCHOR_SHA256:
        raise AssertionError(f"wave anchor digest {wave_digest} (path {aw.path}) "
                             f"!= {ANCHOR_SHA256}")
    if int(aw.rounds) != WAVE_ANCHOR_ROUNDS:
        raise AssertionError(f"wave anchor rounds {int(aw.rounds)} != {WAVE_ANCHOR_ROUNDS}")
    print(f"anchor: {ANCHOR_RECIPE} K2, K1 and wave digests match the reference "
          f"({digest[:16]}), wave rounds {WAVE_ANCHOR_ROUNDS} match")
    phase_done("5_anchor")

    # phase 6: the Score RPC's device side, default and term configuration
    snap_t = g.with_term_tensors(snap, seed=TERM_ANCHOR_SEED)
    cfg_t = default_term_config(packing_headroom=TERM_ANCHOR_HEADROOM)
    anchor_t = g.with_term_tensors(anchor, seed=TERM_ANCHOR_SEED)
    print(json.dumps({"score_headline": [
        {"snapshot": snapshot_desc,
         **score_phase(card, "default", snap, cfg, TOPK_ANCHOR_K, anchor, TOPK_ANCHOR_SHA256)},
        {"snapshot": snapshot_desc + ", term data seed 0",
         **score_phase(card, "terms: default_term_config(packing_headroom=cpu 98, memory 98)",
                       snap_t, cfg_t, TOPK_ANCHOR_K, anchor_t, TERM_TOPK_ANCHOR_SHA256)},
    ]}))
    phase_done("6_score_headline")

    # phase 7: the Assign cycle with the fused terms, on K2 and on K3
    extras_ev, extras_wall = cuda_time(lambda: term_extras(snap_t, cfg_t))
    xs_t, xm_t = term_extras(snap_t, cfg_t)
    oracle_t = greedy_assign(snap_t, cfg_t, extra_mask=xm_t, extra_scores=xs_t)
    cfg_tw = dataclasses.replace(cfg_t, **WAVE_CFG)
    terms_line = {"term_extras_ms_cuda_events": extras_ev,
                  "term_extras_ms_host_wall": extras_wall, "runs": []}
    for name, c, kernel, plain, kw in (
        ("terms headline", cfg_t, wide.cycle_wide_cuda, wide.cycle_wide_reference, {}),
        ("terms wave headline", cfg_tw, wide.wave_cycle_cuda,
         wide.wave_cycle_reference, WAVE_CFG),
    ):
        res_t, counts = drive(name, oracle_t, snap_t, c)
        launched = "wave_cycle" if kw else "cycle_wide"
        launches = only(name, counts, launched)
        ev, wall = cuda_time(lambda: run_cycle(snap_t, c))
        inp_t = wide.prepare_wide_inputs(snap_t, c, xm_t, xs_t)
        k_ms, k_plain_ms, k_err = kernel_vs_plain(name, kernel, plain, inp_t, c, **kw)
        run = {"path": f"run_cycle(snap_terms, {'wave=32, top_m=4' if kw else 'cfg_terms'})",
               "kernel": launched, "launches": launches,
               "assigned": int((res_t.assignment >= 0).sum()),
               "cycle_ms_cuda_events": ev, "cycle_ms_host_wall": wall, "kernel_ms": k_ms,
               "plain_ms": k_plain_ms, "max_abs_err": k_err,
               "parity": "exact vs greedy_assign on the term extras and vs the plain version"}
        if kw:
            if res_t.rounds is None:
                raise AssertionError("the terms wave headline has no rounds")
            run["rounds"] = int(res_t.rounds)
        terms_line["runs"].append(run)
    at = run_cycle(anchor_t, cfg_t)
    t_digest = cycle_digest(at.assignment.cpu(), at.status.cpu())
    if at.path != "cuda" or t_digest != TERM_ANCHOR_SHA256:
        raise AssertionError(f"term anchor digest {t_digest} != {TERM_ANCHOR_SHA256}")
    terms_line.update({"anchor_digest": "matches", "moved_by_terms": int(
        (oracle_t.assignment != oracle.assignment).sum()), "snapshot": snapshot_desc,
        "card": card})
    print(json.dumps({"terms_cycle": terms_line}))
    phase_done("7_terms_cycle")

    # phase 8: the warm delta and the incremental rescore
    print(json.dumps({"incremental": [
        incremental_phase(card, "default", snap, cfg, seed=8),
        incremental_phase(card, "terms", snap_t, cfg_t, seed=8),
    ]}))
    phase_done("8_incremental")

    # phase 9: the sparse candidate engine
    print(json.dumps({"sparse": sparse_phase(card, dev)}))
    phase_done("9_sparse")

    # phase 11: the serving seam
    print(json.dumps({"bridge": bridge_phase(card, dev, snap, cluster_lists, result)}))
    phase_done("11_bridge")

    # phase 12: the trace replay through ScorerClient
    trace_line, k2_trace_launches = trace_phase(card, dev)
    print(json.dumps({"trace": trace_line}))
    phase_done("12_trace")

    # phase 13: the extended-plugin cycle
    extras_line, extras_launches = extras_phase(card, dev, counted, only)
    print(json.dumps({"extras": extras_line}))
    phase_done("13_extras")

    # phase 14: the rebalance leg
    rebalance_line, k2_rebalance = rebalance_phase(card, dev, counted, only, snap,
                                                   cluster_lists, oracle)
    print(json.dumps({"rebalance": rebalance_line}))
    phase_done("14_rebalance")

    # phase 10
    print(json.dumps({"phase_seconds": phase_s}))
    entries = (
        ("cycle_dense", "koordinator_tpu_torch/solver/cycle_cuda.cu",
         "koordinator_tpu/solver/pallas_dense.py:114", k1_launches, 0,
         extras_launches["K1"], 0, k1_err, k1_ms, k1_plain_ms, k1_bound, k1_bound_by),
        ("cycle_wide", "koordinator_tpu_torch/solver/cycle_cuda.cu",
         "koordinator_tpu/solver/pallas_cycle.py:180", k2_launches, k2_trace_launches,
         extras_launches["K2"], k2_rebalance, k2_err, k2_ms, k2_plain_ms, k2_bound,
         k2_bound_by),
        ("wave_cycle", "koordinator_tpu_torch/solver/cycle_wide_cuda.cu",
         "koordinator_tpu/solver/pallas_cycle.py:347", k3_launches, 0, 0, 0, k3_err, k3_ms,
         k3_plain_ms, k3_bound, k3_bound_by),
    )
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "trace_launches": trace_launches,
        "extras_launches": extras_n, "rebalance_launches": rebalance_n, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        # no PyTorch call computes a sequential greedy assignment
        "library_ms": None, "parity": "exact",
    } for name, source, replaces, launches, trace_launches, extras_n, rebalance_n, err, ms,
        plain_ms, bound_ms, bound_by in entries]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
