#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Assign cycle on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. the card's name and power limit, torch and CUDA versions;
2. build the three cycle kernels from their two sources, one ``nvcc`` per
   source, both started together: K1 (``solver/cycle_cuda.cu``), K2 and K3
   (``solver/cycle_wide_cuda.cu``); build seconds, ptxas registers and
   spills of each kernel;
3. every kernel against its plain version on the card, exactly, on every
   case of ``build_cases``: K1 (``greedy_assign_dense``) against
   ``greedy_assign``; K2 (``greedy_assign_wide`` at wave 1) and K3 (at
   (wave, top_m) = (8, 2) and (32, 4)) against ``cycle_wide_reference`` and
   ``wave_cycle_reference``, all five ``CycleResult`` arrays and K3's
   rounds; then K3 under MostAllocated at (8, 4) and on the contention
   case, and K1 on extra scores beyond the int32 kernels' range (which
   ``greedy_assign_wide`` refuses);
4. the headlines on the 10k-pod x 2k-node quota_colocation snapshot, each
   path driven through ``run_cycle`` on the inputs that select its kernel,
   with every launch count set to 0 just before it and read just after,
   exact against ``greedy_assign``, no demotion and no other kernel
   launched, timed (CUDA events and host wall, median of 7), its kernel
   timed alone and its plain version once: K2's path ``run_cycle(snap)``,
   K3's path ``run_cycle(snap, CycleConfig(wave=32, top_m=4))``, K1's path
   ``run_cycle(snap, extra_mask=..., extra_scores=...)`` with extra scores
   up to 2^31 (and the wave request on them, which K1 also takes);
5. the reference anchors: the digest of the per-pod (K2 and K1) and of the
   wave cycle on a fixed mid-size snapshot against ``harness/anchor.py``'s
   constant, and the wave cycle's rounds against the reference kernel's,
   both recomputed from the JAX reference by a CPU test;
6. the seconds of each phase, a ``kernels`` JSON line, the card line, then
   the result line.

Imports nothing of JAX and nothing of the JAX package.  Needs one CUDA card
and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU",
              file=sys.stderr)
        return 1

    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.harness.anchor import (
        ANCHOR_RECIPE, ANCHOR_SHA256, WAVE_ANCHOR_CFG, WAVE_ANCHOR_ROUNDS, cycle_digest,
    )
    from koordinator_tpu_torch.solver import (
        dense, greedy_assign, kernel_demotions, run_cycle, wide,
    )
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

    # phase 2: one nvcc per source, both started together
    sources = (dense.KERNEL_SOURCE, wide.KERNEL_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    for built_one in built:
        print(f"build: {built_one.path.name} in {built_one.seconds:.2f} s")
        for line in built_one.log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}")
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
    phase_done("3_parity")

    # phase 4: the headline snapshot
    t0 = time.perf_counter()
    snap = g.quota_colocation_snapshot(device=dev)[0]
    encode_s = time.perf_counter() - t0
    cfg = CycleConfig()
    cfg_w = CycleConfig(**WAVE_CFG)
    oracle = greedy_assign(snap, cfg)
    torch.cuda.synchronize()
    snapshot_desc = "quota_colocation 10000 pods x 2000 nodes, 16 tenants, seed 0"

    def drive(name, want, *args, **kw):
        """``run_cycle(*args, **kw)`` with every launch count set to 0 just
        before it; exact against ``want``, no demotion.  Returns (result,
        {kernel: launches})."""
        torch.cuda.synchronize()
        dense.reset_launches()
        wide.reset_launches()
        out = run_cycle(*args, **kw)
        torch.cuda.synchronize()
        counts = {"cycle_dense": dense.LAUNCHES, **wide.LAUNCHES}
        if out.path != "cuda" or kernel_demotions():
            raise AssertionError(f"{name}: path {out.path}, demotions {kernel_demotions()}")
        assert_same(name, out, want)
        return out, counts

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
    print(json.dumps({"headline": {
        "path": "run_cycle(snap)", "kernel": "cycle_wide", "snapshot": snapshot_desc,
        "assigned": int((result.assignment >= 0).sum()), "pods": snap.num_pods,
        "nodes": snap.num_nodes, "encode_s": encode_s, "cycle_ms_cuda_events": cycle_ev,
        "cycle_ms_host_wall": cycle_wall, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound, "timed_runs": TIMED_RUNS, "parity": "exact vs greedy_assign",
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
    print(json.dumps({"wave_headline": {
        "path": "run_cycle(snap, CycleConfig(wave=32, top_m=4))", "kernel": "wave_cycle",
        "snapshot": snapshot_desc, "assigned": int((result_w.assignment >= 0).sum()),
        "rounds": int(result_w.rounds), "cycle_ms_cuda_events": w_ev,
        "cycle_ms_host_wall": w_wall, "kernel_ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound, "work": stats, "timed_runs": TIMED_RUNS,
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
    # the kernel alone on the default inputs, the shape timed before extras
    inp_1 = dense.prepare_cycle_inputs(snap, cfg)
    k1_no_extras_ms, _ = cuda_time(lambda: dense.cycle_dense_cuda(inp_1, cfg))
    print(json.dumps({"dense_headline": {
        "path": "run_cycle(snap, extra_mask=90%, extra_scores in [0, 2^31))",
        "kernel": "cycle_dense", "snapshot": snapshot_desc,
        "assigned": int((result_x.assignment >= 0).sum()), "cycle_ms_cuda_events": x_ev,
        "cycle_ms_host_wall": x_wall, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound, "kernel_ms_without_extras": k1_no_extras_ms,
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

    # phase 6
    print(json.dumps({"phase_seconds": phase_s}))
    entries = (
        ("cycle_dense", "koordinator_tpu_torch/solver/cycle_cuda.cu",
         "koordinator_tpu/solver/pallas_dense.py:114", k1_launches, k1_err, k1_ms,
         k1_plain_ms, k1_bound, k1_bound_by),
        ("cycle_wide", "koordinator_tpu_torch/solver/cycle_wide_cuda.cu",
         "koordinator_tpu/solver/pallas_cycle.py:180", k2_launches, k2_err, k2_ms,
         k2_plain_ms, k2_bound, k2_bound_by),
        ("wave_cycle", "koordinator_tpu_torch/solver/cycle_wide_cuda.cu",
         "koordinator_tpu/solver/pallas_cycle.py:347", k3_launches, k3_err, k3_ms,
         k3_plain_ms, k3_bound, k3_bound_by),
    )
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        # no PyTorch call computes a sequential greedy assignment
        "library_ms": None, "parity": "exact",
    } for name, source, replaces, launches, err, ms, plain_ms, bound_ms, bound_by in entries]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
