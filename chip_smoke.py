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
    checks, three K2 launches held against the plain version); then the
    fused terms under traffic: the accelerator trace drawn with the term
    events (``TRACE_TERMS_CFG``, ``mix=TERM_MIX``, two accelerator types,
    three workload classes; its digest the reference's) replayed over the
    raw framing with ``default_term_config()`` (``terms``: every Assign on
    K2) and with it at ``wave=32, top_m=4`` (``terms_wave``: every Assign
    on K3), each with 97 parity checks, no build and no demotion, exactly
    one launch of its kernel and one ``term_extras`` per Assign and none
    of the others, and the engine's launches of the cold and the last
    step exact against their plain version
    (``cycle_wide_reference``, ``wave_cycle_reference`` with its round
    count) on their own inputs.  Every pass checks the engine's Syncs by
    kind.  The ``kernels`` line carries each kernel's launches on the
    trace path (``trace_launches``: the raw replay's and the term
    replays');
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
    (``rebalance_launches`` on the ``kernels`` line);
15. (run before phase 10's lines) ``daemon``: the koord-scheduler daemon
    and its read follower (``scheduler/server.py SchedulerServer``, one
    process, each under its own temporary state dir; the leader with the
    journal and the prewarm, gRPC where ``grpc`` imports) driven by a
    ``ScorerClient`` with the follower as ``followers=``: a full Sync of
    the headline cluster, then the follower subscribes (the full frame's
    raw and zlib bytes, its replication ms); the first Assign equal to
    phase 4's; eight O(changed) delta Syncs (the ``incremental`` recipe,
    seed 8), each replicated before the next (the lag); the view re-sent
    with its names; Score (k = 32) on the follower byte for byte the
    leader's; the follower refusing a Sync with the one-writer text; the
    Assign (K2 only) equal to ``run_cycle`` on the same snapshot, then
    seven measured Assigns with no build and no demotion; healthz and
    ``/metrics`` on both; Profile (admin method 5); the leader restarted
    on its state dir, resuming the same snapshot id from the journal and
    the same Assign, its prewarm rebuilding every recorded variant with
    none failed; then the leader stopped, the follower promoted (admin
    method 4) and the client's next Sync finding it, with one full resync
    on the new epoch, and the same Assign.  ``daemon_launches`` on the
    ``kernels`` line counts the line's K2 launches;
16. (run before phase 10's lines) ``chaos``: the chaos x trace gate
    (``harness/chaos.py ChaosTraceReplay``, over the raw framing) on the
    reference's accelerator trace (128 nodes x 512 pod slots, 48 events,
    its digest against ``CHAOS_ANCHOR_SHA256``; the launch poison at event
    12, the leader killed at 32 and warm-restarted from its journal on the
    same socket, tracing on): parity with the unfaulted oracle, no build
    and no demotion after recovery, recovery measured, breaker trips,
    degraded replies, assembled traces with no orphan client span, the
    killed leader collected before the restart, the SLO verdicts with
    the recovery SLO, the overload band storm (free band shed, prod band
    not); the same gate at the headline trace (2,000 nodes x 10,000 pod
    slots, 24 events, poison at 6, kill at 16), two of its K2 launches
    held against ``cycle_wide_reference`` on the CPU; then ``ChaosTier``
    at the headline (two followers behind channels that drop, duplicate,
    reorder and corrupt; a crash and warm restart, a torn journal tail,
    a promotion, convergence: mirror and flat-Score byte parity with the
    oracle, no torn snapshot on any delivery);
17. (run before phase 10's lines) ``tree``: ``harness/relay.py
    RelayTier(chain=3, flat=1, compress=True, batch_bytes=64 KiB)`` at the
    headline (five daemons on the card): a cold converge, 10 O(changed)
    delta Syncs, flat Score bytes at k = 32 equal at the root, the leaf
    and the flat follower, one Assign (K2) at the root and one at the leaf,
    equal; an interior hop killed in a delta storm with no full open and
    no resync; ``autoscale_wave`` with real leaf daemons as its lever; the
    peak device memory;
18. (run before phase 10's lines) ``preempt``: ``post_filter_preempt``
    over the pods the extras cycle on K2 left unplaced, at the anchor
    recipe (its digest against ``PREEMPT_ANCHOR_SHA256``) and at the
    headline on the ``extras`` line's placements (``harness/preempt.py``
    inventory; ms, pods with victims, victims, digest); then a
    ``ReservationController`` tick that expires the reservations past
    their TTL, ``active_reservations()`` re-encoded and the extras cycle
    re-run on K2 (held against the plain version): expired count and the
    placements that moved.  ``chaos_launches``, ``tree_launches`` and
    ``preempt_launches`` on the ``kernels`` line count each line's
    launches;
19. (run before phase 10's lines) ``lint``: koordlint over the checked-out
    port and this script (``python -m koordinator_tpu_torch.analysis``):
    the rules run and files scanned, no finding (by rule), the live and
    stale suppression tags, the derived lock graph's locks and edges, the
    pass's seconds; then the ``chaos`` line's accelerator replay once more
    with the runtime lock witness armed (``lockwitness.install()``, which
    loads the derived order): no inversion, the observed edges and those
    the static order lacks, parity with the serial oracle, its K2 launch
    at the cold step held against ``cycle_wide_reference``, and its wall
    over the unwitnessed replay's (``lint_launches`` on the ``kernels``
    line);
20. (run before phase 10's lines) ``koordlet``: the node agent
    (``koordinator_tpu_torch/koordlet/``, ``native.py``, the runtime
    proxy): (a) the CUDA device enumeration (count 1, equal to the device
    line's, minor 0, memory used while the headline's tensors are
    resident), the ``DeviceCollector``'s stored memory and the
    ``DeviceReporter``'s one Device CR; (b) the native library built by
    ``g++`` (its seconds), ``read_files`` over the fleet's sysfs files equal
    to Python's reads, its delta codec on the fleet's 2,000 x 13 node rows
    with the ``incremental`` recipe's 64 changed rows byte-identical to
    ``bridge/state.py delta_encode`` (apply reproduces the next rows), and
    the CPI reading or the errno it is unavailable for; (c) 2,000 nodes'
    reports (``harness/koordlet_fleet.py``: a ``StatesInformer`` per node
    with ``NodeTopoReporter`` over a sysfs tree of its NUMA layout, one
    tree per shape, ``DeviceReporter`` over its GPU minors,
    ``NodeMetricReporter`` over seeded samples) build the extras snapshot
    at 10,000 pods x 2,000 nodes, its usage column equal to the
    scenario's, and ``FrameworkExtender.run_cycle`` on K2 exact against
    ``greedy_assign`` on the same tables, no demotion and no other kernel
    (the report pass, adapt plus encode and the cycle timed), and at the
    anchor recipe the card's digest against ``KOORDLET_ANCHOR_SHA256``;
    the trees, the hook socket and the daemon's node live under a
    memory-backed directory (``memory_backed_dir``: the temporary directory
    or ``/dev/shm`` when ``stat -f`` calls it ``tmpfs``), as a node's sysfs
    does, and the line records the filesystem type; ``/dev/shm`` is the one
    path outside the checkout, ``HOME`` and the temporary directory that
    the script writes, under a ``koord-smoke-<pid>-`` name, and each run
    first removes such directories whose process has ended;
    (d) every placed GPU pod that passed Reserve: its PreBind
    ``device-allocated`` annotation through PreCreateContainer in the CRI
    proxy (hooks in a koordlet process behind ``RemoteHookRegistry``), the
    docker proxy and NRI, ``NVIDIA_VISIBLE_DEVICES`` identical in the three
    and equal to the allocation's minors (ms per pod per mode); (e)
    ``build_default_daemon`` over a temporary root whose ``/proc`` and
    cgroup counters advance between 16 fake-clock ticks, the tree's digest
    against ``KOORDLET_QOS_SHA256`` and ``/metrics`` answering
    (``koordlet_launches`` on the ``kernels`` line);
21. (run before phase 10's lines) ``controlplane``: the co-location loop
    around the scheduler (``harness/controlplane.py ControlPlaneLoop``) at
    the headline (10,000 pods x 2,000 nodes, 16 tenants, seed 0): cycle A
    (the LS/prod pods, every 20th LSE); 2,000 nodes' NodeMetrics from
    ``NodeMetricReporter`` over seeded node, system and pod samples, each
    node's informer holding the pods cycle A put there (some unreported,
    some the pod list lacks); ``ManagerServer.reconcile_once`` (NodeMetric
    specs, batch resources equal to ``batch_allocatable_batch`` on every
    node with HP usage from the pod metrics, NodeSLOs, the profiles' root
    quotas); the BE pods mutated by the
    ClusterColocationProfile in process and 512 of them over HTTPS to
    ``/mutate-pod`` and ``/validate-pod`` (each patch applied equal to the
    in-process mutation; the certificate generator named; no openssl and
    no ``cryptography`` fails the line); ``transform_cluster`` and cycle B
    (the BE pods on the nodes' batch resources); one LowNodeLoad tick whose
    ``MigrationController`` runs ``ReservationFirst``: reservations through
    ``ReservationController``, cycle C placing the reserve pods off their
    source nodes, a second reconcile evicting (no eviction before its
    reservation is Available, evictions equal to the Succeeded jobs); then
    ``ManagerServer`` and ``DeschedulerServer`` on lease files, elected,
    one tick each, ``/healthz``, stopped with no thread left.  Each cycle
    runs ``run_cycle`` on the card with the launch counts set to 0 around
    it, exact against ``greedy_assign`` on the CPU (all five arrays), its
    rung named; each leg's seconds, and the line fails past its 45 s
    budget.  Then the sequential oracle (``harness/reference.py``): the
    spark example's ``score_cycle`` on the card against ``ReferenceCycle``
    (the reference's ``bench.py --config spark`` check) and the placements
    of phase 3's cases that ``schedule_batch`` covers, each ``run_cycle``
    counted (one launch, no demotion, exact against ``greedy_assign``) but
    not the loop's (``controlplane_launches`` on the ``kernels`` line).
22. (run before phase 10's lines) ``failover``: the reference's
    ``bench.py --config failover`` at the headline, every daemon a
    ``python -m koordinator_tpu_torch.scheduler.server`` process on the card
    (``harness/failover.py failover_leg``, sockets under the memory-backed
    directory, ``--kernel-build-dir`` the package's build directory): a
    journaled leader and a follower, the 3.04 MB full Sync and 8 delta
    Syncs (pairs that bump and restore one node's usage), a storm of 4
    threads of flat Scores (k = 8) on the follower; leg A SIGKILLs the
    leader and restarts it on its state directory (the journal replays onto
    the same chain), leg B SIGKILLs it again and promotes the follower with
    SIGUSR2.  ``warm_restart_ms`` and ``failover_ms`` with their splits
    (spawn to imports, CUDA context, journal replay, server start, first
    acknowledged Sync; kill to reaped, signal to promoted), the journal's
    replay and append times, the follower's resyncs and the storm's reads.
    After each recovery two Assigns, a no-change Sync between them: both
    equal phase 4's ``run_cycle(snap)`` in all five arrays (each daemon's
    ``/debug/last-cycle`` digests) and the second builds nothing, demotes
    nothing and launches K2 once (the daemons' own launch counts, on the
    ``kernels`` line as ``failover_launches``); no process is left, and the
    line fails past its 60 s budget;
23. (run before phase 10's lines) ``coldstart``: the reference's
    ``bench.py --config coldstart`` at the headline: two daemon processes
    on one state directory and one new kernel build directory under the
    package's ``_build/``, the first with nothing built and no prewarm
    record, the second with ``--prewarm`` replaying what the first recorded;
    spawn to the first served flat Score and to the first served Assign
    (where K2's ``nvcc`` build sits) of each, the second's prewarm status,
    the Score and Assign reply digests equal between the boots; then the
    two boots fail past their 60 s budget; then, as the ``controlplane``
    line's oracle after its budget, the serial and the pipelined cold
    candidate builds at the ``sparse`` line's scale point (2^21 nodes x 512
    pods, width 256), byte-equal (``coldstart_launches``);
24. ``mesh``: the multi-device path (``parallel/``) on an in-process mesh
    of 4 shards on the one card (``cluster_mesh([cuda:0] * 4)``, recorded
    as virtual with its distinct device count): (a)
    ``greedy_assign_waves(snap, mesh, wave=32, top_m=4)`` at the headline,
    all five arrays equal to phase 4's K2 ``run_cycle(snap)``, its rounds
    beside the wave headline's K3 rounds, its time (CUDA events, host
    wall), its host reads per round and the host split of its round loop
    (prep, key passes, gather and merge, resolve, apply, host read); (b)
    ``greedy_assign_sharded(snap, mesh)`` equal to the same arrays; (c) a
    mesh-resident ``ScorerServicer`` against a single-device one over the
    same requests, every reply byte-equal (timing fields aside): the full
    Sync, 8 delta Syncs (64 node rows, 16 pod rows each; every shard's
    digest before and after, only the owning node shards and every pod
    replica moving), a flat Score with k = 32 cold and incremental, one
    Assign (path ``shard``, no kernel launched), each shard's resident
    bytes, under ``retrace_guard(budget=0)``, no shard demotion; (d) the
    sparse candidate build, refresh and Score on a 4-shard pod mesh at
    2^21 nodes x 512 pods, width 256, byte-equal to the single-device
    engine.  The line fails past its 90 s budget; its launches are
    ``mesh_launches`` on the ``kernels`` line (the single-device servicer's
    Assigns on K2).

Imports nothing of JAX and nothing of the JAX package.  Needs one CUDA card
and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
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
        kernel_demotions, masked_top_k, run_cycle, score_cycle, score_upper_bound,
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
        reset_counts()
        first, ev, wall = rpc_timed(lambda: cli.call(
            METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sync.snapshot_id), wire.AssignReply))
        launches = kernel_counts()
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
        warm_launches = dict.fromkeys(kernel_counts(), 0)
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
            reset_counts()
            reply, ev, wall = rpc_timed(lambda: cli.call(
                METHOD_ASSIGN, wire.AssignRequest(snapshot_id=s2.snapshot_id),
                wire.AssignReply))
            assign_rpc.append((ev, wall))
            assign_split.append(dict(cli.split))
            for kernel, n in kernel_counts().items():
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
        reset_counts()
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
        cold_launches = kernel_counts()
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
        reset_counts()
        reply, ev, wall = rpc_timed(lambda: cli_w.call(
            METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sw.snapshot_id), wire.AssignReply))
        k3 = kernel_counts()
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
        reset_counts()
        reply, ev, wall = rpc_timed(lambda: cli_x.call(
            METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sx.snapshot_id), wire.AssignReply))
        k1 = kernel_counts()
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
    # the multi-device path: the mesh-resident servicer's
    "solver.resident._scatter_flat_sharded": "sync",
    "solver.greedy.score_cycle_sharded": "score", "solver.incremental._rescore_sharded": "score",
    "solver.candidates._build_sharded": "score", "solver.candidates._count_blocks_sharded": "score",
    "solver.candidates._refresh_sharded": "score", "solver.candidates._score_sharded": "score",
    "parallel.shard_assign._assign_waves": "assign",
    "parallel.shard_assign._assign_sharded": "assign",
    "parallel.shard_assign._cycle_operands": "assign",
}


class K2Tap:
    """Holds K2 against its plain version on a replay's own launches.

    Inside ``with``, ``wide.cycle_wide_cuda`` is wrapped: each launch
    numbered in ``keep`` (0-based, in launch order from entry) keeps a
    device copy of its inputs and outputs, made on the launch's stream, so
    the replay never waits for it.  ``check`` then runs
    ``cycle_wide_reference`` on the CPU on each kept launch's inputs and
    fails on any difference in its four outputs."""

    KERNEL, LAUNCH, PLAIN = "K2", "cycle_wide_cuda", "cycle_wide_reference"
    FIELDS = ("chosen", "nreq", "nest", "quse")

    def __init__(self, keep):
        self.keep = frozenset(keep)
        self.records = {}
        self.seen = 0

    def __enter__(self):
        from koordinator_tpu_torch.solver import wide

        self._wide, self._launch = wide, getattr(wide, self.LAUNCH)

        def tapped(inp, cfg, *args, **kwargs):
            i, self.seen = self.seen, self.seen + 1
            if i not in self.keep:
                return self._launch(inp, cfg, *args, **kwargs)
            held = tensors_to(inp, lambda t: t.clone())
            outs = self._launch(inp, cfg, *args, **kwargs)
            self.records[i] = (held, cfg, args, tuple(o.clone() for o in outs))
            return outs

        setattr(wide, self.LAUNCH, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self._wide, self.LAUNCH, self._launch)
        return False

    def check(self, name):
        import torch

        k = self.KERNEL
        if set(self.records) != self.keep:
            raise AssertionError(f"trace {name}: {k} launches "
                                 f"{sorted(self.keep - set(self.records))} of "
                                 f"{sorted(self.keep)} never ran ({self.seen} launches)")
        plain = getattr(self._wide, self.PLAIN)
        t0 = time.perf_counter()
        err = 0
        for i, (inp, cfg, args, outs) in sorted(self.records.items()):
            want = plain(tensors_to(inp, lambda t: t.cpu()), cfg, *args)
            got = tuple(o.cpu() for o in outs)
            if len(got) != len(self.FIELDS) or len(want) != len(self.FIELDS):
                raise AssertionError(f"trace {name}: {k} launch {i} gave {len(got)} outputs, "
                                     f"plain {len(want)}, want {len(self.FIELDS)}")
            for field, a, b in zip(self.FIELDS, got, want):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise AssertionError(f"trace {name}: {k} launch {i} {field} is "
                                         f"{a.dtype}{list(a.shape)}, plain {b.dtype}{list(b.shape)}")
            err = max(err, max_abs_err(got, want))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"trace {name}: {k} launch {i} differs from its plain "
                                     f"version (max abs err {max_abs_err(got, want)})")
        return {"launches_held": sorted(self.keep), "of_launches": self.seen,
                "plain": f"{self.PLAIN} on the CPU", "max_abs_err": err,
                "plain_s": time.perf_counter() - t0}


class K3Tap(K2Tap):
    """``K2Tap`` for K3: ``wide.wave_cycle_cuda`` held against
    ``wave_cycle_reference`` on its five outputs, the round count among
    them."""

    KERNEL, LAUNCH, PLAIN = "K3", "wave_cycle_cuda", "wave_cycle_reference"
    FIELDS = ("chosen", "nreq", "nest", "quse", "rounds")


@contextlib.contextmanager
def counting(module, name):
    """Inside ``with``, ``module.<name>`` counts its calls in the yielded
    one-element list."""
    fn, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


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

    from koordinator_tpu_torch.bridge.server import ScorerServicer
    from koordinator_tpu_torch.bridge.udsserver import METHOD_PROFILE, RawUdsServer
    from koordinator_tpu_torch import solver
    from koordinator_tpu_torch.harness.anchor import (
        TRACE_ANCHOR_CFG, TRACE_ANCHOR_SHA256, TRACE_HEADLINE_CFG, TRACE_HEADLINE_SHA256,
        TRACE_TERMS_CFG, TRACE_TERMS_SHA256,
    )
    from koordinator_tpu_torch.harness.trace import (
        TERM_MIX, TraceConfig, TraceReplay, default_slo_specs, generate_trace,
        tensor_sync_events,
    )
    from koordinator_tpu_torch.obs import devprof
    from koordinator_tpu_torch.obs.assemble import assemble
    from koordinator_tpu_torch.obs.scorer_metrics import SYNC_TOTAL, TRACE_CYCLE
    from koordinator_tpu_torch.obs.slo import evaluate_slos, slos_pass
    from koordinator_tpu_torch.solver import kernel_demotions
    from koordinator_tpu_torch.solver.terms import default_term_config

    line = {"card": card, "transport": "raw UDS through ScorerClient('raw://...')"}
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

    def held(name, trace, steps, tap=K2Tap, **kw):
        """A replay (warm-up and oracle on: one engine and one oracle
        Assign a step, each one launch of the kernel ``tap`` holds) whose
        engine launches of the measured pass at ``steps`` (0 = the cold
        step) are held against the plain version."""
        first = 2 * (len(trace.events) + 1)  # the warm-up pass's launches
        with tap(first + 2 * s for s in steps) as tapped:
            report = TraceReplay(trace, **kw).run()
        return report, tapped.check(name)

    # 1. the reference's accelerator trace, raw transport
    trace = generate_trace(TraceConfig(**TRACE_ANCHOR_CFG))
    if trace.digest() != TRACE_ANCHOR_SHA256:
        raise AssertionError(f"trace digest {trace.digest()} != {TRACE_ANCHOR_SHA256}")
    line["trace"] = {**TRACE_ANCHOR_CFG, "digest": trace.digest(), "top_k": 8,
                     "cycle_config": "default"}
    reset_counts()
    report, k2_plain = held("main", trace, range(0, len(trace.events) + 1, 8), transport="raw")
    launches = kernel_counts()
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
    # the launch boundaries; the stage rows beside them are the servicer's stages
    launches = {n: b for n, b in summary["boundaries"].items() if b.get("kind") != "stage"}
    top = sorted(((n, b) for n, b in launches.items() if b["sampled"]),
                 key=lambda nb: -nb[1]["device_us_total"])
    unmapped = sorted(set(launches) - set(BOUNDARY_RPC))
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
    reset_counts()
    big_report, big_plain = held("headline", big, (0, len(big.events) // 2, len(big.events)),
                                 transport="raw")
    big_line = checked("headline", big, big_report)
    big_line.update(launches=kernel_counts(), k2_vs_plain=big_plain)
    if big_line["launches"]["cycle_wide"] != 2 * 2 * (len(big.events) + 1):
        raise AssertionError(f"trace headline: launches {big_line['launches']}")
    line["headline"] = {**TRACE_HEADLINE_CFG, "digest": big.digest(), **big_line}

    # 7. the fused terms under traffic: the accelerator trace drawn with the
    # term events, its Assigns on K2 (``terms``), then on K3 (``terms_wave``)
    term_trace = generate_trace(TraceConfig(**TRACE_TERMS_CFG, mix=TERM_MIX))
    if term_trace.digest() != TRACE_TERMS_SHA256:
        raise AssertionError(f"term trace digest {term_trace.digest()} != {TRACE_TERMS_SHA256}")
    steps = len(term_trace.events) + 1
    want = 2 * 2 * steps  # two passes, engine and oracle, one launch an Assign
    traced = {"cycle_wide": launches["cycle_wide"], "wave_cycle": 0}
    t_terms = time.perf_counter()
    for name, cfg, kernel, tap in (
        ("terms", default_term_config(), "cycle_wide", K2Tap),
        ("terms_wave", dataclasses.replace(default_term_config(), **WAVE_CFG), "wave_cycle",
         K3Tap),
    ):
        reset_counts()
        with counting(solver, "term_extras") as extras_calls:
            report, plain = held(name, term_trace, (0, steps - 1), tap=tap,
                                 transport="raw", engine_kw={"cfg": cfg})
        counts = kernel_counts()
        if counts != {k: want if k == kernel else 0 for k in counts}:
            raise AssertionError(f"trace {name}: Assigns launched {counts}, want {want} of "
                                 f"{kernel} alone")
        if extras_calls[0] != want:
            raise AssertionError(f"trace {name}: term_extras ran {extras_calls[0]} times, "
                                 f"want one an Assign ({want})")
        term_line = checked(name, term_trace, report)
        term_line.update(
            digest=term_trace.digest(), launches=counts, term_extras_launches=extras_calls[0],
            launches_note=(f"2 passes (warm-up, measured) x {steps} steps x 2 servicers, one "
                           f"{tap.KERNEL} launch and one term_extras per Assign"),
            **{f"{tap.KERNEL.lower()}_vs_plain": plain})
        line[name] = {**TRACE_TERMS_CFG, "mix": "TERM_MIX",
                      "cycle_config": ("default_term_config()" if kernel == "cycle_wide" else
                                       "default_term_config(), wave=32, top_m=4"),
                      **term_line}
        traced[kernel] += want
    line["terms_seconds"] = time.perf_counter() - t_terms
    return line, traced


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
    """The ``extras`` line (phase 13), the kernels' launches on it, and
    what the ``preempt`` line reads of it: (snapshot, tables, node list,
    pod list, the K2 cycle's result)."""
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
    from koordinator_tpu_torch.solver import greedy_assign, run_cycle

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
    cpu_rows_s = extras_rows_on_cpu("extras", snap, tables, mask, scores)

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
    snap_cpu = map_snapshot(snap, lambda t: t.cpu())
    tables_cpu = (zones.to("cpu"), policy, devices.to("cpu"), rsv.to("cpu"))
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
    return line, launches, (snap, tables, nodes, pods, result)


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


def client_sync_kwargs(lists):
    """``ScorerClient.sync`` keywords for the cluster ``lists`` (nodes, pods,
    gangs, quotas): the tensors and columns of
    ``harness/golden.build_sync_request``'s full Sync, decoded back."""
    from koordinator_tpu_torch.bridge.state import tensor_to_numpy
    from koordinator_tpu_torch.harness.golden import build_sync_request

    node_list, pod_list, gangs, quotas = lists
    P, N = len(pod_list), len(node_list)
    req, _ = build_sync_request(node_list, pod_list, gangs, quotas,
                                node_bucket=N, pod_bucket=P)

    def arr(t):
        return tensor_to_numpy(t, None)

    return dict(
        node_allocatable=arr(req.nodes.allocatable), node_requested=arr(req.nodes.requested),
        node_usage=arr(req.nodes.usage), node_names=list(req.nodes.names),
        metric_fresh=list(req.nodes.metric_fresh), pod_requests=arr(req.pods.requests),
        pod_estimated=arr(req.pods.estimated), pod_names=list(req.pods.names),
        priority=list(req.pods.priority), gang_id=list(req.pods.gang_id),
        quota_id=list(req.pods.quota_id), gang_min_member=list(req.gangs.min_member),
        quota_runtime=arr(req.quotas.runtime), quota_used=arr(req.quotas.used),
        quota_limited=arr(req.quotas.limited), node_bucket=N, pod_bucket=P,
    )


def daemon_deltas(kw, count, seed):
    """``count`` successive Sync keywords, each changing 64 node rows
    (requested and usage of cpu and memory) and 16 pod rows (cpu request):
    the ``incremental`` phase's recipe, its probe rows shifted by one per
    delta.  The keywords carry the three changed tensors only, so each
    frame is O(changed): names and columns the client sent once are not
    sent again.  Yields (keywords, [(field, rows, cols, values)])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, p = kw["node_allocatable"].shape[0], kw["pod_requests"].shape[0]
    probe = np.unique((np.arange(64) * max(1, n // 64)) % n)
    alloc = kw["node_allocatable"]
    cur = dict(kw)
    for i in range(count):
        rows = (probe + i) % n
        changes = []
        for field, frac in (("node_requested", 0.5), ("node_usage", 0.9)):
            a = cur[field].copy()
            for c in (0, 1):
                a[rows, c] = (alloc[rows, c] * rng.uniform(0, frac, len(rows))).astype(np.int64)
            changes.append((field, rows, (0, 1), a[rows][:, :2].copy()))
            cur[field] = a
        pod_rows = np.sort(rng.choice(p, size=16, replace=False))
        a = cur["pod_requests"].copy()
        a[pod_rows, 0] = rng.choice([250, 1000, 8000], len(pod_rows))
        changes.append(("pod_requests", pod_rows, (0,), a[pod_rows][:, :1].copy()))
        cur["pod_requests"] = a
        yield {k: cur[k] for k in ("node_requested", "node_usage", "pod_requests")}, changes


def wait_for(name, predicate, timeout_s=120.0):
    """Seconds until ``predicate()`` held; fails the run past ``timeout_s``."""
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"daemon: {name} did not happen within {timeout_s} s")
        time.sleep(0.0005)
    return time.perf_counter() - t0


def daemon_phase(card, dev, lists, headline, snap):
    """The ``daemon`` line (phase 15): the koord-scheduler daemon and its
    follower at the headline, through the entry points a deployment uses
    (``scheduler/server.py SchedulerServer``, ``bridge/client.py
    ScorerClient``), each check exact.  Returns (line, K2 launches)."""
    import json as _json
    import os
    import tempfile
    import urllib.request

    import torch

    from koordinator_tpu_torch.analysis.retrace_guard import retrace_guard
    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.bridge.client import ScorerClient, parse_snapshot_id
    from koordinator_tpu_torch.obs import prewarm
    from koordinator_tpu_torch.bridge.udsserver import (
        METHOD_ASSIGN, METHOD_PROFILE, METHOD_SCORE, METHOD_SYNC,
    )
    from koordinator_tpu_torch.harness.failover import raw_call
    from koordinator_tpu_torch.replication import codec
    from koordinator_tpu_torch.replication.follower import promote_replica
    from koordinator_tpu_torch.scheduler.server import SchedulerServer
    from koordinator_tpu_torch.solver import dense, run_cycle, wide

    P, N = len(lists[1]), len(lists[0])
    K = 32
    try:
        import grpc  # noqa: F401
        grpc_ok = True
    except ImportError:
        grpc_ok = False
    print(f"daemon: grpc importable: {grpc_ok}")
    tmp = tempfile.mkdtemp(prefix="kd")
    line = {"snapshot": f"quota_colocation {P} pods x {N} nodes, 16 tenants, seed 0",
            "grpc_importable": grpc_ok, "card": card}
    exact = {}
    servers = []

    def uncounted(fn):
        """``fn()`` (an in-process comparison) without touching the counts."""
        torch.cuda.synchronize()
        saved_dense, saved_wide = dense.LAUNCHES, dict(wide.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        dense.LAUNCHES = saved_dense
        wide.LAUNCHES.update(saved_wide)
        return out

    def start(name, **kw):
        srv = SchedulerServer(
            lease_path=os.path.join(tmp, f"{name}.lease"), identity=name,
            uds_path=os.path.join(tmp, f"{name}.sock"), state_dir=os.path.join(tmp, name),
            http_port=0, enable_grpc=grpc_ok, device=dev, **kw).start()
        servers.append(srv)
        return srv

    def stop(srv):
        srv.stop()
        servers.remove(srv)

    def health(srv):
        out = {}
        for path in ("/healthz", "/metrics"):
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.http_port}{path}",
                                        timeout=60) as r:
                if r.status != 200:
                    raise AssertionError(f"daemon: {path} answered {r.status}")
                out[path] = r.read()
        doc = _json.loads(out["/healthz"])
        missing = {"replica", "prewarm", "device"} - set(doc)
        if missing or b"koord_scorer_" not in out["/metrics"]:
            raise AssertionError(f"daemon: healthz lacks {missing} or /metrics is empty")
        return doc

    def score_bytes(path, sid):
        status, body = raw_call(path, METHOD_SCORE, wire.ScoreRequest(
            snapshot_id=sid, top_k=K, flat=True).SerializeToString())
        if status != 0:
            raise AssertionError(f"daemon: Score on {path}: {body.decode()}")
        reply = wire.ScoreReply.FromString(body)
        reply.build_ms = 0.0
        return reply.SerializeToString()

    def placements(reply):
        return list(reply[0]), list(reply[1])

    def same(name, got, want_result):
        ok = (got[0] == want_result.assignment[:P].cpu().tolist()
              and got[1] == want_result.status[:P].cpu().tolist())
        exact[name] = ok
        if not ok:
            raise AssertionError(f"daemon: {name} differs")

    kw = client_sync_kwargs(lists)
    cur = map_snapshot(snap, lambda t: t.clone())
    cli = None
    try:
        reset_counts()
        leader = start("leader", journal=True, prewarm=True)
        wait_for("the leader's election", lambda: leader.elector.is_leader)
        cli = ScorerClient(f"raw://{leader.uds_path}.raw",
                           followers=[f"raw://{tmp}/follower.sock.raw"])
        # 1. the full Sync, then the follower subscribes: its stream opens
        # with the full frame
        t0 = time.perf_counter()
        full_sid = cli.sync(**kw).snapshot_id
        full_sync_ms = (time.perf_counter() - t0) * 1e3
        epoch, gen, payload = leader.servicer.export_replication_snapshot()
        follower = start("follower", replicate_from=leader.repl_path)
        full_s = wait_for("the full frame", lambda: follower.servicer.snapshot_id() == full_sid)
        line["full_frame"] = {
            "raw_bytes": len(payload), "zlib_bytes": len(codec.compress_payload(payload)),
            "replication_ms": full_s * 1e3,
            "note": "follower start to its snapshot id equal to the leader's, "
                    "the subscription included",
            "client_full_sync_ms": full_sync_ms,
        }
        # the first Assign is phase 4's run_cycle on the headline snapshot
        first = placements(cli.assign())
        same("first_assign_vs_phase4_run_cycle", first, headline)
        # 2. eight delta Syncs, each replicated before the next
        lags, waits, frames = [], [], []
        for step_kw, changes in daemon_deltas(kw, 8, seed=8):
            journal_before = leader.journal.stats()["bytes"]
            sid = cli.sync(**step_kw).snapshot_id
            ack = time.perf_counter()
            wait_for("a delta frame", lambda: follower.servicer.snapshot_id() == sid)
            waits.append((time.perf_counter() - ack) * 1e3)
            frames.append(leader.journal.stats()["bytes"] - journal_before)
            lags.append(follower.applier.last_lag_ms)
            for field, rows, cols, values in changes:
                tensor = {"node_requested": cur.nodes.requested,
                          "node_usage": cur.nodes.usage,
                          "pod_requests": cur.pods.requests}[field]
                for j, c in enumerate(cols):
                    tensor[torch.as_tensor(rows, device=dev), c] = torch.as_tensor(
                        values[:, j], device=dev, dtype=tensor.dtype)
        if leader.servicer.state.last_sync_path != "warm":
            raise AssertionError("daemon: the delta Syncs did not land warm")
        # the same cluster with every keyword again (names and columns too,
        # as a client that re-sends its whole view would): no tensor moves,
        # but the frame carries the names
        journal_before = leader.journal.stats()["bytes"]
        sid = cli.sync(**dict(kw, **step_kw)).snapshot_id
        ack = time.perf_counter()
        wait_for("the re-sent view", lambda: follower.servicer.snapshot_id() == sid)
        resent = {"journal_record_bytes": leader.journal.stats()["bytes"] - journal_before,
                  "replication_lag_ms": follower.applier.last_lag_ms,
                  "ack_to_follower_ms": (time.perf_counter() - ack) * 1e3}
        line["deltas"] = {
            "syncs": 8, "node_rows": 64, "pod_rows": 16, "seed": 8,
            "replication_lag_ms_p50": statistics.median(lags),
            "replication_lag_ms_max": max(lags),
            "lag": "leader commit stamp to follower apply (ReplicaApplier.last_lag_ms)",
            "ack_to_follower_ms_p50": statistics.median(waits),
            "ack_to_follower_ms_max": max(waits),
            "journal_record_bytes": frames,
            "resent_view": resent,
        }
        # 3. Score k = 32 on the follower and on the leader
        f_score = score_bytes(f"{tmp}/follower.sock.raw", sid)
        l_score = score_bytes(f"{leader.uds_path}.raw", sid)
        exact["follower_score_bytes_vs_leader"] = f_score == l_score
        if f_score != l_score:
            raise AssertionError("daemon: the follower's Score reply differs from the leader's")
        routed = cli.score_flat(top_k=K)
        if len(routed[0]) != P:
            raise AssertionError(f"daemon: the routed Score covered {len(routed[0])} pods")
        # the follower refuses a Sync with the one-writer text
        status, body = raw_call(f"{tmp}/follower.sock.raw", METHOD_SYNC,
                                wire.SyncRequest().SerializeToString())
        exact["follower_refuses_sync"] = status == 1 and b"one writer" in body
        if not exact["follower_refuses_sync"]:
            raise AssertionError(f"daemon: the follower answered a Sync with {status} {body!r}")
        # 4. the Assign on the leader, against run_cycle on the same snapshot
        assign = placements(cli.assign())
        want = uncounted(lambda: run_cycle(cur))
        same("assign_vs_in_process_run_cycle", assign, want)
        # the measured Assigns: a no-change Sync (a new generation) then an
        # Assign, no kernel build and no demotion
        def ip_cycle():
            r = run_cycle(cur)
            return r.assignment.cpu(), r.status.cpu()

        rpc, ip = [], []
        with retrace_guard(budget=0) as guard:
            for _ in range(TIMED_RUNS):
                cli.sync()
                got, ev, wall = rpc_timed(cli.assign)
                rpc.append((ev, wall))
                if placements(got) != assign:
                    raise AssertionError("daemon: a measured Assign differs")
            for _ in range(TIMED_RUNS):
                ip.append(uncounted(lambda: rpc_timed(ip_cycle))[1:])
        line["assign"] = {**seam_cost(rpc, ip), "measured_builds": guard.compiles,
                          "measured_demotions": guard.traces}
        if guard.compiles or guard.traces:
            raise AssertionError(f"daemon: {guard.compiles} builds, {guard.traces} "
                                 "demotions during the measured Assigns")
        docs = {"leader": health(leader), "follower": health(follower)}
        line["healthz"] = {
            "leader_role": docs["leader"]["replica"]["role"],
            "follower_role": docs["follower"]["replica"]["role"],
            "follower_applied_frames": docs["follower"]["replica"]["applied_frames"],
            "device_platform": docs["leader"]["device"]["platform"],
        }
        if (line["healthz"]["leader_role"], line["healthz"]["follower_role"]) != (
                "leader", "follower") or line["healthz"]["device_platform"] != "cuda":
            raise AssertionError(f"daemon: healthz {line['healthz']}")
        # Profile (admin method 5) on the live leader
        status, body = raw_call(f"{leader.uds_path}.raw", METHOD_PROFILE, b"200")
        capture = body.decode()
        if status != 0 or not capture.startswith(leader.state_dir):
            raise AssertionError(f"daemon: Profile answered {status} {capture!r}")
        wait_for("the profile capture",
                 lambda: os.path.exists(os.path.join(capture, "trace.json")), 120)
        line["profile_capture"] = os.path.relpath(capture, tmp)
        # warm restart on the same state dir: the journal replays
        sid = cli.snapshot_id
        last = assign
        stop(leader)
        journal_bytes = os.path.getsize(os.path.join(tmp, "leader", "journal.krj"))
        leader = start("leader", journal=True, prewarm=True)
        replay = leader.journal_replay
        exact["warm_restart_same_snapshot_id"] = (
            replay["resumed_id"] == sid == leader.servicer.snapshot_id())
        if not exact["warm_restart_same_snapshot_id"]:
            raise AssertionError(f"daemon: the restart resumed {replay['resumed_id']}, "
                                 f"not {sid}")
        wait_for("the restarted leader's election", lambda: leader.elector.is_leader)
        status, body = raw_call(f"{leader.uds_path}.raw", METHOD_ASSIGN,
                                wire.AssignRequest(snapshot_id=sid).SerializeToString())
        reply = wire.AssignReply.FromString(body) if status == 0 else None
        exact["warm_restart_same_assign"] = reply is not None and placements(
            (reply.assignment, reply.status)) == last
        if not exact["warm_restart_same_assign"]:
            raise AssertionError("daemon: the restarted leader's Assign differs")
        if not leader._prewarm_runner.wait(300):
            raise AssertionError("daemon: the prewarm did not finish")
        pw = leader._prewarm_runner.stats()
        record = [r["source"] for r in prewarm.load(leader.state_dir)]
        if (pw["failed"] or pw["compiled"] != pw["total"] or pw["total"] < 1
                or "solver/cycle_cuda.cu" not in record):
            raise AssertionError(f"daemon: prewarm {pw}, record {record}, "
                                 f"failures {leader._prewarm_runner.failures}")
        line["journal"] = {"bytes": journal_bytes,
                           "replayed_frames": replay["replayed_frames"],
                           "replay_ms": replay["replay_ms"]}
        line["prewarm"] = {"variants": pw["total"], "built": pw["compiled"],
                           "failed": pw["failed"], "build_ms": pw["compile_ms_total"],
                           "elapsed_ms": pw["elapsed_ms"],
                           "note": "variants this process had loaded, so each build "
                                   "is a cache hit in the process"}
        # failover: stop the leader, promote the follower over its admin
        # socket, and the client's next Sync finds it
        stop(leader)
        t0 = time.perf_counter()
        new_sid = promote_replica(f"{tmp}/follower.sock.raw", timeout_s=120)
        reply = cli.sync()
        promote_ms = (time.perf_counter() - t0) * 1e3
        e_new, g_new = parse_snapshot_id(new_sid)
        e_got, g_got = parse_snapshot_id(reply.snapshot_id)
        # on the promoted epoch: the client's delta, then its one full
        # resync on the epoch fence
        exact["client_found_the_promoted_leader"] = e_got == e_new and g_got == g_new + 2
        if not exact["client_found_the_promoted_leader"]:
            raise AssertionError(f"daemon: after promotion to {new_sid} the client's Sync "
                                 f"acked {reply.snapshot_id}")
        after = placements(cli.assign())
        exact["assign_after_failover"] = after == last
        if after != last:
            raise AssertionError("daemon: the Assign after failover differs")
        line["failover"] = {"promote_to_first_acked_sync_ms": promote_ms,
                            "syncs_on_new_leader": "the delta, then one full resync"}
        torch.cuda.synchronize()
        launches = kernel_counts()
    finally:
        if cli is not None:
            cli.close()
        for srv in list(servers):
            srv.stop()
    line["launches"] = launches
    line["exact"] = exact
    return line, only_k2("daemon: the Assigns", launches)


# ---------------------------------------------------------------------------
# phases 16-18: the chaos x trace gate, the relay tree, the PostFilter
# ---------------------------------------------------------------------------


def kernel_counts():
    """Each kernel's launches since the counts were last set to 0."""
    from koordinator_tpu_torch.solver import dense, wide

    return {"cycle_dense": dense.LAUNCHES, **wide.LAUNCHES}


def reset_counts():
    """Every launch count set to 0, the device idle first."""
    import torch

    from koordinator_tpu_torch.solver import dense, wide

    torch.cuda.synchronize()
    dense.reset_launches()
    wide.reset_launches()


def only_k2(name, launches):
    """Fail unless ``launches`` holds K2 launches and nothing else, with no
    ladder demotion."""
    from koordinator_tpu_torch.solver import kernel_demotions

    if (launches["cycle_wide"] < 1 or launches["cycle_dense"] or launches["wave_cycle"]
            or kernel_demotions()):
        raise AssertionError(f"{name}: launched {launches}, demotions {kernel_demotions()}")
    return launches["cycle_wide"]


def chaos_schedule(events):
    """The reference bench's fault schedule for a chaos replay of
    ``events`` events: the launch poison at a quarter, the leader kill at
    two thirds."""
    fail_at = max(1, events // 4)
    return fail_at, max(fail_at + 4, (2 * events) // 3)


def histogram_latency(registry):
    """p50 and p99 in ms of each RPC of a chaos replay, estimated from the
    trace-cycle histogram as the SLO gate estimates them."""
    from koordinator_tpu_torch.obs.scorer_metrics import TRACE_CYCLE
    from koordinator_tpu_torch.obs.slo import histogram_quantile

    return {rpc: {q: histogram_quantile(registry, TRACE_CYCLE, v, {"rpc": rpc})
                  for q, v in (("p50", 0.5), ("p99", 0.99))}
            for rpc in ("sync", "score", "assign", "cycle", "recovery")}


def sync_messages(req, count, seed):
    """``count`` O(changed) delta Syncs after the full Sync ``req``: the
    ``incremental`` recipe of ``daemon_deltas`` (64 node rows of requested
    and usage, 16 pod rows of cpu request a delta), each field encoded
    against its previous value."""
    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.bridge.state import numpy_to_tensor, tensor_to_numpy

    kw = {"node_allocatable": tensor_to_numpy(req.nodes.allocatable, None),
          "node_requested": tensor_to_numpy(req.nodes.requested, None),
          "node_usage": tensor_to_numpy(req.nodes.usage, None),
          "pod_requests": tensor_to_numpy(req.pods.requests, None)}
    where = {"node_requested": ("nodes", "requested"), "node_usage": ("nodes", "usage"),
             "pod_requests": ("pods", "requests")}
    prev = dict(kw)
    out = []
    for step_kw, _ in daemon_deltas(kw, count, seed):
        msg = wire.SyncRequest()
        for field, (part, attr) in where.items():
            getattr(getattr(msg, part), attr).CopyFrom(numpy_to_tensor(step_kw[field],
                                                                       prev[field]))
            prev[field] = step_kw[field]
        out.append(msg)
    return out


# the ChaosTier leg of the ``chaos`` line at the headline: its fault mix
# (each fault likely enough that all four fire on ~35 frames), the seed of
# its channels, its Syncs (one full, then CHAOS_TIER_DELTAS deltas, each
# followed by a convergence check, as the reference's acceptance run does:
# a follower promoted behind the leader would serve a lost write) and the
# steps of its faults.  Byte corruption has its own leg
# (CHAOS_CORRUPT_FRAMES): a replication frame carries no checksum, in the
# reference too, so a flipped payload byte can apply silently (ROADMAP
# Queue C) and no parity can be asserted under it.
CHAOS_TIER_PLAN = {"drop": 0.2, "duplicate": 0.2, "reorder": 0.2, "truncate": 0.2}
CHAOS_CORRUPT_FRAMES = 8
CHAOS_TIER_SEED = 0
CHAOS_TIER_DELTAS = 16
CHAOS_TIER_STEPS = {"crash_restart": 4, "crash_damage_restart": 8, "crash_promote": 12}


def chaos_replay(dev, name, cfg, want_digest, tap_steps):
    """One ChaosTraceReplay over the raw framing: the reference bench's
    checks, then its numbers; the engine's K2 launches at ``tap_steps`` of
    the chaos pass (0 = its cold step) held against the plain version."""
    import os
    import tempfile

    from koordinator_tpu_torch.harness.chaos import ChaosTraceReplay, chaos_trace_slo_specs
    from koordinator_tpu_torch.harness.trace import TraceConfig, generate_trace
    from koordinator_tpu_torch.obs import slo as slo_mod
    from koordinator_tpu_torch.obs.assemble import assemble

    trace = generate_trace(TraceConfig(**cfg))
    if trace.digest() != want_digest:
        raise AssertionError(f"chaos {name}: trace digest {trace.digest()}")
    events = len(trace.events)
    fail_at, kill_at = chaos_schedule(events)
    tmp = tempfile.mkdtemp(prefix="kc")
    export = os.path.join(tmp, "spans")
    # the warm-up pass: one engine and one oracle Assign a step; the
    # chaos pass then opens with the engine's and the oracle's cold
    # Assigns, and each event's engine Assign follows
    first = 2 * (events + 1)
    keep = [first + (0 if s == 0 else s + 1) for s in tap_steps]
    t0 = time.perf_counter()
    with K2Tap(keep) as tap:
        report = ChaosTraceReplay(trace, tmp, fail_at=fail_at, fail_n=4, kill_at=kill_at,
                                  trace_export=export, device=dev).run()
    wall_s = time.perf_counter() - t0
    assembly = assemble([export])
    checks = {
        "parity_ok": report.parity_ok,
        "no_build_after_recovery": report.builds == 0,
        "no_demotion_after_recovery": report.retraces == 0,
        "recovery_measured": report.recovery_ms is not None,
        "breaker_tripped": report.breaker_trips > 0,
        "degraded_replies": report.degraded_replies > 0,
        "traces_assembled": len(assembly.traces) > 0,
        "no_client_orphan_span": not assembly.client_orphans,
        "dead_leader_collected": report.dead_leader_collected is True,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"chaos {name}: {failed} ({report.parity_detail})")
    verdicts = slo_mod.evaluate_slos(report.registry, chaos_trace_slo_specs(report.bands))
    return {**cfg, "digest": trace.digest(), "fail_at": fail_at, "fail_n": 4,
            "kill_at": kill_at, "recovery_ms": report.recovery_ms,
            "rpc_errors": report.rpc_errors, "degraded_replies": report.degraded_replies,
            "breaker_trips": report.breaker_trips, "shed_by_band": report.shed_by_band,
            "builds_after_recovery": report.builds,
            "demotions_after_recovery": report.retraces,
            "traces_assembled": len(assembly.traces),
            "client_orphan_spans": len(assembly.client_orphans),
            "latency_ms": histogram_latency(report.registry),
            "slo": [v.to_doc() for v in verdicts], "slo_pass": slo_mod.slos_pass(verdicts),
            "checks": checks, "k2_vs_plain": tap.check(f"chaos {name}"), "wall_s": wall_s}


def chaos_phase(card, dev, lists):
    """The ``chaos`` line (phase 16): the chaos x trace gate over the raw
    framing at the reference's accelerator size and at the headline, then
    ``ChaosTier`` at the headline.  Returns (line, K2 launches)."""
    import tempfile

    import torch

    from koordinator_tpu_torch.harness.anchor import (
        CHAOS_ANCHOR_CFG, CHAOS_ANCHOR_SHA256, CHAOS_HEADLINE_CFG, TRACE_HEADLINE_SHA256,
    )
    from koordinator_tpu_torch.harness.chaos import (
        ChaosTier, FaultPlan, flat_score_bytes, overload_band_storm,
    )
    from koordinator_tpu_torch.harness.golden import build_sync_request
    from koordinator_tpu_torch.obs import slo as slo_mod
    from koordinator_tpu_torch.obs.scorer_metrics import TRACE_CYCLE
    from koordinator_tpu_torch.obs.slo import SloSpec

    line = {"card": card, "transport": "raw UDS through ScorerClient('raw://...')"}
    reset_counts()

    # (a) the reference's accelerator configuration, then its band storm
    line["accelerator"] = chaos_replay(dev, "accelerator", CHAOS_ANCHOR_CFG["accelerator"],
                                       CHAOS_ANCHOR_SHA256, (0,))
    storm = overload_band_storm(device=dev)
    if storm["shed_by_band"].get("koord-free", 0) == 0 or storm["shed_by_band"].get(
            "koord-prod", 0) or storm["errors"]:
        raise AssertionError(f"chaos: the band storm shed {storm['shed_by_band']}, "
                             f"{storm['errors']} errors")
    storm_verdicts = slo_mod.evaluate_slos(storm["registry"], [SloSpec(
        name="prod-storm-score-p99", family=TRACE_CYCLE, quantile=0.99,
        threshold_ms=2000.0, labels={"band": "koord-prod", "rpc": "score"})])
    line["band_storm"] = {k: storm[k] for k in ("band_p99_ms", "served", "shed_client",
                                                "shed_by_band", "errors", "max_inflight")}
    line["band_storm"]["slo"] = [v.to_doc() for v in storm_verdicts]
    line["gate_pass"] = line["accelerator"]["slo_pass"] and slo_mod.slos_pass(storm_verdicts)

    # (b) the same gate at the headline cluster size, two K2 launches held
    line["headline"] = chaos_replay(dev, "headline", CHAOS_HEADLINE_CFG, TRACE_HEADLINE_SHA256,
                                    (0, 1))

    # (c) ChaosTier at the headline: two followers behind faulty channels
    node_list, pod_list, gangs, quotas = lists
    P, N = len(pod_list), len(node_list)
    req, _ = build_sync_request(node_list, pod_list, gangs, quotas, node_bucket=N,
                                pod_bucket=P)
    msgs = [req] + sync_messages(req, CHAOS_TIER_DELTAS, seed=16)
    tmp = tempfile.mkdtemp(prefix="kt")
    t0 = time.perf_counter()
    tier = ChaosTier(tmp, followers=2, plan=FaultPlan(**CHAOS_TIER_PLAN), seed=CHAOS_TIER_SEED,
                     device=dev)
    steps = {}
    for step, msg in enumerate(msgs):
        if step == CHAOS_TIER_STEPS["crash_restart"]:
            before = tier.leader.snapshot_id()
            tier.crash_leader()
            stats = tier.restart_leader()
            if stats["resumed_id"] != before or tier.leader.snapshot_id() != before:
                raise AssertionError(f"chaos tier: the restart resumed {stats['resumed_id']}")
            steps["restart"] = {"ms": stats["recovery_ms"], "replay_ms": stats["replay_ms"],
                                "replayed_frames": stats["replayed_frames"]}
        if step == CHAOS_TIER_STEPS["crash_damage_restart"]:
            tier.crash_leader()
            tier.damage_journal(cut_bytes=9)
            stats = tier.restart_leader()
            if not stats["truncated"]:
                raise AssertionError("chaos tier: the torn tail was not truncated")
            # the torn frame's Sync never became durable: the writer re-sends
            # it to the recovered leader (the oracle applied it already)
            tier.sync(msgs[step - 1], oracle=False)
            steps["damaged_restart"] = {"ms": stats["recovery_ms"], "new_epoch":
                                        tier.leader.snapshot_id()}
        if step == CHAOS_TIER_STEPS["crash_promote"]:
            tier.crash_leader()
            t1 = time.perf_counter()
            sid = tier.promote(0)
            steps["promote"] = {"ms": (time.perf_counter() - t1) * 1e3, "snapshot_id": sid}
        tier.sync(msg)
        tier.converge()
    sid = tier.leader.snapshot_id()
    fired = {k: sum(f.channel.injected[k] for f in tier.followers) for k in CHAOS_TIER_PLAN}
    score_bytes = len(flat_score_bytes(tier.leader, sid))
    line["tier"] = {
        "snapshot": f"quota_colocation {P} pods x {N} nodes, 16 tenants, seed 0",
        "followers": 2, "plan": CHAOS_TIER_PLAN, "seed": CHAOS_TIER_SEED, "syncs": len(msgs),
        "delta_recipe": "daemon_deltas, seed 16", "fault_steps": CHAOS_TIER_STEPS,
        "steps": steps, "resyncs": tier.resyncs, "torn_checks": tier.torn_checks,
        "stats": dict(tier.stats), "faults_fired": fired,
        "flat_score_bytes_k8": score_bytes, "wall_s": time.perf_counter() - t0,
        "parity": "every delivery: no torn snapshot; at each converge: mirrors and ids "
                  "equal to the leader's, and leader and followers' flat Score bytes equal "
                  "to the unfaulted oracle's",
    }
    if not all(fired.values()) or tier.resyncs < 3:
        raise AssertionError(f"chaos tier: faults {fired}, {tier.resyncs} resyncs")
    del tier
    line["corrupt"] = corrupt_leg(dev, msgs[0], sync_messages(req, CHAOS_CORRUPT_FRAMES,
                                                               seed=17))
    torch.cuda.synchronize()
    line["launches"] = kernel_counts()
    return line, only_k2("chaos", line["launches"])


def corrupt_leg(dev, full, deltas):
    """One follower behind a channel that flips one byte of every frame
    (``FaultPlan(corrupt=1.0)``): each delta frame is refused (its
    follower state untouched, no torn snapshot, then the one-shot resync)
    or applied; an applied frame either matches the leader's state (the
    flip hit a byte the state does not hold, such as the stamp) or, with
    the same snapshot id, diverges from it silently.  Counts each outcome;
    the follower is resynced after every frame."""
    import tempfile

    from koordinator_tpu_torch.harness.chaos import ChaosTier, FaultPlan, state_digest

    tier = ChaosTier(tempfile.mkdtemp(prefix="kx"), followers=1,
                     plan=FaultPlan(corrupt=1.0), seed=0, device=dev)
    tier.sync(full)
    f = tier.followers[0]
    tier._resync(f)
    out = {"frames": len(deltas), "refused": 0, "applied_equal": 0,
           "applied_diverged_same_id": 0}
    for msg in deltas:
        resyncs = tier.resyncs
        sid = tier.sync(msg)
        if tier.resyncs > resyncs or f.servicer.snapshot_id() != sid:
            out["refused"] += 1
        elif state_digest(f.servicer) == state_digest(tier.leader):
            out["applied_equal"] += 1
        else:
            out["applied_diverged_same_id"] += 1
        tier._resync(f)
    out.update(torn_checks=tier.torn_checks, corrupted=f.channel.injected["corrupt"],
               note="a replication frame carries no checksum (the reference's format); "
                    "refused frames left no torn snapshot")
    return out


def tree_phase(card, dev, lists):
    """The ``tree`` line (phase 17): the reference's ``--config tree`` at
    the headline, a root leader with a depth-3 relay chain and one flat
    follower, all real daemons in this process.  Returns (line, K2
    launches)."""
    import tempfile

    import torch

    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.harness.golden import build_sync_request
    from koordinator_tpu_torch.harness.relay import RelayTier, autoscale_wave

    node_list, pod_list, gangs, quotas = lists
    P, N = len(pod_list), len(node_list)
    req, _ = build_sync_request(node_list, pod_list, gangs, quotas, node_bucket=N,
                                pod_bucket=P)
    deltas = sync_messages(req, 15, seed=8)
    line = {"snapshot": f"quota_colocation {P} pods x {N} nodes, 16 tenants, seed 0",
            "shape": "RelayTier(chain=3, flat=1, compress=True, batch_bytes=64 KiB)",
            "card": card}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tmp = tempfile.mkdtemp(prefix="kr")
    tier = RelayTier(tmp, chain=3, flat=1, compress=True, batch_bytes=64 * 1024, device=dev)
    exact = {}

    def settle(name, sid):
        t0 = time.perf_counter()
        if not tier.wait(sid, timeout_s=600.0):
            raise AssertionError(f"tree: {name}: the tier did not converge to {sid}")
        return (time.perf_counter() - t0) * 1e3

    def score(srv, sid):
        reply = srv.servicer.score(wire.ScoreRequest(snapshot_id=sid, top_k=32, flat=True))
        return reply.flat.SerializeToString()

    try:
        t0 = time.perf_counter()
        sid = tier.sync(req)
        sync_ms = (time.perf_counter() - t0) * 1e3
        line["cold"] = {"root_sync_ms": sync_ms, "converge_ms": settle("cold", sid)}
        t0 = time.perf_counter()
        for msg in deltas[:10]:
            sid = tier.sync(msg)
        line["deltas"] = {"syncs": 10, "recipe": "daemon_deltas, seed 8",
                          "root_sync_ms": (time.perf_counter() - t0) * 1e3,
                          "converge_ms": settle("deltas", sid)}
        leaf, flat = tier.chain[-1], tier.flat[0]
        want = score(tier.leader, sid)
        exact["score_bytes_root_leaf_flat"] = score(leaf, sid) == want == score(flat, sid)
        # one Assign at the root and one at the leaf, each one K2 launch
        root_a = tier.leader.servicer.assign(wire.AssignRequest(snapshot_id=sid))
        leaf_a = leaf.servicer.assign(wire.AssignRequest(snapshot_id=sid))
        exact["assign_root_vs_leaf"] = (
            list(root_a.assignment) == list(leaf_a.assignment)
            and list(root_a.status) == list(leaf_a.status)
            and root_a.path == leaf_a.path == "cuda")
        # an interior hop dies in the middle of a delta storm
        victim = tier.chain[1]
        opens0 = sum(s._publisher.subscriptions - s._publisher.resumed_subscriptions
                     for s in [tier.leader] + tier.followers()
                     if s is not victim and s._publisher is not None)
        resyncs0 = sum(s.applier.resyncs for s in tier.followers() if s is not victim)
        for msg in deltas[10:12]:
            sid = tier.sync(msg)
        tier.kill(1)
        for msg in deltas[12:]:
            sid = tier.sync(msg)
        kill_ms = settle("the interior kill", sid)
        line["interior_kill"] = {
            "hop": 1, "deltas_before": 2, "deltas_after": 3, "converge_ms": kill_ms,
            "full_opens": tier.full_opens() - opens0, "resyncs": tier.resyncs() - resyncs0,
            "ancestor_switches": sum(s._subscriber.ancestor_switches
                                     for s in tier.followers()),
        }
        exact["no_full_open_no_resync_through_the_kill"] = (
            line["interior_kill"]["full_opens"] == 0 and line["interior_kill"]["resyncs"] == 0)
        want = score(tier.leader, sid)
        exact["score_bytes_after_the_kill"] = all(score(s, sid) == want
                                                  for s in tier.followers())
        # the autoscale wave, its spawn lever splicing real leaf daemons
        t0 = time.perf_counter()
        wave = autoscale_wave(ticks=48, peak=10.0, spawn=tier.spawn_leaf,
                              drain=tier.drain_leaf)
        wave_s = time.perf_counter() - t0
        elastic_ms = settle("the elastic leaves", sid)
        exact["elastic_leaves_score_bytes"] = all(score(s, sid) == want for s in tier.elastic)
        line["autoscale"] = {
            "ticks": wave["ticks"], "peak_load": wave["peak_load"],
            "scale_ups": wave["scale_ups"], "scale_downs": wave["scale_downs"],
            "peak_replicas": wave["peak_replicas"], "final_replicas": wave["final_replicas"],
            "slo_p99_ms": wave["slo_p99_ms"], "slo_held": wave["slo_held"],
            "plateau_ticks_judged": wave["plateau_ticks_judged"],
            "plateau_ticks_within_slo": wave["plateau_ticks_within_slo"],
            "spawn_to_ready_ms_all": wave["spawn_to_ready_ms_all"],
            "elastic_leaves_live": len(tier.elastic), "elastic_converge_ms": elastic_ms,
            "wall_s": wave_s,
            "note": "read latency modeled by the harness (base_ms * load / replicas); the "
                    "levers are real daemons",
        }
        if wave["scale_ups"] < 1:
            raise AssertionError("tree: the autoscale wave never scaled up")
        line["daemons_live"] = 1 + len(tier.followers())
    finally:
        tier.stop()
    torch.cuda.synchronize()
    line["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    line["peak_over_resident_bytes"] = line["peak_device_bytes"] - resident
    line["exact"] = exact
    failed = [k for k, ok in exact.items() if not ok]
    if failed:
        raise AssertionError(f"tree: {failed}")
    line["launches"] = kernel_counts()
    k2 = only_k2("tree", line["launches"])
    if k2 != 2:
        raise AssertionError(f"tree: {k2} K2 launches, want 2 (root and leaf Assign)")
    return line, k2


# the ``preempt`` line's reservation tick: reservation k lives
# RSV_TTL_HOURS[k % 4] hours, and the controller's clock moves to
# RSV_TICK_HOURS
RSV_TTL_HOURS = (1, 2, 3, 4)
RSV_TICK_HOURS = 2.5


def preempt_phase(card, dev, extras_state):
    """The ``preempt`` line (phase 18): the PostFilter over the pods the
    extras cycle on K2 left unplaced, at the anchor and at the headline,
    then a reservation expiry tick re-run through the extras cycle on K2.
    Returns (line, K2 launches)."""
    import torch

    from koordinator_tpu_torch.harness.anchor import (
        ANCHOR_RECIPE, PREEMPT_ANCHOR_SHA256,
    )
    from koordinator_tpu_torch.harness.extras_scenario import (
        extended_plugins, extras_context, extras_snapshot, plugin_extra_tensors,
        reservation_specs,
    )
    from koordinator_tpu_torch.harness.preempt import preempt_digest, preemption_inventory
    from koordinator_tpu_torch.model.reservation import encode_reservations
    from koordinator_tpu_torch.scheduler.framework import CycleContext, FrameworkExtender
    from koordinator_tpu_torch.scheduler.reservation_controller import (
        Reservation, ReservationController,
    )
    from koordinator_tpu_torch.solver import run_cycle

    snap, tables, nodes, pods, result = extras_state
    P, N = snap.pods.capacity, snap.nodes.capacity
    line = {"snapshot": f"quota_colocation {P} pods x {N} nodes, seed 0, extras_scenario "
                        "seed 0, the extras line's K2 placements", "card": card}
    reset_counts()

    def post_filter(s, res, node_list, pod_list):
        ctx = CycleContext(snapshot=s)
        t0 = time.perf_counter()
        ctx.extras["preemption"] = preemption_inventory(s, res.assignment, res.quota_used,
                                                        node_list, pod_list)
        inv_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        found = FrameworkExtender().post_filter_preempt(ctx, res)
        return ctx.extras["preemption"], found, inv_ms, (time.perf_counter() - t0) * 1e3

    # the anchor: the PostFilter over the extras cycle on K2
    snap_a, *tables_a, nodes_a, pods_a = extras_snapshot(**ANCHOR_RECIPE, device=dev)
    m_a, s_a = plugin_extra_tensors(snap_a, *tables_a)
    res_a = run_cycle(snap_a, extra_mask=m_a, extra_scores=s_a)
    _, found_a, _, _ = post_filter(snap_a, res_a, nodes_a, pods_a)
    if res_a.path != "cuda" or preempt_digest(found_a) != PREEMPT_ANCHOR_SHA256:
        raise AssertionError(f"preempt anchor: digest {preempt_digest(found_a)}")
    line["anchor"] = f"{ANCHOR_RECIPE}: {len(found_a)} pods find victims, digest matches"

    # the headline
    inv, found, inv_ms, pf_ms = post_filter(snap, result, nodes, pods)
    unplaced = int((result.assignment < 0).sum())
    if len(inv["pending_pods"]) != unplaced:
        raise AssertionError(f"preempt: {len(inv['pending_pods'])} pending, {unplaced} unplaced")
    line["post_filter"] = {
        "unplaced_all_taken": unplaced, "inventory_ms": inv_ms, "post_filter_ms": pf_ms,
        "nodes_evaluated_per_pod": len(inv["node_allocatable"]),
        "pods_with_victims": len(found),
        "victims": sum(len(nv.victims) for nv in found.values()),
        "chosen_nodes": len({nv.node for nv in found.values()}),
        "digest": preempt_digest(found),
        "quota_runtime": "declared dimensions from the quota table, the rest unlimited",
    }

    # the reservation tick
    zones, policy, devices, _ = tables
    node_names = [n["name"] for n in nodes]
    specs = {s["name"]: s for s in reservation_specs(node_names)}
    now = [0.0]
    ctl = ReservationController(clock=lambda: now[0])
    for k, spec in enumerate(specs.values()):
        ctl.create(Reservation(name=spec["name"], requests=dict(spec["allocatable"]),
                               owners=spec["owners"],
                               ttl_seconds=3600.0 * RSV_TTL_HOURS[k % len(RSV_TTL_HOURS)],
                               allocate_policy=spec["allocate_policy"], creation_time=0.0))
        ctl.on_reserve_pod_assigned(spec["name"], spec["node"], now=0.0)

    def cycle():
        # the controller owns the CR's spec and status; its labels and order
        # are the CR's metadata, as the scenario declares them
        rows = [dict(row, labels=specs[row["name"]]["labels"], order=specs[row["name"]]["order"])
                for row in ctl.active_reservations()]
        rsv = encode_reservations(rows, pods, node_names, pod_bucket=P, device=dev)
        fx = FrameworkExtender(extended_plugins())
        fx.register_error_handler(lambda ctx, p, exc: True)
        t0 = time.perf_counter()
        out = fx.run_cycle(extras_context(snap, zones, policy, devices, rsv))
        torch.cuda.synchronize()
        return out, len(rows), (time.perf_counter() - t0) * 1e3

    before, rows_before, before_ms = cycle()
    now[0] = RSV_TICK_HOURS * 3600.0
    t0 = time.perf_counter()
    ctl.sync_all()
    tick_ms = (time.perf_counter() - t0) * 1e3
    expired = sum(1 for r in ctl.reservations.values() if r.is_expired())
    with K2Tap([0]) as tap:
        after, rows_after, after_ms = cycle()
    if before.path != "cuda" or after.path != "cuda" or rows_after != rows_before - expired:
        raise AssertionError(f"preempt: paths {before.path}/{after.path}, rows "
                             f"{rows_before} -> {rows_after}, {expired} expired")
    line["reservation_tick"] = {
        "reservations": len(specs), "ttl_hours": RSV_TTL_HOURS, "tick_hours": RSV_TICK_HOURS,
        "expired": expired, "active_before": rows_before, "active_after": rows_after,
        "tick_ms": tick_ms, "cycle_before_ms": before_ms, "cycle_after_ms": after_ms,
        "placed_before": int((before.assignment >= 0).sum()),
        "placed_after": int((after.assignment >= 0).sum()),
        "placements_moved": int((before.assignment != after.assignment).sum()),
        "k2_vs_plain": tap.check("preempt tick"),
        "cycle": "FrameworkExtender([NodeNUMAResource, Reservation, DeviceShare]).run_cycle "
                 "on the re-encoded active_reservations(), hooks included",
    }
    if not expired:
        raise AssertionError("preempt: the tick expired no reservation")
    torch.cuda.synchronize()
    line["launches"] = kernel_counts()
    return line, only_k2("preempt", line["launches"])


# the device-discipline rules, which the lint line also times alone
DEVICE_RULES = ("donation-safety", "retrace-hazard", "host-sync-in-jit",
                "unregistered-jit-boundary", "prewarm-drift")


def lint_phase(card, dev, unwitnessed):
    """The ``lint`` line (phase 19): (a) koordlint over the checked-out port
    and this script (``koordinator_tpu_torch/analysis``): every rule, no
    finding, the suppression audit clean, the derived lock graph; (b) the
    witness leg: the ``chaos`` line's first replay (the reference's
    accelerator trace) once more, with ``lockwitness.install()`` armed on
    the port's derived order: no inversion, the observed edges (those the
    static order lacks named), parity with the serial oracle, one K2 launch
    held against its plain version, and its wall over ``unwitnessed``, the
    ``chaos`` line's wall for the same replay.  Returns (line, K2
    launches)."""
    import os

    import torch

    from koordinator_tpu_torch.analysis import RULES, lockgraph, suppressions
    from koordinator_tpu_torch.analysis.core import run_repo, scanned_files
    from koordinator_tpu_torch.harness.anchor import CHAOS_ANCHOR_CFG, CHAOS_ANCHOR_SHA256
    from koordinator_tpu_torch.obs import lockwitness

    # (a) the static pass over the tree this script runs from
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    lint = suppressions.lint_pass(root)
    static_s = time.perf_counter() - t0
    findings, tags, graph = lint.findings, lint.tags, lint.graph
    if findings or lint.problems:
        raise AssertionError("lint: " + "; ".join(
            v.format() for v in findings + lint.problems))
    # the device-discipline rules alone, timed apart
    t0 = time.perf_counter()
    device_found = run_repo(root=root, rules=list(DEVICE_RULES))
    device_s = time.perf_counter() - t0
    if device_found:
        raise AssertionError("lint: " + "; ".join(v.format() for v in device_found))
    live = {}
    for tag in tags:
        live[tag.rule] = live.get(tag.rule, 0) + 1
    line = {"card": card, "static": {
        "rules": list(RULES), "files": len(scanned_files(root)), "findings": 0,
        "findings_by_rule": {rule: sum(v.rule == rule for v in findings) for rule in RULES},
        "live_tags": len(tags), "live_tags_by_rule": live, "stale_tags": 0,
        "tags_without_reason": 0, "locks": len(graph.locks), "edges": len(graph.edges),
        "cycles": len(lockgraph.find_cycles(graph)), "seconds": static_s,
        "device_rules": list(DEVICE_RULES), "device_rules_seconds": device_s,
        "note": "suppressions.lint_pass: one unsuppressed pass over the tree and one "
                "lock graph give the findings, the tags and the audit",
    }}

    # (b) the witness leg: the locks a replay creates are witnessed, so the
    # witness is armed before the replay builds its daemons
    reset_counts()
    t0 = time.perf_counter()
    lockwitness.install()
    install_s = time.perf_counter() - t0
    try:
        static = {(a, b) for a, bs in lockwitness._STATE.static_order.items() for b in bs}
        if static != set(graph.edges):
            raise AssertionError("lint: install() did not arm the derived order")
        replay = chaos_replay(dev, "witnessed", CHAOS_ANCHOR_CFG["accelerator"],
                              CHAOS_ANCHOR_SHA256, (0,))
        observed = lockwitness.observed_edges()
        inversions = lockwitness.inversions()
    finally:
        lockwitness.uninstall()
    torch.cuda.synchronize()
    launches = kernel_counts()
    if inversions or not observed:
        raise AssertionError(f"lint: witness saw {len(observed)} edges, "
                             f"inversions {inversions}")
    lacking = sorted(e for e in observed if e not in static)
    line["witness"] = {
        "replay": "chaos accelerator (CHAOS_ANCHOR_CFG): "
                  f"{replay['nodes']} nodes x {replay['pod_slots']} pod slots, "
                  f"{replay['events']} events, poison at {replay['fail_at']}, "
                  f"kill at {replay['kill_at']}",
        "order_edges": len(static), "install_s": install_s, "inversions": 0,
        "observed_edges": len(observed),
        "acquisitions_on_observed_edges": sum(observed.values()),
        "observed_not_in_static_order": [
            {"first": a, "then": b, "count": observed[(a, b)]} for a, b in lacking],
        "parity_ok": replay["checks"]["parity_ok"], "checks": replay["checks"],
        "k2_vs_plain": replay["k2_vs_plain"], "launches": launches,
        "wall_s": replay["wall_s"], "unwitnessed_wall_s": unwitnessed,
        "wall_over_unwitnessed": replay["wall_s"] / unwitnessed,
    }
    return line, only_k2("lint", launches)


# the koordlet line (phase 20)
KOORDLET_RECIPE = {"seed": 0, "pods": 10000, "nodes": 2000, "tenants": 16}
KOORDLET_DELTA_SEED = 8  # the incremental recipe's seed
UDS_PATH_MAX = 107


def koordlet_device_leg(now):
    """(a) the CUDA enumeration, the collector's stored memory and the
    Device CR, while the headline's tensors are resident."""
    import torch

    from koordinator_tpu_torch.koordlet import collectors
    from koordinator_tpu_torch.koordlet import metriccache as mc
    from koordinator_tpu_torch.koordlet import statesinformer as si

    torch.cuda.synchronize()
    devs = collectors._cuda_devices()
    count = torch.cuda.device_count()
    if (len(devs) != 1 or count != 1 or devs[0]["minor"] != 0
            or devs[0]["platform"] != "gpu" or devs[0]["memory_used"] <= 0):
        raise AssertionError(f"koordlet device: enumeration {devs}, device count {count}")
    cache = mc.MetricCache()
    collectors.DeviceCollector(cache).collect(now)
    stored = cache.query(mc.DEVICE_MEMORY_USED, start=now - 1, end=now, agg=mc.AGG_LATEST,
                         labels={"minor": "0"})
    if stored != float(devs[0]["memory_used"]):
        raise AssertionError(f"koordlet device: stored {stored}, enumerated {devs[0]}")
    crs = si.DeviceReporter(si.StatesInformer()).sync(now)
    if [(d["type"], d["minor"]) for d in crs] != [("gpu", 0)]:
        raise AssertionError(f"koordlet device: Device CR {crs}")
    return {"count": len(devs), "device_count": count, "minor": devs[0]["minor"],
            "platform": devs[0]["platform"], "memory_used": devs[0]["memory_used"],
            "stored_memory_used": stored, "device_crs": len(crs)}


def koordlet_native_leg(fleet, base):
    """(b) the native library: its build, its batched reads of the fleet's
    sysfs files against Python's, its delta codec on the fleet's node rows
    against the numpy one, and the CPI reading or why there is none."""
    import os

    import numpy as np

    from koordinator_tpu_torch import native
    from koordinator_tpu_torch.bridge.state import delta_encode
    from koordinator_tpu_torch.harness import koordlet_fleet as kf

    if not native.available():
        raise AssertionError(f"koordlet native: unavailable: {native.build_info()}")
    info = native.build_info()
    files = kf.tree_files([os.path.join(base, d) for d in os.listdir(base)])
    t0 = time.perf_counter()
    got = native.read_files(files)
    native_read_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = []
    for p in files:
        with open(p) as f:
            want.append(f.read())
    python_read_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError("koordlet native: read_files differs from Python's reads")

    # the incremental recipe's 64 changed node rows on the fleet's rows
    prev = fleet.snapshot.nodes.requested.cpu().numpy().astype(np.int64)
    alloc = fleet.snapshot.nodes.allocatable.cpu().numpy()
    n, r = prev.shape
    rows = np.unique((np.arange(64) * max(1, n // 64)) % n)
    rng = np.random.default_rng(KOORDLET_DELTA_SEED)
    nxt = prev.copy()
    nxt[rows[:, None], [0, 1]] = (alloc[rows][:, [0, 1]]
                                  * rng.uniform(0, 0.5, (len(rows), 2))).astype(np.int64)
    t0 = time.perf_counter()
    enc = native.delta_encode(prev, nxt)
    encode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want_idx, want_val = delta_encode(prev, nxt, prev.size)
    numpy_encode_ms = (time.perf_counter() - t0) * 1e3
    if enc is None or enc[0].tobytes() != want_idx.tobytes() or \
            enc[1].tobytes() != want_val.tobytes():
        raise AssertionError("koordlet native: delta_encode differs from the numpy codec")
    base_rows = prev.copy()
    t0 = time.perf_counter()
    native.delta_apply(base_rows, *enc)
    apply_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(base_rows, nxt):
        raise AssertionError("koordlet native: delta_apply did not reproduce the next rows")
    try:
        with native.PerfCPIGroup(0) as group:
            cycles, instructions = group.read()
        cpi = {"cycles": cycles, "instructions": instructions}
    except OSError as exc:
        cpi = {"unavailable": f"errno {exc.errno}: {exc.strerror}"}
    return {"available": True, "library": os.path.basename(info["path"]),
            "built_here": info["built"], "build_s": info["seconds"],
            "files": len(files), "read_files_ms": native_read_ms,
            "python_read_ms": python_read_ms, "rows": [n, r], "changed_rows": len(rows),
            "changed_cells": len(enc[0]), "delta_encode_ms": encode_ms,
            "numpy_delta_encode_ms": numpy_encode_ms, "delta_apply_ms": apply_ms,
            "delta": "byte-identical to bridge/state.py delta_encode; apply reproduces the "
                     "next rows", "cpi": cpi}


def extras_rows_on_cpu(what, snap, tables, mask, scores):
    """Hold the card's plugin mask and scores against ``plugin_extra_tensors``
    on the CPU, on ``EXTRAS_CPU_ROWS`` pod rows spread across the snapshot;
    ``tables`` is (zones, policy, devices, rsv).  Returns the CPU path's
    seconds."""
    import torch

    from koordinator_tpu_torch.harness.extras_scenario import plugin_extra_tensors
    from koordinator_tpu_torch.solver import greedy

    zones, policy, devices, rsv = tables
    P = snap.pods.capacity
    rows = torch.linspace(0, P - 1, EXTRAS_CPU_ROWS).round().long()
    if len(set(rows.tolist())) != EXTRAS_CPU_ROWS:
        raise AssertionError(f"{what}: sampled pod rows repeat")
    snap_cpu = map_snapshot(snap, lambda t: t.cpu())
    rsv_cpu = rsv.to("cpu")
    sub = greedy._pod_rows(snap_cpu, rows)
    sub_rsv = dataclasses.replace(rsv_cpu, matched=rsv_cpu.matched[rows],
                                  affinity_required=rsv_cpu.affinity_required[rows])
    t0 = time.perf_counter()
    m_cpu, s_cpu = plugin_extra_tensors(sub, zones.to("cpu"), policy, devices.to("cpu"),
                                        sub_rsv)
    seconds = time.perf_counter() - t0
    if not (torch.equal(m_cpu, mask[rows].cpu()) and torch.equal(s_cpu, scores[rows].cpu())):
        raise AssertionError(f"{what}: the card's mask or scores differ from the CPU path")
    return seconds


def koordlet_fleet_leg(dev, base, counted, only):
    """(c) 2,000 nodes' reports build the extras snapshot; the extended-plugin
    cycle on K2 over it, exact against the plain cycle; the anchor.
    Returns (line, K2 launches, fleet, the framework, the cycle's context,
    its result, the list its Reserve failures land in)."""
    import os

    import numpy as np
    import torch

    from koordinator_tpu_torch.harness import koordlet_fleet as kf
    from koordinator_tpu_torch.harness.anchor import (
        ANCHOR_RECIPE, KOORDLET_ANCHOR_SHA256, cycle_digest,
    )
    from koordinator_tpu_torch.harness.extras_scenario import (
        extended_plugins, extras_context, plugin_extra_tensors,
    )
    from koordinator_tpu_torch.model import resources as res
    from koordinator_tpu_torch.scheduler.framework import FrameworkExtender
    from koordinator_tpu_torch.solver import greedy_assign, run_cycle

    def framework(failures):
        fx = FrameworkExtender(extended_plugins())
        fx.register_error_handler(lambda ctx, p, exc: failures.append(p) or True)
        return fx

    # the anchor recipe first: the same pipeline, the card's cycle against
    # the JAX-derived digest
    anchor = kf.fleet_snapshot(os.path.join(base, "anchor"), **ANCHOR_RECIPE,
                               impl=kf.port_impl(dev))
    res_a = framework([]).run_cycle(extras_context(anchor.snapshot, *anchor.tables))
    digest = cycle_digest(res_a.assignment.cpu(), res_a.status.cpu())
    if res_a.path != "cuda" or digest != KOORDLET_ANCHOR_SHA256:
        raise AssertionError(f"koordlet anchor: path {res_a.path}, digest {digest}")

    t0 = time.perf_counter()
    fleet = kf.fleet_snapshot(os.path.join(base, "fleet"), **KOORDLET_RECIPE,
                              impl=kf.port_impl(dev))
    fleet_s = time.perf_counter() - t0
    snap = fleet.snapshot
    n = KOORDLET_RECIPE["nodes"]
    usage = snap.nodes.usage[:n].cpu().numpy()
    if not np.array_equal(usage, kf.fleet_usage_rows(res, fleet.nodes)):
        raise AssertionError("koordlet fleet: the reports' usage is not the scenario's")
    mask, scores = plugin_extra_tensors(snap, *fleet.tables)
    # the composition over the report-built tables against the CPU path,
    # before the card's mask and scores feed the plain cycle
    cpu_rows_s = extras_rows_on_cpu("koordlet fleet", snap, fleet.tables, mask, scores)
    oracle = greedy_assign(snap, extra_mask=mask, extra_scores=scores)
    failures = []
    fx = framework(failures)
    ctx = extras_context(snap, *fleet.tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, counts = counted("koordlet fleet", oracle, lambda: fx.run_cycle(ctx))
    framework_ms = (time.perf_counter() - t0) * 1e3
    launches = only("the koordlet fleet cycle", counts, "cycle_wide")
    cycle_ev, cycle_wall = cuda_time(
        lambda: run_cycle(snap, extra_mask=mask, extra_scores=scores))
    seconds = fleet.reports.node_seconds
    line = {
        "recipe": f"extras_snapshot{KOORDLET_RECIPE}, usage, zones and devices from "
                  "each node's koordlet reports",
        "nodes": n, "pods": KOORDLET_RECIPE["pods"], "sysfs_trees": fleet.reports.trees,
        "zones": int(fleet.zones.valid.sum()), "devices": int(fleet.devices.valid.sum()),
        "fleet_build_s": fleet_s,
        "report_pass_s": fleet.reports.wall_s, "report_node_s_sum": sum(seconds),
        "report_p50_ms_per_node": statistics.median(seconds) * 1e3,
        "adapt_encode_s": fleet.adapt_encode_s,
        "usage_from_reports": "equal to the scenario's node usage",
        "cpu_rows_checked": EXTRAS_CPU_ROWS, "cpu_rows_s": cpu_rows_s,
        "assigned": int((result.assignment >= 0).sum()),
        "launches": launches,
        "framework_cycle_ms_host_wall": framework_ms,
        "cycle_ms_cuda_events": cycle_ev, "cycle_ms_host_wall": cycle_wall,
        "parity": "K2 exact vs greedy_assign on the same tables, all five arrays; "
                  "no demotion, no other kernel",
        "anchor": f"{ANCHOR_RECIPE}: K2 digest matches KOORDLET_ANCHOR_SHA256",
    }
    return line, launches, fleet, fx, ctx, result, failures


def spawn_hook_server(path):
    """A koordlet process serving the default hook registry on ``path``
    (``hook_server_ready`` waits for it to serve)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys\n"
            "from koordinator_tpu_torch.koordlet.hookserver import HookServer\n"
            "from koordinator_tpu_torch.koordlet.runtimehooks import default_registry\n"
            "server = HookServer(sys.argv[1], default_registry()).start()\n"
            "print('ready', flush=True)\n"
            "sys.stdin.read()\n"
            "server.stop()\n")
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code, path], cwd=root, env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def hook_server_ready(proc, timeout=60.0):
    """Wait up to ``timeout`` seconds for the hook server process to print
    ``ready``; raises with its exit code when it does not."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    line = proc.stdout.readline().strip() if ready else ""
    if line != "ready":
        raise AssertionError(f"koordlet hooks: the hook server process did not start "
                             f"within {timeout} s (exit code {proc.poll()}, said {line!r})")


def stop_hook_server(proc):
    """End the hook server process: its stdin closed, then killed if it
    has not exited within 30 s.  Returns its exit code."""
    proc.stdin.close()
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        return proc.returncode


def koordlet_hooks_leg(gpu_pods, tmp, hook_proc, hook_path):
    """(d) each GPU pod's ``device-allocated`` annotation through
    PreCreateContainer in the CRI proxy (over ``hook_proc``, a hook server
    in its own koordlet process on ``hook_path``), the docker proxy and
    NRI: the container env of each mode.  ``gpu_pods`` is [(uid,
    annotation)]."""
    import http.client
    import json as _json
    import os
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from koordinator_tpu_torch.httpserving import HTTPLifecycle
    from koordinator_tpu_torch.koordlet.hookserver import RemoteHookRegistry
    from koordinator_tpu_torch.koordlet.nri import (
        EVENT_CREATE_CONTAINER, EVENT_RUN_POD_SANDBOX, NriPlugin, NriRuntime,
    )
    from koordinator_tpu_torch.koordlet.runtimehooks import (
        DEVICE_ALLOCATED_ANNOTATION as ANN, default_registry,
    )
    from koordinator_tpu_torch.runtimeproxy import CRIRequest
    from koordinator_tpu_torch.runtimeproxy_docker import DockerProxyServer
    from koordinator_tpu_torch.runtimeproxy_server import (
        CRIProxyClient, CRIProxyServer, FakeRuntimeServer,
    )

    paths = {k: os.path.join(tmp, f"{k}.sock") for k in ("rt", "cri", "nri")}
    if max(len(p) for p in paths.values()) > UDS_PATH_MAX:
        raise AssertionError(f"koordlet hooks: socket paths too long under {tmp}")
    env = {"cri": {}, "docker": {}, "nri": {}}
    ms = {}

    # the CRI proxy; the hooks run in the koordlet process
    hook_server_ready(hook_proc)
    backend = FakeRuntimeServer(paths["rt"]).start()
    remote = RemoteHookRegistry(hook_path)
    proxy = CRIProxyServer(paths["cri"], paths["rt"], remote).start()
    client = CRIProxyClient(paths["cri"])
    try:
        t0 = time.perf_counter()
        for uid, ann in gpu_pods:
            client.call(CRIRequest(call="RunPodSandbox", pod_uid=uid,
                                   annotations={ANN: ann},
                                   labels={"koordinator.sh/qosClass": "LS"}))
            resp = client.call(CRIRequest(call="CreateContainer", pod_uid=uid,
                                          container_name="main"))
            env["cri"][uid] = resp["env"].get("NVIDIA_VISIBLE_DEVICES")
        ms["cri"] = (time.perf_counter() - t0) * 1e3 / max(len(gpu_pods), 1)
    finally:
        client.close()
        proxy.stop()
        remote.close()
        backend.stop()
    code = stop_hook_server(hook_proc)
    if code != 0:
        raise AssertionError(f"koordlet hooks: hook server exited {code}")

    # the docker proxy in front of a dockerd stand-in that keeps each
    # container's Env
    created = {}

    class Dockerd(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, *a):
            pass

        def do_POST(self):
            body = _json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
            created[body["Labels"]["io.kubernetes.pod.uid"]] = body.get("Env") or []
            data = b'{"Id": "c"}'
            self.send_response(201)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    dockerd = HTTPLifecycle(ThreadingHTTPServer(("127.0.0.1", 0), Dockerd))
    dockerd.start()
    docker = DockerProxyServer(default_registry(),
                               ("127.0.0.1", dockerd.httpd.server_address[1])).start()
    conn = http.client.HTTPConnection("127.0.0.1", docker.port, timeout=30)
    try:
        t0 = time.perf_counter()
        for uid, ann in gpu_pods:
            body = _json.dumps({"Labels": {
                "io.kubernetes.pod.uid": uid, "io.kubernetes.container.name": "main",
                "koordinator.sh/qosClass": "LS", f"annotation.{ANN}": _json.dumps(ann),
            }, "HostConfig": {}}).encode()
            conn.request("POST", "/v1.43/containers/create", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 201:
                raise AssertionError(f"koordlet hooks: docker create answered {resp.status}")
            pairs = dict(e.split("=", 1) for e in created[uid])
            env["docker"][uid] = pairs.get("NVIDIA_VISIBLE_DEVICES")
        ms["docker"] = (time.perf_counter() - t0) * 1e3 / max(len(gpu_pods), 1)
    finally:
        conn.close()
        docker.stop()
        dockerd.stop()

    # NRI: the koordlet registers as a plugin on the runtime's socket
    runtime = NriRuntime(paths["nri"])
    box = {}
    registering = threading.Thread(
        target=lambda: box.update(plugin=NriPlugin(paths["nri"], default_registry())))
    registering.start()
    try:
        runtime.accept_plugin(timeout=30.0)
        registering.join(timeout=30.0)
        t0 = time.perf_counter()
        for uid, ann in gpu_pods:
            runtime.event({"event": EVENT_RUN_POD_SANDBOX, "pod": {
                "uid": uid, "labels": {"koordinator.sh/qosClass": "LS"},
                "annotations": {ANN: ann}}})
            reply = runtime.event({"event": EVENT_CREATE_CONTAINER, "pod": {"uid": uid},
                                   "container": {"name": "main"}})
            pairs = {e["key"]: e["value"] for e in reply["adjustment"].get("env", [])}
            env["nri"][uid] = pairs.get("NVIDIA_VISIBLE_DEVICES")
        ms["nri"] = (time.perf_counter() - t0) * 1e3 / max(len(gpu_pods), 1)
    finally:
        if "plugin" in box:
            box["plugin"].close()
        runtime.close()

    for uid, ann in gpu_pods:
        want = ",".join(str(e["minor"]) for e in ann["gpu"])
        got = {mode: env[mode].get(uid) for mode in env}
        if set(got.values()) != {want}:
            raise AssertionError(f"koordlet hooks: pod {uid}: {got}, allocation {want}")
    return {"pods": len(gpu_pods), "modes": ["cri proxy (hooks in a koordlet process)",
                                             "docker proxy", "nri"],
            "cut": None, "ms_per_pod": ms,
            "env": "NVIDIA_VISIBLE_DEVICES identical in the three modes and equal to each "
                   "allocation's minors"}


def koordlet_daemon_leg(dev, tmp):
    """(e) ``build_default_daemon`` over a synthetic node under ``tmp``: the
    tree's digest after 16 fake-clock ticks against the JAX-derived
    constant, and its ``/metrics`` endpoint."""
    import urllib.request
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from koordinator_tpu_torch.harness import koordlet_fleet as kf
    from koordinator_tpu_torch.harness.anchor import KOORDLET_QOS_SEED, KOORDLET_QOS_SHA256
    from koordinator_tpu_torch.httpserving import HTTPLifecycle

    class Quiet(WSGIRequestHandler):
        def log_message(self, *a):
            pass

    tree = kf.QosTree(tmp, KOORDLET_QOS_SEED)
    d = kf.qos_daemon(kf.port_impl(dev), tmp)
    http = None
    try:
        digest, ran, tick_ms = kf.run_qos_ticks(d, tree)
        if digest != KOORDLET_QOS_SHA256:
            raise AssertionError(f"koordlet daemon: cgroup digest {digest}")
        http = HTTPLifecycle(make_server("127.0.0.1", 0, d.metrics.wsgi_app,
                                         handler_class=Quiet))
        http.start()
        url = f"http://127.0.0.1:{http.httpd.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            status, text = resp.status, resp.read().decode()
        if status != 200 or "koordlet_ticks_total" not in text:
            raise AssertionError(f"koordlet daemon: /metrics answered {status}")
    finally:
        if http is not None:
            http.stop()
        d.shutdown()
    return {"cgroup_root": "a temporary directory", "ticks": len(tick_ms),
            "strategies": len(d.qos.strategies), "strategies_last_tick": ran[-1],
            "evictions": len(d.evictor.evicted), "digest": "matches KOORDLET_QOS_SHA256",
            "tick_ms_p50": statistics.median(tick_ms), "tick_ms_max": max(tick_ms),
            "metrics": "/metrics answers 200 with koordlet_ticks_total"}


def filesystem_type(path):
    """What ``stat -f -c %T`` calls the filesystem under ``path``."""
    out = subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True, text=True,
                         timeout=30)
    return out.stdout.strip() if out.returncode == 0 else f"unknown (stat exit {out.returncode})"


MEMORY_DIR_PREFIX = "koord-smoke-"


def memory_backed_dir():
    """(directory, filesystem type): the temporary directory when it is a
    ``tmpfs``, else ``/dev/shm`` when that is one, else the temporary
    directory with the type it has.  A node's koordlet reads sysfs and
    cgroup files that live in memory; so does the ``koordlet`` line."""
    import os
    import tempfile

    tmp = tempfile.gettempdir()
    for d in (tmp, "/dev/shm"):
        if os.path.isdir(d) and os.access(d, os.W_OK) and filesystem_type(d) == "tmpfs":
            return d, "tmpfs"
    return tmp, filesystem_type(tmp)


def reap_memory_dirs(parent):
    """Remove the ``koord-smoke-<pid>-`` directories under ``parent`` whose
    process has ended (a run killed at its time limit leaves its tree in
    memory); returns how many went."""
    import os
    import shutil

    reaped = 0
    for name in os.listdir(parent):
        if not name.startswith(MEMORY_DIR_PREFIX):
            continue
        pid = name[len(MEMORY_DIR_PREFIX):].split("-", 1)[0]
        if not pid.isdigit():
            continue
        try:
            os.kill(int(pid), 0)
            continue  # its run is alive
        except ProcessLookupError:
            pass
        except PermissionError:
            continue  # a live process of another user
        shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
        reaped += 1
    return reaped


def koordlet_phase(card, dev, counted, only):
    """The ``koordlet`` line (phase 20) and K2's launches on it."""
    import os
    import shutil
    import tempfile

    from koordinator_tpu_torch.koordlet.runtimehooks import DEVICE_ALLOCATED_ANNOTATION

    # the fleet's sysfs trees, the hook socket and the daemon's node tree
    # on a memory-backed filesystem where the machine has one
    parent, fs_type = memory_backed_dir()
    reaped = reap_memory_dirs(parent)
    tmp = tempfile.mkdtemp(prefix=f"{MEMORY_DIR_PREFIX}{os.getpid()}-", dir=parent)
    # the koordlet process of the hooks leg starts now, beside the fleet
    hook_path = os.path.join(tmp, "hook.sock")
    if len(hook_path) > UDS_PATH_MAX:
        raise AssertionError(f"koordlet hooks: socket path too long: {hook_path}")
    hook_proc = spawn_hook_server(hook_path)
    try:
        t0 = time.perf_counter()
        device = koordlet_device_leg(time.time())
        legs_s = {"device": time.perf_counter() - t0}
        t0 = time.perf_counter()
        fleet_line, launches, fleet, fx, ctx, result, failures = koordlet_fleet_leg(
            dev, os.path.join(tmp, "sys"), counted, only)
        legs_s["fleet"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native_line = koordlet_native_leg(fleet, os.path.join(tmp, "sys", "fleet"))
        legs_s["native"] = time.perf_counter() - t0
        # the GPU pods the cycle placed and Reserve admitted: their PreBind
        # annotation
        t0 = time.perf_counter()
        fx.run_reserve(ctx, result)
        patches = fx.pre_bind_patches(ctx, result)
        pods = fleet.pods
        gpu_pods = [(pods[p]["name"], patch["annotations"][DEVICE_ALLOCATED_ANNOTATION])
                    for p, patch in sorted(patches.items())
                    if "gpu" in patch["annotations"].get(DEVICE_ALLOCATED_ANNOTATION, {})]
        if not gpu_pods:
            raise AssertionError("koordlet hooks: no placed GPU pod passed Reserve")
        reserve_ms = (time.perf_counter() - t0) * 1e3
        hooks = koordlet_hooks_leg(gpu_pods, os.path.join(tmp, "h"), hook_proc, hook_path)
        hooks.update(reserve_prebind_ms=reserve_ms, reserve_failures=len(failures),
                     placed_gpu_pods=len(gpu_pods))
        legs_s["hooks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        daemon = koordlet_daemon_leg(dev, os.path.join(tmp, "node"))
        legs_s["daemon"] = time.perf_counter() - t0
    finally:
        if hook_proc.poll() is None:
            stop_hook_server(hook_proc)
        shutil.rmtree(tmp, ignore_errors=True)
    line = {"card": card, "filesystem": {"parent": parent, "type": fs_type,
                                         "reaped_stale_dirs": reaped},
            "device": device, "native": native_line, "fleet": fleet_line,
            "hooks": hooks, "daemon": daemon, "legs_s": legs_s}
    return line, launches


# the controlplane line (phase 21)
CONTROLPLANE_RECIPE = {"seed": 0, "pods": 10000, "nodes": 2000, "tenants": 16}
CONTROLPLANE_SAMPLE = 512  # BE pods sent to the webhook over HTTPS
CONTROLPLANE_BUDGET_S = 45.0
# phase 3's cases whose features ReferenceCycle.schedule_batch covers (no
# gangs, no extras, no aggregated or prod usage)
ORACLE_CASES = ("loadaware_joint_1kx200", "quota_colocation_512x128", "most_allocated",
                "loadaware_disabled", "scarce_capacity")


def on_device(result, dev):
    """``result`` with its five arrays moved to ``dev``."""
    return dataclasses.replace(result, **{f: getattr(result, f).to(dev) for f in FIELDS})


def oracle_leg(cases, dev, counted):
    """The jax-free sequential oracle (``harness/reference.py``) on the
    card's results: the spark example's ``score_cycle`` scores and
    feasibility (the reference's ``bench.py --config spark`` check), and
    ``run_cycle``'s placements on every case of ``ORACLE_CASES``, each
    cycle through ``counted`` (one launch, no demotion, exact against
    ``greedy_assign``)."""
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.harness.reference import ReferenceCycle
    from koordinator_tpu_torch.model import resources as res
    from koordinator_tpu_torch.model.snapshot import PriorityClass, estimate_pod
    from koordinator_tpu_torch.solver import greedy_assign, run_cycle, score_cycle

    by_name = {name: (snap, cfg) for name, snap, cfg, xm, xs in cases}
    t0 = time.perf_counter()
    nodes, pods, _, _ = g.spark_colocation()
    snap = by_name["spark_colocation"][0]
    scores, feasible = (t.cpu() for t in score_cycle(snap))
    oracle = ReferenceCycle(
        [res.resource_vector(n["allocatable"]) for n in nodes],
        [[0] * res.NUM_RESOURCES for _ in nodes],
        [res.resource_vector(n.get("usage", {})) for n in nodes],
        [bool(n.get("metric_fresh", True)) for n in nodes])
    pairs = 0
    for p, pod in enumerate(pods):
        req = res.resource_vector(pod["requests"])
        est = estimate_pod(req, res.resource_vector(pod.get("limits", {})),
                           PriorityClass.from_name(pod.get("priority_class")))
        for n in range(len(nodes)):
            ok = oracle.fit_ok(n, req) and oracle.loadaware_filter_ok(n)
            if (int(scores[p, n]) != oracle.combined_score(n, req, est)
                    or bool(feasible[p, n]) != ok):
                raise AssertionError(f"oracle spark: pod {p} node {n} differs from "
                                     "ReferenceCycle")
            pairs += 1
    line = {"spark": {"pairs": pairs, "score_cycle": "scores and feasibility equal to "
                      "ReferenceCycle", "ms": (time.perf_counter() - t0) * 1e3}}
    for name in ORACLE_CASES:
        snap, cfg = by_name[name]
        t0 = time.perf_counter()
        cpu = map_snapshot(snap, lambda t: t.cpu())
        got, counts = counted(f"oracle {name}", on_device(greedy_assign(cpu, cfg), dev),
                              lambda: run_cycle(snap, cfg))
        if sum(counts.values()) != 1:
            raise AssertionError(f"oracle {name}: launches {counts}")
        n, P = int(snap.nodes.valid.sum()), int(snap.pods.valid.sum())
        q = cpu.quotas
        nq = int(q.valid.sum())
        cyc = ReferenceCycle(
            cpu.nodes.allocatable[:n].tolist(), cpu.nodes.requested[:n].tolist(),
            cpu.nodes.usage[:n].tolist(), cpu.nodes.metric_fresh[:n].tolist(), cfg=cfg,
            quota_runtime={i: q.runtime[i].tolist() for i in range(nq)},
            quota_used={i: q.used[i].tolist() for i in range(nq)},
            quota_limited={i: q.limited[i].tolist() for i in range(nq)})
        want = cyc.schedule_batch(cpu.pods.requests[:P].tolist(), cpu.pods.estimated[:P].tolist(),
                                  priorities=cpu.pods.priority[:P].tolist(),
                                  quota_ids=cpu.pods.quota_id[:P].tolist())
        if got.assignment[:P].tolist() != want:
            raise AssertionError(f"oracle {name}: placements differ from "
                                 "ReferenceCycle.schedule_batch")
        line[name] = {"pods": P, "nodes": n, "placed": sum(1 for a in want if a >= 0),
                      "launches": {k: v for k, v in counts.items() if v},
                      "ms": (time.perf_counter() - t0) * 1e3}
    return line


def controlplane_phase(card, dev, counted, cases):
    """The ``controlplane`` line (phase 21): the co-location loop of
    ``harness/controlplane.py`` at the headline, each of its cycles on the
    kernel ladder held against the plain cycle on the CPU, its daemons,
    and the sequential oracle.  Returns (line, launches by kernel)."""
    import os
    import shutil
    import tempfile

    from koordinator_tpu_torch.harness import controlplane as cp
    from koordinator_tpu_torch.solver import greedy_assign, run_cycle

    if cp.cert_generator() == "openssl" and shutil.which("openssl") is None:
        raise AssertionError("controlplane webhook: neither the cryptography package nor the "
                             "openssl command is here; the webhook cannot make its certificates")
    wall = time.perf_counter()
    launches = {"cycle_dense": 0, "cycle_wide": 0, "wave_cycle": 0}
    cycles = {}

    def cycle(name, snap, extra_mask=None):
        snap_cpu = map_snapshot(snap, lambda t: t.cpu())
        t0 = time.perf_counter()
        want = greedy_assign(snap_cpu, extra_mask=None if extra_mask is None
                             else extra_mask.cpu())
        plain_s = time.perf_counter() - t0
        out, counts = counted(f"controlplane cycle {name}", on_device(want, dev),
                              lambda: run_cycle(snap, extra_mask=extra_mask))
        rungs = [k for k, v in counts.items() if v]
        if sum(counts.values()) != 1:
            raise AssertionError(f"controlplane cycle {name}: launches {counts}")
        for k, v in counts.items():
            launches[k] += v
        cycles[name] = {"pods": int(snap.pods.valid.sum()), "rung": rungs[0],
                        "launches": counts[rungs[0]], "plain_cpu_s": plain_s,
                        "parity": "all five arrays equal to greedy_assign on the CPU"}
        return out

    legs_s = {}
    tmp = tempfile.mkdtemp(prefix="cp")
    try:
        loop = cp.ControlPlaneLoop(cp.port_impl(dev), tmp, now=time.time(), cycle=cycle,
                                   **CONTROLPLANE_RECIPE)
        line = {"card": card, "recipe": f"quota_colocation{CONTROLPLANE_RECIPE}"}
        for step in ("cycle_a", "node_metrics", "manager", "webhook", "cycle_b",
                     "deschedule"):
            t0 = time.perf_counter()
            line[step] = (loop.webhook(CONTROLPLANE_SAMPLE) if step == "webhook"
                          else getattr(loop, step)())
            legs_s[step] = time.perf_counter() - t0
        if line["deschedule"]["evicted"] < 1:
            raise AssertionError("controlplane: the migration evicted nothing")
        t0 = time.perf_counter()
        line["servers"] = cp.servers_leg(cp.port_impl(dev), tmp, loop.view,
                                         loop.placed_node_dicts)
        legs_s["servers"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line["cycles"] = cycles
    line["wall_s"] = time.perf_counter() - wall
    line["budget_s"] = CONTROLPLANE_BUDGET_S
    line["legs_s"] = legs_s
    if line["wall_s"] > CONTROLPLANE_BUDGET_S:
        raise AssertionError(f"controlplane: the loop took {line['wall_s']:.1f} s, over its "
                             f"{CONTROLPLANE_BUDGET_S} s budget (legs {legs_s})")
    # the oracle's launches compare: they are not the loop's
    t0 = time.perf_counter()
    line["oracle"] = oracle_leg(cases, dev, counted)
    line["oracle_s"] = time.perf_counter() - t0
    if os.path.exists(tmp):
        raise AssertionError(f"controlplane: {tmp} left behind")
    return line, launches


FAILOVER_BUDGET_S = 60.0
COLDSTART_BUDGET_S = 60.0


def failover_phase(card, lists, headline):
    """The ``failover`` line (phase 22) and each kernel's launches in its
    daemon processes."""
    import os
    import shutil
    import tempfile

    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.harness import failover
    from koordinator_tpu_torch.harness.anchor import cycle_digest, result_digests

    P, N, Q = len(lists[1]), len(lists[0]), len(lists[3])
    want = {"digests": result_digests(headline, P, N, Q),
            "assign": cycle_digest(headline.assignment[:P].cpu(), headline.status[:P].cpu())}
    parent, fs = memory_backed_dir()
    base = tempfile.mkdtemp(prefix=f"{MEMORY_DIR_PREFIX}{os.getpid()}-f", dir=parent)
    try:
        line = failover.failover_leg(base, lists, want, kernel_build_dir=str(_build.BUILD_DIR))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    if line["wall_s"] > FAILOVER_BUDGET_S:
        raise AssertionError(f"failover: the line took {line['wall_s']:.1f} s, over its "
                             f"{FAILOVER_BUDGET_S} s budget")
    launches = {k: line["leg_a_assign"]["launches"][k] + line["leg_b_assign"]["launches"][k]
                for k in line["leg_a_assign"]["launches"]}
    if launches["cycle_wide"] != sum(launches.values()) or launches["cycle_wide"] != 4:
        raise AssertionError(f"failover: the recovered daemons launched {launches}")
    line.update(card=card, filesystem=fs, budget_s=FAILOVER_BUDGET_S, launches=launches,
                snapshot=f"quota_colocation {P} pods x {N} nodes, 16 tenants, seed 0",
                parity="both recovered daemons' Assigns equal phase 4's run_cycle(snap) in "
                       "all five arrays")
    return line, launches


def coldstart_phase(card, dev):
    """The ``coldstart`` line (phase 23) and each kernel's launches in its
    daemon processes."""
    import os
    import shutil
    import tempfile

    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.config import CycleConfig
    from koordinator_tpu_torch.harness import failover, generators as g
    from koordinator_tpu_torch.model.snapshot import snapshot_from_numpy

    lists = g.quota_colocation()
    parent, fs = memory_backed_dir()
    base = tempfile.mkdtemp(prefix=f"{MEMORY_DIR_PREFIX}{os.getpid()}-c", dir=parent)
    build_dir = os.path.join(str(_build.BUILD_DIR), f"coldstart-{os.getpid()}")
    try:
        line = failover.coldstart_leg(base, lists, build_dir=build_dir)
    finally:
        shutil.rmtree(base, ignore_errors=True)
        shutil.rmtree(build_dir, ignore_errors=True)
    cold, warm = line["cold"], line["warm"]
    if not cold["build_dir_files"] or warm["prewarm"]["total"] < 1 or warm["prewarm"][
            "failed"] or warm["prewarm"]["compiled"] != warm["prewarm"]["total"]:
        raise AssertionError(f"coldstart: built {cold['build_dir_files']}, "
                             f"prewarm {warm['prewarm']}")
    launches = {k: cold["launches"][k] + warm["launches"][k] for k in cold["launches"]}
    if launches["cycle_wide"] != sum(launches.values()) or launches["cycle_wide"] != 2:
        raise AssertionError(f"coldstart: the boots launched {launches}")
    line.update(card=card, filesystem=fs, budget_s=COLDSTART_BUDGET_S, launches=launches,
                snapshot="quota_colocation 10000 pods x 2000 nodes, 16 tenants, seed 0")
    if line["wall_s"] > COLDSTART_BUDGET_S:
        raise AssertionError(f"coldstart: the two boots took {line['wall_s']:.1f} s, over "
                             f"their {COLDSTART_BUDGET_S} s budget")
    # the reference's third leg, in this process at the sparse line's scale
    # point (after the budget, as the controlplane line's oracle)
    t0 = time.perf_counter()
    width = 256
    big = snapshot_from_numpy(g.sparse_leaves(1 << 21, 512, n_open=width // 2, seed=16),
                              device=dev)
    line["candidate_build"] = {"nodes": big.nodes.capacity, "pods": big.pods.capacity,
                               "width": width, **failover.candidate_build_leg(
                                   big, CycleConfig(candidate_width=width))}
    del big
    line["candidate_build"]["leg_s"] = time.perf_counter() - t0
    return line, launches


# the mesh line (phase 24)
MESH_BUDGET_S = 90.0
MESH_SHARDS = 4
MESH_DELTAS = 8
MESH_SCORE_K = 32
MESH_SPARSE = {"nodes": 1 << 21, "pods": 512, "width": 256, "seed": 16}
MESH_PER_POD = {"pods": 2048, "nodes": 512}


def sha(t) -> str:
    import hashlib

    import torch

    return hashlib.sha256(
        t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def shard_digests(snap):
    """{leaf name: [sha256 of each shard]} of a mesh-resident snapshot's
    node and pod tensors that a delta can write."""
    return {f"{table}.{f}": [sha(s) for s in getattr(getattr(snap, table), f).shards]
            for table, f in (("nodes", "requested"), ("nodes", "usage"), ("pods", "requests"))}


def resident_bytes(snap, shards):
    """(total bytes, bytes one device holds) of a mesh-resident snapshot,
    by the reference's per-device arithmetic: a split leaf costs its bytes
    over the shard count, a replicated one its whole bytes."""
    from koordinator_tpu_torch.parallel.mesh import snapshot_leaves

    total = per_device = 0
    for leaf in snapshot_leaves(snap):
        n = leaf.numel() * leaf.shards[0].element_size()
        total += n
        split = any(e is not None for e in leaf.sharding.spec)
        per_device += n // shards if split else n
    return total, per_device


def score_bytes(reply) -> bytes:
    """A ScoreReply's bytes without its timing field."""
    reply.build_ms = 0.0
    return reply.SerializeToString()


def mesh_phase(card, dev, snap, lists, headline, wave_rounds):
    """The ``mesh`` line (phase 24): the multi-device path on an in-process
    mesh of ``MESH_SHARDS`` shards on the one card.  Returns (line,
    {kernel: launches on the line})."""
    import numpy as np
    import torch

    from koordinator_tpu_torch import parallel
    from koordinator_tpu_torch.analysis.retrace_guard import retrace_guard
    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.bridge.server import ScorerServicer
    from koordinator_tpu_torch.bridge.state import numpy_to_tensor
    from koordinator_tpu_torch.config import CycleConfig
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.harness.golden import build_sync_request
    from koordinator_tpu_torch.model.snapshot import snapshot_from_numpy
    from koordinator_tpu_torch.solver import (
        build_candidates, dense, kernel_demotions, refresh_candidates, run_cycle,
        score_candidates, wide,
    )

    t_line = time.perf_counter()
    torch.cuda.synchronize()
    dense.reset_launches()
    wide.reset_launches()
    card_dev = dev if dev.type != "cuda" or dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
    mesh = parallel.cluster_mesh([card_dev] * MESH_SHARDS)
    line = {"mesh": {"shards": mesh.size, "distinct_devices": mesh.distinct_devices,
                     "virtual": mesh.distinct_devices < mesh.size,
                     "devices": [str(d) for d in mesh.device_list]}, "card": card}
    P, N = headline.assignment.shape[0], headline.node_requested.shape[0]
    desc = "quota_colocation 10000 pods x 2000 nodes, 16 tenants, seed 0"

    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), (time.perf_counter() - w0) * 1e3

    # (a) the round-based sharded cycle, exact against phase 4's K2
    split = {}
    (res_a, rounds), ev, wall = timed(lambda: parallel.greedy_assign_waves(
        snap, mesh, wave=32, top_m=4, split=split))
    assert_same("mesh (a) greedy_assign_waves", res_a, headline)
    if res_a.path != "shard":
        raise AssertionError(f"mesh (a): path {res_a.path}")
    line["waves"] = {
        "call": f"greedy_assign_waves(snap, cluster_mesh([cuda:0] * {MESH_SHARDS}), wave=32, "
                "top_m=4)", "snapshot": desc, "rounds": rounds, "k3_rounds": wave_rounds,
        "rounds_equal_k3": rounds == wave_rounds,
        "ms_cuda_events": ev, "ms_host_wall": wall,
        "host_reads": split["host_reads"], "host_reads_per_round": split["host_reads"] / rounds,
        "resolve_graphed": split["resolve_graphed"],
        "split_ms": {k[:-2]: v * 1e3 for k, v in split.items() if k.endswith("_s")},
        "parity": "all five arrays equal phase 4's K2 run_cycle(snap)",
    }
    if rounds != wave_rounds:
        line["waves"]["rounds_differ_because"] = (
            "the shard rounds certify with solver/wave.py resolve_wave, the reference's "
            "XLA wave_assign, whose rounds they equal (500 here on the CPU; "
            "tests/test_torch_parallel.py holds them to the JAX package's shard rounds); "
            "K3's count is the Pallas wave kernel's in-kernel certification, another "
            "prefix rule with the same placements")

    line["legs_s"] = {"waves": time.perf_counter() - t_line}
    # (b) the per-pod sharded scan, one max over the shards per pod, at the
    # reference test's 2,048 pods x 512 nodes (tests/test_parallel.py:94-106):
    # at the headline its 10,000 pod steps of eager launches do not fit the
    # line's budget beside (a) and (c)
    t0 = time.perf_counter()
    small = g.loadaware_joint(seed=0, pods=MESH_PER_POD["pods"], nodes=MESH_PER_POD["nodes"])
    from koordinator_tpu_torch.model import encode_snapshot

    snap_b = encode_snapshot(*small, device=dev)
    want_b = run_cycle(snap_b)
    res_b, ev_b, wall_b = timed(lambda: parallel.greedy_assign_sharded(snap_b, mesh))
    assert_same("mesh (b) greedy_assign_sharded", res_b, want_b)
    line["per_pod"] = {"call": "greedy_assign_sharded(snap, mesh)",
                       "snapshot": f"loadaware_joint seed 0, {MESH_PER_POD['pods']} pods x "
                                   f"{MESH_PER_POD['nodes']} nodes",
                       "cut": "the headline's 10,000 pod steps do not fit the line's 90 s "
                              "budget beside (a) and (c)",
                       "ms_cuda_events": ev_b, "ms_host_wall": wall_b,
                       "parity": "all five arrays equal run_cycle(snap) on K2"}
    line["legs_s"]["per_pod"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (c) a mesh-resident servicer against a single-device one
    node_list, pod_list, gangs, quotas = lists
    Pn, Nn = len(pod_list), len(node_list)
    req, _ = build_sync_request(node_list, pod_list, gangs, quotas,
                                node_bucket=Nn, pod_bucket=Pn)
    full = req.SerializeToString()
    # the mesh-resident servicer rescores incrementally whatever the dirt;
    # the single-device one, the oracle, rescores in full
    meshed = ScorerServicer(mesh=mesh, mesh_resident=True, device=dev, score_memo=False,
                            score_incr_max_ratio=1.0)
    single = ScorerServicer(device=dev, score_memo=False, score_incr=False)
    for sv in (meshed, single):
        sv._epoch = sv.telemetry.spans.epoch = "24meshed"
    pair = (meshed, single)

    def both(call):
        out = []
        for sv in pair:
            t0 = time.perf_counter()
            reply = call(sv)
            out.append((reply, (time.perf_counter() - t0) * 1e3))
        return out

    def flat(sv):
        return sv.score(wire.ScoreRequest(snapshot_id=sv.snapshot_id(), top_k=MESH_SCORE_K,
                                          flat=True))

    serv = {"full_sync_bytes": len(full)}
    (m_sync, m_ms), (s_sync, s_ms) = both(lambda sv: sv.sync(wire.SyncRequest.FromString(full)))
    if m_sync.SerializeToString() != s_sync.SerializeToString():
        raise AssertionError(f"mesh (c): full Sync replies differ: {m_sync} vs {s_sync}")
    if meshed.state.active_mesh() is not mesh:
        raise AssertionError("mesh (c): the snapshot is not mesh-resident")
    serv["full_sync_ms"] = {"mesh": m_ms, "single": s_ms}
    snap_m = meshed.state.snapshot()
    total, per_device = resident_bytes(snap_m, mesh.size)
    serv["resident_bytes"] = {"total": total, "per_device": per_device}
    (m_cold, m_ms), (s_cold, s_ms) = both(flat)
    if score_bytes(m_cold) != score_bytes(s_cold):
        raise AssertionError("mesh (c): cold Score replies differ")
    serv["cold_score_ms"] = {"mesh": m_ms, "single": s_ms}
    # the guarded stream's routes are warm: K2 was built before the line, and
    # the shard path builds nothing
    from koordinator_tpu_torch.bridge.state import tensor_to_numpy

    cur = {"node_requested": tensor_to_numpy(req.nodes.requested, None),
           "node_usage": tensor_to_numpy(req.nodes.usage, None),
           "pod_requests": tensor_to_numpy(req.pods.requests, None)}
    kw = dict(cur, node_allocatable=tensor_to_numpy(req.nodes.allocatable, None))
    n_loc = meshed.state.node_bucket // mesh.size
    delta_ms, written = [], []
    with retrace_guard(budget=0) as guard:
        for new, changes in daemon_deltas(kw, MESH_DELTAS, seed=24):
            msg = wire.SyncRequest()
            msg.nodes.requested.CopyFrom(numpy_to_tensor(new["node_requested"],
                                                         cur["node_requested"]))
            msg.nodes.usage.CopyFrom(numpy_to_tensor(new["node_usage"], cur["node_usage"]))
            msg.pods.requests.CopyFrom(numpy_to_tensor(new["pod_requests"],
                                                       cur["pod_requests"]))
            cur = {k: new[k] for k in cur}
            raw = msg.SerializeToString()
            before = shard_digests(meshed.state.snapshot())
            (m_r, m_ms), (s_r, s_ms) = both(lambda sv: sv.sync(wire.SyncRequest.FromString(raw)))
            if m_r.SerializeToString() != s_r.SerializeToString():
                raise AssertionError("mesh (c): delta Sync replies differ")
            if (meshed.state.last_sync_path, single.state.last_sync_path) != ("warm", "warm"):
                raise AssertionError("mesh (c): a delta Sync went cold")
            after = shard_digests(meshed.state.snapshot())
            owners = sorted({int(r) // n_loc for r in changes[0][1]})
            for leaf in ("nodes.requested", "nodes.usage"):
                moved = [i for i, (a, b) in enumerate(zip(before[leaf], after[leaf])) if a != b]
                if moved != owners:
                    raise AssertionError(f"mesh (c): {leaf} shards {moved} changed, owners "
                                         f"{owners}")
            if len(set(after["pods.requests"])) != 1 or after["pods.requests"] == before[
                    "pods.requests"]:
                raise AssertionError("mesh (c): the pod replicas did not move together")
            delta_ms.append({"mesh": m_ms, "single": s_ms})
            written.append(owners)
        # one more delta on a single node row: one shard moves, no other
        node = 2 * n_loc + 7
        new_req = cur["node_requested"].copy()
        new_req[node, 0] += 1
        msg = wire.SyncRequest()
        msg.nodes.requested.CopyFrom(numpy_to_tensor(new_req, cur["node_requested"]))
        cur["node_requested"] = new_req
        raw = msg.SerializeToString()
        before = shard_digests(meshed.state.snapshot())
        (m_r, _), (s_r, _) = both(lambda sv: sv.sync(wire.SyncRequest.FromString(raw)))
        after = shard_digests(meshed.state.snapshot())
        moved = [i for i, (a, b) in enumerate(zip(before["nodes.requested"],
                                                  after["nodes.requested"])) if a != b]
        if m_r.SerializeToString() != s_r.SerializeToString() or moved != [2] or any(
                before[k] != after[k] for k in ("nodes.usage", "pods.requests")):
            raise AssertionError(f"mesh (c): a one-row delta on shard 2 moved shards {moved}")
        serv["one_row_delta_moved_shards"] = moved
        (m_inc, m_ms), (s_inc, s_ms) = both(flat)
        if score_bytes(m_inc) != score_bytes(s_inc):
            raise AssertionError("mesh (c): incremental Score replies differ")
        serv["incremental_score_ms"] = {"mesh": m_ms, "single": s_ms}
        torch.cuda.synchronize()
        before = {"cycle_dense": dense.LAUNCHES, **wide.LAUNCHES}
        ta = time.perf_counter()
        m_as = meshed.assign(wire.AssignRequest(snapshot_id=meshed.snapshot_id()))
        m_ms = (time.perf_counter() - ta) * 1e3
        torch.cuda.synchronize()
        shard_launches = {k: v - before[k] for k, v in
                          {"cycle_dense": dense.LAUNCHES, **wide.LAUNCHES}.items()}
        ta = time.perf_counter()
        s_as = single.assign(wire.AssignRequest(snapshot_id=single.snapshot_id()))
        s_ms = (time.perf_counter() - ta) * 1e3
    if m_as.path != "shard" or any(shard_launches.values()):
        raise AssertionError(f"mesh (c): the mesh Assign took path {m_as.path}, launched "
                             f"{shard_launches}")
    if (list(m_as.assignment), list(m_as.status)) != (list(s_as.assignment),
                                                        list(s_as.status)):
        raise AssertionError("mesh (c): Assign replies differ")
    incr = meshed.telemetry.registry.get("koord_scorer_score_incr_total", {"result": "incr"})
    if not incr:
        raise AssertionError("mesh (c): the incremental Score did not run incrementally: " + str(
            {r: meshed.telemetry.registry.get("koord_scorer_score_incr_total", {"result": r})
             for r in ("incr", "full", "fallback")}))
    demotions = {k: v for k, v in kernel_demotions().items() if k[0] == "shard"}
    if demotions:
        raise AssertionError(f"mesh (c): shard demotions {demotions}")
    serv.update(delta_ms=delta_ms, delta_owner_shards=written,
                assign_ms={"mesh": m_ms, "single": s_ms},
                assign_rounds=int(meshed.last_cycle.rounds),
                assign_path={"mesh": m_as.path, "single": s_as.path},
                builds=guard.compiles, demotions=guard.traces,
                incremental_scores=incr,
                parity="Sync, Score (cold, incremental; build_ms zeroed) and Assign "
                       "(assignment, status) replies equal the single-device servicer's; "
                       "each delta moved only its owning node shards and every pod replica")
    line["servicer"] = serv
    line["legs_s"]["servicer"] = time.perf_counter() - t0

    # (d) the sparse candidate engine on a pod mesh, against one device
    t0 = time.perf_counter()
    sp = MESH_SPARSE
    cfg = CycleConfig(candidate_width=sp["width"])
    big = snapshot_from_numpy(g.sparse_leaves(sp["nodes"], sp["pods"],
                                              n_open=sp["width"] // 2, seed=sp["seed"]),
                              device=dev)
    pmesh = parallel.pod_mesh([card_dev] * MESH_SHARDS)
    (cand_s, count_s), b_ev, _ = timed(lambda: build_candidates(big, cfg, mesh=pmesh))
    cand, count = build_candidates(big, cfg)
    same = lambda a, b: torch.equal(parallel.mesh.gather(a), parallel.mesh.gather(b))  # noqa: E731
    if not (same(cand_s, cand) and same(count_s, count)):
        raise AssertionError("mesh (d): the pod-mesh build differs from one device's")
    rng = np.random.default_rng(sp["seed"])
    rows = sorted(rng.choice(big.nodes.capacity, 64, replace=False).tolist())
    (ref_s, r_ev, _) = timed(lambda: refresh_candidates(big, cand_s, count_s, rows, [300],
                                                        cfg, mesh=pmesh))
    ref_1 = refresh_candidates(big, cand, count, rows, [300], cfg)
    if not all(same(a, b) for a, b in zip(ref_s, ref_1)):
        raise AssertionError("mesh (d): the pod-mesh refresh differs from one device's")
    (sc_s, s_ev, _) = timed(lambda: score_candidates(big, cand_s, cfg, mesh=pmesh))
    sc_1 = score_candidates(big, cand, cfg)
    if not all(same(a, b) for a, b in zip(sc_s, sc_1)):
        raise AssertionError("mesh (d): the pod-mesh Score differs from one device's")
    line["sparse"] = {"nodes": big.nodes.capacity, "pods": big.pods.capacity,
                      "width": sp["width"], "pod_mesh_shards": pmesh.size,
                      "build_ms": b_ev, "refresh_64_nodes_1_pod_ms": r_ev, "score_ms": s_ev,
                      "parity": "build, refresh and Score byte-equal to the single-device "
                                "engine"}
    line["legs_s"]["sparse"] = time.perf_counter() - t0
    del big
    torch.cuda.synchronize()
    launches = {"cycle_dense": dense.LAUNCHES, **wide.LAUNCHES}
    line["wall_s"] = time.perf_counter() - t_line
    line["budget_s"] = MESH_BUDGET_S
    if line["wall_s"] > MESH_BUDGET_S:
        print(json.dumps({"mesh_over_budget": line}), file=sys.stderr)
        raise AssertionError(f"mesh: the line took {line['wall_s']:.1f} s, over its "
                             f"{MESH_BUDGET_S} s budget")
    return line, launches


ONLY_LINES = ("trace", "failover", "coldstart", "mesh")


def only_lines(names) -> int:
    """``python3 chip_smoke.py --only trace,failover,coldstart,mesh``: those
    lines alone, after the card line, the kernels' builds and phase 4's
    headline ``run_cycle(snap)`` (exact against ``greedy_assign``), which
    the ``failover`` line holds its recovered daemons to and the ``mesh``
    line its sharded cycles (with the wave headline's K3 rounds)."""
    import torch

    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.config import CycleConfig
    from koordinator_tpu_torch.harness import generators as g
    from koordinator_tpu_torch.solver import dense, greedy_assign, run_cycle, wide

    unknown = set(names) - set(ONLY_LINES)
    if unknown:
        print(f"chip_smoke: --only takes {','.join(ONLY_LINES)}, not {sorted(unknown)}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    phase_s = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build, (dense.KERNEL_SOURCE, wide.KERNEL_SOURCE)))
    snap, *cluster_lists, _ = g.quota_colocation_snapshot(device=torch.device("cuda"))
    result = run_cycle(snap)
    oracle = greedy_assign(snap)
    assert_same("headline", result, oracle)
    result_w = run_cycle(snap, CycleConfig(**WAVE_CFG))
    assert_same("wave headline", result_w, oracle)
    phase_s["headline"] = time.perf_counter() - t0
    for name in names:
        t0 = time.perf_counter()
        if name == "trace":
            line, _ = trace_phase(card, torch.device("cuda"))
        elif name == "failover":
            line, _ = failover_phase(card, cluster_lists, result)
        elif name == "mesh":
            line, _ = mesh_phase(card, torch.device("cuda"), snap, cluster_lists, result,
                                 int(result_w.rounds))
        else:
            line, _ = coldstart_phase(card, torch.device("cuda"))
        print(json.dumps({name: line}))
        phase_s[name] = time.perf_counter() - t0
    print(json.dumps({"phase_seconds": phase_s}))
    print(card_line())
    print(json.dumps({"ok": True, "only": list(names), "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3:
        return only_lines(sys.argv[2].split(","))

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
    trace_line, trace_launches = trace_phase(card, dev)
    print(json.dumps({"trace": trace_line}))
    phase_done("12_trace")

    # phase 13: the extended-plugin cycle
    extras_line, extras_launches, extras_state = extras_phase(card, dev, counted, only)
    print(json.dumps({"extras": extras_line}))
    phase_done("13_extras")

    # phase 14: the rebalance leg
    rebalance_line, k2_rebalance = rebalance_phase(card, dev, counted, only, snap,
                                                   cluster_lists, oracle)
    print(json.dumps({"rebalance": rebalance_line}))
    phase_done("14_rebalance")

    # phase 15: the daemon and its follower
    daemon_line, k2_daemon = daemon_phase(card, dev, cluster_lists, result, snap)
    print(json.dumps({"daemon": daemon_line}))
    phase_done("15_daemon")

    # phase 16: the chaos x trace gate and ChaosTier
    chaos_line, k2_chaos = chaos_phase(card, dev, cluster_lists)
    print(json.dumps({"chaos": chaos_line}))
    phase_done("16_chaos")

    # phase 17: the relay tree
    tree_line, k2_tree = tree_phase(card, dev, cluster_lists)
    print(json.dumps({"tree": tree_line}))
    phase_done("17_tree")

    # phase 18: the PostFilter and the reservation tick
    preempt_line, k2_preempt = preempt_phase(card, dev, extras_state)
    print(json.dumps({"preempt": preempt_line}))
    phase_done("18_preempt")

    # phase 19: koordlint over the port and the witnessed chaos replay
    lint_line, k2_lint = lint_phase(card, dev, chaos_line["accelerator"]["wall_s"])
    print(json.dumps({"lint": lint_line}))
    phase_done("19_lint")

    # phase 20: the node agent's reports feeding the extras cycle
    koordlet_line, k2_koordlet = koordlet_phase(card, dev, counted, only)
    print(json.dumps({"koordlet": koordlet_line}))
    phase_done("20_koordlet")

    # phase 21: the co-location control loop around the scheduler
    controlplane_line, controlplane_launches = controlplane_phase(card, dev, counted, cases)
    print(json.dumps({"controlplane": controlplane_line}))
    phase_done("21_controlplane")

    # phase 22: the journal warm restart and the promotion, daemons in processes
    failover_line, failover_launches = failover_phase(card, cluster_lists, result)
    print(json.dumps({"failover": failover_line}))
    phase_done("22_failover")

    # phase 23: cold and prewarmed boots, and the cold candidate builds
    coldstart_line, coldstart_launches = coldstart_phase(card, dev)
    print(json.dumps({"coldstart": coldstart_line}))
    phase_done("23_coldstart")

    # phase 24: the multi-device path on an in-process mesh on the card
    mesh_line, mesh_launches = mesh_phase(card, dev, snap, cluster_lists, result,
                                          int(result_w.rounds))
    print(json.dumps({"mesh": mesh_line}))
    phase_done("24_mesh")

    # phase 10
    print(json.dumps({"phase_seconds": phase_s}))
    # each kernel's launches on every line that drives a path
    lines = ("trace", "extras", "rebalance", "daemon", "chaos", "tree", "preempt", "lint",
             "koordlet", "controlplane", "failover", "coldstart", "mesh")
    cp_n = controlplane_launches
    fo_n, cs_n, me_n = failover_launches, coldstart_launches, mesh_launches
    entries = (
        ("cycle_dense", "koordinator_tpu_torch/solver/cycle_cuda.cu",
         "koordinator_tpu/solver/pallas_dense.py:114", k1_launches,
         (0, extras_launches["K1"], 0, 0, 0, 0, 0, 0, 0, cp_n["cycle_dense"],
          fo_n["cycle_dense"], cs_n["cycle_dense"], me_n["cycle_dense"]), k1_err, k1_ms,
         k1_plain_ms, k1_bound, k1_bound_by),
        ("cycle_wide", "koordinator_tpu_torch/solver/cycle_cuda.cu",
         "koordinator_tpu/solver/pallas_cycle.py:180", k2_launches,
         (trace_launches["cycle_wide"], extras_launches["K2"], k2_rebalance, k2_daemon, k2_chaos,
          k2_tree, k2_preempt, k2_lint, k2_koordlet, cp_n["cycle_wide"], fo_n["cycle_wide"],
          cs_n["cycle_wide"], me_n["cycle_wide"]), k2_err, k2_ms,
         k2_plain_ms, k2_bound, k2_bound_by),
        ("wave_cycle", "koordinator_tpu_torch/solver/cycle_wide_cuda.cu",
         "koordinator_tpu/solver/pallas_cycle.py:347", k3_launches,
         (trace_launches["wave_cycle"], 0, 0, 0, 0, 0, 0, 0, 0, cp_n["wave_cycle"],
          fo_n["wave_cycle"], cs_n["wave_cycle"], me_n["wave_cycle"]), k3_err, k3_ms,
         k3_plain_ms, k3_bound, k3_bound_by),
    )
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        **{f"{ln}_launches": n for ln, n in zip(lines, per_line)},
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no PyTorch call computes a sequential greedy assignment
        "library_ms": None, "parity": "exact",
    } for name, source, replaces, launches, per_line, err, ms, plain_ms, bound_ms, bound_by
        in entries]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
