"""The int32 Assign cycle kernels: the per-pod wide rung and the
wave-batched cycle, their wrappers and their plain PyTorch versions.

Counterpart of ``koordinator_tpu/solver/pallas_cycle.py``
(``greedy_assign_pallas`` -> ``_run_cycle`` -> the Pallas kernels
``_cycle_kernel`` and ``_wave_cycle_kernel``), the way ``dense.py`` stands
for ``pallas_dense.py``.  The host preparation is ``dense.py``'s
(``prepare_cycle_inputs``: queue order, non-zero score requests, LoadAware
masks and score usage, the prod split, the weights, ``xcomb``), narrowed to
int32: both kernels compute in 32-bit integers, as the TPU kernels do, so
they take only snapshots that ``inputs_fit_i32`` admits and extra scores
below 2^29 (``xcomb`` is int32 with ``I32_MIN`` as the masked sentinel).  The
TPU kernels' lane packing (flags and ``req0`` in spare lanes, one-hot lane
extraction) is a VMEM-layout device and is not carried over.

* ``cfg.wave <= 1``: ``cycle_wide`` — the same function as the dense
  cycle (per pod: Filter, Score, argmax with the lowest index, Reserve).
* ``cfg.wave > 1``: ``wave_cycle`` — the wave-batched cycle with the TPU
  kernel's own rules, which set its round count: pods run in blocks of 128
  in queue order and a wave never crosses a block end; ``W = min(wave,
  128)``; ``M = max(1, min(top_m, ceil(N / 8) * 8, 128))``; a round freezes
  each wave pod's top-M (score, node) pairs against the round-start state,
  then resolves the wave in queue order against the live state (re-key,
  certify against the frozen M-th pair with a lexicographic (score, index)
  compare, node-invariant quota recheck, Reserve) and commits the queue
  prefix.  Under MostAllocated the re-keyed set is the pod's own top-M plus
  the nodes committed to earlier in the round.  ``rounds`` is the sum over
  blocks.

On CUDA tensors the wrappers launch the kernels, one launch of one
thread-block cluster per cycle each: the per-pod kernel is the int32
instantiation of the dense kernel's templated body (``cycle_cuda.cu``,
``CYCLE_WIDE_SOURCE``), the wave kernel lives in ``cycle_wide_cuda.cu``
(``KERNEL_SOURCE``); on CPU tensors they run the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.config import DEFAULT_CYCLE_CONFIG, MOST_ALLOCATED, CycleConfig
from koordinator_tpu_torch.model.snapshot import ClusterSnapshot
from koordinator_tpu_torch.solver import dense
from koordinator_tpu_torch.solver.dense import FLAG_FRESH, FLAG_OK, FLAG_PROD_OK, CycleInputs
from koordinator_tpu_torch.solver.greedy import (
    INT64_MIN,
    CycleResult,
    finish_cycle,
    step_feasible_scores,
)

KERNEL_SOURCE = "solver/cycle_wide_cuda.cu"  # the wave kernel
# the per-pod kernel: the int32 instantiation of the dense kernel's body
CYCLE_WIDE_SOURCE = dense.KERNEL_SOURCE

I32_MIN = torch.iinfo(torch.int32).min
# extra scores ride xcomb as int32 next to the I32_MIN sentinel
EXTRA_SCORES_LIMIT = 2**29

# the TPU kernel's pod block (its grid step): waves stop at its ends
BLOCK = 128
# W and M are capped at the TPU kernel's 128 lanes
MAX_LANES = 128

# Launches of each kernel in this process; a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"cycle_wide": 0, "wave_cycle": 0}

# CycleInputs fields that are int64 on the dense path and int32 here
_NARROWED = ("preq", "psreq", "pest", "alloc", "req0", "usage", "uprod",
             "qrt", "quse0", "weights")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The int32 kernels multiply clamped free capacity by MAX_NODE_SCORE (100),
# so scored values need that much headroom below 2^31; quota rows are only
# added and compared, so they need room for every request of the cycle.
_I32_SCORED_LIMIT = 2**31 // 100
_I32_QUOTA_LIMIT = 2**31 - 2**27


def check_i32_bounds(maxima) -> bool:
    """``maxima``: (scored_max, quota_max, est_sum_max, req_sum_max).

    Bounds the kernels' accumulators, not only their inputs: LoadAware sums
    usage and every assigned pod's estimate on one node, and a quota's used
    row sums every assigned request of the cycle."""
    scored_max, quota_max, est_sum_max, req_sum_max = (int(v) for v in maxima)
    return (
        scored_max < _I32_SCORED_LIMIT
        and quota_max + req_sum_max < _I32_QUOTA_LIMIT
        and scored_max + est_sum_max < _I32_SCORED_LIMIT
    )


def inputs_fit_i32(snapshot: ClusterSnapshot) -> bool:
    """True when the int32 kernels are exact on ``snapshot``; out-of-range
    inputs must not reach them (truncation would change placements
    silently).  The four maxima come back in one device-to-host read."""
    nodes, pods, quotas = snapshot.nodes, snapshot.pods, snapshot.quotas

    def peak(tensors):
        return torch.stack([t.abs().max() for t in tensors]).max()

    maxima = torch.stack([
        peak((nodes.allocatable, nodes.requested, nodes.usage, pods.requests,
              pods.estimated)),
        peak((quotas.runtime, quotas.used)),
        pods.estimated.abs().sum(0).max(),
        pods.requests.abs().sum(0).max(),
    ]).tolist()
    return check_i32_bounds(maxima)


def extra_scores_peak(extra_scores: Optional[torch.Tensor]) -> Optional[int]:
    """``max |extra_scores|`` as a Python int (exact for INT64_MIN, which
    ``abs`` wraps), 0 for an empty tensor, None without extra scores."""
    if extra_scores is None:
        return None
    if extra_scores.numel() == 0:
        return 0
    lo, hi = torch.aminmax(extra_scores)
    return max(int(hi), -int(lo))


def prepare_wide_inputs(
    snapshot: ClusterSnapshot,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    extra_mask: Optional[torch.Tensor] = None,
    extra_scores: Optional[torch.Tensor] = None,
) -> CycleInputs:
    """``dense.prepare_cycle_inputs`` with every int64 tensor narrowed to
    int32.  Exact only for snapshots that ``inputs_fit_i32`` admits."""
    inp = dense.prepare_cycle_inputs(snapshot, cfg, extra_mask, extra_scores)
    narrowed = {k: getattr(inp, k).to(torch.int32).contiguous() for k in _NARROWED}
    if inp.xcomb is not None:
        x = inp.xcomb
        narrowed["xcomb"] = torch.where(x == INT64_MIN, I32_MIN, x).to(torch.int32)
    return dataclasses.replace(inp, **narrowed)


def wave_dims(n_nodes: int, wave: int, top_m: int):
    """(W, M) of the wave cycle: the TPU kernel's caps, with M counting the
    node rows padded to a multiple of 8."""
    n_pad8 = -(-n_nodes // 8) * 8
    return min(wave, MAX_LANES), max(1, min(top_m, n_pad8, MAX_LANES))


def _widen(inp: CycleInputs) -> CycleInputs:
    widened = {k: getattr(inp, k).long() for k in _NARROWED}
    if inp.xcomb is not None:
        x = inp.xcomb.long()
        widened["xcomb"] = torch.where(x == I32_MIN, INT64_MIN, x)
    return dataclasses.replace(inp, **widened)


def cycle_wide_reference(inp: CycleInputs, cfg: CycleConfig):
    """The plain PyTorch version of the per-pod wide kernel: the same
    function as the dense cycle, on the int32 inputs.  Within the bounds of
    ``check_i32_bounds`` no int32 intermediate of the kernel overflows, so
    the exact int64 plain loop gives its results.

    Returns (chosen i32[P] in queue order, nreq i32[R, N], nest i32[R, N],
    quse i32[Q, R])."""
    chosen, nreq, nest, quse = dense.cycle_dense_reference(_widen(inp), cfg)
    return chosen, nreq.to(torch.int32), nest.to(torch.int32), quse.to(torch.int32)


def _masked_scores(inp, cfg, nreq, nest, pods, nodes=None) -> torch.Tensor:
    """Filter and Score of each queue slot in ``pods`` against ``nodes``
    (all when None) on the state (nreq, nest), through the oracle's
    ``step_feasible_scores``: i64[len(pods), K], the score or I32_MIN where
    the node fails Fit, its LoadAware flag or the extra mask.  Pod validity
    and quota are not applied here."""
    cols = slice(None) if nodes is None else nodes

    def pod_rows(t):  # [B, 1, R], broadcast against the [K, R] node block
        return t[pods].long()[:, None, :]

    def node_rows(t):  # [R, N] -> [K, R]
        return t[:, cols].t().long()

    prod = (inp.pprod[pods] != 0)[:, None]  # [B, 1]
    flags = inp.flags[cols]
    ok = torch.where(prod, (flags & FLAG_PROD_OK) != 0, (flags & FLAG_OK) != 0)
    usage = torch.where(prod[:, :, None], node_rows(inp.uprod), node_rows(inp.usage))
    feasible, total = step_feasible_scores(
        node_rows(nreq), node_rows(nest), inp.quse0, node_rows(inp.alloc), usage,
        (flags & FLAG_FRESH) != 0, ok, pod_rows(inp.preq), pod_rows(inp.psreq),
        pod_rows(inp.pest), -1, True, inp.qrt, inp.qlim, cfg,
    )
    if inp.xcomb is not None:
        x = inp.xcomb[pods][:, cols].long()
        feasible = feasible & (x != I32_MIN)
        total = total + x
    return torch.where(feasible, total, I32_MIN)


def _top_m(scores: torch.Tensor, M: int):
    """Each row's top-M (score, node) pairs by (score desc, node asc), as
    the TPU kernel picks them: once only infeasible nodes remain, the
    remaining slots are the sentinel pair (I32_MIN, 0)."""
    B, N = scores.shape
    k = min(M, N)
    idx = torch.arange(N, dtype=torch.int64, device=scores.device)
    # unique keys: topk returns the same pairs whatever its tie rule
    key, _ = torch.topk(scores * N + (N - 1 - idx), k, dim=1)
    s = torch.div(key, N, rounding_mode="floor")
    i = torch.where(s == I32_MIN, 0, N - 1 - (key - s * N))
    if k < M:
        s = torch.cat([s, torch.full((B, M - k), I32_MIN, dtype=s.dtype, device=s.device)], 1)
        i = torch.cat([i, torch.zeros((B, M - k), dtype=i.dtype, device=i.device)], 1)
    return s.tolist(), i.tolist()


def wave_cycle_reference(inp: CycleInputs, cfg: CycleConfig, wave: int, top_m: int,
                         stats: Optional[dict] = None):
    """The plain PyTorch version of the wave cycle kernel: the same inputs,
    outputs and round count, phase A as one [W, N] tensor op per round,
    phase B as an eager loop in queue order.  Exact int64 arithmetic on the
    int32 inputs (see ``cycle_wide_reference``).  ``stats``, when given,
    receives the work the kernel does on these inputs: ``frozen_cells``
    (phase-A pod x node scores) and ``rekeys`` (phase-B node scores).

    Returns (chosen i32[P], nreq i32[R, N], nest i32[R, N], quse i32[Q, R],
    rounds i32[1])."""
    P = inp.preq.shape[0]
    N = inp.alloc.shape[1]
    dev = inp.alloc.device
    W, M = wave_dims(N, wave, top_m)
    most = cfg.enable_fit_score and cfg.fit_scoring_strategy == MOST_ALLOCATED
    nreq = inp.req0.long().clone()
    nest = torch.zeros_like(nreq)
    quse = inp.quse0.long().clone()
    qrt = inp.qrt.long()
    qlim = inp.qlim != 0
    pvalid = inp.pvalid.tolist()
    qids = inp.qid.tolist()
    chosen = [-1] * P
    rounds = frozen_cells = rekeys = 0
    for base in range(0, P, BLOCK):
        ptr = 0
        while ptr < BLOCK:
            # phase A: freeze the wave's top-M against the round-start state
            live = [w for w in range(W)
                    if ptr + w < BLOCK and base + ptr + w < P and pvalid[base + ptr + w]]
            cand_s = [[I32_MIN] * M for _ in range(W)]
            cand_i = [[0] * M for _ in range(W)]
            if live:
                frozen_cells += len(live) * N
                pods = torch.tensor([base + ptr + w for w in live], device=dev)
                s, i = _top_m(_masked_scores(inp, cfg, nreq, nest, pods), M)
                for row, w in enumerate(live):
                    cand_s[w], cand_i[w] = s[row], i[row]

            # phase B: resolve in queue order against the live state
            ncommit = 0
            taken = []  # nodes committed to earlier in this round
            for w in range(W):
                j = ptr + w
                p = base + j
                if j >= BLOCK or p >= P or not pvalid[p]:
                    ncommit += 1  # node-independent -1: always certified
                    continue
                req = inp.preq[p].long()
                qid = qids[p]
                if qid >= 0 and bool((qlim[qid] & (quse[qid] + req > qrt[qid])).any()):
                    chosen[p] = -1  # quota-blocked: node-independent
                    ncommit += 1
                    continue
                nodes = [c for fs, c in zip(cand_s[w], cand_i[w]) if fs != I32_MIN]
                if most:
                    nodes += taken
                # lexicographic (max score, min index), seeded (I32_MIN, 0)
                bs, bi = I32_MIN, 0
                if nodes:
                    rekeys += len(nodes)
                    pod = torch.tensor([p], device=dev)
                    cols = torch.tensor(nodes, device=dev)
                    scores = _masked_scores(inp, cfg, nreq, nest, pod, cols)[0].tolist()
                    for cs, c in zip(scores, nodes):
                        if cs > bs or (cs == bs and c < bi):
                            bs, bi = cs, c
                ks, ki = cand_s[w][M - 1], cand_i[w][M - 1]
                certified = (bs > ks or (bs == ks and bi <= ki) or ks == I32_MIN
                             or (most and w == 0))
                if not certified:
                    break  # ends the commit prefix; reruns next round
                choice = bi if bs > I32_MIN else -1
                chosen[p] = choice
                if choice >= 0:
                    nreq[:, choice] += req
                    nest[:, choice] += inp.pest[p].long()
                    if qid >= 0:
                        quse[qid] += req
                    taken.append(choice)
                ncommit += 1
            ptr += ncommit
            rounds += 1
    if stats is not None:
        stats.update(frozen_cells=frozen_cells, rekeys=rekeys)
    return (
        torch.tensor(chosen, dtype=torch.int32, device=dev),
        nreq.to(torch.int32),
        nest.to(torch.int32),
        quse.to(torch.int32),
        torch.tensor([rounds], dtype=torch.int32, device=dev),
    )


_COMMON_ARGTYPES = (
    [ctypes.c_int] * 4  # P, N, R, Q
    + [ctypes.c_void_p] * 13  # preq .. weights
    + [ctypes.c_int] * 4  # fit_wsum, la_wsum, fit_pw, la_pw
    + [ctypes.c_int] * 3  # most_allocated, enable_fit, enable_la
    + [ctypes.c_void_p] * 5  # xcomb, chosen, nreq, nest, quse
)
_WIDE_ARGTYPES = _COMMON_ARGTYPES + [ctypes.c_void_p] * 3  # magic, shift, stream
_WAVE_ARGTYPES = (
    _COMMON_ARGTYPES
    + [ctypes.c_int] * 2  # wave, top_m
    + [ctypes.c_void_p] * 4  # magic, shift, rounds, stream
)
_WIDE_PLAN_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_WAVE_PLAN_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _checked_common(inp: CycleInputs, cfg: CycleConfig, what: str):
    """Check the inputs as the kernels take them; allocate the outputs;
    return the leading arguments shared by both entry points."""
    dense.check_kernel_inputs(inp, what, torch.int32)
    dev = inp.alloc.device
    P, R = inp.preq.shape
    N = inp.alloc.shape[1]
    outs = (
        torch.empty(P, dtype=torch.int32, device=dev),
        inp.req0.clone(),
        torch.zeros_like(inp.req0),
        inp.quse0.clone(),
    )
    fit_wsum, la_wsum = dense.weight_sums(cfg)
    args = (
        P, N, R, inp.qrt.shape[0],
        inp.preq.data_ptr(), inp.psreq.data_ptr(), inp.pest.data_ptr(),
        inp.qid.data_ptr(), inp.pvalid.data_ptr(), inp.pprod.data_ptr(),
        inp.alloc.data_ptr(), inp.usage.data_ptr(), inp.uprod.data_ptr(),
        inp.flags.data_ptr(), inp.qrt.data_ptr(), inp.qlim.data_ptr(),
        inp.weights.data_ptr(),
        fit_wsum, la_wsum, cfg.fit_plugin_weight, cfg.loadaware_plugin_weight,
        int(cfg.fit_scoring_strategy == MOST_ALLOCATED),
        int(cfg.enable_fit_score), int(cfg.enable_loadaware),
        inp.xcomb.data_ptr() if inp.xcomb is not None else None,
    ) + tuple(t.data_ptr() for t in outs)
    return outs, args


def wide_plan(inp: CycleInputs) -> dict:
    """The cluster plan the per-pod kernel takes for ``inp``
    (``dense.read_plan``)."""
    R, N = inp.alloc.shape
    fn = _build.entry(CYCLE_WIDE_SOURCE, "koord_wide_plan", _WIDE_PLAN_ARGTYPES)
    with torch.cuda.device(inp.alloc.device):
        return dense.read_plan(fn, N, R, inp.qrt.shape[0], dense.uprod_shared(inp))


def cycle_wide_cuda(inp: CycleInputs, cfg: CycleConfig, defines=()):
    """Launch the per-pod wide kernel on the current stream; same outputs
    as ``cycle_wide_reference``.  Raises on a bad input or a refused launch.
    ``defines=_build.PHASE_CLOCK`` launches the instrumented build of the
    same source (``wide_phase_cycles``)."""
    outs, args = _checked_common(inp, cfg, "cycle_wide_cuda")
    dev = inp.alloc.device
    R, N = inp.alloc.shape
    fn = _build.entry(CYCLE_WIDE_SOURCE, "koord_wide_cycle_launch", _WIDE_ARGTYPES, defines)
    magic, shift = dense.reciprocal_tables(wide_plan(inp), R, N, torch.int32, dev)
    with torch.cuda.device(dev):
        err = fn(*args, None if magic is None else magic.data_ptr(),
                 None if shift is None else shift.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wide cycle kernel launch failed: cudaError {err}")
    LAUNCHES["cycle_wide"] += 1
    return outs


def wide_phase_cycles():
    """The instrumented build's clock64 counters of the per-pod kernel,
    summed since the last read (reading resets them), as
    ``dense.phase_cycles`` gives the dense kernel's: rank 0's pod-step
    cycles of quota and Filter/Score, of staging the next pod, of the
    reduction and barrier, and of the merge and Reserve."""
    return _build.read_counters(CYCLE_WIDE_SOURCE, "koord_wide_phase_cycles", 4)


def wave_plan(inp: CycleInputs, wave: int, top_m: int) -> dict:
    """The cluster plan the wave kernel takes for ``inp``
    (``dense.read_plan``)."""
    R, N = inp.alloc.shape
    W, M = wave_dims(N, wave, top_m)
    fn = _build.entry(KERNEL_SOURCE, "koord_wave_plan", _WAVE_PLAN_ARGTYPES)
    with torch.cuda.device(inp.alloc.device):
        return dense.read_plan(fn, N, R, inp.qrt.shape[0], W, M, dense.uprod_shared(inp))


def wave_cycle_cuda(inp: CycleInputs, cfg: CycleConfig, wave: int, top_m: int, defines=()):
    """Launch the wave cycle kernel on the current stream; same outputs as
    ``wave_cycle_reference``.  Raises on a bad input or a refused launch.
    ``defines=_build.PHASE_CLOCK`` launches the instrumented build of the
    same source (``wave_phase_cycles``)."""
    if wave < 2 or top_m < 1:
        raise ValueError(f"wave cycle takes wave >= 2 and top_m >= 1, got {wave}, {top_m}")
    outs, args = _checked_common(inp, cfg, "wave_cycle_cuda")
    dev = inp.alloc.device
    R, N = inp.alloc.shape
    W, M = wave_dims(N, wave, top_m)
    magic, shift = dense.reciprocal_tables(wave_plan(inp, wave, top_m), R, N, torch.int32, dev)
    rounds = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = _build.entry(KERNEL_SOURCE, "koord_wave_cycle_launch", _WAVE_ARGTYPES, defines)
    with torch.cuda.device(dev):
        err = fn(*args, W, M,
                 None if magic is None else magic.data_ptr(),
                 None if shift is None else shift.data_ptr(), rounds.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wave cycle kernel launch failed: cudaError {err}")
    LAUNCHES["wave_cycle"] += 1
    return outs + (rounds,)


def wave_phase_cycles():
    """The instrumented build's leader-thread cycles summed over the rounds
    since the last read, as (phase A, merge, phase B, the staging within
    phase A, the re-keys within phase B); reading resets them."""
    return _build.read_counters(KERNEL_SOURCE, "koord_wave_phase_cycles", 5)


def run_wide(inp: CycleInputs, cfg: CycleConfig):
    """The cycle on ``inp``'s device — the wave cycle when ``cfg.wave > 1``,
    else the per-pod one: the kernel on CUDA tensors, the plain version on
    CPU tensors.  Returns (chosen, nreq, nest, quse, rounds or None)."""
    cpu = inp.alloc.device.type == "cpu"
    if cfg.wave > 1:
        fn = wave_cycle_reference if cpu else wave_cycle_cuda
        return fn(inp, cfg, cfg.wave, cfg.top_m)
    return (cycle_wide_reference if cpu else cycle_wide_cuda)(inp, cfg) + (None,)


def wide_result(snapshot: ClusterSnapshot, inp: CycleInputs, outs, path: str) -> CycleResult:
    """The ``CycleResult`` of a wide or wave cycle's outputs ``outs``
    (chosen, nreq, nest, quse, rounds or None)."""
    chosen, nreq, nest, quse, rounds = outs
    return finish_cycle(
        snapshot, inp.order, chosen, nreq.t().long().contiguous(),
        nest.t().long().contiguous(), quse.long(), path=path,
        rounds=None if rounds is None else rounds[0].long(),
    )


def greedy_assign_wide(
    snapshot: ClusterSnapshot,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    extra_mask: Optional[torch.Tensor] = None,  # bool[P, N]
    extra_scores: Optional[torch.Tensor] = None,  # i64[P, N]
    i32_ok: Optional[bool] = None,
    scores_hi: Optional[int] = None,
) -> CycleResult:
    """Drop-in for ``greedy_assign`` through the int32 kernels: the wave
    cycle (``rounds`` set) when ``cfg.wave > 1``, else the per-pod wide
    cycle.  ``path="cuda"`` on a CUDA snapshot, ``path="scan"`` (the plain
    version) on a CPU snapshot.  Placements and state equal
    ``greedy_assign``'s.

    Raises ``ValueError`` on inputs the int32 kernels cannot take exactly:
    a snapshot that ``inputs_fit_i32`` refuses, or extra scores of
    magnitude >= 2^29.  ``i32_ok`` and ``scores_hi`` (``extra_scores_peak``)
    are for callers that already computed them."""
    if i32_ok is None:
        i32_ok = inputs_fit_i32(snapshot)
    if not i32_ok:
        raise ValueError("snapshot values out of the int32 kernels' range "
                         "(inputs_fit_i32); use greedy_assign_dense")
    if scores_hi is None:
        scores_hi = extra_scores_peak(extra_scores)
    if scores_hi is not None and scores_hi >= EXTRA_SCORES_LIMIT:
        raise ValueError(
            f"extra_scores magnitude {scores_hi} >= 2^29: out of the int32 "
            "kernels' extra-score range; use greedy_assign_dense"
        )
    inp = prepare_wide_inputs(snapshot, cfg, extra_mask, extra_scores)
    path = "scan" if inp.alloc.device.type == "cpu" else "cuda"
    return wide_result(snapshot, inp, run_wide(inp, cfg), path)
