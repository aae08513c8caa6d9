"""The single-launch Assign cycle: host preparation, the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``koordinator_tpu/solver/pallas_dense.py``
(``greedy_assign_dense`` -> ``_run_cycle_dense`` -> the Pallas kernel
``_cycle_kernel_dense``).  The host side is the same preparation: queue
order, non-zero score requests, LoadAware masks and score usage, the prod
split, the weights, and the combined extra-plugin tensor ``xcomb``.  The
cycle itself is ``cycle_dense``: on CUDA tensors it launches the kernel in
``cycle_cuda.cu`` (one launch of one thread-block cluster per cycle); on
CPU tensors it runs ``cycle_dense_reference``, the plain version with the
same inputs and outputs.  Gang status is applied after the cycle.

Layouts: pod rows are [P, R] in queue order; node tensors are
resource-major [R, N] so that the kernel's threads, one per node, read
each resource coalesced; node flags are one bit-packed byte per node.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.config import (
    DEFAULT_CYCLE_CONFIG,
    MOST_ALLOCATED,
    CycleConfig,
)
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import ClusterSnapshot, PriorityClass
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.obs.spans import stage
from koordinator_tpu_torch.ops.fit import nonzero_requests
from koordinator_tpu_torch.ops.scoring import (
    least_requested_score,
    most_requested_score,
    weighted_resource_score,
)
from koordinator_tpu_torch.solver.greedy import (
    INT64_MIN,
    CycleResult,
    finish_cycle,
    node_filter_inputs,
    queue_order,
    run_pod_count,
)

KERNEL_SOURCE = "solver/cycle_cuda.cu"

FLAG_OK = 1  # valid & LoadAware default mask
FLAG_PROD_OK = 2  # valid & LoadAware prod mask
FLAG_FRESH = 4  # NodeMetric fresh

@dataclasses.dataclass(frozen=True)
class CycleInputs:
    """Everything one cycle reads, in the kernel's layouts."""

    order: torch.Tensor  # i64[P] queue order
    preq: torch.Tensor  # i64[P, R] requests, queue order
    psreq: torch.Tensor  # i64[P, R] non-zero score requests
    pest: torch.Tensor  # i64[P, R] LoadAware estimates
    qid: torch.Tensor  # i32[P] quota id, -1 = none
    pvalid: torch.Tensor  # u8[P]
    pprod: torch.Tensor  # u8[P] pod takes the prod mask and usage
    alloc: torch.Tensor  # i64[R, N]
    req0: torch.Tensor  # i64[R, N] node requested before the cycle
    usage: torch.Tensor  # i64[R, N] score usage, non-prod pods
    uprod: torch.Tensor  # i64[R, N] score usage, prod pods
    flags: torch.Tensor  # u8[N] FLAG_* bits
    qrt: torch.Tensor  # i64[Q, R] quota runtime
    qlim: torch.Tensor  # u8[Q, R] quota declares the dimension
    quse0: torch.Tensor  # i64[Q, R] quota used before the cycle
    weights: torch.Tensor  # i64[2, R]: fit, LoadAware resource weights
    xcomb: Optional[torch.Tensor]  # i64[P, N] extra score, INT64_MIN = masked


def prepare_cycle_inputs(
    snapshot: ClusterSnapshot,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    extra_mask: Optional[torch.Tensor] = None,
    extra_scores: Optional[torch.Tensor] = None,
) -> CycleInputs:
    pods, nodes, quotas = snapshot.pods, snapshot.nodes, snapshot.quotas
    dev = nodes.allocatable.device
    P = pods.capacity
    N = nodes.capacity
    order = queue_order(pods.priority, pods.valid)
    nf = node_filter_inputs(snapshot, cfg)
    is_prod = pods.priority_class == int(PriorityClass.PROD)
    pprod = is_prod & nf.prod_sensitive

    flags = (
        nf.node_ok_default.to(torch.uint8) * FLAG_OK
        + nf.node_ok_prod.to(torch.uint8) * FLAG_PROD_OK
        + nodes.metric_fresh.to(torch.uint8) * FLAG_FRESH
    )

    def cols(a):
        return a.t().contiguous()

    xcomb = None
    if extra_mask is not None or extra_scores is not None:
        if extra_mask is None:
            extra_mask = torch.ones((P, N), dtype=torch.bool, device=dev)
        if extra_scores is None:
            extra_scores = torch.zeros((P, N), dtype=torch.int64, device=dev)
        # an extra score of INT64_MIN itself reads as masked
        comb = torch.where(extra_mask, extra_scores.long(), INT64_MIN)
        xcomb = comb[order].contiguous()

    return CycleInputs(
        order=order,
        preq=pods.requests[order].contiguous(),
        psreq=nonzero_requests(pods.requests)[order].contiguous(),
        pest=pods.estimated[order].contiguous(),
        qid=pods.quota_id[order].to(torch.int32).contiguous(),
        pvalid=pods.valid[order].to(torch.uint8).contiguous(),
        pprod=pprod[order].to(torch.uint8).contiguous(),
        alloc=cols(nodes.allocatable),
        req0=cols(nodes.requested),
        usage=cols(nf.usage_default),
        uprod=cols(nf.usage_prod),
        flags=flags.contiguous(),
        qrt=quotas.runtime.contiguous(),
        qlim=quotas.limited.to(torch.uint8).contiguous(),
        quse0=quotas.used.contiguous(),
        weights=torch.stack(
            [cfg.fit_weights_arr(dev), cfg.loadaware_weights_arr(dev)]
        ),
        xcomb=xcomb,
    )


def weight_sums(cfg: CycleConfig):
    return (
        sum(res.weights_vector(dict(cfg.fit_resource_weights))),
        sum(res.weights_vector(dict(cfg.loadaware.resource_weights))),
    )


def cycle_dense_reference(inp: CycleInputs, cfg: CycleConfig):
    """The plain PyTorch version of the cycle kernel: the same inputs and
    outputs, one eager step per pod.  Runs on any device.

    Returns (chosen i32[P] in queue order, nreq i64[R, N], nest i64[R, N],
    quse i64[Q, R])."""
    P = inp.preq.shape[0]
    dev = inp.alloc.device
    fit_w, la_w = inp.weights[0], inp.weights[1]
    most = cfg.fit_scoring_strategy == MOST_ALLOCATED
    fresh = (inp.flags & FLAG_FRESH) != 0
    ok_bits = ((inp.flags & FLAG_OK) != 0, (inp.flags & FLAG_PROD_OK) != 0)
    alloc = inp.alloc
    nreq = inp.req0.clone()
    nest = torch.zeros_like(inp.req0)
    quse = inp.quse0.clone()
    qlim = inp.qlim != 0
    chosen_out = torch.full((P,), -1, dtype=torch.int32, device=dev)
    pvalid = inp.pvalid.tolist()
    qids = inp.qid.tolist()
    prods = inp.pprod.tolist()
    for p in range(P):
        if not pvalid[p]:
            continue
        req = inp.preq[p][:, None]  # [R, 1]
        prod = prods[p] != 0
        feasible = ok_bits[1] if prod else ok_bits[0]
        feasible = feasible & ((nreq + req <= alloc) | (req <= 0)).all(0)
        qid = qids[p]
        if qid >= 0:
            feasible = feasible & (
                (quse[qid] + inp.preq[p] <= inp.qrt[qid]) | ~qlim[qid]
            ).all()
        total = torch.zeros(alloc.shape[1], dtype=torch.int64, device=dev)
        if inp.xcomb is not None:
            x = inp.xcomb[p]
            feasible = feasible & (x != INT64_MIN)
            total = total + x
        if cfg.enable_fit_score:
            t = nreq + inp.psreq[p][:, None]
            per_res = (most_requested_score if most else least_requested_score)(
                t, alloc
            )
            total = total + cfg.fit_plugin_weight * weighted_resource_score(
                per_res.t(), fit_w
            )
        if cfg.enable_loadaware:
            usage = inp.uprod if prod else inp.usage
            per_res = least_requested_score(
                usage + nest + inp.pest[p][:, None], alloc
            )
            la = weighted_resource_score(per_res.t(), la_w)
            total = total + cfg.loadaware_plugin_weight * torch.where(
                fresh, la, torch.zeros_like(la)
            )
        masked = torch.where(feasible, total, torch.full_like(total, INT64_MIN))
        any_feasible = feasible.any()
        chosen = torch.where(any_feasible, masked.argmax(), -1)
        chosen_out[p] = chosen
        node = chosen.clamp(min=0).view(1)
        take = any_feasible.long()
        nreq.index_add_(1, node, req * take)
        nest.index_add_(1, node, inp.pest[p][:, None] * take)
        if qid >= 0:
            quse[qid] += inp.preq[p] * take
    return chosen_out, nreq, nest, quse


_LAUNCH_ARGTYPES = (
    [ctypes.c_int] * 4  # P, N, R, Q
    + [ctypes.c_void_p] * 13  # preq .. weights
    + [ctypes.c_int64] * 4  # fit_wsum, la_wsum, fit_pw, la_pw
    + [ctypes.c_int] * 3  # most_allocated, enable_fit, enable_la
    + [ctypes.c_void_p] * 9  # xcomb, chosen, nreq, nest, quse, magic, shift, run_pods, run_scratch
    + [ctypes.c_size_t, ctypes.c_void_p]  # run_scratch's bytes, stream
)
PLAN_KEYS = ("cluster_size", "slice_nodes", "resident", "smem_bytes_per_cta",
             "max_active_clusters_8", "max_active_clusters_16")


def read_plan(source: str, name: str, argtypes, *args) -> dict:
    """Call a kernel's plan entry ``name(*args, out)`` of ``source``: the
    cluster size, the nodes of a slice, whether the slice is resident in
    shared memory, the dynamic shared bytes per CTA and
    ``cudaOccupancyMaxActiveClusters`` at 8 and 16 CTAs."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    _build.call(source, name, argtypes, *args, out)
    return dict(zip(PLAN_KEYS, out))


def uprod_shared(inp: CycleInputs) -> int:
    """1 when the prod score usage is the default one (one tensor)."""
    return int(inp.uprod.data_ptr() == inp.usage.data_ptr())


def cycle_plan(inp: CycleInputs) -> dict:
    """The cluster plan the kernel takes for ``inp`` (``read_plan``)."""
    R, N = inp.alloc.shape
    with torch.cuda.device(inp.alloc.device):
        return read_plan(KERNEL_SOURCE, "koord_cycle_plan", [ctypes.c_int] * 4 + [ctypes.c_void_p],
                         N, R, inp.qrt.shape[0], uprod_shared(inp))


def reciprocal_tables(plan: dict, R: int, N: int, dtype, dev):
    """The device tables of a cycle whose node slices do not fit in shared
    memory: one reciprocal (``dtype`` holds its bits) and one shift per (r,
    n).  None when the slices are resident."""
    if plan["resident"]:
        return None, None
    return (torch.empty((R, N), dtype=dtype, device=dev),
            torch.empty((R, N), dtype=torch.uint8, device=dev))


def _align16(n: int) -> int:
    return (n + 15) & ~15


def run_scratch(plan: dict, N: int, dtype, dev) -> Optional[torch.Tensor]:
    """The device scratch of the per-pod kernels' run path when the node
    slices are not resident (``cycle_cuda.cu carve_run``): a leaf of
    ``dtype`` and a feasibility byte per node, then a 16-byte entry per
    group of 32 nodes of a slice, for 16 CTAs at most.  None when the
    slices are resident; the launcher refuses a scratch that is short."""
    if plan["resident"]:
        return None
    groups = 16 * -(-plan["slice_nodes"] // 32)
    nbytes = _align16(N * torch.iinfo(dtype).bits // 8) + _align16(N) + 16 * groups
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def scratch_args(scratch: Optional[torch.Tensor]) -> tuple:
    """The launcher's (run_scratch, run_scratch_bytes) arguments."""
    return (None, 0) if scratch is None else (scratch.data_ptr(), scratch.numel())


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"cycle kernel input {name}: want {dtype} {tuple(shape)} on {dev}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"cycle kernel input {name} must be contiguous")


def check_kernel_inputs(inp: CycleInputs, what: str, value_dtype=torch.int64) -> None:
    """Check ``inp`` as a cycle kernel takes it: CUDA tensors, the layouts
    of ``CycleInputs`` with requests, node and quota values and ``xcomb``
    in ``value_dtype``, contiguous, 1..32 resources, quota ids in range."""
    dev = inp.alloc.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    P, R = inp.preq.shape
    N = inp.alloc.shape[1]
    Q = inp.qrt.shape[0]
    v, u8, i32 = value_dtype, torch.uint8, torch.int32
    for name, dtype, shape in (
        ("preq", v, (P, R)), ("psreq", v, (P, R)), ("pest", v, (P, R)),
        ("qid", i32, (P,)), ("pvalid", u8, (P,)), ("pprod", u8, (P,)),
        ("alloc", v, (R, N)), ("req0", v, (R, N)), ("usage", v, (R, N)),
        ("uprod", v, (R, N)), ("flags", u8, (N,)), ("qrt", v, (Q, R)),
        ("qlim", u8, (Q, R)), ("quse0", v, (Q, R)), ("weights", v, (2, R)),
    ):
        _check(getattr(inp, name), name, dtype, shape, dev)
    if inp.xcomb is not None:
        _check(inp.xcomb, "xcomb", v, (P, N), dev)
    if not 1 <= R <= 32 or N < 1:
        raise ValueError(f"{what} takes 1..32 resources and >= 1 node, got R={R} N={N}")
    if inp.qid.numel() and int(inp.qid.max()) >= Q:
        raise ValueError(f"quota id out of range for {Q} quota rows")


def phase_cycles():
    """The instrumented build's clock64 counters, summed since the last
    read (reading resets them): rank 0's cycles, over the full pod steps,
    of quota and Filter/Score, of staging the next pod, of the reduction
    and barrier, and of the merge and Reserve; then of the runs, from
    their first pod's merge to the staging of the pod after them."""
    return _build.read_counters(KERNEL_SOURCE, "koord_cycle_phase_cycles", 5)


@devprof.boundary("solver.dense.cycle_dense_cuda")
def cycle_dense_cuda(inp: CycleInputs, cfg: CycleConfig, defines=(),
                     run_pods: Optional[torch.Tensor] = None):
    """Launch the CUDA cycle kernel on the current stream; same outputs as
    ``cycle_dense_reference``.  Raises on a bad input or a refused launch.
    ``defines=_build.PHASE_CLOCK`` launches the instrumented build of the
    same source (``phase_cycles``).  ``run_pods``, an i32[1] on the
    device, receives the pods placed on the run path (``run_pod_count``)."""
    check_kernel_inputs(inp, "cycle_dense_cuda")
    dev = inp.alloc.device
    P, R = inp.preq.shape
    N = inp.alloc.shape[1]
    i32 = torch.int32

    plan = cycle_plan(inp)
    magic, shift = reciprocal_tables(plan, R, N, torch.int64, dev)
    scratch = run_scratch(plan, N, torch.int64, dev)
    chosen = torch.empty(P, dtype=i32, device=dev)
    nreq = inp.req0.clone()
    nest = torch.zeros_like(inp.req0)
    quse = inp.quse0.clone()
    fit_wsum, la_wsum = weight_sums(cfg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _build.launch(
            "cycle_dense", KERNEL_SOURCE, "koord_cycle_launch", _LAUNCH_ARGTYPES,
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
            chosen.data_ptr(), nreq.data_ptr(), nest.data_ptr(), quse.data_ptr(),
            None if magic is None else magic.data_ptr(),
            None if shift is None else shift.data_ptr(),
            None if run_pods is None else run_pods.data_ptr(), *scratch_args(scratch),
            stream, defines=defines,
        )
    return chosen, nreq, nest, quse


def inputs_run_pods(inp: CycleInputs) -> torch.Tensor:
    """``run_pod_count`` of a cycle's inputs: what the kernel reports."""
    return run_pod_count(inp.preq, inp.psreq, inp.pest, inp.pprod, inp.pvalid,
                         inp.xcomb is not None)


def cycle_dense(inp: CycleInputs, cfg: CycleConfig, run_pods: Optional[torch.Tensor] = None):
    """The cycle on ``inp``'s device: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors (which counts ``run_pods`` from the
    inputs)."""
    if inp.alloc.device.type == "cpu":
        if run_pods is not None:
            run_pods.copy_(inputs_run_pods(inp))
        return cycle_dense_reference(inp, cfg)
    return cycle_dense_cuda(inp, cfg, run_pods=run_pods)


def greedy_assign_dense(
    snapshot: ClusterSnapshot,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    extra_mask: Optional[torch.Tensor] = None,  # bool[P, N]
    extra_scores: Optional[torch.Tensor] = None,  # i64[P, N]
) -> CycleResult:
    """Drop-in for ``greedy_assign`` through the single-launch cycle:
    ``path="cuda"`` on a CUDA snapshot, ``path="scan"`` (the kernel's plain
    version) on a CPU snapshot.  Bit-identical to ``greedy_assign``, extra
    scores of any int64 magnitude included."""
    with stage("prepare"):
        inp = prepare_cycle_inputs(snapshot, cfg, extra_mask, extra_scores)
    with stage("kernel"):
        run_pods = torch.zeros(1, dtype=torch.int32, device=inp.alloc.device)
        chosen, nreq, nest, quse = cycle_dense(inp, cfg, run_pods)
    path = "scan" if inp.alloc.device.type == "cpu" else "cuda"
    with stage("finish"):
        return finish_cycle(
            snapshot, inp.order, chosen, nreq.t().contiguous(),
            nest.t().contiguous(), quse, path=path, run_pods=run_pods,
        )
