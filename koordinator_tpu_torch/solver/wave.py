"""Wave/top-M certification and the round-based cycle ``wave_assign``.

Counterpart of ``koordinator_tpu/solver/wave.py``.  A round scores the next
``wave`` pods in queue order against the round-start state, freezes each
pod's top-``top_m`` packed (score, node) keys, and resolves the wave in
queue order with ``resolve_wave``: every pod re-keys its candidates against
the earlier in-wave commits and is certified against its frozen M-th key
``k_M``; the first pod that cannot be certified ends the commit prefix and
reruns next round.  Placements equal ``greedy_assign``'s bit for bit; the
result carries the number of rounds.

The certification, in short (the reference module states it in full):

* LeastAllocated: keys only fall as load commits, so a node outside a pod's
  frozen top-M stays below ``k_M`` for the whole wave, and the best
  re-keyed candidate is exact once it is still >= ``k_M``;
* MostAllocated: keys rise with load, so every pod re-keys the closed
  universe (the union of the wave's top-M rows, where every in-wave commit
  lands) and certifies when its best is >= its own ``k_M``; pod 0 of a
  round always commits;
* quota admission is node-invariant and rechecked against the in-wave quota
  state; a ``-1`` outcome certifies only when it does not depend on the
  node or when ``k_M`` is the sentinel.

The loops are eager PyTorch on the snapshot's device.  Integer products
that the reference writes as ``jnp.einsum`` are ``index_add_`` or one-hot
sums here: CUDA has no int64 matrix product, and the eager loop stays usable
on a card's tensors (``run_cycle`` itself runs a kernel there).
"""

from __future__ import annotations

from typing import Optional

import torch

from koordinator_tpu_torch.config import (
    DEFAULT_CYCLE_CONFIG,
    MOST_ALLOCATED,
    CycleConfig,
)
from koordinator_tpu_torch.model.snapshot import ClusterSnapshot, PriorityClass
from koordinator_tpu_torch.ops.fit import nonzero_requests
from koordinator_tpu_torch.solver.greedy import (
    CycleResult,
    finish_cycle,
    node_filter_inputs,
    queue_order,
    step_feasible_scores,
)

# scores are bounded by plugin weights * MAX_NODE_SCORE (tiny); this
# sentinel for infeasible nodes leaves the packed key far from i64 limits
SENTINEL_SCORE = -(2**40)


def is_most_allocated(cfg: CycleConfig) -> bool:
    """True when the fit strategy needs the closed-universe certificate
    (scores increase with committed load) instead of the k_M bound."""
    return bool(cfg.enable_fit_score) and cfg.fit_scoring_strategy == MOST_ALLOCATED


def sentinel_threshold(n_total: int) -> int:
    """Packed keys at or below this decode as infeasible."""
    return SENTINEL_SCORE * n_total // 2


def pack_keys(total, feasible, node_index, n_total: int) -> torch.Tensor:
    """(score, node) -> packed i64 key ``score * N + (N - 1 - node)``: one
    integer max picks the highest score with the lowest node index.
    Infeasible slots take the sentinel score but keep their index term, so
    every key is unique."""
    score = torch.where(feasible, total, SENTINEL_SCORE)
    return score * n_total + (n_total - 1 - node_index)


def decode_key(key: torch.Tensor, n_total: int):
    """Packed key -> (score i64, node i32).  Floor division decodes the
    negative sentinel range too."""
    score = torch.div(key, n_total, rounding_mode="floor")
    node = (n_total - 1 - (key - score * n_total)).to(torch.int32)
    return score, node


def score_feasible(score: torch.Tensor) -> torch.Tensor:
    """True when a DECODED score (not a packed key) is a real score rather
    than the infeasible sentinel."""
    return score > SENTINEL_SCORE // 2


def flatten_shards(a: torch.Tensor) -> torch.Tensor:
    """Align a gathered per-shard candidate payload by wave lane:
    ``[S, W, M, ...] -> [W, S*M, ...]``, the pool the cross-shard top-M
    merge selects from."""
    a = a.movedim(0, 1)
    return a.reshape((a.shape[0], -1) + tuple(a.shape[3:]))


def merge_topm_keys(gathered_key: torch.Tensor, top_m: int) -> torch.Tensor:
    """Key-only cross-shard merge: the frozen global top-M packed keys per
    wave pod.  Keys are unique, so ``torch.topk`` orders them as
    ``lax.top_k`` does whatever its tie rule."""
    return torch.topk(flatten_shards(gathered_key), top_m, dim=1).values


def merge_topm(gathered: dict, top_m: int):
    """The cross-shard top-M merge of the k_M path: flatten every gathered
    row ``[S, W, M, ...] -> [W, S*M, ...]``, select the global top-M by
    packed ``key`` and take each winner's rows along.  Returns ``(cand_key
    i64[W, M], cand dict)`` as :func:`resolve_wave` reads them."""
    g = {k: flatten_shards(v) for k, v in gathered.items()}
    gkeys, gsel = torch.topk(g["key"], top_m, dim=1)

    def take(a):
        sel = gsel
        while sel.dim() < a.dim():
            sel = sel[..., None]
        return torch.take_along_dim(a, sel.expand(sel.shape[:2] + a.shape[2:]), dim=1)

    return gkeys, {k: take(v) for k, v in g.items() if k != "key"}


def _rows_delta(hit: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """sum_w hit[w, k] * rows[w, :] -> [K, R], as a one-hot sum (the
    reference's int64 ``einsum('wk,wr->kr')``)."""
    return (hit.to(torch.int64)[:, :, None] * rows[:, None, :]).sum(0)


def resolve_wave(
    cand_key: torch.Tensor,  # i64[W, M] frozen top-M keys per wave pod
    *,
    cand: Optional[dict] = None,  # k_M path candidate rows
    universe: Optional[dict] = None,  # closed-universe rows (MostAllocated)
    preq_wave: torch.Tensor,  # i64[W, R] pod requests, wave order
    pest_wave: torch.Tensor,  # i64[W, R]
    psreq_wave: torch.Tensor,  # i64[W, R] non-zero score requests
    pqid_wave: torch.Tensor,  # i32[W]
    pvalid_wave: torch.Tensor,  # bool[W]
    pprod_wave: torch.Tensor,  # bool[W]
    wvalid: torch.Tensor,  # bool[W] lane addresses a real pod slot
    qrt: torch.Tensor,  # i64[Q, R] quota runtime
    qlim: torch.Tensor,  # bool[Q, R]
    quse: torch.Tensor,  # i64[Q, R] quota used at round start
    cfg: CycleConfig,
    n_total: int,
    prod_sensitive: bool,
):
    """Deterministic in-wave resolution and certification.

    ``cand`` (k_M path) holds per-pod candidate rows, each ``[W, M, ...]``:
    ``gid`` (node ids), ``alloc``, ``nreq``, ``nest``, ``usage``
    (prod-selected), ``ok``, ``fresh``, ``xval``, ``xfeas``.  ``universe``
    (MostAllocated) holds the node-keyed closed candidate set ``[U, ...]``:
    ``gid``, ``alloc``, ``nreq``, ``nest``, ``usage``, ``okd``, ``fresh``,
    per-pod ``xval``/``xfeas`` ``[W, U]`` and, when ``prod_sensitive``,
    ``uprod``/``okp``.  Duplicated nodes are harmless.

    Returns ``(choices i64[W], committed bool[W], done bool[W], quota_used,
    ncommit i64)``: ``done`` marks the committed prefix (including -1
    commits), ``committed`` the lanes that took a node.
    """
    W, M = cand_key.shape
    N = n_total
    most_alloc = is_most_allocated(cfg)
    if most_alloc and universe is None:
        raise ValueError(
            "MostAllocated wave resolution needs the closed candidate "
            "universe (scores rise with committed load; the k_M bound "
            "alone is not exact)"
        )
    if not most_alloc and cand is None:
        raise ValueError("wave resolution needs the candidate rows")
    dev = cand_key.device
    sent_th = sentinel_threshold(N)
    R = preq_wave.shape[1]

    # per-lane values the loop reads, gathered once a round
    qid_w = pqid_wave.to(torch.int64)
    qi_w = qid_w.clamp(min=0)
    has_quota_w = qid_w >= 0
    k_m_w = cand_key[:, M - 1]
    # k_M at sentinel: every frozen-feasible node is a candidate, and
    # committed load never turns an infeasible node feasible
    sentinel_w = k_m_w <= sent_th
    lane_ok_w = pvalid_wave & wvalid
    qlim_w, qrt_w = qlim[qi_w], qrt[qi_w]
    pod_rows_w = torch.cat([preq_wave, pest_wave], dim=1)  # [W, 2R]

    choices = torch.full((W,), -1, dtype=torch.int64, device=dev)
    committed = torch.zeros((W,), dtype=torch.bool, device=dev)
    done = torch.zeros((W,), dtype=torch.bool, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    quse_w = quse.clone()
    for i in range(W):
        req, est, sreq = preq_wave[i], pest_wave[i], psreq_wave[i]
        if most_alloc:
            nodes = universe["gid"]
            if prod_sensitive:
                usage = torch.where(pprod_wave[i], universe["uprod"], universe["usage"])
                ok = torch.where(pprod_wave[i], universe["okp"], universe["okd"])
            else:
                usage, ok = universe["usage"], universe["okd"]
            rows = universe
            xval, xfeas = universe["xval"][i], universe["xfeas"][i]
        else:
            nodes = cand["gid"][i]  # [M]
            rows = {k: cand[k][i] for k in ("alloc", "nreq", "nest", "fresh")}
            usage, ok = cand["usage"][i], cand["ok"][i]
            xval, xfeas = cand["xval"][i], cand["xfeas"][i]
        # the earlier in-wave commits onto each candidate: lanes not
        # committed (later ones included) hold -1, which no node id equals
        hit = choices[:, None] == nodes[None, :]  # [W, K]
        delta = _rows_delta(hit, pod_rows_w)  # [K, 2R]
        # re-key with the same step semantics as the scan: the rows stand
        # in as a node block, quota off (admission is rechecked below)
        re_feas, re_total = step_feasible_scores(
            rows["nreq"] + delta[:, :R], rows["nest"] + delta[:, R:],
            quse_w, rows["alloc"], usage, rows["fresh"], ok,
            req, sreq, est, -1, True, qrt, qlim, cfg,
        )
        re_total = re_total + torch.where(xfeas, xval, 0)
        cur = pack_keys(re_total, re_feas & xfeas, nodes, N)
        if not most_alloc:
            # only candidates dirtied in-wave changed their key
            cur = torch.where(hit.any(0), cur, cand_key[i])
        # indices stay on the device: indexing with a 0-d device tensor
        # reads it on the host, a wait for every launch before it
        best_key, best = cur.max(0)
        best_node = nodes.index_select(0, best.view(1))[0]
        # pod 0 of a MostAllocated round has no earlier in-wave commits:
        # its frozen keys are current
        certified = (best_key >= k_m_w[i]) | sentinel_w[i] | (most_alloc and i == 0)
        feas = best_key > sent_th

        qi = qi_w[i].view(1)
        used = quse_w.index_select(0, qi)[0]
        qblocked = has_quota_w[i] & (qlim_w[i] & (used + req > qrt_w[i])).any()
        usable = lane_ok_w[i] & ~qblocked
        choice = torch.where(feas & usable, best_node, -1)
        # a -1 outcome is exact only when it is node-independent (blocked
        # quota, invalid pod, padding lane) or at the sentinel
        certified = certified | ~usable

        commit = active & certified
        take_node = commit & (choice >= 0)
        choices[i] = torch.where(take_node, choice, -1)
        committed[i] = take_node
        done[i] = commit
        charge = (take_node & has_quota_w[i]).to(torch.int64)
        quse_w.index_add_(0, qi, (req * charge)[None])
        active = active & certified
    # the committed prefix: every lane up to the first uncertified one
    return choices, committed, done, quse_w, done.sum()


def _wave_assign(
    snapshot: ClusterSnapshot,
    extra_mask: Optional[torch.Tensor],
    extra_scores: Optional[torch.Tensor],
    cfg: CycleConfig,
    wave: int,
    top_m: int,
) -> CycleResult:
    """Single-device round-based cycle: one eager iteration per round."""
    pods, nodes, quotas = snapshot.pods, snapshot.nodes, snapshot.quotas
    dev = nodes.allocatable.device
    PCAP = pods.capacity
    N = nodes.capacity
    W = wave
    M = max(1, min(top_m, N))

    order = queue_order(pods.priority, pods.valid)
    order_pad = torch.cat([order, torch.zeros(W, dtype=order.dtype, device=dev)])
    score_requests = nonzero_requests(pods.requests)
    nf = node_filter_inputs(snapshot, cfg)
    usage_np, uprod = nf.usage_default, nf.usage_prod
    is_prod_pods = pods.priority_class == int(PriorityClass.PROD)
    alloc, fresh = nodes.allocatable, nodes.metric_fresh
    gidx = torch.arange(N, dtype=torch.int64, device=dev)
    iota_w = torch.arange(W, device=dev)
    qrt, qlim = quotas.runtime, quotas.limited
    most_alloc = is_most_allocated(cfg)

    def wave_keys(nreq, nest, ps):
        """Frozen [W, N] packed keys of the wave pods ``ps`` (quota is
        handled in the resolution, so qid=-1 here)."""
        if nf.prod_sensitive:
            prod = is_prod_pods[ps]
            ok = torch.where(prod[:, None], nf.node_ok_prod, nf.node_ok_default)
            usage = torch.where(prod[:, None, None], uprod, usage_np)
        else:
            ok, usage = nf.node_ok_default, usage_np
        # pod rows broadcast as [W, 1, R] against the [N, R] node block
        feasible, total = step_feasible_scores(
            nreq, nest, quotas.used, alloc, usage, fresh, ok,
            pods.requests[ps][:, None], score_requests[ps][:, None],
            pods.estimated[ps][:, None], -1, True, qrt, qlim, cfg,
        )
        feasible = feasible & pods.valid[ps][:, None]
        if extra_mask is not None:
            feasible = feasible & extra_mask[ps]
        if extra_scores is not None:
            total = total + extra_scores[ps]
        return pack_keys(total, feasible, gidx, N)

    def gather_x(ps, idx, width):
        xval = (extra_scores[ps[:, None], idx] if extra_scores is not None
                else torch.zeros((W, width), dtype=torch.int64, device=dev))
        xfeas = (extra_mask[ps[:, None], idx] if extra_mask is not None
                 else torch.ones((W, width), dtype=torch.bool, device=dev))
        return xval, xfeas

    ptr = 0
    nrounds = 0
    nreq = nodes.requested.clone()
    nest = torch.zeros_like(nodes.requested)
    quse = quotas.used.clone()
    chosen_buf = torch.full((PCAP + W,), -1, dtype=torch.int32, device=dev)
    while ptr < PCAP:
        ps = order_pad[ptr:ptr + W]
        wvalid = (ptr + iota_w) < PCAP
        # packed keys are unique (the index term), so torch.topk returns
        # the same (key, index) set and order as lax.top_k whatever its
        # tie rule
        cand_key, lidx = torch.topk(wave_keys(nreq, nest, ps), M, dim=1)
        preq_wave = pods.requests[ps]
        pest_wave = pods.estimated[ps]
        pprod_wave = is_prod_pods[ps]

        if most_alloc:
            uni = lidx.reshape(-1)  # [W*M], duplicates harmless
            xval, xfeas = gather_x(ps, uni[None, :].expand(W, -1), W * M)
            universe = dict(
                gid=uni, alloc=alloc[uni], nreq=nreq[uni], nest=nest[uni],
                usage=usage_np[uni], okd=nf.node_ok_default[uni], fresh=fresh[uni],
                xval=xval, xfeas=xfeas,
            )
            if nf.prod_sensitive:
                universe["uprod"] = uprod[uni]
                universe["okp"] = nf.node_ok_prod[uni]
            cand = None
        else:
            universe = None
            if nf.prod_sensitive:
                usage_rows = torch.where(pprod_wave[:, None, None], uprod[lidx], usage_np[lidx])
                ok_rows = torch.where(pprod_wave[:, None], nf.node_ok_prod[lidx],
                                      nf.node_ok_default[lidx])
            else:
                usage_rows, ok_rows = usage_np[lidx], nf.node_ok_default[lidx]
            xval, xfeas = gather_x(ps, lidx, M)
            cand = dict(
                gid=lidx, alloc=alloc[lidx], nreq=nreq[lidx], nest=nest[lidx],
                usage=usage_rows, ok=ok_rows, fresh=fresh[lidx], xval=xval, xfeas=xfeas,
            )

        choices, committed, done, quse, ncommit = resolve_wave(
            cand_key, cand=cand, universe=universe,
            preq_wave=preq_wave, pest_wave=pest_wave,
            psreq_wave=score_requests[ps], pqid_wave=pods.quota_id[ps],
            pvalid_wave=pods.valid[ps], pprod_wave=pprod_wave, wvalid=wvalid,
            qrt=qrt, qlim=qlim, quse=quse, cfg=cfg, n_total=N,
            prod_sensitive=nf.prod_sensitive,
        )

        # Reserve the committed prefix into the carried node state
        take = committed.to(torch.int64)[:, None]
        node = choices.clamp(min=0)
        nreq.index_add_(0, node, preq_wave * take)
        nest.index_add_(0, node, pest_wave * take)
        # positions not committed this round keep their value: they are
        # rewritten when their round comes
        window = chosen_buf[ptr:ptr + W]
        chosen_buf[ptr:ptr + W] = torch.where(done, choices.to(torch.int32), window)
        ptr += int(ncommit)
        nrounds += 1

    return finish_cycle(
        snapshot, order, chosen_buf[:PCAP].clone(), nreq, nest, quse, path="wave",
        rounds=torch.tensor(nrounds, dtype=torch.int64, device=dev),
    )


def wave_assign(
    snapshot: ClusterSnapshot,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    extra_mask: Optional[torch.Tensor] = None,
    extra_scores: Optional[torch.Tensor] = None,
    wave: Optional[int] = None,
    top_m: Optional[int] = None,
    scores_hi: Optional[int] = None,
) -> CycleResult:
    """Wave-batched drop-in for ``greedy_assign``: the same placements and
    post-cycle state, ``rounds`` set, ``path="wave"``.

    ``wave``/``top_m`` default from the ``CycleConfig`` knobs.
    ``scores_hi``: callers that already reduced ``extra_scores`` to its max
    magnitude pass it to skip a second device-to-host reduction.
    """
    W = int(cfg.wave if wave is None else wave)
    M = int(cfg.top_m if top_m is None else top_m)
    if W < 1 or M < 1:
        raise ValueError(f"wave ({W}) and top_m ({M}) must be >= 1")
    if extra_scores is not None:
        # the packed key multiplies scores by N: caller-supplied scores at
        # the sentinel's magnitude would decode as infeasible
        if scores_hi is not None:
            hi = int(scores_hi)
        else:
            hi = int(extra_scores.abs().max()) if extra_scores.numel() else 0
        if hi >= 2**31:
            raise ValueError(
                f"extra_scores magnitude {hi} too large for the packed "
                "key (must be < 2^31); use solver.greedy_assign"
            )
    return _wave_assign(snapshot, extra_mask, extra_scores, cfg, W, M)
