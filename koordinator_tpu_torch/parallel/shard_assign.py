"""The greedy assignment with node state sharded over a mesh.

Counterpart of ``koordinator_tpu/parallel/shard_assign.py``.  Node state
(allocatable, requested, estimated, usage, the Filter masks, the extended
plugins' [P, N] columns) is split over every position of the mesh; pod rows
and the quota table live once, on the lead device.  Placements equal
``solver.greedy.greedy_assign``'s bit for bit.

The reference partitions the scan body with ``shard_map`` and puts the one
collective of a step inside it (a ``lax.pmax`` of a packed key, or an
``all_gather`` of each shard's top-M candidates).  One process drives the
port's mesh, so the step becomes an outer loop (a pod step or a round) and
the per-shard work an inner ``shard_map`` over the shards:

* each shard computes its local packed keys and candidate payload on its
  own device;
* the "collective" is the assembly of those payloads on the lead device: a
  stack of the per-shard maxima (the pmax) or of the per-shard payloads
  (the all-gather);
* the replicated resolution (the key decode, or ``solver/wave.py
  resolve_wave``) runs once there — every device of the reference computes
  the same bits, so once is exact;
* its committed prefix goes back to every shard, and each shard applies the
  part that lands on its own node rows.

The packed key ``score * N + (N - 1 - node)`` makes one integer max pick
the highest score with the lowest node index, the scan's tie-break; the
wave round certifies its commit prefix as ``solver/wave.py`` says (the k_M
bound under LeastAllocated, the closed candidate universe under
MostAllocated).  The rounds read one value back to the host each (the
commit count that advances the queue pointer).
"""

from __future__ import annotations

import dataclasses as dc
import time
from typing import Optional

import torch

from koordinator_tpu_torch.config import DEFAULT_CYCLE_CONFIG, CycleConfig
from koordinator_tpu_torch.model.snapshot import (
    SNAPSHOT_FIELDS,
    ClusterSnapshot,
    PriorityClass,
    tensors_to,
)
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.obs.spans import maybe_span
from koordinator_tpu_torch.ops.fit import nonzero_requests
from koordinator_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    ShardedTensor,
    axis_index,
    is_sharded,
    lead_snapshot,
    mesh_axis,
    shard_map,
    shard_tensor,
    unshard_snapshot,
)
from koordinator_tpu_torch.solver.greedy import (
    CycleResult,
    finish_cycle,
    node_filter_inputs,
    queue_order,
    step_feasible_scores,
)
from koordinator_tpu_torch.solver.wave import (
    decode_key,
    is_most_allocated,
    merge_topm,
    merge_topm_keys,
    pack_keys,
    resolve_wave,
    score_feasible,
)

_NODE_FIELDS = SNAPSHOT_FIELDS["nodes"][1]

# the payload rows of one shard in a k_M round, and in a MostAllocated
# round (its closed candidate universe); the prod-usage rows ride only when
# some pod can select them
_KM_PAYLOAD = ("key", "gid", "alloc", "nreq", "nest", "usage", "ok", "fresh", "xval", "xfeas")
_UNIVERSE_PAYLOAD = ("key", "u_gid", "u_alloc", "u_nreq", "u_nest", "u_usage", "u_okd",
                     "u_fresh", "u_xval", "u_xfeas")
_UNIVERSE_PROD = ("u_uprod", "u_okp")


def _pad_nodes_to(snap: ClusterSnapshot, multiple: int) -> ClusterSnapshot:
    """Pad the node axis to a multiple of the device count with invalid
    rows (``valid`` False keeps them unchoosable)."""
    if is_sharded(snap) and snap.nodes.allocatable.shape[0] % multiple:
        snap = unshard_snapshot(snap)
    nodes = snap.nodes
    pad = (-nodes.allocatable.shape[0]) % multiple
    if pad == 0:
        return snap

    def rows(a):
        if a is None:
            return None
        return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                                         device=a.device)])

    return dc.replace(snap, nodes=dc.replace(
        nodes, **{f: rows(getattr(nodes, f)) for f in _NODE_FIELDS}))


def _prod_sensitive(nodes, cfg: CycleConfig) -> bool:
    """Whether prod pods filter or score against other node rows than the
    rest (``solver/greedy.py node_filter_inputs``), from the config and
    which tables are present."""
    prod_usage = cfg.loadaware.score_according_prod_usage and nodes.prod_usage is not None
    return bool(cfg.enable_loadaware and (
        prod_usage or bool(dict(cfg.loadaware.prod_usage_thresholds))))


@dc.dataclass
class _Operands:
    """One cycle's operands: node rows split over the mesh, pod rows and
    the quota table on the lead device."""

    alloc: ShardedTensor
    req0: ShardedTensor
    usage: ShardedTensor
    uprod: ShardedTensor
    okd: ShardedTensor
    okp: ShardedTensor
    fresh: ShardedTensor
    xmask: Optional[ShardedTensor]
    xscores: Optional[ShardedTensor]
    lead: ClusterSnapshot
    prod_sensitive: bool


@devprof.boundary("parallel.shard_assign._cycle_operands")
def _cycle_operands(snapshot, cfg, mesh, extra_mask, extra_scores) -> _Operands:
    """The prologue of both sharded entry points: the node-local LoadAware
    masks and score-usage selection computed on each shard
    (``load_aware.go:150-226,291-311``), the extras split by node columns,
    and the replicated tables on the lead device."""
    ax = mesh_axis(mesh)
    nodes = snapshot.nodes
    node_specs = dc.replace(nodes, **{
        f: P(ax, *([None] * (len(getattr(nodes, f).shape) - 1)))
        for f in _NODE_FIELDS if getattr(nodes, f) is not None
    })

    def filter_body(nodes_l):
        nf = node_filter_inputs(ClusterSnapshot(nodes_l, None, None, None), cfg)
        return (nodes_l.allocatable, nodes_l.requested, nf.usage_default, nf.usage_prod,
                nf.node_ok_default, nf.node_ok_prod, nodes_l.metric_fresh)

    row2, row1 = P(ax, None), P(ax)
    alloc, req0, usage, uprod, okd, okp, fresh = shard_map(
        filter_body, mesh=mesh, in_specs=(node_specs,),
        out_specs=(row2, row2, row2, row2, row1, row1, row1),
    )(nodes)
    cols = NamedSharding(mesh, P(None, ax))
    lead = lead_snapshot(snapshot) if is_sharded(snapshot) else snapshot
    lead = ClusterSnapshot(
        nodes=None,
        pods=tensors_to(lead.pods, mesh.lead),
        gangs=tensors_to(lead.gangs, mesh.lead),
        quotas=tensors_to(lead.quotas, mesh.lead),
    )
    return _Operands(
        alloc=alloc, req0=req0, usage=usage, uprod=uprod, okd=okd, okp=okp, fresh=fresh,
        xmask=None if extra_mask is None else shard_tensor(extra_mask, cols),
        xscores=None if extra_scores is None else shard_tensor(extra_scores, cols),
        lead=lead, prod_sensitive=_prod_sensitive(nodes, cfg),
    )


def _carried(ops: _Operands):
    """The carried (requested, estimated) node state: new allocations per
    shard, so the cycle never writes the snapshot's own rows."""
    nreq = ShardedTensor([r.clone() for r in ops.req0.shards], ops.req0.sharding)
    nest = ShardedTensor([torch.zeros_like(r) for r in ops.req0.shards], ops.req0.sharding)
    return nreq, nest


def _finish(ops: _Operands, mesh, order, chosen, nreq, nest, quse, orig_n, rounds=None):
    """Scatter the queue-order choices to pod order, apply the gang
    status, and assemble the node state on the lead device, trimmed to the
    snapshot's node bucket."""
    lead = mesh.lead
    return finish_cycle(
        ops.lead, order, chosen, nreq.full(lead)[:orig_n], nest.full(lead)[:orig_n], quse,
        path="shard",
        rounds=None if rounds is None else torch.tensor(rounds, dtype=torch.int64,
                                                        device=lead),
    )


def _check_scores(extra_scores) -> None:
    """The packed key multiplies scores by N: caller-supplied scores at
    the sentinel's magnitude would decode as infeasible, so they are
    refused."""
    if extra_scores is None:
        return
    hi = int(extra_scores.abs().max()) if extra_scores.numel() else 0
    if hi >= 2**31:
        raise ValueError(
            f"extra_scores magnitude {hi} too large for the packed-key "
            "collective (must be < 2^31); use solver.greedy_assign"
        )


def _pad_extras(extra, padded_n: int):
    if extra is None or extra.shape[1] == padded_n:
        return extra
    return torch.cat([extra, torch.zeros((extra.shape[0], padded_n - extra.shape[1]),
                                         dtype=extra.dtype, device=extra.device)], dim=1)


@devprof.boundary("parallel.shard_assign._assign_sharded")
def _assign_sharded(snapshot, extra_mask, extra_scores, cfg: CycleConfig, mesh: Mesh,
                    orig_n: int) -> CycleResult:
    """One pod step at a time: every shard's local Filter+Score and packed
    key max, the max of the shards' maxima on the lead device, and the
    Reserve on the shard that owns the chosen node."""
    ax = mesh_axis(mesh)
    N = snapshot.nodes.allocatable.shape[0]
    ops = _cycle_operands(snapshot, cfg, mesh, extra_mask, extra_scores)
    pods, quotas = ops.lead.pods, ops.lead.quotas
    lead = mesh.lead
    order = queue_order(pods.priority, pods.valid)
    score_requests = nonzero_requests(pods.requests)
    # the pods' ids and flags, read once: the step's control flow needs them
    order_np, is_prod, quota_id, valid = (
        # koordlint: disable=host-sync-in-jit(the step loop reads the queue order and the pods' flags once a cycle, ROADMAP Queue C "The sharded cycle's host reads")
        t.cpu().numpy() for t in (order, pods.priority_class == int(PriorityClass.PROD),
                                  pods.quota_id, pods.valid))

    def key_body(alloc, nreq, nest, usage, uprod, okd, okp, fresh, xmask, xscores, step):
        p, prod, ok_pod, req, sreq, est = step
        n_loc = alloc.shape[0]
        off = axis_index(ax) * n_loc
        feasible, total = step_feasible_scores(
            nreq, nest, None, alloc, uprod if prod else usage, fresh,
            okp if prod else okd, req, sreq, est, -1, ok_pod, None, None, cfg,
        )
        if xmask is not None:
            feasible = feasible & xmask[p]
        if xscores is not None:
            total = total + xscores[p]
        gidx = torch.arange(off, off + n_loc, dtype=torch.int64, device=alloc.device)
        return pack_keys(total, feasible, gidx, N).max()[None]

    def reserve_body(nreq, nest, chosen, req, est):
        n_loc = nreq.shape[0]
        loc = chosen.to(torch.int64) - axis_index(ax) * n_loc
        hit = ((loc >= 0) & (loc < n_loc)).to(torch.int64)
        node = torch.where(hit > 0, loc, torch.zeros_like(loc)).view(1)
        nreq.index_add_(0, node, (req * hit)[None])
        nest.index_add_(0, node, (est * hit)[None])

    node2, rep = P(ax, None), P()
    cols = P(None, ax)
    key_pass = shard_map(
        key_body, mesh=mesh,
        in_specs=(node2, node2, node2, node2, node2, P(ax), P(ax), P(ax), cols, cols, rep),
        out_specs=P(ax),
    )
    reserve = shard_map(reserve_body, mesh=mesh, in_specs=(node2, node2, rep, rep, rep),
                        out_specs=None)
    nreq, nest = _carried(ops)
    quse = quotas.used.clone()
    chosen_in_order = torch.empty(pods.capacity, dtype=torch.int32, device=lead)
    for i, p in enumerate(int(x) for x in order_np):
        prod = ops.prod_sensitive and bool(is_prod[p])
        req, est = pods.requests[p], pods.estimated[p]
        keys = key_pass(ops.alloc, nreq, nest, ops.usage, ops.uprod, ops.okd, ops.okp,
                        ops.fresh, ops.xmask, ops.xscores,
                        (p, prod, bool(valid[p]), req, score_requests[p], est))
        # the pmax: one max over the shards' maxima
        best, chosen = decode_key(keys.full(lead).max(), N)
        any_feasible = score_feasible(best)
        q = int(quota_id[p])
        if q >= 0:
            any_feasible = any_feasible & ((quse[q] + req <= quotas.runtime[q])
                                           | ~quotas.limited[q]).all()
        chosen = torch.where(any_feasible, chosen, -1)
        chosen_in_order[i] = chosen
        reserve(nreq, nest, chosen, req, est)
        if q >= 0:
            quse[q].add_(req * any_feasible.to(torch.int64))
    return _finish(ops, mesh, order, chosen_in_order, nreq, nest, quse, orig_n)


class _Split:
    """Host seconds of each stage of the round loop, when asked for: the
    clock is read at the stage boundaries only, with no synchronisation
    added (the round's one host read is its own stage)."""

    STAGES = ("prep", "keys", "gather_merge", "resolve", "apply", "host_read")

    def __init__(self, out: Optional[dict]):
        self.out = out
        if out is not None:
            out.update({f"{k}_s": 0.0 for k in self.STAGES}, host_reads=0)
            self.t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.out is not None:
            now = time.perf_counter()
            self.out[f"{stage}_s"] += now - self.t
            self.t = now


class _Resolution:
    """The round's replicated resolution (``solver/wave.py resolve_wave``)
    on the lead device.

    ``resolve_wave`` is a Python loop of about 70 small launches a wave
    lane, so the host's time to issue them, not the device's, bounds a
    round.  On a CUDA lead device the loop is captured once a cycle into a
    CUDA graph (a cycle's rounds share their shapes: ``wave``, ``top_m`` and
    the candidate rows) and replayed each round on that round's inputs,
    copied into the graph's input buffers; elsewhere it runs eagerly.  The
    graph replays the same launches on the same inputs, so the same bits."""

    def __init__(self, device: torch.device, **static):
        self.device = device
        self.static = static  # cfg, n_total, prod_sensitive
        self.graph = None
        self.inputs = self.outputs = None

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    @staticmethod
    def _flat(inputs: dict):
        for k, v in inputs.items():
            if isinstance(v, dict):
                yield from ((f"{k}.{kk}", vv) for kk, vv in v.items())
            elif v is not None:
                yield k, v

    def _args(self, like: dict) -> dict:
        """``like`` with every tensor replaced by its input buffer."""
        return {k: ({kk: self.inputs[f"{k}.{kk}"] for kk in v} if isinstance(v, dict)
                    else (None if v is None else self.inputs[k]))
                for k, v in like.items()}

    def __call__(self, **inputs):
        if not self.graphed:
            return resolve_wave(**inputs, **self.static)
        if self.graph is None:
            self.inputs = {k: v.clone() for k, v in self._flat(inputs)}
            args = self._args(inputs)
            # one eager run on a side stream first: it fills the config's
            # cached weight vectors and the allocator, outside the capture
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                resolve_wave(**args, **self.static)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread-local: the servicer's readbacks on other threads go on
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.outputs = resolve_wave(**args, **self.static)
        else:
            for k, v in self._flat(inputs):
                self.inputs[k].copy_(v)
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


@devprof.boundary("parallel.shard_assign._assign_waves")
def _assign_waves(snapshot, extra_mask, extra_scores, cfg: CycleConfig, mesh: Mesh,
                  wave: int, top_m: int, orig_n: int, split=None) -> CycleResult:
    """Round-based sharded cycle: one gather of candidates per round
    instead of one max per pod.

    Each round every shard scores the next ``wave`` pods against its
    frozen node rows and contributes its local top-``top_m`` candidates
    (packed key and the candidate's node-state rows) to the round's one
    gather; ``resolve_wave`` then certifies the commit prefix on the lead
    device, exactly as the reference's replicated resolution does (the
    reference's docstring states the certificate in full: the k_M bound
    under LeastAllocated; the closed universe of every wave pod's gathered
    candidates under MostAllocated, where pod 0 of a round always
    commits).  ``split``: a dict that receives the stage times of
    :class:`_Split` and the count of host reads."""
    tick = _Split(split)
    ax = mesh_axis(mesh)
    N = snapshot.nodes.allocatable.shape[0]
    W = wave
    # the local top-M runs on each shard's node slice, so M is bounded by
    # the per-shard node count
    M = max(1, min(top_m, N // mesh.size))
    most_alloc = is_most_allocated(cfg)
    ops = _cycle_operands(snapshot, cfg, mesh, extra_mask, extra_scores)
    pods, quotas = ops.lead.pods, ops.lead.quotas
    lead = mesh.lead
    PCAP = pods.capacity
    order = queue_order(pods.priority, pods.valid)
    order_pad = torch.cat([order, torch.zeros(W, dtype=order.dtype, device=lead)])
    score_requests = nonzero_requests(pods.requests)
    is_prod_pods = pods.priority_class == int(PriorityClass.PROD)
    prod_sensitive = ops.prod_sensitive
    iota_w = torch.arange(W, device=lead)
    names = _UNIVERSE_PAYLOAD + (_UNIVERSE_PROD if prod_sensitive else ()) \
        if most_alloc else _KM_PAYLOAD

    def keys_body(alloc, nreq, nest, usage, uprod, okd, okp, fresh, xmask, xscores, wave_rows):
        ps, preq, psreq, pest, pvalid, pprod = wave_rows
        n_loc = alloc.shape[0]
        dev = alloc.device
        off = axis_index(ax) * n_loc
        if prod_sensitive:
            ok = torch.where(pprod[:, None], okp, okd)
            usage_sel = torch.where(pprod[:, None, None], uprod, usage)
        else:
            ok, usage_sel = okd, usage
        # frozen [W, n_loc] keys of the wave pods (quota is rechecked in
        # the resolution, so qid=-1 here); pod rows broadcast as [W, 1, R]
        feasible, total = step_feasible_scores(
            nreq, nest, None, alloc, usage_sel, fresh, ok,
            preq[:, None], psreq[:, None], pest[:, None], -1, True, None, None, cfg,
        )
        feasible = feasible & pvalid[:, None]
        if xmask is not None:
            feasible = feasible & xmask[ps]
        if xscores is not None:
            total = total + xscores[ps]
        gidx = torch.arange(off, off + n_loc, dtype=torch.int64, device=dev)
        lvals, lidx = torch.topk(pack_keys(total, feasible, gidx, N), M, dim=1)

        def extras_at(idx, width):
            xval = (xscores[ps[:, None], idx] if xscores is not None
                    else torch.zeros((W, width), dtype=torch.int64, device=dev))
            xfeas = (xmask[ps[:, None], idx] if xmask is not None
                     else torch.ones((W, width), dtype=torch.bool, device=dev))
            return xval, xfeas

        if most_alloc:
            # the closed candidate universe: this shard's W pods' local
            # top-M rows, keyed by node (duplicates are harmless)
            uni = lidx.reshape(-1)
            xval, xfeas = extras_at(uni[None, :].expand(W, -1), W * M)
            payload = dict(
                key=lvals, u_gid=off + uni, u_alloc=alloc[uni], u_nreq=nreq[uni],
                u_nest=nest[uni], u_usage=usage[uni], u_okd=okd[uni], u_fresh=fresh[uni],
                u_xval=xval, u_xfeas=xfeas,
            )
            if prod_sensitive:
                payload.update(u_uprod=uprod[uni], u_okp=okp[uni])
        else:
            if prod_sensitive:
                usage_rows = torch.where(pprod[:, None, None], uprod[lidx], usage[lidx])
                ok_rows = torch.where(pprod[:, None], okp[lidx], okd[lidx])
            else:
                usage_rows, ok_rows = usage[lidx], okd[lidx]
            xval, xfeas = extras_at(lidx, M)
            payload = dict(
                key=lvals, gid=off + lidx, alloc=alloc[lidx], nreq=nreq[lidx],
                nest=nest[lidx], usage=usage_rows, ok=ok_rows, fresh=fresh[lidx],
                xval=xval, xfeas=xfeas,
            )
        # a leading axis of one: the shards stack along it
        return tuple(payload[k][None] for k in names)

    def apply_body(nreq, nest, choices, committed, preq, pest):
        n_loc = nreq.shape[0]
        loc = choices - axis_index(ax) * n_loc
        mine = committed & (loc >= 0) & (loc < n_loc)
        take = mine.to(torch.int64)[:, None]
        node = torch.where(mine, loc, torch.zeros_like(loc))
        nreq.index_add_(0, node, preq * take)
        nest.index_add_(0, node, pest * take)

    node2, rep, cols = P(ax, None), P(), P(None, ax)
    key_pass = shard_map(
        keys_body, mesh=mesh,
        in_specs=(node2, node2, node2, node2, node2, P(ax), P(ax), P(ax), cols, cols, rep),
        out_specs=tuple(P(ax) for _ in names),
    )
    apply = shard_map(apply_body, mesh=mesh, in_specs=(node2, node2, rep, rep, rep, rep),
                      out_specs=None)
    nreq, nest = _carried(ops)
    quse = quotas.used.clone()
    chosen_buf = torch.full((PCAP + W,), -1, dtype=torch.int32, device=lead)
    resolve = _Resolution(lead, cfg=cfg, n_total=N, prod_sensitive=prod_sensitive)
    if split is not None:
        split["resolve_graphed"] = resolve.graphed
    ptr = 0
    nrounds = 0
    tick("prep")
    while ptr < PCAP:  # koordlint: disable=host-sync-in-jit(the pointer is the host int the round's commit count advanced, ROADMAP Queue C "The sharded cycle's host reads")
        ps = order_pad[ptr:ptr + W]
        wvalid = (ptr + iota_w) < PCAP
        preq_wave, pest_wave = pods.requests[ps], pods.estimated[ps]
        pprod_wave = is_prod_pods[ps]
        psreq_wave = score_requests[ps]
        outs = key_pass(ops.alloc, nreq, nest, ops.usage, ops.uprod, ops.okd, ops.okp,
                        ops.fresh, ops.xmask, ops.xscores,
                        (ps, preq_wave, psreq_wave, pest_wave, pods.valid[ps], pprod_wave))
        tick("keys")
        # the round's one gather: every shard's payload, [S, W, ...]
        gathered = {k: v.full(lead) for k, v in zip(names, outs)}
        if most_alloc:
            cand_key = merge_topm_keys(gathered["key"], M)
            R = gathered["u_alloc"].shape[-1]
            u_gid = gathered["u_gid"].reshape(-1)
            U = u_gid.shape[0]
            universe = dict(
                gid=u_gid,
                alloc=gathered["u_alloc"].reshape(U, R),
                nreq=gathered["u_nreq"].reshape(U, R),
                nest=gathered["u_nest"].reshape(U, R),
                usage=gathered["u_usage"].reshape(U, R),
                okd=gathered["u_okd"].reshape(U),
                fresh=gathered["u_fresh"].reshape(U),
                # [S, W, W*M] -> [W, U], aligned with u_gid's (s, k) order
                xval=gathered["u_xval"].movedim(0, 1).reshape(W, U),
                xfeas=gathered["u_xfeas"].movedim(0, 1).reshape(W, U),
            )
            if prod_sensitive:
                universe["uprod"] = gathered["u_uprod"].reshape(U, R)
                universe["okp"] = gathered["u_okp"].reshape(U)
            cand = None
        else:
            cand_key, cand = merge_topm(gathered, M)
            universe = None
        tick("gather_merge")
        choices, committed, done, quse, ncommit = resolve(
            cand_key=cand_key, cand=cand, universe=universe,
            preq_wave=preq_wave, pest_wave=pest_wave, psreq_wave=psreq_wave,
            pqid_wave=pods.quota_id[ps], pvalid_wave=pods.valid[ps],
            pprod_wave=pprod_wave, wvalid=wvalid, qrt=quotas.runtime,
            qlim=quotas.limited, quse=quse,
        )
        tick("resolve")
        # each shard applies the committed prefix to its own node rows
        apply(nreq, nest, choices, committed, preq_wave, pest_wave)
        # positions not committed this round keep their value: they are
        # rewritten when their round comes
        window = chosen_buf[ptr:ptr + W]
        chosen_buf[ptr:ptr + W] = torch.where(done, choices.to(torch.int32), window)
        tick("apply")
        # the round's one host read: the queue pointer's advance
        ptr += int(ncommit)  # koordlint: disable=host-sync-in-jit(the round loop's condition needs the commit count, ROADMAP Queue C "The sharded cycle's host reads")
        nrounds += 1
        tick("host_read")
        if split is not None:
            split["host_reads"] += 1
    return _finish(ops, mesh, order, chosen_buf[:PCAP].clone(), nreq, nest, quse, orig_n,
                   rounds=nrounds)


def _prepare(snapshot, mesh, extra_mask, extra_scores, candidates=None):
    """Check the extras, AND a candidate map into the mask, and pad the
    node axis (and the extras' columns) to a multiple of the mesh size.
    Returns (snapshot, extra_mask, extra_scores, unpadded node count)."""
    _check_scores(extra_scores)
    orig_n = snapshot.nodes.allocatable.shape[0]
    if candidates is not None:
        from koordinator_tpu_torch.solver.candidates import candidate_membership_mask

        member = candidate_membership_mask(candidates, orig_n)
        extra_mask = member if extra_mask is None else extra_mask & member
    snapshot = _pad_nodes_to(snapshot, mesh.size)
    padded_n = snapshot.nodes.allocatable.shape[0]
    return (snapshot, _pad_extras(extra_mask, padded_n), _pad_extras(extra_scores, padded_n),
            orig_n)


def greedy_assign_waves(
    snapshot: ClusterSnapshot,
    mesh: Mesh,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    extra_mask: Optional[torch.Tensor] = None,
    extra_scores: Optional[torch.Tensor] = None,
    wave: int = 32,
    top_m: int = 4,
    spans=None,
    candidates: Optional[torch.Tensor] = None,
    split: Optional[dict] = None,
):
    """Round-based sharded assignment, equal to ``greedy_assign`` bit for
    bit with one gather per round instead of one max per pod.  Returns
    ``(CycleResult, rounds)``; the result's ``path`` is ``"shard"``.

    ``snapshot`` is a plain snapshot (its node rows are split over the
    mesh for the call) or one already placed on ``mesh``
    (``shard_cluster_snapshot``, the mesh-resident servicer's), whose
    shards are read where they live.  ``candidates``: an optional [P, C]
    sparse candidate map (``solver/candidates.py``), ANDed into
    ``extra_mask`` before the node padding; exact when the lists did not
    overflow.  ``spans``: an optional ``obs.spans.SpanRecorder`` timing the
    host stages (``shard_prep``, ``shard_rounds``).  ``split``: a dict
    that receives the host seconds of each stage of the round loop (prep,
    key passes, gather and merge, resolve, apply, the host read) and the
    count of host reads."""
    with maybe_span(spans, "shard_prep"):
        snapshot, extra_mask, extra_scores, orig_n = _prepare(
            snapshot, mesh, extra_mask, extra_scores, candidates)
    with maybe_span(spans, "shard_rounds"):
        result = _assign_waves(snapshot, extra_mask, extra_scores, cfg, mesh, int(wave),
                               int(top_m), orig_n, split)
    return result, int(result.rounds)


def greedy_assign_sharded(
    snapshot: ClusterSnapshot,
    mesh: Mesh,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    extra_mask: Optional[torch.Tensor] = None,
    extra_scores: Optional[torch.Tensor] = None,
) -> CycleResult:
    """Sequential-parity greedy assignment with node state split over every
    position of ``mesh`` and one max over the shards per pod step.
    Placements equal ``greedy_assign``'s; ``node_requested`` and
    ``node_estimated`` come back assembled on the lead device, trimmed to
    the snapshot's node bucket."""
    snapshot, extra_mask, extra_scores, orig_n = _prepare(
        snapshot, mesh, extra_mask, extra_scores)
    return _assign_sharded(snapshot, extra_mask, extra_scores, cfg, mesh, orig_n)
