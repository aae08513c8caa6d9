"""The BatchedScorer servicer: Sync, Score and Assign on the resident
snapshot, and its gRPC transport.

Counterpart of ``koordinator_tpu/bridge/server.py``.  One
process owns the card; callers talk over a unix socket, through the raw
framing of ``udsserver.py`` or through gRPC (``make_server``).  Score and
Assign run the same device programs as the in-process API
(``solver.score_cycle``/``masked_top_k``, ``solver.run_cycle``), so a
client gets the placements an embedded caller gets.

Concurrency, as in the reference:

* ``_sync_lock`` serializes Sync RPCs and pins the mirror baseline for the
  wire decode, which runs outside the device critical section.
* ``_state_lock`` guards the mirrors, the generation counter, the Assign
  result memo and telemetry sequencing; it is never held across a device
  launch or a blocking readback.
* the **pipelined dispatch queue** (``coalesce.py``): concurrent Scores
  stack into one launch whose replies are demultiplexed per caller; the
  launch runs under the launch lock, the readback off it.  A Sync whose
  commit writes into resident tensors drains the pipeline first
  (``ResidentState.commit_donates``); other commits keep it flowing.

Where the port differs from the reference:

* ``run_cycle`` synchronises inside each rung, so an Assign holds the
  launch lock for its whole cycle (the reference returns at enqueue and
  reads back off the lock).  ``masked_top_k`` reads one flag back to pick
  its path, so a Score launch also waits for its scoring.  Both are
  correct and serialise device work behind the lock.
* every readback is one device->host transfer (``read_back``), and a
  Score reads back the feasibility of its top-k cells only ([P, k], the
  ``ok`` matrix), not the [P, N] feasible tensor — except where the
  brownout cache keeps the full tensors (``KOORD_BROWNOUT_FULL_CELLS``).
* with a mesh, the shard Assign (``parallel.greedy_assign_waves``) runs
  its rounds under the launch lock and reads its placements back there, as
  the reference's demotion guard does; its fallback is the single-device
  ``run_cycle`` on the mesh's lead device.

Replication seam, as in the reference: ``journal_hook`` and then
``replication_hook`` run under ``_sync_lock`` after every committed Sync,
with the client's original bytes where the transport had them
(``wire_bytes``); ``export_replication_snapshot`` is the full-state frame
a subscriber opens with, and ``apply_replica_frame`` applies a leader's
frame — a delta through the same stage/commit seam and commit rule as a
client Sync, a full frame onto a fresh ``ResidentState``.
"""

from __future__ import annotations

import enum
import logging
import os
import threading
import time
import uuid
from typing import List, Optional

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.coalesce import (
    AdaptiveGatherWindow,
    CoalescingDispatcher,
    DEFAULT_DEPTH,
    DeadlineExpired,
    PendingRequest,
    ScoreMemo,
    SnapshotNotResident,
    launch_section,
)
from koordinator_tpu_torch.bridge.state import ResidentState
from koordinator_tpu_torch.config import CycleConfig, DEFAULT_CYCLE_CONFIG
from koordinator_tpu_torch.model.snapshot import pad_bucket
from koordinator_tpu_torch.obs import CycleTelemetry
from koordinator_tpu_torch.obs import devprof
from koordinator_tpu_torch.obs import lockwitness
from koordinator_tpu_torch.obs.lockwitness import witness_lock
from koordinator_tpu_torch.obs.spans import (
    device_stage,
    stage,
    stage_at,
    stage_since_arrival,
)
from koordinator_tpu_torch.parallel.mesh import check_mesh, gather, is_sharded, local
from koordinator_tpu_torch.replication.admission import (
    AdmissionGate,
    BreakerOpen,
    CircuitBreaker,
    ResourceExhausted,
)
from koordinator_tpu_torch.solver import (
    CandidateOverflow,
    build_candidates,
    masked_top_k,
    refresh_candidates,
    run_cycle,
    score_candidates,
    score_cycle,
    score_cycle_sharded,
    score_upper_bound,
    sparse_top_k,
)
from koordinator_tpu_torch.solver.candidates import check_candidate_overflow
from koordinator_tpu_torch.solver.terms import term_names
from koordinator_tpu_torch.solver.topk import masked_top_k_host

logger = logging.getLogger(__name__)

SERVICE = wire.SERVICE


class StatusCode(enum.Enum):
    """The RPC status codes the servicer aborts with; the gRPC transport
    maps each to the ``grpc.StatusCode`` of the same name."""

    FAILED_PRECONDITION = "failed precondition"
    RESOURCE_EXHAUSTED = "resource exhausted"
    DEADLINE_EXCEEDED = "deadline exceeded"
    UNAVAILABLE = "unavailable"
    # any other failure the client sees (a server error the codes above do
    # not name); the servicer never aborts with it
    UNKNOWN = "unknown"


_NP_DTYPES = {
    torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
}


def read_back(*tensors):
    """Host numpy copies of ``tensors`` in ONE device->host transfer: the
    tensors' bytes are concatenated on their device, copied once and split
    again on the host.  ``None`` and plain Python values pass through."""
    live = [t for t in tensors if isinstance(t, torch.Tensor)]
    if not live:
        return tensors
    host = torch.cat(
        [t.contiguous().reshape(-1).view(torch.uint8) for t in live]
    ).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        n = t.numel() * t.element_size()
        out.append(host[off:off + n].view(_NP_DTYPES[t.dtype]).reshape(tuple(t.shape)))
        off += n
    return tuple(out)


def _devprof_span_attrs(span, notes) -> None:
    """Attach the launch ledger's notes (``obs/devprof.py``, drained on the
    thread that ran the boundaries) to a launch/RPC span: sampled device
    time, and whether a boundary built or loaded a kernel (with the
    build's ms) — the host/device split the assemble waterfall renders.
    No notes (the ledger off, or an unsampled launch) = no attributes, so
    traces stay as they are with the ledger off."""
    if not notes:
        return
    dev = [n["device_us"] for n in notes if n.get("device_us") is not None]
    if dev:
        span.set_attr("device_us", round(sum(dev), 1))
    if any(n.get("compiled") for n in notes):
        span.set_attr("compiled", True)
        span.set_attr(
            "build_ms", round(sum(n.get("build_ms") or 0.0 for n in notes), 2)
        )


class _AssignMemo:
    """One (snapshot id, CycleConfig)'s certified Assign result.

    The owner (first RPC to miss) runs the cycle and publishes under the
    servicer's ``_state_lock``; waiters block on ``done`` outside every
    lock.  ``result`` is host-side (never device tensors).  A generation
    bump clears the memo dict, but an entry already handed to a waiter
    stays valid: that waiter passed its generation check before the
    bump."""

    __slots__ = ("done", "result", "error", "span_ref")

    def __init__(self):
        self.done = threading.Event()
        # (assignment, status, valid, path, rounds, eff_wave, cycle_ms)
        self.result = None
        self.error: Optional[BaseException] = None
        # the owner's (trace_id, span_id) when its RPC was traced
        self.span_ref = None


class ScorerServicer:
    def __init__(
        self,
        cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
        mesh=None,
        state_dir=None,
        telemetry: Optional[CycleTelemetry] = None,
        coalesce_max_batch: int = 16,
        coalesce_window_ms: Optional[float] = None,
        pipeline_depth: int = DEFAULT_DEPTH,
        mesh_resident: bool = False,
        coalesce_cap_ms: Optional[float] = None,
        score_memo: bool = True,
        max_inflight: int = 0,
        score_incr: bool = True,
        score_incr_max_ratio: Optional[float] = None,
        breaker_threshold: Optional[int] = None,
        breaker_cooldown_ms: Optional[float] = None,
        brownout_max_lag: Optional[int] = None,
        trace_export: Optional[str] = None,
        shed_fractions=None,
        device=None,
        devprof_sample: Optional[int] = None,
    ):
        """The reference's knobs, with the same meanings and defaults:

        * ``score_memo``: serve Scores of an unchanged (snapshot id,
          CycleConfig) as prefixes of one memoized top-k readback;
        * ``score_incr``: keep the [P, N] score tensors resident and
          rescore only the rows and columns warm Syncs dirtied, up to a
          dirty-cost fraction ``score_incr_max_ratio`` (default
          ``KOORD_SCORE_INCR_MAX_RATIO``, else 0.5) past which a full
          ``score_cycle`` runs;
        * ``max_inflight`` / ``shed_fractions``: the band-aware admission
          gate in front of Score and Assign (0 = off; Sync never sheds);
        * ``breaker_threshold`` / ``breaker_cooldown_ms`` /
          ``brownout_max_lag``: the circuit breaker (defaults from
          ``KOORD_BREAKER_THRESHOLD`` 3, ``KOORD_BREAKER_COOLDOWN_MS`` 250,
          ``KOORD_BROWNOUT_MAX_LAG`` 2): consecutive launch failures open
          it; while open, Score serves the brownout cache (at most that
          many generations stale, flagged ``degraded``) and Assign fails
          fast;
        * ``coalesce_max_batch`` / ``coalesce_window_ms`` /
          ``coalesce_cap_ms`` / ``pipeline_depth``: the dispatcher
          (``coalesce.py``);
        * ``state_dir`` / ``telemetry`` / ``trace_export``: flight-recorder
          dumps, an injected CycleTelemetry, the span export directory;
        * ``devprof_sample``: configure the process-global launch ledger
          (``obs/devprof.py``) to time 1 launch in N (0 = off) into this
          servicer's metrics, dumping under ``state_dir``; None leaves the
          ledger as it is.

        ``device``: the card the resident snapshot lives on (default CUDA,
        raising when absent; ``"cpu"`` runs the plain path).

        ``mesh`` (a ``parallel.mesh.Mesh``): Assign runs the round-based
        sharded cycle (``parallel.greedy_assign_waves``, wave widened to 32
        from a per-pod config) and replies ``path="shard"``; a term config
        serves Assign through the single-device ``run_cycle``.  A shard
        failure demotes its shape bucket and serves the RPC through
        ``run_cycle`` on the mesh's lead device, with the same placements;
        the reply's path and the cycle's ``shard_error`` span note say so.
        ``mesh_resident``: the snapshot itself lives on the mesh
        (``bridge/state.py``): node tensors split, deltas scattered into
        the owning shard, Score and the incremental rescore computed shard
        by shard.  Pass a 1-D ``parallel.cluster_mesh``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = check_mesh(mesh)
        self.mesh_resident = bool(mesh_resident and mesh is not None)
        self.state = ResidentState(mesh=mesh if self.mesh_resident else None,
                                   device=self.device)
        self._generation = 0
        # per-boot epoch in every snapshot id ("s<epoch>-<gen>"): a client
        # checking bare generation continuity could coincidentally pass
        # after a restart reset the counter; the epoch makes it visible
        self._epoch = uuid.uuid4().hex[:8]
        self.telemetry = telemetry or CycleTelemetry(
            epoch=self._epoch, cfg=cfg, state_dir=state_dir,
            trace_export=trace_export,
        )
        if lockwitness.enabled():
            lockwitness.attach_metrics(self.telemetry.metrics)
        # lock order where nesting happens: launch -> state
        self._sync_lock = witness_lock(
            "bridge.server.ScorerServicer._sync_lock")
        self._state_lock = witness_lock(
            "bridge.server.ScorerServicer._state_lock")
        # Assign result memo: (snapshot id, CycleConfig) -> _AssignMemo,
        # cleared atomically with every generation bump
        self._assign_memo = {}
        # the last computed Assign's CycleResult (device tensors), for the
        # daemon's /debug/last-cycle digests
        self.last_cycle = None
        self._score_memo = ScoreMemo() if score_memo else None
        self._score_incr = bool(score_incr)
        if score_incr_max_ratio is None:
            # `or`: an empty env value means unset
            score_incr_max_ratio = float(
                os.environ.get("KOORD_SCORE_INCR_MAX_RATIO") or "0.5"
            )
        self._score_incr_max_ratio = float(score_incr_max_ratio)
        self.admission = AdmissionGate(
            max_inflight, shed_fractions=shed_fractions
        )
        if breaker_threshold is None:
            breaker_threshold = int(
                os.environ.get("KOORD_BREAKER_THRESHOLD") or "3"
            )
        if breaker_cooldown_ms is None:
            breaker_cooldown_ms = float(
                os.environ.get("KOORD_BREAKER_COOLDOWN_MS") or "250"
            )
        if brownout_max_lag is None:
            brownout_max_lag = int(
                os.environ.get("KOORD_BROWNOUT_MAX_LAG") or "2"
            )
        self.breaker = CircuitBreaker(
            threshold=breaker_threshold,
            cooldown_ms=breaker_cooldown_ms,
            on_transition=self._breaker_transition,
        )
        self._brownout_max_lag = max(0, int(brownout_max_lag))
        # the brownout cache keeps the launch's full [P, N] scores and
        # feasibility while P x N <= this many cells (default 4M), so a
        # breaker-open Score wanting a wider top-k is ranked on the host;
        # past the gate only the padded top-k is kept
        self._brownout_full_cells = int(
            os.environ.get("KOORD_BROWNOUT_FULL_CELLS") or str(1 << 22)
        )
        self._term_names = term_names(cfg)
        # host-side brownout cache: the last Score launch's padded top-k
        # readback and the (epoch, generation, cfg, geometry) it
        # certified; survives generation bumps (bounded staleness is
        # what the breaker-open path serves).  Guarded by _state_lock.
        self._brownout = None
        self.degraded_replies = 0
        # replication seam: the leader's publisher streams every committed
        # Sync through replication_hook, and the frame journal appends it
        # through journal_hook first (durability, then fan-out); both run
        # under _sync_lock, so frames leave in generation order
        self.replication_hook = None
        self.journal_hook = None
        self.dispatch = CoalescingDispatcher(
            self._score_launch_batch,
            max_batch=coalesce_max_batch,
            window=(
                AdaptiveGatherWindow(
                    **({} if coalesce_cap_ms is None
                       else {"cap_ms": coalesce_cap_ms})
                )
                if coalesce_window_ms is None else None
            ),
            gather_window_s=(coalesce_window_ms or 0.0) / 1000.0,
            depth=pipeline_depth,
        )
        self.dispatch.deadline_hook = self._count_gather_expired
        self.dispatch.launch_outcome_hook = self._launch_outcome
        self.telemetry.metrics.set_breaker_state(self.breaker.state())
        self.telemetry.metrics.set_candidate_width(self.cfg.candidate_width)
        if devprof_sample is not None:
            # the metrics sink is a weakref inside devprof, so this
            # servicer's lifetime is never extended
            devprof.configure(
                sample=devprof_sample,
                metrics=self.telemetry.metrics,
                state_dir=state_dir,
            )

    # -- degradation ladder seams --
    def _breaker_transition(self, to: str) -> None:
        self.telemetry.metrics.set_breaker_state(to)
        self.telemetry.metrics.count_breaker_transition(to)

    def _count_gather_expired(self, n: int) -> None:
        self.telemetry.metrics.count_deadline_expired("gather", n)

    def _launch_outcome(self, outcome: str, exc) -> None:
        """The dispatcher's launch-outcome hook -> the breaker.  Only real
        launch faults count as failures: request-level rejections (a
        displaced snapshot, an expired deadline, a shed, a too-narrow
        candidate width) say nothing about the device."""
        if outcome == "ok":
            self.breaker.record_success()
        elif outcome == "error":
            if isinstance(exc, (SnapshotNotResident, DeadlineExpired,
                                ResourceExhausted, CandidateOverflow)):
                self.breaker.release_probe()
            else:
                self.breaker.record_failure()
        else:  # "none": no device work happened, nothing was probed
            self.breaker.release_probe()

    def _deadline_budget_ms(self, req, ctx) -> float:
        """Remaining deadline budget in ms: the wire field and the gRPC
        transport deadline, whichever is tighter.  0 = no deadline;
        NEGATIVE = already expired on arrival."""
        budget = float(getattr(req, "deadline_ms", 0) or 0)
        if ctx is not None:
            try:
                remaining = ctx.time_remaining()
            except Exception:  # koordlint: disable=broad-except(a transport without deadline support must not fail the RPC; the wire field still applies)
                remaining = None
            if remaining is not None:
                remaining_ms = float(remaining) * 1000.0
                if remaining_ms <= 0.0:
                    remaining_ms = -1.0
                if budget <= 0.0:
                    budget = remaining_ms
                else:
                    budget = min(budget, remaining_ms)
        return budget

    def snapshot_id(self) -> str:
        return f"s{self._epoch}-{self._generation}"

    def rebase_epoch(self, epoch: Optional[str] = None) -> str:
        """Mint a fresh epoch while KEEPING the generation; the memos die
        with the old chain."""
        with self._sync_lock:
            with self._state_lock:
                return self._rebase_epoch_locked(epoch)

    def _rebase_epoch_locked(self, epoch: Optional[str] = None) -> str:
        """The bump itself, ``_sync_lock`` and ``_state_lock`` held;
        ``FollowerServicer.promote`` composes it with its promoted flag
        under one hold."""
        self._epoch = epoch or uuid.uuid4().hex[:8]
        self._assign_memo.clear()
        if self._score_memo is not None:
            self._score_memo.invalidate()
        return self.snapshot_id()

    def _stale_snapshot(
        self, want: str, sid: Optional[str] = None
    ) -> Optional[SnapshotNotResident]:
        """The one stale-snapshot test, shared by the serial and the
        coalesced paths: the FULL id must match, epoch included."""
        sid = self.snapshot_id() if sid is None else sid
        if want and want != sid:
            return SnapshotNotResident(
                f"snapshot {want!r} is not resident (current {sid})"
            )
        return None

    def _check_generation(self, req, ctx) -> None:
        exc = self._stale_snapshot(getattr(req, "snapshot_id", ""))
        if exc is not None:
            if ctx is not None:
                ctx.abort(StatusCode.FAILED_PRECONDITION, str(exc))
            raise exc

    # -- distributed tracing --
    def _start_rpc_span(self, name: str, req, **attrs):
        """The per-RPC server span, parented under the client's attempt
        span, or None when the request carries no trace context."""
        trace_id = getattr(req, "trace_id", "") or ""
        if not trace_id:
            return None
        return self.telemetry.spans.start_trace_span(
            name, trace_id,
            parent_id=getattr(req, "parent_span", "") or None,
            kind="server", attrs={k: v for k, v in attrs.items() if v},
        )

    # -- RPC bodies --
    def sync(self, req: "wire.SyncRequest", ctx=None,
             wire_bytes: Optional[bytes] = None) -> "wire.SyncReply":
        """Tracing shell over :meth:`_sync_impl`.  ``wire_bytes``: the
        client's original frame, when the transport has it (the raw
        framing does), which the journal and the publisher then carry
        verbatim instead of a re-encode."""
        with self.telemetry.spans.rpc("sync"):
            tspan = self._start_rpc_span("sync", req)
            if tspan is None:
                return self._sync_impl(req, wire_bytes)
            try:
                reply = self._sync_impl(req, wire_bytes)
            except BaseException as exc:
                tspan.abort(exc)
                raise
            tspan.set_attr("snapshot_id", reply.snapshot_id)
            reply.server_span = tspan.span_id
            tspan.end()
            return reply

    def _sync_impl(self, req: "wire.SyncRequest",
                   wire_bytes: Optional[bytes] = None) -> "wire.SyncReply":
        # phase 1 under _sync_lock only: the wire->numpy decode runs while
        # coalesced Scores launch
        with self._sync_lock:
            t_stage = time.perf_counter_ns()
            try:
                staged = self.state.stage_sync(req)
            except Exception as exc:
                # ValueError = a frame validation REJECTED (the client's
                # bug): error counter only, no flight record; anything
                # else is a server-side failure: full abort
                with self._state_lock:
                    if isinstance(exc, ValueError):
                        self.telemetry.metrics.count_cycle_error("sync")
                    else:
                        self.telemetry.abort_cycle("sync", exc)
                raise
            t_staged = time.perf_counter_ns()
            stage_at("stage", t_stage, t_staged)

            # phase 2 — atomic commit + the device update, under
            # launch -> state
            def commit() -> "wire.SyncReply":
                stage_at("wait", t_queued, time.perf_counter_ns())
                with self._state_lock:
                    self.telemetry.flush_backlog()
                    spans = self.telemetry.spans
                    spans.add_measured("sync_decode", t_stage, t_staged)
                    try:
                        with stage("commit"):
                            info = self.state.commit_sync(
                                staged, spans=spans, plan=plan_cell[0]
                            )
                    except Exception as exc:
                        self.telemetry.abort_cycle("sync", exc)
                        raise
                    self._generation += 1
                    # the memos die with the generation they certified
                    self._assign_memo.clear()
                    if self._score_memo is not None:
                        self._score_memo.invalidate()
                    self.telemetry.record_sync(
                        info,
                        snapshot_id=self.snapshot_id(),
                        epoch=self._epoch,
                        generation=self._generation,
                    )
                    return wire.SyncReply(
                        snapshot_id=self.snapshot_id(),
                        nodes=self.state.node_alloc.shape[0],
                        pods=self.state.pod_requests.shape[0],
                    )

            # the drain decision runs with the launch lock held: residency
            # only flips inside a launch section, so the plan decided here
            # is the one commit() runs
            plan_cell = [None]

            def _decide_drain() -> bool:
                plan_cell[0] = self.state.plan_commit(staged)
                return self.state.commit_donates(staged, plan=plan_cell[0])

            t_queued = time.perf_counter_ns()
            reply = self.dispatch.run_exclusive(commit, drain=_decide_drain)
            # still under _sync_lock: frames are journaled and published in
            # generation order.  The Sync is committed either way, so a
            # hook's failure is logged, never the client's error
            for name, hook in (("journal append", self.journal_hook),
                               ("replication publish", self.replication_hook)):
                if hook is None:
                    continue
                try:
                    hook(req, reply.snapshot_id, wire_bytes)
                except Exception:  # the acked write stands; followers detect the gap and resync
                    logger.exception("%s failed for %s", name, reply.snapshot_id)
            return reply

    # -- replication seam --
    def export_replication_snapshot(self):
        """``(epoch, generation, payload)`` of the current resident state:
        the full frame a new or resyncing subscriber receives.  ``payload``
        is the full-state SyncRequest bytes (empty before the first Sync).
        Read under ``_state_lock``, so the pair is one committed Sync's
        outcome."""
        with self._state_lock:
            epoch, gen = self._epoch, self._generation
            req = self.state.export_sync_request()
        return epoch, gen, (b"" if req is None else req.SerializeToString())

    def apply_replica_frame(self, frame, origin: str = "replica_apply") -> dict:
        """Apply one replication frame (``replication/codec.py Frame``) and
        adopt the leader's ``(epoch, generation)``.  Continuity is the
        caller's (``replication/follower.py ReplicaApplier``).

        * a delta frame runs the stage/commit seam a client Sync runs,
          under the same commit rule: a commit that writes into resident
          tensors (``ResidentState.commit_donates``) drains the in-flight
          launches first;
        * a full frame stages onto a FRESH ``ResidentState`` and swaps it
          in without a drain: nothing resident is written, and in-flight
          launches keep their own tensors.

        A frame that fails validation raises before anything changes.  A
        payload carrying a trace id opens a consumer span (``origin``:
        ``replica_apply`` or ``journal_replay``) in the originating
        trace."""
        from koordinator_tpu_torch.replication import codec

        payload = frame.payload
        # an empty FULL payload resets to the empty pre-first-Sync state;
        # an empty DELTA payload is a real no-change Sync and applies
        if frame.kind == codec.KIND_FULL:
            req = wire.SyncRequest.FromString(payload) if payload else None
        else:
            req = wire.SyncRequest.FromString(payload)
        aspan = None
        if req is not None and (getattr(req, "trace_id", "") or ""):
            aspan = self.telemetry.spans.start_trace_span(
                origin, req.trace_id,
                parent_id=getattr(req, "parent_span", "") or None,
                kind="consumer",
                attrs={
                    "epoch": frame.epoch,
                    "generation": int(frame.generation),
                    "frame_kind": (
                        "full" if frame.kind == codec.KIND_FULL else "delta"
                    ),
                },
            )
        try:
            with self._sync_lock:
                if frame.kind == codec.KIND_FULL:
                    fresh = ResidentState(mesh=self.state.mesh, device=self.device)
                    staged = None if req is None else fresh.stage_sync(req)

                    def commit_full() -> dict:
                        with self._state_lock:
                            self.state = fresh
                            info = (
                                {"path": "cold", "delta_tensors": 0,
                                 "full_tensors": 0}
                                if staged is None
                                else fresh.commit_sync(staged)
                            )
                            self._adopt_replica_locked(frame, info)
                            return info

                    info = self.dispatch.run_exclusive(commit_full, drain=False)
                else:
                    staged = self.state.stage_sync(req)
                    plan_cell = [None]

                    def commit_seq() -> dict:
                        with self._state_lock:
                            info = self.state.commit_sync(
                                staged, plan=plan_cell[0]
                            )
                            self._adopt_replica_locked(frame, info)
                            return info

                    def _decide_drain() -> bool:
                        plan_cell[0] = self.state.plan_commit(staged)
                        return self.state.commit_donates(
                            staged, plan=plan_cell[0]
                        )

                    info = self.dispatch.run_exclusive(
                        commit_seq, drain=_decide_drain
                    )
        except BaseException as exc:
            if aspan is not None:
                aspan.abort(exc)
            raise
        if aspan is not None:
            aspan.set_attr("snapshot_id", self.snapshot_id())
            aspan.end()
        return info

    def _adopt_replica_locked(self, frame, info) -> None:
        """Adopt the leader's snapshot id after a replica apply
        (``_state_lock`` held): epoch and generation move to the frame's,
        and the memos die as on a client Sync."""
        self._epoch = frame.epoch
        self._generation = frame.generation
        self._assign_memo.clear()
        if self._score_memo is not None:
            self._score_memo.invalidate()
        # the same backlog valve as a client Sync: a follower applying an
        # endless stream with no Assign must not grow one pending cycle
        self.telemetry.flush_backlog()
        self.telemetry.record_sync(
            info,
            snapshot_id=self.snapshot_id(),
            epoch=frame.epoch,
            generation=frame.generation,
        )

    def score(self, req: "wire.ScoreRequest", ctx=None) -> "wire.ScoreReply":
        """Tracing shell over :meth:`_score_impl`."""
        with self.telemetry.spans.rpc("score"):
            tspan = self._start_rpc_span(
                "score", req,
                band=getattr(req, "band", "") or "",
                top_k=int(getattr(req, "top_k", 0) or 0),
            )
            if tspan is None:
                return self._score_impl(req, ctx, None)
            try:
                reply = self._score_impl(req, ctx, tspan)
            except BaseException as exc:
                tspan.abort(exc)
                raise
            if reply.degraded:
                tspan.set_attr("degraded", True)
            reply.server_span = tspan.span_id
            tspan.end()
            return reply

    def _score_impl(self, req: "wire.ScoreRequest", ctx=None,
                    tspan=None) -> "wire.ScoreReply":
        # the degradation ladder, in rung order: admission sheds; an
        # exhausted deadline is refused before it costs a launch; an open
        # breaker serves the brownout cache or fails fast; the coalescer
        # evicts entries whose budget expires while queued
        band = getattr(req, "band", "") or ""
        try:
            gate = self.admission.admit("score", band)
            gate.__enter__()
        except ResourceExhausted as exc:
            self.telemetry.metrics.count_shed("score", band)
            if ctx is not None:
                ctx.abort(StatusCode.RESOURCE_EXHAUSTED, str(exc))
            raise
        try:
            budget = self._deadline_budget_ms(req, ctx)
            if budget < 0.0:
                self.telemetry.metrics.count_deadline_expired("queue")
                exc = DeadlineExpired("score", "queue", budget)
                if ctx is not None:
                    ctx.abort(StatusCode.DEADLINE_EXCEEDED, str(exc))
                raise exc
            if not self.breaker.allow_launch():
                reply = self._serve_brownout(req, tspan)
                if reply is not None:
                    return reply
                self.telemetry.metrics.count_breaker_rejected("score")
                exc = BreakerOpen(
                    "score", self.breaker.retry_after_ms(),
                    "brownout cache cannot serve within "
                    f"--brownout-max-lag={self._brownout_max_lag}",
                )
                if ctx is not None:
                    ctx.abort(StatusCode.UNAVAILABLE, str(exc))
                raise exc
            deadline_at = (
                time.perf_counter() + budget / 1000.0
                if budget > 0.0 else None
            )
            try:
                entry = self.dispatch.submit(
                    req, deadline_at=deadline_at, budget_ms=budget,
                    trace_span=tspan,
                )
            except (SnapshotNotResident, CandidateOverflow) as exc:
                if ctx is not None:
                    ctx.abort(StatusCode.FAILED_PRECONDITION, str(exc))
                raise
            except DeadlineExpired as exc:
                if ctx is not None:
                    ctx.abort(StatusCode.DEADLINE_EXCEEDED, str(exc))
                raise
            # queued from submit() to its batch's launch section, which
            # stamped queue_delay_ms on the dispatcher's perf_counter clock
            stage_at(
                "wait", int(entry.enqueued_at * 1e9),
                int((entry.enqueued_at + entry.queue_delay_ms / 1e3) * 1e9),
            )
            return entry.reply
        finally:
            gate.__exit__(None, None, None)

    def _serve_brownout(self, req, tspan=None) -> Optional["wire.ScoreReply"]:
        """Serve one breaker-open Score STALE from the brownout cache, or
        None when the bound (or the cache's coverage) refuses it.  The
        reply is flagged ``degraded`` and certifies a generation at most
        ``brownout_max_lag`` behind the named one — same epoch, geometry
        and CycleConfig, a top-k no wider than the cache holds (or ranked
        on the host from the cached full scores).  Host numpy only."""
        with self._state_lock:
            if self._stale_snapshot(
                getattr(req, "snapshot_id", "")
            ) is not None:
                return None
            cache = self._brownout
            if cache is None or cache["epoch"] != self._epoch:
                return None
            lag = self._generation - cache["gen"]
            if lag < 0 or lag > self._brownout_max_lag:
                return None
            if cache["cfg"] != self.cfg:
                return None
            st = self.state
            if (
                st.node_alloc is None
                or st.pod_requests is None
                or st.node_alloc.shape[0] != cache["nodes"]
                or st.pod_requests.shape[0] != cache["pods"]
            ):
                return None  # geometry moved: the cached rows misalign
            k = min(int(req.top_k) or cache["N"], cache["N"])
            # one consistent read of the cached columns under the lock
            ts, ti, ok, kb = cache["ts"], cache["ti"], cache["ok"], cache["kb"]
            if k > kb and cache.get("scores") is None:
                return None  # the cache cannot invent columns
        if k > kb:
            # rank the cached full scores on the host, as the launch would
            ts, ti = masked_top_k_host(cache["scores"], cache["feasible"], k)
            ok = np.take_along_axis(cache["feasible"], ti, axis=1)
            with self._state_lock:
                if self._brownout is cache and k > cache["kb"]:
                    cache.update(ts=ts, ti=ti, ok=ok, kb=k)
        reply = self._assemble_score_reply(
            req, k, ts, ti, ok, cache["valid"], cache["P"], degraded=True,
        )
        if tspan is not None:
            tspan.link_ref(cache.get("launch_span"))
            tspan.set_attr("brownout_lag", lag)
        with self._state_lock:
            self.degraded_replies += 1
            self.telemetry.metrics.count_degraded("score")
        return reply

    def _publish_readback(self, sid, entry) -> None:
        """Publish a launch's host readback to the Score memo (while the
        snapshot it certified is current) and to the brownout cache (an
        older launch never replaces a newer entry).  ``_state_lock``
        held."""
        if self._score_memo is not None and sid == self.snapshot_id():
            self._score_memo.put(sid, self.cfg, entry)
        b_epoch, _, b_gen = sid[1:].rpartition("-")
        try:
            b_gen = int(b_gen)
        except ValueError:
            b_gen = -1
        prev = self._brownout
        if b_gen >= 0 and b_epoch == self._epoch and (
            prev is None
            or prev["epoch"] != self._epoch
            or b_gen >= prev["gen"]
        ):
            self._brownout = dict(entry, epoch=b_epoch, gen=b_gen, cfg=self.cfg)

    # -- coalesced Score execution: launch phase (launch lock held)
    #    returning the readback closure the dispatcher runs off the lock --
    @launch_section
    def _score_launch_batch(self, batch: List[PendingRequest]):
        # the execution clock (and the dispatch stage) starts with the
        # launch section: queue wait excluded, snapshot capture included
        t_exec = time.perf_counter_ns()
        with self._state_lock:
            sid = self.snapshot_id()
            accepted = []
            for entry in batch:
                err = self._stale_snapshot(
                    getattr(entry.req, "snapshot_id", ""), sid
                )
                if err is not None:
                    entry.error = err
                else:
                    accepted.append(entry)
            if not accepted:
                return None
            # an unchanged (snapshot id, CycleConfig) whose memoized
            # k-bucket covers every caller serves sliced prefixes
            memo = memo_ks = None
            if self._score_memo is not None:
                memo = self._score_memo.get(sid, self.cfg)
            if memo is not None:
                memo_ks = [
                    min(int(e.req.top_k) or memo["N"], memo["N"])
                    for e in accepted
                ]
                if max(memo_ks) > memo["kb"]:
                    memo = None  # needs a wider launch; it will replace
            incr = None
            # geometry at launch, for the brownout cache's serve checks
            mirror_rows = (
                self.state.node_alloc.shape[0]
                if self.state.node_alloc is not None else 0,
                self.state.pod_requests.shape[0]
                if self.state.pod_requests is not None else 0,
            )
            sparse = self.cfg.candidate_width > 0
            cres = None
            if memo is None:
                try:
                    snap = self.state.snapshot()
                except Exception as exc:
                    self.telemetry.abort_cycle("score", exc)
                    raise
                if sparse:
                    cres = self.state.candidate_residency()
                    if cres is not None and cres.cfg != self.cfg:
                        self.state.drop_candidate_residency()
                        cres = None
                elif self._score_incr:
                    incr = self.state.score_residency()
                    if incr is not None and incr.cfg != self.cfg:
                        self.state.drop_score_residency()
                        incr = None
        if memo is not None:
            # pure host work: a no-device closure run off the launch lock
            def _serve(accepted=accepted, ks=memo_ks, memo=memo, sid=sid):
                return self._score_serve_memo(accepted, ks, memo, sid)

            _serve.no_device = True
            return _serve
        # ONE launch span for the whole coalesced batch, parented under the
        # first traced rider's RPC span; every traced rider links to it
        traced = [e.trace_span for e in accepted
                  if e.trace_span is not None]
        launch_span = None
        if traced:
            lead = traced[0]
            launch_span = self.telemetry.spans.start_trace_span(  # ends in the readback closure; both failure paths abort it
                "score_launch", lead.trace_id, parent_id=lead.span_id,
                kind="internal",
                attrs={"batch": len(accepted), "snapshot_id": sid},
            )
            for t in traced:
                t.link_ref(launch_span.ref)
        launch_ref = None if launch_span is None else launch_span.ref
        if sparse:
            return self._score_launch_sparse(
                accepted, snap, cres, sid, mirror_rows,
                launch_span, launch_ref, t_exec,
            )
        try:
            dev_span = device_stage(self.device)
            devprof.drain_notes()
            N = snap.nodes.capacity
            P = snap.pods.capacity
            ks = [min(int(e.req.top_k) or N, N) for e in accepted]
            # ONE launch serves every caller, at the batch max padded to a
            # power-of-two bucket; each caller's k is a prefix
            k_launch = min(pad_bucket(max(ks)), N)
            # engine order: memo (above) -> incremental rescore of the
            # resident tensors -> full score_cycle; all three give the
            # same tensors to the same masked top-k
            scores = feasible = None
            incr_result = None  # telemetry: incr | full | fallback
            incr_cols = 0
            if self._score_incr:
                if incr is not None:
                    ratio = (
                        len(incr.dirty_nodes) / N + len(incr.dirty_pods) / P
                    )
                    if ratio <= self._score_incr_max_ratio:
                        incr_cols = len(incr.dirty_nodes)
                        try:
                            scores, feasible = self._score_incremental(
                                snap, incr
                            )
                            incr_result = "incr"
                        except Exception:  # the full rescore below is the documented fallback; the residency is dropped so a torn tensor never serves
                            logger.exception(
                                "incremental rescore failed; falling "
                                "back to a full score_cycle"
                            )
                            self.state.drop_score_residency()
                            incr_result = "fallback"
                    else:
                        incr_result = "fallback"
                else:
                    incr_result = "full"  # nothing resident to advance
            if scores is None:
                if is_sharded(snap):
                    # each shard's block on its own device, kept split for
                    # the residency
                    scores, feasible = score_cycle_sharded(snap, self.cfg)
                else:
                    scores, feasible = score_cycle(snap, self.cfg)
            if self._score_incr:
                self.state.store_score_result(self.cfg, scores, feasible)
            # mesh-resident tensors are assembled on the lead device
            scores, feasible = gather(scores), gather(feasible)
            top_scores, top_idx = masked_top_k(
                scores, feasible, k=k_launch,
                hi=score_upper_bound(self.cfg),
            )
            ok = torch.gather(feasible, 1, top_idx.long())
            if dev_span is not None:
                dev_span.close()
            # the brownout cache's full tensors: a COPY of the scores,
            # which the next incremental launch writes in place
            cache_full = P * N <= self._brownout_full_cells
            scores_cache = scores.clone() if cache_full else None
            feasible_cache = feasible if cache_full else None
            dispatched = (t_exec, time.perf_counter_ns())
            stage_at("dispatch", *dispatched)
            devprof_notes = devprof.drain_notes()
        except Exception as exc:
            if launch_span is not None:
                launch_span.abort(exc)
            with self._state_lock:
                self.telemetry.abort_cycle("score", exc)
            raise

        def _readback():
            try:
                t0 = time.perf_counter_ns()
                ts, ti, ok_np, valid_np, scores_np, feasible_np = read_back(
                    top_scores, top_idx, ok, local(snap.pods.valid), scores_cache,
                    feasible_cache,
                )
                read = (t0, time.perf_counter_ns())
                stage_at("readback", *read)
                if dev_span is not None:
                    dev_span.read()
                if launch_span is not None:
                    launch_span.set_attr("k_bucket", k_launch)
                    _devprof_span_attrs(launch_span, devprof_notes)
                    launch_span.end()
                valid = valid_np[:P].astype(bool)
                with self._state_lock:
                    self._publish_readback(sid, dict(
                        kb=k_launch, N=N, P=P, ts=ts, ti=ti, ok=ok_np,
                        valid=valid, launch_span=launch_ref,
                        nodes=mirror_rows[0], pods=mirror_rows[1],
                        scores=scores_np, feasible=feasible_np,
                    ))
                # assembly failures are per-entry: the launch served
                # everyone else
                assembled = []
                n_failed = 0
                for entry, k in zip(accepted, ks):
                    try:
                        entry.reply = self._assemble_score_reply(
                            entry.req, k, ts, ti, ok_np, valid, P,
                        )
                        assembled.append(entry)
                    except Exception as exc:  # routed to the one caller as its RPC error; sibling replies stand
                        entry.error = exc
                        n_failed += 1
                exec_ms = (time.perf_counter_ns() - t_exec) / 1e6
            except Exception as exc:
                if launch_span is not None:
                    launch_span.abort(exc)
                with self._state_lock:
                    self.telemetry.abort_cycle("score", exc)
                raise
            return lambda: self._score_telemetry(
                assembled, sid, dispatched, read, exec_ms, n_failed,
                incr_result=incr_result, incr_cols=incr_cols,
            )

        return _readback

    @launch_section
    def _score_launch_sparse(self, accepted, snap, cres, sid, mirror_rows,
                             launch_span, launch_ref, t_exec):
        """Sparse candidate-set Score launch: score [P, C] gathered cells
        instead of [P, N].  Reuses the resident candidate lists when
        clean, merge-refreshes the dirty entries (reason "dirty"), and
        rebuilds past the staleness bound ("stale") or with nothing
        resident ("cold").  Where every pod's feasible fan-out fits C the
        reply bytes equal the dense path's; otherwise the readback raises
        :class:`CandidateOverflow`.  ``t_exec``: the launch section's start
        (``perf_counter_ns``)."""
        try:
            dev_span = device_stage(self.device)
            devprof.drain_notes()
            N = snap.nodes.capacity
            P = snap.pods.capacity
            C = int(self.cfg.candidate_width)
            k_cap = min(C, N)
            ks = [min(int(e.req.top_k) or k_cap, k_cap) for e in accepted]
            k_launch = min(pad_bucket(max(ks)), k_cap)
            refresh_reason = None
            merges = 0
            if cres is None:
                # the node mesh, when configured, splits the pipelined
                # build's counts pass over its blocks
                cand, count = build_candidates(snap, self.cfg, node_mesh=self.mesh)
                refresh_reason = "cold"
            elif cres.dirty_nodes or cres.dirty_pods:
                if cres.merges >= self.cfg.candidate_max_stale:
                    cand, count = build_candidates(snap, self.cfg, node_mesh=self.mesh)
                    refresh_reason = "stale"
                else:
                    cand, count = refresh_candidates(
                        snap, cres.idx, cres.count,
                        sorted(cres.dirty_nodes), sorted(cres.dirty_pods),
                        self.cfg,
                    )
                    refresh_reason = "dirty"
                    merges = cres.merges + 1
            else:
                cand, count = cres.idx, cres.count
            if refresh_reason is not None:
                self.state.store_candidates(self.cfg, cand, count, merges)
            scores, feasible = score_candidates(snap, cand, self.cfg)
            top_scores, top_idx, top_ok = sparse_top_k(
                scores, feasible, cand, k=k_launch,
                hi=score_upper_bound(self.cfg),
            )
            if dev_span is not None:
                dev_span.close()
            dispatched = (t_exec, time.perf_counter_ns())
            stage_at("dispatch", *dispatched)
            devprof_notes = devprof.drain_notes()
        except Exception as exc:
            if launch_span is not None:
                launch_span.abort(exc)
            with self._state_lock:
                self.telemetry.abort_cycle("score", exc)
            raise

        def _readback():
            try:
                t0 = time.perf_counter_ns()
                ts, ti, ok_np, count_np, valid_np = read_back(
                    top_scores, top_idx, top_ok, gather(count), local(snap.pods.valid)
                )
                read = (t0, time.perf_counter_ns())
                stage_at("readback", *read)
                if dev_span is not None:
                    dev_span.read()
                try:
                    check_candidate_overflow(count_np, C)
                except CandidateOverflow:
                    # a truncating merge may have dropped real candidates:
                    # drop the lists so the next sparse Score rebuilds
                    self.state.drop_candidate_residency()
                    raise
                if launch_span is not None:
                    launch_span.set_attr("k_bucket", k_launch)
                    launch_span.set_attr("candidate_width", C)
                    _devprof_span_attrs(launch_span, devprof_notes)
                    launch_span.end()
                valid = valid_np[:P].astype(bool)
                with self._state_lock:
                    # no full scores cached: the cache cannot invent
                    # candidate columns this launch never scored
                    self._publish_readback(sid, dict(
                        kb=k_launch, N=k_cap, P=P, ts=ts, ti=ti, ok=ok_np,
                        valid=valid, launch_span=launch_ref,
                        nodes=mirror_rows[0], pods=mirror_rows[1],
                        scores=None, feasible=None,
                    ))
                assembled = []
                n_failed = 0
                for entry, k in zip(accepted, ks):
                    try:
                        entry.reply = self._assemble_score_reply(
                            entry.req, k, ts, ti, ok_np, valid, P,
                        )
                        assembled.append(entry)
                    except Exception as exc:  # routed to the one caller as its RPC error; sibling replies stand
                        entry.error = exc
                        n_failed += 1
                exec_ms = (time.perf_counter_ns() - t_exec) / 1e6
            except Exception as exc:
                if launch_span is not None:
                    launch_span.abort(exc)
                with self._state_lock:
                    self.telemetry.abort_cycle("score", exc)
                raise
            return lambda: self._score_telemetry(
                assembled, sid, dispatched, read, exec_ms, n_failed,
                cand_refresh=refresh_reason, cand_width=C,
            )

        return _readback

    @launch_section
    def _score_incremental(self, snap, res_):
        """Advance the resident score tensors through the accumulated dirty
        columns/rows (``rescore_dirty``).  The residency's references are
        cleared FIRST, so a failure can never leave a half-written tensor
        published; the caller re-stores on success.  With no dirt the
        tensors are exact and pass through untouched."""
        if not res_.dirty_nodes and not res_.dirty_pods:
            return res_.scores, res_.feasible
        scores, feasible = res_.scores, res_.feasible
        res_.scores = res_.feasible = None
        # looked up at the call, as the reference does, so a fault injected
        # into ``solver.incremental.rescore_dirty`` reaches the servicer
        from koordinator_tpu_torch.solver.incremental import rescore_dirty

        # koordlint: disable=donation-safety(the launch lock orders it after every earlier launch, whose readbacks hold a clone of the scores, ROADMAP Queue C "The incremental rescore's in-place write")
        return rescore_dirty(
            snap, scores, feasible, res_.dirty_nodes, res_.dirty_pods,
            self.cfg, mesh=self.state.active_mesh(),
        )

    def _score_serve_memo(self, accepted, ks, memo, sid):
        """Serve a whole coalesced batch as sliced prefixes of the memoized
        padded top-k readback: host numpy only, the same bytes a fresh
        launch would give.  Hits count on the score-memo family and the
        latency histogram under ``path="memo"``."""
        t_exec = time.perf_counter()
        served = []
        n_failed = 0
        for entry, k in zip(accepted, ks):
            try:
                if entry.trace_span is not None:
                    entry.trace_span.link_ref(memo.get("launch_span"))
                    entry.trace_span.set_attr("memo_hit", True)
                entry.reply = self._assemble_score_reply(
                    entry.req, k, memo["ts"], memo["ti"], memo["ok"],
                    memo["valid"], memo["P"],
                )
                served.append(entry)
            except Exception as exc:  # routed to the one caller as its RPC error; sibling replies stand
                entry.error = exc
                n_failed += 1
        exec_ms = (time.perf_counter() - t_exec) * 1000.0

        def _hook():
            with self._state_lock:
                tel = self.telemetry
                for _ in range(n_failed):
                    tel.metrics.count_cycle_error("score")
                if not served:
                    return
                tel.metrics.count_score_memo("hit", len(served))
                tel.metrics.record_coalesce(
                    len(served), [e.queue_delay_ms for e in served]
                )
                pending = tel.spans.has_pending()
                n_observe = len(served) if pending else len(served) - 1
                if not pending:
                    tel.flush_backlog()
                    spans = tel.spans
                    spans.current(snapshot_id=sid)
                    if len(served) > 1:
                        spans.note("coalesced", len(served))
                    spans.note("memo_hit", True)
                    tel.commit_cycle(
                        exec_ms, path="memo", wave=self.cfg.wave
                    )
                for _ in range(n_observe):
                    tel.metrics.observe_cycle(
                        exec_ms, path="memo", wave=self.cfg.wave
                    )

        return _hook

    def _assemble_score_reply(
        self, req, k, top_scores, top_idx, ok_full, valid, P,
        degraded: bool = False,
    ) -> "wire.ScoreReply":
        """Demux one caller's reply from the shared readback: the k-prefix
        of the padded top-k and of its [P, k_bucket] validity matrix, then
        the flat or the per-pod layout."""
        ts = top_scores[:, :k]
        ti = top_idx[:, :k]
        ok = ok_full[:, :k]
        reply = wire.ScoreReply()
        if degraded:
            reply.degraded = True
        t0 = time.perf_counter_ns()
        if req.flat:
            # flat layout: four packed arrays, no per-pod messages
            ok_v = ok[:P][valid]
            reply.flat.pod_index = (
                np.flatnonzero(valid).astype("<i4").tobytes()
            )
            reply.flat.counts = ok_v.sum(axis=1).astype("<i4").tobytes()
            reply.flat.node_index = (
                ti[:P][valid][ok_v].astype("<i4").tobytes()
            )
            reply.flat.score = (
                ts[:P][valid][ok_v].astype("<i8").tobytes()
            )
        else:
            for p in np.flatnonzero(valid):
                entry = reply.pods.add()
                m = ok[p]
                entry.node_index.extend(ti[p, m])
                entry.score.extend(ts[p, m])
        t1 = time.perf_counter_ns()
        reply.build_ms = (t1 - t0) / 1e6
        stage_at("reply_build", t0, t1)
        return reply

    def _score_telemetry(self, assembled, sid, dispatched, read,
                         exec_ms, n_failed=0, incr_result=None,
                         incr_cols=0, cand_refresh=None, cand_width=0):
        """Per-batch telemetry, sequenced under the state lock, run as the
        dispatcher's post-batch hook.  ``dispatched`` and ``read`` are the
        launch's and the readback's ``perf_counter_ns`` (start, end).  A pending cycle (Sync stages
        awaiting their Assign) is not committed by a Score; the latency
        histogram gets one observation per request at the batch's
        execution time."""
        with self._state_lock:
            tel = self.telemetry
            for _ in range(n_failed):
                tel.metrics.count_cycle_error("score")
            if self._score_memo is not None and (assembled or n_failed):
                tel.metrics.count_score_memo(
                    "miss", len(assembled) + n_failed
                )
            if incr_result is not None:
                tel.metrics.count_score_incr(incr_result)
                if incr_result == "incr":
                    tel.metrics.observe_incr_cols(incr_cols)
            if cand_width:
                tel.metrics.set_candidate_width(cand_width)
                if cand_refresh is not None:
                    tel.metrics.count_candidate_refresh(cand_refresh)
            if assembled or n_failed:
                for term in self._term_names:
                    tel.metrics.count_term(term)
            if not assembled:
                return
            tel.flush_backlog()
            spans = tel.spans
            pending = spans.has_pending()
            spans.current(snapshot_id=sid)
            spans.add_measured("score_dispatch", *dispatched)
            spans.add_measured("score_readback", *read)
            if len(assembled) > 1:
                spans.note("coalesced", len(assembled))
            tel.metrics.record_coalesce(
                len(assembled), [e.queue_delay_ms for e in assembled]
            )
            stats = self.dispatch.stats()
            tel.metrics.set_coalesce_window(stats["window_ms"])
            tel.metrics.set_device_idle(stats["device_idle_ms"])
            n_observe = len(assembled) if pending else len(assembled) - 1
            if not pending:
                tel.commit_cycle(exec_ms, path="score", wave=self.cfg.wave)
            for _ in range(n_observe):
                tel.metrics.observe_cycle(
                    exec_ms, path="score", wave=self.cfg.wave
                )

    def assign(self, req: "wire.AssignRequest", ctx=None) -> "wire.AssignReply":
        """Tracing shell over :meth:`_assign_impl`."""
        with self.telemetry.spans.rpc("assign"):
            tspan = self._start_rpc_span(
                "assign", req, band=getattr(req, "band", "") or "",
            )
            if tspan is None:
                return self._assign_impl(req, ctx, None)
            try:
                reply = self._assign_impl(req, ctx, tspan)
            except BaseException as exc:
                tspan.abort(exc)
                raise
            tspan.set_attr("cycle_id", reply.cycle_id)
            reply.server_span = tspan.span_id
            tspan.end()
            return reply

    def _assign_impl(self, req: "wire.AssignRequest", ctx=None,
                     tspan=None) -> "wire.AssignReply":
        band = getattr(req, "band", "") or ""
        try:
            gate = self.admission.admit("assign", band)
            gate.__enter__()
        except ResourceExhausted as exc:
            self.telemetry.metrics.count_shed("assign", band)
            if ctx is not None:
                ctx.abort(StatusCode.RESOURCE_EXHAUSTED, str(exc))
            raise
        try:
            budget = self._deadline_budget_ms(req, ctx)
            if budget < 0.0:
                self.telemetry.metrics.count_deadline_expired("queue")
                exc = DeadlineExpired("assign", "queue", budget)
                if ctx is not None:
                    ctx.abort(StatusCode.DEADLINE_EXCEEDED, str(exc))
                raise exc
            # Assign never serves stale: an open breaker fails fast
            if not self.breaker.allow_launch():
                self.telemetry.metrics.count_breaker_rejected("assign")
                exc = BreakerOpen(
                    "assign", self.breaker.retry_after_ms(),
                    "assign never serves stale",
                )
                if ctx is not None:
                    ctx.abort(StatusCode.UNAVAILABLE, str(exc))
                raise exc
            deadline_at = (
                time.perf_counter() + budget / 1000.0
                if budget > 0.0 else None
            )
            # bounded retry: a waiter that inherited an owner's failure
            # re-runs the memo protocol; the last attempt bypasses the memo
            for attempt in range(3):
                outcome = self._assign_once(
                    req, ctx, bypass_memo=attempt == 2,
                    deadline_at=deadline_at, budget_ms=budget,
                    tspan=tspan,
                )
                if outcome is not None:
                    return outcome
            raise RuntimeError(
                "unreachable: memo-bypass attempt returned None"
            )
        finally:
            gate.__exit__(None, None, None)

    def _assign_once(
        self, req: "wire.AssignRequest", ctx, bypass_memo: bool = False,
        deadline_at: Optional[float] = None, budget_ms: float = 0.0,
        tspan=None,
    ) -> Optional["wire.AssignReply"]:
        """One pass of the Assign memo protocol: the reply, or None when
        this thread waited on a memo owner that failed (the caller
        retries)."""
        t_rpc = time.perf_counter()
        with self._state_lock:
            self._check_generation(req, ctx)
            sid = self.snapshot_id()
            key = (sid, self.cfg)
            owner = False
            entry = None
            if not bypass_memo:
                entry = self._assign_memo.get(key)
                if entry is None:
                    entry = _AssignMemo()
                    self._assign_memo[key] = entry
                    owner = True
            # the cycle owner adopts the pending Sync->Assign cycle; memo
            # waiters mint fresh ones
            scope = self.telemetry.begin_rpc_scope(
                snapshot_id=sid,
                cycle_id=req.cycle_id or None,
                adopt_pending=owner or bypass_memo,
                trace_id=getattr(req, "trace_id", "") or None,
            )
            if tspan is not None and (owner or bypass_memo):
                if entry is not None:
                    entry.span_ref = tspan.ref
        if entry is not None and not owner:
            if tspan is not None:
                tspan.link_ref(entry.span_ref)
                tspan.set_attr("memo_hit", True)
            # no device work on this RPC: free a half-open probe slot
            self.breaker.release_probe()
            return self._assign_from_memo(entry, scope, t_rpc)
        try:
            reply = self._assign_compute(
                req, ctx, scope, memo=entry,
                deadline_at=deadline_at, budget_ms=budget_ms,
                tspan=tspan,
            )
        except BaseException as exc:
            if owner:
                # unpublish BEFORE waiters act on it
                with self._state_lock:
                    if self._assign_memo.get(key) is entry:
                        del self._assign_memo[key]
                    entry.error = exc
                    entry.done.set()
            raise
        return reply

    def _assign_from_memo(
        self, entry: _AssignMemo, scope, t_rpc: float
    ) -> Optional["wire.AssignReply"]:
        """Serve one Assign from a published (or in-flight) memo entry,
        waiting outside every lock; None when the owner failed."""
        # backstop timeout: the owner always sets done
        while not entry.done.wait(timeout=1.0):
            pass
        if entry.error is not None or entry.result is None:
            exc = entry.error or RuntimeError(
                "memo owner published no result"
            )
            with self._state_lock:
                scope.note("memo_owner_failed", True)
                self.telemetry.abort_scope(
                    scope, "assign-memo-wait", exc, dump=False
                )
            return None
        assignment, status, valid, path, rounds, eff_wave, cycle_ms = (
            entry.result
        )
        wait_ms = (time.perf_counter() - t_rpc) * 1000.0
        with self._state_lock:
            with stage("reply_build"):
                reply = wire.AssignReply(
                    cycle_ms=cycle_ms, path=path or "", cycle_id=scope.cycle_id,
                )
                reply.assignment.extend(assignment[valid])
                reply.status.extend(status[valid])
            self.telemetry.metrics.count_assign_memo("hit")
            scope.note("memo_hit", True)
            self.telemetry.commit_scope(
                scope, wait_ms, path="memo", wave=eff_wave, rounds=rounds
            )
        return reply

    def _assign_compute(
        self, req: "wire.AssignRequest", ctx, scope,
        memo: Optional[_AssignMemo] = None,
        deadline_at: Optional[float] = None, budget_ms: float = 0.0,
        tspan=None,
    ) -> "wire.AssignReply":
        """Run one cycle through the pipelined dispatcher and (as memo
        owner) publish its result on the owned entry."""
        t0 = [0.0]
        devprof_notes: list = []

        @launch_section
        def launch():
            # capture INSIDE the launch section: a Sync committing while
            # this RPC queued makes a pinned snapshot_id stale, and its
            # in-place writes cannot start until this cycle is read back
            t0[0] = time.perf_counter()
            stage_since_arrival("wait")
            dev_span = device_stage(self.device)
            devprof.drain_notes()
            if deadline_at is not None and t0[0] >= deadline_at:
                raise DeadlineExpired("assign", "gather", budget_ms)
            with self._state_lock:
                self._check_generation(req, None)
                snap = self.state.snapshot()
                i32_ok = self.state.i32_fits()
            result, rounds, eff_wave = self._assign_cycle(
                snap, scope, i32_ok
            )
            if dev_span is not None:
                dev_span.close()
            devprof_notes.extend(devprof.drain_notes())

            def _readback():
                # assignment, status, validity and rounds in one transfer
                with scope.span("readback"), stage("readback"):
                    assignment, status, valid, got_rounds = read_back(
                        result.assignment, result.status, local(snap.pods.valid),
                        rounds,
                    )
                if dev_span is not None:
                    dev_span.read()
                return (
                    result,
                    None if got_rounds is None else int(got_rounds),
                    eff_wave,
                    assignment, status, valid.astype(bool),
                )

            return _readback

        try:
            result, rounds, eff_wave, assignment, status, valid = (
                self.dispatch.run_pipelined(launch)
            )
        except SnapshotNotResident as exc:
            # displaced mid-queue by another client's Sync: a protocol
            # condition (the Go client full-resyncs on it), not a failure
            with self._state_lock:
                scope.note("displaced", True)
                self.telemetry.abort_scope(scope, "assign", exc, dump=False)
            if ctx is not None:
                ctx.abort(StatusCode.FAILED_PRECONDITION, str(exc))
            raise
        except DeadlineExpired as exc:
            with self._state_lock:
                self.telemetry.metrics.count_deadline_expired("gather")
                scope.note("deadline_expired", True)
                self.telemetry.abort_scope(scope, "assign", exc, dump=False)
            if ctx is not None:
                ctx.abort(StatusCode.DEADLINE_EXCEEDED, str(exc))
            raise
        except Exception as exc:
            with self._state_lock:
                self.telemetry.abort_scope(scope, "assign", exc)
            raise
        ms = (time.perf_counter() - t0[0]) * 1000.0
        if tspan is not None:
            _devprof_span_attrs(tspan, devprof_notes)
        with self._state_lock:
            with stage("reply_build"):
                reply = wire.AssignReply(
                    cycle_ms=ms, path=result.path or "", cycle_id=scope.cycle_id,
                )
                reply.assignment.extend(assignment[valid])
                reply.status.extend(status[valid])
            # publish on the OWNED entry: waiters blocked on it consume a
            # result consistent with the generation check they passed
            if memo is not None:
                memo.result = (
                    assignment, status, valid,
                    result.path or "", rounds, eff_wave, ms,
                )
                memo.done.set()
            self.last_cycle = result
            self.telemetry.metrics.count_assign_memo("miss")
            self.telemetry.commit_scope(
                scope, ms,
                path=result.path or "unknown",
                wave=eff_wave,
                rounds=rounds,
            )
        return reply

    @launch_section
    def _assign_cycle(self, snap, spans, i32_ok):
        """Run the cycle, shard-first when a mesh is configured: ``(CycleResult,
        rounds or None, wave width)``.  ``rounds`` stays a device scalar on
        the single-device route (or None: the dense kernel takes a wave
        request beyond int32) for the stacked readback; the shard route's
        is a host int, its placements host arrays read inside its demotion
        guard."""
        if self.mesh is not None and not self._term_names:
            # koordlint: disable=lock-held-dispatch(the shard demotion guard reads the placements back under the launch lock, ROADMAP Queue C "The shard Assign's readback")
            shard = self._assign_shard(snap, spans)
            if shard is not None:
                return shard
        with spans.span("dispatch"):
            # koordlint: disable=lock-held-dispatch(an Assign holds the launch lock for its whole cycle and the kernel ladder synchronizes each rung to demote a faulting kernel there, ROADMAP Queue C "The servicer")
            result = run_cycle(snap, self.cfg, i32_ok=i32_ok)
        return result, result.rounds, self.cfg.wave

    def _assign_shard(self, snap, spans):
        """The round-based sharded cycle under its demotion guard: the
        result, or None when the bucket is demoted or the attempt failed
        (the bucket is then demoted with the kernel ladder's backoff and
        the cycle record notes ``shard_error``).  Fused terms have no
        extras seam here, so the caller keeps them on ``run_cycle``."""
        import dataclasses

        from koordinator_tpu_torch import parallel
        from koordinator_tpu_torch.solver import _demoted, _record_failure, _record_success

        # a per-pod config widens to the sharded cycle's own width
        wave = self.cfg.wave if self.cfg.wave > 1 else 32
        top_m = self.cfg.top_m
        bucket = ("shard", int(snap.nodes.allocatable.shape[0]), int(snap.pods.capacity),
                  self.mesh.size, wave, top_m)
        if _demoted(bucket):
            return None
        try:
            # its own span name: a failed shard attempt next to the
            # fallback's "dispatch" is not counted twice
            with spans.span("dispatch_shard"):
                result, rounds = parallel.greedy_assign_waves(
                    snap, self.mesh, self.cfg, wave=wave, top_m=top_m, spans=spans,
                )
                # read back inside the guard: a late device fault surfaces
                # here, where the fallback can still serve the RPC
                assignment, status = read_back(result.assignment, result.status)
                result = dataclasses.replace(result, assignment=assignment, status=status)
        except Exception as exc:  # the shard attempt's fault demotes its bucket; the single-device cycle serves the RPC and the reply's path shows it
            _record_failure(bucket)
            spans.note("shard_error", f"{exc!r:.200}")
            logger.exception(
                "sharded assign failed; serving single-device and backing off bucket %r",
                bucket,
            )
            return None
        _record_success(bucket)
        return result, rounds, wave


# -- the gRPC transport --

class _GrpcContext:
    """A gRPC servicer context whose ``abort`` takes the port's
    :class:`StatusCode`."""

    def __init__(self, ctx, grpc):
        self._ctx = ctx
        self._grpc = grpc

    def abort(self, code: StatusCode, details: str):
        self._ctx.abort(getattr(self._grpc.StatusCode, code.name), details)

    def time_remaining(self):
        return self._ctx.time_remaining()


def make_server(
    servicer: Optional[ScorerServicer] = None,
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG,
    max_workers: int = 16,
    device=None,
):
    """A ``grpc.Server`` serving Sync, Score and Assign through generic
    handlers whose (de)serialisers are the port codec's, so no protobuf
    runtime is needed.  Raises ``RuntimeError`` where ``grpc`` is not
    installed (serve the raw framing of ``udsserver.py`` instead).
    ``max_workers`` defaults to the reference scheduler's 16 parallel
    Score workers."""
    try:
        import grpc
    except ImportError as exc:
        raise RuntimeError(
            "the gRPC transport needs the grpc package; serve the raw UDS "
            "framing (bridge/udsserver.py) where it is absent"
        ) from exc
    from concurrent import futures

    servicer = servicer or ScorerServicer(cfg, device=device)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        # unbounded frames: a large cluster's first full Sync is far past
        # gRPC's 4 MB default receive cap
        options=(
            ("grpc.max_receive_message_length", -1),
            ("grpc.max_send_message_length", -1),
        ),
    )

    def handler(fn, req_cls):
        return grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: fn(req, _GrpcContext(ctx, grpc)),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg: msg.SerializeToString(),
        )

    handlers = {
        "Sync": handler(servicer.sync, wire.SyncRequest),
        "Score": handler(servicer.score, wire.ScoreRequest),
        "Assign": handler(servicer.assign, wire.AssignRequest),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, handlers),)
    )
    server._koord_servicer = servicer  # introspection seam
    return server


def serve_uds(path: str, cfg: CycleConfig = DEFAULT_CYCLE_CONFIG, device=None):
    """Bind the gRPC scorer on a unix-domain socket and start it."""
    server = make_server(cfg=cfg, device=device)
    server.add_insecure_port(f"unix://{path}")
    server.start()
    return server
