"""Resident snapshot state of the scorer seam.

Counterpart of ``koordinator_tpu/bridge/state.py``.  Two layers:

* **host mirrors** — numpy mirrors of every snapshot tensor; a warm Sync
  ships only sparse (index, value) deltas against them.  The mirrors are
  the source of truth: validation, the int32-bounds check and cold rebuilds
  all read them.
* **device residency** — the committed ``ClusterSnapshot``'s tensors stay
  on the device across Syncs.  A delta frame is scattered into the
  resident tensor in place (``solver/resident.py apply_flat_delta``); a
  full tensor of unchanged geometry binds a new tensor built from its
  mirror; derived columns (padded priority/gang/quota vectors, freshness
  masks) are rebuilt only when their wire columns changed.  Assign and
  Score then run straight off the resident tensors.

Any geometry change (table size, pad bucket, a tensor appearing or
disappearing) drops residency and the next ``snapshot()`` is a cold
rebuild from the mirrors.  The two paths give the same tensors: the warm
path edits the same padded cells the cold build writes.

The resident snapshot carries no names: they stay on this object, and
replies are index-based.

With a cluster mesh (``parallel/mesh.py cluster_mesh``) the snapshot is
mesh-resident: node tensors split along the mesh's node axis, pod rows and
the gang/quota tables replicate, every leaf placed by the policy of
``parallel.mesh.snapshot_shardings``; a warm delta scatters into the
owning shard only.  A node bucket that does not divide over the mesh stays
single-device for that geometry (logged once).

Where the reference donates, the port writes in place: the tensors a
launched batch captured are the resident ones, so a delta commit must not
run while such a batch is in flight (:meth:`ResidentState.commit_donates`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import (
    ClusterSnapshot,
    GangTable,
    NodeBatch,
    PodBatch,
    PriorityClass,
    QuotaTable,
    pad_bucket,
)
from koordinator_tpu_torch.obs.spans import maybe_span, stage_part
from koordinator_tpu_torch.parallel.mesh import (
    check_mesh,
    node_sharding,
    replicated_sharding,
    score_sharding,
    shard_tensor,
)
from koordinator_tpu_torch.solver.resident import apply_flat_delta

R = res.NUM_RESOURCES

logger = logging.getLogger(__name__)

# "no precomputed plan" sentinel for commit_donates/commit_sync —
# distinct from None, which is a real plan value meaning "go cold"
_PLAN_UNSET = object()


def delta_encode(prev: np.ndarray, next_: np.ndarray, max_changes: int):
    """(flat indices, values) of the cells of ``next_`` that differ from
    ``prev``, or None when more than ``max_changes`` differ."""
    prev = np.ascontiguousarray(prev, np.int64).reshape(-1)
    next_ = np.ascontiguousarray(next_, np.int64).reshape(-1)
    idx = np.flatnonzero(prev != next_)
    if len(idx) > max_changes:
        return None
    return idx.astype(np.int64), next_[idx]


def decode_tensor(
    t: "wire.Tensor", base: Optional[np.ndarray]
) -> Tuple[Optional[np.ndarray], str, Optional[np.ndarray], Optional[np.ndarray]]:
    """Decode a wire Tensor against the resident ``base`` mirror.

    Returns ``(mirror, kind, idx, val)`` where kind is "none" (message
    carries nothing; tensor unchanged), "full" (full payload) or "delta"
    (sparse update; idx/val are the validated flat indices and values so
    the device path can scatter them without re-diffing).
    """
    if t.data:
        arr = np.frombuffer(t.data, dtype="<i8").astype(np.int64)
        return arr.reshape(tuple(t.shape)), "full", None, None
    if t.delta_idx:
        if base is None:
            raise ValueError("delta sync without a resident tensor")
        # the delta must target the RESIDENT shape: a client with a stale
        # differently-shaped mirror emits indices that may all land inside
        # the resident cell count yet write the wrong cells
        if t.shape and tuple(t.shape) != base.shape:
            raise ValueError(
                f"delta shape {tuple(t.shape)} != resident {base.shape}"
            )
        idx = np.frombuffer(t.delta_idx, dtype="<i8").astype(np.int64)
        val = np.frombuffer(t.delta_val, dtype="<i8").astype(np.int64)
        if len(idx) != len(val):
            raise ValueError(
                f"delta index/value length mismatch: {len(idx)} vs {len(val)}"
            )
        # duplicate indices are rejected: a scatter's duplicate semantics
        # are implementation-defined, so a frame with repeats could split
        # the mirror from the resident tensors
        if len(idx) != len(np.unique(idx)):
            raise ValueError("delta carries duplicate indices")
        if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= base.size):
            raise ValueError(
                f"delta index out of range for resident tensor of "
                f"{base.size} cells"
            )
        out = base.copy()
        out.reshape(-1)[idx] = val
        return out, "delta", idx, val
    return None, "none", None, None


def tensor_to_numpy(
    t: "wire.Tensor", base: Optional[np.ndarray]
) -> Optional[np.ndarray]:
    """Decode a wire Tensor: full payload, or sparse delta onto ``base``.
    None when the message carries nothing (tensor unchanged)."""
    arr, kind, _, _ = decode_tensor(t, base)
    return arr if kind != "none" else None


def numpy_to_tensor(
    arr: np.ndarray, prev: Optional[np.ndarray] = None, max_delta_ratio: float = 0.25
) -> "wire.Tensor":
    """Encode full, or as a sparse delta when <= max_delta_ratio changed."""
    t = wire.Tensor()
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    t.shape.extend(arr.shape)
    if prev is not None and prev.shape == arr.shape:
        enc = delta_encode(
            prev, arr, max_changes=max(1, int(arr.size * max_delta_ratio))
        )
        if enc is not None:
            idx, val = enc
            t.delta_idx = idx.astype("<i8").tobytes()
            t.delta_val = val.astype("<i8").tobytes()
            return t
    t.data = arr.astype("<i8").tobytes()
    return t


def _pad_rows_to(a, rows):
    """Pad (or keep) leading axis to ``rows`` regardless of current length
    (a stale mirror after a node-count change must never produce a
    wrong-shaped tensor)."""
    a = np.asarray(a)
    if a.shape[0] >= rows:
        return a[:rows]
    pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _pc_column(explicit, priority, P, pb):
    col = np.full(pb, int(PriorityClass.NONE), np.int32)
    if explicit is not None:
        col[: len(explicit)] = explicit[:pb]
    else:
        for i in range(P):
            col[i] = int(PriorityClass.from_priority_value(int(priority[i])))
    return col


def _present(a: Optional[np.ndarray]) -> bool:
    return a is not None and a.size > 0


# wire tensors that ride the sparse-delta path, keyed by mirror attribute
_DELTA_TENSORS = (
    "node_alloc",
    "node_requested",
    "node_usage",
    "node_agg",
    "node_agg_fresh",
    "node_prod",
    "pod_requests",
    "pod_estimated",
    "quota_runtime",
    "quota_used",
    "quota_limited",
    "pod_sensitivity",
    "term_throughput",
)

# score-relevant tensors: a delta to one of these dirties the touched ROWS
# of the resident [P, N] score tensors.  Quota tensors are absent:
# score_cycle reads no quota state, so a quota-only Sync leaves the
# resident score tensors exactly valid.
_SCORE_NODE_TENSORS = ("node_alloc", "node_requested", "node_usage",
                       "node_agg", "node_agg_fresh", "node_prod")
_SCORE_POD_TENSORS = ("pod_requests", "pod_estimated", "pod_sensitivity")


class ScoreResidency:
    """The [P, N] score/feasible tensors the last Score launch certified,
    plus the dirty row/column sets accumulated since.  Every warm commit
    unions the rows it invalidated into ``dirty_nodes``/``dirty_pods``;
    the next Score recomputes only those (``solver/incremental.py
    rescore_dirty``) and the sets clear.  ``cfg`` is the CycleConfig the
    tensors were scored under: a config change drops the residency."""

    __slots__ = ("cfg", "scores", "feasible", "dirty_nodes", "dirty_pods")

    def __init__(self, cfg, scores, feasible):
        self.cfg = cfg
        self.scores = scores
        self.feasible = feasible
        self.dirty_nodes: set = set()
        self.dirty_pods: set = set()


class CandidateResidency:
    """The sparse engine's [P, C] candidate-index map
    (``solver/candidates.py``), the exact per-pod feasible counts and the
    dirt accumulated since the launch that built them.  Advanced by the
    same commit seam as :class:`ScoreResidency`; ``merges`` counts
    merge-refreshes since the last full build (bounded by
    ``cfg.candidate_max_stale``)."""

    __slots__ = ("cfg", "idx", "count", "dirty_nodes", "dirty_pods",
                 "merges")

    def __init__(self, cfg, idx, count, merges: int = 0):
        self.cfg = cfg
        self.idx = idx
        self.count = count
        self.dirty_nodes: set = set()
        self.dirty_pods: set = set()
        self.merges = int(merges)


# companions reset to defaults when a full tensor changes the node table
# size: a stale differently-shaped column must not linger to fail later at
# snapshot build, or be padded onto the NEW nodes' rows
_NODE_COMPANIONS = ("node_fresh", "node_names", "node_agg", "node_agg_fresh",
                    "node_prod", "node_requested", "node_usage", "node_accel")
# gang_min is not a pod companion: the gang table's shape is per-gang
_POD_COMPANIONS = ("pod_priority", "pod_priority_class", "pod_gang",
                   "pod_quota", "pod_names", "pod_estimated",
                   "pod_workload", "pod_sensitivity")
_COMPANION_DEFAULTS = {"node_names": (), "pod_names": ()}


class ResidentState:
    """Numpy mirrors + the device-resident ClusterSnapshot built from them.

    ``device``: where the resident tensors live (default CUDA, raising
    when it is absent; ``"cpu"`` runs the plain path).  ``mesh``: a cluster
    mesh makes the snapshot mesh-resident (module docstring); its leaves
    are then ``ShardedTensor``s on the mesh's devices, and a geometry whose
    node bucket does not divide over it stays on ``device``."""

    def __init__(self, mesh=None, device=None):
        self.mesh = check_mesh(mesh)
        self._mesh_skip_warned: set = set()
        self.device = resolve_device(device)
        self.node_alloc: Optional[np.ndarray] = None
        self.node_requested: Optional[np.ndarray] = None
        self.node_usage: Optional[np.ndarray] = None
        self.node_fresh: Optional[np.ndarray] = None
        self.node_agg: Optional[np.ndarray] = None  # [N, A, R]
        self.node_agg_fresh: Optional[np.ndarray] = None
        self.node_prod: Optional[np.ndarray] = None
        self.node_names: tuple = ()
        self.pod_requests: Optional[np.ndarray] = None
        self.pod_estimated: Optional[np.ndarray] = None
        self.pod_priority: Optional[np.ndarray] = None
        self.pod_priority_class: Optional[np.ndarray] = None
        self.pod_gang: Optional[np.ndarray] = None
        self.pod_quota: Optional[np.ndarray] = None
        self.pod_names: tuple = ()
        self.gang_min: Optional[np.ndarray] = None
        self.quota_runtime: Optional[np.ndarray] = None
        self.quota_used: Optional[np.ndarray] = None
        self.quota_limited: Optional[np.ndarray] = None
        # fused-term mirrors; None = never synced (the terms are inert)
        self.node_accel: Optional[np.ndarray] = None
        self.pod_workload: Optional[np.ndarray] = None
        self.pod_sensitivity: Optional[np.ndarray] = None
        self.term_throughput: Optional[np.ndarray] = None
        self.node_bucket = 0
        self.pod_bucket = 0
        self._snapshot: Optional[ClusterSnapshot] = None
        self._score_res: Optional[ScoreResidency] = None
        self._cand_res: Optional[CandidateResidency] = None
        self._i32_ok: Optional[bool] = None
        # how the last Sync landed on the device ("cold" = residency
        # dropped, rebuilt at the next snapshot(); "warm" = resident
        # tensors updated in place)
        self.last_sync_path = "cold"

    def apply_sync(self, reqmsg: "wire.SyncRequest", spans=None) -> dict:
        """Decode everything first, commit only if every tensor decoded: a
        rejected frame leaves the resident state untouched.  One-shot form
        of the two-phase ``stage_sync`` / ``commit_sync`` seam the
        servicer uses.  Returns ``{"path": "warm"|"cold",
        "delta_tensors": n, "full_tensors": n}``."""
        return self.commit_sync(
            self.stage_sync(reqmsg, spans=spans), spans=spans
        )

    def stage_sync(self, reqmsg: "wire.SyncRequest", spans=None):
        """Phase 1 — pure decode/validate.  Mutates nothing; every
        validation error raises here, so a frame that passes staging
        always commits.  The caller serializes Syncs (deltas are
        validated against the current mirrors)."""
        with maybe_span(spans, "sync_decode"):
            return self._decode_sync(reqmsg)

    def plan_commit(self, staged_tinfo):
        """The device-update plan of a staged frame against the current
        (pre-commit) mirrors and residency; mutates nothing.  Residency
        can flip at any launch (a Score's launch section cold-rebuilds via
        ``snapshot()``), so a plan that gates a commit is computed with the
        dispatch launch lock held and handed to ``commit_sync``."""
        staged, tinfo = staged_tinfo
        return self._warm_plan(staged, tinfo)

    def commit_donates(self, staged_tinfo, plan=_PLAN_UNSET) -> bool:
        """Whether committing this staged frame WRITES INTO resident device
        tensors, and so must drain in-flight launches first
        (``run_exclusive(fn, drain=True)``).

        The port's rule: a warm plan with at least one delta update writes
        in place (``apply_flat_delta`` scatters into the resident tensor,
        where the reference donates it and binds a new one), and a batch
        that was launched but not read back, or an Assign cycle, holds
        those very tensors — so every such commit drains.  Every other
        commit binds new tensors and never writes into old ones: a full
        re-upload builds a new tensor from its mirror (never ``copy_``
        into the resident one), derived columns are rebuilt, and a cold
        commit drops residency.  In-flight batches keep their own
        references to the old tensors, so those commits need launch
        ordering only and the pipeline keeps flowing.  Pinned by
        ``tests/test_torch_server.py``'s interleaved Score-storm and
        delta-Sync test."""
        if plan is _PLAN_UNSET:
            plan = self.plan_commit(staged_tinfo)
        if plan is None:
            return False
        tensor_updates, _ = plan
        return any(u[0] == "delta" for u in tensor_updates.values())

    def commit_sync(self, staged_tinfo, spans=None, plan=_PLAN_UNSET) -> dict:
        """Phase 2 — atomic commit of a staged frame + the device-side
        warm update.  The caller holds the dispatch launch lock, drained
        when ``commit_donates`` says so; ``plan=`` takes the
        :meth:`plan_commit` result the drain decision was made on."""
        staged, tinfo = staged_tinfo
        if plan is _PLAN_UNSET:
            plan = self._warm_plan(staged, tinfo)
        # dirty score rows/columns this commit invalidates, computed
        # against the PRE-commit mirrors, like the plan
        score_dirty = (
            self._score_dirty_rows(staged, plan) if plan is not None else None
        )
        # atomic commit point: nothing above mutated self
        for key, value in staged.items():
            setattr(self, key, value)
        if plan is None:
            self._snapshot = None  # cold: rebuilt lazily at snapshot()
            self._score_res = None  # geometry moved: nothing to advance
            self._cand_res = None
            self.last_sync_path = "cold"
        else:
            try:
                with maybe_span(spans, "delta_scatter"):
                    self._snapshot = self._apply_warm(plan)
                self.last_sync_path = "warm"
                self._note_score_dirty(score_dirty)
                self._note_candidate_dirty(score_dirty)
            except Exception:
                # a torn device update may have written part of the
                # resident tensors: drop residency, the mirrors stay
                # truthful and the next snapshot() cold-rebuilds
                logger.exception(
                    "warm device update failed; falling back to cold rebuild"
                )
                self._snapshot = None
                self._score_res = None
                self._cand_res = None
                self.last_sync_path = "cold"
        self._i32_ok = None
        kinds = [kind for kind, _, _ in tinfo.values()]
        return {
            "path": self.last_sync_path,
            "delta_tensors": kinds.count("delta"),
            "full_tensors": kinds.count("full"),
        }

    def export_sync_request(self) -> Optional["wire.SyncRequest"]:
        """Full-state ``SyncRequest`` rebuilt from the host mirrors: a
        fresh ResidentState that applies it ends with the same mirrors.
        Explicit buckets ride along.  None before the first Sync."""
        if self.node_alloc is None or self.pod_requests is None:
            return None
        req = wire.SyncRequest(
            node_bucket=self.node_bucket, pod_bucket=self.pod_bucket
        )
        for target, arr in (
            (req.nodes.allocatable, self.node_alloc),
            (req.nodes.requested, self.node_requested),
            (req.nodes.usage, self.node_usage),
            (req.nodes.agg_usage, self.node_agg),
            (req.nodes.agg_fresh, self.node_agg_fresh),
            (req.nodes.prod_usage, self.node_prod),
            (req.pods.requests, self.pod_requests),
            (req.pods.estimated, self.pod_estimated),
            (req.pods.sensitivity, self.pod_sensitivity),
            (req.quotas.runtime, self.quota_runtime),
            (req.quotas.used, self.quota_used),
            (req.quotas.limited, self.quota_limited),
            (req.terms.throughput, self.term_throughput),
        ):
            if _present(arr):
                # always the full payload: the receiver has no baseline
                target.CopyFrom(numpy_to_tensor(np.asarray(arr, np.int64)))
        if self.node_names:
            req.nodes.names.extend(self.node_names)
        if self.node_fresh is not None and len(self.node_fresh):
            req.nodes.metric_fresh.extend(bool(b) for b in self.node_fresh)
        if self.pod_names:
            req.pods.names.extend(self.pod_names)
        for target, arr in (
            (req.pods.priority, self.pod_priority),
            (req.pods.priority_class, self.pod_priority_class),
            (req.pods.gang_id, self.pod_gang),
            (req.pods.quota_id, self.pod_quota),
            (req.gangs.min_member, self.gang_min),
            (req.nodes.accel_type, self.node_accel),
            (req.pods.workload_class, self.pod_workload),
        ):
            if arr is not None and len(arr):
                target.extend(np.asarray(arr))
        return req

    def _decode_sync(self, reqmsg: "wire.SyncRequest"):
        """The pure decode/validate half of apply_sync: the staged mirror
        values and per-tensor wire info, without mutating any state."""
        n = reqmsg.nodes
        p = reqmsg.pods
        wire_tensors = {
            "node_alloc": n.allocatable,
            "node_requested": n.requested,
            "node_usage": n.usage,
            "node_agg": n.agg_usage,
            "node_agg_fresh": n.agg_fresh,
            "node_prod": n.prod_usage,
            "pod_requests": p.requests,
            "pod_estimated": p.estimated,
            "pod_sensitivity": p.sensitivity,
            "term_throughput": reqmsg.terms.throughput,
        }
        staged: Dict[str, object] = {}
        tinfo: Dict[str, tuple] = {}

        def decode(tensors) -> None:
            for key, tensor in tensors.items():
                current = getattr(self, key)
                arr, kind, idx, val = decode_tensor(tensor, current)
                staged[key] = current if kind == "none" else arr
                tinfo[key] = (kind, idx, val)

        decode(wire_tensors)
        # the quota table, the gang table and the pods' memberships: the
        # Sync's "tables" stage, here and in their device update
        with stage_part("tables"):
            decode({
                "quota_runtime": reqmsg.quotas.runtime,
                "quota_used": reqmsg.quotas.used,
                "quota_limited": reqmsg.quotas.limited,
            })
            if p.gang_id:
                staged["pod_gang"] = np.asarray(list(p.gang_id), dtype=np.int32)
            if p.quota_id:
                staged["pod_quota"] = np.asarray(list(p.quota_id), dtype=np.int32)
            if reqmsg.gangs.min_member:
                staged["gang_min"] = np.asarray(
                    list(reqmsg.gangs.min_member), np.int32
                )
        if staged["node_alloc"] is None or staged["pod_requests"] is None:
            raise ValueError("first Sync must carry full node and pod tensors")
        if n.metric_fresh:
            staged["node_fresh"] = np.asarray(list(n.metric_fresh), dtype=bool)
        if n.names:
            staged["node_names"] = tuple(n.names)
        if p.priority:
            staged["pod_priority"] = np.asarray(list(p.priority), dtype=np.int64)
        if p.priority_class:
            staged["pod_priority_class"] = np.asarray(
                list(p.priority_class), dtype=np.int32
            )
        if p.names:
            staged["pod_names"] = tuple(p.names)
        if n.accel_type:
            staged["node_accel"] = np.asarray(list(n.accel_type), np.int32)
        if p.workload_class:
            staged["pod_workload"] = np.asarray(
                list(p.workload_class), np.int32
            )

        # explicit wire buckets win; otherwise a warm frame that omits them
        # INHERITS the resident bucket (sticky-grow) instead of reshaping
        # the resident snapshot mid-stream
        def bucket(wire_value, current, rows):
            if wire_value:
                return int(wire_value)
            if current and current >= rows:
                return current
            return pad_bucket(rows)

        staged["node_bucket"] = bucket(
            reqmsg.node_bucket, self.node_bucket,
            staged["node_alloc"].shape[0],
        )
        staged["pod_bucket"] = bucket(
            reqmsg.pod_bucket, self.pod_bucket,
            staged["pod_requests"].shape[0],
        )
        self._reset_companions(staged, tinfo)
        return staged, tinfo

    def _reset_companions(self, staged: Dict[str, object], tinfo) -> None:
        """When a full tensor changes a table's row count, omitted
        companion columns reset to defaults of the new shape instead of
        lingering at the stale shape.  (None means "the default of the
        current shape" everywhere in this class: all-fresh, zero priority,
        no gang/quota membership, estimated = requests.)"""
        def rows(a):
            return -1 if a is None else a.shape[0]

        def reset(companions, new_rows):
            for key in companions:
                if key in _DELTA_TENSORS:
                    if tinfo[key][0] == "none":
                        staged[key] = None
                    elif rows(staged[key]) != new_rows:
                        # a delta (validated against the PRE-resize shape)
                        # or an old-shaped full tensor riding the resize
                        raise ValueError(
                            f"{key} targets the pre-resize table "
                            f"({rows(staged[key])} rows != {new_rows})"
                        )
                elif key not in staged:
                    staged[key] = _COMPANION_DEFAULTS.get(key)

        if rows(staged["node_alloc"]) != rows(self.node_alloc):
            reset(_NODE_COMPANIONS, rows(staged["node_alloc"]))
        if rows(staged["pod_requests"]) != rows(self.pod_requests):
            reset(_POD_COMPANIONS, rows(staged["pod_requests"]))

    # -- warm-path planning / application --
    def _warm_plan(self, staged, tinfo):
        """How this Sync lands on the resident snapshot.

        None when residency must drop (no resident snapshot, or any
        geometry change: table rows, pad buckets, a tensor or table
        appearing or disappearing).  Otherwise ``(tensor_updates,
        derived)``: mirror key -> ("delta", idx, val) / ("full",), and the
        set of scalar-derived device columns to rebuild.  Runs BEFORE the
        mirror commit so it can compare staged against current values."""
        if self._snapshot is None:
            return None
        if (
            staged["node_bucket"] != self.node_bucket
            or staged["pod_bucket"] != self.pod_bucket
        ):
            return None

        def shape(a):
            return None if a is None else a.shape

        for key in _DELTA_TENSORS:
            old, new = getattr(self, key), staged[key]
            if _present(old) != _present(new):
                return None
            if _present(old) and shape(old) != shape(new):
                return None
        old_gang = self.gang_min if self.gang_min is not None else ()
        new_gang = staged.get("gang_min", self.gang_min)
        new_gang = new_gang if new_gang is not None else ()
        if len(old_gang) != len(new_gang):
            return None
        new_fresh = staged.get("node_fresh", self.node_fresh)
        if new_fresh is not None and len(new_fresh) != staged["node_alloc"].shape[0]:
            return None

        tensor_updates = {}
        for key in _DELTA_TENSORS:
            kind, idx, val = tinfo[key]
            if kind == "delta":
                tensor_updates[key] = ("delta", idx, val)
            elif kind == "full":
                if not np.array_equal(staged[key], getattr(self, key)):
                    tensor_updates[key] = ("full",)
        # estimated falls back to requests while never synced: a requests
        # update must land on the estimated device tensor too
        if staged["pod_estimated"] is None and "pod_requests" in tensor_updates:
            tensor_updates["pod_estimated_from_requests"] = tensor_updates[
                "pod_requests"
            ]

        # first appearance of a term column: the snapshot gains a leaf
        for key in ("node_accel", "pod_workload"):
            if staged.get(key) is not None and getattr(self, key) is None:
                return None

        derived = set()
        for key in ("node_fresh", "pod_priority", "pod_priority_class",
                    "pod_gang", "pod_quota", "gang_min",
                    "node_accel", "pod_workload"):
            if key not in staged:
                continue
            old = getattr(self, key)
            if old is None or not np.array_equal(
                np.asarray(staged[key]), np.asarray(old)
            ):
                derived.add(key)
        if "pod_priority" in derived and staged.get(
            "pod_priority_class", self.pod_priority_class
        ) is None:
            # classes derive from the priority bands when the wire never
            # sent explicit ones
            derived.add("pod_priority_class")
        return tensor_updates, derived

    def _apply_warm(self, plan) -> ClusterSnapshot:
        """Apply a warm plan to the resident snapshot (mirrors already
        committed).  Delta tensors scatter in place; full tensors bind a
        new tensor built from the committed mirror; derived columns
        rebuild through the same ``_dev_*`` functions the cold path uses."""
        tensor_updates, derived = plan
        snap = self._snapshot
        nodes, pods, quotas = snap.nodes, snap.pods, snap.quotas

        mesh = self.active_mesh()

        def updated(dev_arr, update):
            if update[0] == "delta":
                # a node tensor scatters into its owning shard only; a
                # replicated one into every copy, with the same values
                return apply_flat_delta(dev_arr, update[1], update[2], mesh=mesh)
            return None  # full: rebuilt below from the committed mirror

        node_patch = {}
        for key, field in (
            ("node_alloc", "allocatable"),
            ("node_requested", "requested"),
            ("node_usage", "usage"),
        ):
            if key in tensor_updates:
                new = updated(getattr(nodes, field), tensor_updates[key])
                node_patch[field] = (
                    new if new is not None
                    else self._dev_padded2(key, self.node_bucket)
                )
        for key, field, build in (
            ("node_agg", "agg_usage", self._dev_agg_usage),
            ("node_agg_fresh", "agg_fresh", self._dev_agg_fresh),
            ("node_prod", "prod_usage", self._dev_prod_usage),
        ):
            if key in tensor_updates:
                new = updated(getattr(nodes, field), tensor_updates[key])
                node_patch[field] = new if new is not None else build()
        if "node_fresh" in derived:
            node_patch["metric_fresh"] = self._dev_metric_fresh()
        if "node_accel" in derived:
            node_patch["accel_type"] = self._dev_accel_type()

        pod_patch = {}
        if "pod_requests" in tensor_updates:
            new = updated(pods.requests, tensor_updates["pod_requests"])
            pod_patch["requests"] = (
                new if new is not None
                else self._dev_padded2("pod_requests", self.pod_bucket)
            )
        est_update = tensor_updates.get(
            "pod_estimated", tensor_updates.get("pod_estimated_from_requests")
        )
        if est_update is not None:
            new = updated(pods.estimated, est_update)
            pod_patch["estimated"] = (
                new if new is not None else self._dev_estimated()
            )
        if "pod_sensitivity" in tensor_updates:
            new = updated(pods.sensitivity, tensor_updates["pod_sensitivity"])
            pod_patch["sensitivity"] = (
                new if new is not None else self._dev_sensitivity()
            )
        if "pod_priority" in derived:
            pod_patch["priority"] = self._dev_priority()
        if "pod_priority_class" in derived:
            pod_patch["priority_class"] = self._dev_priority_class()
        if "pod_workload" in derived:
            pod_patch["workload_class"] = self._dev_workload_class()

        quota_patch = {}
        with stage_part("tables"):
            if "pod_gang" in derived:
                pod_patch["gang_id"] = self._dev_gang_id()
            if "pod_quota" in derived:
                pod_patch["quota_id"] = self._dev_quota_id()
            for key, field in (
                ("quota_runtime", "runtime"),
                ("quota_used", "used"),
                ("quota_limited", "limited"),
            ):
                if key in tensor_updates:
                    new = updated(getattr(quotas, field), tensor_updates[key])
                    if new is None:
                        arr = getattr(self, key)
                        new = self._place_rep(
                            arr.astype(bool) if field == "limited" else arr
                        )
                    quota_patch[field] = new
            gangs = self._dev_gangs() if "gang_min" in derived else snap.gangs

        throughput = snap.throughput
        if "term_throughput" in tensor_updates:
            new = updated(snap.throughput, tensor_updates["term_throughput"])
            throughput = new if new is not None else self._dev_throughput()

        if node_patch:
            nodes = dataclasses.replace(nodes, **node_patch)
        if pod_patch:
            pods = dataclasses.replace(pods, **pod_patch)
        if quota_patch:
            quotas = dataclasses.replace(quotas, **quota_patch)
        return ClusterSnapshot(
            nodes=nodes, pods=pods, gangs=gangs, quotas=quotas,
            throughput=throughput,
        )

    # -- resident score tensors --
    def score_residency(self) -> Optional[ScoreResidency]:
        """The resident [P, N] score/feasible tensors with their dirt, or
        None.  Callers serialize through the dispatch launch lock."""
        return self._score_res

    def drop_score_residency(self) -> None:
        self._score_res = None

    def store_score_result(self, cfg, scores, feasible) -> None:
        """Adopt the tensors a Score launch just certified; the dirt
        clears (the launch incorporated it).  Mesh-resident, they are kept
        split by node columns (``parallel.mesh.score_sharding``), so the
        next incremental rescore is shard-local; tensors already placed so
        are kept as they are."""
        mesh = self.active_mesh()
        if mesh is not None:
            spec = score_sharding(mesh)
            scores, feasible = shard_tensor(scores, spec), shard_tensor(feasible, spec)
        self._score_res = ScoreResidency(cfg, scores, feasible)

    def _note_score_dirty(self, score_dirty) -> None:
        """Advance the score residency past a warm commit: union the
        invalidated rows (None = attribution lost, e.g. a full re-upload:
        the residency drops and the next Score full-rescores)."""
        res_ = self._score_res
        if res_ is None:
            return
        if score_dirty is None:
            self._score_res = None
            return
        dirty_nodes, dirty_pods = score_dirty
        res_.dirty_nodes |= dirty_nodes
        res_.dirty_pods |= dirty_pods

    # -- resident sparse candidate lists --
    def candidate_residency(self) -> Optional[CandidateResidency]:
        """The resident [P, C] candidate map with its counts and dirt, or
        None.  Same serialization contract as :meth:`score_residency`."""
        return self._cand_res

    def drop_candidate_residency(self) -> None:
        self._cand_res = None

    def store_candidates(self, cfg, idx, count, merges: int = 0) -> None:
        """Adopt the candidate lists a sparse Score launch built or
        refreshed; ``merges`` is the merge-refresh chain's depth."""
        self._cand_res = CandidateResidency(cfg, idx, count, merges=merges)

    def _note_candidate_dirty(self, score_dirty) -> None:
        """Advance the candidate residency with the score residency's row
        attribution (a superset for feasibility, so the lists stay exact);
        None = attribution lost: drop."""
        res_ = self._cand_res
        if res_ is None:
            return
        if score_dirty is None:
            self._cand_res = None
            return
        dirty_nodes, dirty_pods = score_dirty
        res_.dirty_nodes |= dirty_nodes
        res_.dirty_pods |= dirty_pods

    def _score_dirty_rows(self, staged, plan):
        """(dirty node rows, dirty pod rows) a warm plan invalidates in the
        resident score tensors, or None when row attribution is lost (a
        full tensor rode the frame).  Runs BEFORE the mirror commit.

        * a sparse delta's flat indices divide by the mirror's trailing
          row size;
        * quota tensors contribute nothing (score_cycle reads no quota);
        * freshness diffs old-vs-new per node;
        * priority/class changes dirty the pods whose EFFECTIVE class
          moved (``_pc_column``);
        * a throughput-matrix change to cell (c, a) dirties every node
          whose clipped accel type is ``a`` (a full re-upload of the small
          matrix stays attributable through a mirror diff).
        """
        tensor_updates, derived = plan
        dirty_nodes: set = set()
        dirty_pods: set = set()
        for key, update in tensor_updates.items():
            if key == "pod_estimated_from_requests":
                continue  # rides pod_requests' indices, counted there
            if key == "term_throughput":
                tput = np.asarray(self.term_throughput, np.int64)
                if update[0] == "delta":
                    changed = np.asarray(update[1], np.int64)
                else:
                    changed = np.flatnonzero(
                        tput.reshape(-1)
                        != np.asarray(staged[key], np.int64).reshape(-1)
                    )
                A = int(tput.shape[-1]) if tput.ndim > 1 else 1
                touched = set((changed % A).tolist())
                N = self.node_alloc.shape[0]
                accel_new = staged.get("node_accel", self.node_accel)
                accel = (
                    np.asarray(accel_new, np.int64)
                    if accel_new is not None
                    else np.zeros(N, np.int64)
                )
                accel = np.clip(accel[:N], 0, A - 1)
                for a in touched:
                    dirty_nodes.update(np.flatnonzero(accel == a).tolist())
                continue
            if key not in _SCORE_NODE_TENSORS and key not in _SCORE_POD_TENSORS:
                continue
            if update[0] != "delta":
                return None  # full re-upload: which rows moved is unknown
            base = np.asarray(getattr(self, key))
            trailing = int(np.prod(base.shape[1:])) if base.ndim > 1 else 1
            rows = dirty_nodes if key in _SCORE_NODE_TENSORS else dirty_pods
            rows.update(
                (np.asarray(update[1], np.int64) // trailing).tolist()
            )
        new_fresh = staged.get("node_fresh")
        if "node_fresh" in derived and new_fresh is not None:
            new_fresh = np.asarray(new_fresh, bool)
            old_fresh = (
                np.asarray(self.node_fresh, bool)
                if self.node_fresh is not None
                else np.ones(len(new_fresh), bool)
            )
            if len(old_fresh) == len(new_fresh):
                dirty_nodes.update(
                    np.flatnonzero(old_fresh != new_fresh).tolist()
                )
            else:
                return None  # length moved without a resize: stay safe
        if "pod_priority" in derived or "pod_priority_class" in derived:
            P = self.pod_requests.shape[0]

            def eff_class(explicit, priority):
                prio = (
                    np.asarray(priority)
                    if priority is not None
                    else np.zeros(P, np.int64)
                )
                return _pc_column(explicit, prio, P, P)

            old_cls = eff_class(self.pod_priority_class, self.pod_priority)
            new_cls = eff_class(
                staged.get("pod_priority_class", self.pod_priority_class),
                staged.get("pod_priority", self.pod_priority),
            )
            dirty_pods.update(np.flatnonzero(old_cls != new_cls).tolist())
        # an accel-type flip moves that node's column, a workload-class
        # flip that pod's row
        for key, rows in (("node_accel", dirty_nodes),
                          ("pod_workload", dirty_pods)):
            if key not in derived:
                continue
            new_col = staged.get(key)
            old_col = getattr(self, key)
            if new_col is None or old_col is None:
                return None
            new_col = np.asarray(new_col, np.int64)
            old_col = np.asarray(old_col, np.int64)
            if len(new_col) != len(old_col):
                return None
            rows.update(np.flatnonzero(old_col != new_col).tolist())
        return dirty_nodes, dirty_pods

    def has_tables(self) -> bool:
        """Whether the synced cluster has an ElasticQuota group or a
        PodGroup (from the host mirrors)."""
        return _present(self.quota_runtime) or _present(self.gang_min)

    def i32_fits(self) -> bool:
        """Whether the resident tensors fit the int32 kernels' arithmetic,
        from the host mirrors (no device round trip on the Assign path)."""
        if self._i32_ok is None:
            from koordinator_tpu_torch.solver import check_i32_bounds

            zeros = np.zeros(1, np.int64)

            def amax(a):
                return int(np.abs(a).max()) if a is not None and a.size else 0

            est = (
                self.pod_estimated
                if self.pod_estimated is not None
                else self.pod_requests
            )
            scored = max(
                amax(self.node_alloc),
                amax(self.node_requested),
                amax(self.node_usage),
                amax(self.pod_requests),
                amax(est),
            )
            quota = max(amax(self.quota_runtime), amax(self.quota_used))
            est_sum = int(
                np.abs(est if est is not None else zeros).sum(axis=0).max()
            )
            req_sum = int(np.abs(self.pod_requests).sum(axis=0).max())
            self._i32_ok = check_i32_bounds((scored, quota, est_sum, req_sum))
        return self._i32_ok

    def _pad2(self, a: np.ndarray, rows: int) -> np.ndarray:
        out = np.zeros((rows, a.shape[1]), np.int64)
        out[: a.shape[0]] = a
        return out

    # -- mesh placement --
    def active_mesh(self):
        """The cluster mesh for the current node bucket, or None (no mesh,
        or the bucket does not divide over it: the snapshot then stays
        single-device for this geometry, logged once)."""
        if self.mesh is None:
            return None
        nb = self.node_bucket
        if nb and nb % self.mesh.size == 0:
            return self.mesh
        if nb and nb not in self._mesh_skip_warned:
            self._mesh_skip_warned.add(nb)
            logger.warning(
                "node bucket %d does not divide over the %d-device cluster mesh; "
                "resident snapshot stays single-device for this geometry",
                nb, self.mesh.size,
            )
        return None

    # -- per-field device tensors (shared by the cold rebuild and the
    #    warm patch, so the two paths write the same tensors) --
    def _place(self, a) -> torch.Tensor:
        """A NEW device tensor holding ``a`` (never a view of a mirror)."""
        return torch.from_numpy(np.array(a, copy=True)).to(self.device)

    def _place_node(self, a):
        """A node-major tensor: split along the cluster mesh's node axis
        when mesh-resident, else one device tensor."""
        m = self.active_mesh()
        if m is None:
            return self._place(a)
        return shard_tensor(torch.from_numpy(np.asarray(a)), node_sharding(m, np.ndim(a)))

    def _place_rep(self, a):
        """A pod/gang/quota tensor: replicated over the cluster mesh when
        mesh-resident (every shard's certifier and quota recheck reads
        it), else one device tensor."""
        m = self.active_mesh()
        if m is None:
            return self._place(a)
        return shard_tensor(torch.from_numpy(np.asarray(a)), replicated_sharding(m))

    def _dev_padded2(self, key: str, rows: int) -> torch.Tensor:
        place = self._place_node if key.startswith("node_") else self._place_rep
        return place(self._pad2(np.asarray(getattr(self, key), np.int64), rows))

    def _dev_metric_fresh(self) -> torch.Tensor:
        N = self.node_alloc.shape[0]
        fresh = np.zeros(self.node_bucket, bool)
        fresh[:N] = (
            self.node_fresh if self.node_fresh is not None else np.ones(N, bool)
        )
        return self._place_node(fresh)

    def _dev_agg_usage(self):
        if not _present(self.node_agg):
            return None
        return self._place_node(_pad_rows_to(self.node_agg, self.node_bucket))

    def _dev_agg_fresh(self):
        if not _present(self.node_agg_fresh):
            return None
        return self._place_node(
            _pad_rows_to(self.node_agg_fresh, self.node_bucket).astype(bool)
        )

    def _dev_prod_usage(self):
        if not _present(self.node_prod):
            return None
        return self._place_node(
            _pad_rows_to(np.asarray(self.node_prod, np.int64), self.node_bucket)
        )

    def _dev_accel_type(self) -> torch.Tensor:
        """Node accel-type column padded to the bucket (pad rows type 0:
        padded nodes are masked by ``valid``, and the term gather clips)."""
        N = self.node_alloc.shape[0]
        col = np.zeros(self.node_bucket, np.int32)
        if self.node_accel is not None:
            src = np.asarray(self.node_accel, np.int32)
            col[: min(N, len(src))] = src[:N]
        return self._place_node(col)

    def _dev_workload_class(self) -> torch.Tensor:
        P = self.pod_requests.shape[0]
        col = np.zeros(self.pod_bucket, np.int32)
        if self.pod_workload is not None:
            src = np.asarray(self.pod_workload, np.int32)
            col[: min(P, len(src))] = src[:P]
        return self._place_rep(col)

    def _dev_sensitivity(self) -> torch.Tensor:
        return self._place_rep(
            self._pad2(
                np.asarray(self.pod_sensitivity, np.int64), self.pod_bucket
            )
        )

    def _dev_throughput(self) -> torch.Tensor:
        """The [C, A] throughput matrix, never padded."""
        return self._place_rep(np.asarray(self.term_throughput, np.int64))

    def _dev_estimated(self) -> torch.Tensor:
        est = (
            self.pod_estimated
            if self.pod_estimated is not None
            else self.pod_requests
        )
        return self._place_rep(self._pad2(np.asarray(est, np.int64), self.pod_bucket))

    def _dev_priority(self) -> torch.Tensor:
        P = self.pod_requests.shape[0]
        prio = (
            self.pod_priority
            if self.pod_priority is not None
            else np.zeros(P, np.int64)
        )
        pprio = np.zeros(self.pod_bucket, np.int64)
        pprio[:P] = prio
        return self._place_rep(pprio)

    def _dev_priority_class(self) -> torch.Tensor:
        P = self.pod_requests.shape[0]
        prio = (
            self.pod_priority
            if self.pod_priority is not None
            else np.zeros(P, np.int64)
        )
        # explicit classes from the wire, else derived from the priority
        # bands; padding is NONE (zeros would mean PROD)
        return self._place_rep(
            _pc_column(self.pod_priority_class, prio, P, self.pod_bucket)
        )

    def _dev_gang_id(self) -> torch.Tensor:
        P = self.pod_requests.shape[0]
        gang = (
            self.pod_gang if self.pod_gang is not None else np.full(P, -1, np.int32)
        )
        pgang = np.full(self.pod_bucket, -1, np.int32)
        pgang[:P] = gang
        return self._place_rep(pgang)

    def _dev_quota_id(self) -> torch.Tensor:
        P = self.pod_requests.shape[0]
        quota = (
            self.pod_quota if self.pod_quota is not None else np.full(P, -1, np.int32)
        )
        pquota = np.full(self.pod_bucket, -1, np.int32)
        pquota[:P] = quota
        return self._place_rep(pquota)

    def _dev_gangs(self) -> GangTable:
        gmin = self.gang_min if self.gang_min is not None else np.zeros(0, np.int32)
        G = max(1, len(gmin))
        gvalid = np.zeros(G, bool)
        gvalid[: len(gmin)] = True
        gm = np.zeros(G, np.int32)
        gm[: len(gmin)] = gmin
        return GangTable(
            min_member=self._place_rep(gm),
            valid=self._place_rep(gvalid),
            names=(),
        )

    def snapshot(self) -> ClusterSnapshot:
        if self._snapshot is not None:
            return self._snapshot
        N = self.node_alloc.shape[0]
        P = self.pod_requests.shape[0]
        nb, pb = self.node_bucket, self.pod_bucket
        nvalid = np.zeros(nb, bool)
        nvalid[:N] = True
        pvalid = np.zeros(pb, bool)
        pvalid[:P] = True
        if _present(self.quota_runtime):
            Q = self.quota_runtime.shape[0]
            qrt, quse = self.quota_runtime, self.quota_used
            qlim = self.quota_limited.astype(bool)
            qvalid = np.ones(Q, bool)
        else:
            qrt = np.zeros((1, R), np.int64)
            quse = np.zeros((1, R), np.int64)
            qlim = np.zeros((1, R), bool)
            qvalid = np.zeros(1, bool)

        self._snapshot = ClusterSnapshot(
            nodes=NodeBatch(
                allocatable=self._dev_padded2("node_alloc", nb),
                requested=(
                    self._dev_padded2("node_requested", nb)
                    if self.node_requested is not None
                    else self._place_node(np.zeros((nb, R), np.int64))
                ),
                usage=(
                    self._dev_padded2("node_usage", nb)
                    if self.node_usage is not None
                    else self._place_node(np.zeros((nb, R), np.int64))
                ),
                metric_fresh=self._dev_metric_fresh(),
                valid=self._place_node(nvalid),
                agg_usage=self._dev_agg_usage(),
                agg_fresh=self._dev_agg_fresh(),
                prod_usage=self._dev_prod_usage(),
                accel_type=(
                    self._dev_accel_type()
                    if self.node_accel is not None
                    else None
                ),
                names=(),
            ),
            pods=PodBatch(
                requests=self._dev_padded2("pod_requests", pb),
                estimated=self._dev_estimated(),
                priority_class=self._dev_priority_class(),
                qos=self._place_rep(np.zeros(pb, np.int32)),
                priority=self._dev_priority(),
                gang_id=self._dev_gang_id(),
                quota_id=self._dev_quota_id(),
                valid=self._place_rep(pvalid),
                workload_class=(
                    self._dev_workload_class()
                    if self.pod_workload is not None
                    else None
                ),
                sensitivity=(
                    self._dev_sensitivity()
                    if _present(self.pod_sensitivity)
                    else None
                ),
                names=(),
            ),
            gangs=self._dev_gangs(),
            quotas=QuotaTable(
                runtime=self._place_rep(qrt),
                used=self._place_rep(quse),
                limited=self._place_rep(qlim),
                valid=self._place_rep(qvalid),
                names=(),
            ),
            throughput=(
                self._dev_throughput()
                if _present(self.term_throughput)
                else None
            ),
        )
        return self._snapshot
