"""Trace-driven cluster simulator and replay engine.

Counterpart of ``koordinator_tpu/harness/trace.py``.  The generator is the
reference's, line for line: a :class:`Trace` of one seed is the same bytes
(``Trace.digest()`` equal to the JAX package's), with gang arrivals on
``minMember`` boundaries, ElasticQuota pressure waves, node drains and
resizes, usage ticks and priority churn across the koord-prod|mid|batch|free
bands.  :class:`TraceReplay` replays a trace through the whole serving path
of the port: the delta-encoding ``bridge/client.py ScorerClient`` over a
real unix socket (gRPC through ``make_server``, or the raw framing of
``bridge/udsserver.py RawUdsServer``), through the coalescing dispatcher,
onto the device.

One replay is both a CORRECTNESS and a PERFORMANCE gate:

* the same event stream drives the full-engine servicer AND a serial
  oracle servicer (``max_batch=1``, ``pipeline_depth=1``, memos and the
  incremental engine off), with the flat-Score reply arrays, the Assign
  assignment/status arrays and the Assign ``path`` digest-compared after
  EVERY event — bit parity, not statistics;
* the measured pass runs under ``analysis/retrace_guard.py``: it must
  build no kernel and demote no rung (an untimed warm-up pass over the
  identical stream comes first, so every kernel the trace reaches is
  built before the guard arms);
* every RPC's client-observed latency lands in the
  ``koord_scorer_trace_cycle_ms{band, rpc}`` histogram, which the
  ``obs/slo.py`` SLO gate judges (per-band p99 cycle latency, per-RPC p99);
* the replay emits a per-event timeline in the flight-recorder dump
  format (``obs.validate_flight_dump`` is the schema).

Determinism: a :class:`Trace` is concrete — every event carries the
absolute rows it writes (plain ints, JSON-able), produced once by the
generator's own cluster model.  Replay is a dumb applier, so the same seed
replays the same bytes; ``Trace.digest()`` pins that.

The artificial slow stage (:func:`slow_stage`) exists for the gate's own
regression test: latency injected into the engine's launch path must flip
the SLO verdicts to FAIL while bit parity still holds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model.snapshot import PriorityClass, estimate_pod

R = res.NUM_RESOURCES
_CPU = res.RESOURCE_INDEX[res.CPU]
_MEM = res.RESOURCE_INDEX[res.MEMORY]
_PODS = res.RESOURCE_INDEX[res.PODS]

BANDS = ("koord-prod", "koord-mid", "koord-batch", "koord-free")
INFRA_BAND = "infra"
_BAND_BASE_PRIORITY = {
    "koord-prod": 9000, "koord-mid": 7000,
    "koord-batch": 5000, "koord-free": 3000,
}
RPCS = ("sync", "score", "assign", "cycle")

# the default event mix with the fused-term kinds folded in:
# a trace generated with TraceConfig(mix=TERM_MIX, accel_types=...,
# workload_classes=...) drifts throughput rows and sensitivity profiles
# on the warm delta path like any other event
TERM_MIX = (
    ("gang_arrival", 0.10),
    ("gang_partial", 0.04),
    ("pod_arrival", 0.20),
    ("pod_departure", 0.14),
    ("priority_churn", 0.10),
    ("quota_wave", 0.10),
    ("usage_tick", 0.10),
    ("node_drain", 0.04),
    ("node_restore", 0.03),
    ("node_resize", 0.03),
    ("throughput_update", 0.06),
    ("sensitivity_drift", 0.06),
)

# sparse-regime event mix (pair with TraceConfig.open_nodes
# and gangs=0): only kinds that keep every pod slot OCCUPIED.  A
# zero-request slot is feasible on every node — the sparse engine
# correctly refuses it at C < N rather than truncate — and arrivals/
# departures need (or create) empty slots, so a sparse trace churns
# priorities, quotas and nodes instead.
SPARSE_MIX = (
    ("priority_churn", 0.30),
    ("quota_wave", 0.20),
    ("usage_tick", 0.20),
    ("node_drain", 0.10),
    ("node_restore", 0.10),
    ("node_resize", 0.10),
)


class TraceParityError(AssertionError):
    """The engine servicer's reply bytes diverged from the serial
    oracle's at a named replay step."""


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Shape of one generated trace.  ``events`` counts the replayed
    mutations; every event is followed by one Score + one Assign
    cycle on both servicers."""

    seed: int = 0
    nodes: int = 32
    pod_slots: int = 128
    tenants: int = 4
    gangs: int = 6
    gang_min_member: int = 4
    events: int = 32
    top_k: int = 8
    # (kind, weight) mix the generator draws from; infra events label
    # their latency observations band="infra"
    mix: Tuple[Tuple[str, float], ...] = (
        ("gang_arrival", 0.12),
        ("gang_partial", 0.04),
        ("pod_arrival", 0.24),
        ("pod_departure", 0.16),
        ("priority_churn", 0.12),
        ("quota_wave", 0.12),
        ("usage_tick", 0.10),
        ("node_drain", 0.04),
        ("node_restore", 0.03),
        ("node_resize", 0.03),
    )
    # arrival probability per band, aligned with BANDS
    band_mix: Tuple[float, ...] = (0.35, 0.20, 0.30, 0.15)
    # fused scoring-term state: >0 gives every node an
    # accelerator type in [0, accel_types), every pod a workload class
    # in [0, workload_classes) plus a sensitivity profile, and the init
    # a [workload_classes, accel_types] throughput matrix — enabling
    # the throughput_update / sensitivity_drift event kinds (TERM_MIX
    # is the default mix with both folded in).  0 = terms off, init
    # unchanged.
    accel_types: int = 0
    workload_classes: int = 0
    # sparse-feasibility regime: >0 leaves only this many
    # nodes with pod-sized headroom — the rest start requested-to-the-
    # brim (free cpu/mem below the smallest pod ask), so every pod's
    # exact feasible count stays near ``open_nodes`` and a sparse-
    # engine replay (CycleConfig.candidate_width) serves without
    # overflow at node counts the dense oracle cannot even allocate.
    # node_resize (x1.25) can re-open a closed node mid-trace, so
    # leave width slack: open_nodes <= candidate_width / 2 is
    # comfortable.  0 = every node keeps the dense generator's 2-30%
    # load (feasibility ~N, the dense engines' regime).
    open_nodes: int = 0

    def to_doc(self) -> Dict[str, object]:
        doc = dataclasses.asdict(self)
        doc["mix"] = [list(e) for e in self.mix]
        doc["band_mix"] = list(self.band_mix)
        return doc


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One concrete mutation: ``payload`` holds the absolute rows to
    write (plain ints/lists — the replay never recomputes them)."""

    kind: str
    band: str
    payload: Dict[str, object]

    def to_doc(self) -> Dict[str, object]:
        return {"kind": self.kind, "band": self.band,
                "payload": self.payload}


@dataclasses.dataclass(frozen=True)
class Trace:
    config: TraceConfig
    init: Dict[str, object]
    events: Tuple[TraceEvent, ...]

    def to_doc(self) -> Dict[str, object]:
        return {
            "config": self.config.to_doc(),
            "init": _jsonable_init(self.init),
            "events": [e.to_doc() for e in self.events],
        }

    def digest(self) -> str:
        # cached on the frozen instance: the full-trace JSON serialize
        # is several MB at full scale and digest() is consulted per
        # replay pass (and once inside the measured wall clock)
        cached = self.__dict__.get("_digest")
        if cached is None:
            cached = hashlib.sha256(
                json.dumps(self.to_doc(), sort_keys=True).encode()
            ).hexdigest()
            object.__setattr__(self, "_digest", cached)
        return cached

    def bands(self) -> List[str]:
        seen: List[str] = []
        for e in self.events:
            if e.band not in seen:
                seen.append(e.band)
        return seen


def _jsonable_init(init: Dict[str, object]) -> Dict[str, object]:
    """Init tensors are held as numpy at sparse scale (
    ``TraceConfig.nodes`` accepts node counts past the dense
    allocator's reach, and a million-row ``.tolist()`` is both slow
    and several GB of python ints); JSON surfaces — export, digest —
    convert at the edge, so small traces serialize exactly as before."""
    return {
        k: (v.tolist() if isinstance(v, np.ndarray) else v)
        for k, v in init.items()
    }


def export_trace(trace: Trace) -> List[str]:
    """Serialize a trace as concrete JSON audit lines: one
    ``trace_header`` line carrying the config + initial cluster state, then
    one ``trace_event`` line per event — the shape a real cluster's audit log drains into, so
    :func:`import_trace` is also the importer for externally captured
    streams."""
    lines = [json.dumps(
        {"event": "trace_header", "config": trace.config.to_doc(),
         "init": _jsonable_init(trace.init)},
        sort_keys=True,
    )]
    lines.extend(
        json.dumps({"event": "trace_event", **e.to_doc()}, sort_keys=True)
        for e in trace.events
    )
    return lines


def import_trace(lines) -> Trace:
    """Rebuild a :class:`Trace` from concrete JSON audit lines (strings
    or already-parsed dicts).  The result is digest-identical to the
    exported trace — every payload is absolute rows, so import is pure
    parsing — and replays through :class:`TraceReplay` unchanged.
    Unknown line shapes raise: an audit stream this module cannot
    faithfully replay must fail loudly, never replay approximately."""
    header: Optional[Dict] = None
    events: List[TraceEvent] = []
    for i, line in enumerate(lines):
        doc = json.loads(line) if isinstance(line, (str, bytes)) else line
        if not isinstance(doc, dict):
            raise ValueError(f"audit line {i} is not a JSON object")
        kind = doc.get("event")
        if kind == "trace_header":
            if header is not None:
                raise ValueError(
                    f"audit line {i}: duplicate trace_header"
                )
            header = doc
        elif kind == "trace_event":
            if header is None:
                raise ValueError(
                    f"audit line {i}: trace_event before trace_header"
                )
            events.append(TraceEvent(
                kind=str(doc["kind"]), band=str(doc["band"]),
                payload=dict(doc["payload"]),
            ))
        else:
            raise ValueError(
                f"audit line {i}: unknown event shape {kind!r}"
            )
    if header is None:
        raise ValueError("audit stream carries no trace_header line")
    cdoc = dict(header["config"])
    cdoc["mix"] = tuple(
        (str(k), float(w)) for k, w in cdoc.get("mix", ())
    )
    cdoc["band_mix"] = tuple(float(v) for v in cdoc.get("band_mix", ()))
    return Trace(
        config=TraceConfig(**cdoc),
        init=dict(header["init"]),
        events=tuple(events),
    )


class ClusterModel:
    """The mutable numpy cluster state one trace replays over — shared
    verbatim by the generator (to mint concrete payloads) and the
    replay (to apply them), so the two can never drift."""

    TENSOR_KEYS = ("nalloc", "nreq", "nuse", "preq", "pest",
                   "qrt", "quse", "qlim")

    def __init__(self, init: Dict[str, object]):
        self.nalloc = np.asarray(init["nalloc"], np.int64).copy()
        self.nreq = np.asarray(init["nreq"], np.int64).copy()
        self.nuse = np.asarray(init["nuse"], np.int64).copy()
        self.fresh = [bool(b) for b in init["fresh"]]
        self.preq = np.asarray(init["preq"], np.int64).copy()
        self.pest = np.asarray(init["pest"], np.int64).copy()
        self.priority = [int(v) for v in init["priority"]]
        self.gang_id = [int(v) for v in init["gang_id"]]
        self.quota_id = [int(v) for v in init["quota_id"]]
        self.gang_min = [int(v) for v in init["gang_min"]]
        self.qrt = np.asarray(init["qrt"], np.int64).copy()
        self.quse = np.asarray(init["quse"], np.int64).copy()
        self.qlim = np.asarray(init["qlim"], np.int64).copy()
        # fused-term state; absent keys = terms off
        self.accel = (
            [int(v) for v in init["accel"]] if "accel" in init else None
        )
        self.wclass = (
            [int(v) for v in init["wclass"]] if "wclass" in init else None
        )
        self.sens = (
            np.asarray(init["sens"], np.int64).copy()
            if "sens" in init else None
        )
        self.tput = (
            np.asarray(init["tput"], np.int64).copy()
            if "tput" in init else None
        )

    def apply(self, event: TraceEvent) -> Set[str]:
        """Apply one event's concrete payload; returns the changed
        array keys (what the replay must Sync)."""
        p = event.payload
        kind = event.kind
        if kind in ("gang_arrival", "gang_partial", "pod_arrival",
                    "pod_departure"):
            for i, slot in enumerate(p["slots"]):
                self.preq[slot] = p["requests"][i]
                self.pest[slot] = p["estimated"][i]
                self.priority[slot] = int(p["priority"][i])
            return {"preq", "pest", "priority"}
        if kind == "priority_churn":
            for slot, prio in zip(p["slots"], p["priority"]):
                self.priority[slot] = int(prio)
            return {"priority"}
        if kind == "quota_wave":
            for i, row in enumerate(p["rows"]):
                self.qrt[row] = p["runtime"][i]
                self.quse[row] = p["used"][i]
            return {"qrt", "quse"}
        if kind in ("node_drain", "node_restore", "node_resize"):
            self.nalloc[int(p["node"])] = p["allocatable"]
            return {"nalloc"}
        if kind == "usage_tick":
            for i, node in enumerate(p["nodes"]):
                self.nuse[node] = p["usage"][i]
                self.fresh[node] = bool(p["fresh"][i])
            return {"nuse", "fresh"}
        if kind == "throughput_update":
            for i, row in enumerate(p["rows"]):
                self.tput[row] = p["values"][i]
            return {"tput"}
        if kind == "sensitivity_drift":
            for i, slot in enumerate(p["slots"]):
                self.sens[slot] = p["profiles"][i]
            return {"sens"}
        raise ValueError(f"unknown trace event kind {kind!r}")


# the model's columns a warm Sync ships as tensors (TraceReplay._sync_kwargs)
SYNCED_TENSORS = ("nalloc", "nuse", "preq", "pest", "qrt", "quse", "tput",
                  "sens")


def tensor_sync_events(trace: Trace) -> int:
    """How many of ``trace``'s events change the value of a column that a
    warm Sync ships as a tensor.  Each reaches the servicer as a Sync that
    carries a tensor (a delta or a full one), so the engine of a replay's
    pass commits that many tensor Syncs besides its cold full one."""
    model = ClusterModel(trace.init)
    changed = 0
    for event in trace.events:
        before = {key: getattr(model, key).copy() for key in SYNCED_TENSORS
                  if getattr(model, key) is not None}
        model.apply(event)
        changed += any(not np.array_equal(arr, getattr(model, key))
                       for key, arr in before.items())
    return changed


# ---- generation ----


def _pod_rows(rng, band: str, count: int) -> Tuple[List, List, List]:
    """(requests, estimated, priority) rows for ``count`` arriving pods
    of one band — all plain ints."""
    pc = PriorityClass.from_name(band)
    reqs, ests, prios = [], [], []
    for _ in range(count):
        cpu_m = int(rng.choice([250, 500, 1000, 2000]))
        mem = int(rng.choice([256, 512, 1024, 2048]))
        req = [0] * R
        req[_CPU], req[_MEM], req[_PODS] = cpu_m, mem, 1
        lim = list(req)
        lim[_CPU], lim[_MEM] = cpu_m * 2, mem * 2
        est = estimate_pod(req, lim, pc)
        reqs.append([int(v) for v in req])
        ests.append([int(v) for v in est])
        prios.append(_BAND_BASE_PRIORITY[band] + int(rng.integers(0, 900)))
    return reqs, ests, prios


def _pick_band(rng, cfg: TraceConfig) -> str:
    mix = np.asarray(cfg.band_mix, float)
    return BANDS[int(rng.choice(len(BANDS), p=mix / mix.sum()))]


def _undrained_node(rng, model: ClusterModel, st: "_GenState"):
    """A uniform-ish undrained node id WITHOUT building the O(N)
    undrained list; None after 8 drained draws (the caller skips the
    event — the generator's mix loop retries with another kind)."""
    n = model.nalloc.shape[0]
    for _ in range(8):
        node = int(rng.integers(0, n))
        if node not in st.drained:
            return node
    return None


class _GenState:
    """Generator-side occupancy bookkeeping (slots, gangs, drains)."""

    def __init__(self, cfg: TraceConfig, model: ClusterModel):
        gang_region = cfg.gangs * cfg.gang_min_member
        self.gang_slots = [
            list(range(g * cfg.gang_min_member,
                       (g + 1) * cfg.gang_min_member))
            for g in range(cfg.gangs)
        ]
        self.idle_gangs = set(range(cfg.gangs))
        self.active_gangs: Set[int] = set()
        self.free_singles = [
            s for s in range(gang_region, cfg.pod_slots)
            if not model.preq[s].any()
        ]
        self.active_singles = [
            s for s in range(gang_region, cfg.pod_slots)
            if model.preq[s].any()
        ]
        self.drained: Dict[int, List[int]] = {}


def _next_event(cfg: TraceConfig, rng, model: ClusterModel,
                st: _GenState) -> Optional[TraceEvent]:
    kinds = [k for k, _ in cfg.mix]
    weights = np.asarray([w for _, w in cfg.mix], float)
    kind = kinds[int(rng.choice(len(kinds), p=weights / weights.sum()))]

    if kind in ("gang_arrival", "gang_partial") and st.idle_gangs:
        g = sorted(st.idle_gangs)[int(rng.integers(0, len(st.idle_gangs)))]
        band = _pick_band(rng, cfg)
        slots = st.gang_slots[g]
        if kind == "gang_partial" and len(slots) > 1:
            # UNDER the minMember boundary: these members must WAIT_GANG
            # until the rest arrive (they never do in this trace — the
            # partial gang is released by the next departure draw)
            slots = slots[: int(rng.integers(1, len(slots)))]
        reqs, ests, prios = _pod_rows(rng, band, len(slots))
        st.idle_gangs.discard(g)
        st.active_gangs.add(g)
        return TraceEvent(kind, band, {
            "gang": g, "slots": [int(s) for s in slots],
            "requests": reqs, "estimated": ests, "priority": prios,
        })
    if kind == "pod_arrival" and st.free_singles:
        band = _pick_band(rng, cfg)
        n = min(len(st.free_singles), int(rng.integers(1, 5)))
        slots = [st.free_singles.pop(0) for _ in range(n)]
        st.active_singles.extend(slots)
        reqs, ests, prios = _pod_rows(rng, band, n)
        return TraceEvent(kind, band, {
            "slots": slots, "requests": reqs, "estimated": ests,
            "priority": prios,
        })
    if kind == "pod_departure":
        # departures free whole gangs first (all-or-nothing, matching
        # the arrival boundary), else a few singles
        if st.active_gangs and rng.random() < 0.4:
            g = sorted(st.active_gangs)[
                int(rng.integers(0, len(st.active_gangs)))
            ]
            slots = list(st.gang_slots[g])
            st.active_gangs.discard(g)
            st.idle_gangs.add(g)
        elif st.active_singles:
            n = min(len(st.active_singles), int(rng.integers(1, 4)))
            slots = [st.active_singles.pop(0) for _ in range(n)]
            st.free_singles.extend(slots)
        else:
            return None
        zero = [0] * R
        return TraceEvent(kind, INFRA_BAND, {
            "slots": [int(s) for s in slots],
            "requests": [zero] * len(slots),
            "estimated": [zero] * len(slots),
            "priority": [0] * len(slots),
        })
    if kind == "priority_churn" and st.active_singles:
        n = min(len(st.active_singles), int(rng.integers(1, 5)))
        picks = sorted(
            int(s) for s in rng.choice(st.active_singles, n, replace=False)
        )
        band = _pick_band(rng, cfg)
        prios = [
            _BAND_BASE_PRIORITY[band] + int(rng.integers(0, 900))
            for _ in picks
        ]
        return TraceEvent(kind, band, {"slots": picks, "priority": prios})
    if kind == "quota_wave":
        row = int(rng.integers(0, model.qrt.shape[0]))
        factor = float(rng.choice([0.5, 0.8, 1.25, 1.6]))
        runtime = np.maximum(
            (model.qrt[row].astype(float) * factor), 0
        ).astype(np.int64)
        used = (runtime.astype(float) * float(rng.uniform(0.0, 0.9))).astype(
            np.int64
        )
        return TraceEvent(kind, INFRA_BAND, {
            "rows": [row],
            "runtime": [[int(v) for v in runtime]],
            "used": [[int(v) for v in used]],
        })
    if kind == "node_drain":
        # rejection-sample instead of materializing the undrained list
        # (O(N) per event is minutes of generation at sparse-scale node
        # counts); a draw landing on a drained node 8 times in a row
        # just skips the event, which the mix loop already tolerates
        node = _undrained_node(rng, model, st)
        if node is None:
            return None
        st.drained[node] = [int(v) for v in model.nalloc[node]]
        return TraceEvent(kind, INFRA_BAND, {
            "node": int(node), "allocatable": [0] * R,
        })
    if kind == "node_restore" and st.drained:
        node = sorted(st.drained)[int(rng.integers(0, len(st.drained)))]
        row = st.drained.pop(node)
        return TraceEvent(kind, INFRA_BAND, {
            "node": int(node), "allocatable": row,
        })
    if kind == "node_resize":
        node = _undrained_node(rng, model, st)
        if node is None:
            return None
        factor = float(rng.choice([0.75, 1.25]))
        row = (model.nalloc[node].astype(float) * factor).astype(np.int64)
        row[_PODS] = model.nalloc[node][_PODS]  # pod slots don't scale
        return TraceEvent(kind, INFRA_BAND, {
            "node": int(node), "allocatable": [int(v) for v in row],
        })
    if kind == "throughput_update" and model.tput is not None:
        # one workload class's measured throughput moved (a profiling
        # round finished, a kernel regressed): concrete new row values,
        # normalized to [0, 100] like the wire contract
        row = int(rng.integers(0, model.tput.shape[0]))
        values = [
            int(v) for v in rng.integers(0, 101, model.tput.shape[1])
        ]
        return TraceEvent(kind, INFRA_BAND, {
            "rows": [row], "values": [values],
        })
    if kind == "sensitivity_drift" and model.sens is not None:
        # a few pods' CPU/mem sensitivity profiles re-estimated
        count = min(model.sens.shape[0], int(rng.integers(1, 5)))
        slots = sorted(
            int(s) for s in rng.choice(
                model.sens.shape[0], count, replace=False
            )
        )
        profiles = []
        for _ in slots:
            prof = [0] * R
            prof[_CPU] = int(rng.integers(0, 101))
            prof[_MEM] = int(rng.integers(0, 101))
            profiles.append(prof)
        return TraceEvent(kind, INFRA_BAND, {
            "slots": slots, "profiles": profiles,
        })
    if kind == "usage_tick":
        # capped at 256 rows: an uncapped N/4 tick at sparse-scale node
        # counts would put hundreds of thousands of rows in ONE event
        # payload (and its JSON line) — a usage tick is a churn sample,
        # not a full-cluster rescan
        count = max(1, min(model.nuse.shape[0] // 4, 256))
        nodes = sorted(
            int(n) for n in rng.choice(
                model.nuse.shape[0], count, replace=False
            )
        )
        usage, fresh = [], []
        for n in nodes:
            target = model.nalloc[n].astype(float) * rng.uniform(0.05, 0.7)
            drifted = (
                model.nuse[n].astype(float) * 0.5 + target * 0.5
            ).astype(np.int64)
            usage.append([int(v) for v in drifted])
            # the occasional stale koordlet: LoadAware's freshness gate
            fresh.append(bool(rng.random() > 0.05))
        return TraceEvent(kind, INFRA_BAND, {
            "nodes": nodes, "usage": usage, "fresh": fresh,
        })
    return None


def _build_init(cfg: TraceConfig, rng) -> Dict[str, object]:
    N, P, Q, G = cfg.nodes, cfg.pod_slots, cfg.tenants, cfg.gangs
    # vectorized over the node axis (a per-node python loop
    # makes sparse-scale node counts — the whole point of the knob —
    # take minutes before the first event is even drawn)
    nalloc = np.zeros((N, R), np.int64)
    nreq = np.zeros((N, R), np.int64)
    nuse = np.zeros((N, R), np.int64)
    cpu = rng.choice(np.asarray([16000, 32000, 64000], np.int64), size=N)
    mem = (cpu // 1000) * 4 * 1024  # MiB axis
    nalloc[:, _CPU], nalloc[:, _MEM], nalloc[:, _PODS] = cpu, mem, 256
    nreq[:, _CPU] = (cpu * rng.uniform(0.02, 0.3, N)).astype(np.int64)
    nreq[:, _MEM] = (mem * rng.uniform(0.02, 0.3, N)).astype(np.int64)
    nuse[:, _CPU] = (cpu * rng.uniform(0.05, 0.5, N)).astype(np.int64)
    nuse[:, _MEM] = (mem * rng.uniform(0.05, 0.5, N)).astype(np.int64)
    if cfg.open_nodes > 0:
        # sparse-feasibility regime (see TraceConfig.open_nodes): close
        # every node but the chosen few — free cpu below the 250m
        # minimum ask, free mem below the 256 MiB minimum
        closed = np.ones(N, bool)
        closed[rng.choice(N, size=min(cfg.open_nodes, N),
                          replace=False)] = False
        nreq[closed, _CPU] = nalloc[closed, _CPU] - 100
        nreq[closed, _MEM] = nalloc[closed, _MEM] - 128
    fresh = [True] * N

    gang_region = G * cfg.gang_min_member
    if gang_region >= P:
        raise ValueError(
            f"pod_slots={P} must exceed gangs*gang_min_member="
            f"{gang_region}"
        )
    preq = np.zeros((P, R), np.int64)
    pest = np.zeros((P, R), np.int64)
    priority = [0] * P
    gang_id = [-1] * P
    for g in range(G):
        for s in range(g * cfg.gang_min_member, (g + 1) * cfg.gang_min_member):
            gang_id[s] = g
    quota_id = [s % Q for s in range(P)]
    # ~40% of the single slots start occupied so departures have
    # something to drain from step one; in the sparse regime EVERY
    # slot is occupied instead — an empty (zero-request) slot is
    # feasible on all N nodes, which the sparse engine refuses at
    # C < N (pair open_nodes with SPARSE_MIX and gangs=0)
    for s in range(gang_region, P):
        if cfg.open_nodes > 0 or rng.random() < 0.4:
            band = _pick_band(rng, cfg)
            reqs, ests, prios = _pod_rows(rng, band, 1)
            preq[s], pest[s], priority[s] = reqs[0], ests[0], prios[0]

    total_cpu = int(nalloc[:, _CPU].sum())
    total_mem = int(nalloc[:, _MEM].sum())
    qrt = np.zeros((Q, R), np.int64)
    quse = np.zeros((Q, R), np.int64)
    qlim = np.zeros((Q, R), np.int64)
    for t in range(Q):
        qrt[t, _CPU] = total_cpu * 6 // 10 // Q
        qrt[t, _MEM] = total_mem * 6 // 10 // Q
        qlim[t, _CPU] = qlim[t, _MEM] = 1
    # tensor keys stay numpy (see _jsonable_init: sparse-scale node
    # counts make .tolist() the bottleneck); ClusterModel np.asarray's
    # either representation, so imported JSON traces replay unchanged
    init = {
        "nalloc": nalloc, "nreq": nreq,
        "nuse": nuse, "fresh": fresh,
        "preq": preq, "pest": pest,
        "priority": priority, "gang_id": gang_id, "quota_id": quota_id,
        "gang_min": [cfg.gang_min_member] * G,
        "qrt": qrt, "quse": quse, "qlim": qlim,
    }
    if cfg.accel_types > 0 and cfg.workload_classes > 0:
        # fused-term state: heterogeneous accelerator fleet,
        # per-pod workload classes + sensitivity profiles, and the
        # [C, A] throughput matrix — all concrete, digest-pinned like
        # every other init key
        A_, C_ = cfg.accel_types, cfg.workload_classes
        init["accel"] = [int(rng.integers(0, A_)) for _ in range(N)]
        init["wclass"] = [int(rng.integers(0, C_)) for _ in range(P)]
        sens = np.zeros((P, R), np.int64)
        sens[:, _CPU] = rng.integers(0, 101, P)
        sens[:, _MEM] = rng.integers(0, 101, P)
        init["sens"] = sens.tolist()
        init["tput"] = rng.integers(0, 101, (C_, A_)).astype(
            np.int64
        ).tolist()
    return init


def generate_trace(cfg: TraceConfig) -> Trace:
    """Deterministic per ``cfg.seed``: the generator advances its own
    :class:`ClusterModel` so every payload is concrete, then the model
    is thrown away — replay re-derives it from ``init``."""
    rng = np.random.default_rng(cfg.seed)
    init = _build_init(cfg, rng)
    model = ClusterModel(init)
    st = _GenState(cfg, model)
    events: List[TraceEvent] = []
    guard = 0
    while len(events) < cfg.events and guard < cfg.events * 20:
        guard += 1
        ev = _next_event(cfg, rng, model, st)
        if ev is None:
            continue  # mix drew a kind with nothing to act on
        model.apply(ev)
        events.append(ev)
    return Trace(config=cfg, init=init, events=tuple(events))


# ---- replay ----

# the serialized oracle: one request in the device section at a time, no
# memos, no incremental engine — the reference execution the full engine
# must match byte for byte
ORACLE_KW = dict(
    coalesce_max_batch=1,
    coalesce_window_ms=0.0,
    pipeline_depth=1,
    score_memo=False,
    score_incr=False,
)

TRANSPORTS = ("grpc", "raw")


@contextlib.contextmanager
def slow_stage(servicer, ms: float):
    """Inject an artificial slow stage into a servicer's coalesced launch
    path (the SLO gate's own regression fixture): every Score launch pays
    ``ms`` of extra wall before touching the device.  Replies stay
    bit-exact — only the latency distribution moves, which is exactly what
    the gate must catch."""
    dispatch = servicer.dispatch
    real = dispatch._launch_batch
    delay_s = float(ms) / 1000.0

    def slowed(batch):
        time.sleep(delay_s)
        return real(batch)

    dispatch._launch_batch = slowed
    try:
        yield
    finally:
        dispatch._launch_batch = real


@dataclasses.dataclass
class TraceReport:
    """Outcome of one measured replay.  ``registry`` is the engine
    servicer's metrics registry — the ``koord_scorer_trace_cycle_ms``
    observations the SLO gate judges live there.  ``retraces`` counts the
    kernel demotions and ``builds`` the kernel builds or loads of the
    measured pass (``analysis/retrace_guard.py``).  ``cold_ms``: the
    engine's cold step (full Sync, Score, Assign) by RPC, which the
    histogram leaves out."""

    trace: Trace
    events_replayed: int
    parity_checks: int
    retraces: int
    wall_ms: float
    registry: object
    timeline: List[Dict[str, object]]
    config_doc: Dict[str, object]
    builds: int = 0
    cold_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def timeline_document(self) -> Dict[str, object]:
        """The per-replay timeline in the flight-recorder dump format
        (``obs.validate_flight_dump`` is the schema)."""
        return {
            "version": 1,
            "reason": "trace-replay",
            "dumped_at_unix": time.time(),
            "config": dict(self.config_doc),
            "dropped_cycles": 0,
            "cycles": list(self.timeline),
        }

    def quantile(self, q: float, band: Optional[str] = None,
                 rpc: str = "cycle") -> Optional[float]:
        from koordinator_tpu_torch.obs import slo as slo_mod
        from koordinator_tpu_torch.obs.scorer_metrics import TRACE_CYCLE

        labels = {"rpc": rpc}
        if band is not None:
            labels["band"] = band
        return slo_mod.histogram_quantile(
            self.registry, TRACE_CYCLE, q, labels
        )


def default_slo_specs(
    bands: Sequence[str],
    cycle_p99_ms: Optional[float] = None,
    rpc_p99_ms: Optional[float] = None,
) -> List:
    """The declarative gate: p99 whole-step latency per band, plus per-RPC
    p99 across all bands.  Thresholds default from
    ``KOORD_TRACE_SLO_P99_MS`` / ``KOORD_TRACE_SLO_RPC_P99_MS`` (2,500 ms,
    the reference's default: the gate's job is catching regressions, not
    flaking on a busy host)."""
    from koordinator_tpu_torch.obs.scorer_metrics import TRACE_CYCLE
    from koordinator_tpu_torch.obs.slo import SloSpec

    # `or`: empty env value means unset (the KOORD_* convention)
    if cycle_p99_ms is None:
        cycle_p99_ms = float(
            os.environ.get("KOORD_TRACE_SLO_P99_MS") or "2500"
        )
    if rpc_p99_ms is None:
        rpc_p99_ms = float(
            os.environ.get("KOORD_TRACE_SLO_RPC_P99_MS") or cycle_p99_ms
        )
    specs = [
        SloSpec(
            name=f"{band}-cycle-p99",
            family=TRACE_CYCLE,
            quantile=0.99,
            threshold_ms=float(cycle_p99_ms),
            labels={"band": band, "rpc": "cycle"},
        )
        for band in bands
    ]
    specs.extend(
        SloSpec(
            name=f"{rpc}-p99",
            family=TRACE_CYCLE,
            quantile=0.99,
            threshold_ms=float(rpc_p99_ms),
            labels={"rpc": rpc},
        )
        for rpc in ("sync", "score", "assign")
    )
    return specs


class TraceReplay:
    """Replay one trace through engine + serial oracle over real unix
    sockets.  ``run()`` performs an untimed warm-up pass over the identical
    stream first (building every kernel the trace reaches), then the
    measured pass under the retrace guard.

    ``slow_score_ms`` injects the artificial slow stage into the ENGINE's
    launch path during the measured pass (see :func:`slow_stage`)."""

    def __init__(
        self,
        trace: Trace,
        engine_kw: Optional[dict] = None,
        oracle_kw: Optional[dict] = None,
        slow_score_ms: float = 0.0,
        retrace_budget: int = 0,
        warmup: bool = True,
        trace_export: Optional[str] = None,
        oracle: bool = True,
        device=None,
        transport: str = "grpc",
    ):
        """``trace_export``: directory the ENGINE side — servicer and
        client both — exports its distributed-trace spans to during the
        measured pass; the oracle stays untraced (its replies are the
        parity baseline, not part of the request tree).  The warm-up pass
        is untraced either way.

        ``oracle=False`` drops the serial-oracle servicer: ``parity_checks``
        stays 0 and only the engine replays.

        ``device``: where both servicers keep their resident snapshots
        (default CUDA, raising when absent; ``"cpu"`` runs the plain
        path).  ``transport``: ``"grpc"`` serves each servicer through
        ``make_server`` on ``unix://`` (needs the ``grpc`` package);
        ``"raw"`` through ``RawUdsServer`` on ``raw://``, the Go plugin's
        framing, which needs no gRPC."""
        if transport not in TRANSPORTS:
            raise ValueError(
                f"transport must be one of {TRANSPORTS}, got {transport!r}"
            )
        from koordinator_tpu_torch import resolve_device

        self.trace = trace
        self.device = resolve_device(device)
        self.transport = transport
        self.engine_kw = dict(engine_kw or {})
        self.oracle_kw = dict(oracle_kw or ORACLE_KW)
        # the oracle must score under the ENGINE's CycleConfig (fused
        # scoring terms included) or a term-enabled replay fails parity by
        # construction; an explicit oracle_kw cfg wins
        if "cfg" in self.engine_kw and "cfg" not in self.oracle_kw:
            self.oracle_kw["cfg"] = self.engine_kw["cfg"]
        self.slow_score_ms = float(slow_score_ms)
        self.retrace_budget = int(retrace_budget)
        self.warmup = bool(warmup)
        self.trace_export = trace_export
        self.oracle = bool(oracle)

    def run(self) -> TraceReport:
        from koordinator_tpu_torch.analysis.retrace_guard import retrace_guard

        if self.warmup:
            self._replay_once(record=False)
        t0 = time.perf_counter()
        with retrace_guard(budget=self.retrace_budget) as counter:
            report = self._replay_once(record=True)
        report.wall_ms = (time.perf_counter() - t0) * 1000.0
        report.retraces = counter.traces
        report.builds = counter.compiles
        return report

    # -- one full pass --
    def _serve(self, sv, sock: str):
        """Start ``sv`` on the socket ``sock``: (client target, stop)."""
        if self.transport == "raw":
            from koordinator_tpu_torch.bridge.client import RAW_SCHEME
            from koordinator_tpu_torch.bridge.udsserver import RawUdsServer

            server = RawUdsServer(sock, servicer=sv).start()
            return RAW_SCHEME + sock, server.stop
        from koordinator_tpu_torch.bridge.server import make_server

        server = make_server(servicer=sv)
        server.add_insecure_port(f"unix://{sock}")
        server.start()
        return f"unix://{sock}", lambda: server.stop(0)

    def _replay_once(self, record: bool) -> Optional[TraceReport]:
        from koordinator_tpu_torch.bridge.client import ScorerClient
        from koordinator_tpu_torch.bridge.server import ScorerServicer

        # tracing only on the MEASURED pass (the warm-up stays untraced so
        # export files hold exactly the replayed stream's spans)
        export = self.trace_export if record else None
        engine_kw = dict(self.engine_kw, device=self.device)
        engine_kw["trace_export"] = export if export else False
        oracle_kw = dict(self.oracle_kw, device=self.device)
        oracle_kw.setdefault("trace_export", False)
        with tempfile.TemporaryDirectory(prefix="koord-trace-") as tmp:
            engine_sv = ScorerServicer(**engine_kw)
            sides = [("engine", engine_sv)]
            if self.oracle:
                sides.append(("oracle", ScorerServicer(**oracle_kw)))
            stops, clients = [], []
            try:
                for name, sv in sides:
                    target, stop = self._serve(
                        sv, os.path.join(tmp, f"{name}.sock")
                    )
                    stops.append(stop)
                    clients.append(ScorerClient(
                        target,
                        # False forces tracing OFF (env included) on the
                        # oracle and on untraced passes — the export dir
                        # must hold exactly the measured engine stream's
                        # spans
                        trace_export=(
                            export if name == "engine" and export
                            else False
                        ),
                    ))
                return self._drive(
                    engine_sv, clients[0],
                    clients[1] if self.oracle else None,
                    record=record,
                )
            finally:
                for client in clients:
                    client.close()
                for stop in stops:
                    stop()
                # close() drains each side's span writer and unhooks the
                # process-wide feeds: the caller assembles the export
                # directory right after run(), and a replay must not leak
                # a writer thread per pass
                for _name, sv in sides:
                    sv.telemetry.close()


    def _drive(self, engine_sv, engine, oracle,
               record: bool) -> Optional[TraceReport]:
        trace = self.trace
        model = ClusterModel(trace.init)
        metrics = engine_sv.telemetry.metrics
        timeline: List[Dict[str, object]] = []
        parity_checks = 0
        tdig = trace.digest()[:8]

        # first Sync ships the whole cluster (names stay empty — the
        # replies are index-based, like the Go shim's)
        full_kw = dict(
            node_allocatable=model.nalloc,
            node_requested=model.nreq,
            node_usage=model.nuse,
            metric_fresh=list(model.fresh),
            pod_requests=model.preq,
            pod_estimated=model.pest,
            priority=list(model.priority),
            gang_id=list(model.gang_id),
            quota_id=list(model.quota_id),
            gang_min_member=list(model.gang_min),
            quota_runtime=model.qrt,
            quota_used=model.quse,
            quota_limited=model.qlim,
        )
        if model.tput is not None:
            full_kw.update(
                node_accel_type=list(model.accel),
                workload_class=list(model.wclass),
                pod_sensitivity=model.sens,
                throughput=model.tput,
            )
        k = trace.config.top_k
        t0 = time.perf_counter()
        engine.sync(**full_kw)
        t_sync = time.perf_counter()
        if oracle is not None:
            oracle.sync(**full_kw)
        # cold Score/Assign: builds the kernels in the warm-up pass; in
        # the measured pass both find them loaded
        t_score = time.perf_counter()
        e_score = engine.score_flat(top_k=k)
        t_assign = time.perf_counter()
        e_assign = engine.assign()
        t_end = time.perf_counter()
        cold_ms = {"sync": (t_sync - t0) * 1000.0,
                   "score": (t_assign - t_score) * 1000.0,
                   "assign": (t_end - t_assign) * 1000.0}
        d_e = self._digest(e_score, e_assign)
        if oracle is not None:
            d_o = self._digest(oracle.score_flat(top_k=k), oracle.assign())
            parity_checks += 1
            if d_e != d_o:
                raise TraceParityError(
                    "cold step: engine reply digest diverged from the "
                    "serial oracle"
                )

        maybe_slow = (
            slow_stage(engine_sv, self.slow_score_ms)
            if record and self.slow_score_ms > 0
            else contextlib.nullcontext()
        )
        with maybe_slow:
            for i, event in enumerate(trace.events):
                changed = model.apply(event)
                kw = self._sync_kwargs(model, changed)
                started = time.time()
                # the ENGINE's step is timed end to end with nothing
                # else interleaved; the oracle replays the same step
                # afterwards, off the clock
                t0 = time.perf_counter()
                engine.sync(**kw)
                t_sync = time.perf_counter()
                e_score = engine.score_flat(top_k=k)
                t_score = time.perf_counter()
                e_assign = engine.assign()
                t_assign = time.perf_counter()
                if oracle is not None:
                    oracle.sync(**kw)
                    digest_e = self._digest(e_score, e_assign)
                    digest_o = self._digest(
                        oracle.score_flat(top_k=k), oracle.assign()
                    )
                    parity_checks += 1
                    if digest_e != digest_o:
                        raise TraceParityError(
                            f"step {i} ({event.kind}, band {event.band}): "
                            f"engine reply digest {digest_e[:16]} != "
                            f"serial oracle {digest_o[:16]}"
                        )
                if not record:
                    continue
                sync_ms = (t_sync - t0) * 1000.0
                score_ms = (t_score - t_sync) * 1000.0
                assign_ms = (t_assign - t_score) * 1000.0
                cycle_ms = sync_ms + score_ms + assign_ms
                for rpc, ms in (("sync", sync_ms), ("score", score_ms),
                                ("assign", assign_ms),
                                ("cycle", cycle_ms)):
                    metrics.observe_trace_cycle(event.band, rpc, ms)
                timeline.append({
                    "cycle_id": f"t{tdig}-{i}",
                    "snapshot_id": engine.snapshot_id,
                    "started_unix": started,
                    "spans": [
                        {"name": "sync", "start_ms": 0.0,
                         "dur_ms": round(sync_ms, 3)},
                        {"name": "score", "start_ms": round(sync_ms, 3),
                         "dur_ms": round(score_ms, 3)},
                        {"name": "assign",
                         "start_ms": round(sync_ms + score_ms, 3),
                         "dur_ms": round(assign_ms, 3)},
                    ],
                    "notes": {
                        "event": event.kind,
                        "band": event.band,
                        "latency_ms": round(cycle_ms, 3),
                        "parity": "ok",
                    },
                    "error": None,
                })
        if not record:
            return None
        return TraceReport(
            trace=trace,
            events_replayed=len(trace.events),
            parity_checks=parity_checks,
            retraces=0,  # filled by run() from the guard
            wall_ms=0.0,
            registry=metrics.registry,
            timeline=timeline,
            cold_ms=cold_ms,
            config_doc={
                "trace_digest": trace.digest(),
                "seed": trace.config.seed,
                "nodes": trace.config.nodes,
                "pod_slots": trace.config.pod_slots,
                "events": len(trace.events),
            },
        )

    @staticmethod
    def _sync_kwargs(model: ClusterModel, changed: Set[str]) -> dict:
        kw: Dict[str, object] = {}
        if "nalloc" in changed:
            kw["node_allocatable"] = model.nalloc
        if "nuse" in changed:
            kw["node_usage"] = model.nuse
        if "fresh" in changed:
            kw["metric_fresh"] = list(model.fresh)
        if "preq" in changed:
            kw["pod_requests"] = model.preq
        if "pest" in changed:
            kw["pod_estimated"] = model.pest
        if "priority" in changed:
            kw["priority"] = list(model.priority)
        if "qrt" in changed:
            kw["quota_runtime"] = model.qrt
        if "quse" in changed:
            kw["quota_used"] = model.quse
        if "tput" in changed:
            kw["throughput"] = model.tput
        if "sens" in changed:
            kw["pod_sensitivity"] = model.sens
        return kw

    @staticmethod
    def _digest(score_flat, assign) -> str:
        h = hashlib.sha256()
        for arr in score_flat:
            h.update(np.ascontiguousarray(arr).tobytes())
        assignment, status, _ms, path = assign
        h.update(np.ascontiguousarray(assignment).tobytes())
        h.update(np.ascontiguousarray(status).tobytes())
        h.update(path.encode())
        return h.hexdigest()
