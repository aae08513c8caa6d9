"""Scorer metric families over the koordlet Prometheus-text registry.

One place declares every family the bridge daemon exports on /metrics
(koordlet/metrics.py renders the exposition text; the registration is
idempotent, so a restarted daemon re-registering is a no-op).  Families:

====================================== ========= ==========================
family                                 kind      labels
====================================== ========= ==========================
koord_scorer_cycle_latency_ms          histogram path, wave
koord_scorer_cycle_rounds              gauge     path
koord_scorer_rounds_total              counter   path
koord_scorer_cycles_total              counter   path
koord_scorer_cycle_errors_total        counter   stage
koord_scorer_sync_total                counter   kind (delta|full|mixed|scalar)
koord_scorer_sync_tensors_total        counter   kind (delta|full)
koord_scorer_snapshot_generation       gauge     —
koord_scorer_resident_epoch            gauge     epoch (value always 1)
koord_scorer_resident_warm             gauge     — (last Sync: 1 warm/0 cold)
koord_scorer_kernel_demotions_total    counter   —
koord_scorer_uds_frames_total          counter   method
koord_scorer_uds_malformed_total       counter   reason
koord_scorer_uds_errors_total          counter   —
koord_scorer_coalesce_queue_delay_ms   histogram —
koord_scorer_coalesce_batch_occupancy  histogram —
koord_scorer_coalesce_batches_total    counter   —
koord_scorer_coalesce_requests_total   counter   —
koord_scorer_coalesce_window_ms        gauge     —
koord_scorer_coalesce_device_idle_ms   gauge     — (cumulative)
koord_scorer_assign_memo_total         counter   result (hit|miss)
koord_scorer_score_memo_total          counter   result (hit|miss)
koord_scorer_score_incr_total          counter   result (incr|full|fallback)
koord_scorer_incr_cols                 histogram —
koord_scorer_term_total                counter   term (heterogeneity|sensitivity|packing)
koord_scorer_shed_total                counter   method (score|assign)
koord_scorer_shed_band_total           counter   band (koord-prod|mid|batch|free|none)
koord_scorer_deadline_expired_total    counter   stage (queue|gather)
koord_scorer_degraded_total            counter   rpc (score)
koord_scorer_breaker_state             gauge     state (closed|half-open|open)
koord_scorer_breaker_transitions_total counter   to (closed|half-open|open)
koord_scorer_breaker_rejected_total    counter   method (score|assign)
koord_scorer_replica_role              gauge     role (leader|follower)
koord_scorer_replica_frames_total      counter   result (applied|stale|resync|error)
koord_scorer_replica_lag_ms            gauge     —
koord_scorer_replica_resyncs_total     counter   reason (gap|epoch|decode|apply|connect)
koord_scorer_replica_followers         gauge     — (leader: live subscribers)
koord_scorer_journal_frames_total      counter   op (append|replay|compact|truncate)
koord_scorer_journal_append_us         histogram —
koord_scorer_journal_position          gauge     — (last journaled generation)
koord_scorer_journal_bytes             gauge     — (journal file size)
koord_scorer_journal_compaction_stamp  gauge     — (us since epoch, last compaction)
koord_scorer_failover_total            counter   event (promoted|warm_restart)
koord_scorer_retry_total               counter   op (subscribe|resume)
koord_scorer_trace_cycle_ms            histogram band, rpc
koord_scorer_trace_spans_total         counter   kind (client|server|internal|consumer)
koord_scorer_trace_export_dropped_total counter  reason (closed|rate|bytes|encode|io)
koord_scorer_candidate_refresh_total   counter   reason (dirty|stale|cold)
koord_scorer_candidate_width           gauge     — (configured C; 0 = dense)
koord_scorer_lock_witness_edges_total  counter   result (observed|inversion)
koord_scorer_relay_position            gauge     — (hops from the root leader)
koord_scorer_relay_forwarded_total     counter   — (frames re-published)
koord_scorer_replica_hop_lag_ms        gauge     hop
koord_scorer_repl_send_batch_frames    histogram —
koord_scorer_repl_compress_total       counter   op (encode|decode)
koord_scorer_autoscale_events_total    counter   action (scale_up|scale_down)
koord_scorer_autoscale_replicas        gauge     — (autoscaler's target size)
koord_scorer_devprof_compiles_total    counter   boundary, backend
koord_scorer_devprof_compile_ms_total  counter   boundary, backend
koord_scorer_devprof_device_us         histogram boundary
koord_scorer_devprof_retrace_total     counter   boundary
koord_scorer_prewarm_signatures_total  counter   result (compiled|skipped|failed)
koord_scorer_prewarm_compile_ms_total  counter   —
koord_scorer_prewarm_pending           gauge     —
====================================== ========= ==========================

The ``koord_scorer_coalesce_*`` families observe the coalescing
dispatch engine: how long a Score
request waited in the gather queue before its batch launched, and how
many requests shared each device launch — occupancy near 1 under heavy
concurrency means the engine is not batching (gather window too small,
or the clients are actually serial).  The pipelined engine adds
the current adaptive gather window (``_window_ms``; moves with the
observed inter-arrival EWMA, clamped) and the cumulative wall time the
device sat idle while work was queued (``_device_idle_ms``; the
double-buffered pipeline exists to hold this near zero — watch its
RATE, a flat line is a saturated pipeline).  ``assign_memo_total``
counts Assign RPCs served from the (snapshot id, CycleConfig) result
memo vs. those that ran a device cycle; ``score_memo_total`` is the
Score-side twin — requests served as sliced
prefixes of a memoized padded top-k readback vs. those that launched.

The ``koord_scorer_shed_total`` and ``koord_scorer_replica_*`` families
observe the replicated serving tier.  ``shed_total`` counts
read RPCs the admission gate refused with RESOURCE_EXHAUSTED (its RATE
under load is the overload signal; zero under the configured depth).
On a follower, ``replica_frames_total`` partitions every replication
frame by outcome (``applied`` extends the chain; ``stale`` is a
duplicate/late frame a reordering transport re-delivered — dropped,
not applied; ``resync`` detected a discontinuity; ``error`` failed
frame decode), ``replica_lag_ms`` is the last applied frame's
commit-to-apply wall delay against the leader's stamp, and
``replica_resyncs_total`` says WHY each one-shot full resync ran — a
growing ``gap`` rate means the transport (or a slow follower's dropped
subscription) is lossy.  On the leader, ``replica_followers`` gauges
live subscriptions.

The port compiles no programs at run time, so it has no jit cache-miss
family: its kernel builds and loads are the ``devprof`` families'.
"""

from __future__ import annotations

from typing import Mapping, Optional

from koordinator_tpu_torch.koordlet.metrics import DEFAULT_BUCKETS_MS, MetricsRegistry

CYCLE_LATENCY = "koord_scorer_cycle_latency_ms"
CYCLE_ROUNDS = "koord_scorer_cycle_rounds"
ROUNDS_TOTAL = "koord_scorer_rounds_total"
CYCLES_TOTAL = "koord_scorer_cycles_total"
CYCLE_ERRORS = "koord_scorer_cycle_errors_total"
SYNC_TOTAL = "koord_scorer_sync_total"
SYNC_TENSORS = "koord_scorer_sync_tensors_total"
SNAPSHOT_GENERATION = "koord_scorer_snapshot_generation"
RESIDENT_EPOCH = "koord_scorer_resident_epoch"
RESIDENT_WARM = "koord_scorer_resident_warm"
DEMOTIONS_TOTAL = "koord_scorer_kernel_demotions_total"
UDS_FRAMES = "koord_scorer_uds_frames_total"
UDS_MALFORMED = "koord_scorer_uds_malformed_total"
UDS_ERRORS = "koord_scorer_uds_errors_total"
COALESCE_QUEUE_DELAY = "koord_scorer_coalesce_queue_delay_ms"
COALESCE_OCCUPANCY = "koord_scorer_coalesce_batch_occupancy"
COALESCE_BATCHES = "koord_scorer_coalesce_batches_total"
COALESCE_REQUESTS = "koord_scorer_coalesce_requests_total"
COALESCE_WINDOW = "koord_scorer_coalesce_window_ms"
COALESCE_DEVICE_IDLE = "koord_scorer_coalesce_device_idle_ms"
ASSIGN_MEMO = "koord_scorer_assign_memo_total"
SCORE_MEMO = "koord_scorer_score_memo_total"
SCORE_INCR = "koord_scorer_score_incr_total"
INCR_COLS = "koord_scorer_incr_cols"
TERM_TOTAL = "koord_scorer_term_total"
SHED_TOTAL = "koord_scorer_shed_total"
SHED_BAND = "koord_scorer_shed_band_total"
DEADLINE_EXPIRED = "koord_scorer_deadline_expired_total"
DEGRADED_TOTAL = "koord_scorer_degraded_total"
BREAKER_STATE = "koord_scorer_breaker_state"
BREAKER_TRANSITIONS = "koord_scorer_breaker_transitions_total"
BREAKER_REJECTED = "koord_scorer_breaker_rejected_total"
REPLICA_ROLE = "koord_scorer_replica_role"
REPLICA_FRAMES = "koord_scorer_replica_frames_total"
REPLICA_LAG = "koord_scorer_replica_lag_ms"
REPLICA_RESYNCS = "koord_scorer_replica_resyncs_total"
REPLICA_FOLLOWERS = "koord_scorer_replica_followers"
JOURNAL_FRAMES = "koord_scorer_journal_frames_total"
JOURNAL_APPEND_US = "koord_scorer_journal_append_us"
JOURNAL_POSITION = "koord_scorer_journal_position"
JOURNAL_BYTES = "koord_scorer_journal_bytes"
JOURNAL_COMPACTION_STAMP = "koord_scorer_journal_compaction_stamp"
FAILOVER_TOTAL = "koord_scorer_failover_total"
RETRY_TOTAL = "koord_scorer_retry_total"
TRACE_CYCLE = "koord_scorer_trace_cycle_ms"
TRACE_SPANS = "koord_scorer_trace_spans_total"
TRACE_EXPORT_DROPPED = "koord_scorer_trace_export_dropped_total"
CANDIDATE_REFRESH = "koord_scorer_candidate_refresh_total"
CANDIDATE_WIDTH = "koord_scorer_candidate_width"
LOCK_WITNESS_EDGES = "koord_scorer_lock_witness_edges_total"
RELAY_POSITION = "koord_scorer_relay_position"
RELAY_FORWARDED = "koord_scorer_relay_forwarded_total"
REPLICA_HOP_LAG = "koord_scorer_replica_hop_lag_ms"
SEND_BATCH_FRAMES = "koord_scorer_repl_send_batch_frames"
REPL_COMPRESS = "koord_scorer_repl_compress_total"
AUTOSCALE_EVENTS = "koord_scorer_autoscale_events_total"
AUTOSCALE_REPLICAS = "koord_scorer_autoscale_replicas"
DEVPROF_COMPILES = "koord_scorer_devprof_compiles_total"
DEVPROF_COMPILE_MS = "koord_scorer_devprof_compile_ms_total"
DEVPROF_DEVICE_US = "koord_scorer_devprof_device_us"
DEVPROF_RETRACE = "koord_scorer_devprof_retrace_total"
PREWARM_SIGNATURES = "koord_scorer_prewarm_signatures_total"
PREWARM_COMPILE_MS = "koord_scorer_prewarm_compile_ms_total"
PREWARM_PENDING = "koord_scorer_prewarm_pending"

# occupancy is a count-of-requests-per-launch, not a latency: its own
# power-of-two buckets (the dispatcher caps batches at 16 by default;
# 32/64 leave headroom for tuned deployments)
_OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, float("inf"))

# dirty-column counts per incremental Score launch: power-of-two-ish
# buckets matching the delta scatter's pad buckets (0 = a row-only or
# quota-only delta stream rescored no columns at all)
_INCR_COLS_BUCKETS = (
    1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, float("inf"),
)

_FAMILIES = (
    (CYCLE_LATENCY, "histogram",
     "end-to-end Assign/Score cycle latency on the bridge, by device "
     "path and wave width"),
    (CYCLE_ROUNDS, "gauge",
     "sequential device rounds of the last wave-batched cycle (~P/wave "
     "certified-prefix rounds vs P per-pod steps)"),
    (ROUNDS_TOTAL, "counter", "cumulative wave-cycle rounds, by path"),
    (CYCLES_TOTAL, "counter", "completed scoring cycles, by device path"),
    (CYCLE_ERRORS, "counter", "cycles that raised, by pipeline stage"),
    (SYNC_TOTAL, "counter",
     "Sync frames by how their tensors rode the wire (delta/full/mixed)"),
    (SYNC_TENSORS, "counter", "synced tensors by encoding (delta/full)"),
    (SNAPSHOT_GENERATION, "gauge",
     "generation of the resident snapshot (the <gen> of s<epoch>-<gen>)"),
    (RESIDENT_EPOCH, "gauge",
     "per-boot epoch of the resident snapshot as a label; value is "
     "always 1"),
    (RESIDENT_WARM, "gauge",
     "1 when the last Sync landed on the resident device tensors "
     "(warm), 0 when it dropped residency (cold)"),
    (DEMOTIONS_TOTAL, "counter",
     "cycle kernel shape-bucket demotions to the next rung"),
    (UDS_FRAMES, "counter", "raw-UDS request frames served, by method"),
    (UDS_MALFORMED, "counter",
     "malformed raw-UDS frames (oversized, unknown method, truncated "
     "mid-frame), by reason"),
    (UDS_ERRORS, "counter", "raw-UDS requests answered with an error frame"),
    (COALESCE_QUEUE_DELAY, "histogram",
     "time a Score request waited in the coalescer's gather queue "
     "before its batch launched"),
    (COALESCE_OCCUPANCY, "histogram",
     "Score requests sharing one coalesced device launch"),
    (COALESCE_BATCHES, "counter", "coalesced Score launches"),
    (COALESCE_REQUESTS, "counter",
     "Score requests served through the coalescer (requests/batches = "
     "mean occupancy)"),
    (COALESCE_WINDOW, "gauge",
     "current adaptive gather window (EWMA of inter-arrival gaps, "
     "clamped; 0 = launch immediately)"),
    (COALESCE_DEVICE_IDLE, "gauge",
     "cumulative wall time the device sat idle with work queued; the "
     "pipelined dispatcher holds the rate near zero"),
    (ASSIGN_MEMO, "counter",
     "Assign RPCs served from the (snapshot, config) result memo (hit) "
     "vs. ran a device cycle (miss)"),
    (SCORE_MEMO, "counter",
     "Score requests served as sliced prefixes of the memoized "
     "(snapshot, config, k-bucket) top-k readback (hit) vs. launched "
     "a device batch (miss)"),
    (SCORE_INCR, "counter",
     "Score launches by engine outcome: incr rescored only the dirty "
     "columns/rows of the resident score tensor, full had no resident "
     "tensor to advance (cold/first score), fallback had one but full-"
     "rescored (dirty ratio past --score-incr-max-ratio, or an "
     "incremental-launch failure)"),
    (INCR_COLS, "histogram",
     "dirty node columns recomputed per incremental Score launch "
     "(O(P x d) of the O(P x N) a full rescore pays)"),
    (TERM_TOTAL, "counter",
     "fused scoring-term activations by term name, one per device "
     "Score launch with the term enabled"),
    (SHED_TOTAL, "counter",
     "read RPCs the admission gate refused with RESOURCE_EXHAUSTED "
     "(queue depth at the band's rung of --max-inflight), by method; "
     "in-flight work completes untouched"),
    (SHED_BAND, "counter",
     "admission sheds by priority band; under an "
     "overload storm the free/batch rates climb while prod stays ~0"),
    (DEADLINE_EXPIRED, "counter",
     "requests whose propagated deadline budget expired before any "
     "device work ran, by stage: queue = already expired at RPC "
     "entry, gather = evicted by the batch leader at gather time; "
     "either way the request never occupied a launch slot"),
    (DEGRADED_TOTAL, "counter",
     "replies served STALE from the brownout cache while the circuit "
     "breaker was open (explicit degraded flag on the reply, "
     "staleness bounded by --brownout-max-lag generations), by rpc"),
    (BREAKER_STATE, "gauge",
     "circuit breaker state as a label (closed|half-open|open); the "
     "current state's series is 1, the others 0"),
    (BREAKER_TRANSITIONS, "counter",
     "circuit breaker state transitions, by destination state (to= "
     "open is a trip or a failed half-open probe; to=closed is a "
     "successful probe recovering the device path)"),
    (BREAKER_REJECTED, "counter",
     "requests the open breaker failed fast with UNAVAILABLE + "
     "retry-after instead of queueing behind a failing device "
     "(Assign always; Score when the brownout cache could not serve "
     "it within the staleness bound), by method"),
    (REPLICA_ROLE, "gauge",
     "replication role of this daemon as a label (leader|follower); "
     "value is always 1"),
    (REPLICA_FRAMES, "counter",
     "replication frames by outcome on a follower: applied extends "
     "the s<epoch>-<gen> chain, stale was a duplicate/late redelivery "
     "(dropped), resync detected a discontinuity, error failed decode"),
    (REPLICA_LAG, "gauge",
     "commit-to-apply wall delay of the last applied replication "
     "frame against the leader's stamp"),
    (REPLICA_RESYNCS, "counter",
     "one-shot full resyncs a follower performed, by trigger "
     "(gap|epoch|decode|apply|connect)"),
    (REPLICA_FOLLOWERS, "gauge",
     "live replication subscriptions on the leader"),
    (JOURNAL_FRAMES, "counter",
     "durable frame-journal operations: append wrote one "
     "committed frame, replay applied one on boot, compact rewrote the "
     "file as one full-state frame, truncate cut a torn/corrupt tail"),
    (JOURNAL_APPEND_US, "histogram",
     "wall time one journal append added to the Sync commit path "
     "(encode + write + flush); the durability tax on the one writer"),
    (JOURNAL_POSITION, "gauge",
     "generation of the last journaled frame (the <gen> the journal "
     "can recover to); must track koord_scorer_snapshot_generation"),
    (JOURNAL_BYTES, "gauge",
     "journal file size; sawtooths with --journal-compact-every"),
    (JOURNAL_COMPACTION_STAMP, "gauge",
     "wall clock (us since the unix epoch) of the last journal "
     "compaction; a stale stamp under write load means compaction "
     "is failing and the journal grows without bound"),
    (FAILOVER_TOTAL, "counter",
     "crash-tolerance transitions: promoted = this follower became "
     "the leader (SIGUSR2/admin RPC), warm_restart = this daemon "
     "resumed its s<epoch>-<gen> chain from the journal on boot"),
    (RETRY_TOTAL, "counter",
     "backed-off retries through the shared replication.retry policy, "
     "by operation (subscribe = follower redial; resume = a "
     "subscription served from the journal instead of a full frame)"),
    (TRACE_CYCLE, "histogram",
     "client-observed latency of one trace-replay step, by priority band (koord-prod|mid|batch|free; "
     "infra = node/quota events) and rpc (sync|score|assign|cycle = "
     "the whole step); the obs/slo.py SLO gate judges its per-band "
     "p99s in bench.py --config trace"),
    (TRACE_SPANS, "counter",
     "distributed-trace spans completed and handed to the exporter "
     "by span kind: client = shim op/attempt spans, "
     "server = RPC spans, internal = launch/readback spans, consumer "
     "= replica-apply/journal-replay spans; zero while no client "
     "stamps a trace_id"),
    (TRACE_EXPORT_DROPPED, "counter",
     "spans the export sink dropped instead of writing, by "
     "reason (closed|rate|bytes|encode|io); any nonzero rate means "
     "assembled traces are INCOMPLETE — widen the bound or stop the "
     "span storm before trusting a tree"),
    (CANDIDATE_REFRESH, "counter",
     "sparse candidate-list builds/refreshes, by reason: "
     "cold = no resident lists (full blocked build), dirty = lazy "
     "merge-refresh of the entries a warm commit invalidated, stale = "
     "forced full rebuild after --candidate-max-stale merges; a warm "
     "delta stream should run mostly dirty with a bounded stale rate — "
     "a climbing cold rate means commits keep losing row attribution"),
    (CANDIDATE_WIDTH, "gauge",
     "configured sparse candidate width C (the [P, C] serving shape); "
     "0 while the dense engines serve"),
    (LOCK_WITNESS_EDGES, "counter",
     "distinct lock-acquisition edges the runtime witness "
     "(KOORD_LOCK_WITNESS=1, obs/lockwitness.py) recorded, by result: "
     "observed = consistent with the derived order in "
     "koordinator_tpu_torch/analysis/LOCKORDER.md, inversion = closed a "
     "cycle against it (a "
     "schedulable deadlock; the witness also raises); 0 when witness "
     "mode is off"),
    (RELAY_POSITION, "gauge",
     "this daemon's depth in the relay tree: 0 = the root "
     "leader, 1 = a direct follower, 2 = behind one relay, ...; a "
     "relay both applies its parent's stream and re-publishes it on "
     "its own .repl socket"),
    (RELAY_FORWARDED, "counter",
     "replication frames this relay re-published verbatim to its own "
     "subscribers (applied delta frames forwarded byte-identically; "
     "full frames are served from the relay's OWN state, never "
     "forwarded)"),
    (REPLICA_HOP_LAG, "gauge",
     "commit-to-apply wall delay of the last applied frame, labeled "
     "by this replica's hop distance from the root leader — a deep "
     "chain's lag amplification shows per level, not just in the "
     "aggregate koord_scorer_replica_lag_ms"),
    (SEND_BATCH_FRAMES, "histogram",
     "queued replication frames coalesced into one sender wakeup/"
     "syscall on the publisher (frames per wakeup; the batch is "
     "bounded by --repl-batch-bytes, not a frame count)"),
    (REPL_COMPRESS, "counter",
     "full replication frames that crossed the wire zlib-compressed "
     "(KIND_FULL_Z), by op: encode = the publisher compressed one for "
     "a z-capable subscriber, decode = a subscriber inflated one; "
     "journal bytes stay uncompressed"),
    (AUTOSCALE_EVENTS, "counter",
     "elastic replica-tier scaling decisions the autoscaler acted on "
     "by action (scale_up|scale_down); hysteresis and the "
     "cooldown window keep this a step function, not a flap"),
    (AUTOSCALE_REPLICAS, "gauge",
     "the autoscaler's current target follower count (what it is "
     "holding the tier at, between --autoscale-min and "
     "--autoscale-max)"),
    (DEVPROF_COMPILES, "counter",
     "hand kernels the launch ledger (obs/devprof.py) saw built or "
     "loaded inside a launch boundary, by boundary and backend — each is "
     "one (boundary, shape signature) build-ledger row"),
    (DEVPROF_COMPILE_MS, "counter",
     "cumulative kernel build or load wall-time the ledger attributed, "
     "by boundary and backend; divide by devprof_compiles_total for the "
     "mean build cost of that boundary's kernels"),
    (DEVPROF_DEVICE_US, "histogram",
     "sampled per-launch device time (a CUDA event pair on the launch's "
     "stream around the call, the host wall on the CPU), by boundary; "
     "sampling is 1-in-N (--devprof-sample), so multiply counts by N "
     "to estimate launch totals"),
    (DEVPROF_RETRACE, "counter",
     "attributed rebuilds: a registered boundary built or loaded a "
     "kernel again after its first build — named per boundary in "
     "/healthz and the report CLI"),
    (PREWARM_SIGNATURES, "counter",
     "kernel variants the boot-time prewarm thread rebuilt from "
     "<state-dir>/prewarm.json, by result: compiled built (or loaded) "
     "and ready, skipped not replayable here (a CPU daemon, or a source "
     "no longer in the package), failed raised (the live path still "
     "builds at first launch)"),
    (PREWARM_COMPILE_MS, "counter",
     "cumulative build wall-time the prewarm thread spent on recorded "
     "kernel variants; with the library already in the build directory "
     "this collapses to the load"),
    (PREWARM_PENDING, "gauge",
     "recorded kernel variants the prewarm thread has not reached yet "
     "(0 = prewarm done; a launch needing a pending variant just builds "
     "it inline, as an unprewarmed boot does)"),
)

# journal appends are MICROsecond-scale (a header pack + one buffered
# write); the default ms latency buckets would collapse them into the
# first bucket
_JOURNAL_APPEND_BUCKETS = (
    10.0, 50.0, 100.0, 500.0, 1_000.0, 5_000.0, 20_000.0, 100_000.0,
    float("inf"),
)

# sampled device launches span ~100 us (a warm delta scatter) to
# multiple seconds (a cold-start dense cycle on CPU): wider-than-journal
# microsecond buckets
_DEVPROF_US_BUCKETS = (
    100.0, 1_000.0, 5_000.0, 20_000.0, 100_000.0, 500_000.0,
    2_000_000.0, 10_000_000.0, float("inf"),
)

# per-family bucket overrides (histograms default to DEFAULT_BUCKETS_MS)
_BUCKET_OVERRIDES = {
    COALESCE_OCCUPANCY: _OCCUPANCY_BUCKETS,
    INCR_COLS: _INCR_COLS_BUCKETS,
    JOURNAL_APPEND_US: _JOURNAL_APPEND_BUCKETS,
    # frames-per-wakeup is a count, like coalesce occupancy
    SEND_BATCH_FRAMES: _OCCUPANCY_BUCKETS,
    DEVPROF_DEVICE_US: _DEVPROF_US_BUCKETS,
}


class ScorerMetrics:
    """Typed facade over the registry for the scorer families.  All
    methods take host-side Python scalars only — values must be
    materialized BEFORE they reach here."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        for name, kind, help_text in _FAMILIES:
            self.registry.register(
                name, kind, help_text,
                buckets=(
                    _BUCKET_OVERRIDES.get(name, DEFAULT_BUCKETS_MS)
                    if kind == "histogram" else None
                ),
            )

    # -- cycle completion --
    def observe_cycle(
        self,
        latency_ms: float,
        path: str,
        wave: int,
        rounds: Optional[int] = None,
    ) -> None:
        labels = {"path": path or "unknown", "wave": str(int(wave))}
        self.registry.histogram_observe(CYCLE_LATENCY, latency_ms, labels)
        self.registry.counter_add(
            CYCLES_TOTAL, 1, {"path": path or "unknown"}
        )
        if rounds is not None:
            self.registry.gauge_set(
                CYCLE_ROUNDS, rounds, {"path": path or "unknown"}
            )
            self.registry.counter_add(
                ROUNDS_TOTAL, rounds, {"path": path or "unknown"}
            )

    def count_cycle_error(self, stage: str) -> None:
        self.registry.counter_add(CYCLE_ERRORS, 1, {"stage": stage})

    # -- sync --
    def record_sync(self, info: Mapping[str, object]) -> None:
        """``info`` is bridge/state.py apply_sync's summary dict."""
        delta = int(info.get("delta_tensors", 0))
        full = int(info.get("full_tensors", 0))
        if delta and full:
            kind = "mixed"
        elif delta:
            kind = "delta"
        elif full:
            kind = "full"
        else:
            # scalar-columns-only frame (freshness/priority churn): no
            # tensors rode the wire at all — don't claim a delta
            kind = "scalar"
        self.registry.counter_add(SYNC_TOTAL, 1, {"kind": kind})
        if delta:
            self.registry.counter_add(SYNC_TENSORS, delta, {"kind": "delta"})
        if full:
            self.registry.counter_add(SYNC_TENSORS, full, {"kind": "full"})
        self.registry.gauge_set(
            RESIDENT_WARM, 1 if info.get("path") == "warm" else 0
        )

    def set_snapshot(self, epoch: str, generation: int) -> None:
        self.registry.gauge_set(SNAPSHOT_GENERATION, generation)
        self.registry.gauge_set(RESIDENT_EPOCH, 1, {"epoch": epoch})

    # -- feeds --
    def count_demotion(self) -> None:
        self.registry.counter_add(DEMOTIONS_TOTAL, 1)

    def count_uds_frame(self, method: str) -> None:
        self.registry.counter_add(UDS_FRAMES, 1, {"method": method})

    def count_uds_malformed(self, reason: str) -> None:
        self.registry.counter_add(UDS_MALFORMED, 1, {"reason": reason})

    def count_uds_error(self) -> None:
        self.registry.counter_add(UDS_ERRORS, 1)

    def record_coalesce(self, batch_size: int, queue_delays_ms) -> None:
        """One coalesced launch: how many requests shared it and how
        long each waited in the gather queue.  Called by the batch
        leader AFTER the stacked readback (never under the device
        lock's critical path a follower is waiting on)."""
        self.registry.counter_add(COALESCE_BATCHES, 1)
        self.registry.counter_add(COALESCE_REQUESTS, int(batch_size))
        self.registry.histogram_observe(COALESCE_OCCUPANCY, float(batch_size))
        for delay_ms in queue_delays_ms:
            self.registry.histogram_observe(
                COALESCE_QUEUE_DELAY, float(delay_ms)
            )

    def set_coalesce_window(self, window_ms: float) -> None:
        self.registry.gauge_set(COALESCE_WINDOW, float(window_ms))

    def set_device_idle(self, idle_ms: float) -> None:
        self.registry.gauge_set(COALESCE_DEVICE_IDLE, float(idle_ms))

    def count_assign_memo(self, result: str) -> None:
        self.registry.counter_add(ASSIGN_MEMO, 1, {"result": result})

    def count_score_memo(self, result: str, n: int = 1) -> None:
        self.registry.counter_add(SCORE_MEMO, int(n), {"result": result})

    # -- incremental score engine --
    def count_score_incr(self, result: str) -> None:
        """One Score LAUNCH's engine outcome (incr|full|fallback) —
        per launch, not per coalesced request: the engine decision is
        batch-scoped."""
        self.registry.counter_add(SCORE_INCR, 1, {"result": result})

    def observe_incr_cols(self, cols: int) -> None:
        self.registry.histogram_observe(INCR_COLS, float(cols))

    def count_term(self, term: str, n: int = 1) -> None:
        """One fused scoring term's activation on a device Score launch
        — per launch per enabled term, so the series ratio
        term_total / score launches proves the terms rode the ONE
        launch instead of extra per-plugin passes."""
        self.registry.counter_add(TERM_TOTAL, n, {"term": term})

    # -- sparse candidate engine --
    def count_candidate_refresh(self, reason: str, n: int = 1) -> None:
        """One sparse candidate-list build/refresh, by reason
        (cold|dirty|stale) — per launch that rebuilt or re-merged, not
        per coalesced request; a launch that reused clean resident
        lists counts nothing."""
        self.registry.counter_add(
            CANDIDATE_REFRESH, int(n), {"reason": reason}
        )

    def set_candidate_width(self, width: int) -> None:
        self.registry.gauge_set(CANDIDATE_WIDTH, int(width))

    def count_lock_witness_edge(self, result: str) -> None:
        """One distinct witness edge; ``result`` is ``observed`` or
        ``inversion`` (obs/lockwitness.py)."""
        self.registry.counter_add(LOCK_WITNESS_EDGES, 1, {"result": result})

    # -- replicated serving tier --
    def count_shed(self, method: str, band: str = "") -> None:
        # imported here: replication/admission.py imports obs (its lock
        # witness), so a module-level import would make
        # ``import koordinator_tpu_torch.replication`` fail as a first import
        from koordinator_tpu_torch.replication.admission import band_label

        self.registry.counter_add(SHED_TOTAL, 1, {"method": method})
        self.registry.counter_add(
            SHED_BAND, 1, {"band": band_label(band)}
        )

    # -- degradation ladder --
    def count_deadline_expired(self, stage: str, n: int = 1) -> None:
        self.registry.counter_add(
            DEADLINE_EXPIRED, int(n), {"stage": stage}
        )

    def count_degraded(self, rpc: str, n: int = 1) -> None:
        self.registry.counter_add(DEGRADED_TOTAL, int(n), {"rpc": rpc})

    def set_breaker_state(self, state: str) -> None:
        """Flip the state gauge: the current state's series reads 1,
        every other state's 0 (so a scrape always sees exactly one)."""
        for s in ("closed", "half-open", "open"):
            self.registry.gauge_set(
                BREAKER_STATE, 1 if s == state else 0, {"state": s}
            )

    def count_breaker_transition(self, to: str) -> None:
        self.registry.counter_add(BREAKER_TRANSITIONS, 1, {"to": to})

    def count_breaker_rejected(self, method: str) -> None:
        self.registry.counter_add(
            BREAKER_REJECTED, 1, {"method": method}
        )

    def set_replica_role(self, role: str) -> None:
        self.registry.gauge_set(REPLICA_ROLE, 1, {"role": role})

    def count_replica_frame(self, result: str) -> None:
        self.registry.counter_add(REPLICA_FRAMES, 1, {"result": result})

    def set_replica_lag(self, lag_ms: float) -> None:
        self.registry.gauge_set(REPLICA_LAG, float(lag_ms))

    def count_replica_resync(self, reason: str) -> None:
        self.registry.counter_add(REPLICA_RESYNCS, 1, {"reason": reason})

    def set_replica_followers(self, n: int) -> None:
        self.registry.gauge_set(REPLICA_FOLLOWERS, int(n))

    # -- relay tree + elastic tier --
    def set_relay_position(self, depth: int) -> None:
        self.registry.gauge_set(RELAY_POSITION, int(depth))

    def count_relay_forwarded(self, n: int = 1) -> None:
        self.registry.counter_add(RELAY_FORWARDED, int(n))

    def set_replica_hop_lag(self, hop: int, lag_ms: float) -> None:
        self.registry.gauge_set(
            REPLICA_HOP_LAG, float(lag_ms), {"hop": str(int(hop))}
        )

    def observe_send_batch(self, n_frames: int) -> None:
        """Frames one publisher sender wakeup coalesced into a single
        syscall (1 = no coalescing happened on that wakeup)."""
        self.registry.histogram_observe(SEND_BATCH_FRAMES, float(n_frames))

    def count_replica_compress(self, op: str) -> None:
        self.registry.counter_add(REPL_COMPRESS, 1, {"op": op})

    def count_autoscale_event(self, action: str) -> None:
        self.registry.counter_add(AUTOSCALE_EVENTS, 1, {"action": action})

    def set_autoscale_replicas(self, n: int) -> None:
        self.registry.gauge_set(AUTOSCALE_REPLICAS, int(n))

    # -- crash tolerance: journal / failover / retry --
    def count_journal(self, op: str, n: int = 1) -> None:
        self.registry.counter_add(JOURNAL_FRAMES, int(n), {"op": op})

    def observe_journal_append_us(self, us: float) -> None:
        self.registry.histogram_observe(JOURNAL_APPEND_US, float(us))

    def set_journal_position(self, generation: int) -> None:
        self.registry.gauge_set(JOURNAL_POSITION, int(generation))

    def set_journal_bytes(self, n: int) -> None:
        self.registry.gauge_set(JOURNAL_BYTES, int(n))

    def set_journal_compaction_stamp(self, stamp_us: int) -> None:
        self.registry.gauge_set(JOURNAL_COMPACTION_STAMP, int(stamp_us))

    def count_failover(self, event: str) -> None:
        self.registry.counter_add(FAILOVER_TOTAL, 1, {"event": event})

    def count_retry(self, op: str) -> None:
        self.registry.counter_add(RETRY_TOTAL, 1, {"op": op})

    # -- distributed tracing --
    def count_trace_span(self, kind: str) -> None:
        self.registry.counter_add(TRACE_SPANS, 1, {"kind": kind})

    def count_trace_export_dropped(self, reason: str) -> None:
        self.registry.counter_add(
            TRACE_EXPORT_DROPPED, 1, {"reason": reason}
        )

    # -- device-time truth: fed by obs/devprof.py through
    # its weakref metrics sink; all values arrive as host scalars the
    # ledger already materialized --
    def devprof_compile(
        self, boundary: str, backend: str, compile_ms: float
    ) -> None:
        labels = {"boundary": boundary, "backend": backend or "unknown"}
        self.registry.counter_add(DEVPROF_COMPILES, 1, labels)
        self.registry.counter_add(
            DEVPROF_COMPILE_MS, float(compile_ms), labels
        )

    def devprof_device_us(self, boundary: str, us: float) -> None:
        self.registry.histogram_observe(
            DEVPROF_DEVICE_US, float(us), {"boundary": boundary}
        )

    def devprof_retrace(self, boundary: str) -> None:
        self.registry.counter_add(DEVPROF_RETRACE, 1, {"boundary": boundary})

    # -- AOT signature prewarm --
    def count_prewarm(self, result: str) -> None:
        self.registry.counter_add(
            PREWARM_SIGNATURES, 1, {"result": result}
        )

    def add_prewarm_compile_ms(self, ms: float) -> None:
        self.registry.counter_add(PREWARM_COMPILE_MS, float(ms))

    def set_prewarm_pending(self, pending: int) -> None:
        self.registry.gauge_set(PREWARM_PENDING, int(pending))

    # -- trace-driven replay --
    def observe_trace_cycle(self, band: str, rpc: str, ms: float) -> None:
        """One replay step's client-observed latency: ``rpc`` is the
        individual RPC (sync/score/assign) or ``cycle`` for the whole
        step, ``band`` the priority band of the workload the step
        schedules (``infra`` for node/quota events)."""
        self.registry.histogram_observe(
            TRACE_CYCLE, float(ms), {"band": band or "infra", "rpc": rpc}
        )
