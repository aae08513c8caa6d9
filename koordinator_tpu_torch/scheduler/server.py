"""koord-scheduler app/server: CLI, leader election, serving, the seam.

Counterpart of ``koordinator_tpu/scheduler/server.py``, which mirrors
``cmd/koord-scheduler/app/server.go``:

* ``NewSchedulerCommand`` (:79) -> ``build_arg_parser``/``main``: flags
  for the component config, lease path/identity, sockets and ports.
* ``Setup`` (:331) -> ``SchedulerServer``: loads the component config
  (scheduler/config_api.py), builds the scorer servicer (the device-side
  scheduling seam) and the REST service API.
* ``Run`` (:155) -> ``start``/``run_forever``: healthz + /metrics +
  services API over HTTP, the bridge scorer on UDS (the raw framing on
  ``<uds>.raw``, and gRPC on ``<uds>`` where ``grpc`` is installed), all
  gated by **leader election** (:225): only the leader serves Assign.

The replicated tier comes along: ``--replicate-from`` runs a read
follower of a leader's ``<uds>.repl``, ``--relay-from`` a relay,
``--journal`` the crash journal, ``promote`` (SIGUSR2 or admin method 4
over ``<uds>.raw``) turns a follower into the tier's leader.

    python -m koordinator_tpu_torch.scheduler.server --device cpu \\
        --uds /tmp/ks/leader.sock --state-dir /tmp/ks/leader --http-port 0

Where the port differs from the reference:

* ``--device`` (default ``cuda``, raising when CUDA is absent) stands
  where the reference reads ``JAX_PLATFORMS``;
* the persistent XLA compile cache becomes the kernel build directory of
  ``_build.py`` (``--kernel-build-dir``; default the package's gitignored
  ``_build/``), and ``--prewarm`` rebuilds the recorded kernel variants
  (``obs/prewarm.py``);
* ``--mesh N`` and ``--shard`` build an in-process mesh over the visible
  devices of ``--device`` (``parallel/mesh.py visible_devices``: the CUDA
  devices, or on the CPU the forced host platform's count);
* ``enable_grpc`` with no ``grpc`` installed raises at ``start()``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from koordinator_tpu_torch.bridge.server import ScorerServicer, make_server
from koordinator_tpu_torch.httpserving import (
    HTTPLifecycle,
    format_thread_stacks,
    reply_text,
)
from koordinator_tpu_torch.bridge.udsserver import RawUdsServer
from koordinator_tpu_torch.config import DEFAULT_CYCLE_CONFIG
from koordinator_tpu_torch.leaderelection import LeaderElector
from koordinator_tpu_torch.obs.lockwitness import witness_lock
from koordinator_tpu_torch.scheduler.config_api import load_config
from koordinator_tpu_torch.scheduler.services import APIService
from koordinator_tpu_torch.solver import kernel_demotions

# sun_path of a unix socket address holds 107 bytes and a terminating NUL
UDS_PATH_MAX = 107

def _daemon_mesh(device, mesh_devices, shard):
    """(mesh, mesh_resident) of the daemon's ``--mesh``/``--shard``.

    ``--mesh`` builds the 1-D cluster mesh of the mesh-resident snapshot
    over a power-of-two prefix of the visible devices (node buckets are
    powers of two, so only such a mesh divides every geometry; a rounded
    count is logged); ``--shard`` the 2-D ``make_mesh`` of the sharded
    Assign over every visible device.  Neither: (None, False)."""
    if not mesh_devices and not shard:
        return None, False
    from koordinator_tpu_torch.parallel import (
        cluster_mesh,
        make_mesh,
        pow2_device_count,
        visible_devices,
    )

    devices = visible_devices(device)
    if not mesh_devices:
        return make_mesh(devices), False
    if mesh_devices == "auto":
        want = len(devices)
    else:
        try:
            want = int(mesh_devices)
        except ValueError:
            raise ValueError(
                f"--mesh must be a device count or 'auto', got {mesh_devices!r}"
            ) from None
    n = pow2_device_count(min(max(1, want), len(devices)))
    if n != want:
        import logging

        logging.getLogger(__name__).warning(
            "--mesh %s rounded down to %d devices (largest power of two <= "
            "visible %d: node buckets are powers of two, so only a power-of-two "
            "mesh divides every geometry)",
            mesh_devices, n, len(devices),
        )
    return cluster_mesh(devices[:n]), True


def default_state_dir() -> str:
    """Per-user daemon state dir (XDG state home), not a fixed shared
    path: it holds the flight dumps, the journal and the prewarm record."""
    base = os.environ.get("XDG_STATE_HOME") or os.path.join(
        os.path.expanduser("~"), ".local", "state"
    )
    return os.path.join(base, "koord-scheduler")


def check_uds_path(path: str) -> str:
    """``path`` when it fits a unix socket address, else ``ValueError``."""
    if len(os.fsencode(path)) > UDS_PATH_MAX:
        raise ValueError(
            f"unix socket path {path!r} is {len(os.fsencode(path))} bytes; "
            f"the limit is {UDS_PATH_MAX}"
        )
    return path


class _LeaderGatedServicer(ScorerServicer):
    """Assign requires leadership; Score/Sync serve on any replica (they
    are read-only against the resident snapshot)."""

    def __init__(self, cfg, is_leader, **kwargs):
        super().__init__(cfg, **kwargs)
        self._is_leader = is_leader

    def assign(self, req, ctx=None):
        if not self._is_leader():
            raise PermissionError(
                "not the leader: this replica does not place pods"
            )
        return super().assign(req, ctx)


class SchedulerServer:
    def __init__(
        self,
        *,
        config_path: Optional[str] = None,
        lease_path: str = "/tmp/koord-scheduler/leader.lease",
        identity: Optional[str] = None,
        uds_path: str = "/tmp/koord-scheduler/scorer.sock",
        http_host: str = "127.0.0.1",
        http_port: int = 0,
        enable_grpc: bool = True,
        shard: bool = False,
        state_dir: Optional[str] = None,
        mesh_devices: Optional[str] = None,
        pipeline_depth: Optional[int] = None,
        coalesce_cap_ms: Optional[float] = None,
        max_inflight: Optional[int] = None,
        replicate_from: Optional[str] = None,
        relay_from: Optional[str] = None,
        tree_depth: Optional[int] = None,
        repl_batch_bytes: Optional[int] = None,
        repl_compress: bool = True,
        autoscale: bool = False,
        autoscale_min: Optional[int] = None,
        autoscale_max: Optional[int] = None,
        read_slo_p99_ms: Optional[float] = None,
        autoscale_interval_s: Optional[float] = None,
        score_incr_max_ratio: Optional[float] = None,
        candidate_width: Optional[int] = None,
        journal: bool = False,
        journal_compact_every: Optional[int] = None,
        journal_fsync: bool = False,
        breaker_threshold: Optional[int] = None,
        breaker_cooldown_ms: Optional[float] = None,
        brownout_max_lag: Optional[int] = None,
        trace_export: Optional[str] = None,
        shed_fractions: Optional[dict] = None,
        devprof_sample: Optional[int] = None,
        kernel_build_dir: Optional[str] = None,
        prewarm: bool = False,
        device=None,
    ):
        """The reference's keyword surface, with ``kernel_build_dir`` for
        its ``xla_cache`` and ``device`` (default CUDA) for its
        ``JAX_PLATFORMS``.  ``mesh_devices`` (a count or ``"auto"``) serves
        the mesh-resident snapshot over that many visible devices, rounded
        down to a power of two; ``shard`` the round-based sharded Assign
        over every visible device, the snapshot on one."""
        from koordinator_tpu_torch import resolve_device

        self.device = resolve_device(device)
        mesh, mesh_resident = _daemon_mesh(self.device, mesh_devices, shard)
        for path in (uds_path, uds_path + ".raw", uds_path + ".repl"):
            check_uds_path(path)
        if state_dir is None:
            state_dir = default_state_dir()
        self.state_dir = state_dir
        if state_dir:
            try:
                os.makedirs(state_dir, exist_ok=True)
            except OSError as exc:
                import logging

                logging.getLogger(__name__).warning(
                    "state dir %s unavailable (%s); journal and prewarm "
                    "record disabled for this run", state_dir, exc,
                )
                state_dir = self.state_dir = ""
        if kernel_build_dir is not None:
            # an explicit build directory: one replica's build is every
            # replica's load when the tier shares it
            from koordinator_tpu_torch import _build

            _build.set_build_dir(kernel_build_dir)
        self.kernel_build_dir = kernel_build_dir
        cfg = DEFAULT_CYCLE_CONFIG
        self.profiles = []
        if config_path:
            with open(config_path) as fh:
                self.profiles = load_config(fh.read())
            if self.profiles:
                cfg = self.profiles[0].cycle
        if candidate_width is not None:
            import dataclasses

            cfg = dataclasses.replace(
                cfg, candidate_width=int(candidate_width)
            )
        self.cfg = cfg
        self.elector = LeaderElector(
            lease_path,
            identity or f"{socket.gethostname()}-{os.getpid()}",
        )
        servicer_kw = {"device": self.device}
        if mesh is not None:
            servicer_kw.update(mesh=mesh, mesh_resident=mesh_resident)
        if pipeline_depth is not None:
            servicer_kw["pipeline_depth"] = int(pipeline_depth)
        if coalesce_cap_ms is not None:
            servicer_kw["coalesce_cap_ms"] = float(coalesce_cap_ms)
        if max_inflight is not None:
            servicer_kw["max_inflight"] = int(max_inflight)
        if score_incr_max_ratio is not None:
            servicer_kw["score_incr_max_ratio"] = float(score_incr_max_ratio)
        if breaker_threshold is not None:
            servicer_kw["breaker_threshold"] = int(breaker_threshold)
        if breaker_cooldown_ms is not None:
            servicer_kw["breaker_cooldown_ms"] = float(breaker_cooldown_ms)
        if brownout_max_lag is not None:
            servicer_kw["brownout_max_lag"] = int(brownout_max_lag)
        if trace_export is not None:
            servicer_kw["trace_export"] = trace_export
        if shed_fractions is not None:
            servicer_kw["shed_fractions"] = shed_fractions
        if devprof_sample is not None:
            servicer_kw["devprof_sample"] = int(devprof_sample)
        # --prewarm: every kernel variant this process builds is recorded
        # under <state-dir>/prewarm.json (a build listener, and a dump at
        # stop), and at start()/promote() the previous incarnation's set
        # is rebuilt on a background thread while the transports serve
        self._prewarm_enabled = bool(prewarm) and bool(state_dir)
        self._prewarm_runner = None
        self._unhook_prewarm = None
        if prewarm and not self._prewarm_enabled:
            import logging

            logging.getLogger(__name__).warning(
                "--prewarm needs a writable --state-dir for the variant "
                "record; prewarm disabled for this run"
            )
        # replication role: --replicate-from makes this daemon a READ
        # FOLLOWER of the named leader's replication socket; --relay-from
        # is the follower role plus re-publication (the value is the
        # ancestor ladder, nearest parent first).  The default role is
        # leader: every committed Sync streams out on <uds>.repl.
        self.relay_from = relay_from
        self._ancestors: tuple = ()
        self._relay = False
        if relay_from and not replicate_from:
            parts = [p.strip() for p in relay_from.split(",") if p.strip()]
            if not parts:
                raise ValueError(
                    "--relay-from needs at least one ancestor socket path"
                )
            replicate_from = parts[0]
            self._ancestors = tuple(parts[1:])
            self._relay = True
        # hop = distance from the tree's root leader (0 = the root)
        if tree_depth is not None:
            self.hop = max(0, int(tree_depth))
        elif self._relay:
            self.hop = 1 + len(self._ancestors)
        else:
            self.hop = 1 if replicate_from else 0
        self.replicate_from = replicate_from
        self.repl_path = uds_path + ".repl"
        self.repl_batch_bytes = repl_batch_bytes
        self.repl_compress = bool(repl_compress)
        self._relay_cache = None
        # the autoscaler decides in-daemon; the capacity levers are
        # injectable (set autoscale_spawn/drain before start()), and the
        # defaults log the decision
        self._autoscale_enabled = bool(autoscale)
        self._autoscale_min = autoscale_min
        self._autoscale_max = autoscale_max
        self._read_slo_p99_ms = read_slo_p99_ms
        self._autoscale_interval_s = autoscale_interval_s
        self._autoscaler = None
        self.autoscale_spawn = self._default_scale_lever("spawn")
        self.autoscale_drain = self._default_scale_lever("drain")
        self._publisher = None
        self._subscriber = None
        self.applier = None
        # --journal appends every committed frame to a CRC'd journal under
        # the state dir; on boot it replays through the stage/commit seam
        # and the daemon resumes the SAME s<epoch>-<gen> chain.  A
        # follower opens its own journal at promotion.
        self.journal = None
        self.journal_replay: Optional[dict] = None
        self._journal_enabled = bool(journal)
        self._journal_compact_every = journal_compact_every
        self._journal_fsync = bool(journal_fsync)
        self._promote_lock = witness_lock(
            "scheduler.server.SchedulerServer._promote_lock")
        self._promoted = False
        if self._journal_enabled and not state_dir:
            import logging

            logging.getLogger(__name__).warning(
                "--journal needs a writable --state-dir; journaling "
                "disabled for this run"
            )
            self._journal_enabled = False
        if replicate_from:
            from koordinator_tpu_torch.replication.follower import (
                FollowerServicer,
            )

            self.servicer = FollowerServicer(
                cfg, leader=replicate_from, state_dir=state_dir or None,
                **servicer_kw,
            )
        else:
            self.servicer = _LeaderGatedServicer(
                cfg, lambda: self.elector.is_leader,
                # flight-recorder dumps land under <state-dir>/flight on
                # cycle error and SIGUSR1
                state_dir=state_dir or None,
                **servicer_kw,
            )
        self.api = APIService()
        # /healthz slo block: last-window p50/p99 per
        # cycle-latency series (path/wave labels), from the SAME
        # obs/slo.py estimator the trace-replay SLO gate judges with —
        # operators read the identical numbers.  One window per
        # /healthz request.
        from koordinator_tpu_torch.obs.slo import SloWindow
        from koordinator_tpu_torch.obs.scorer_metrics import CYCLE_LATENCY

        self._slo_window = SloWindow(families=(CYCLE_LATENCY,))
        self._slo_lock = witness_lock(
            "scheduler.server.SchedulerServer._slo_lock")
        self.uds_path = uds_path
        # wall-clock stamps of this process's boot: imports done and the
        # device ready (``main``), the transports binding (``start``)
        self.boot: dict = {}
        self.enable_grpc = enable_grpc
        self._raw_server: Optional[RawUdsServer] = None
        self._grpc_server = None
        self._elector_thread: Optional[threading.Thread] = None

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/healthz":
                    # demoted kernel buckets ride health: a demotion
                    # must be visible beyond a log line
                    demoted = {
                        "/".join(map(str, k)): v
                        for k, v in kernel_demotions().items()
                    }
                    self._reply(
                        200,
                        {
                            "ok": True,
                            "leader": outer.elector.is_leader,
                            "kernel_demotions": demoted,
                            # warm-cycle visibility: whether the last Sync
                            # landed on the resident device tensors
                            # ("warm") or dropped residency ("cold")
                            "last_sync_path": outer.servicer.state.last_sync_path,
                            # replication tier visibility
                            "replica": outer.replica_health(),
                            # degradation ladder visibility:
                            # breaker state, per-band sheds, degraded
                            # replies served from the brownout cache
                            "degrade": outer.degrade_health(),
                            # SLO visibility: last-window
                            # per-series quantiles from the gate's
                            # own estimator
                            "slo": outer.slo_health(),
                            # the launch ledger: platform, build
                            # summary, top boundaries by device time
                            "device": outer.device_health(),
                            # kernel prewarm progress: state, counts,
                            # cumulative build time
                            "prewarm": outer.prewarm_health(),
                        },
                    )
                    return
                if self.path == "/debug/stacks":
                    reply_text(self, format_thread_stacks())
                    return
                if self.path == "/debug/process":
                    self._reply(200, outer.process_doc())
                    return
                if self.path == "/debug/last-cycle":
                    doc = outer.last_cycle_doc()
                    self._reply(200 if doc else 404, doc or {})
                    return
                if self.path == "/metrics":
                    # the scorer families (obs/scorer_metrics.py) plus
                    # the daemon gauges, all through the ONE registry so
                    # every family renders exactly once
                    registry = outer.servicer.telemetry.registry
                    registry.gauge_set(
                        "koord_scheduler_leader",
                        int(outer.elector.is_leader),
                    )
                    registry.gauge_set(
                        "koord_scheduler_kernel_demotions",
                        len(kernel_demotions()),
                    )
                    reply_text(self, registry.render())
                    return
                path, _, query = self.path.partition("?")
                q = dict(
                    kv.split("=", 1) for kv in query.split("&") if "=" in kv
                )
                code, doc = outer.api.dispatch(path, q)
                self._reply(code, doc)

            def _reply(self, code, doc):
                data = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((http_host, http_port), Handler)
        self._http = HTTPLifecycle(self._httpd)

    @property
    def http_port(self) -> int:
        return self._httpd.server_address[1]

    @staticmethod
    def _default_scale_lever(action: str):
        """The no-op capacity lever: the in-daemon autoscaler DECIDES;
        starting/stopping replica processes is the orchestrator's job
        (the trace harness injects real levers).  Logging keeps a
        lever-less deployment's decisions visible."""
        import logging

        def lever():
            logging.getLogger(__name__).warning(
                "autoscale %s decided but no capacity lever is wired "
                "(set server.autoscale_%s before start())",
                action, action,
            )

        return lever

    def replica_health(self) -> dict:
        """The /healthz replication block: role, chain position, the
        journal's durable position/compaction stamp and replay outcome
       , follower lag or the leader's live subscriber count,
        and the promotion flag — the fields the failover runbooks in
        docs/REPLICATION.md key off."""
        role = "leader"
        if self.replicate_from and not self._promoted:
            role = "follower"
        out = {
            "role": role,
            "promoted": self._promoted,
            "snapshot_id": self.servicer.snapshot_id(),
            "shed": self.servicer.admission.stats()["shed"],
        }
        if self.applier is not None:
            out["applied_frames"] = self.applier.applied
            out["resyncs"] = self.applier.resyncs
            out["lag_ms"] = self.applier.last_lag_ms
        if self._subscriber is not None:
            out["redials"] = self._subscriber.redials
        if self._publisher is not None:
            out["followers"] = self._publisher.follower_count()
            out["resumed_subscriptions"] = (
                self._publisher.resumed_subscriptions
            )
            out["publish"] = self._publisher.stats()
        if self._relay:
            out["relay"] = {
                "hop": self.hop,
                "ancestors": list(self._ancestors),
                "active_path": (
                    self._subscriber.active_path
                    if self._subscriber is not None else None
                ),
                "ancestor_switches": (
                    self._subscriber.ancestor_switches
                    if self._subscriber is not None else 0
                ),
                "cache": (
                    self._relay_cache.stats()
                    if self._relay_cache is not None else None
                ),
            }
        if self._autoscaler is not None:
            out["autoscale"] = self._autoscaler.stats()
        if self.journal is not None:
            st = self.journal.stats()
            out["journal"] = {
                "position": st["generation"],
                "bytes": st["bytes"],
                "appends": st["appends"],
                "compactions": st["compactions"],
                "truncations": st["truncations"],
                "last_compaction_us": st["last_compaction_us"],
                "compact_every": st["compact_every"],
            }
            if self.journal_replay is not None:
                out["journal"]["replayed_frames"] = (
                    self.journal_replay["replayed_frames"]
                )
                out["journal"]["replay_ms"] = (
                    self.journal_replay["replay_ms"]
                )
        return out

    def process_doc(self) -> dict:
        """``/debug/process``: this daemon process's boot stamps, journal
        counters, the cycle kernels' launch counts (``_build``'s launch
        table; the top-k's paths apart, under ``topk_launches``) and loaded
        kernel variants — what a harness driving the daemon as a separate
        process reads of it."""
        from koordinator_tpu_torch import _build

        journal = self.journal
        return {
            "pid": os.getpid(),
            "boot": dict(self.boot),
            "journal": None if journal is None else journal.stats(),
            "launches": _build.launch_counts("cycle_dense", "cycle_wide", "wave_cycle"),
            "topk_launches": _build.launch_counts("topk_kernel", "topk_sort"),
            "loaded_variants": len(_build.loaded_variants()),
            "kernel_demotions": len(kernel_demotions()),
        }

    def last_cycle_doc(self) -> Optional[dict]:
        """``/debug/last-cycle``: sha256 of each of the last computed
        Assign's five ``CycleResult`` arrays over the synced rows
        (``harness/anchor.py result_digests``), or None before one."""
        from koordinator_tpu_torch.harness.anchor import result_digests

        result, state = self.servicer.last_cycle, self.servicer.state
        if result is None or state.node_alloc is None:
            return None
        quotas = 0 if state.quota_runtime is None else state.quota_runtime.shape[0]
        return {"path": result.path,
                "digests": result_digests(result, state.pod_requests.shape[0],
                                          state.node_alloc.shape[0], quotas)}

    def slo_health(self) -> dict:
        """The /healthz ``slo`` block: per-series p50/p99 of the cycle
        latency histogram over the window since the LAST /healthz
        request (first request: since boot), estimated by the same
        ``obs/slo.py`` bucket quantiles the trace-replay SLO gate
        uses (docs/OBSERVABILITY.md "The SLO gate")."""
        with self._slo_lock:
            window = self._slo_window.advance(
                self.servicer.telemetry.registry
            )
        return {"window": window}

    def degrade_health(self) -> dict:
        """The /healthz ``degrade`` block: where on the
        degradation ladder this daemon currently sits — breaker state
        (any non-closed state in the prod path is page-worthy), the
        admission gate's per-band shed counts, degraded (brownout)
        replies served, and deadline-expired evictions."""
        sv = self.servicer
        out = {
            "breaker": sv.breaker.stats(),
            "admission": sv.admission.stats(),
            "degraded_replies": sv.degraded_replies,
            "deadline_evicted": sv.dispatch.deadline_evicted,
            "brownout_max_lag": sv._brownout_max_lag,
        }
        return out

    def prewarm_health(self) -> dict:
        """The /healthz ``prewarm`` block: whether the AOT
        signature prewarm is enabled and, once the runner started, its
        replay progress — state (loading/importing/replaying/done),
        signature counts by outcome, cumulative compile milliseconds.
        A request arriving before its signature replays just compiles
        inline, so "pending > 0" is a boot-latency note, never an
        availability problem."""
        out: dict = {"enabled": self._prewarm_enabled}
        runner = self._prewarm_runner
        if runner is not None:
            out.update(runner.stats())
        return out

    def _start_prewarm(self) -> None:
        """Kick the background rebuild of the recorded kernel variants.
        Runs while the transports already serve: a launch whose variant
        is not built yet builds it inline.  promote() re-kicks it; a
        variant already loaded in this process costs a dictionary
        lookup."""
        from koordinator_tpu_torch.obs.prewarm import PrewarmRunner

        if self._prewarm_runner is not None:
            self._prewarm_runner.stop()
        self._prewarm_runner = PrewarmRunner(
            self.state_dir, metrics=self.servicer.telemetry.metrics,
            device=self.device,
        ).start()

    def device_health(self) -> dict:
        """The /healthz ``device`` block: backend platform
        and device count, the launch ledger's compile summary (compiles,
        cumulative compile wall-time, attributed retraces), and the top
        boundaries by cumulative sampled device time.  With the ledger
        off (``--devprof-sample`` unset/0) the block still reports the
        platform, so a CPU daemon is told from a CUDA one."""
        from koordinator_tpu_torch.obs import devprof

        return devprof.health_block()

    # -- crash tolerance --
    def _journal_path(self) -> str:
        return os.path.join(self.state_dir, "journal.krj")

    def _open_journal(self):
        from koordinator_tpu_torch.replication.journal import FrameJournal

        kw = {}
        if self._journal_compact_every is not None:
            kw["compact_every"] = int(self._journal_compact_every)
        return FrameJournal(
            self._journal_path(), fsync=self._journal_fsync, **kw
        )

    def _boot_journal(self) -> None:
        """Leader boot: replay the journal through the stage/commit
        seam BEFORE any transport serves, so the first client RPC
        already sees the resumed ``s<epoch>-<gen>`` chain."""
        journal = self._open_journal()
        stats = journal.recover(self.servicer)
        journal.attach(self.servicer)
        # koordlint: disable=unguarded-shared-state(reason: leader boot runs before any transport or elector thread starts; the competing locked writer is promote, which cannot run yet)
        self.journal = journal
        self.journal_replay = stats
        if stats["replayed_frames"]:
            self.servicer.telemetry.metrics.count_failover("warm_restart")
            import logging

            logging.getLogger(__name__).warning(
                "journal warm-restart: replayed %d frame(s) in %.1f ms, "
                "resumed %s (truncated tail: %s)",
                stats["replayed_frames"], stats["replay_ms"],
                stats["resumed_id"], stats["truncated"],
            )

    def promote(self) -> str:
        """Promote this follower daemon to the tier's leader (
        SIGUSR2 and the raw-UDS admin RPC both land here): stop the
        subscription, bump the epoch on the servicer (clients
        full-resync ONCE on the epoch fence; reads never stop), open
        this daemon's own journal seeded with a full-state frame, and
        start publishing on its own ``<uds>.repl``.  Idempotent;
        raises on a daemon that is already the leader role."""
        if not self.replicate_from:
            raise RuntimeError(
                "promote: this daemon is already the leader role"
            )
        with self._promote_lock:
            if self._promoted:
                return self.servicer.snapshot_id()
            if self._subscriber is not None:
                self._subscriber.stop()
                self._subscriber = None
            sid = self.servicer.promote()
            if self._journal_enabled:
                journal = self._open_journal()
                epoch, gen, payload = (
                    self.servicer.export_replication_snapshot()
                )
                journal.write_base(epoch, gen, payload)
                journal.attach(self.servicer)
                self.journal = journal
            from koordinator_tpu_torch.replication.leader import (
                ReplicationPublisher,
            )

            if self._publisher is not None:
                # a promoted RELAY already publishes on its own .repl:
                # hook the local Sync commit path into it and point the
                # hello/resume seam at the durable journal (the relay
                # cache's window ended with the parent's chain)
                self._publisher.journal = self.journal
                self._publisher.attach()
            else:
                self._publisher = ReplicationPublisher(
                    self.servicer, self.repl_path, journal=self.journal
                ).attach().start()
            self._promoted = True
            if self._prewarm_enabled:
                try:
                    self._start_prewarm()
                except Exception:  # prewarm is an accelerant: a failed re-kick must not fail the promotion that clients are waiting on
                    import logging

                    logging.getLogger(__name__).exception(
                        "post-promotion prewarm re-kick failed"
                    )
            return sid

    def _install_sigusr2(self) -> None:
        """SIGUSR2 = promote (main thread only, like the flight
        recorder's SIGUSR1; a no-op on leaders so a fat-fingered
        signal cannot hurt)."""
        import logging
        import signal

        def _handler(signum, frame):
            def run():
                try:
                    self.promote()
                except Exception:  # a failed promotion must be logged, never kill the daemon from a signal handler thread
                    logging.getLogger(__name__).exception(
                        "SIGUSR2 promotion failed"
                    )

            if self.replicate_from:
                # off the signal frame: promotion joins threads and
                # takes servicer locks, neither safe in a handler
                threading.Thread(target=run, daemon=True).start()

        try:
            signal.signal(signal.SIGUSR2, _handler)
        except ValueError:
            pass  # not the main thread (embedded/test use)

    def start(self) -> "SchedulerServer":
        if self._prewarm_enabled:
            # a first boot: the default kernels build while the daemon
            # comes up, side by side (obs/prewarm.py)
            from koordinator_tpu_torch.obs import prewarm

            prewarm.build_boot_default(self.state_dir, self.device)
        if self.enable_grpc:
            # raises RuntimeError where grpc is not installed, before
            # anything binds: a daemon asked for gRPC must not serve the
            # raw socket alone without saying so
            self._grpc_server = make_server(servicer=self.servicer)
        os.makedirs(os.path.dirname(self.uds_path) or ".", exist_ok=True)
        # operator seam: `kill -USR1 <pid>` dumps the last K cycles'
        # spans under <state-dir>/flight (no-op off the main thread);
        # SIGUSR2 promotes a follower
        self.servicer.telemetry.flight.install_sigusr1()
        self._install_sigusr2()
        # journal replay BEFORE any transport binds: the first RPC a
        # reconnecting client lands must already see the resumed chain
        if self._journal_enabled and not self.replicate_from:
            self._boot_journal()
        from koordinator_tpu_torch.bridge.udsserver import (
            METHOD_PROFILE,
            METHOD_PROMOTE,
        )

        def _promote_admin(payload: bytes) -> bytes:
            return self.promote().encode()

        def _profile_admin(payload: bytes) -> bytes:
            # on-demand device profile capture: payload is an
            # optional ASCII window in milliseconds; the reply is the
            # capture directory under --state-dir.  The torch.profiler
            # window closes on a background thread, so the admin RPC
            # returns at once and the operator polls the directory.
            from koordinator_tpu_torch.obs import devprof

            window_ms = 1000
            if payload.strip():
                window_ms = int(payload.strip().decode("ascii"))
            return devprof.capture_profile(
                self.state_dir, window_ms=window_ms
            ).encode()

        # the journal is replayed: the transports bind from here on
        self.boot["transports"] = time.time()
        self._raw_server = RawUdsServer(
            self.uds_path + ".raw", servicer=self.servicer,
            admin_handlers={
                METHOD_PROMOTE: _promote_admin,
                METHOD_PROFILE: _profile_admin,
            },
        ).start()
        if self._grpc_server is not None:
            self._grpc_server.add_insecure_port(f"unix://{self.uds_path}")
            self._grpc_server.start()
        repl_kw = {}
        if self.repl_batch_bytes is not None:
            repl_kw["max_batch_bytes"] = int(self.repl_batch_bytes)
        repl_kw["compress_full"] = self.repl_compress
        metrics = self.servicer.telemetry.metrics
        if self.replicate_from:
            from koordinator_tpu_torch.replication.follower import (
                APPLIED,
                ReplicaApplier,
                ReplicationSubscriber,
            )

            self.applier = ReplicaApplier(self.servicer, hop=self.hop)
            on_raw = None
            if self._relay:
                # relay role: re-publish the applied stream
                # on this daemon's own .repl.  The publisher is NOT
                # attach()ed — there is no local Sync commit to hook;
                # frames arrive through the on_raw forwarding seam as
                # the exact wire bytes the parent sent, and descendant
                # hello/resume is answered from the in-memory cache
                from koordinator_tpu_torch.replication import codec
                from koordinator_tpu_torch.replication.journal import (
                    RelayFrameCache,
                )
                from koordinator_tpu_torch.replication.leader import (
                    ReplicationPublisher,
                )

                self._relay_cache = RelayFrameCache()
                # koordlint: disable=unguarded-shared-state(reason: boot runs before the elector/HTTP threads exist; promote, the locked writer, cannot race it)
                self._publisher = ReplicationPublisher(
                    self.servicer, self.repl_path,
                    journal=self._relay_cache, **repl_kw,
                ).start()
                publisher = self._publisher
                cache = self._relay_cache

                def on_raw(result, frame, raw):
                    if result != APPLIED:
                        return
                    if frame.kind == codec.KIND_DELTA:
                        # forward-then-cache would race a descendant's
                        # hello between the two; cache-first keeps
                        # frames_since ahead of the fan-out
                        cache.add_delta(
                            frame.epoch, frame.generation, raw
                        )
                        publisher.publish_frame(raw)
                        metrics.count_relay_forwarded()
                    else:
                        # an applied full rebases this relay's chain;
                        # descendants are never forwarded the full —
                        # each relay serves opens from its OWN export
                        cache.note_full(frame.epoch, frame.generation)

            # koordlint: disable=unguarded-shared-state(reason: boot runs before the elector/HTTP threads exist; promote, the locked writer, cannot race it)
            self._subscriber = ReplicationSubscriber(
                self.replicate_from, self.applier,
                fallbacks=self._ancestors, on_raw=on_raw,
            ).start()
        else:
            from koordinator_tpu_torch.replication.leader import (
                ReplicationPublisher,
            )

            # koordlint: disable=unguarded-shared-state(reason: boot runs before the elector/HTTP threads exist; promote, the locked writer, cannot race it)
            self._publisher = ReplicationPublisher(
                self.servicer, self.repl_path, journal=self.journal,
                **repl_kw,
            ).attach().start()
        metrics.set_relay_position(self.hop)
        if self._autoscale_enabled:
            from koordinator_tpu_torch.replication.autoscale import (
                AutoscalePolicy,
                RegistrySignals,
                ReplicaAutoscaler,
            )

            policy_kw = {}
            if self._autoscale_min is not None:
                policy_kw["min_replicas"] = int(self._autoscale_min)
            if self._autoscale_max is not None:
                policy_kw["max_replicas"] = int(self._autoscale_max)
            if self._read_slo_p99_ms is not None:
                policy_kw["p99_high_ms"] = float(self._read_slo_p99_ms)
            signals = RegistrySignals(self.servicer.telemetry.registry)
            self._autoscaler = ReplicaAutoscaler(
                AutoscalePolicy(**policy_kw),
                signals.collect,
                spawn=lambda: self.autoscale_spawn(),
                drain=lambda: self.autoscale_drain(),
                metrics=metrics,
                interval_s=(
                    float(self._autoscale_interval_s)
                    if self._autoscale_interval_s is not None else 1.0
                ),
            ).start()
        self._http.start()
        self._elector_thread = threading.Thread(
            target=self.elector.run, daemon=True
        )
        self._elector_thread.start()
        # prewarm LAST: every transport above is already accepting, so
        # the background rebuild overlaps real serving (a launch whose
        # variant is not rebuilt yet builds it inline)
        if self._prewarm_enabled:
            from koordinator_tpu_torch import _build
            from koordinator_tpu_torch.obs import prewarm

            state_dir = self.state_dir
            self._unhook_prewarm = _build.add_build_listener(
                lambda source, defines, seconds: prewarm.record_build(
                    state_dir, source, defines)
            )
            self._start_prewarm()
        return self

    def stop(self):
        if self._prewarm_runner is not None:
            self._prewarm_runner.stop()
        if self._unhook_prewarm is not None:
            # every variant this process holds loaded joins the record,
            # also those built before this daemon started
            from koordinator_tpu_torch.obs import prewarm

            self._unhook_prewarm()
            self._unhook_prewarm = None
            prewarm.dump(self.state_dir)
        self.elector.stop()
        if self._elector_thread:
            self._elector_thread.join(timeout=5)
        if self._autoscaler:
            self._autoscaler.stop()
        if self._subscriber:
            self._subscriber.stop()
        if self._publisher:
            self._publisher.stop()
        if self._raw_server:
            self._raw_server.stop()
        if self._grpc_server:
            self._grpc_server.stop(0)
        if self.journal is not None:
            self.journal.close()
        self._http.stop()


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="koord-scheduler")
    ap.add_argument("--config", help="component config YAML", default=None)
    ap.add_argument(
        "--lease", default="/tmp/koord-scheduler/leader.lease",
        help="leader-election lease file (shared dir across replicas)",
    )
    ap.add_argument("--identity", default=None)
    ap.add_argument(
        "--uds", default="/tmp/koord-scheduler/scorer.sock",
        help="scorer UDS path (gRPC; <path>.raw serves the native framing)",
    )
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=10251)
    ap.add_argument(
        "--shard", action="store_true",
        help="serve the round-based sharded Assign over every visible device "
        "(an in-process mesh; placements stay bit-identical); the snapshot "
        "stays on one device — see --mesh",
    )
    ap.add_argument(
        "--mesh", dest="mesh_devices",
        default=os.environ.get("KOORD_MESH_DEVICES") or None,
        help="serve the MESH-RESIDENT snapshot: split the cluster's node rows "
        "over N visible devices ('auto' = all; rounded down to a power of "
        "two), deltas scattered into the owning shard, Assign on the sharded "
        "rounds (env: KOORD_MESH_DEVICES)",
    )
    ap.add_argument(
        "--pipeline-depth", type=int,
        default=(
            int(os.environ["KOORD_PIPELINE_DEPTH"])
            if os.environ.get("KOORD_PIPELINE_DEPTH") else None
        ),
        help="launched-but-unread device batches allowed in flight "
        "(default 2 = double buffering; 1 = serial readbacks, the bench "
        "baseline; env: KOORD_PIPELINE_DEPTH)",
    )
    ap.add_argument(
        "--coalesce-cap-ms", type=float,
        default=(
            float(os.environ["KOORD_COALESCE_CAP_MS"])
            if os.environ.get("KOORD_COALESCE_CAP_MS") else None
        ),
        help="clamp of the adaptive gather window's straggler wait "
        "(default 5.0 ms; env: KOORD_COALESCE_CAP_MS) — bounds the "
        "latency tax a burst-gathering leader may pay (docs/PIPELINE.md)",
    )
    ap.add_argument(
        "--max-inflight", type=int,
        default=(
            int(os.environ["KOORD_MAX_INFLIGHT"])
            if os.environ.get("KOORD_MAX_INFLIGHT") else None
        ),
        help="admission control (docs/REPLICATION.md): read RPCs "
        "(Score/Assign) admitted-but-unfinished before new ones shed "
        "with RESOURCE_EXHAUSTED + a retry-after hint; 0 = unlimited "
        "(default; env: KOORD_MAX_INFLIGHT).  Sync is never shed",
    )
    ap.add_argument(
        "--replicate-from", dest="replicate_from",
        default=os.environ.get("KOORD_REPLICATE_FROM") or None,
        help="run as a READ FOLLOWER of the leader daemon whose "
        "replication socket is at this path (the leader serves it at "
        "<uds>.repl): apply the streamed Sync frames onto a local "
        "device-resident snapshot copy, serve Score/Assign locally, "
        "refuse client Syncs (env: KOORD_REPLICATE_FROM; "
        "docs/REPLICATION.md)",
    )
    ap.add_argument(
        "--relay-from", dest="relay_from",
        default=os.environ.get("KOORD_RELAY_FROM") or None,
        help="run as a RELAY follower (docs/REPLICATION.md \"Relay "
        "tree & autoscaling\"): comma-separated ancestor ladder of "
        "replication sockets, nearest parent first (e.g. "
        "'relay1.sock.repl,root.sock.repl').  Subscribes to the first "
        "entry with the rest as failover fallbacks, re-publishes every "
        "applied delta frame byte-identically on this daemon's own "
        "<uds>.repl for its children, and answers their hello/resume "
        "from an in-memory frame cache — fan-out bandwidth multiplies "
        "with tree width (env: KOORD_RELAY_FROM)",
    )
    ap.add_argument(
        "--tree-depth", type=int, dest="tree_depth",
        default=(
            int(os.environ["KOORD_TREE_DEPTH"])
            if os.environ.get("KOORD_TREE_DEPTH") else None
        ),
        help="pin this daemon's hop distance from the relay tree's "
        "root (labels the per-hop lag gauge); default inferred from "
        "the --relay-from ladder length (env: KOORD_TREE_DEPTH)",
    )
    ap.add_argument(
        "--repl-batch-bytes", type=int, dest="repl_batch_bytes",
        default=(
            int(os.environ["KOORD_REPL_BATCH_BYTES"])
            if os.environ.get("KOORD_REPL_BATCH_BYTES") else None
        ),
        help="byte bound of the replication sender's frame coalescing: "
        "consecutive queued frames concatenate into ONE send syscall "
        "up to this many bytes per wakeup (default 1 MiB; frames-per-"
        "wakeup publishes on koord_scorer_repl_send_batch_frames; "
        "env: KOORD_REPL_BATCH_BYTES)",
    )
    ap.add_argument(
        "--repl-no-compress", action="store_true",
        default=bool(os.environ.get("KOORD_REPL_NO_COMPRESS")),
        help="disable zlib compression of full replication frames on "
        "the wire (compression is negotiated per subscriber in the "
        "hello handshake and never touches journal bytes or delta "
        "frames; env: KOORD_REPL_NO_COMPRESS=1)",
    )
    ap.add_argument(
        "--autoscale", action="store_true",
        default=bool(os.environ.get("KOORD_AUTOSCALE")),
        help="run the SLO-driven elastic-tier control loop "
        "(docs/REPLICATION.md \"Relay tree & autoscaling\"): watch the "
        "windowed read p99, replication lag and admission sheds, and "
        "call the wired spawn/drain capacity levers to hold "
        "--read-slo-p99-ms; decisions publish on "
        "koord_scorer_autoscale_* either way (env: KOORD_AUTOSCALE=1)",
    )
    ap.add_argument(
        "--autoscale-min", type=int, dest="autoscale_min",
        default=(
            int(os.environ["KOORD_AUTOSCALE_MIN"])
            if os.environ.get("KOORD_AUTOSCALE_MIN") else None
        ),
        help="floor of the autoscaler's follower count (default 1; "
        "env: KOORD_AUTOSCALE_MIN)",
    )
    ap.add_argument(
        "--autoscale-max", type=int, dest="autoscale_max",
        default=(
            int(os.environ["KOORD_AUTOSCALE_MAX"])
            if os.environ.get("KOORD_AUTOSCALE_MAX") else None
        ),
        help="ceiling of the autoscaler's follower count (default 8; "
        "env: KOORD_AUTOSCALE_MAX)",
    )
    ap.add_argument(
        "--read-slo-p99-ms", type=float, dest="read_slo_p99_ms",
        default=(
            float(os.environ["KOORD_READ_SLO_P99_MS"])
            if os.environ.get("KOORD_READ_SLO_P99_MS") else None
        ),
        help="the declared read SLO the autoscaler defends: windowed "
        "read p99 above this scales up (after the hysteresis streak), "
        "comfortably below scales down (default 50.0; env: "
        "KOORD_READ_SLO_P99_MS)",
    )
    ap.add_argument(
        "--autoscale-interval-s", type=float, dest="autoscale_interval_s",
        default=(
            float(os.environ["KOORD_AUTOSCALE_INTERVAL_S"])
            if os.environ.get("KOORD_AUTOSCALE_INTERVAL_S") else None
        ),
        help="seconds between autoscaler ticks (default 1.0; the "
        "hysteresis streaks and cooldown are counted in ticks, so "
        "this also scales the tier's reaction time; env: "
        "KOORD_AUTOSCALE_INTERVAL_S)",
    )
    ap.add_argument(
        "--score-incr-max-ratio", type=float,
        dest="score_incr_max_ratio",
        default=(
            float(os.environ["KOORD_SCORE_INCR_MAX_RATIO"])
            if os.environ.get("KOORD_SCORE_INCR_MAX_RATIO") else None
        ),
        help="incremental score engine's fallback gate (docs/KERNEL.md "
        "\"Incremental scoring\"): dirty-cost fraction "
        "(dirty_nodes/N + dirty_pods/P) above which a warm Score "
        "full-rescores instead of advancing the resident [P, N] score "
        "tensor column-wise (default 0.5, tuned by the trace-harness "
        "sweep — the measured crossover is ~0.6; env: "
        "KOORD_SCORE_INCR_MAX_RATIO)",
    )
    ap.add_argument(
        "--candidate-width", type=int,
        dest="candidate_width",
        default=(
            int(os.environ["KOORD_CANDIDATE_WIDTH"])
            if os.environ.get("KOORD_CANDIDATE_WIDTH") else None
        ),
        help="sparse candidate-set scoring (docs/KERNEL.md \"Sparse "
        "candidate scoring\"): score each pod against only its C "
        "lowest-indexed feasible nodes ([P, C] cells instead of the "
        "dense [P, N] wall).  Power of two; 0 (default) keeps the "
        "dense engines; 256 is the recommended serving width.  A pod "
        "whose exact feasible fan-out exceeds C makes Score refuse "
        "with FAILED_PRECONDITION rather than serve a truncated list "
        "(env: KOORD_CANDIDATE_WIDTH)",
    )
    ap.add_argument(
        "--journal", action="store_true",
        default=bool(os.environ.get("KOORD_JOURNAL")),
        help="crash tolerance (docs/REPLICATION.md): append every "
        "committed Sync's encoded frame to a CRC'd journal at "
        "<state-dir>/journal.krj and replay it on boot, resuming the "
        "same s<epoch>-<gen> chain — reconnecting clients/followers "
        "see no full resync; a torn tail truncates to the last valid "
        "frame (env: KOORD_JOURNAL=1)",
    )
    ap.add_argument(
        "--journal-compact-every", type=int,
        default=(
            int(os.environ["KOORD_JOURNAL_COMPACT_EVERY"])
            if os.environ.get("KOORD_JOURNAL_COMPACT_EVERY") else None
        ),
        help="delta frames between journal compactions (a full-state "
        "frame atomically replaces the file; default 256; env: "
        "KOORD_JOURNAL_COMPACT_EVERY)",
    )
    ap.add_argument(
        "--journal-fsync", action="store_true",
        default=bool(os.environ.get("KOORD_JOURNAL_FSYNC")),
        help="fsync every journal append (power-loss durability at a "
        "per-commit fsync cost; default flushes to the OS, which "
        "already survives the process crashes the tier replicates "
        "against; env: KOORD_JOURNAL_FSYNC=1)",
    )
    ap.add_argument(
        "--breaker-threshold", type=int,
        default=(
            int(os.environ["KOORD_BREAKER_THRESHOLD"])
            if os.environ.get("KOORD_BREAKER_THRESHOLD") else None
        ),
        help="circuit breaker (docs/REPLICATION.md \"Degradation "
        "ladder\"): consecutive device-launch failures that trip it "
        "open — Score then serves the bounded-staleness brownout "
        "cache with an explicit degraded flag, Assign fails fast with "
        "retry-after; 0 disables (default 3; env: "
        "KOORD_BREAKER_THRESHOLD)",
    )
    ap.add_argument(
        "--breaker-cooldown-ms", type=float,
        default=(
            float(os.environ["KOORD_BREAKER_COOLDOWN_MS"])
            if os.environ.get("KOORD_BREAKER_COOLDOWN_MS") else None
        ),
        help="how long an open breaker waits before admitting one "
        "half-open probe launch (default 250 ms; env: "
        "KOORD_BREAKER_COOLDOWN_MS)",
    )
    ap.add_argument(
        "--brownout-max-lag", type=int,
        default=(
            int(os.environ["KOORD_BROWNOUT_MAX_LAG"])
            if os.environ.get("KOORD_BROWNOUT_MAX_LAG") else None
        ),
        help="bounded staleness of breaker-open Score replies: max "
        "generations behind the current snapshot the brownout cache "
        "may serve (degraded flag set); a reply past the bound is "
        "REFUSED, never served (default 2; env: "
        "KOORD_BROWNOUT_MAX_LAG).  Assign never serves stale",
    )
    ap.add_argument(
        "--trace-export", nargs="?", const="1",
        default=os.environ.get("KOORD_TRACE_EXPORT") or None,
        help="distributed tracing (docs/OBSERVABILITY.md \"Distributed "
        "tracing\"): export completed spans as OTLP-shaped JSON lines "
        "to this directory (bare flag or '1' = <state-dir>/traces); "
        "requests carrying a trace_id get server spans either way, "
        "coalesced batches fan-in link to their one launch span, and "
        "`python -m koordinator_tpu_torch.obs.assemble` merges the "
        "per-process exports into whole-request trees (env: "
        "KOORD_TRACE_EXPORT)",
    )
    for band, suffix in (("free", "FREE"), ("batch", "BATCH"),
                         ("mid", "MID"), ("prod", "PROD")):
        ap.add_argument(
            f"--shed-fraction-{band}", type=float,
            dest=f"shed_fraction_{band}",
            default=(
                float(os.environ[f"KOORD_SHED_FRACTION_{suffix}"])
                if os.environ.get(f"KOORD_SHED_FRACTION_{suffix}")
                else None
            ),
            help=f"admission shed ladder rung for the koord-{band} "
            "band: fraction of --max-inflight this band may fill "
            "before ITS new requests shed (must be in (0, 1] and "
            "monotone free <= batch <= mid <= prod; defaults "
            "0.50/0.65/0.80/1.00; env: "
            f"KOORD_SHED_FRACTION_{suffix})",
        )
    ap.add_argument(
        "--devprof-sample", type=int,
        default=(
            int(os.environ["KOORD_DEVPROF_SAMPLE"])
            if os.environ.get("KOORD_DEVPROF_SAMPLE") else None
        ),
        help="the launch ledger (obs/devprof.py): time 1-in-N serving "
        "launches on the device and record every kernel build per "
        "boundary; 0/unset = off, and the serving path stays bit-inert.  "
        "The ledger persists to <state-dir>/devprof.json; read it with "
        "`python -m koordinator_tpu_torch.obs.devprof <state-dir>` (env: "
        "KOORD_DEVPROF_SAMPLE)",
    )
    ap.add_argument(
        "--kernel-build-dir", dest="kernel_build_dir",
        default=os.environ.get("KOORD_KERNEL_BUILD_DIR") or None,
        help="directory the CUDA kernels are built into and loaded from "
        "(_build.py; default the package's koordinator_tpu_torch/_build/).  "
        "Point every replica of a tier at the same directory so one "
        "replica's build is every replica's load (env: "
        "KOORD_KERNEL_BUILD_DIR)",
    )
    ap.add_argument(
        "--prewarm", action="store_true",
        default=bool(os.environ.get("KOORD_PREWARM")),
        help="kernel prewarm (obs/prewarm.py): record every kernel "
        "variant this daemon builds into <state-dir>/prewarm.json and, "
        "on the next boot and on promotion, rebuild the recorded set on "
        "a background thread while the daemon already serves.  Progress "
        "publishes on koord_scorer_prewarm_* and /healthz 'prewarm' "
        "(env: KOORD_PREWARM=1)",
    )
    ap.add_argument(
        "--no-grpc", dest="grpc", action="store_false",
        help="serve the raw framing on <uds>.raw only, no gRPC on <uds> "
        "(where the grpc package is absent the daemon otherwise refuses "
        "to start)",
    )
    ap.add_argument(
        "--device", default=os.environ.get("KOORD_DEVICE") or "cuda",
        help="the device the resident snapshot and every launch live on: "
        "cuda (default; the daemon fails without a card) or cpu, the "
        "plain PyTorch path (env: KOORD_DEVICE)",
    )
    ap.add_argument(
        "--state-dir", default=None,
        help="daemon state directory (default: $XDG_STATE_HOME/"
        "koord-scheduler, per-user): flight dumps, the journal, the "
        "prewarm record and the launch ledger live there",
    )
    return ap


# seconds between the main thread's wake-ups while the daemon serves (a
# signal's Python handler waits at most this long)
_PARK_S = 0.5


def main(argv=None) -> int:
    # every import of this module (torch included) is done by now
    boot = {"imported": time.time()}
    args = build_arg_parser().parse_args(argv)
    from koordinator_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import torch

        # the CUDA context, stamped apart from the journal replay
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    boot["device_ready"] = time.time()
    shed_fractions = {
        f"koord-{band}": value
        for band in ("free", "batch", "mid", "prod")
        if (value := getattr(args, f"shed_fraction_{band}")) is not None
    } or None
    server = SchedulerServer(
        config_path=args.config,
        lease_path=args.lease,
        identity=args.identity,
        uds_path=args.uds,
        http_host=args.http_host,
        http_port=args.http_port,
        enable_grpc=args.grpc,
        shard=args.shard,
        state_dir=args.state_dir,
        mesh_devices=args.mesh_devices,
        pipeline_depth=args.pipeline_depth,
        coalesce_cap_ms=args.coalesce_cap_ms,
        max_inflight=args.max_inflight,
        replicate_from=args.replicate_from,
        relay_from=args.relay_from,
        tree_depth=args.tree_depth,
        repl_batch_bytes=args.repl_batch_bytes,
        repl_compress=not args.repl_no_compress,
        autoscale=args.autoscale,
        autoscale_min=args.autoscale_min,
        autoscale_max=args.autoscale_max,
        read_slo_p99_ms=args.read_slo_p99_ms,
        autoscale_interval_s=args.autoscale_interval_s,
        score_incr_max_ratio=args.score_incr_max_ratio,
        candidate_width=args.candidate_width,
        journal=args.journal,
        journal_compact_every=args.journal_compact_every,
        journal_fsync=args.journal_fsync,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_ms=args.breaker_cooldown_ms,
        brownout_max_lag=args.brownout_max_lag,
        trace_export=args.trace_export,
        shed_fractions=shed_fractions,
        devprof_sample=args.devprof_sample,
        kernel_build_dir=args.kernel_build_dir,
        prewarm=args.prewarm,
        device=args.device,
    )
    server.boot = boot
    server.start()
    try:
        # the main thread parks in timed waits: a process-directed SIGUSR1
        # or SIGUSR2 that the kernel hands to another thread only flags
        # its Python handler, which runs when the main thread next wakes
        parked = threading.Event()
        while not parked.wait(_PARK_S):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
