"""Node-agent daemon wiring: one object owning every koordlet subsystem.

Reference: ``pkg/koordlet/koordlet.go:68 NewDaemon`` wires metriccache ->
statesinformer -> metricsadvisor -> predictserver -> qosmanager ->
runtimehooks and ``:123 Run`` starts them as goroutines
(``koordlet.go:126-178``).  Here the same wiring with explicit tick
methods (``run_once``) so tests drive it with a fake clock, plus a
``run`` loop with threads for live deployment.  Prometheus-style metrics
and the audit /events handler hang off the daemon the way
``cmd/koordlet/main.go:64-90`` mounts them.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.koordlet.collectors import Collector, MetricsAdvisor
from koordinator_tpu_torch.koordlet.metriccache import MetricCache
from koordinator_tpu_torch.koordlet.metrics import MetricsRegistry
from koordinator_tpu_torch.koordlet.pleg import Pleg
from koordinator_tpu_torch.koordlet.prediction import PeakPredictServer
from koordinator_tpu_torch.koordlet.qosmanager import QOSManager, QOSStrategy
from koordinator_tpu_torch.koordlet.statesinformer import NodeMetricReporter, StatesInformer
from koordinator_tpu_torch.koordlet.sysfs import SysFS


class Daemon:
    """Wires the six koordlet subsystems (koordlet.go:126-178 order)."""

    def __init__(
        self,
        *,
        fs: Optional[SysFS] = None,
        cache: Optional[MetricCache] = None,
        informer: Optional[StatesInformer] = None,
        collectors: Sequence[Collector] = (),
        strategies: Sequence[QOSStrategy] = (),
        predict: Optional[PeakPredictServer] = None,
        reporter: Optional[NodeMetricReporter] = None,
        auditor: Optional[Auditor] = None,
        metrics: Optional[MetricsRegistry] = None,
        report_interval_seconds: float = 60.0,
        storage_dir: Optional[str] = None,
        nri_socket: Optional[str] = None,
        hook_registry=None,
        evictor=None,
    ):
        self.fs = fs or SysFS()
        if cache is not None:
            self.cache = cache
        elif storage_dir:
            # durable metrics (the reference embeds a Prometheus TSDB,
            # tsdb_storage.go:105): a koordlet restart replays the WAL so
            # the NodeMetric aggregation window survives
            from koordinator_tpu_torch.koordlet.metriccache import (
                PersistentMetricCache,
            )

            self.cache = PersistentMetricCache(storage_dir)
        else:
            self.cache = MetricCache()
        self.informer = informer or StatesInformer()
        self.advisor = MetricsAdvisor(list(collectors))
        self.qos = QOSManager(list(strategies))
        self.predict = predict
        self.reporter = reporter
        self.auditor = auditor
        self.metrics = metrics or MetricsRegistry()
        self.pleg = Pleg(self.fs)
        self.evictor = evictor
        # NRI delivery mode (reference runtimehooks/nri/server.go): when a
        # runtime NRI socket is configured, register as a plugin on it —
        # the runtime then drives the shared HookRegistry through
        # CreateContainer/UpdateContainer events; proxy and reconciler
        # modes keep working beside it
        self.nri = None
        if nri_socket is not None:
            import logging

            from koordinator_tpu_torch.koordlet.nri import NriPlugin
            from koordinator_tpu_torch.koordlet.runtimehooks import default_registry

            try:
                self.nri = NriPlugin(
                    nri_socket, hook_registry or default_registry()
                )
            except (OSError, RuntimeError):
                # NRI is one of three delivery modes; an absent/unready
                # runtime socket must degrade to proxy/reconciler, not
                # fail the whole daemon (reference runtimehooks.go falls
                # back the same way when NRI registration fails)
                logging.getLogger(__name__).exception(
                    "NRI registration on %s failed; continuing with "
                    "proxy/reconciler delivery only",
                    nri_socket,
                )
        self.report_interval = report_interval_seconds
        self._next_report = 0.0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- single tick (test- and fake-clock-friendly) --
    def run_once(self, now: Optional[float] = None) -> dict:
        """One pass over every subsystem, in the reference's start order."""
        now = time.time() if now is None else now
        events = self.pleg.poll_once()
        # informer plugin sync (reference states_informer.go:146 Run):
        # NRT/device producers publish through the informer store each tick
        informer_reports = self.informer.sync_plugins(now)
        collected = self.advisor.run_once(now)
        reported = None
        if self.reporter is not None and now >= self._next_report:
            reported = self.reporter.collect(now)
            self._next_report = now + self.report_interval
        strategies = self.qos.run_once(now)
        if self.auditor is not None and strategies:
            self.auditor.log("qos-tick", strategies=",".join(strategies))
        self.metrics.counter_add("koordlet_ticks_total", 1)
        self.metrics.gauge_set("koordlet_collectors_last_run", len(collected))
        return {
            "pleg_events": events,
            "collectors": collected,
            "strategies": strategies,
            "node_metric": reported,
            "informer_reports": informer_reports,
        }

    # -- live loop --
    def run(
        self,
        interval_seconds: float = 1.0,
        stop: Optional[Callable[[], bool]] = None,
    ) -> None:
        while not self._stop.is_set() and not (stop and stop()):
            self.run_once()
            self._stop.wait(interval_seconds)

    def start(self, interval_seconds: float = 1.0) -> None:
        t = threading.Thread(
            target=self.run, args=(interval_seconds,), daemon=True
        )
        t.start()
        self._threads.append(t)

    def shutdown(self) -> None:
        self._stop.set()
        if self.nri is not None:
            self.nri.close()
        for t in self._threads:
            t.join(timeout=5)
        if self.predict is not None:
            self.predict.checkpoint_all()
        close = getattr(self.cache, "close", None)
        if close is not None:
            close()  # the WAL handle belongs to the Daemon that built it


def build_default_daemon(
    *,
    cgroup_root: str = "/",
    storage_dir: Optional[str] = None,
    audit_dir: Optional[str] = None,
    nri_socket: Optional[str] = None,
    node_name: str = "",
    evict_fn=None,
) -> Daemon:
    """Wire the reference's default module set (koordlet.go:126-178):
    metriccache -> statesinformer -> the metricsadvisor collector battery
    -> qosmanager strategies -> audit/metrics, against the host sysfs.
    Everything goes through the Daemon constructor so MetricsAdvisor's
    enabled() gate applies to the default battery too."""
    from koordinator_tpu_torch.koordlet.collectors import (
        BEResourceCollector,
        DeviceCollector,
        NodeResourceCollector,
        PSICollector,
        SysResourceCollector,
    )
    from koordinator_tpu_torch.koordlet.qosmanager import (
        Evictor,
        default_qos_strategies,
    )
    from koordinator_tpu_torch.koordlet.resourceexecutor import ResourceUpdateExecutor
    from koordinator_tpu_torch.koordlet.statesinformer import (
        DeviceReporter,
        NodeTopoReporter,
    )

    if not node_name:
        # reference koordlet resolves the node name from NODE_NAME; an
        # empty name would publish an NRT no scheduler could match
        import os
        import socket as _socket

        node_name = os.environ.get("NODE_NAME") or _socket.gethostname()
    fs = SysFS(root=cgroup_root)
    informer = StatesInformer()
    executor = ResourceUpdateExecutor(fs)
    # the eviction sink: production passes evict_fn (the reference calls
    # the apiserver eviction API); it rides on the returned Daemon so
    # callers can inspect the ledger
    evictor = Evictor(evict_fn)
    if storage_dir:
        from koordinator_tpu_torch.koordlet.metriccache import PersistentMetricCache

        cache = PersistentMetricCache(storage_dir)
    else:
        cache = MetricCache()
    daemon = Daemon(
        fs=fs,
        cache=cache,
        informer=informer,
        collectors=[
            NodeResourceCollector(fs, cache),
            PSICollector(fs, cache),
            BEResourceCollector(fs, cache),
            SysResourceCollector(cache),
            DeviceCollector(cache),
        ],
        strategies=default_qos_strategies(informer, cache, executor, evictor),
        reporter=NodeMetricReporter(cache, informer),
        auditor=Auditor(audit_dir) if audit_dir else None,
        nri_socket=nri_socket,
        evictor=evictor,
    )
    # informer producer plugins (reference impl/registry.go): publish
    # NodeResourceTopology and the Device CR each tick
    informer.register_plugin(NodeTopoReporter(fs, informer, node_name))
    informer.register_plugin(DeviceReporter(informer))
    return daemon


def main(argv=None) -> int:
    """koordlet CLI (cmd/koordlet/main.go): the node agent + /metrics
    and /events HTTP exposition."""
    import argparse
    from wsgiref.simple_server import make_server

    from koordinator_tpu_torch.httpserving import HTTPLifecycle

    ap = argparse.ArgumentParser(prog="koordlet")
    ap.add_argument("--cgroup-root", default="/")
    ap.add_argument(
        "--storage-dir", default=None,
        help="durable metric WAL dir (restart keeps aggregation windows)",
    )
    ap.add_argument("--audit-dir", default=None)
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument(
        "--nri-socket", default=None,
        help="runtime NRI socket; when set koordlet registers as an NRI "
        "plugin (third hook delivery mode beside proxy/reconciler)",
    )
    ap.add_argument("--node-name", default="")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=9316)
    args = ap.parse_args(argv)

    daemon = build_default_daemon(
        cgroup_root=args.cgroup_root,
        storage_dir=args.storage_dir,
        audit_dir=args.audit_dir,
        nri_socket=args.nri_socket,
        node_name=args.node_name,
    )

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "")
        if path == "/metrics":
            return daemon.metrics.wsgi_app(environ, start_response)
        if path == "/events" and daemon.auditor is not None:
            return daemon.auditor.wsgi_app(environ, start_response)
        start_response("404 Not Found", [("Content-Type", "text/plain")])
        return [b"not found"]

    # bind BEFORE the tick loop starts: a port conflict must be a clean
    # no-op, never a daemon left mutating cgroups with no teardown path
    http = HTTPLifecycle(make_server(args.http_host, args.http_port, app))
    daemon.start(args.interval)
    http.start()
    try:
        threading.Event().wait()  # koordlint: disable=unbounded-wait(main thread parks forever by design; the daemon threads own the work and KeyboardInterrupt unparks)
    except KeyboardInterrupt:
        pass
    finally:
        daemon.shutdown()
        http.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
