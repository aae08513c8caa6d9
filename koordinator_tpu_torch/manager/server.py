"""koord-manager app/server: leader-elected controller manager + webhook.

The port's own copy of ``koordinator_tpu/manager/server.py``.

Mirrors ``cmd/koord-manager/main.go``: a controller-runtime manager with
leader election (:116-127) running the slo-controller reconcilers
(nodemetric, noderesource, nodeslo — registered in
``options/controllers.go:34-39``), the quota-profile controller, and the
webhook server (``pkg/webhook/server.go:80``), all as ticking reconcile
loops gated on leadership.  State flows through a pluggable ``Cluster``
view (nodes/pods/NodeMetrics/configmaps) the way the reference flows
through the apiserver.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Mapping, Optional

from koordinator_tpu_torch.httpserving import (
    HTTPLifecycle,
    format_thread_stacks,
    reply_text,
)
from koordinator_tpu_torch.leaderelection import LeaderElector
from koordinator_tpu_torch.manager.nodemetric import reconcile_nodemetrics
from koordinator_tpu_torch.manager.noderesource import calculate_batch_resource
from koordinator_tpu_torch.manager.nodeslo import render_nodeslo
from koordinator_tpu_torch.manager.quota_profile import reconcile_profiles
from koordinator_tpu_torch.manager.sloconfig import ColocationStrategy


@dataclasses.dataclass
class ClusterView:
    """The manager's world state (the apiserver stand-in): callers supply
    getters; reconcilers write their outputs back through the setters."""

    nodes_fn: Callable[[], List[Mapping]] = lambda: []
    pods_fn: Callable[[], List[Mapping]] = lambda: []
    node_metrics_fn: Callable[[], Dict[str, Mapping]] = dict
    strategy_fn: Callable[[], ColocationStrategy] = ColocationStrategy
    quota_profiles_fn: Callable[[], List[Mapping]] = lambda: []
    # outputs
    nodemetric_specs: Dict[str, Optional[Dict]] = dataclasses.field(
        default_factory=dict
    )
    node_extended_resources: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict
    )
    nodeslos: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    quotas: Dict[str, Dict] = dataclasses.field(default_factory=dict)


class ManagerServer:
    """Leader-elected reconcile loops + healthz (+ optional webhook)."""

    def __init__(
        self,
        cluster: ClusterView,
        *,
        lease_path: str = "/tmp/koord-manager/leader.lease",
        identity: Optional[str] = None,
        resync_seconds: float = 60.0,
        http_host: str = "127.0.0.1",
        http_port: int = 0,
        webhook_cert_dir: Optional[str] = None,
    ):
        self.cluster = cluster
        self.resync_seconds = resync_seconds
        self.elector = LeaderElector(
            lease_path, identity or f"{socket.gethostname()}-{os.getpid()}"
        )
        self.reconciles = 0
        self.last_error: Optional[str] = None
        self.webhook = None
        if webhook_cert_dir:
            from koordinator_tpu_torch.manager.webhook_server import WebhookServer

            self.webhook = WebhookServer(webhook_cert_dir)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/debug/stacks":
                    reply_text(self, format_thread_stacks())
                    return
                doc = {
                    "ok": outer.last_error is None,
                    "leader": outer.elector.is_leader,
                    "reconciles": outer.reconciles,
                    "last_error": outer.last_error,
                }
                data = json.dumps(doc).encode()
                self.send_response(200 if self.path == "/healthz" else 404)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((http_host, http_port), Handler)
        self._http = HTTPLifecycle(self._httpd)

    @property
    def http_port(self) -> int:
        return self._httpd.server_address[1]

    # -- one reconcile pass over every controller ---------------------------
    def reconcile_once(self) -> None:
        c = self.cluster
        nodes = c.nodes_fn()
        pods = c.pods_fn()
        metrics = c.node_metrics_fn()
        strategy = c.strategy_fn()

        # nodemetric controller (slo-controller/nodemetric):
        # desired NodeMetric spec per node, None = GC
        c.nodemetric_specs = reconcile_nodemetrics(nodes, metrics, strategy)

        # noderesource controller (slo-controller/noderesource):
        # batch/mid overcommit -> node extended resources
        now = time.time()
        by_node: Dict[str, List[Mapping]] = {}
        for p in pods:
            if p.get("node"):
                by_node.setdefault(p["node"], []).append(p)
        c.node_extended_resources = {}
        for n in nodes:
            name = n.get("name", "")
            nm = metrics.get(name, {})
            result = calculate_batch_resource(
                strategy,
                n.get("allocatable", {}),
                None,
                n.get("kubelet_reserved"),
                nm.get("system_usage", {}),
                by_node.get(name, []),
                nm.get("pod_metrics", {}),
                metric_update_time=nm.get("update_time"),
                now=now,
            )
            c.node_extended_resources[name] = result.as_extended_resources()

        # nodeslo controller (slo-controller/nodeslo): per-node NodeSLO
        c.nodeslos = {
            n.get("name", ""): render_nodeslo(n.get("labels", {}) or {})
            for n in nodes
        }

        # quota-profile controller (pkg/quota-controller/profile)
        c.quotas = reconcile_profiles(c.quota_profiles_fn(), nodes)

        # webhook cert rotation tick rides the reconcile loop
        if self.webhook is not None:
            self.webhook.rotate_if_needed()
        self.reconciles += 1

    # -- loops --------------------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            if self.elector.is_leader:
                try:
                    self.reconcile_once()
                    self.last_error = None
                except Exception as exc:  # requeue like controller-runtime
                    self.last_error = str(exc)
                self._stop.wait(self.resync_seconds)
            else:
                self._stop.wait(self.elector.retry_period)

    def start(self) -> "ManagerServer":
        if self.webhook is not None:
            self.webhook.start()
        for target in (
            lambda: self.elector.run(),
            self._loop,
        ):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        self._http.start()
        return self

    def stop(self):
        self._stop.set()
        self.elector.stop()
        self._http.stop()
        if self.webhook is not None:
            self.webhook.stop()
        for t in self._threads[:2]:
            t.join(timeout=5)
