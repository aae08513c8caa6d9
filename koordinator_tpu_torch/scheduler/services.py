"""Scheduler debug/service REST API.

Reference: ``pkg/scheduler/frameworkext/services/services.go:44``
(``InstallAPIHandler`` mounts a gin engine; plugins implementing
``APIServiceProvider`` expose ``/apis/v1/plugins/<name>``; ``:104`` adds
``/apis/v1/nodes/:nodeName`` returning the cached NodeInfo).  Here the
same surface over the stdlib WSGI stack — no gin, no framework deps —
serving JSON views of the FrameworkExtender's plugin state and the
resident snapshot.  The port's copy of
``koordinator_tpu/scheduler/services.py``.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Tuple
from wsgiref.simple_server import WSGIServer, make_server

from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.obs.lockwitness import witness_lock

Handler = Callable[[Mapping[str, str]], Tuple[int, Any]]


class APIService:
    """Route registry: plugins register handlers under their name, the
    node endpoint reads the latest encoded snapshot."""

    def __init__(self):
        self._routes: Dict[str, Handler] = {}
        self._snapshot = None
        self._lock = witness_lock("scheduler.services.APIService._lock")

    # -- registration (APIServiceProvider.RegisterEndpoints analog) --
    def register_plugin(self, plugin_name: str, path: str, handler: Handler) -> None:
        with self._lock:
            self._routes[f"/apis/v1/plugins/{plugin_name}/{path.strip('/')}"] = handler

    def set_snapshot(self, snapshot) -> None:
        with self._lock:
            self._snapshot = snapshot

    # -- views --
    def _node_view(self, name: str) -> Tuple[int, Any]:
        snap = self._snapshot
        if snap is None:
            return 503, {"error": "no snapshot synced"}
        names = list(snap.nodes.names)
        if name not in names:
            return 404, {"error": f"node {name} not found"}
        i = names.index(name)

        def vec(arr):
            # one row to the host: numpy and tensors on any device alike
            row = arr[i].tolist()
            return {
                res.RESOURCE_AXIS[j]: int(v) for j, v in enumerate(row) if v
            }

        return 200, {
            "name": name,
            "allocatable": vec(snap.nodes.allocatable),
            "requested": vec(snap.nodes.requested),
            "usage": vec(snap.nodes.usage),
            "metricFresh": bool(snap.nodes.metric_fresh[i]),
        }

    def dispatch(self, path: str, query: Mapping[str, str]) -> Tuple[int, Any]:
        m = re.fullmatch(r"/apis/v1/nodes/([^/]+)", path)
        if m:
            return self._node_view(m.group(1))
        with self._lock:
            handler = self._routes.get(path)
        if handler is None:
            if path == "/apis/v1/plugins":
                with self._lock:
                    return 200, sorted(self._routes)
            return 404, {"error": f"no route {path}"}
        return handler(query)

    # -- WSGI --
    def wsgi_app(self, environ, start_response):
        path = environ.get("PATH_INFO", "/")
        query = dict(
            pair.split("=", 1)
            for pair in environ.get("QUERY_STRING", "").split("&")
            if "=" in pair
        )
        try:
            status, body = self.dispatch(path, query)
        except Exception as exc:  # handler bug -> 500, never kill the server
            status, body = 500, {"error": str(exc)}
        payload = json.dumps(body).encode()
        reasons = {200: "OK", 404: "Not Found", 500: "Internal", 503: "Unavailable"}
        start_response(
            f"{status} {reasons.get(status, 'Status')}",
            [("Content-Type", "application/json"),
             ("Content-Length", str(len(payload)))],
        )
        return [payload]

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> WSGIServer:
        server = make_server(host, port, self.wsgi_app)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server


def install_framework_endpoints(api: APIService, extender) -> None:
    """Mount the FrameworkExtender's debug state the way debug.go:32 and
    services.go:82 expose score tables and plugin internals."""

    def debug_scores(_q) -> Tuple[int, Any]:
        table = getattr(extender, "last_debug", None)
        return 200, {
            "scores": (
                None
                if table is None
                else (table.rows if hasattr(table, "rows") else table)
            ),
            "debug_top_n": extender.debug_top_n,
        }

    def set_debug_scores(q) -> Tuple[int, Any]:
        # runtime setter on its OWN route (reference debug.go:32-51: the
        # -debug-scores flag has live setters, not just a startup value);
        # the reader above stays a pure view so scrapes cannot mutate
        if "top_n" not in q:
            return 400, {"error": "missing top_n"}
        try:
            extender.debug_top_n = max(0, int(q["top_n"]))
        except ValueError:
            return 400, {"error": f"bad top_n {q['top_n']!r}"}
        if extender.debug_top_n == 0:
            # disabling must not leave a stale table served as live data
            extender.last_debug = None
        return 200, {"debug_top_n": extender.debug_top_n}

    def plugins_list(_q) -> Tuple[int, Any]:
        return 200, [p.name for p in extender.plugins]

    api.register_plugin("frameworkext", "debug-scores", debug_scores)
    api.register_plugin("frameworkext", "set-debug-scores", set_debug_scores)
    api.register_plugin("frameworkext", "plugins", plugins_list)
