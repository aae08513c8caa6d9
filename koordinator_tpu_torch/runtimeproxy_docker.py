"""koord-runtime-proxy docker path: an HTTP reverse proxy for dockerd.

Reference ``pkg/runtimeproxy/server/docker``: the proxy serves the docker
API between kubelet (dockershim) and dockerd, intercepting
``POST /(vX.Y/)?containers/create`` (``server.go:64``) to run the hook
chain and merge cgroup mutations into the request's HostConfig before
forwarding; every other request passes through the reverse proxy
untouched (``pkg/util/httputil`` reverse proxy).
"""

from __future__ import annotations

import http.client
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional, Tuple

from koordinator_tpu_torch.httpserving import HTTPLifecycle
from koordinator_tpu_torch.koordlet.runtimehooks import ContainerContext, HookRegistry
from koordinator_tpu_torch.runtimeproxy import FailurePolicy

_CREATE_RE = re.compile(r"^/(v\d\.\d+/)?containers/create$")

_HOP_HEADERS = {
    "connection",
    "keep-alive",
    "proxy-authenticate",
    "proxy-authorization",
    "te",
    "trailers",
    "transfer-encoding",
    "upgrade",
    "host",
    "content-length",
}


class DockerProxyServer:
    """HTTP interposer in front of a dockerd endpoint (host, port)."""

    def __init__(
        self,
        registry: HookRegistry,
        backend: Tuple[str, int],
        host: str = "127.0.0.1",
        port: int = 0,
        failure_policy: FailurePolicy = FailurePolicy.IGNORE,
    ):
        self.registry = registry
        self.backend = backend
        self.failure_policy = failure_policy
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _proxy(self, body: Optional[bytes]):
                try:
                    conn = http.client.HTTPConnection(
                        *outer.backend, timeout=30
                    )
                    headers = {
                        k: v
                        for k, v in self.headers.items()
                        if k.lower() not in _HOP_HEADERS
                    }
                    conn.request(
                        self.command, self.path, body=body, headers=headers
                    )
                    resp = conn.getresponse()
                except OSError as exc:
                    # backend down: a structured 502, not a TCP reset
                    self._error(502, f"runtime backend unavailable: {exc}")
                    return
                length = resp.getheader("Content-Length")
                self.send_response(resp.status)
                for k, v in resp.getheaders():
                    if k.lower() not in _HOP_HEADERS:
                        self.send_header(k, v)
                if length is not None:
                    self.send_header("Content-Length", length)
                    self.end_headers()
                    remaining = int(length)
                    while remaining > 0:
                        chunk = resp.read(min(65536, remaining))
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        remaining -= len(chunk)
                else:
                    # unbounded/streaming endpoint (events, logs?follow):
                    # stream chunks through, close-delimited — never buffer
                    # the whole body (it may never end)
                    self.send_header("Connection", "close")
                    self.end_headers()
                    while True:
                        chunk = resp.read(65536)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        self.wfile.flush()
                    self.close_connection = True
                conn.close()

            def _error(self, code: int, message: str):
                data = json.dumps({"message": message}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._proxy(None)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                if _CREATE_RE.match(self.path.split("?")[0]):
                    try:
                        body = outer._intercept_create(body)
                    except Exception as exc:  # FAIL policy: structured 500
                        self._error(500, f"hook chain failed: {exc}")
                        return
                self._proxy(body)

            do_DELETE = do_GET

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._http = HTTPLifecycle(self._httpd)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "DockerProxyServer":
        self._http.start()
        return self

    def stop(self):
        self._http.stop()

    # -- create interception (docker/handler.go HandleCreateContainer) --
    def _intercept_create(self, body: bytes) -> bytes:
        try:
            doc = json.loads(body or b"{}")
        except ValueError:
            return body  # passthrough on unparseable body
        labels = doc.get("Labels") or {}
        # explicit JSON null must not crash the interposer
        host_config = doc.get("HostConfig") or {}
        doc["HostConfig"] = host_config
        ctx = ContainerContext(
            pod_uid=labels.get("io.kubernetes.pod.uid", ""),
            container_name=labels.get("io.kubernetes.container.name", ""),
            qos=labels.get("koordinator.sh/qosClass", ""),
            pod_labels=dict(labels),
            # dockershim stores pod annotations as "annotation."-prefixed
            # labels; annotation-reading hooks (cpuset, device env) need
            # them back under their bare keys
            pod_annotations={
                k[len("annotation."):]: v
                for k, v in labels.items()
                if k.startswith("annotation.")
            },
            cgroup_dir=host_config.get("CgroupParent", ""),
            cfs_quota_us=host_config.get("CpuQuota"),
            cpu_shares=host_config.get("CpuShares"),
            cpuset_cpus=host_config.get("CpusetCpus"),
            memory_limit_bytes=host_config.get("Memory"),
        )
        try:
            self.registry.run("PreCreateContainer", ctx)
        except Exception:
            if self.failure_policy == FailurePolicy.FAIL:
                raise
            return body  # Ignore: forward the original request untouched
        if ctx.cfs_quota_us is not None:
            host_config["CpuQuota"] = ctx.cfs_quota_us
        if ctx.cpu_shares is not None:
            host_config["CpuShares"] = ctx.cpu_shares
        if ctx.cpuset_cpus is not None:
            host_config["CpusetCpus"] = ctx.cpuset_cpus
        if ctx.memory_limit_bytes is not None:
            host_config["Memory"] = ctx.memory_limit_bytes
        env = doc.get("Env") or []
        doc["Env"] = env
        for k, v in ctx.env.items():
            env.append(f"{k}={v}")
        return json.dumps(doc).encode()
