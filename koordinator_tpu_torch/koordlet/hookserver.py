"""Remote runtime-hook dispatch: the koordlet-side hook server.

Reference: the runtime proxy does not run hooks in-process — it forwards
each CRI event to koordlet's hook gRPC server (the proto at
``apis/runtime/v1alpha1/api.proto:148 RuntimeHookService``, served by
``pkg/koordlet/runtimehooks/proxyserver``), and merges the returned
mutations into the request.  This module provides that process split
over the repo's framed-UDS transport:

* ``HookServer`` — runs in the koordlet process, owns the real
  ``HookRegistry``; serves framed JSON ContainerContext requests.
* ``RemoteHookRegistry`` — runs in the proxy process; a ``HookRegistry``
  look-alike whose ``run`` ships the context to the koordlet socket and
  applies the returned mutations, with the reference's failure-policy
  semantics left to the caller (an unreachable hook server raises, and
  ``RuntimeProxy``'s Ignore policy forwards the original request).
"""

from __future__ import annotations

import dataclasses
import socket
import threading
from typing import Dict, List, Optional

from koordinator_tpu_torch.koordlet.runtimehooks import ContainerContext, HookRegistry
from koordinator_tpu_torch.runtimeproxy_server import (
    _UdsServer,
    recv_frame,
    send_frame,
)

# context fields the wire protocol carries (mutations flow back for the
# writable subset, mirroring the proto's ContainerResourceHookResponse)
_MUTABLE = (
    "cfs_quota_us",
    "cpu_shares",
    "cpuset_cpus",
    "bvt_warp_ns",
    "memory_limit_bytes",
)


def _ctx_to_doc(stage: str, ctx: ContainerContext) -> Dict:
    doc = dataclasses.asdict(ctx)
    doc["__stage__"] = stage
    return doc


def _doc_to_ctx(doc: Dict) -> ContainerContext:
    fields = {f.name for f in dataclasses.fields(ContainerContext)}
    return ContainerContext(**{k: v for k, v in doc.items() if k in fields})


class HookServer(_UdsServer):
    """koordlet-side hook service (proxyserver role)."""

    def __init__(self, path: str, registry: HookRegistry):
        self.registry = registry

        def handle(doc: Dict) -> Dict:
            stage = doc.pop("__stage__", "")
            ctx = _doc_to_ctx(doc)
            ran = self.registry.run(stage, ctx)
            out = dataclasses.asdict(ctx)
            out["__ran__"] = ran
            return out

        super().__init__(path, handle)


class RemoteHookRegistry:
    """Proxy-side stand-in for HookRegistry: dispatches over UDS.

    One connection PER SERVING THREAD (threading.local, the same scheme
    as CRIProxyServer._backend_conn): replies on a stream socket are
    matched by read order, so a connection shared across the proxy's
    concurrent serving threads would hand one container another
    container's mutations."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()

    def _connect(self) -> socket.socket:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.connect(self.path)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def run(self, stage: str, ctx: ContainerContext) -> List[str]:
        try:
            conn = self._connect()
            send_frame(conn, _ctx_to_doc(stage, ctx))
            reply = recv_frame(conn)
        except OSError:
            self._drop_thread_conn()
            raise ConnectionError(
                f"hook server unreachable at {self.path}"
            ) from None
        if reply is None:
            self._drop_thread_conn()
            raise ConnectionError("hook server closed the connection")
        if "error" in reply and "__ran__" not in reply:
            raise RuntimeError(reply["error"])
        # apply the returned mutations onto the caller's context
        for field in _MUTABLE:
            setattr(ctx, field, reply.get(field))
        ctx.env.update(reply.get("env") or {})
        return list(reply.get("__ran__") or [])

    def _drop_thread_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            finally:
                self._local.conn = None
                with self._conns_lock:
                    if conn in self._conns:
                        self._conns.remove(conn)

    def close(self) -> None:
        """Close every thread's connection (proxy shutdown)."""
        with self._conns_lock:
            for conn in self._conns:
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
        self._local = threading.local()
