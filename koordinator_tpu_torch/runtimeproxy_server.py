"""koord-runtime-proxy as a real UDS process boundary.

The reference interposes between kubelet and containerd as a gRPC server
on a unix socket, re-registering RuntimeService and forwarding to the
real runtime's socket (``pkg/runtimeproxy/server/cri/criserver.go:93-97``;
``cmd/koord-runtime-proxy/main.go:58-66``).  The in-process
``RuntimeProxy`` dispatcher (runtimeproxy.py) proves the hook semantics;
this module gives it the PROCESS boundary:

* ``CRIProxyServer`` listens on ``listen_path`` and forwards every call
  to the backend runtime's socket at ``backend_path`` after the pre-stage
  hooks, dispatching post-stage hooks with the backend's actual response.
* frames are length-prefixed JSON CRI requests (u32 length + payload) —
  the image has no grpc++/containerd, and the framing is the same one the
  native bridge client speaks (bridge/udsserver.py), so the boundary is
  crossable from C++ too.
* ``FakeRuntimeServer`` stands in for containerd in tests/standalone use
  (the reference tests against a fake CRI runtime the same way,
  ``pkg/koordlet/util/runtime/handler/fake_runtime.go``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
import threading
from typing import Callable, Dict, Mapping, Optional

from koordinator_tpu_torch.bridge.acceptloop import join_unless_current, wake_accept_loop
from koordinator_tpu_torch.runtimeproxy import CRIRequest, FailurePolicy, RuntimeProxy

_LEN = struct.Struct(">I")


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def send_frame(conn: socket.socket, doc: Mapping) -> None:
    payload = json.dumps(doc).encode()
    conn.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(conn: socket.socket) -> Optional[Dict]:
    header = _recv_exact(conn, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    payload = _recv_exact(conn, length)
    if payload is None:
        return None
    return json.loads(payload)


def _req_from_doc(doc: Mapping) -> CRIRequest:
    fields = {f.name for f in dataclasses.fields(CRIRequest)}
    return CRIRequest(**{k: v for k, v in doc.items() if k in fields})


def _req_to_doc(req: CRIRequest) -> Dict:
    return dataclasses.asdict(req)


class _UdsServer:
    """Minimal threaded UDS server handling framed JSON requests."""

    def __init__(self, path: str, handler: Callable[[Dict], Dict]):
        self.path = path
        self.handler = handler
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(8)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            wake_accept_loop(self.path, self._thread)
            self._sock.close()
        finally:
            if os.path.exists(self.path):
                os.unlink(self.path)
            join_unless_current(self._thread)

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stop.is_set():
                conn.close()  # the wake-up connection of stop()
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket):
        with conn:
            while not self._stop.is_set():
                doc = recv_frame(conn)
                if doc is None:
                    return
                try:
                    send_frame(conn, self.handler(doc))
                except Exception as exc:  # surface, don't kill the conn
                    send_frame(conn, {"error": str(exc)})


class FakeRuntimeServer(_UdsServer):
    """containerd stand-in: records calls, echoes requests as responses
    (fake_runtime.go role)."""

    def __init__(self, path: str):
        self.calls = []
        self.response_extras: Dict[str, Dict] = {}

        def handle(doc: Dict) -> Dict:
            self.calls.append(doc.get("call"))
            resp = dict(doc)
            resp.update(self.response_extras.get(doc.get("call", ""), {}))
            resp["handled_by"] = "fake-runtime"
            return resp

        super().__init__(path, handle)


class CRIProxyServer:
    """The interposer process: kubelet-side UDS in, runtime UDS out."""

    def __init__(
        self,
        listen_path: str,
        backend_path: str,
        registry,
        failure_policy: FailurePolicy = FailurePolicy.IGNORE,
    ):
        self.backend_path = backend_path
        self._local = threading.local()
        self._conns: list = []  # every thread's backend socket, for stop()
        self._conns_lock = threading.Lock()
        self.proxy = RuntimeProxy(
            registry, self._call_backend, failure_policy=failure_policy
        )
        self._server = _UdsServer(listen_path, self._handle)

    def start(self):
        self._server.start()
        return self

    def stop(self):
        self._server.stop()
        with self._conns_lock:
            for conn in self._conns:
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()

    # one backend connection per serving thread
    def _backend_conn(self) -> socket.socket:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.connect(self.backend_path)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def _call_backend(self, req: CRIRequest) -> Mapping:
        conn = self._backend_conn()
        send_frame(conn, _req_to_doc(req))
        resp = recv_frame(conn)
        if resp is None:
            raise ConnectionError("runtime backend closed the connection")
        return resp

    def _handle(self, doc: Dict) -> Dict:
        req = _req_from_doc(doc)
        resp = self.proxy.intercept(req)
        return dict(resp)


class CRIProxyClient:
    """kubelet stand-in for tests/tools."""

    def __init__(self, path: str):
        self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._conn.connect(path)

    def call(self, req: CRIRequest) -> Dict:
        send_frame(self._conn, _req_to_doc(req))
        resp = recv_frame(self._conn)
        if resp is None:
            raise ConnectionError("proxy closed the connection")
        return resp

    def close(self):
        self._conn.close()
