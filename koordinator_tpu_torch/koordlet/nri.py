"""NRI-mode hook delivery: the runtime-initiated event subscription path.

Reference: ``pkg/koordlet/runtimehooks/nri/server.go`` — koordlet runs as
an NRI plugin: it DIALS the runtime's NRI socket, registers a
subscription (plugin name/index + event set), and from then on the
RUNTIME calls the plugin over that same connection (reverse RPC over
ttrpc): ``Synchronize`` replays existing pods/containers,
``CreateContainer`` (server.go:165) returns a ContainerAdjustment the
runtime applies, ``UpdateContainer``/``RemoveContainer`` follow the
container lifecycle.  This is the modern delivery mode beside the CRI
proxy (runtimeproxy_server.py) and the standalone reconciler
(runtimehooks.Reconciler).

This module reproduces that structure over the repo's framed-JSON UDS
transport (runtimeproxy_server send_frame/recv_frame standing in for
ttrpc):

* ``NriPlugin`` — koordlet side: dials, registers, then serves runtime
  events from the SAME connection, running the shared ``HookRegistry``
  and replying ContainerAdjustment-style documents.
* ``NriRuntime`` — runtime side (containerd's role; used by tests and
  the e2e smoke): owns the socket, accepts one plugin registration,
  emits lifecycle events, and applies returned adjustments to cgroup
  parameters via ``apply_adjustment``.

All three delivery modes feed the SAME registry, so a container created
through NRI mode gets byte-identical cgroup mutations to one handled by
the reconciler (tests/test_nri.py asserts it).
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Dict, List, Optional

from koordinator_tpu_torch.bridge.acceptloop import join_unless_current, wake_accept_loop
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    ResourceUpdate,
    ResourceUpdateExecutor,
)
from koordinator_tpu_torch.koordlet.runtimehooks import (
    ContainerContext,
    HookRegistry,
    POST_STOP_POD_SANDBOX,
    PRE_CREATE_CONTAINER,
    PRE_UPDATE_CONTAINER,
)
from koordinator_tpu_torch.runtimeproxy_server import recv_frame, send_frame

# event names mirror the NRI stub callbacks the reference subscribes to
# (nri/server.go Subscribe mask)
EVENT_RUN_POD_SANDBOX = "RunPodSandbox"
EVENT_STOP_POD_SANDBOX = "StopPodSandbox"
EVENT_CREATE_CONTAINER = "CreateContainer"
EVENT_UPDATE_CONTAINER = "UpdateContainer"
EVENT_REMOVE_CONTAINER = "RemoveContainer"
EVENT_SYNCHRONIZE = "Synchronize"

DEFAULT_EVENTS = (
    EVENT_RUN_POD_SANDBOX,
    EVENT_STOP_POD_SANDBOX,
    EVENT_CREATE_CONTAINER,
    EVENT_UPDATE_CONTAINER,
    EVENT_REMOVE_CONTAINER,
)


def _adjustment_from_ctx(ctx: ContainerContext) -> Dict:
    """ContainerAdjustment-style reply document (the shape of NRI's
    api.ContainerAdjustment: linux resources + env), carrying only the
    fields hooks actually set."""
    linux: Dict = {}
    cpu: Dict = {}
    if ctx.cfs_quota_us is not None:
        cpu["quota"] = ctx.cfs_quota_us
    if ctx.cpu_shares is not None:
        cpu["shares"] = ctx.cpu_shares
    if ctx.cpuset_cpus is not None:
        cpu["cpus"] = ctx.cpuset_cpus
    if cpu:
        linux["cpu"] = cpu
    if ctx.memory_limit_bytes is not None:
        linux["memory"] = {"limit": ctx.memory_limit_bytes}
    if ctx.bvt_warp_ns is not None:
        # koord-specific cgroup knob rides the adjustment like the
        # reference's bvt writes ride its protocol objects
        linux["bvt_warp_ns"] = ctx.bvt_warp_ns
    out: Dict = {}
    if linux:
        out["linux"] = {"resources": linux}
    if ctx.env:
        out["env"] = [{"key": k, "value": v} for k, v in ctx.env.items()]
    return out


def apply_adjustment(
    adjustment: Dict,
    cgroup_dir: str,
    executor: ResourceUpdateExecutor,
    now: float = 0.0,
) -> int:
    """Runtime-side application of a ContainerAdjustment to cgroup
    parameters (what containerd does with the NRI reply).  Uses the same
    ResourceUpdate names as the reconciler so the two delivery modes are
    directly comparable."""
    res = (adjustment.get("linux") or {}).get("resources") or {}
    cpu = res.get("cpu") or {}
    updates: List[ResourceUpdate] = []
    if "quota" in cpu:
        updates.append(ResourceUpdate("cpu.cfs_quota", cgroup_dir, str(cpu["quota"])))
    if "shares" in cpu:
        updates.append(ResourceUpdate("cpu.shares", cgroup_dir, str(cpu["shares"])))
    if "bvt_warp_ns" in res:
        updates.append(
            ResourceUpdate("cpu.bvt_warp_ns", cgroup_dir, str(res["bvt_warp_ns"]))
        )
    if "cpus" in cpu:
        updates.append(ResourceUpdate("cpuset.cpus", cgroup_dir, cpu["cpus"]))
    if "memory" in res and "limit" in res["memory"]:
        updates.append(
            ResourceUpdate("memory.limit", cgroup_dir, str(res["memory"]["limit"]))
        )
    return executor.update_batch(updates, now)


class NriPlugin:
    """koordlet as an NRI plugin: dial, register, serve runtime events
    from the same connection (reference nri/server.go)."""

    def __init__(
        self,
        socket_path: str,
        registry: HookRegistry,
        plugin_name: str = "koordlet",
        plugin_index: str = "00",
        events: tuple = DEFAULT_EVENTS,
        register_timeout: float = 10.0,
    ):
        self.registry = registry
        self.plugin_name = plugin_name
        self.plugin_index = plugin_index
        self.events = tuple(events)
        self.pods: Dict[str, Dict] = {}  # pod uid -> sandbox doc
        self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # bounded registration: connect() can succeed via the listen
        # backlog while nothing is accepting — an unbounded recv here
        # would hang the whole constructor (and the koordlet daemon)
        self._conn.settimeout(register_timeout)
        try:
            self._conn.connect(socket_path)
            send_frame(
                self._conn,
                {
                    "type": "register",
                    "plugin_name": plugin_name,
                    "plugin_index": plugin_index,
                    "events": list(self.events),
                },
            )
            ack = recv_frame(self._conn)
        except socket.timeout as exc:
            self._conn.close()
            raise RuntimeError(
                f"NRI registration timed out after {register_timeout}s"
            ) from exc
        except OSError:
            self._conn.close()
            raise
        if not ack or not ack.get("ok"):
            self._conn.close()
            raise RuntimeError(f"NRI registration rejected: {ack!r}")
        self._conn.settimeout(None)  # event loop blocks until close()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        try:
            self._conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._conn.close()
        join_unless_current(self._thread)

    # -- event loop (runtime -> plugin reverse RPC) --
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                doc = recv_frame(self._conn)
            except OSError:
                return  # close() raced the blocking recv (EBADF/shutdown)
            if doc is None:
                return
            try:
                reply = self._dispatch(doc)
            except Exception as exc:  # surfaced to the runtime, not lost
                reply = {"error": str(exc)}
            try:
                send_frame(self._conn, reply)
            except OSError:
                return  # runtime dropped the connection mid-reply

    def _ctx_for(self, pod_uid: str, container: Dict) -> ContainerContext:
        pod = self.pods.get(pod_uid, {})
        return ContainerContext(
            pod_name=pod.get("name", ""),
            pod_uid=pod_uid,
            container_name=container.get("name", ""),
            qos=pod.get("labels", {}).get("koordinator.sh/qosClass", ""),
            priority_class=pod.get("priority_class", ""),
            pod_annotations=pod.get("annotations", {}),
            pod_labels=pod.get("labels", {}),
            requests=pod.get("requests", {}),
            limits=pod.get("limits", {}),
            cgroup_dir=container.get("cgroup_dir", ""),
        )

    def _dispatch(self, doc: Dict) -> Dict:
        event = doc.get("event", "")
        if event not in self.events and event != EVENT_SYNCHRONIZE:
            return {}
        if event == EVENT_RUN_POD_SANDBOX:
            pod = doc.get("pod", {})
            self.pods[pod.get("uid", "")] = pod
            return {}
        if event == EVENT_STOP_POD_SANDBOX:
            pod = doc.get("pod", {})
            ctx = self._ctx_for(pod.get("uid", ""), {})
            self.registry.run(POST_STOP_POD_SANDBOX, ctx)
            self.pods.pop(pod.get("uid", ""), None)
            return {}
        if event == EVENT_CREATE_CONTAINER:
            ctx = self._ctx_for(
                doc.get("pod", {}).get("uid", ""), doc.get("container", {})
            )
            self.registry.run(PRE_CREATE_CONTAINER, ctx)
            return {"adjustment": _adjustment_from_ctx(ctx)}
        if event == EVENT_UPDATE_CONTAINER:
            ctx = self._ctx_for(
                doc.get("pod", {}).get("uid", ""), doc.get("container", {})
            )
            self.registry.run(PRE_UPDATE_CONTAINER, ctx)
            return {"update": _adjustment_from_ctx(ctx)}
        if event == EVENT_REMOVE_CONTAINER:
            return {}
        if event == EVENT_SYNCHRONIZE:
            # replay of existing state on (re)connect: rebuild the pod
            # store and return updates for running containers
            # (reference Synchronize returns []*ContainerUpdate)
            updates = []
            for pod in doc.get("pods", []):
                self.pods[pod.get("uid", "")] = pod
            for c in doc.get("containers", []):
                ctx = self._ctx_for(c.get("pod_uid", ""), c)
                self.registry.run(PRE_UPDATE_CONTAINER, ctx)
                adj = _adjustment_from_ctx(ctx)
                if adj:
                    updates.append({"container": c.get("name", ""), "update": adj})
            return {"updates": updates}
        return {}


class NriRuntime:
    """The runtime's side of the NRI socket (containerd's role): owns the
    listener, accepts one plugin registration, emits lifecycle events and
    returns the plugin's adjustments.  Production containerd speaks real
    NRI; this server exists for tests, the e2e smoke, and any
    CRI-implementation that wants to drive the plugin directly."""

    def __init__(self, socket_path: str):
        import os

        self.path = socket_path
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        os.makedirs(os.path.dirname(socket_path) or ".", exist_ok=True)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(socket_path)
        self._sock.listen(2)
        self._conn: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self.plugin: Optional[Dict] = None
        self._closed = threading.Event()
        self._accepting: Optional[threading.Thread] = None
        self._accepted = threading.Event()

    def accept_plugin(self, timeout: float = 5.0) -> Dict:
        self._sock.settimeout(timeout)
        self._accepted.clear()
        self._accepting = threading.current_thread()
        try:
            conn, _ = self._sock.accept()
        finally:
            self._accepting = None
            self._accepted.set()
        if self._closed.is_set():
            conn.close()  # the wake-up connection of close()
            raise RuntimeError("NRI runtime closed while accepting")
        reg = recv_frame(conn)
        if not reg or reg.get("type") != "register":
            send_frame(conn, {"ok": False, "error": "expected registration"})
            conn.close()
            raise RuntimeError(f"bad NRI registration: {reg!r}")
        send_frame(conn, {"ok": True})
        self._conn = conn
        self.plugin = reg
        return reg

    def event(self, doc: Dict) -> Dict:
        """Send one lifecycle event; returns the plugin's reply.  Serialized
        under a lock: NRI replies are matched by order on the stream."""
        with self._lock:
            assert self._conn is not None, "no plugin registered"
            send_frame(self._conn, doc)
            reply = recv_frame(self._conn)
            if reply is None:
                raise RuntimeError("NRI plugin connection closed")
            if "error" in reply:
                raise RuntimeError(f"NRI plugin error: {reply['error']}")
            return reply

    def close(self) -> None:
        self._closed.set()
        accepting = self._accepting
        if accepting is not None:
            # the listening socket stays open until accept() has returned
            wake_accept_loop(self.path, accepting)
            self._accepted.wait(timeout=5.0)
        if self._conn is not None:
            self._conn.close()
        self._sock.close()
        import os

        if os.path.exists(self.path):
            os.unlink(self.path)
