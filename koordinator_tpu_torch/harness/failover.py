"""The reference's ``failover`` and ``coldstart`` legs with every daemon in
a process of its own.

Counterpart of ``bench.py --config failover`` (``bench.py:3998-4360``) and
``--config coldstart`` (``bench.py:4362+``).  Each daemon here is a real
``python -m koordinator_tpu_torch.scheduler.server`` process (:class:`Daemon`),
driven over its raw socket (``<uds>.raw``) and read over HTTP: ``/healthz``
for its role, journal and ledger, ``/debug/process`` for its boot stamps,
journal counters and kernel launch counts, ``/debug/last-cycle`` for the
digests of its last Assign's five ``CycleResult`` arrays.

* :func:`failover_leg`: a journaled leader and a follower
  (``--replicate-from``); one full Sync and ``DELTAS`` delta Syncs; a read
  storm of flat Scores on the follower; then **leg A**, SIGKILL the leader
  and restart it on the same state directory (the journal replays onto the
  same ``s<epoch>-<gen>`` chain), and **leg B**, SIGKILL it again and
  promote the follower with SIGUSR2.  After each recovery a no-change
  Sync is acknowledged, then two Assigns: the first warms the kernel, the
  second must add no build and no demotion, and both must equal ``want``
  (the caller's ``result_digests`` of the same cluster's cycle).  The
  delta Syncs bump and then restore one node's usage in pairs, so the
  cluster the recovered daemons place is the one synced first.
* :func:`coldstart_leg`: two boots on one state directory and one kernel
  build directory, the first with nothing built and no prewarm record, the
  second with ``--prewarm`` replaying what the first recorded; each timed
  from spawn to its first served flat Score and to its first served
  Assign, with the Score and Assign replies equal between the boots.
* :func:`candidate_build_leg`: the reference's third coldstart leg, in
  the calling process: the serial and the pipelined cold candidate builds
  (``KOORD_PARALLEL_BUILD=0``/``1``), byte-equal.

Every wait has a time limit, every process is reaped, and each leg checks
that none is left.  ``device=None`` runs the daemons on the card; tests pass
``device="cpu"``.  Socket paths live under ``base``, which must be short (a
unix socket address holds 107 bytes).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

import numpy as np

WAIT_S = 180.0
RPC_TIMEOUT_S = 120.0
STORM_THREADS = 4
STORM_K = 8
# delta Syncs before the storm, in bump/restore pairs (bench.py's default)
DELTAS = 8
_POLL_S = 0.01

# the raw framing's methods (bridge/udsserver.py)
METHOD_SYNC, METHOD_SCORE, METHOD_ASSIGN = 1, 2, 3

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ms(t0: float, t1: Optional[float] = None) -> float:
    return ((time.perf_counter() if t1 is None else t1) - t0) * 1e3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def raw_call(path: str, method: int, payload: bytes, timeout: float = RPC_TIMEOUT_S):
    """(status, body) of one raw-framing call on a fresh connection;
    raises ``OSError`` when the daemon is not there or drops the call."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout)
    try:
        conn.connect(path)
        conn.sendall(struct.pack(">BI", method, len(payload)) + payload)
        head = _recv(conn, 5)
        status, length = struct.unpack(">BI", head)
        return status, _recv(conn, length)
    finally:
        conn.close()


def _recv(conn: socket.socket, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = conn.recv(min(n - len(out), 1 << 22))
        if not chunk:
            raise ConnectionError("the daemon closed the connection mid-reply")
        out.extend(chunk)
    return bytes(out)


def wait_until(what: str, predicate: Callable[[], object], timeout_s: float = WAIT_S,
               alive: Optional[Callable[[], None]] = None):
    """``predicate()``'s first truthy value, polled; ``alive()`` raises when
    the process waited on has died.  Fails past ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = predicate()
        if got:
            return got
        if alive is not None:
            alive()
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} did not happen within {timeout_s} s")
        time.sleep(_POLL_S)


class Daemon:
    """One scheduler daemon process (``--no-grpc``: the raw framing only)."""

    def __init__(self, base: str, name: str, *, device=None, journal: bool = False,
                 replicate_from: Optional[str] = None, prewarm: bool = False,
                 kernel_build_dir: Optional[str] = None, devprof_sample: int = 0):
        self.name = name
        self.sock = os.path.join(base, f"{name}.sock")
        self.raw = self.sock + ".raw"
        self.repl = self.sock + ".repl"
        self.state_dir = os.path.join(base, name)
        self.port = free_port()
        self.log_path = os.path.join(base, f"{name}.log")
        args = [sys.executable, "-m", "koordinator_tpu_torch.scheduler.server", "--no-grpc",
                "--uds", self.sock, "--lease", os.path.join(base, f"{name}.lease"),
                "--identity", name, "--state-dir", self.state_dir,
                "--http-port", str(self.port)]
        if device is not None:
            args += ["--device", str(device)]
        if journal:
            args.append("--journal")
        if replicate_from:
            args += ["--replicate-from", replicate_from]
        if prewarm:
            args.append("--prewarm")
        if kernel_build_dir:
            args += ["--kernel-build-dir", kernel_build_dir]
        if devprof_sample:
            args += ["--devprof-sample", str(devprof_sample)]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, env.get("PYTHONPATH", "")) if p)
        self.spawned = time.time()
        self.spawned_pc = time.perf_counter()
        with open(self.log_path, "ab") as log:
            self.proc = subprocess.Popen(args, cwd=_REPO, env=env, stdin=subprocess.DEVNULL,
                                         stdout=subprocess.DEVNULL, stderr=log)

    def log_tail(self, n: int = 3000) -> str:
        try:
            with open(self.log_path, "rb") as fh:
                return fh.read()[-n:].decode(errors="replace")
        except OSError:
            return ""

    def alive(self) -> None:
        """Raise when the process has exited."""
        if self.proc.poll() is not None:
            raise AssertionError(f"daemon {self.name} exited ({self.proc.returncode}):\n"
                                 f"{self.log_tail()}")

    def get(self, path: str) -> Optional[dict]:
        """The JSON document at ``path``, or None while the daemon does not
        answer it."""
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                        timeout=RPC_TIMEOUT_S) as r:
                return json.loads(r.read())
        except (OSError, ValueError, urllib.error.URLError):
            return None

    def wait(self, what: str, predicate, timeout_s: float = WAIT_S):
        return wait_until(f"{self.name}: {what}", predicate, timeout_s, self.alive)

    def call(self, method: int, payload: bytes) -> bytes:
        status, body = raw_call(self.raw, method, payload)
        if status != 0:
            raise AssertionError(f"{self.name}: method {method} answered {status}: "
                                 f"{body[:300]!r}")
        return body

    def first_ack(self, method: int, payload: bytes, timeout_s: float = WAIT_S) -> tuple:
        """(reply body, perf_counter at the reply) of the first call the
        daemon serves, sent as soon as its socket accepts."""
        def attempt():
            try:
                return self.call(method, payload), time.perf_counter()
            except OSError:
                return None

        return self.wait(f"the first served method {method}", attempt, timeout_s)

    def kill(self) -> float:
        """SIGKILL and reap; returns when the process is gone."""
        self.proc.kill()
        self.proc.wait(timeout=WAIT_S)
        return time.perf_counter()

    def stop(self) -> int:
        """SIGINT (the daemon stops its servers and dumps its prewarm record),
        SIGKILL if it does not exit."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=WAIT_S)
        return self.proc.returncode

    def boot_split(self, ack_pc: float, journal_replay_ms: float = 0.0) -> dict:
        """Spawn to the first acknowledged call, split at this process's
        boot stamps (``/debug/process``): spawn to imports done (the
        interpreter and ``import torch``), the CUDA context, the journal
        replay, the rest of the server's construction and start, and the
        first call from the transports binding to its reply."""
        boot = (self.get("/debug/process") or {}).get("boot", {})
        imported, ready, bound = (boot.get(k) for k in ("imported", "device_ready",
                                                        "transports"))
        total = _ms(self.spawned_pc, ack_pc)
        if None in (imported, ready, bound):
            return {"total_ms": total}
        return {
            "total_ms": total,
            "spawn_to_import_ms": (imported - self.spawned) * 1e3,
            "cuda_init_ms": (ready - imported) * 1e3,
            "journal_replay_ms": journal_replay_ms,
            "server_start_ms": (bound - ready) * 1e3 - journal_replay_ms,
            "first_ack_ms": total - (bound - self.spawned) * 1e3,
        }


def _reap(daemons) -> None:
    for d in daemons:
        d.stop()
    left = [d.name for d in daemons if d.proc.poll() is None]
    if left:
        raise AssertionError(f"daemon processes left: {left}")


# -- frames --

def sync_frames(lists, deltas: int):
    """(full Sync bytes, [delta Sync bytes], no-change Sync bytes) of the
    cluster ``lists`` (nodes, pods, gangs, quotas): the deltas bump one
    node's cpu usage and restore it, in pairs, so the state after them is
    the full Sync's."""
    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.bridge.state import numpy_to_tensor, tensor_to_numpy
    from koordinator_tpu_torch.harness.golden import build_sync_request

    if deltas % 2:
        raise ValueError(f"deltas come in bump/restore pairs, got {deltas}")
    nodes, pods, gangs, quotas = lists
    req, _ = build_sync_request(nodes, pods, gangs, quotas, node_bucket=len(nodes),
                                pod_bucket=len(pods))
    base = tensor_to_numpy(req.nodes.usage, None)
    frames, prev = [], base
    for i in range(deltas):
        cur = base
        if i % 2 == 0:
            cur = base.copy()
            cur[(i * 97) % cur.shape[0], 0] += 1 + i
        msg = wire.SyncRequest()
        msg.nodes.usage.CopyFrom(numpy_to_tensor(cur, prev))
        frames.append(msg.SerializeToString())
        prev = cur
    return req.SerializeToString(), frames, wire.SyncRequest().SerializeToString()


def _sid(body: bytes) -> str:
    from koordinator_tpu_torch.bridge import wire

    return wire.SyncReply.FromString(body).snapshot_id


def score_digest(body: bytes) -> str:
    """sha256 of a Score reply with its timing and span fields cleared."""
    from koordinator_tpu_torch.bridge import wire

    reply = wire.ScoreReply.FromString(body)
    reply.build_ms = 0.0
    reply.server_span = ""
    return hashlib.sha256(reply.SerializeToString()).hexdigest()


def assign_digest(body: bytes) -> str:
    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.harness.anchor import cycle_digest

    reply = wire.AssignReply.FromString(body)
    return cycle_digest(np.asarray(reply.assignment), np.asarray(reply.status))


def _score_payload() -> bytes:
    from koordinator_tpu_torch.bridge import wire

    return wire.ScoreRequest(top_k=STORM_K, flat=True).SerializeToString()


def _assign_payload() -> bytes:
    from koordinator_tpu_torch.bridge import wire

    return wire.AssignRequest().SerializeToString()


def _on_card(device) -> bool:
    return device is None or str(device).startswith("cuda")


def _checked_assigns(d: Daemon, noop: bytes, want: dict, device) -> dict:
    """Two Assigns on a recovered daemon, a no-change Sync between them:
    the first warms the kernel; the second must build nothing, demote
    nothing and launch one kernel (none on the CPU); both equal ``want``."""
    out = {}
    for i in range(2):
        if i:
            d.call(METHOD_SYNC, noop)
            before = d.get("/debug/process")
            ledger_before = d.get("/healthz")["device"]["compiles"]
        t0 = time.perf_counter()
        body = d.call(METHOD_ASSIGN, _assign_payload())
        out[f"assign_{i}_ms"] = _ms(t0)
        last = d.get("/debug/last-cycle") or {}
        if last.get("digests") != want["digests"] or assign_digest(body) != want["assign"]:
            raise AssertionError(f"{d.name}: Assign {i} differs from the headline cycle: "
                                 f"{last.get('digests')} vs {want['digests']}")
    after = d.get("/debug/process")
    health = d.get("/healthz")
    builds = after["loaded_variants"] - before["loaded_variants"]
    ledger_builds = health["device"]["compiles"] - ledger_before
    launched = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
    if builds or ledger_builds or after["kernel_demotions"] or health["kernel_demotions"]:
        raise AssertionError(f"{d.name}: after warm-up {builds} builds, ledger {ledger_builds}, "
                             f"demotions {health['kernel_demotions']}")
    if sum(launched.values()) != int(_on_card(device)):
        raise AssertionError(f"{d.name}: the checked Assign launched {launched}")
    out.update(path=last.get("path"), builds_after_warmup=builds,
               ledger_compiles_after_warmup=ledger_builds,
               demotions=after["kernel_demotions"], launches=after["launches"],
               checked_assign_launches=launched, equal_to_headline=True)
    return out


def _prewarm_done(d: Daemon) -> Optional[dict]:
    """The /healthz prewarm block once its runner has finished."""
    block = (d.get("/healthz") or {}).get("prewarm", {})
    return block if block.get("state") == "done" else None


class _Storm:
    """``threads`` clients of flat Scores (k = ``STORM_K``) on one daemon,
    counting replies, errors and replies while a failover is open."""

    def __init__(self, raw: str, threads: int = STORM_THREADS):
        self.raw = raw
        self.stop_event = threading.Event()
        self.failover = threading.Event()
        self._lock = threading.Lock()
        self.reads = {"ok": 0, "err": 0, "ok_during_failover": 0}
        self.threads = [threading.Thread(target=self._run, daemon=True, name=f"storm-{i}")
                        for i in range(threads)]

    def _one(self, body: bytes) -> bool:
        try:
            status, _ = raw_call(self.raw, METHOD_SCORE, body, timeout=30.0)
        except OSError:
            return False
        return status == 0

    def _run(self) -> None:
        body = _score_payload()
        while not self.stop_event.is_set():
            ok = self._one(body)
            with self._lock:
                if ok:
                    self.reads["ok"] += 1
                    if self.failover.is_set():
                        self.reads["ok_during_failover"] += 1
                else:
                    self.reads["err"] += 1
            # request pacing: errors are counted, not retried
            self.stop_event.wait(0.005)

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop_event.set()
        for t in self.threads:
            t.join(timeout=60)
        if any(t.is_alive() for t in self.threads):
            raise AssertionError("a storm thread did not end")

    def counts(self) -> dict:
        with self._lock:
            return dict(self.reads)


def failover_leg(base: str, lists, want: dict, *, device=None,
                 kernel_build_dir: Optional[str] = None) -> dict:
    """The ``failover`` leg (module docstring) on the cluster ``lists``.
    ``want``: ``{"digests": result_digests(...), "assign": cycle_digest}``
    of the cluster's cycle as the caller ran it."""
    full, frames, noop = sync_frames(lists, DELTAS)
    kw = dict(device=device, kernel_build_dir=kernel_build_dir, devprof_sample=16)
    wall = time.perf_counter()
    leader = Daemon(base, "l", journal=True, **kw)
    follower = Daemon(base, "f", replicate_from=leader.repl, **kw)
    daemons = [leader, follower]
    out = {"deltas": DELTAS, "full_sync_bytes": len(full), "storm_threads": STORM_THREADS,
           "storm_k": STORM_K}
    try:
        body, ack = leader.first_ack(METHOD_SYNC, full)
        sid = _sid(body)
        out["leader_boot"] = leader.boot_split(ack)
        follower.wait("the full frame", lambda: (follower.get("/healthz") or {}).get(
            "replica", {}).get("snapshot_id") == sid)
        out["follower_boot"] = follower.boot_split(time.perf_counter())
        for frame in frames:
            sid = _sid(leader.call(METHOD_SYNC, frame))
        follower.wait("the delta frames", lambda: (follower.get("/healthz") or {}).get(
            "replica", {}).get("snapshot_id") == sid)
        journal = leader.get("/debug/process")["journal"]
        out["journal_appends"] = journal["appends"]
        out["journal_append_us"] = journal["last_append_us"]
        resyncs_before = follower.get("/healthz")["replica"].get("resyncs", 0)
        epoch = sid.rsplit("-", 1)[0]
        with _Storm(follower.raw) as storm:
            follower.wait("the storm's first read", lambda: storm.counts()["ok"] > 0)
            # leg A: SIGKILL, then a warm restart on the same state dir
            storm.failover.set()
            t_kill = time.perf_counter()
            reaped = leader.kill()
            leader = Daemon(base, "l", journal=True, **kw)
            daemons.append(leader)
            body, ack = leader.first_ack(METHOD_SYNC, noop)
            restarted = _sid(body)
            storm.failover.clear()
            replay = leader.get("/debug/process")["journal"]
            if (restarted.rsplit("-", 1)[0] != epoch
                    or int(restarted.rsplit("-", 1)[1]) != int(sid.rsplit("-", 1)[1]) + 1):
                raise AssertionError(f"the warm restart resumed {restarted}, not the chain "
                                     f"of {sid}")
            out["warm_restart_ms"] = _ms(t_kill, ack)
            out["warm_restart"] = {"kill_to_reaped_ms": _ms(t_kill, reaped),
                                   **leader.boot_split(ack, replay["replay_ms"])}
            out["journal_replay_ms"] = replay["replay_ms"]
            out["replayed_frames"] = replay["replayed_frames"]
            out["resumed"] = {"before_kill": sid, "first_ack": restarted}
            leader.wait("the lease", lambda: (leader.get("/healthz") or {}).get("leader"))
            out["leg_a_assign"] = _checked_assigns(leader, noop, want, device)
            sid = _sid(leader.call(METHOD_SYNC, noop))
            follower.wait("the resumed stream", lambda: (follower.get("/healthz") or {}).get(
                "replica", {}).get("snapshot_id") == sid)
            # leg B: SIGKILL again, then promote the follower with SIGUSR2
            storm.failover.set()
            t_kill = time.perf_counter()
            reaped = leader.kill()
            os.kill(follower.proc.pid, signal.SIGUSR2)
            promoted = follower.wait("the promotion", lambda: (follower.get(
                "/healthz") or {}).get("replica", {}).get("promoted") and time.perf_counter())
            body, ack = follower.first_ack(METHOD_SYNC, noop)
            storm.failover.clear()
            new_sid = _sid(body)
            if new_sid.rsplit("-", 1)[0] == epoch:
                raise AssertionError(f"the promotion kept the epoch of {sid}: {new_sid}")
            out["failover_ms"] = _ms(t_kill, ack)
            out["failover"] = {"kill_to_reaped_ms": _ms(t_kill, reaped),
                               "signal_to_promoted_ms": _ms(reaped, promoted),
                               "first_ack_ms": _ms(promoted, ack),
                               "promoted_snapshot_id": new_sid,
                               "note": "the follower's spawn, imports and CUDA context "
                                       "were paid at its boot (follower_boot)"}
            out["leg_b_assign"] = _checked_assigns(follower, noop, want, device)
            resyncs = follower.get("/healthz")["replica"].get("resyncs", 0)
        out["resyncs_during_failover"] = resyncs - resyncs_before
        out["reads"] = storm.counts()
        if out["reads"]["ok_during_failover"] < 1:
            raise AssertionError(f"no read was served while the leader was down: {out['reads']}")
    finally:
        _reap(daemons)
    out["processes_left"] = 0
    out["wall_s"] = _ms(wall) / 1e3
    return out


def coldstart_leg(base: str, lists, *, build_dir: str, device=None) -> dict:
    """The ``coldstart`` leg (module docstring): boot 1 with ``build_dir``
    empty and no prewarm record, boot 2 with ``--prewarm`` on the same state
    and build directories."""
    full, _, _ = sync_frames(lists, 0)
    os.makedirs(build_dir, exist_ok=True)
    if os.listdir(build_dir):
        raise AssertionError(f"coldstart: {build_dir} is not empty")
    out = {"k": STORM_K}
    wall = time.perf_counter()
    for boot in ("cold", "warm"):
        d = Daemon(base, "c", device=device, prewarm=True, kernel_build_dir=build_dir)
        try:
            _, synced = d.first_ack(METHOD_SYNC, full)
            body = d.call(METHOD_SCORE, _score_payload())
            scored = time.perf_counter()
            assigned_body = d.call(METHOD_ASSIGN, _assign_payload())
            assigned = time.perf_counter()
            pw = d.wait("the prewarm", lambda: _prewarm_done(d))
            out[boot] = {
                "spawn_to_first_score_ms": _ms(d.spawned_pc, scored),
                "spawn_to_first_assign_ms": _ms(d.spawned_pc, assigned),
                "boot": d.boot_split(synced),
                "first_score_ms": _ms(synced, scored),
                "first_assign_ms": _ms(scored, assigned),
                "score_digest": score_digest(body),
                "assign_digest": assign_digest(assigned_body),
                "launches": d.get("/debug/process")["launches"],
                "prewarm": {key: pw.get(key) for key in (
                    "state", "total", "replayable", "compiled", "skipped", "failed",
                    "compile_ms_total", "elapsed_ms")},
            }
        finally:
            _reap([d])
        out[boot]["build_dir_files"] = sorted(os.listdir(build_dir))
    for key in ("score_digest", "assign_digest"):
        out[f"{key}s_equal"] = out["cold"][key] == out["warm"][key]
        if not out[f"{key}s_equal"]:
            raise AssertionError(f"coldstart: the {key} differs between the boots")
    out["processes_left"] = 0
    out["wall_s"] = _ms(wall) / 1e3
    return out


def candidate_build_leg(snapshot, cfg) -> dict:
    """The serial sweep and the pipelined cold candidate build on
    ``snapshot`` (``KOORD_PARALLEL_BUILD=0`` then ``1``), each timed to its
    lists on the host; ``(cand, count)`` must be byte-equal."""
    from koordinator_tpu_torch.solver import build_candidates

    prior = os.environ.get("KOORD_PARALLEL_BUILD")
    got, out = {}, {}
    try:
        for mode, name in (("0", "serial"), ("1", "pipelined")):
            os.environ["KOORD_PARALLEL_BUILD"] = mode
            t0 = time.perf_counter()
            cand, count = build_candidates(snapshot, cfg)
            got[name] = (cand.cpu().numpy().tobytes(), count.cpu().numpy().tobytes())
            out[f"{name}_ms"] = _ms(t0)
    finally:
        if prior is None:
            os.environ.pop("KOORD_PARALLEL_BUILD", None)
        else:
            os.environ["KOORD_PARALLEL_BUILD"] = prior
    out["byte_equal"] = got["serial"] == got["pipelined"]
    if not out["byte_equal"]:
        raise AssertionError("the serial and the pipelined candidate builds differ")
    return out
