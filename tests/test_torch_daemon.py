"""The port's koord-scheduler daemon (``koordinator_tpu_torch/scheduler/
server.py``) on the CPU: lease election against the reference's lease
file, Assign gated on leadership, the mesh of --shard and --mesh, the reference's flags
and healthz blocks, the kernel prewarm record, the client's follower
routing and leader probing, and a leader with a follower daemon end to
end — replication, the journal's warm restart, promotion over the admin
socket and the client's failover — with the follower's replies equal to
the leader's.  ``python -m koordinator_tpu_torch.scheduler.server
--device cpu`` starts a leader and a follower as processes.  Every socket
and thread wait has its own timeout, every server stops in a
``finally``, and the socket paths are short paths under /tmp."""

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from koordinator_tpu.leaderelection import LeaderElector as RefElector

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.client import RpcError, ScorerClient
from koordinator_tpu_torch.bridge.server import ScorerServicer, StatusCode
from koordinator_tpu_torch.bridge.udsserver import METHOD_PROFILE, RawUdsServer
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.leaderelection import LeaderElector
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.replication.follower import FollowerServicer, promote_replica
from koordinator_tpu_torch.scheduler.server import SchedulerServer, build_arg_parser

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 30.0


def _wait_until(predicate, timeout_s=WAIT_S, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def _short_dir(prefix="kd"):
    return tempfile.mkdtemp(prefix=prefix, dir="/tmp")


def _cluster(pods=32, nodes=8, seed=3):
    nodes_l, pods_l, gangs, quotas = generators.quota_colocation(
        seed=seed, pods=pods, nodes=nodes, tenants=2
    )
    kw = dict(
        node_allocatable=np.asarray([res.resource_vector(n["allocatable"]) for n in nodes_l]),
        node_requested=np.asarray([res.resource_vector(n.get("requested", {}))
                                   for n in nodes_l]),
        node_usage=np.asarray([res.resource_vector(n.get("usage", {})) for n in nodes_l]),
        node_names=[n["name"] for n in nodes_l],
        pod_requests=np.asarray([res.resource_vector(p["requests"]) for p in pods_l]),
        pod_names=[p["name"] for p in pods_l],
        priority=[p.get("priority", 0) for p in pods_l],
    )
    return kw


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=WAIT_S) as r:
        return r.status, r.read()


def _healthz(server):
    status, body = _get(server.http_port, "/healthz")
    assert status == 200
    return json.loads(body)


# -- leader election --

ELECTORS = {"port": LeaderElector, "reference": RefElector}


@pytest.mark.parametrize("first,second", [("port", "port"), ("port", "reference"),
                                          ("reference", "port")])
def test_lease_contention_and_handover_across_packages(tmp_path, first, second):
    """The lease file format is the reference's: either package's elector
    blocks the other until expiry, observes a takeover, and a release
    hands over at once; transitions are counted."""
    lease = str(tmp_path / "leader.lease")
    t = [100.0]
    clock = lambda: t[0]  # noqa: E731
    a = ELECTORS[first](lease, "a", lease_duration=15.0, clock=clock)
    b = ELECTORS[second](lease, "b", lease_duration=15.0, clock=clock)
    assert a.try_acquire_or_renew() and a.try_acquire_or_renew()
    assert not b.try_acquire_or_renew()
    t[0] = 114.0
    assert not b.try_acquire_or_renew()
    t[0] = 116.0
    assert b.try_acquire_or_renew()
    assert not a.try_acquire_or_renew()
    assert a._read().leader_transitions == 1
    b.release()
    assert a.try_acquire_or_renew()


def test_two_electors_in_one_process_contend_as_two_processes_do(tmp_path):
    """The flock is per open file description: a second elector in the
    same process waits while the first holds the lock."""
    lease = str(tmp_path / "leader.lease")
    a, b = LeaderElector(lease, "a"), LeaderElector(lease, "b")
    inside, release, order = threading.Event(), threading.Event(), []

    def hold():
        inside.set()
        assert release.wait(WAIT_S)
        order.append("a")

    ta = threading.Thread(target=lambda: a._with_lock(hold), daemon=True)
    ta.start()
    assert inside.wait(WAIT_S)
    tb = threading.Thread(target=lambda: (b.try_acquire_or_renew(), order.append("b")),
                          daemon=True)
    tb.start()
    time.sleep(0.2)
    assert order == []  # b is blocked on a's flock
    release.set()
    ta.join(WAIT_S)
    tb.join(WAIT_S)
    assert order == ["a", "b"]


def test_the_run_loop_starts_and_stops_leading(tmp_path):
    lease = str(tmp_path / "leader.lease")
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    events = []
    a = LeaderElector(lease, "a", lease_duration=10.0, retry_period=0.0, clock=clock,
                      on_started_leading=lambda: events.append("start"),
                      on_stopped_leading=lambda: events.append("stop"))
    a.run(max_iterations=2, sleep=lambda s: None)
    assert a.is_leader and events == ["start"]
    t[0] = 50.0
    assert LeaderElector(lease, "b", lease_duration=10.0, clock=clock).try_acquire_or_renew()
    a.run(max_iterations=1, sleep=lambda s: None)
    assert not a.is_leader and events == ["start", "stop"]


# -- the daemon alone --

def _server(d, name, **kw):
    kw.setdefault("enable_grpc", False)
    return SchedulerServer(
        lease_path=os.path.join(d, f"{name}.lease"), identity=name,
        uds_path=os.path.join(d, f"{name}.sock"), state_dir=os.path.join(d, name),
        device="cpu", **kw,
    )


def test_the_daemon_serves_and_gates_assign_on_leadership():
    d = _short_dir()
    s = _server(d, "l").start()
    try:
        assert _wait_until(lambda: s.elector.is_leader)
        doc = _healthz(s)
        assert doc["ok"] and doc["leader"] and doc["device"]["platform"] == "cpu"
        nodes_l, pods_l, _, _ = generators.loadaware_joint(seed=3, pods=8, nodes=4)
        req, _ = build_sync_request(nodes_l, pods_l, [], [])
        sid = s.servicer.sync(req).snapshot_id
        assert len(s.servicer.assign(wire.AssignRequest(snapshot_id=sid)).assignment) == 8
        s.elector.is_leader = False
        with pytest.raises(PermissionError):
            s.servicer.assign(wire.AssignRequest(snapshot_id=sid))
    finally:
        s.stop()


# the daemon's mesh over the CPU: the test configuration forces 8 host
# devices, so visible_devices("cpu") names the CPU eight times
@pytest.mark.parametrize("kw,axes,shards,resident", [
    ({"shard": True}, ("pods", "nodes"), 8, False),
    ({"mesh_devices": "auto"}, ("nodes",), 8, True),
    ({"mesh_devices": "2"}, ("nodes",), 2, True),
    ({"mesh_devices": "3"}, ("nodes",), 2, True),
], ids=["shard", "mesh_auto", "mesh_2", "mesh_3"])
def test_the_sharded_assign_builds_its_mesh(kw, axes, shards, resident):
    """``--shard`` builds ``make_mesh`` over every visible device;
    ``--mesh`` a cluster mesh over a power-of-two prefix of them (``3``
    rounds down to 2), the snapshot resident on it."""
    import torch

    s = _server(_short_dir(), "l", **kw)
    try:
        mesh = s.servicer.mesh
        assert (mesh.axis_names, mesh.size, s.servicer.mesh_resident) == (axes, shards, resident)
        assert mesh.device_list == (torch.device("cpu"),) * shards
        assert (s.servicer.state.mesh is mesh) is resident
    finally:
        s.stop()


def test_mesh_4_on_a_one_device_host_gives_one_device(monkeypatch, caplog):
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    s = _server(_short_dir(), "l", mesh_devices="4")
    try:
        assert s.servicer.mesh.size == 1 and s.servicer.mesh_resident
    finally:
        s.stop()
    assert "--mesh 4 rounded down to 1 devices" in caplog.text


@pytest.mark.parametrize("argv,axes,shards", [(["--shard"], ("pods", "nodes"), 8),
                                              (["--mesh", "auto"], ("nodes",), 8)],
                         ids=["shard", "mesh"])
def test_the_cli_builds_the_mesh(argv, axes, shards, monkeypatch):
    from koordinator_tpu_torch.scheduler import server as daemon

    built = {}

    class Built(Exception):
        pass

    def build(**kw):
        s = SchedulerServer(**kw)
        built["mesh"] = s.servicer.mesh
        s.stop()
        raise Built

    monkeypatch.setattr(daemon, "SchedulerServer", build)
    d = _short_dir()
    with pytest.raises(Built):
        daemon.main(argv + ["--device", "cpu", "--uds", os.path.join(d, "s.sock"),
                            "--lease", os.path.join(d, "lease"), "--state-dir", d,
                            "--no-grpc", "--http-port", "0"])
    assert (built["mesh"].axis_names, built["mesh"].size) == (axes, shards)


def test_a_socket_path_past_the_address_limit_is_refused():
    with pytest.raises(ValueError, match="107"):
        SchedulerServer(uds_path="/tmp/" + "x" * 100 + ".sock", device="cpu",
                        lease_path=os.path.join(_short_dir(), "lease"))


def test_grpc_asked_for_without_grpc_installed_refuses_to_start(monkeypatch):
    d = _short_dir()
    s = _server(d, "l", enable_grpc=True)
    monkeypatch.setitem(sys.modules, "grpc", None)  # import grpc now raises
    try:
        with pytest.raises(RuntimeError, match="grpc"):
            s.start()
        assert not os.path.exists(os.path.join(d, "l.sock.raw"))
    finally:
        s.stop()


def test_the_parser_has_the_references_flags_but_the_listed_renames():
    from koordinator_tpu.scheduler.server import build_arg_parser as ref_parser

    def flags(ap):
        return {o: a.dest for a in ap._actions for o in a.option_strings}

    ours, theirs = flags(build_arg_parser()), flags(ref_parser())
    # the XLA compile cache becomes the kernel build directory; --device
    # stands for JAX_PLATFORMS; --no-grpc serves the raw framing alone
    renamed = {"--xla-cache": "--kernel-build-dir"}
    added = {"--device", "--no-grpc"}
    assert set(ours) == (set(theirs) - set(renamed)) | set(renamed.values()) | added
    for flag, dest in theirs.items():
        if flag not in renamed:
            assert ours[flag] == dest, flag
    args = build_arg_parser().parse_args([])
    assert (args.device, args.grpc, args.kernel_build_dir) == ("cuda", True, None)
    # --shard and --mesh are the reference's, served rather than refused
    assert (ours["--shard"], ours["--mesh"]) == ("shard", "mesh_devices")
    args = build_arg_parser().parse_args(["--shard", "--mesh", "3"])
    assert (args.shard, args.mesh_devices) == (True, "3")


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_the_healthz_blocks_have_the_references_keys(monkeypatch):
    """A leader with journal and prewarm, and a follower, of each
    package: every healthz key path is the reference's, and the port's
    device block adds only its stage rows' heading (``device.stages``)."""
    import jax

    from koordinator_tpu.obs import devprof as ref_devprof
    from koordinator_tpu.scheduler.server import SchedulerServer as RefServer

    # the reference's prewarm turns its process-wide launch ledger to
    # capture: give it a ledger of its own for this test
    monkeypatch.setattr(ref_devprof, "_LEDGER", ref_devprof.LaunchLedger())
    d = _short_dir()
    docs = {}
    # the reference daemon points JAX's compile cache at its state dir
    # unless given one: keep this process's own
    ref_kw = {"xla_cache": jax.config.jax_compilation_cache_dir or ""}
    for pkg, cls, extra in (("ref", RefServer, ref_kw), ("port", SchedulerServer,
                                                         {"device": "cpu"})):
        leader = cls(lease_path=os.path.join(d, f"{pkg}.lease"), identity="a",
                     uds_path=os.path.join(d, f"{pkg}l.sock"),
                     state_dir=os.path.join(d, f"{pkg}l"), journal=True, prewarm=True,
                     enable_grpc=False, http_port=0, **extra).start()
        follower = cls(lease_path=os.path.join(d, f"{pkg}f.lease"), identity="b",
                       uds_path=os.path.join(d, f"{pkg}f.sock"),
                       state_dir=os.path.join(d, f"{pkg}f"),
                       replicate_from=os.path.join(d, f"{pkg}l.sock.repl"),
                       enable_grpc=False, http_port=0, **extra).start()
        try:
            assert _wait_until(lambda: follower.applier.applied >= 1)
            docs[pkg] = [_healthz(leader), _healthz(follower)]
        finally:
            follower.stop()
            leader.stop()
    for ours, theirs in zip(docs["port"], docs["ref"]):
        assert _keys(ours) - _keys(theirs) == {"device.stages"}
        assert _keys(theirs) <= _keys(ours)
    assert docs["port"][1]["replica"]["role"] == "follower"


# -- the prewarm record --

def test_the_prewarm_tables_cover_every_launch_boundary_once():
    from koordinator_tpu_torch.obs import devprof
    from koordinator_tpu_torch.obs.prewarm import PREWARM_BOUNDARIES, PREWARM_EXCLUDED
    from koordinator_tpu_torch.parallel import shard_assign  # noqa: F401
    from koordinator_tpu_torch.solver import candidates, dense, incremental, resident, wide  # noqa: F401

    # the port's launch boundaries (a test may register its own names)
    names = {n for n in devprof.boundaries() if n.startswith(("solver.", "parallel."))}
    assert set(PREWARM_BOUNDARIES) | set(PREWARM_EXCLUDED) == names
    assert not set(PREWARM_BOUNDARIES) & set(PREWARM_EXCLUDED)


def test_the_prewarm_record_and_runner(tmp_path, monkeypatch):
    """Builds are recorded as JSON, a stop adds every loaded variant, and
    the runner rebuilds the record in order — on a CPU daemon it skips
    them all; its stats have the reference's keys."""
    from koordinator_tpu.obs.prewarm import PrewarmRunner as RefRunner

    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.obs import prewarm
    from koordinator_tpu_torch.obs.scorer_metrics import ScorerMetrics

    state = str(tmp_path)
    prewarm.record_build(state, "solver/cycle_cuda.cu", ())
    prewarm.record_build(state, "solver/cycle_cuda.cu", ())
    monkeypatch.setattr(_build, "loaded_variants", lambda: [
        ("solver/cycle_wide_cuda.cu", ()), ("solver/cycle_cuda.cu", ("KOORD_PHASE_CLOCK",))])
    prewarm.dump(state)
    assert json.loads((tmp_path / "prewarm.json").read_text()) == {"variants": [
        {"source": "solver/cycle_cuda.cu", "defines": []},
        {"source": "solver/cycle_wide_cuda.cu", "defines": []},
        {"source": "solver/cycle_cuda.cu", "defines": ["KOORD_PHASE_CLOCK"]},
    ]}
    built = []
    monkeypatch.setattr(_build, "build", lambda s, d=(): built.append((s, tuple(d))))
    metrics = ScorerMetrics()
    runner = prewarm.PrewarmRunner(state, metrics=metrics, device="cuda").start()
    assert runner.wait(WAIT_S)
    st = runner.stats()
    assert (st["state"], st["total"], st["compiled"], st["failed"]) == ("done", 3, 3, 0)
    assert built == [("solver/cycle_cuda.cu", ()), ("solver/cycle_wide_cuda.cu", ()),
                     ("solver/cycle_cuda.cu", ("KOORD_PHASE_CLOCK",))]
    assert metrics.registry.get("koord_scorer_prewarm_signatures_total",
                                {"result": "compiled"}) == 3
    cpu = prewarm.PrewarmRunner(state, device="cpu").start()
    assert cpu.wait(WAIT_S) and cpu.stats()["skipped"] == 3
    assert set(st) == set(RefRunner(state).stats())


def test_a_failed_prewarm_build_is_counted_and_named(tmp_path, monkeypatch):
    from koordinator_tpu_torch import _build
    from koordinator_tpu_torch.obs import prewarm

    prewarm.record_build(str(tmp_path), "solver/cycle_cuda.cu", ())

    def broken(source, defines=()):
        raise _build.KernelBuildError("nvcc failed")

    monkeypatch.setattr(_build, "build", broken)
    runner = prewarm.PrewarmRunner(str(tmp_path), device="cuda").start()
    assert runner.wait(WAIT_S)
    assert runner.stats()["failed"] == 1 and "nvcc failed" in runner.failures[0]


# -- the client's routing --

class _Counting(ScorerServicer):
    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.calls = []

    def score(self, req, ctx=None):
        self.calls.append("score")
        return super().score(req, ctx)


class _CountingFollower(FollowerServicer):
    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.calls = []

    def score(self, req, ctx=None):
        self.calls.append("score")
        return super().score(req, ctx)


def test_score_round_robins_over_followers_and_falls_back_for_a_laggard():
    """Sync goes to the leader; Score alternates between two followers
    (raw targets, one with a depth annotation); a follower that has not
    applied the generation answers "not resident" and that call is
    served by the leader."""
    from koordinator_tpu_torch.replication.follower import ReplicaApplier

    d = _short_dir()
    leader = _Counting()
    followers = [_CountingFollower(), _CountingFollower()]
    appliers = [ReplicaApplier(f) for f in followers]
    servers = [RawUdsServer(os.path.join(d, "l.sock"), servicer=leader).start()]
    servers += [RawUdsServer(os.path.join(d, f"f{i}.sock"), servicer=f).start()
                for i, f in enumerate(followers)]
    cli = ScorerClient(f"raw://{d}/l.sock",
                       followers=[f"raw://{d}/f0.sock", f"raw://{d}/f1.sock@1"],
                       rpc_timeout_ms=WAIT_S * 1000)
    try:
        from koordinator_tpu_torch.replication import codec

        cli.sync(**_cluster())
        epoch, gen, payload = leader.export_replication_snapshot()
        full = codec.Frame(codec.KIND_FULL, epoch, gen, 0, payload)
        assert appliers[0].offer(full) == "applied"  # follower 1 lags
        want = cli.score_flat(top_k=4)
        for _ in range(3):
            assert all(np.array_equal(a, b) for a, b in zip(cli.score_flat(top_k=4), want))
        # the leader fallback draws from the same round-robin counter, as
        # in the reference: the followers share the four calls, and the
        # leader serves exactly the laggard's
        f0, f1 = len(followers[0].calls), len(followers[1].calls)
        assert f0 + f1 == 4 and f0 >= 1 and f1 >= 1
        assert len(leader.calls) == f1
    finally:
        cli.close()
        for s in servers:
            s.stop()


def test_writers_probe_past_a_dead_leader_and_a_refusing_follower():
    """The leader dies; follower 0 is not promoted ("one writer"),
    follower 1 is: Sync and Assign find follower 1, and the client
    resyncs once on its new epoch."""
    d = _short_dir()
    leader = ScorerServicer(device="cpu")
    followers = [FollowerServicer(device="cpu"), FollowerServicer(device="cpu")]
    syncs = []
    real_sync = followers[1].sync

    def counted_sync(req, ctx=None, wire_bytes=None):
        syncs.append(req)
        return real_sync(req, ctx, wire_bytes=wire_bytes)

    followers[1].sync = counted_sync
    lsrv = RawUdsServer(os.path.join(d, "l.sock"), servicer=leader).start()
    fsrv = [RawUdsServer(os.path.join(d, f"f{i}.sock"), servicer=f).start()
            for i, f in enumerate(followers)]
    cli = ScorerClient(f"raw://{d}/l.sock",
                       followers=[f"raw://{d}/f0.sock", f"raw://{d}/f1.sock"],
                       rpc_timeout_ms=WAIT_S * 1000)
    try:
        kw = _cluster()
        cli.sync(**kw)
        want = cli.assign()[:2]
        lsrv.stop()
        followers[1].promote()
        reply = cli.sync(**kw)
        assert reply.snapshot_id == followers[1].snapshot_id()
        # the delta, then one full Sync on the new epoch
        assert cli._leader_idx == 1 and len(syncs) == 2
        assert not syncs[0].nodes.allocatable.data and syncs[1].nodes.allocatable.data
        got = cli.assign()[:2]
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        with pytest.raises(RpcError) as ei:
            cli._follower_syncs[0](wire.SyncRequest(), timeout=WAIT_S)
        assert ei.value.code() == StatusCode.FAILED_PRECONDITION
    finally:
        cli.close()
        for s in fsrv:
            s.stop()
        lsrv.stop()


# -- the tier end to end --

def test_leader_and_follower_daemons_end_to_end():
    """A journaled leader and a follower daemon: Syncs replicate, the
    follower's Score equals the leader's, the follower refuses Syncs; the
    leader restarts on its state dir and resumes the chain with the same
    Assign; then it stops, the follower is promoted over its admin socket,
    and the client's next Sync finds it and Assigns as before.  Profile
    over the admin socket returns a capture directory."""
    d = _short_dir()
    leader = _server(d, "l", journal=True, prewarm=True).start()
    follower = _server(d, "f", replicate_from=os.path.join(d, "l.sock.repl")).start()
    servers = [leader, follower]
    cli = ScorerClient(f"raw://{d}/l.sock.raw", followers=[f"raw://{d}/f.sock.raw"],
                       rpc_timeout_ms=WAIT_S * 1000)
    try:
        assert _wait_until(lambda: leader.elector.is_leader)
        kw = _cluster()
        cli.sync(**kw)
        usage = kw["node_usage"].copy()
        for i in range(3):
            usage[i % usage.shape[0], 0] += 100 + i
            cli.sync(**dict(kw, node_usage=usage))
        sid = cli.snapshot_id
        assert _wait_until(lambda: follower.servicer.snapshot_id() == sid)
        f_score = follower.servicer.score(wire.ScoreRequest(snapshot_id=sid, top_k=8, flat=True))
        l_score = leader.servicer.score(wire.ScoreRequest(snapshot_id=sid, top_k=8, flat=True))
        f_score.build_ms = l_score.build_ms = 0.0
        assert f_score.SerializeToString() == l_score.SerializeToString()
        assert cli.score_flat(top_k=8)[2].size > 0
        want = cli.assign()[:2]
        with pytest.raises(RpcError, match="one writer"):
            cli._follower_syncs[0](wire.SyncRequest(), timeout=WAIT_S)
        for s in servers:
            status, body = _get(s.http_port, "/metrics")
            assert status == 200 and b"koord_scorer_" in body
            doc = _healthz(s)
            assert {"replica", "prewarm", "device"} <= set(doc)
        assert _healthz(follower)["replica"]["applied_frames"] >= 1
        # warm restart on the same state dir
        leader.stop()
        servers.remove(leader)
        leader = _server(d, "l", journal=True, prewarm=True).start()
        servers.append(leader)
        assert leader.journal_replay["resumed_id"] == sid
        assert leader.servicer.snapshot_id() == sid
        assert _wait_until(lambda: leader.elector.is_leader)
        got = cli.assign()[:2]
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert _healthz(leader)["prewarm"]["state"] in ("running", "done")
        # Profile over the admin socket
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(WAIT_S)
        try:
            conn.connect(os.path.join(d, "l.sock.raw"))
            conn.sendall(bytes([METHOD_PROFILE]) + (3).to_bytes(4, "big") + b"200")
            head = b""
            while len(head) < 5:
                head += conn.recv(5 - len(head))
            status, n = head[0], int.from_bytes(head[1:], "big")
            body = b""
            while len(body) < n:
                body += conn.recv(n - len(body))
        finally:
            conn.close()
        assert status == 0 and body.decode().startswith(os.path.join(d, "l"))
        # failover
        leader.stop()
        servers.remove(leader)
        new_sid = promote_replica(os.path.join(d, "f.sock.raw"), timeout_s=WAIT_S)
        assert new_sid != sid and new_sid.endswith(sid.rsplit("-", 1)[1])
        reply = cli.sync(**dict(kw, node_usage=usage))
        assert reply.snapshot_id.startswith(new_sid.rsplit("-", 1)[0])
        got = cli.assign()[:2]
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert _healthz(follower)["replica"]["promoted"] is True
    finally:
        cli.close()
        for s in servers:
            s.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_module_starts_a_leader_and_a_follower_on_the_cpu():
    d = _short_dir()
    ports = [_free_port(), _free_port()]
    common = [sys.executable, "-m", "koordinator_tpu_torch.scheduler.server",
              "--device", "cpu", "--no-grpc"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(common + [
        "--uds", os.path.join(d, "l.sock"), "--lease", os.path.join(d, "l.lease"),
        "--state-dir", os.path.join(d, "l"), "--http-port", str(ports[0]), "--journal",
    ], cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)]
    try:
        assert _wait_until(lambda: os.path.exists(os.path.join(d, "l.sock.repl")), 120)
        procs.append(subprocess.Popen(common + [
            "--uds", os.path.join(d, "f.sock"), "--lease", os.path.join(d, "f.lease"),
            "--state-dir", os.path.join(d, "f"), "--http-port", str(ports[1]),
            "--replicate-from", os.path.join(d, "l.sock.repl"),
        ], cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))

        def health(port):
            try:
                return json.loads(_get(port, "/healthz")[1])
            except OSError:
                return None

        assert _wait_until(lambda: health(ports[0]) and health(ports[1]), 120)
        cli = ScorerClient(f"raw://{d}/l.sock.raw", rpc_timeout_ms=WAIT_S * 1000)
        try:
            assert _wait_until(lambda: health(ports[0])["leader"])
            sid = cli.sync(**_cluster()).snapshot_id
        finally:
            cli.close()
        assert _wait_until(lambda: health(ports[1])["replica"]["snapshot_id"] == sid)
        assert health(ports[0])["replica"]["role"] == "leader"
        assert health(ports[1])["replica"]["role"] == "follower"
    finally:
        for p in procs:
            p.send_signal(signal.SIGINT)
        for p in procs:
            try:
                assert p.wait(timeout=WAIT_S) == 0, p.stderr.read().decode()[-2000:]
            finally:
                if p.poll() is None:
                    p.kill()


def test_a_relay_republishes_the_stream_to_its_own_follower():
    """leader -> relay (``relay_from``) -> follower: the relay applies and
    forwards the deltas' exact bytes, the leaf converges on the leader's
    snapshot id, and the relay's healthz names its hop and ancestors."""
    d = _short_dir()
    leader = _server(d, "l").start()
    servers = [leader]
    try:
        relay = _server(d, "r", relay_from=os.path.join(d, "l.sock.repl"))
        servers.append(relay.start())
        leaf = _server(d, "f", replicate_from=os.path.join(d, "r.sock.repl"), tree_depth=2)
        servers.append(leaf.start())
        assert _wait_until(lambda: leaf.applier.applied >= 1)
        kw = _cluster()
        cli = ScorerClient(f"raw://{d}/l.sock.raw", rpc_timeout_ms=WAIT_S * 1000)
        try:
            cli.sync(**kw)
            usage = kw["node_usage"].copy()
            for i in range(3):
                usage[i, 0] += 50 + i
                cli.sync(node_usage=usage)
        finally:
            cli.close()
        sid = leader.servicer.snapshot_id()
        assert _wait_until(lambda: leaf.servicer.snapshot_id() == sid)
        assert relay.servicer.snapshot_id() == sid
        doc = _healthz(relay)["replica"]["relay"]
        assert doc["hop"] == 1 and doc["cache"] is not None
        # the full Sync and three deltas, each forwarded as the leader sent it
        assert relay.servicer.telemetry.registry.get(
            "koord_scorer_relay_forwarded_total") == 4
    finally:
        for s in reversed(servers):
            s.stop()


def test_the_autoscaler_runs_in_the_daemon_and_logs_its_decisions():
    d = _short_dir()
    decisions = []
    s = _server(d, "l", autoscale=True, autoscale_interval_s=0.02, autoscale_min=1,
                autoscale_max=3)
    s.autoscale_spawn = lambda: decisions.append("spawn")
    s.start()
    try:
        assert _wait_until(lambda: _healthz(s)["replica"].get("autoscale", {}).get("ticks", 0) > 2)
        assert "autoscale" in _healthz(s)["replica"]
    finally:
        s.stop()


def test_sigusr2_promotes_a_follower_daemon():
    d = _short_dir()
    previous = signal.getsignal(signal.SIGUSR2)
    leader = _server(d, "l").start()
    follower = _server(d, "f", replicate_from=os.path.join(d, "l.sock.repl")).start()
    try:
        assert _wait_until(lambda: follower.applier.applied >= 1)
        os.kill(os.getpid(), signal.SIGUSR2)
        assert _wait_until(lambda: follower._promoted)
        assert _healthz(follower)["replica"]["role"] == "leader"
        with pytest.raises(RuntimeError, match="already the leader"):
            leader.promote()
    finally:
        follower.stop()
        leader.stop()
        signal.signal(signal.SIGUSR2, previous)
