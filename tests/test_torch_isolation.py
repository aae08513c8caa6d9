"""The PyTorch port runs where JAX is absent: it imports neither ``jax`` nor
the JAX package nor the protobuf runtime, imports ``grpc`` only inside the
two functions that build gRPC transports (the server's and the client's)
and ``yaml`` only inside ``load_config``, serves and replays a trace (and
a chaos replay with a leader kill) over the raw framing with all three
blocked, runs the daemon tier (a leader
and a follower) with ``yaml`` blocked too, and ``chip_smoke.py`` refuses
to run without a CUDA card or without the port beside it."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "koordinator_tpu_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "koordinator_tpu") or module.startswith("google.protobuf")


def test_no_source_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _grpc_import_sites(path: Path):
    """(enclosing function name or None, line) of every ``grpc`` import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    sites = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.module:
                names = [child.module]
            if any(n.split(".")[0] == "grpc" for n in names):
                sites.append((func, child.lineno))
            visit(child, inner)

    visit(tree, None)
    return sites


def test_grpc_is_imported_only_by_the_grpc_transport():
    sites = {str(p.relative_to(REPO)): _grpc_import_sites(p)
             for p in sorted(PORT.rglob("*.py"))}
    sites = {p: s for p, s in sites.items() if s}
    # the two builders of gRPC transports: the server's and the client's
    assert list(sites) == ["koordinator_tpu_torch/bridge/client.py",
                           "koordinator_tpu_torch/bridge/server.py"]
    assert [func for func, _ in sites["koordinator_tpu_torch/bridge/server.py"]] == [
        "make_server"]
    assert [func for func, _ in sites["koordinator_tpu_torch/bridge/client.py"]] == [
        "_grpc_channel"]
    # chip_smoke.py reports whether grpc imports and, where it does, holds
    # the gRPC transport against the fixtures: inside functions only
    assert all(func is not None for func, _ in _grpc_import_sites(REPO / "chip_smoke.py"))


_SEAM = r"""
import json, os, socket, struct, sys, tempfile
for blocked in ("jax", "jaxlib", "grpc", "google.protobuf"):
    sys.modules[blocked] = None  # any import of them now raises ImportError
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.udsserver import (
    METHOD_ASSIGN, METHOD_SCORE, METHOD_SYNC, serve_raw_uds)
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.golden import build_sync_request
nodes, pods, gangs, quotas = generators.quota_colocation(pods=24, nodes=6)
req, _ = build_sync_request(nodes, pods, gangs, quotas)
path = os.path.join(tempfile.mkdtemp(), "scorer.sock")
srv = serve_raw_uds(path, device="cpu")
conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
conn.settimeout(120)
conn.connect(path)

def recv(n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        assert chunk, "server closed the connection"
        buf += chunk
    return buf

def call(method, msg, cls):
    body = msg.SerializeToString()
    conn.sendall(struct.pack(">BI", method, len(body)) + body)
    status, n = struct.unpack(">BI", recv(5))
    payload = recv(n)
    assert status == 0, payload
    return cls.FromString(payload)

try:
    sync = call(METHOD_SYNC, req, wire.SyncReply)
    score = call(METHOD_SCORE, wire.ScoreRequest(snapshot_id=sync.snapshot_id, top_k=3,
                                                 flat=True), wire.ScoreReply)
    assign = call(METHOD_ASSIGN, wire.AssignRequest(snapshot_id=sync.snapshot_id),
                  wire.AssignReply)
finally:
    conn.close()
    srv.stop()
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "grpc", "koordinator_tpu") or m.startswith("google.protobuf")))
print(json.dumps({"pods": sync.pods, "groups": len(score.flat.counts) // 4,
                  "assigned": len(assign.assignment), "path": assign.path,
                  "loaded": loaded}))
"""


def test_seam_serves_over_uds_with_jax_grpc_and_protobuf_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _SEAM], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"pods": 24, "groups": 24, "assigned": 24, "path": "scan",
                   "loaded": []}


_REPLAY = r"""
import json, sys
for blocked in ("jax", "jaxlib", "grpc", "google.protobuf"):
    sys.modules[blocked] = None  # any import of them now raises ImportError
from koordinator_tpu_torch.harness.trace import TraceConfig, TraceReplay, generate_trace
trace = generate_trace(TraceConfig(seed=7, nodes=8, pod_slots=48, tenants=2, gangs=4,
                                   gang_min_member=4, events=14))
report = TraceReplay(trace, device="cpu", transport="raw").run()
import tempfile
from koordinator_tpu_torch.harness.chaos import ChaosTraceReplay
with tempfile.TemporaryDirectory() as td:
    chaos = ChaosTraceReplay(trace, td, fail_at=3, fail_n=4, kill_at=9, device="cpu").run()
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "grpc", "koordinator_tpu") or m.startswith("google.protobuf")))
print(json.dumps({"events": report.events_replayed, "parity": report.parity_checks,
                  "retraces": report.retraces, "builds": report.builds, "loaded": loaded,
                  "chaos": {"parity_ok": chaos.parity_ok, "retraces": chaos.retraces,
                            "builds": chaos.builds, "recovered": chaos.recovery_ms is not None,
                            "tripped": chaos.breaker_trips > 0,
                            "collected": chaos.dead_leader_collected}}))
"""


def test_trace_replay_runs_over_raw_with_jax_grpc_and_protobuf_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _REPLAY], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"events": 14, "parity": 15, "retraces": 0, "builds": 0, "loaded": [],
                   "chaos": {"parity_ok": True, "retraces": 0, "builds": 0, "recovered": True,
                             "tripped": True, "collected": True}}


_ISOLATED = r"""
import json, sys
import torch
sys.modules["jax"] = None        # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import koordinator_tpu_torch
import koordinator_tpu_torch.solver
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.config import CycleConfig
from koordinator_tpu_torch.solver import run_cycle
snap = generators.quota_colocation_snapshot(pods=24, nodes=6, device="cpu")[0]
res = run_cycle(snap)
wave = run_cycle(snap, CycleConfig(wave=8, top_m=2))
from koordinator_tpu_torch.solver import (
    build_candidates, masked_top_k, rescore_dirty, score_candidates, score_cycle,
    score_upper_bound, sparse_top_k)
from koordinator_tpu_torch.solver.resident import apply_flat_delta
from koordinator_tpu_torch.solver.terms import default_term_config
snap = generators.with_term_tensors(snap, seed=0)
tcfg = default_term_config(packing_headroom={"cpu": 98})
terms_res = run_cycle(snap, tcfg)
scores, feasible = score_cycle(snap, tcfg)
top = masked_top_k(scores, feasible, k=4, hi=score_upper_bound(tcfg))
apply_flat_delta(snap.nodes.requested, [0], [1000])
scores, feasible = rescore_dirty(snap, scores, feasible, [0], [], tcfg)
scfg = CycleConfig(candidate_width=8)
cand, count = build_candidates(snap, scfg)
stop = sparse_top_k(*score_candidates(snap, cand, scfg), cand, k=2,
                    hi=score_upper_bound(scfg))
loaded = sorted(m for m in sys.modules
                if m == "koordinator_tpu" or m.startswith("koordinator_tpu."))
print(json.dumps({"placed": int((res.assignment >= 0).sum()), "path": res.path,
                  "wave_path": wave.path, "wave_rounds": int(wave.rounds) > 0,
                  "same": bool((wave.assignment == res.assignment).all()),
                  "terms_path": terms_res.path, "top_shape": list(top[1].shape),
                  "rescored": bool(torch.equal(scores, score_cycle(snap, tcfg)[0])),
                  "sparse_shape": list(stop[1].shape),
                  "port_modules": sorted(m for m in sys.modules
                                         if m.startswith("koordinator_tpu_torch.solver.")),
                  "reference_modules": loaded}))
"""


def test_port_runs_a_cycle_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATED], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ported = got.pop("port_modules")
    assert got == {"placed": 24, "path": "scan", "wave_path": "wave", "wave_rounds": True,
                   "same": True, "terms_path": "scan", "top_shape": [24, 4],
                   "rescored": True, "sparse_shape": [24, 2], "reference_modules": []}
    for mod in ("candidates", "dense", "greedy", "incremental", "resident", "terms",
                "topk", "wave", "wide"):
        assert f"koordinator_tpu_torch.solver.{mod}" in ported


def test_chip_smoke_needs_the_port_beside_it(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        # on a card the script runs for real; its no-card branch is what
        # this test covers, so check only that it is there
        assert "torch.cuda.is_available()" in (REPO / "chip_smoke.py").read_text()
        return
    code = (
        "import sys, runpy; sys.modules['jax'] = None; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr


def _lazy_import_sites(path: Path, top: str):
    """(enclosing function or None) of every import of ``top``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    sites = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.module:
                names = [child.module]
            if any(n.split(".")[0] == top for n in names):
                sites.append(func)
            visit(child, inner)

    visit(tree, None)
    return sites


def test_yaml_is_imported_only_where_a_config_string_is_parsed():
    sites = {str(p.relative_to(REPO)): _lazy_import_sites(p, "yaml")
             for p in sorted(PORT.rglob("*.py"))}
    assert {p: s for p, s in sites.items() if s} == {
        "koordinator_tpu_torch/scheduler/config_api.py": ["load_config"]}


_DAEMONS = r"""
import json, os, sys, tempfile, time
for blocked in ("jax", "jaxlib", "grpc", "yaml", "google.protobuf"):
    sys.modules[blocked] = None  # any import of them now raises ImportError
import numpy as np
from koordinator_tpu_torch.bridge.client import ScorerClient
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.scheduler.server import SchedulerServer
d = tempfile.mkdtemp(prefix="ki", dir="/tmp")
common = dict(device="cpu", enable_grpc=False, http_port=0)
leader = SchedulerServer(lease_path=d + "/l.lease", uds_path=d + "/l.sock",
                         state_dir=d + "/l", journal=True, prewarm=True, **common).start()
follower = SchedulerServer(lease_path=d + "/f.lease", uds_path=d + "/f.sock",
                           state_dir=d + "/f", replicate_from=d + "/l.sock.repl",
                           **common).start()
cli = ScorerClient("raw://" + d + "/l.sock.raw", followers=["raw://" + d + "/f.sock.raw"])
try:
    nodes, pods, _, _ = generators.quota_colocation(pods=24, nodes=6)
    deadline = time.time() + 60
    while not leader.elector.is_leader and time.time() < deadline:
        time.sleep(0.05)
    sid = cli.sync(
        node_allocatable=np.asarray([res.resource_vector(n["allocatable"]) for n in nodes]),
        node_names=[n["name"] for n in nodes],
        pod_requests=np.asarray([res.resource_vector(p["requests"]) for p in pods]),
        pod_names=[p["name"] for p in pods]).snapshot_id
    while follower.servicer.snapshot_id() != sid and time.time() < deadline:
        time.sleep(0.02)
    groups = len(cli.score_flat(top_k=3)[1])
    assignment = cli.assign()[0]
finally:
    cli.close()
    follower.stop()
    leader.stop()
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "grpc", "yaml", "koordinator_tpu")
    or m.startswith("google.protobuf")))
print(json.dumps({"replicated": follower.servicer.snapshot_id() == sid, "groups": groups,
                  "assigned": len(assignment), "loaded": loaded}))
"""


def test_the_daemon_tier_serves_with_jax_grpc_yaml_and_protobuf_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _DAEMONS], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"replicated": True, "groups": 24, "assigned": 24, "loaded": []}
