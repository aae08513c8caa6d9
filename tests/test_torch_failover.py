"""The reference's ``failover`` and ``coldstart`` legs on the CPU, every
daemon a process of its own (``koordinator_tpu_torch/harness/failover.py``),
at 128 pods × 64 nodes of ``quota_colocation`` seed 0.

Each test holds a time limit of its own (``SIGALRM``), every wait in the
harness has one too, and each leg reaps its processes: the tests check that
no process started under the leg's directory is left.
"""

import contextlib
import ctypes
import os
import shutil
import signal
import tempfile

import numpy as np
import pytest

from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.state import tensor_to_numpy
from koordinator_tpu_torch.config import CycleConfig
from koordinator_tpu_torch.harness import failover, generators as g
from koordinator_tpu_torch.harness.anchor import cycle_digest, result_digests
from koordinator_tpu_torch.model.snapshot import snapshot_from_numpy
from koordinator_tpu_torch.solver import run_cycle

PODS, NODES = 128, 64
LIMIT_S = 240


@contextlib.contextmanager
def _alarm(limit_s):
    """Raise in the block, rather than hang the run, past ``limit_s``."""
    def expired(signum, frame):
        raise TimeoutError(f"ran past its {limit_s} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(limit_s)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def time_limit():
    with _alarm(LIMIT_S):
        yield


def _short_dir():
    return tempfile.mkdtemp(prefix="kf", dir="/tmp")


def _processes_under(base):
    """pids of the processes whose command line names ``base``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                if base.encode() in fh.read():
                    out.append(int(pid))
        except OSError:
            continue
    return out


def _cluster():
    snap, *lists, _ = g.quota_colocation_snapshot(pods=PODS, nodes=NODES, device="cpu")
    result = run_cycle(snap)
    want = {"digests": result_digests(result, PODS, NODES, len(lists[3])),
            "assign": cycle_digest(result.assignment[:PODS], result.status[:PODS])}
    return lists, want


@pytest.fixture(scope="module")
def failover_run():
    """One failover leg, shared by the tests that read it."""
    base = _short_dir()
    lists, want = _cluster()
    try:
        with _alarm(LIMIT_S):
            out = failover.failover_leg(base, lists, want, device="cpu")
        yield out, _processes_under(base)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def test_the_journal_warm_restart_resumes_the_same_chain(time_limit, failover_run):
    out, _ = failover_run
    before, after = out["resumed"]["before_kill"], out["resumed"]["first_ack"]
    epoch, gen = before.rsplit("-", 1)
    assert after == f"{epoch}-{int(gen) + 1}"
    # the full Sync and the deltas, each appended as one journal frame,
    # all of them replayed (the journal's epoch base frame besides)
    assert out["journal_appends"] == out["deltas"] + 1
    assert out["replayed_frames"] >= out["journal_appends"]
    assert out["journal_replay_ms"] > 0 and out["journal_append_us"] > 0
    split = out["warm_restart"]
    parts = ("spawn_to_import_ms", "cuda_init_ms", "journal_replay_ms", "server_start_ms",
             "first_ack_ms")
    assert all(split[p] >= 0 for p in parts), split
    assert sum(split[p] for p in parts) == pytest.approx(split["total_ms"], rel=1e-6)
    assert out["warm_restart_ms"] > split["total_ms"]


def test_the_promoted_follower_and_the_restarted_leader_place_the_synced_cluster(
        time_limit, failover_run):
    out, _ = failover_run
    assert out["failover"]["promoted_snapshot_id"].rsplit("-", 1)[0] != \
        out["resumed"]["first_ack"].rsplit("-", 1)[0]
    assert out["failover_ms"] > 0
    for leg in ("leg_a_assign", "leg_b_assign"):
        got = out[leg]
        assert got["equal_to_headline"] and got["path"] == "scan"
        assert got["builds_after_warmup"] == got["ledger_compiles_after_warmup"] == 0
        assert got["demotions"] == 0
        assert sum(got["checked_assign_launches"].values()) == 0  # no kernel on the CPU


def test_the_storm_reads_through_both_failovers_and_resyncs_are_counted(
        time_limit, failover_run):
    out, _ = failover_run
    reads = out["reads"]
    assert reads["ok"] >= reads["ok_during_failover"] > 0
    # the journal's point: the follower resumes the restarted leader's
    # stream without a full resync
    assert out["resyncs_during_failover"] == 0


def test_the_failover_leg_leaves_no_process(time_limit, failover_run):
    out, left = failover_run
    assert out["processes_left"] == 0 and left == []


def test_cold_and_warm_boots_serve_equal_digests(time_limit):
    base = _short_dir()
    lists, _ = _cluster()
    try:
        out = failover.coldstart_leg(base, lists, build_dir=os.path.join(base, "kb"),
                                     device="cpu")
        assert _processes_under(base) == []
    finally:
        shutil.rmtree(base, ignore_errors=True)
    assert out["score_digests_equal"] and out["assign_digests_equal"]
    for boot in ("cold", "warm"):
        assert out[boot]["spawn_to_first_assign_ms"] >= out[boot]["spawn_to_first_score_ms"] > 0
        # a CPU daemon builds nothing, so nothing is recorded or replayed
        assert out[boot]["prewarm"]["state"] == "done"
        assert out[boot]["prewarm"]["failed"] == 0
        assert out[boot]["build_dir_files"] == []


def test_the_serial_and_pipelined_candidate_builds_are_byte_equal(time_limit):
    snap = snapshot_from_numpy(g.sparse_leaves(4096, 64, n_open=32, seed=16), device="cpu")
    out = failover.candidate_build_leg(snap, CycleConfig(candidate_width=64))
    assert out["byte_equal"] and "KOORD_PARALLEL_BUILD" not in os.environ


def test_the_delta_frames_restore_the_full_syncs_usage():
    lists = g.quota_colocation(pods=PODS, nodes=NODES)
    full, frames, noop = failover.sync_frames(lists, 8)
    base = tensor_to_numpy(wire.SyncRequest.FromString(full).nodes.usage, None)
    cur, changed = base, 0
    for frame in frames:
        cur = tensor_to_numpy(wire.SyncRequest.FromString(frame).nodes.usage, cur)
        changed += int(not np.array_equal(cur, base))
    assert np.array_equal(cur, base) and changed == 4
    assert noop == b""
    with pytest.raises(ValueError):
        failover.sync_frames(lists, 3)


def test_a_daemon_that_dies_fails_the_wait_instead_of_hanging(time_limit):
    base = _short_dir()
    try:
        d = failover.Daemon(base, "x", device="cpu")
        d.kill()
        with pytest.raises(AssertionError, match="exited"):
            d.first_ack(failover.METHOD_SYNC, b"", timeout_s=60)
        assert d.stop() == -signal.SIGKILL
    finally:
        shutil.rmtree(base, ignore_errors=True)


def test_a_promotion_signal_taken_by_another_thread_still_promotes(time_limit):
    """The kernel may hand a process-directed SIGUSR2 to any thread of the
    follower; its Python handler runs only in the main thread, which wakes
    within the daemon's park interval to run it.  Sent to a thread that is
    not the main one, the signal still promotes."""
    base = _short_dir()
    daemons = []
    try:
        leader = failover.Daemon(base, "l", device="cpu")
        daemons.append(leader)
        leader.wait("the lease", lambda: (leader.get("/healthz") or {}).get("leader"))
        follower = failover.Daemon(base, "f", device="cpu", replicate_from=leader.repl)
        daemons.append(follower)
        follower.wait("the subscription", lambda: (follower.get("/healthz") or {}).get(
            "replica", {}).get("role") == "follower")
        pid = follower.proc.pid
        tid = next(int(t) for t in sorted(os.listdir(f"/proc/{pid}/task")) if int(t) != pid)
        assert ctypes.CDLL(None, use_errno=True).tgkill(pid, tid, signal.SIGUSR2) == 0
        follower.wait("the promotion", lambda: (follower.get("/healthz") or {}).get(
            "replica", {}).get("promoted"), timeout_s=30.0)
    finally:
        for daemon in reversed(daemons):
            daemon.stop()
        shutil.rmtree(base, ignore_errors=True)
