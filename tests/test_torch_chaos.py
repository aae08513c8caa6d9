"""The port's chaos harness (``harness/chaos.py``), held against the JAX
package.

* The reference's chaos cases (``tests/test_chaos.py``) run through both
  packages (the reference module loaded a second time with its imports
  bound to the port, servicers on the CPU).
* ``ChaosTier`` in both packages, on the same ``FaultPlan`` seed and the
  same Syncs (``harness/golden.py`` requests at 32 pods x 8 nodes): a
  leader kill and warm restart, a torn journal tail, a promotion, then
  convergence.  The frames are byte-identical across the packages, so the
  chaos channels mutate them identically: every state digest, flat-Score
  reply, journal file byte, resync count and delivery count must match.
* ``ChaosTraceReplay`` on the port over the raw framing at the reference's
  CPU size: the gate passes, the trace digest is the reference's, and the
  ``unrecovered=True`` control fails the gate.

No wall-clock assertion: recovery SLO budgets here are ones a loaded
6-worker run cannot miss.
"""

import os
import uuid

import numpy as np
import pytest

import koordinator_tpu.obs  # noqa: F401  (before replication: the reference's import cycle)
from koordinator_tpu.bridge.codegen import pb2
from koordinator_tpu.bridge.state import numpy_to_tensor as j_numpy_to_tensor
from koordinator_tpu.harness import chaos as jchaos
from koordinator_tpu.harness import trace as jtrace
from koordinator_tpu.replication.journal import FrameJournal as JJournal
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.bridge.state import numpy_to_tensor as t_numpy_to_tensor
from koordinator_tpu_torch.harness import chaos as tchaos
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness.anchor import (
    CHAOS_ANCHOR_CFG,
    CHAOS_ANCHOR_SHA256,
    CHAOS_HEADLINE_CFG,
)
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.harness.trace import TraceConfig, generate_trace
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.obs import slo as slo_mod
from koordinator_tpu_torch.obs.assemble import assemble
from koordinator_tpu_torch.replication.journal import FrameJournal as TJournal
from test_torch_constraints import PACKAGES, reference_cases, run_reference_case

CASES = reference_cases("test_chaos")


def test_the_reference_cases_are_collected():
    assert len(CASES) >= 6


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path):
    run_reference_case(module, cls, method, package, tmp_path)


# ---------------------------------------------------------------------------
# ChaosTier, both packages, the same faults
# ---------------------------------------------------------------------------

NASTY = dict(drop=0.12, duplicate=0.12, reorder=0.18, corrupt=0.08, truncate=0.06)


def _pinned(monkeypatch):
    """Deterministic epochs (uuid4) and journal stamps (the journal's
    clock) for both packages, so journals compare byte for byte."""
    counter = iter(range(1, 1 << 30))
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter) << 96))
    for journal in (JJournal, TJournal):
        defaults = list(journal.__init__.__defaults__)
        defaults = [(lambda: 0.0) if callable(d) else d for d in defaults]
        monkeypatch.setattr(journal.__init__, "__defaults__", tuple(defaults))


def _syncs(msg_cls, numpy_to_tensor):
    """The Sync stream: one full Sync of the golden requests, then warm
    usage deltas and scalar priority re-sends, seeded."""
    nodes_l, pods_l, gangs, quotas = generators.quota_colocation(
        seed=3, pods=32, nodes=8, tenants=2)
    req, _ = build_sync_request(nodes_l, pods_l, gangs, quotas)
    out = [msg_cls.FromString(req.SerializeToString())]
    prev = np.asarray([res.resource_vector(n.get("usage", {})) for n in nodes_l],
                      dtype=np.int64)
    rng = np.random.default_rng(5)
    for step in range(18):
        if step % 7 == 3:
            scalar = msg_cls()
            scalar.pods.priority.extend(int(v) for v in rng.integers(0, 9000, 32))
            out.append(scalar)
        else:
            cur = prev.copy()
            cur.flat[int(rng.integers(0, 64)) % cur.size] += 1 + step
            warm = msg_cls()
            warm.nodes.usage.CopyFrom(numpy_to_tensor(cur, prev))
            prev = cur
            out.append(warm)
    return out


def drive_tier(chaos, msg_cls, numpy_to_tensor, state_dir, **kw):
    """Every observable of one faulted tier run, in order."""
    tier = chaos.ChaosTier(state_dir, followers=2, plan=chaos.FaultPlan(**NASTY),
                           seed=11, **kw)
    seen = []
    msgs = _syncs(msg_cls, numpy_to_tensor)
    for step, msg in enumerate(msgs):
        if step == 6:
            tier.crash_leader()
            stats = tier.restart_leader()
            seen.append(("restart", stats["resumed_id"], stats["truncated"],
                         stats["replayed_frames"]))
        if step == 10:
            tier.crash_leader()
            tier.damage_journal(cut_bytes=9)
            stats = tier.restart_leader()
            seen.append(("damaged", stats["resumed_id"], bool(stats["truncated"])))
            # the torn frame's Sync never became durable: the writer
            # re-sends it to the recovered leader (the oracle has it)
            seen.append(("resent", tier.sync(msgs[step - 1], oracle=False)))
        if step == 14:
            tier.crash_leader()
            seen.append(("promote", tier.promote(0)))
        sid = tier.sync(msg)
        seen.append(("sync", sid, chaos.state_digest(tier.leader),
                     [chaos.state_digest(f.servicer) for f in tier.followers]))
        # as the reference's acceptance run: converged after every Sync, so
        # a promoted follower holds every acknowledged write
        tier.converge()
        if step % 4 == 0:
            seen.append(("score", chaos.flat_score_bytes(tier.leader, sid)))
    with open(tier.journal_path, "rb") as fh:
        journal = fh.read()
    with open(tier.journal_path + ".promoted", "rb") as fh:
        promoted = fh.read()
    injected = [f.channel.injected for f in tier.followers]
    return {"seen": seen, "journal": journal, "promoted": promoted,
            "resyncs": tier.resyncs, "torn_checks": tier.torn_checks,
            "stats": dict(tier.stats), "injected": injected}


def test_chaos_tier_matches_the_reference(tmp_path, monkeypatch):
    _pinned(monkeypatch)
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    want = drive_tier(jchaos, pb2.SyncRequest, j_numpy_to_tensor, str(tmp_path / "j"))
    _pinned(monkeypatch)
    got = drive_tier(tchaos, wire.SyncRequest, t_numpy_to_tensor, str(tmp_path / "t"),
                     device="cpu")
    for key in ("injected", "stats", "resyncs", "torn_checks", "journal", "promoted"):
        assert got[key] == want[key], key
    assert len(got["seen"]) == len(want["seen"])
    for i, (a, b) in enumerate(zip(got["seen"], want["seen"])):
        assert a == b, f"step {i}: {a[0]}"
    # the faults fired and the recovery paths ran
    fired = {k: sum(f[k] for f in got["injected"]) for k in NASTY}
    assert fired["drop"] and fired["reorder"] and fired["corrupt"] + fired["truncate"], fired
    epochs = {entry[1].split("-")[0] for entry in got["seen"] if entry[0] == "sync"}
    assert len(epochs) == 3  # the first leader, the torn tail's fence, the promotion
    assert got["resyncs"] > 2 and got["torn_checks"] > 30


def test_chaos_tier_defaults_to_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tchaos.ChaosTier(str(tmp_path))


def test_mirror_keys_are_the_references():
    assert tchaos.MIRROR_KEYS == jchaos.MIRROR_KEYS


# ---------------------------------------------------------------------------
# chaos x trace on the port
# ---------------------------------------------------------------------------


def _cpu_trace():
    return generate_trace(TraceConfig(**CHAOS_ANCHOR_CFG["on_cpu"]))


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """One chaos replay at the reference's CPU size over the raw framing,
    tracing on (the bench's shape: fail at a quarter, kill at two
    thirds)."""
    trace = _cpu_trace()
    td = tmp_path_factory.mktemp("chaos-trace")
    trace_dir = str(td / "traces")
    events = len(trace.events)
    report = tchaos.ChaosTraceReplay(
        trace, str(td), fail_at=events // 4, fail_n=4, kill_at=(2 * events) // 3,
        trace_export=trace_dir, device="cpu",
    ).run()
    return trace, report, assemble([trace_dir])


def test_chaos_trace_gate_passes_on_the_port(replay):
    _, report, assembly = replay
    verdicts = slo_mod.evaluate_slos(
        report.registry, tchaos.chaos_trace_slo_specs(report.bands, recovery_slo_ms=600_000))
    assert slo_mod.slos_pass(verdicts), [v.reason for v in verdicts if not v.ok]
    assert report.parity_ok, report.parity_detail
    assert report.retraces == 0 and report.builds == 0
    assert report.recovery_ms is not None and report.dead_leader_collected
    assert report.breaker_trips > 0 and report.degraded_replies > 0
    assert report.rpc_errors >= 3
    assert len(assembly.traces) > 0 and not assembly.client_orphans


def test_chaos_trace_digest_is_the_references(replay):
    trace, _, _ = replay
    ref = jtrace.generate_trace(jtrace.TraceConfig(**CHAOS_ANCHOR_CFG["on_cpu"]))
    assert trace.digest() == ref.digest()


def test_chaos_anchor_constants_from_the_reference():
    """The ``chaos`` line's trace digests on the card."""
    ref = jtrace.generate_trace(jtrace.TraceConfig(**CHAOS_ANCHOR_CFG["accelerator"]))
    assert ref.digest() == CHAOS_ANCHOR_SHA256
    assert generate_trace(TraceConfig(**CHAOS_ANCHOR_CFG["accelerator"])).digest() == (
        CHAOS_ANCHOR_SHA256)
    assert CHAOS_HEADLINE_CFG["events"] == 24


def test_unrecovered_control_fails_the_gate(tmp_path):
    trace = generate_trace(TraceConfig(seed=3, nodes=16, pod_slots=64, gangs=3,
                                       gang_min_member=2, events=10, top_k=4))
    report = tchaos.ChaosTraceReplay(trace, str(tmp_path), fail_at=2, kill_at=6,
                                     unrecovered=True, device="cpu").run()
    verdicts = slo_mod.evaluate_slos(report.registry,
                                     tchaos.chaos_trace_slo_specs(report.bands))
    assert report.recovery_ms is None
    assert not report.parity_ok
    assert not slo_mod.slos_pass(verdicts)
    assert report.dead_leader_collected is None


def test_overload_band_storm_sheds_the_free_band_on_the_port():
    storm = tchaos.overload_band_storm(device="cpu")
    assert storm["shed_by_band"].get("koord-free", 0) > 0
    assert storm["shed_by_band"].get("koord-prod", 0) == 0
    assert storm["errors"] == 0
    assert storm["served"].get("koord-prod", 0) > 0


def test_a_stopped_raw_server_lets_go_of_its_servicer(tmp_path):
    """``RawUdsServer.stop`` ends its accept thread (a closed listening
    socket alone does not wake ``accept()``), so a killed leader's servicer
    and its resident tensors are collected before a restart binds the same
    socket."""
    import gc
    import weakref

    from koordinator_tpu_torch.bridge.server import ScorerServicer
    from koordinator_tpu_torch.bridge.udsserver import RawUdsServer

    sv = ScorerServicer(device="cpu", trace_export=False)
    server = RawUdsServer(str(tmp_path / "s.sock"), servicer=sv).start()
    dead, thread = weakref.ref(sv), server._thread
    server.stop()
    sv.telemetry.close()
    del sv, server
    gc.collect()
    assert not thread.is_alive()
    assert dead() is None


def _flip_outcomes(chaos, server, follower_mod, msg_cls, numpy_to_tensor, **kw):
    """For every byte of one warm delta frame, that byte flipped (``^
    0xFF``, as ``ChaosChannel`` corrupts): what a follower holding the
    previous state does with it, and whether its state then equals the
    leader's."""
    from koordinator_tpu_torch.replication import codec

    full, warm = _syncs(msg_cls, numpy_to_tensor)[:2]
    leader = server.ScorerServicer(score_memo=False, **kw)
    frames = []
    leader.replication_hook = lambda req, sid, wire_bytes=None: frames.append(
        (sid, wire_bytes if wire_bytes is not None else req.SerializeToString()))
    leader.sync(full)
    base = leader.export_replication_snapshot()
    leader.sync(warm)
    sid, payload = frames[-1]
    epoch, gen = sid[1:].split("-")
    raw = codec.encode_frame(codec.KIND_DELTA, epoch, int(gen), 0, payload)
    want = chaos.state_digest(leader)
    out = []
    for i in range(len(raw)):
        follower = follower_mod.FollowerServicer(score_memo=False, **kw)
        applier = follower_mod.ReplicaApplier(follower)
        applier.offer(codec.decode_frame(codec.encode_frame(codec.KIND_FULL, *base[:2], 0,
                                                            base[2])))
        bad = bytearray(raw)
        bad[i] ^= 0xFF
        try:
            result = applier.offer(codec.decode_frame(bytes(bad)))
        except codec.FrameError:
            result = "frame-error"
        out.append((result, chaos.state_digest(follower) == want))
    return out


def test_a_flipped_payload_byte_applies_silently_in_both_packages(monkeypatch):
    """A replication frame carries no checksum (the reference's format,
    which the port keeps byte for byte): flipping one byte of a delta
    frame is refused for some positions and applied for others, and some
    applied flips leave the follower at the leader's snapshot id with
    other state.  Both packages do the same at every position (ROADMAP
    Queue C)."""
    import koordinator_tpu.bridge.server as jserver
    import koordinator_tpu.replication.follower as jfollower
    import koordinator_tpu_torch.bridge.server as tserver
    import koordinator_tpu_torch.replication.follower as tfollower

    _pinned(monkeypatch)
    want = _flip_outcomes(jchaos, jserver, jfollower, pb2.SyncRequest, j_numpy_to_tensor)
    _pinned(monkeypatch)
    got = _flip_outcomes(tchaos, tserver, tfollower, wire.SyncRequest, t_numpy_to_tensor,
                         device="cpu")
    assert got == want
    applied = [same for result, same in got if result == "applied"]
    assert any(not same for same in applied), "no flipped byte applied a different state"
    assert any(result != "applied" for result, _ in got)


def test_chaos_trace_gate_over_grpc(tmp_path):
    """The same gate over gRPC (``make_server``), the reference's transport:
    the leader killed and restarted on the same socket, parity after.
    gRPC logs each injected handler failure with its traceback, and a log
    record kept by the test runner would keep the killed leader's frames
    alive: logging is off for the replay."""
    import logging

    trace = generate_trace(TraceConfig(seed=3, nodes=16, pod_slots=64, gangs=3,
                                       gang_min_member=2, events=10, top_k=4))
    logging.disable(logging.CRITICAL)
    try:
        report = tchaos.ChaosTraceReplay(trace, str(tmp_path), fail_at=2, kill_at=6,
                                         device="cpu", transport="grpc").run()
    finally:
        logging.disable(logging.NOTSET)
    assert report.parity_ok, report.parity_detail
    assert report.recovery_ms is not None and report.breaker_trips > 0
    assert report.retraces == 0 and report.builds == 0
    assert report.dead_leader_collected is True
