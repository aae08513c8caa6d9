"""The port's relay-tree and elastic-tier harness (``harness/relay.py``),
held against the JAX package.

* The reference's relay cases (``tests/test_relay_tree.py``: the relay
  frame cache, a depth-3 chain of real daemons in byte parity with a flat
  follower, an interior death resumed through an ancestor with no full
  open and no resync, the epoch fence, compression, sender batching, the
  warm two-hop stream) run through both packages, the port's daemons on
  the CPU.
* ``autoscale_wave`` with the bookkeeping levers: the decision log, the
  per-tick records and the verdict equal the reference's on the same seed.
* A ``RelayTier`` at depth 3 with a flat follower, driven across the
  packages' frames: the port's chain serves the reference's Score bytes.

Every tier is stopped in a ``finally``; waits go through ``wait_until``
with a bounded timeout.
"""

import tempfile

import pytest

import koordinator_tpu.obs  # noqa: F401  (before replication: the reference's import cycle)
from koordinator_tpu.bridge.codegen import pb2
from koordinator_tpu.bridge.server import ScorerServicer as RefServicer
from koordinator_tpu.harness import relay as jrelay
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.harness import generators
from koordinator_tpu_torch.harness import relay as trelay
from koordinator_tpu_torch.harness.golden import build_sync_request
from koordinator_tpu_torch.replication.autoscale import AutoscalePolicy
from test_torch_constraints import PACKAGES, reference_cases, run_reference_case

CASES = reference_cases("test_relay_tree")


def test_the_reference_cases_are_collected():
    assert len(CASES) >= 12


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path):
    run_reference_case(module, cls, method, package, tmp_path)


def _decisions(report):
    """Everything ``autoscale_wave`` decides and models (the decision log
    and per-tick records, the verdict): all of it but the levers' wall
    times and the registry."""
    return {k: v for k, v in report.items()
            if k not in ("registry", "spawn_to_ready_ms", "spawn_to_ready_ms_all")}


@pytest.mark.parametrize("seed,ticks,peak", [(0, 48, 10.0), (3, 24, 6.0), (7, 32, 14.0)])
def test_autoscale_wave_decisions_match_the_reference(seed, ticks, peak):
    calls = {"j": [], "t": []}
    want = jrelay.autoscale_wave(ticks=ticks, peak=peak, seed=seed,
                                 spawn=lambda: calls["j"].append("up"),
                                 drain=lambda: calls["j"].append("down"))
    got = trelay.autoscale_wave(ticks=ticks, peak=peak, seed=seed,
                                spawn=lambda: calls["t"].append("up"),
                                drain=lambda: calls["t"].append("down"))
    assert calls["t"] == calls["j"] and "up" in calls["t"]
    assert _decisions(got) == _decisions(want)
    assert len(got["spawn_to_ready_ms_all"]) == got["scale_ups"] > 0


def test_autoscale_wave_with_a_custom_policy_matches():
    def policy(mod):
        return mod(min_replicas=1, max_replicas=3, p99_high_ms=40.0, min_count=8,
                   up_after=2, down_after=2, cooldown_ticks=2)

    from koordinator_tpu.replication.autoscale import AutoscalePolicy as JPolicy

    want = jrelay.autoscale_wave(ticks=30, policy=policy(JPolicy), seed=5)
    got = trelay.autoscale_wave(ticks=30, policy=policy(AutoscalePolicy), seed=5)
    assert _decisions(got) == _decisions(want)
    assert got["peak_replicas"] == 3


def test_wave_profile_matches():
    for ticks, peak in ((4, 2.0), (48, 10.0), (13, 7.5)):
        assert trelay.wave_profile(ticks, peak) == jrelay.wave_profile(ticks, peak)


def _tiny(seed):
    nodes, pods, gangs, quotas = generators.quota_colocation(seed=seed, pods=32, nodes=8,
                                                            tenants=2)
    return build_sync_request(nodes, pods, gangs, quotas)[0]


def test_port_chain_serves_the_references_score_bytes():
    """The same Syncs into the port's depth-3 tree and a reference
    servicer: every hop and the flat follower answer the reference's flat
    Score bytes; an interior kill then resumes without a full open."""
    ref = RefServicer(score_memo=False)
    with tempfile.TemporaryDirectory(dir="/tmp") as tmp:
        tier = trelay.RelayTier(tmp, chain=3, flat=1, batch_bytes=64 * 1024, device="cpu")
        try:
            for seed in (0, 1):
                msg = _tiny(seed)
                sid = tier.sync(msg)
                ref.sync(pb2.SyncRequest.FromString(msg.SerializeToString()))
                assert tier.wait(sid, timeout_s=120.0)
            want = ref.score(pb2.ScoreRequest(snapshot_id=ref.snapshot_id(), top_k=8,
                                              flat=True)).flat.SerializeToString()
            for srv in [tier.leader] + tier.followers():
                got = srv.servicer.score(wire.ScoreRequest(snapshot_id=sid, top_k=8,
                                                           flat=True))
                assert got.flat.SerializeToString() == want
            victim = tier.chain[1]
            opens0 = sum(s._publisher.subscriptions - s._publisher.resumed_subscriptions
                         for s in [tier.leader] + tier.followers()
                         if s is not victim and s._publisher is not None)
            resyncs0 = sum(s.applier.resyncs for s in tier.followers() if s is not victim)
            tier.kill(1)
            for seed in (2, 3):
                sid = tier.sync(_tiny(seed))
            assert tier.wait(sid, timeout_s=120.0)
            assert tier.full_opens() == opens0 and tier.resyncs() == resyncs0
            assert sum(s._subscriber.ancestor_switches for s in tier.followers()) >= 1
        finally:
            tier.stop()
