"""Seeded parity of the port's sharded cycles with the JAX package's:
fuzzed clusters (quota, gangs, aggregated and prod usage), both fit
strategies, with and without extended-plugin extras, the quota cluster,
one-node shards on meshes of 3 and 7, the per-pod sharded scan, the 2^31
refusal and the candidate constraint, each through JAX's
``greedy_assign_waves``/``greedy_assign_sharded`` on virtual CPU devices and
the port's on CPU meshes of the same size: all five ``CycleResult`` arrays
and ``rounds`` equal exactly.  The shard rounds also equal the
single-device ``wave_assign``'s, whose certification they share.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu import parallel as jpar
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.model import snapshot as jsnap
from koordinator_tpu.solver import wave as jwave
from koordinator_tpu_torch import parallel as tpar
from koordinator_tpu_torch.model import snapshot as tsnap
from koordinator_tpu_torch.parallel.shard_assign import _prod_sensitive
from koordinator_tpu_torch.solver import wave as twave

from test_torch_cycle import assert_cycle_equal, encode_pair, extras, quota_lists
from test_torch_wave import fuzz_pair

CPU = torch.device("cpu")


def jax_mesh(k=8):
    return jpar.make_mesh(jax.devices()[:k])


def port_mesh(k=8):
    return tpar.make_mesh([CPU] * k)


def with_strategy(jcfg, tcfg, strategy):
    return (dataclasses.replace(jcfg, fit_scoring_strategy=strategy),
            dataclasses.replace(tcfg, fit_scoring_strategy=strategy))


def extras_pair(js, seed, on):
    if not on:
        return (None, None), (None, None)
    m, s = extras(js, seed)
    return (jnp.asarray(m), jnp.asarray(s)), (torch.from_numpy(m), torch.from_numpy(s))


STRATEGIES = ("LeastAllocated", "MostAllocated")
# fuzzed clusters (tests/test_parity_fuzz.py's sampler): quota, gangs,
# aggregated usage and prod usage vary with the seed
FUZZ_SEEDS = (101, 102, 118)


@pytest.mark.parametrize("seed,strategy,with_extras",
                         list(itertools.product(FUZZ_SEEDS, STRATEGIES, (False, True))))
def test_waves_match_the_reference(seed, strategy, with_extras):
    js, ts, jcfg, tcfg = fuzz_pair(seed)
    jcfg, tcfg = with_strategy(jcfg, tcfg, strategy)
    (jm, jx), (tm, tx) = extras_pair(js, seed, with_extras)
    want, want_rounds = jpar.greedy_assign_waves(js, jax_mesh(), jcfg, extra_mask=jm,
                                                 extra_scores=jx, wave=8, top_m=2)
    got, rounds = tpar.greedy_assign_waves(ts, port_mesh(), tcfg, extra_mask=tm,
                                           extra_scores=tx, wave=8, top_m=2)
    assert got.path == "shard"
    assert_cycle_equal(got, want, f"seed {seed}")
    assert rounds == want_rounds == int(got.rounds)


def test_the_fuzz_seeds_cover_quota_gangs_and_prod_usage():
    seen = set()
    for seed in FUZZ_SEEDS:
        _, ts, _, tcfg = fuzz_pair(seed)
        if bool((ts.pods.quota_id >= 0).any()):
            seen.add("quota")
        if bool((ts.pods.gang_id >= 0).any()):
            seen.add("gangs")
        if _prod_sensitive(ts.nodes, tcfg):
            seen.add("prod")
    assert seen == {"quota", "gangs", "prod"}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_waves_on_the_quota_cluster_match_the_reference(strategy):
    js, ts = encode_pair(quota_lists(96, 16), quota=True)
    from koordinator_tpu.config import CycleConfig as JCfg
    from koordinator_tpu_torch.config import CycleConfig as TCfg

    jcfg, tcfg = JCfg(fit_scoring_strategy=strategy), TCfg(fit_scoring_strategy=strategy)
    want, want_rounds = jpar.greedy_assign_waves(js, jax_mesh(), jcfg)
    got, rounds = tpar.greedy_assign_waves(ts, port_mesh(), tcfg)
    assert_cycle_equal(got, want, strategy)
    assert rounds == want_rounds


@pytest.mark.parametrize("mesh_size", (3, 7))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_node_shards_match_the_reference(mesh_size, strategy):
    lists = jgen.loadaware_joint(seed=5, pods=16, nodes=mesh_size)
    js = jsnap.encode_snapshot(*lists, node_bucket=mesh_size)
    ts = tsnap.encode_snapshot(*lists, node_bucket=mesh_size, device="cpu")
    assert ts.nodes.capacity == mesh_size
    from koordinator_tpu.config import CycleConfig as JCfg
    from koordinator_tpu_torch.config import CycleConfig as TCfg

    jcfg, tcfg = JCfg(fit_scoring_strategy=strategy), TCfg(fit_scoring_strategy=strategy)
    want, want_rounds = jpar.greedy_assign_waves(js, jax_mesh(mesh_size), jcfg, wave=7)
    got, rounds = tpar.greedy_assign_waves(ts, port_mesh(mesh_size), tcfg, wave=7)
    assert_cycle_equal(got, want, f"{mesh_size} one-node shards")
    assert rounds == want_rounds


@pytest.mark.parametrize("seed", (102, 104))
def test_the_per_pod_sharded_scan_matches_the_reference(seed):
    js, ts, jcfg, tcfg = fuzz_pair(seed)
    (jm, jx), (tm, tx) = extras_pair(js, seed, True)
    want = jpar.greedy_assign_sharded(js, jax_mesh(), jcfg, extra_mask=jm, extra_scores=jx)
    got = tpar.greedy_assign_sharded(ts, port_mesh(), tcfg, extra_mask=tm, extra_scores=tx)
    assert got.path == "shard"
    assert_cycle_equal(got, want, f"seed {seed}")


def test_extra_scores_at_two_to_the_31_are_refused_like_the_reference():
    _, ts = encode_pair(quota_lists(16, 8), quota=True)
    xs = torch.zeros((ts.pods.capacity, ts.nodes.capacity), dtype=torch.int64)
    xs[0, 0] = 2**31
    for fn in (tpar.greedy_assign_waves, tpar.greedy_assign_sharded):
        with pytest.raises(ValueError, match="2\\^31"):
            fn(ts, port_mesh(), extra_scores=xs)


def test_candidates_constrain_the_waves_like_the_reference():
    js, ts = encode_pair(quota_lists(32, 16), quota=True)
    rng = np.random.default_rng(3)
    n = ts.nodes.capacity
    cand = np.sort(np.stack([rng.choice(n + 4, size=8, replace=False)
                             for _ in range(ts.pods.capacity)]), axis=1).astype(np.int32)
    want, want_rounds = jpar.greedy_assign_waves(js, jax_mesh(), candidates=jnp.asarray(cand))
    got, rounds = tpar.greedy_assign_waves(ts, port_mesh(), candidates=torch.from_numpy(cand))
    assert_cycle_equal(got, want, "candidates")
    assert rounds == want_rounds


def test_the_shard_rounds_are_the_single_device_wave_assigns():
    js, ts = encode_pair(quota_lists(96, 16), quota=True)
    want = int(np.asarray(jwave.wave_assign(js, wave=32, top_m=4).rounds))
    single = twave.wave_assign(ts, wave=32, top_m=4)
    got, rounds = tpar.greedy_assign_waves(ts, port_mesh(4), wave=32, top_m=4)
    assert rounds == int(single.rounds) == want
    assert_cycle_equal(got, single, "shard vs wave_assign")
