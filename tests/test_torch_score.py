"""Parity of the port's Score path with the JAX package, exactly.

* ``feasibility_mask``, ``score_all`` and ``score_cycle`` on the generator
  recipes and under the LoadAware and Fit variants, zero capacity and
  over-request included; the pod-row chunking changes no bit; a row of
  ``score_all`` equals the per-pod step ``step_feasible_scores``;
* ``masked_top_k`` against ``lax.top_k(where(feasible, scores, i64.min))``
  and the reference's own ``masked_top_k``, on fuzz with forced ties, in
  and out of bound, for every ``k`` from 1 to N;
* ``masked_top_k_host`` against the reference's;
* the top-k anchors ``chip_smoke.py`` checks on the card.

Every compared value is an integer or a bool: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.solver import greedy as jgreedy
from koordinator_tpu.solver import topk as jtopk
from koordinator_tpu.solver import terms as jterms

from koordinator_tpu_torch import config as tconfig
from koordinator_tpu_torch.harness import generators as tgen
from koordinator_tpu_torch.harness.anchor import (
    ANCHOR_RECIPE,
    TERM_ANCHOR_HEADROOM,
    TERM_ANCHOR_SEED,
    TERM_TOPK_ANCHOR_SHA256,
    TOPK_ANCHOR_K,
    TOPK_ANCHOR_SHA256,
    topk_digest,
)
from koordinator_tpu_torch.model import snapshot as tsnap
from koordinator_tpu_torch.solver import greedy, terms, topk

from test_torch_cycle import both_configs, encode_pair, quota_lists
from test_torch_terms import with_terms_pair


def zero_capacity_lists():
    """Nodes with a zero-capacity resource, nodes already past their
    capacity, and pods asking more than any node has."""
    nodes = [
        {"name": "no-mem", "allocatable": {"cpu": "8000m", "memory": 0, "pods": 110},
         "usage": {"cpu": "1000m"}},
        {"name": "over", "allocatable": {"cpu": "4000m", "memory": 8 << 30, "pods": 110},
         "requested": {"cpu": "6000m", "memory": 9 << 30}, "usage": {"cpu": "5000m"}},
        {"name": "empty", "allocatable": {}, "metric_fresh": False},
        {"name": "ok", "allocatable": {"cpu": "16000m", "memory": 32 << 30, "pods": 110},
         "usage": {"cpu": "2000m", "memory": 4 << 30}},
    ]
    pods = [
        {"name": "small", "requests": {"cpu": "500m", "memory": 1 << 30}},
        {"name": "huge", "requests": {"cpu": "64000m", "memory": 256 << 30},
         "priority_class": "koord-prod"},
        {"name": "cpu-only", "requests": {"cpu": "1000m"}, "priority_class": "koord-batch"},
        {"name": "nothing", "requests": {}},
    ]
    return nodes, pods, [], []


RECIPES = {
    "spark": (lambda: jgen.spark_colocation(seed=2), False),
    "gang": (lambda: jgen.gang_batch(seed=4, pods=64, nodes=6, min_member=8), False),
    "loadaware": (lambda: jgen.loadaware_joint(seed=6, pods=100, nodes=20), False),
    "quota_colocation": (lambda: quota_lists(128, 32, seed=5), True),
    "zero_capacity": (zero_capacity_lists, False),
    "usage_extensions": (
        lambda: (tgen.with_usage_extensions(jgen.loadaware_joint(seed=5, pods=60, nodes=12)[0],
                                            seed=5),
                 *jgen.loadaware_joint(seed=5, pods=60, nodes=12)[1:]),
        False),
}

CFGS = {
    "default": {},
    "most_allocated": {"fit_scoring_strategy": "MostAllocated"},
    "prod_and_aggregated": {
        "la": {"prod_usage_thresholds": {"cpu": 55, "memory": 80},
               "score_according_prod_usage": True, "aggregated": ("p95", "p90")}},
    "weights_loadaware_off": {"enable_loadaware": False, "fit_plugin_weight": 3,
                              "fit_resource_weights": {"cpu": 2, "memory": 1, "pods": 1}},
}

CASES = [(r, c) for r in sorted(RECIPES) for c in sorted(CFGS)
         if c == "default" or r in ("quota_colocation", "usage_extensions", "zero_capacity")]


def assert_equal(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("recipe,cfg_name", CASES)
def test_score_cycle_matches_reference(recipe, cfg_name, monkeypatch):
    lists_fn, quota = RECIPES[recipe]
    js, ts = encode_pair(lists_fn(), quota=quota)
    jcfg, tcfg = both_configs(**CFGS[cfg_name])
    want_s, want_f = jgreedy.score_cycle(js, jcfg)
    got_s, got_f = greedy.score_cycle(ts, tcfg)
    assert got_s.dtype == torch.int64 and got_f.dtype == torch.bool
    assert_equal(got_s, want_s, f"{recipe}/{cfg_name} scores")
    assert_equal(got_f, want_f, f"{recipe}/{cfg_name} feasible")
    assert_equal(greedy.feasibility_mask(ts, tcfg), jgreedy.feasibility_mask(js, jcfg),
                 f"{recipe}/{cfg_name} feasibility_mask")
    # chunks of a few pod rows give the same bits
    monkeypatch.setattr(greedy, "CHUNK_BYTES", 3 * ts.nodes.capacity * 13 * 8)
    for a, b in zip(greedy.score_all(ts, tcfg), (got_s, got_f)):
        assert torch.equal(a, b)


def test_score_all_rows_equal_the_per_pod_step():
    """On an unreserved snapshot with no quotas, row p of ``score_all`` is
    ``step_feasible_scores`` for pod p: the two statements of one
    arithmetic agree."""
    _, ts = encode_pair(jgen.loadaware_joint(seed=8, pods=40, nodes=10))
    for kw in ({}, CFGS["prod_and_aggregated"], CFGS["most_allocated"]):
        tcfg = both_configs(**kw)[1]
        scores, feasible = greedy.score_all(ts, tcfg)
        nf = greedy.node_filter_inputs(ts, tcfg)
        nodes, pods = ts.nodes, ts.pods
        sreq = greedy._fit_score_requests(pods.requests)
        for p in range(ts.pods.capacity):
            prod = nf.prod_sensitive and int(pods.priority_class[p]) == 0
            f, s = greedy.step_feasible_scores(
                nodes.requested, torch.zeros_like(nodes.requested), ts.quotas.used,
                nodes.allocatable, nf.usage_prod if prod else nf.usage_default,
                nodes.metric_fresh, nf.node_ok_prod if prod else nf.node_ok_default,
                pods.requests[p], sreq[p], pods.estimated[p], -1, bool(pods.valid[p]),
                ts.quotas.runtime, ts.quotas.limited, tcfg)
            assert torch.equal(f, feasible[p]) and torch.equal(s, scores[p]), p


def topk_case(seed, P, N, ties, out_of_bound):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, ties, (P, N)).astype(np.int64)
    f = rng.random((P, N)) > 0.3
    f[0] = False  # a row with nothing feasible
    f[1] = True
    if out_of_bound:
        s[2, ::3] = -rng.integers(1, 1 << 40, len(s[2, ::3]))
        s[3, 1] = np.iinfo(np.int64).max
        s[3, 2] = np.iinfo(np.int64).min  # feasible at the sentinel's value
        f[3, :4] = True
    return s, f


@pytest.mark.parametrize("out_of_bound", [False, True])
@pytest.mark.parametrize("hi", [None, 7, 1 << 24])
def test_masked_top_k_matches_lax_top_k(hi, out_of_bound):
    P, N = 6, 11
    s, f = topk_case(int(out_of_bound) * 10 + (hi or 0) % 97, P, N, ties=4,
                     out_of_bound=out_of_bound)
    masked = jnp.where(jnp.asarray(f), jnp.asarray(s), jnp.iinfo(jnp.int64).min)
    # lax.top_k is sorted, so its k-prefix is its top-k
    all_s, all_i = (np.asarray(a) for a in lax.top_k(masked, N))
    for k in range(1, N + 1):
        got_s, got_i = topk.masked_top_k(torch.from_numpy(s), torch.from_numpy(f), k=k, hi=hi)
        assert got_s.dtype == torch.int64 and got_i.dtype == torch.int32
        assert_equal(got_s, all_s[:, :k], f"k={k} values")
        assert_equal(got_i, all_i[:, :k], f"k={k} indices")
        if k not in (1, N // 2, N):
            continue
        ref_s, ref_i = jtopk.masked_top_k(jnp.asarray(s), jnp.asarray(f), k=k, hi=hi)
        assert_equal(got_i, ref_i, f"k={k} vs the reference masked_top_k")
        assert_equal(got_s, ref_s, f"k={k} vs the reference masked_top_k")


@pytest.mark.parametrize("seed", range(3))
def test_masked_top_k_host_matches_reference(seed):
    s, f = topk_case(seed, 5, 23, ties=3 + seed, out_of_bound=seed == 2)
    for k in (1, 5, 23):
        got = topk.masked_top_k_host(s, f, k)
        want = jtopk.masked_top_k_host(s, f, k)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        dev = topk.masked_top_k(torch.from_numpy(s), torch.from_numpy(f), k=k, hi=10)
        np.testing.assert_array_equal(dev[0].numpy(), got[0])
        np.testing.assert_array_equal(dev[1].numpy(), got[1])


def test_score_upper_bound_matches_reference():
    for kw in ({}, {"enable_loadaware": False}, {"fit_plugin_weight": 4,
                                                 "loadaware_plugin_weight": 2}):
        jcfg, tcfg = both_configs(**kw)
        assert topk.score_upper_bound(tcfg) == jtopk.score_upper_bound(jcfg)
        jt = jterms.default_term_config(jcfg, packing_headroom={"cpu": 90})
        tt = terms.default_term_config(tcfg, packing_headroom={"cpu": 90})
        assert topk.score_upper_bound(tt) == jtopk.score_upper_bound(jt)


@pytest.mark.parametrize("with_terms", [False, True])
def test_topk_anchor_constants_are_the_reference_digests(with_terms):
    js = jgen.quota_colocation_snapshot(**ANCHOR_RECIPE)[0]
    ts = tgen.quota_colocation_snapshot(**ANCHOR_RECIPE, device="cpu")[0]
    jcfg, tcfg = both_configs()
    want_digest = TOPK_ANCHOR_SHA256
    if with_terms:
        js, ts = with_terms_pair(js, ts, TERM_ANCHOR_SEED)
        jcfg = jterms.default_term_config(packing_headroom=TERM_ANCHOR_HEADROOM)
        tcfg = terms.default_term_config(packing_headroom=TERM_ANCHOR_HEADROOM)
        want_digest = TERM_TOPK_ANCHOR_SHA256
    want = jtopk.masked_top_k(*jgreedy.score_cycle(js, jcfg), k=TOPK_ANCHOR_K,
                              hi=jtopk.score_upper_bound(jcfg))
    assert topk_digest(*want) == want_digest
    got = topk.masked_top_k(*greedy.score_cycle(ts, tcfg), k=TOPK_ANCHOR_K,
                            hi=topk.score_upper_bound(tcfg))
    assert topk_digest(*got) == want_digest


def test_score_entry_points_stay_on_the_snapshot_device():
    ts = tsnap.encode_snapshot(*jgen.spark_colocation(), device="cpu")
    s, f = greedy.score_cycle(ts, tconfig.CycleConfig())
    assert s.device == f.device == ts.device
    ts_, ti = topk.masked_top_k(s, f, k=2, hi=topk.score_upper_bound(tconfig.CycleConfig()))
    assert ts_.device == ti.device == ts.device
