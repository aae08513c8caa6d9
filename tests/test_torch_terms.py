"""Parity of the port's fused scoring terms (``solver/terms.py``) with the
JAX package, exactly.

Each term alone and all three together through ``score_cycle`` and
``term_extras``; the static bound; the missing-data and no-mask cases; the
worst case of the sensitivity term's product; ``run_cycle`` under the term
configuration (the per-pod scan and ``wave=32``) against the reference's
CPU ``run_cycle``; and the term cycle's anchor digest.  Every compared
value is an integer or a bool: tolerance 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu import config as jconfig
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.solver import greedy as jgreedy
from koordinator_tpu.solver import run_cycle as j_run_cycle
from koordinator_tpu.solver import terms as jterms

from koordinator_tpu_torch import config as tconfig
from koordinator_tpu_torch.harness import generators as tgen
from koordinator_tpu_torch.harness.anchor import (
    ANCHOR_RECIPE,
    TERM_ANCHOR_HEADROOM,
    TERM_ANCHOR_SEED,
    TERM_ANCHOR_SHA256,
    cycle_digest,
)
from koordinator_tpu_torch.solver import greedy, run_cycle, terms

from test_torch_cycle import assert_cycle_equal, encode_pair, quota_lists


def with_terms_pair(js, ts, seed=0):
    """Both snapshots with the same term data (``generators.term_tensors``)."""
    t = tgen.term_tensors(ts.pods.capacity, ts.nodes.capacity, seed)
    js = dataclasses.replace(
        js,
        nodes=dataclasses.replace(js.nodes, accel_type=jnp.asarray(t["accel_type"])),
        pods=dataclasses.replace(
            js.pods,
            workload_class=jnp.asarray(t["workload_class"]),
            sensitivity=jnp.asarray(t["sensitivity"]),
        ),
        throughput=jnp.asarray(t["throughput"]),
    )
    return js, tgen.with_term_tensors(ts, seed)


def term_cfgs(het=None, sens=None, pack=None, headroom=(), **base):
    """The same config in both packages; ``het``/``sens``/``pack`` are term
    weights (None = term off)."""
    pair = []
    for mod in (jconfig, tconfig):
        pair.append(mod.CycleConfig(
            heterogeneity=None if het is None else mod.HeterogeneityTermArgs(weight=het),
            sensitivity=None if sens is None else mod.SensitivityTermArgs(weight=sens),
            packing=None if pack is None else mod.PackingTermArgs(
                weight=pack, headroom=dict(headroom),
                resource_weights={"cpu": 2, "memory": 1, "pods": 1}),
            **base,
        ))
    return tuple(pair)


def term_snapshots(pods=96, nodes=24, seed=3):
    """quota_colocation with its lower half of nodes requested near full,
    so the packing headroom mask bites, and the term data."""
    lists = quota_lists(pods, nodes, seed=seed)
    for i, nd in enumerate(lists[0][: nodes // 2]):
        cpu = int(nd["allocatable"]["cpu"][:-1])
        nd["requested"] = {"cpu": f"{cpu * (50 + 4 * i) // 100}m",
                           "memory": nd["allocatable"]["memory"] * (30 + 5 * i) // 100}
    return with_terms_pair(*encode_pair(lists, quota=True))


def assert_equal(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)
    assert got.dtype == {np.dtype("int64"): torch.int64,
                         np.dtype("bool"): torch.bool}[np.asarray(want).dtype]


TERM_SETS = {
    "heterogeneity": {"het": 1},
    "sensitivity": {"sens": 1},
    "packing": {"pack": 1},
    "packing_headroom": {"pack": 2, "headroom": {"cpu": 70, "memory": 60}},
    "all_three": {"het": 1, "sens": 1, "pack": 1, "headroom": {"cpu": 98, "memory": 98}},
    "all_weighted_most_allocated": {
        "het": 3, "sens": 2, "pack": 4, "headroom": {"cpu": 80},
        "fit_scoring_strategy": "MostAllocated"},
}


@pytest.mark.parametrize("name", sorted(TERM_SETS))
def test_terms_match_reference(name):
    js, ts = term_snapshots()
    jcfg, tcfg = term_cfgs(**TERM_SETS[name])
    s, f = greedy.score_cycle(ts, tcfg)
    js_, jf = jgreedy.score_cycle(js, jcfg)
    assert_equal(s, js_, f"{name} scores")
    assert_equal(f, jf, f"{name} feasible")
    xs, xm = terms.term_extras(ts, tcfg)
    jxs, jxm = jterms.term_extras(js, jcfg)
    assert_equal(xs, jxs, f"{name} term scores")
    assert (xm is None) == (jxm is None)
    if xm is not None:
        assert_equal(xm, jxm, f"{name} term mask")
        if "headroom" in TERM_SETS[name] and name != "all_three":
            assert not bool(xm.all()), "the headroom mask should bite here"
    assert terms.term_names(tcfg) == jterms.term_names(jcfg)


@pytest.mark.parametrize("kw", [{}, {"het": 1}, {"het": 2, "sens": 3},
                                {"pack": 5, "headroom": {"cpu": 90}},
                                {"het": 1, "sens": 1, "pack": 1, "enable_loadaware": False}])
def test_terms_upper_bound_matches_reference(kw):
    jcfg, tcfg = term_cfgs(**kw)
    assert terms.terms_upper_bound(tcfg) == jterms.terms_upper_bound(jcfg)
    assert [t.has_mask(tcfg) for t in terms.enabled_terms(tcfg)] == [
        t.has_mask(jcfg) for t in jterms.enabled_terms(jcfg)]


def test_term_extras_without_terms_and_without_headroom():
    js, ts = term_snapshots(pods=16, nodes=8)
    assert terms.term_extras(ts, tconfig.CycleConfig()) == (None, None)
    jcfg, tcfg = term_cfgs(het=1, sens=1, pack=1)
    xs, xm = terms.term_extras(ts, tcfg)
    assert xm is None and jterms.term_extras(js, jcfg)[1] is None
    assert xs.shape == (ts.pods.capacity, ts.nodes.capacity)
    assert_equal(xs, jterms.term_extras(js, jcfg)[0], "terms without headroom")
    jd = jterms.default_term_config(packing_headroom={"cpu": 98})
    td = terms.default_term_config(packing_headroom={"cpu": 98})
    assert terms.term_names(td) == jterms.term_names(jd)
    assert td.packing.headroom == jd.packing.headroom


def test_missing_term_data_contributes_nothing():
    """Terms enabled before their data arrived: the heterogeneity and
    sensitivity terms are inert, and the scores equal the reference's."""
    js, ts = encode_pair(quota_lists(40, 12, seed=4), quota=True)
    jcfg, tcfg = term_cfgs(het=1, sens=1)
    assert terms.term_extras(ts, tcfg)[0].abs().sum() == 0
    base = greedy.score_cycle(ts, tconfig.CycleConfig())
    got = greedy.score_cycle(ts, tcfg)
    want = jgreedy.score_cycle(js, jcfg)
    for g, b, w, what in zip(got, base, want, ("scores", "feasible")):
        assert torch.equal(g, b)
        assert_equal(g, w, what)


def test_sensitivity_worst_case_is_exact():
    """Every profile and every occupancy at 100 (and past it, clamped):
    the largest products and sums the int64 multiply-and-sum sees."""
    js, ts = term_snapshots(pods=32, nodes=16)
    R = ts.pods.requests.shape[1]
    sens = np.full((ts.pods.capacity, R), 100, np.int64)
    sens[::3] = 250  # clamps to 100
    sens[1] = 0  # an insensitive pod
    # every resource allocatable, every occupancy 100: each dot product is
    # R * 100 * 100, the largest there is
    alloc = np.maximum(np.asarray(js.nodes.allocatable), 1000)
    usage = alloc * 3  # past allocatable: clamps to 100
    usage[::2] = alloc[::2]
    js = dataclasses.replace(
        js, pods=dataclasses.replace(js.pods, sensitivity=jnp.asarray(sens)),
        nodes=dataclasses.replace(js.nodes, usage=jnp.asarray(usage),
                                  allocatable=jnp.asarray(alloc)))
    ts = dataclasses.replace(
        ts, pods=dataclasses.replace(ts.pods, sensitivity=torch.from_numpy(sens)),
        nodes=dataclasses.replace(ts.nodes, usage=torch.from_numpy(usage),
                                  allocatable=torch.from_numpy(alloc)))
    jcfg, tcfg = term_cfgs(sens=7)
    got = terms._sens_score(ts, tcfg)
    assert_equal(got, jterms._sens_score(js, jcfg), "worst-case sensitivity")
    assert int(got[1].min()) == 700 and int(got[0].max()) == 0


@pytest.mark.parametrize("wave", [1, 32])
def test_run_cycle_with_terms_matches_reference(wave):
    js, ts = term_snapshots(pods=128, nodes=32, seed=5)
    jcfg, tcfg = (dataclasses.replace(c, wave=wave, top_m=4) for c in term_cfgs(
        het=1, sens=1, pack=1, headroom={"cpu": 85, "memory": 90}))
    got = run_cycle(ts, tcfg)
    want = j_run_cycle(js, jcfg)
    assert got.path == ("wave" if wave > 1 else "scan")
    assert_cycle_equal(got, want, f"terms wave={wave}")
    assert (got.rounds is None) == (wave == 1)
    if wave > 1:
        assert int(got.rounds) == int(want.rounds)
    plain = run_cycle(ts, dataclasses.replace(tcfg, heterogeneity=None, sensitivity=None,
                                              packing=None))
    assert not torch.equal(plain.assignment, got.assignment), "the terms should move pods"


def test_run_cycle_with_terms_and_caller_extras():
    js, ts = term_snapshots(pods=64, nodes=16, seed=6)
    P, N = ts.pods.capacity, ts.nodes.capacity
    rng = np.random.default_rng(9)
    m = rng.random((P, N)) > 0.2
    s = rng.integers(0, 300, (P, N)).astype(np.int64)
    jcfg, tcfg = term_cfgs(het=1, sens=1, pack=1, headroom={"cpu": 90})
    got = run_cycle(ts, tcfg, extra_mask=torch.from_numpy(m), extra_scores=torch.from_numpy(s))
    want = j_run_cycle(js, jcfg, extra_mask=jnp.asarray(m), extra_scores=jnp.asarray(s))
    assert_cycle_equal(got, want, "terms with caller extras")


def test_term_anchor_constant_is_the_reference_digest():
    js, ts = with_terms_pair(
        jgen.quota_colocation_snapshot(**ANCHOR_RECIPE)[0],
        tgen.quota_colocation_snapshot(**ANCHOR_RECIPE, device="cpu")[0],
        TERM_ANCHOR_SEED,
    )
    want = j_run_cycle(js, jterms.default_term_config(packing_headroom=TERM_ANCHOR_HEADROOM))
    assert cycle_digest(want.assignment, want.status) == TERM_ANCHOR_SHA256
    got = run_cycle(ts, terms.default_term_config(packing_headroom=TERM_ANCHOR_HEADROOM))
    assert cycle_digest(got.assignment, got.status) == TERM_ANCHOR_SHA256
