"""Parity of the port's sparse candidate engine (``solver/candidates.py``)
with ``koordinator_tpu/solver/candidates.py``, exactly: the cold build on
both routes (serial and pipelined), the merge-refresh after a warm delta,
``score_candidates``, ``sparse_top_k`` (also against the dense
``score_cycle`` + ``masked_top_k``), ``candidate_membership_mask`` and the
``CandidateOverflow`` refusal.

The engine sweeps the node axis in blocks of at least 1,024 nodes, so a
sweep of several blocks needs a few thousand nodes: the snapshots here
have 4,096 nodes and 32 pods (131,072 cells).  Every compared value is an
integer or a bool: tolerance 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu.model import snapshot as jsnap
from koordinator_tpu.solver import candidates as jcand
from koordinator_tpu.solver import greedy as jgreedy
from koordinator_tpu.solver import resident as jresident
from koordinator_tpu.solver import topk as jtopk

from koordinator_tpu_torch.harness import generators as tgen
from koordinator_tpu_torch.model import snapshot as tsnap
from koordinator_tpu_torch.solver import candidates, greedy, resident, topk

from test_torch_terms import term_cfgs, with_terms_pair

N_NODES, N_PODS, WIDTH = 4096, 32, 64


def varied_leaves(seed):
    """The sparse engine's narrow-feasibility cluster
    (``generators.sparse_leaves``) with per-pod variety: open nodes with
    three amounts of free cpu, some of them past the LoadAware threshold,
    and pods of three cpu sizes, so each pod has its own feasible set."""
    leaves = tgen.sparse_leaves(N_NODES, N_PODS, n_open=1, seed=seed)
    rng = np.random.default_rng(seed)
    nodes, pods = leaves["nodes"], leaves["pods"]
    open_rows = rng.choice(N_NODES, size=48, replace=False)
    nodes["requested"][open_rows, 0] = 32_000 - rng.choice([300, 600, 1000], size=48)
    nodes["usage"][open_rows[:6], 0] = 31_000  # over the 65 % cpu threshold
    pods["requests"][:, 0] = rng.choice([250, 500, 900], size=N_PODS)
    pods["estimated"][:] = pods["requests"]
    return leaves


def snapshot_pair(leaves):
    def table(cls, src):
        return cls(**{k: jnp.asarray(v) for k, v in src.items()})

    js = jsnap.ClusterSnapshot(
        nodes=table(jsnap.NodeBatch, leaves["nodes"]),
        pods=table(jsnap.PodBatch, leaves["pods"]),
        gangs=table(jsnap.GangTable, leaves["gangs"]),
        quotas=table(jsnap.QuotaTable, leaves["quotas"]),
    )
    return js, tsnap.snapshot_from_numpy(leaves, device="cpu")


def cfgs(width=WIDTH, terms=False):
    kw = {"het": 1, "sens": 1, "pack": 1, "headroom": {"cpu": 99}} if terms else {}
    return tuple(dataclasses.replace(c, candidate_width=width) for c in term_cfgs(**kw))


@pytest.fixture(scope="module")
def pair():
    return snapshot_pair(varied_leaves(5))


def assert_equal(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("route", ["0", "1"])
def test_build_matches_reference_on_both_routes(pair, route, monkeypatch):
    js, ts = pair
    jcfg, tcfg = cfgs()
    monkeypatch.setenv("KOORD_PARALLEL_BUILD", "0")
    want_cand, want_count = jcand.build_candidates(js, jcfg)
    monkeypatch.setenv("KOORD_PARALLEL_BUILD", route)
    cand, count = candidates.build_candidates(ts, tcfg)
    assert cand.dtype == torch.int32 and count.dtype == torch.int64
    assert_equal(cand, want_cand, "candidate lists")
    assert_equal(count, want_count, "counts")
    assert 0 < int(count.min()) and int(count.max()) <= WIDTH
    assert bool((cand[:, 1:] >= cand[:, :-1]).all()), "lists ascend"
    if route == "1":
        jp = jcand.build_candidates(js, jcfg)  # the reference's pipelined route
        assert_equal(cand, jp[0], "vs the reference's pipelined build")


def test_pipelined_build_is_the_default_from_sixteen_blocks(monkeypatch):
    monkeypatch.delenv("KOORD_PARALLEL_BUILD", raising=False)
    routes = []
    monkeypatch.setattr(candidates, "_build_pipelined",
                        lambda s, c, node_mesh=None: routes.append("pipelined") or (None, None))
    # the serial build takes its config by keyword, as the reference's does
    monkeypatch.setattr(candidates, "_build",
                        lambda s, *, cfg: routes.append("serial") or (None, None))
    for n in (4096, 16 * 1024):
        leaves = tgen.sparse_leaves(n, 8, n_open=2, seed=1)
        candidates.build_candidates(tsnap.snapshot_from_numpy(leaves, device="cpu"),
                                    cfgs()[1])
    assert routes == ["serial", "pipelined"]


@pytest.mark.parametrize("terms_on", [False, True])
def test_score_and_sparse_top_k_match_reference_and_dense(pair, terms_on):
    js, ts = pair
    if terms_on:
        js, ts = with_terms_pair(js, ts, seed=3)
    jcfg, tcfg = cfgs(terms=terms_on)
    cand, count = candidates.build_candidates(ts, tcfg)
    candidates.check_candidate_overflow(count, WIDTH)
    s, f = candidates.score_candidates(ts, cand, tcfg)
    js_, jf = jcand.score_candidates(js, jnp.asarray(cand.numpy()), jcfg)
    assert_equal(s, js_, "candidate scores")
    assert_equal(f, jf, "candidate feasible")
    hi = topk.score_upper_bound(tcfg)
    for k in (1, 8, WIDTH):
        got = candidates.sparse_top_k(s, f, cand, k=k, hi=hi)
        want = jcand.sparse_top_k(js_, jf, jnp.asarray(cand.numpy()), k=k, hi=hi)
        for g, w, what in zip(got, want, ("scores", "nodes", "ok")):
            assert_equal(g, w, f"sparse_top_k k={k} {what}")
    # the sparse reply is the dense one wherever the dense slot is feasible
    ts_, ti, ok = candidates.sparse_top_k(s, f, cand, k=8, hi=hi)
    ds, di = topk.masked_top_k(*greedy.score_cycle(ts, tcfg), k=8, hi=hi)
    assert torch.equal(ok, ds != greedy.INT64_MIN)
    assert bool(ok[:, 0].all()) and bool(ok.all()) != terms_on
    assert torch.equal(ts_, ds) and torch.equal(ti[ok], di[ok])
    jd = jtopk.masked_top_k(*jgreedy.score_cycle(js, jcfg), k=8, hi=hi)
    assert_equal(ti[ok], np.asarray(jd[1])[ok.numpy()], "vs the reference's dense top-k")


def test_refresh_matches_reference_and_a_fresh_build(pair):
    js, ts = pair
    ts = dataclasses.replace(ts, nodes=dataclasses.replace(
        ts.nodes, requested=ts.nodes.requested.clone()), pods=dataclasses.replace(
        ts.pods, requests=ts.pods.requests.clone()))
    jcfg, tcfg = cfgs()
    cand, count = candidates.build_candidates(ts, tcfg)
    R = ts.nodes.requested.shape[1]
    rng = np.random.default_rng(12)
    feasible_nodes = np.unique(cand.numpy()[cand.numpy() < N_NODES])
    # close some feasible nodes, open some new ones, resize three pods
    dirty_nodes = sorted(set(rng.choice(feasible_nodes, 5, replace=False).tolist())
                         | set(rng.choice(N_NODES, 6, replace=False).tolist()))
    node_val = np.where(np.isin(dirty_nodes, feasible_nodes), 32_000, 31_000)
    dirty_pods = [1, 7, 30]
    pod_val = np.asarray([100, 1200, 600])
    for table, field, rows, val in (("nodes", "requested", dirty_nodes, node_val),
                                    ("pods", "requests", dirty_pods, pod_val)):
        idx = np.asarray(rows, np.int64) * R
        jt = getattr(js, table)
        # the reference donates the array it updates: give it a copy, the
        # module's snapshot pair is shared
        jarr = jresident.apply_flat_delta(jnp.array(getattr(jt, field), copy=True), idx, val)
        js = dataclasses.replace(js, **{table: dataclasses.replace(jt, **{field: jarr})})
        resident.apply_flat_delta(getattr(getattr(ts, table), field), idx, val)
    given = cand.clone(), count.clone()
    got = candidates.refresh_candidates(ts, cand, count, dirty_nodes, dirty_pods, tcfg)
    assert torch.equal(cand, given[0]) and torch.equal(count, given[1])
    want = jcand.refresh_candidates(js, jnp.asarray(cand.numpy()), jnp.asarray(count.numpy()),
                                    dirty_nodes, dirty_pods, jcfg)
    fresh = candidates.build_candidates(ts, tcfg)
    for g, w, f, what in zip(got, want, fresh, ("lists", "counts")):
        assert_equal(g, w, f"refresh {what} vs the reference")
        assert torch.equal(g, f), f"refresh {what} vs a fresh build"
    # a refresh with no dirt changes nothing
    same = candidates.refresh_candidates(ts, got[0], got[1], [], [], tcfg)
    assert torch.equal(same[0], got[0]) and torch.equal(same[1], got[1])


def test_membership_mask_matches_reference(pair):
    js, ts = pair
    cand, _ = candidates.build_candidates(ts, cfgs()[1])
    cand = cand.clone()
    cand[0, :3] = torch.tensor([-1, N_NODES + 3, -N_NODES - 1], dtype=torch.int32)
    got = candidates.candidate_membership_mask(cand, N_NODES)
    want = jcand.candidate_membership_mask(jnp.asarray(cand.numpy()), N_NODES)
    assert_equal(got, want, "membership mask")


def test_overflow_is_refused_like_the_reference(pair):
    js, ts = pair
    jcfg, tcfg = cfgs(width=8)
    _, count = candidates.build_candidates(ts, tcfg)
    _, jcount = jcand.build_candidates(js, jcfg)
    assert_equal(count, jcount, "counts past the width")
    with pytest.raises(candidates.CandidateOverflow) as got:
        candidates.check_candidate_overflow(count, 8)
    with pytest.raises(jcand.CandidateOverflow) as want:
        jcand.check_candidate_overflow(np.asarray(jcount), 8)
    assert str(got.value) == str(want.value)
    assert (got.value.width, got.value.max_feasible, got.value.pods) == (
        want.value.width, want.value.max_feasible, want.value.pods)
    candidates.check_candidate_overflow(count, int(count.max()))  # at the width: served


def test_sparse_entry_points_refuse_width_zero_and_a_mesh(pair):
    _, ts = pair

    class Mesh:
        size = 2

    with pytest.raises(ValueError, match="candidate_width"):
        candidates.build_candidates(ts, term_cfgs()[1])
    # a mesh the port cannot shard over (not a parallel.mesh.Mesh)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        candidates.build_candidates(ts, cfgs()[1], mesh=Mesh())


def test_sweep_covers_whole_blocks_only_as_the_reference():
    """A node axis that is no multiple of the sweep block (1,536 nodes,
    block 1,024) is swept over its whole blocks only, in the reference and
    in the port alike: a feasible node past the last whole block is in no
    list and in no count (ROADMAP Queue C)."""
    leaves = tgen.sparse_leaves(1536, 8, n_open=1, seed=2)
    leaves["nodes"]["requested"][[5, 1030, 1500], 0] = 0  # one open node below 1,024, two past
    js, ts = snapshot_pair(leaves)
    jcfg, tcfg = cfgs(width=8)
    cand, count = candidates.build_candidates(ts, tcfg)
    want = jcand.build_candidates(js, jcfg)
    assert_equal(cand, want[0], "lists")
    assert_equal(count, want[1], "counts")
    # open nodes 5, 1030, 1500 and the seed's 1286: only node 5 is listed
    assert cand[0].tolist() == [5] + [1536] * 7 and int(count[0]) == 1
    assert int(greedy.feasibility_mask(ts, tcfg)[0].sum()) == 4
