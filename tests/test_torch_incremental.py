"""Parity of the port's warm Sync path with the JAX package, exactly:
``apply_flat_delta`` (the resident scatter, pad buckets and the drop rule)
and ``rescore_dirty``, which over seeded warm streams must equal a full
``score_cycle`` of the updated snapshot, under the default and the term
configuration, without writing the ``feasible`` tensor it was given.
Every compared value is an integer or a bool: tolerance 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu.solver import greedy as jgreedy
from koordinator_tpu.solver import resident as jresident

from koordinator_tpu_torch.solver import greedy, incremental, resident, terms

from test_torch_cycle import encode_pair, quota_lists
from test_torch_terms import term_cfgs, with_terms_pair


@pytest.mark.parametrize("dtype", ["int64", "int32", "bool"])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 40])
def test_apply_flat_delta_matches_reference(n, dtype):
    rng = np.random.default_rng(n * 7 + len(dtype))
    shape = (12, 5) if dtype != "bool" else (12,)
    base = rng.integers(0, 50, shape).astype(dtype)
    size = base.size
    idx = rng.choice(size, size=min(n, size), replace=False).astype(np.int64)
    if n >= 9:
        idx[:3] = [size, size + 5, -1]  # past the end (dropped), wrapped from the end
    val = rng.integers(-3, 90, len(idx)).astype(np.int64)
    want = np.asarray(jresident.apply_flat_delta(jnp.asarray(base), idx, val))
    arr = torch.from_numpy(base.copy())
    got = resident.apply_flat_delta(arr, idx, val)
    assert got is arr, "the resident tensor is updated in place"
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_flat_delta_refuses_a_mesh():
    class Mesh:
        size = 4

    # a mesh the port cannot shard over, and a tensor not placed on a mesh
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        resident.apply_flat_delta(torch.zeros(4, dtype=torch.int64), [0], [1], mesh=Mesh())
    from koordinator_tpu_torch.parallel import cluster_mesh

    with pytest.raises(ValueError, match="not placed on the given mesh"):
        resident.apply_flat_delta(torch.zeros(4, dtype=torch.int64), [0], [1],
                                  mesh=cluster_mesh([torch.device("cpu")] * 4))


def delta_step(rng, js, ts, n_nodes, n_pods):
    """Change ``n_nodes`` random node rows (requested cpu/memory, usage
    cpu) and ``n_pods`` random pod rows (requests cpu) through
    ``apply_flat_delta`` in both packages.  Returns (js, ts, node rows, pod
    rows)."""
    N, R = ts.nodes.requested.shape
    P = ts.pods.requests.shape[0]
    nodes = sorted(rng.choice(N, size=n_nodes, replace=False).tolist())
    pods = sorted(rng.choice(P, size=n_pods, replace=False).tolist())
    updates = []
    for table, field, rows, cols, hi in (
        ("nodes", "requested", nodes, (0, 1), 40_000),
        ("nodes", "usage", nodes, (0,), 20_000),
        ("pods", "requests", pods, (0,), 6_000),
    ):
        idx = np.asarray([r * R + c for r in rows for c in cols], np.int64)
        val = rng.integers(0, hi, len(idx)).astype(np.int64)
        updates.append((table, field, idx, val))
    for table, field, idx, val in updates:
        jt, tt = getattr(js, table), getattr(ts, table)
        jarr = jresident.apply_flat_delta(getattr(jt, field), idx, val)
        resident.apply_flat_delta(getattr(tt, field), idx, val)
        js = dataclasses.replace(js, **{table: dataclasses.replace(jt, **{field: jarr})})
    return js, ts, nodes, pods


@pytest.mark.parametrize("with_terms", [False, True])
def test_warm_stream_rescore_equals_full_score_cycle(with_terms):
    js, ts = encode_pair(quota_lists(96, 24, seed=7), quota=True)
    jcfg, tcfg = term_cfgs()
    if with_terms:
        js, ts = with_terms_pair(js, ts, seed=2)
        jcfg, tcfg = term_cfgs(het=1, sens=2, pack=1, headroom={"cpu": 80, "memory": 90})
    scores, feasible = greedy.score_cycle(ts, tcfg)
    rng = np.random.default_rng(31 + with_terms)
    for n_nodes, n_pods in ((3, 0), (0, 2), (9, 5), (1, 1), (0, 0)):
        js, ts, nodes, pods = delta_step(rng, js, ts, n_nodes, n_pods)
        given = feasible.clone()
        scores_in = scores
        scores, feasible_new = incremental.rescore_dirty(ts, scores, feasible, nodes, pods, tcfg)
        assert scores is scores_in, "scores are updated in place"
        assert feasible_new is not feasible and torch.equal(feasible, given), (
            "the feasible tensor given must be left as it was")
        feasible = feasible_new
        full_s, full_f = greedy.score_cycle(ts, tcfg)
        assert torch.equal(scores, full_s) and torch.equal(feasible, full_f)
        want_s, want_f = jgreedy.score_cycle(js, jcfg)
        np.testing.assert_array_equal(scores.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(feasible.numpy(), np.asarray(want_f))
    assert not with_terms or terms.term_names(tcfg) == ("heterogeneity", "sensitivity", "packing")


def test_rescore_pad_rows_and_refusals():
    assert incremental._pad_rows([5, 2], 99).tolist() == [2, 5] + [99] * 6
    assert len(incremental._pad_rows(range(9), 99)) == 16
    _, ts = encode_pair(quota_lists(16, 8), quota=True)
    cfg = term_cfgs()[1]
    s, f = greedy.score_cycle(ts, cfg)

    class Mesh:
        size = 2

    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        incremental.rescore_dirty(ts, s, f, [1], [], cfg, mesh=Mesh())
    from koordinator_tpu_torch.parallel import cluster_mesh

    with pytest.raises(ValueError, match="not placed on the given mesh"):
        incremental.rescore_dirty(ts, s, f, [1], [], cfg,
                                  mesh=cluster_mesh([torch.device("cpu")] * 2))
