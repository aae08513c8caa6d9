"""The Score program's masked top-k (``solver/topk.py``) on the CPU.

* the plain version against ``lax.top_k(where(feasible, scores, i64.min))``
  and the host twin on the rows the kernel must order exactly
  (``generators.topk_hard_rows``: ties, nothing feasible, a feasible
  INT64_MIN, INT64_MAX, negative scores and scores at and above 2^24, where
  the plain version sorts), for k up to the row length, on dense and on
  [P, C] sparse shapes;
* the kernel itself (``topk_cuda.cu``) runs only on the card, where
  ``tests/test_torch_topk_card.py`` holds it bit-equal to the plain version
  on the same rows;
* the routing: a CPU tensor never reaches the kernel entry, k past
  ``MAX_KERNEL_K`` counts as ``topk_sort`` in ``_build``'s launch table,
  ``reset_launch_counts()``.

Every compared value is an integer: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.config import CycleConfig
from koordinator_tpu_torch.harness import generators as g
from koordinator_tpu_torch.model.snapshot import snapshot_from_numpy
from koordinator_tpu_torch.solver import candidates, topk

I64_MIN = np.iinfo(np.int64).min
# the top-k's paths on the card, as the launch table counts them
TOPK_PATHS = ("topk_kernel", "topk_sort")


def lax_top_k(s, f, k):
    masked = jnp.where(jnp.asarray(f), jnp.asarray(s), I64_MIN)
    return tuple(np.asarray(a) for a in lax.top_k(masked, k))


def assert_same(got, want, what):
    for a, b, part in zip(got, want, ("values", "indices")):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{what}: {part}")


@pytest.mark.parametrize("hi", [None, 7, 1 << 24])
@pytest.mark.parametrize("cols", [1, 3, 33, 100])
def test_the_plain_version_orders_the_hard_rows(cols, hi):
    s, f = g.topk_hard_rows(cols, seed=cols)
    all_s, all_i = lax_top_k(s, f, cols)
    for k in sorted({1, min(8, cols), min(33, cols), cols}):
        got = topk.masked_top_k_plain(torch.from_numpy(s), torch.from_numpy(f), k=k, hi=hi)
        assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32
        assert_same(got, (all_s[:, :k], all_i[:, :k]), f"cols={cols} k={k}")
        assert_same(got, topk.masked_top_k_host(s, f, k), f"cols={cols} k={k} vs the host twin")


@pytest.mark.parametrize("row", g.TOPK_HARD_ROWS)
def test_each_hard_row_against_lax_top_k(row):
    s, f = g.topk_hard_rows(70, seed=5)
    r = g.TOPK_HARD_ROWS.index(row)
    s, f = s[r:r + 1], f[r:r + 1]
    for k in (1, 8, 32, 70):
        got = topk.masked_top_k(torch.from_numpy(s), torch.from_numpy(f), k=k, hi=7)
        assert_same(got, lax_top_k(s, f, k), f"{row} k={k}")


def test_the_plain_version_on_leading_dimensions():
    s, f = g.topk_hard_rows(40, seed=2)
    s3, f3 = s.reshape(2, 5, 40), f.reshape(2, 5, 40)
    got = topk.masked_top_k_plain(torch.from_numpy(s3), torch.from_numpy(f3), k=8, hi=3)
    want = lax_top_k(s, f, 8)
    assert tuple(got[0].shape) == (2, 5, 8)
    assert_same((got[0].reshape(10, 8), got[1].reshape(10, 8)), want, "[2, 5, 40]")


def test_the_plain_version_on_the_sparse_cells():
    """The [P, C] cells the sparse Score ranks: candidate columns, a
    sentinel tail past each pod's feasible count."""
    cfg = CycleConfig(candidate_width=64)
    snap = snapshot_from_numpy(g.sparse_leaves(512, 24, n_open=40, seed=3), device="cpu")
    cand, _ = candidates.build_candidates(snap, cfg)
    s, f = (t.numpy() for t in candidates.score_candidates(snap, cand, cfg))
    for k in (8, 32):
        got = topk.masked_top_k(torch.from_numpy(s), torch.from_numpy(f), k=k,
                                hi=topk.score_upper_bound(cfg))
        assert_same(got, lax_top_k(s, f, k), f"sparse plain k={k}")


def test_a_cpu_tensor_never_reaches_the_kernel_entry(monkeypatch):
    calls = []
    monkeypatch.setattr(topk._build, "entry", lambda *a, **kw: calls.append(a))
    _build.reset_launch_counts()
    s, f = g.topk_hard_rows(50, seed=1)
    for k in (1, 8, 32, 33, 50):
        assert topk.topk_path(torch.device("cpu"), k) == "plain"
        got = topk.masked_top_k(torch.from_numpy(s), torch.from_numpy(f), k=k, hi=7)
        assert_same(got, lax_top_k(s, f, k), f"k={k}")
    assert calls == []
    assert _build.launch_counts(*TOPK_PATHS) == {"topk_kernel": 0, "topk_sort": 0}


def test_the_path_is_chosen_from_the_device_and_k():
    for k in (1, 8, 9, 16, 17, 32):
        assert topk.topk_path(torch.device("cuda"), k) == "kernel"
        assert topk.topk_path("cuda:1", k) == "kernel"
    for k in (33, 64, 5000):
        assert topk.topk_path(torch.device("cuda", 0), k) == "sort"
    assert topk.topk_path("meta", 8) == "plain"
    assert topk.MAX_KERNEL_K == 32


def test_a_k_past_the_kernel_counts_as_sort_and_runs_the_plain_version(monkeypatch):
    """A CUDA tensor with k > 32 takes the sort path; the routing is
    driven here on CPU tensors by naming the path as the card would."""
    plain = []
    real_plain = topk._ranked
    monkeypatch.setattr(topk, "topk_path", lambda device, k: "sort")
    monkeypatch.setattr(topk, "_ranked",
                        lambda *a: plain.append(a[2]) or real_plain(*a))
    _build.reset_launch_counts()
    s, f = g.topk_hard_rows(40, seed=4)
    got = topk.masked_top_k(torch.from_numpy(s), torch.from_numpy(f), k=40, hi=None)
    assert_same(got, lax_top_k(s, f, 40), "k=40")
    assert plain == [40]
    assert _build.launch_counts(*TOPK_PATHS) == {"topk_kernel": 0, "topk_sort": 1}
    _build.count("topk_kernel")
    _build.reset_launch_counts()
    assert _build.launch_counts(*TOPK_PATHS) == {"topk_kernel": 0, "topk_sort": 0}
