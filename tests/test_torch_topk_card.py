"""The masked top-k kernel (``solver/topk_cuda.cu``) on the card, bit-equal
to its plain version (``masked_top_k_plain``) on the same CUDA tensors.

Runs where CUDA is present and skips elsewhere; this file imports no JAX
and carries its own ``card`` fixture, so on the card it also runs without
the suite's conftest::

    python -m pytest tests/test_torch_topk_card.py -m card --noconftest -q
"""

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.config import CycleConfig
from koordinator_tpu_torch.harness import generators as g
from koordinator_tpu_torch.model.snapshot import snapshot_from_numpy
from koordinator_tpu_torch.solver import candidates, topk

pytestmark = pytest.mark.card

# the benchmark's Score: 10,000 pending pods x 5,000 nodes
CELL = (10_000, 5_000)
# the top-k's paths on the card, as the launch table counts them
TOPK_PATHS = ("topk_kernel", "topk_sort")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    _build.reset_launch_counts()
    return torch.device("cuda")


def random_cells(shape, seed, distinct=200, feasible=0.7):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, distinct, shape).astype(np.int64)
    f = rng.random(shape) < feasible
    return s, f


def on(dev, s, f):
    return torch.from_numpy(s).to(dev), torch.from_numpy(f).to(dev)


def assert_kernel_equals_plain(s, f, k, what, hi=None):
    """One kernel launch against the plain version on the same tensors."""
    before = _build.launch_counts("topk_kernel")["topk_kernel"]
    got = topk.masked_top_k(s, f, k=k, hi=hi)
    torch.cuda.synchronize()
    assert _build.launch_counts("topk_kernel")["topk_kernel"] == before + 1, what
    want = topk.masked_top_k_plain(s, f, k=k, hi=hi)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32, what
    assert got[0].shape == want[0].shape, what
    assert torch.equal(got[0], want[0]), f"{what}: values"
    assert torch.equal(got[1], want[1]), f"{what}: indices"


@pytest.mark.parametrize("k", [1, 8, 16, 32])
def test_the_cells_shape(card, k):
    s, f = on(card, *random_cells(CELL, seed=k))
    assert_kernel_equals_plain(s, f, k, f"{CELL} k={k}", hi=199)


def test_the_servicers_padded_layout(card):
    """The servicer's tensors for the cell's cluster: power-of-two buckets,
    the padding infeasible, so the kernel reads no score there."""
    s, f = on(card, *random_cells(CELL, seed=9))
    ps = torch.zeros((16_384, 8_192), dtype=torch.int64, device=card)
    pf = torch.zeros((16_384, 8_192), dtype=torch.bool, device=card)
    ps[:CELL[0], :CELL[1]] = s
    pf[:CELL[0], :CELL[1]] = f
    ps[CELL[0]:] = 7  # a score behind an infeasible flag is never ranked
    assert_kernel_equals_plain(ps, pf, 8, "padded [16384, 8192] k=8", hi=None)


@pytest.mark.parametrize("cols", [5_001, 2_047, 3])
def test_ragged_rows(card, cols):
    s, f = on(card, *random_cells((777, cols), seed=cols, distinct=5))
    for k in sorted({1, min(8, cols), min(9, cols), min(32, cols), min(cols, 32)}):
        assert_kernel_equals_plain(s, f, k, f"[777, {cols}] k={k}")


@pytest.mark.parametrize("cols", [3, 32, 33, 1_000, 5_001])
def test_the_hard_rows(card, cols):
    s_np, f_np = g.topk_hard_rows(cols, seed=cols)
    s, f = on(card, s_np, f_np)
    for k in sorted({1, min(8, cols), min(16, cols), min(32, cols)}):
        assert_kernel_equals_plain(s, f, k, f"hard rows, {cols} columns, k={k}")
        host = topk.masked_top_k_host(s_np, f_np, k)
        got = topk.masked_top_k(s, f, k=k, hi=None)
        assert np.array_equal(got[0].cpu().numpy(), host[0])
        assert np.array_equal(got[1].cpu().numpy(), host[1])


def test_leading_dimensions_and_strides(card):
    s, f = on(card, *random_cells((3, 100, 257), seed=3, distinct=7))
    assert_kernel_equals_plain(s, f, 8, "[3, 100, 257]")
    # a transposed view: the wrapper lays it out row-major
    st, ft = s[0].t(), f[0].t()
    assert not st.is_contiguous()
    assert_kernel_equals_plain(st, ft, 16, "a transposed [257, 100]")


def test_the_sparse_cells(card):
    """The ``sparse`` line's [P, C] tensors: candidates at 4,096 nodes."""
    width = 256
    cfg = CycleConfig(candidate_width=width)
    snap = snapshot_from_numpy(g.sparse_leaves(4096, 512, n_open=width // 2, seed=17),
                               device=card)
    cand, _ = candidates.build_candidates(snap, cfg)
    s, f = candidates.score_candidates(snap, cand, cfg)
    for k in (8, 32):
        assert_kernel_equals_plain(s, f, k, f"sparse [P, C] k={k}", hi=topk.score_upper_bound(cfg))


def test_one_score_of_the_servicer(card):
    """A Score RPC of the real servicer on the card launches the kernel once
    and replies what the in-process plain top-k ranks."""
    from koordinator_tpu_torch.bridge import wire
    from koordinator_tpu_torch.bridge.server import ScorerServicer
    from koordinator_tpu_torch.harness.golden import build_sync_request
    from koordinator_tpu_torch.solver import score_cycle, score_upper_bound

    nodes, pods, gangs, quotas = g.quota_colocation(pods=2_000, nodes=600)
    sv = ScorerServicer(device="cuda")
    try:
        sync = sv.sync(build_sync_request(nodes, pods, gangs, quotas)[0])
        before = _build.launch_counts("topk_kernel")["topk_kernel"]
        reply = sv.score(wire.ScoreRequest(snapshot_id=sync.snapshot_id, top_k=8, flat=True))
        assert _build.launch_counts(*TOPK_PATHS) == {"topk_kernel": before + 1, "topk_sort": 0}
        snap = sv.state.snapshot()
        scores, feasible = score_cycle(snap, sv.cfg)
        ts, ti = topk.masked_top_k_plain(scores, feasible, k=8, hi=score_upper_bound(sv.cfg))
        ok = torch.gather(feasible, 1, ti.long()).cpu().numpy()[:len(pods)]
        ts, ti = ts.cpu().numpy()[:len(pods)], ti.cpu().numpy()[:len(pods)]
        flat = reply.flat
        assert flat.counts == ok.sum(axis=1).astype("<i4").tobytes()
        assert flat.node_index == ti[ok].astype("<i4").tobytes()
        assert flat.score == ts[ok].astype("<i8").tobytes()
    finally:
        sv.telemetry.close()


def test_a_refused_launch_raises_and_nothing_falls_back(card, monkeypatch):
    s, f = on(card, *random_cells((64, 100), seed=1))
    plain = []
    monkeypatch.setattr(topk._build, "entry", lambda *a, **kw: (lambda *args: 1))
    monkeypatch.setattr(topk, "_ranked", lambda *a: plain.append(1))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        topk.masked_top_k(s, f, k=8, hi=None)
    assert plain == [] and _build.launch_counts(*TOPK_PATHS) == {"topk_kernel": 0, "topk_sort": 0}


def test_a_k_past_the_kernel_takes_the_sort_path(card):
    s, f = on(card, *random_cells((50, 300), seed=2, distinct=3))
    got = topk.masked_top_k(s, f, k=33, hi=2)
    want = topk.masked_top_k_host(s.cpu().numpy(), f.cpu().numpy(), 33)
    assert np.array_equal(got[0].cpu().numpy(), want[0])
    assert np.array_equal(got[1].cpu().numpy(), want[1])
    assert _build.launch_counts(*TOPK_PATHS) == {"topk_kernel": 0, "topk_sort": 1}


def test_the_entry_refuses_what_the_kernel_does_not_take(card):
    s, f = on(card, *random_cells((4, 10), seed=4))
    with pytest.raises(ValueError):
        topk.masked_top_k(s, f[:, :9], k=4, hi=None)
    with pytest.raises(TypeError):
        topk.masked_top_k(s.int(), f, k=4, hi=None)
    with pytest.raises(ValueError):
        topk.masked_top_k(s[:, :3], f[:, :3], k=4, hi=None)
