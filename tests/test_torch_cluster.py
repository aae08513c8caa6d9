"""The thread-block-cluster layer of the port's cycle kernels, on the CPU.

The cluster kernels (``solver/cycle_cuda.cu``, the per-pod cycle in int64
and int32; ``solver/cycle_wide_cuda.cu``, the wave cycle) split the nodes
into contiguous slices, one per CTA, and divide by reciprocals built once
per cycle.  ``solver/cluster.py``
states those algorithms in Python; here they are held exactly against
what they must reproduce:

* the slice-and-merge top-M against ``wide._top_m`` (the plain version's
  frozen candidates, which the JAX wave kernel's pick loop gives);
* the cluster argmax merge against the global argmax over
  ``where(feasible, score, sentinel)`` with the lowest index on ties, at
  the int64 and the int32 sentinel;
* the reciprocal division against Python's ``//`` (and C's truncation for
  the wave kernel), at boundary and seeded random operands, and the
  per-pod kernels' scores against ``ops/scoring.py``;
* the kernel build's digest, which must follow the shared header and the
  ``-D`` defines, and the sources' launch and instrumentation layout.

Inputs are made from seeds with numpy.  Every compared value is an
integer: tolerance 0.
"""

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.solver import cluster, dense, wide

I32_MIN = cluster.I32_MIN
I64_MIN = cluster.I64_MIN


def score_rows(seed, n_rows, n_nodes, kind):
    """i64[n_rows, n_nodes] phase-A scores, I32_MIN = infeasible."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        s = rng.randint(0, 400, size=(n_rows, n_nodes))
        s[rng.uniform(size=s.shape) < 0.3] = I32_MIN
    elif kind == "ties":  # few distinct values: ties cross every slice border
        s = rng.randint(0, 3, size=(n_rows, n_nodes))
    elif kind == "sparse":  # fewer feasible nodes than M
        s = np.full((n_rows, n_nodes), I32_MIN)
        for r in range(n_rows):
            for n in rng.choice(n_nodes, size=min(2, n_nodes), replace=False):
                s[r, n] = rng.randint(0, 100)
    elif kind == "infeasible":
        s = np.full((n_rows, n_nodes), I32_MIN)
    elif kind == "identical":
        s = np.full((n_rows, n_nodes), 77)
    else:
        raise ValueError(kind)
    return torch.from_numpy(s.astype(np.int64))


TOP_M_CASES = [
    # (n_nodes, cluster, M): N < C, N not a multiple of C, a multiple, slices
    # longer than one 128-node chunk, M beyond the feasible count
    (5, 16, 4), (5, 8, 8), (37, 16, 4), (40, 8, 3), (64, 16, 4), (300, 8, 4),
    (2000, 16, 4), (1100, 8, 40), (130, 16, 128), (3, 16, 1),
]


@pytest.mark.parametrize("kind", ["random", "ties", "sparse", "infeasible", "identical"])
@pytest.mark.parametrize("n_nodes,c,m", TOP_M_CASES)
def test_sliced_top_m_equals_the_plain_top_m(n_nodes, c, m, kind):
    scores = score_rows(n_nodes * 31 + m, 3, n_nodes, kind)
    want = wide._top_m(scores, m)
    got = cluster.sliced_top_m(scores, m, c)
    assert got == want
    # sentinel slots are (I32_MIN, 0), never a slice's own lowest index
    for s_row, i_row in zip(*got):
        assert all(i == 0 for s, i in zip(s_row, i_row) if s == I32_MIN)


@pytest.mark.parametrize("n_nodes,c", [(5, 16), (37, 16), (2000, 16), (250, 8), (1, 8)])
def test_slices_cover_the_nodes_in_order(n_nodes, c):
    sl = cluster.slices(n_nodes, c)
    assert len(sl) == c
    covered = [n for lo, hi in sl for n in range(lo, hi)]
    assert covered == list(range(n_nodes))
    assert all(hi - lo <= -(-n_nodes // c) for lo, hi in sl)


def global_choice(masked, feasible, sentinel=I64_MIN):
    """The plain version's argmax (dense.cycle_dense_reference)."""
    m = torch.tensor(masked, dtype=torch.int64)
    f = torch.tensor(feasible)
    where = torch.where(f, m, torch.full_like(m, sentinel))
    return int(where.argmax()) if bool(f.any()) else -1


ARGMAX_CASES = {
    "random": lambda rng, n: (rng.randint(-50, 50, size=n).tolist(),
                              (rng.uniform(size=n) < 0.6).tolist()),
    "all_infeasible": lambda rng, n: ([0] * n, [False] * n),
    "one_feasible_last": lambda rng, n: ([5] * n, [False] * (n - 1) + [True]),
    "ties_across_slices": lambda rng, n: ([9] * n, [True] * n),
    "feasible_at_int64_min": lambda rng, n: ([I64_MIN] * n,
                                             [k % 3 == 2 for k in range(n)]),
    "wide_range": lambda rng, n: ([int(v) for v in rng.randint(-2**62, 2**62, size=n,
                                                                dtype=np.int64)],
                                  (rng.uniform(size=n) < 0.5).tolist()),
}


@pytest.mark.parametrize("sentinel", [I64_MIN, I32_MIN], ids=["int64", "int32"])
@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
@pytest.mark.parametrize("n_nodes,c", [(5, 16), (37, 16), (128, 16), (250, 8), (2, 8)])
def test_cluster_argmax_equals_the_global_argmax(case, n_nodes, c, sentinel):
    """K1 (int64) and K2 (int32) reduce the same way; K2's scores are
    clamped into int32, so its ``feasible_at_int64_min`` case is feasible
    at INT_MIN."""
    rng = np.random.RandomState(n_nodes + c)
    for _ in range(4):
        masked, feasible = ARGMAX_CASES[case](rng, n_nodes)
        if sentinel == I32_MIN:
            masked = [min(max(v, I32_MIN), 2**31 - 1) for v in masked]
        assert (cluster.cluster_argmax(masked, feasible, c, sentinel)
                == global_choice(masked, feasible, sentinel))


def boundary_numerators(d, top):
    vals = {0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, 100 * d - 1, 100 * d, 100 * d + 1,
            top - 1, top - 2, top - d, top // 2, top // 2 - 1}
    return sorted(v for v in vals if 0 <= v < top)


DIVISORS_32 = [1, 2, 3, 7, 10, 100, 1000, 4096, 65535, 2**20 + 1, 2**31 // 100 - 1,
               2**30, 2**31 - 1]
DIVISORS_64 = [1, 2, 3, 7, 100, 2**31 - 1, 2**31 + 1, 2**32 + 3, 10**12 + 39,
               2**62 + 1, 2**63 - 1]


@pytest.mark.parametrize("d", DIVISORS_32)
def test_reciprocal_int32_equals_floor_division(d):
    m, l = cluster.magic(d, 32)
    assert 0 < m < 2**32
    rng = np.random.RandomState(d % 1000)
    nums = boundary_numerators(d, 2**31) + [int(v) for v in rng.randint(0, 2**31, size=300)]
    nums += [2**31, 2**32 - 1]  # the unsigned form takes every 32-bit n
    for n in nums:
        assert cluster.div_magic(n, m, l, 32) == n // d, (n, d)


@pytest.mark.parametrize("d", DIVISORS_64)
def test_reciprocal_int64_equals_floor_division(d):
    m, l = cluster.magic(d, 64)
    assert 0 < m < 2**64
    rng = np.random.RandomState(d % 997)
    nums = boundary_numerators(d, 2**63)
    nums += [int(v) for v in rng.randint(0, 2**63 - 1, size=300, dtype=np.int64)]
    nums += [2**63, 2**64 - 1]
    for n in nums:
        assert cluster.div_magic(n, m, l, 64) == n // d, (n, d)


@pytest.mark.parametrize("seed", range(3))
def test_kernel_divisions_equal_the_plain_ones_on_signed_operands(seed):
    rng = np.random.RandomState(seed)
    for _ in range(400):
        x = int(rng.randint(-2**31, 2**31, dtype=np.int64))
        d = int(rng.choice([-7, -1, 1, 3, 100, int(rng.randint(1, 2**31))]))
        q = abs(x) // abs(d)
        assert cluster.div_i32(x, d) == (q if (x >= 0) == (d > 0) else -q)
        assert cluster.floordiv_i32(x, d) == x // d
        x64 = int(rng.randint(-2**63, 2**63 - 1, dtype=np.int64))
        d64 = int(rng.choice([-5, 1, 7, int(rng.randint(1, 2**62, dtype=np.int64))]))
        assert cluster.floordiv_i64(x64, d64) == x64 // d64


@pytest.mark.parametrize("seed", range(3))
def test_int64_scores_equal_the_plain_scores_with_wrapping_products(seed):
    """K1's least/most requested on the reciprocal path equal the plain
    version's ``ops/scoring.py`` on the same int64 tensors, wrapped
    products (capacities beyond 2^63 / 100) and negative operands included."""
    from koordinator_tpu_torch.ops.scoring import least_requested_score, most_requested_score

    rng = np.random.RandomState(seed)
    caps = np.concatenate([rng.randint(0, 2**40, size=200, dtype=np.int64),
                           rng.randint(2**56, 2**62, size=100, dtype=np.int64),
                           np.array([0, 1, -3, 2**63 - 1, 2**62], dtype=np.int64)])
    ts = np.concatenate([rng.randint(-2**20, 2**40, size=200, dtype=np.int64),
                         rng.randint(0, 2**62, size=100, dtype=np.int64),
                         np.array([0, 0, -5, 2**62, -2**62], dtype=np.int64)])
    want_least = least_requested_score(torch.from_numpy(ts), torch.from_numpy(caps)).tolist()
    want_most = most_requested_score(torch.from_numpy(ts), torch.from_numpy(caps)).tolist()
    for t, cap, wl, wm in zip(ts.tolist(), caps.tolist(), want_least, want_most):
        assert cluster.least_requested_i64(t, cap) == wl, (t, cap)
        assert cluster.most_requested_i64(t, cap) == wm, (t, cap)


# K2's inputs: check_i32_bounds admits node values below 2^31 // 100
I32_SCORED_LIMIT = 2**31 // 100


@pytest.mark.parametrize("seed", range(3))
def test_int32_scores_equal_the_plain_scores_on_the_int32_domain(seed):
    """K2's least/most requested (int32 products, the reciprocal floor
    division) equal the plain version's ``ops/scoring.py`` over the domain
    ``check_i32_bounds`` admits: zero capacity, requests beyond capacity,
    the largest admitted capacity and seeded random values."""
    from koordinator_tpu_torch.ops.scoring import least_requested_score, most_requested_score

    top = I32_SCORED_LIMIT - 1
    assert wide.check_i32_bounds((top, 0, 0, 0))
    assert not wide.check_i32_bounds((top + 1, 0, 0, 0))
    rng = np.random.RandomState(seed)
    caps = rng.randint(0, I32_SCORED_LIMIT, size=300).tolist()
    ts = rng.randint(0, I32_SCORED_LIMIT, size=300).tolist()
    for cap in (0, 1, 3, 100, top):
        for t in (0, 1, cap - 1, cap, cap + 1, top, int(rng.randint(0, I32_SCORED_LIMIT))):
            if t >= 0:
                caps.append(cap)
                ts.append(t)
    want_least = least_requested_score(torch.tensor(ts), torch.tensor(caps)).tolist()
    want_most = most_requested_score(torch.tensor(ts), torch.tensor(caps)).tolist()
    for t, cap, wl, wm in zip(ts, caps, want_least, want_most):
        assert cluster.least_requested_i32(t, cap) == wl, (t, cap)
        assert cluster.most_requested_i32(t, cap) == wm, (t, cap)
        # no product wraps inside the domain: the same as the int64 model
        assert cluster.least_requested_i64(t, cap) == wl, (t, cap)


@pytest.mark.parametrize("d,bits", [(0, 32), (2**31, 32), (-1, 64), (2**63, 64)])
def test_magic_refuses_divisors_out_of_range(d, bits):
    with pytest.raises(ValueError):
        cluster.magic(d, bits)


# every CUDA source of the port (K1 and K2 share the first)
KERNEL_SOURCES = sorted({dense.KERNEL_SOURCE, wide.CYCLE_WIDE_SOURCE, wide.KERNEL_SOURCE})


class TestBuildDigest:
    def test_sources_find_the_shared_header(self):
        for source in (dense.KERNEL_SOURCE, wide.KERNEL_SOURCE):
            incs = _build.local_includes(_build.PACKAGE_DIR / source)
            assert [p.name for p in incs] == ["cluster_state.cuh"]

    def test_digest_follows_headers_and_defines(self, tmp_path):
        src = tmp_path / "k.cu"
        hdr = tmp_path / "h.cuh"
        src.write_text('#include "h.cuh"\n#include <cstdint>\nint f() { return g(); }\n')
        hdr.write_text("inline int g() { return 1; }\n")
        base = _build.source_digest(src, _build.NVCC_FLAGS)
        assert base == _build.source_digest(src, _build.NVCC_FLAGS)
        hdr.write_text("inline int g() { return 2; }\n")
        edited = _build.source_digest(src, _build.NVCC_FLAGS)
        assert edited != base
        flagged = _build.source_digest(src, _build.NVCC_FLAGS + ("-DKOORD_PHASE_CLOCK",))
        assert flagged not in (base, edited)

    @pytest.mark.parametrize("source", KERNEL_SOURCES)
    def test_instrumented_variant_is_compiled_out_of_the_main_build(self, source):
        src = (_build.PACKAGE_DIR / source).read_text()
        inside, timed = False, 0
        for line in src.splitlines():
            code = line.split("//")[0].strip()
            if code == "#ifdef KOORD_PHASE_CLOCK":
                inside = True
            elif code in ("#else", "#endif"):
                inside = False
            elif "clock64()" in code:
                assert inside, line
                timed += 1
        assert timed >= 2


def test_cluster_kernels_launch_one_cluster_and_keep_no_one_cta_body():
    on_disk = sorted(str(p.relative_to(_build.PACKAGE_DIR))
                     for p in (_build.PACKAGE_DIR / "solver").glob("*.cu"))
    assert on_disk == KERNEL_SOURCES
    k12 = (_build.PACKAGE_DIR / dense.KERNEL_SOURCE).read_text()
    k3 = (_build.PACKAGE_DIR / wide.KERNEL_SOURCE).read_text()
    hdr = (_build.PACKAGE_DIR / "solver/cluster_state.cuh").read_text()
    for src in (k12, k3):
        assert "cudaLaunchKernelEx" in src
        assert "cluster_state.cuh" in src
    assert "cudaLaunchAttributeClusterDimension" in hdr
    assert "cudaOccupancyMaxActiveClusters" in hdr
    assert "map_shared_rank" in k12 and "map_shared_rank" in hdr
    # no source of the port keeps a one-CTA launch
    for path in _build.PACKAGE_DIR.rglob("*.cu*"):
        assert "<<<" not in path.read_text(), path
    # K1 and K2 are the two instantiations of one templated body, each
    # entry launching it through the same cluster launch
    assert k12.count("__global__") == 1
    assert "launch<int64_t>(" in k12 and "launch<int32_t>(" in k12
    for entry, kind in (("koord_cycle_launch", "int64_t"), ("koord_wide_cycle_launch", "int32_t")):
        body = k12.split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]
        assert f"launch<{kind}>(" in body, entry
    assert k12.count("cudaLaunchKernelEx(") == 1
    # the one-CTA body and its private helpers are gone
    for gone in ("wide_cycle_kernel", "node_score", "quota_blocked_warp", "load_weights"):
        assert gone not in k12 and gone not in k3, gone
