"""Plain models of the thread-block-cluster layer of the cycle kernels.

``cluster_state.cuh`` and the cluster kernels (``cycle_cuda.cu``, K1 and
K2, the per-pod cycle in int64 and int32; ``cycle_wide_cuda.cu``, K3, the
wave cycle) split the nodes into C contiguous slices, one per CTA, and
rebuild global results from per-slice ones.  This module states the same
algorithms in Python, step for step, so that the CPU tests can hold them
against the plain versions they must equal:

* ``slices``: the node slice of each CTA;
* ``sliced_top_m``: K3's phase A and merge (each slice's top-M by chunked
  warp-argmax passes, then the merge of the C lists by their heads), which
  must equal ``wide._top_m``;
* ``cluster_argmax``: the per-pod kernels' per-slice argmax seeded at the
  slice's lowest index and its merge in rank order, which must equal the
  global argmax;
* ``magic``/``div_magic``, ``div_i32``, ``floordiv_i32``,
  ``floordiv_i64``: the division by an invariant divisor through a
  multiply-and-shift reciprocal, which must equal the plain division on
  every operand;
* ``least_requested_i32``/``most_requested_i32`` and their int64
  counterparts: the per-pod kernels' scores, which must equal
  ``ops/scoring.py``'s.

Nothing on the card's path calls these models.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

I32_MIN = -(2**31)
I64_MIN = -(2**63)
CHUNK = 4  # nodes a lane scores per phase-A chunk (kChunk)
LANES = 32


def slices(n_nodes: int, cluster: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each CTA: S = ceil(N / C) nodes each, contiguous; the
    last CTAs may own none."""
    s = -(-n_nodes // cluster)
    return [(min(k * s, n_nodes), min(k * s + s, n_nodes)) for k in range(cluster)]


def _better(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    """Lexicographic (max score, min index): a beats b."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _best(pairs) -> Tuple[int, int]:
    out = (I32_MIN, 2**31 - 1)
    for pair in pairs:
        if _better(pair, out):
            out = pair
    return out


def slice_top_m(row: Sequence[int], lo: int, hi: int, m: int) -> List[Tuple[int, int]]:
    """One slice's top-M as the kernel builds it: chunks of 32 x CHUNK
    nodes, each merged with the running list by M argmax passes that stop
    at the first infeasible (I32_MIN) best; the slots after it are the
    sentinel (I32_MIN, 0)."""
    running: List[Tuple[int, int]] = []
    for c0 in range(lo, hi, LANES * CHUNK):
        pool = [(row[n], n) for n in range(c0, min(c0 + LANES * CHUNK, hi))] + running
        taken = set()
        merged = []
        for _ in range(m):
            best = _best(p for k, p in enumerate(pool) if k not in taken)
            if best[0] == I32_MIN:
                break
            taken.add(pool.index(best))
            merged.append(best)
        running = merged
    return running + [(I32_MIN, 0)] * (m - len(running))


def merge_top_m(lists: Sequence[Sequence[Tuple[int, int]]], m: int) -> List[Tuple[int, int]]:
    """The leader's merge: M passes, each taking the best of the C list
    heads and advancing its list, stopping at the first sentinel."""
    heads = [0] * len(lists)
    out = []
    for _ in range(m):
        cand = [(lst[h] if h < m else (I32_MIN, 2**31 - 1), k)
                for k, (lst, h) in enumerate(zip(lists, heads))]
        best, k = max(cand, key=lambda c: (c[0][0], -c[0][1]))
        if best[0] == I32_MIN:
            break
        heads[k] += 1
        out.append(best)
    return out + [(I32_MIN, 0)] * (m - len(out))


def sliced_top_m(scores, m: int, cluster: int):
    """K3's frozen top-M of each row of ``scores`` (i64[B, N], I32_MIN =
    infeasible) over ``cluster`` slices: the same (scores, indices) lists
    as ``wide._top_m``."""
    rows = scores.tolist()
    n = len(rows[0]) if rows else 0
    out_s, out_i = [], []
    for row in rows:
        lists = [slice_top_m(row, lo, hi, m) for lo, hi in slices(n, cluster)]
        merged = merge_top_m(lists, m)
        out_s.append([s for s, _ in merged])
        out_i.append([i for _, i in merged])
    return out_s, out_i


def slice_partial(masked: Sequence[int], feasible: Sequence[bool], lo: int, hi: int,
                  sentinel: int = I64_MIN):
    """One slice's (best, index, any) as K1 (``sentinel`` INT64_MIN) and K2
    (INT_MIN) reduce it: seeded with the lowest owned index at the sentinel
    (INT_MAX for an empty slice), nodes in ascending order, a strictly
    greater score replacing the best."""
    best, idx = sentinel, lo if lo < hi else 2**31 - 1
    for n in range(lo, hi):
        if feasible[n] and masked[n] > best:
            best, idx = masked[n], n
    return best, idx, any(feasible[lo:hi])


def cluster_argmax(masked: Sequence[int], feasible: Sequence[bool], cluster: int,
                   sentinel: int = I64_MIN):
    """The per-pod kernels' choice for one pod: the slice partials merged in
    rank order (lexicographic max score, min index; any = OR); -1 when no
    node is feasible.  Equals the argmax of where(feasible, score,
    ``sentinel``) with the lowest index on ties, for every feasible score
    at or above the sentinel."""
    best, idx, anyf = sentinel, 2**31 - 1, False
    for lo, hi in slices(len(masked), cluster):
        b, i, a = slice_partial(masked, feasible, lo, hi, sentinel)
        if (b, -i) > (best, -idx):
            best, idx = b, i
        anyf = anyf or a
    return idx if anyf else -1


# ---------------------------------------------------------------- division


def magic(d: int, bits: int) -> Tuple[int, int]:
    """(m, l) of the divisor 1 <= d < 2^(bits - 1): l = ceil(log2 d) and m =
    floor(2^bits (2^l - d) / d) + 1, the latter by the kernel's
    shift-subtract long division."""
    if not 1 <= d < 2 ** (bits - 1):
        raise ValueError(f"divisor {d} out of range for {bits} bits")
    l = (d - 1).bit_length()
    r, q = (1 << l) - d, 0
    for _ in range(bits):
        r <<= 1
        q <<= 1
        if r >= d:
            r -= d
            q |= 1
    return q + 1, l


def div_magic(n: int, m: int, l: int, bits: int) -> int:
    """floor(n / d) for 0 <= n < 2^bits from d's (m, l): t = mulhi(m, n),
    (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0)."""
    mask = (1 << bits) - 1
    t = (m * n) >> bits
    return ((t + (((n - t) & mask) >> min(l, 1))) & mask) >> max(l - 1, 0)


def wrap(x: int, bits: int) -> int:
    """``x`` as a two's-complement integer of ``bits`` bits."""
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >> (bits - 1) else x


def div_i32(x: int, d: int) -> int:
    """The wave kernel's ``x / d`` (truncating): the reciprocal for x >= 0
    and d > 0, else the plain division."""
    if x >= 0 and d > 0:
        m, l = magic(d, 32)
        return div_magic(x, m, l, 32)
    q = abs(x) // abs(d)
    return q if (x >= 0) == (d > 0) else -q


def floordiv_i32(x: int, d: int) -> int:
    """The int32 per-pod kernel's floordiv(x, d): the reciprocal for x >= 0
    and d > 0, else the plain floor division."""
    if x >= 0 and d > 0:
        m, l = magic(d, 32)
        return div_magic(x, m, l, 32)
    return x // d


def floordiv_i64(x: int, d: int) -> int:
    """The int64 kernel's floordiv(x, d): the reciprocal for x >= 0 and
    d > 0, else the plain floor division."""
    if x >= 0 and d > 0:
        m, l = magic(d, 64)
        return div_magic(x, m, l, 64)
    return x // d


def least_requested_i64(t: int, cap: int) -> int:
    """K1's least-requested score, its product wrapping as int64 does."""
    if cap == 0 or t > cap:
        return 0
    return floordiv_i64(wrap((cap - t) * 100, 64), cap)


def most_requested_i64(t: int, cap: int) -> int:
    """K1's most-requested score, its product wrapping as int64 does."""
    if cap == 0:
        return 0
    return floordiv_i64(wrap(min(t, cap) * 100, 64), cap)


def least_requested_i32(t: int, cap: int) -> int:
    """K2's least-requested score: the int32 product, floored by the
    reciprocal (no product wraps inside ``check_i32_bounds``)."""
    if cap == 0 or t > cap:
        return 0
    return floordiv_i32(wrap((cap - t) * 100, 32), cap)


def most_requested_i32(t: int, cap: int) -> int:
    """K2's most-requested score, as ``least_requested_i32``."""
    if cap == 0:
        return 0
    return floordiv_i32(wrap(min(t, cap) * 100, 32), cap)
