// The wave-batched int32 Assign cycle kernel for Hopper (sm_90a), K3, one
// launch per cycle.
//
// Replaces the TPU kernel koordinator_tpu/solver/pallas_cycle.py
// _wave_cycle_kernel (wave_cycle_kernel here), launched by _run_cycle at
// wave > 1.  It computes what that kernel computes, in 32-bit integers as
// it does.  It does not copy the TPU kernel's lane packing or block
// structure; the 128-pod block survives only where it sets the round count
// (a wave never crosses a block end).  The same file's per-pod kernel at
// wave 0 (_cycle_kernel, K2) is cycle_cuda.cu's int32 instantiation.
//
// Arithmetic.  Every score is exact int32 with truncating division on
// non-negative operands, which is floor division there.  The wrapper takes
// only snapshots that check_i32_bounds admits (node values below 2^31 /
// 100, quota rows with room for every request) and extra scores below
// 2^29, so no intermediate overflows: (cap - t) * 100 and min(t, cap) * 100
// stay below 2^31.  The TPU kernel's f32-reciprocal division exists
// because the TPU's vector unit has no integer divide, and this card has
// none either: nvcc expands an int32 "/" into a sequence of about 20
// instructions.  K3 divides by cap = alloc[r, n] through one
// multiply-and-shift reciprocal per (r, n) built once per cycle
// (cluster_state.cuh), exact, and by the plain "/" for any operand the
// fast form does not take.
//
// wave_cycle_kernel (K3): one thread-block cluster of C CTAs (16 on an
// H100, else 8) of 512 threads; CTA k owns the node slice [k*S, (k+1)*S)
// and holds its node state and reciprocals in its shared memory
// (cluster_state.cuh).  Each round:
//   Staging: every CTA copies the wave's pod rows into shared memory, with
//   each pod's active resources (a non-zero request or estimate, or a Fit
//   or LoadAware weight: 3 of 13 at the headline); the loops below visit
//   only those, since the others change nothing.
//   Phase A: every CTA scores all W wave pods against its own slice only
//   (warp w takes wave lanes w, w + 16, ...) against the round-start state
//   and keeps each pod's slice-local top-M (score, node) pairs in shared
//   memory; a slot past the slice's feasible nodes is the sentinel pair
//   (INT_MIN, 0).  Cluster barrier.
//   Merge: the leader CTA (rank 0) merges each pod's C slice lists, read
//   through DSMEM, in (score desc, node asc) order: that is the global
//   top-M the TPU kernel's pick loop freezes, sentinels included.
//   Phase B: the leader's warp 0 resolves the wave in queue order.  Per pod
//   it rechecks quota against the live quota rows (leader shared memory),
//   re-keys the pod's candidates, and under MostAllocated the nodes
//   committed to earlier in the round, against the live state: a group of
//   lanes per candidate (the active count rounded up to a power of two),
//   one lane per active resource, reading the owner CTA's shared memory
//   through DSMEM, all candidates' loads in flight together; it certifies
//   the lexicographic best against the frozen M-th pair and commits a
//   certified pod's Reserve at once into the owner's shared memory (a plain
//   store of the state the winner's lanes just read), so the next pod's
//   re-key reads it.  The first uncertified pod ends the round's commit prefix.  The
//   other CTAs wait at the cluster barrier: nothing else writes node state
//   during phase B, so no atomics are needed.
// A slice that does not fit in shared memory (large N) runs the same code
// over the device-memory state.  Built with -DKOORD_PHASE_CLOCK, the
// leader's thread 0 sums clock64 cycles of phase A, the merge and phase B
// (koord_wave_phase_cycles); the main path's build carries no timing code.
//
// What bounds K3 on this card: the rounds' sequential phase B (about W / 2
// pods a round, each a DSMEM round trip for its candidates, group and warp
// reductions and a remote Reserve), about two thirds of a round at the
// headline (PERF.md), then phase A and two cluster barriers a round.

#include "cluster_state.cuh"

#include <climits>
#include <cstdint>
#include <mutex>

namespace {

namespace cg = cooperative_groups;

using koord::kFlagFresh;
using koord::kFlagOk;
using koord::kFlagProdOk;
using koord::kFull;
using koord::kMaxResources;
using koord::take_better;
using koord::warp_best;

constexpr int kBlock = 128;  // pod block of the TPU kernel's grid
constexpr int kMaxLanes = 128;  // cap of W and M

struct WideParams {
  int P, N, R;
  const int32_t* preq;    // [P, R] queue order
  const int32_t* psreq;   // [P, R] non-zero score requests
  const int32_t* pest;    // [P, R] LoadAware estimates
  const int32_t* pqid;    // [P] quota id, -1 = none
  const uint8_t* pvalid;  // [P]
  const uint8_t* pprod;   // [P] pod takes the prod mask/usage
  const int32_t* alloc;   // [R, N]
  const int32_t* usage;   // [R, N] score usage, non-prod pods
  const int32_t* uprod;   // [R, N] score usage, prod pods
  const uint8_t* flags;   // [N]
  const int32_t* qrt;     // [Q, R]
  const uint8_t* qlim;    // [Q, R]
  const int32_t* weights; // [2, R]: fit, LoadAware
  int32_t fit_wsum, la_wsum, fit_pw, la_pw;
  int most_allocated, enable_fit, enable_la;
  const int32_t* xcomb;   // [P, N] or null; INT_MIN = infeasible
  int32_t* chosen;        // [P] out
  int32_t* nreq;          // [R, N] in/out (carried state: plain loads only)
  int32_t* nest;          // [R, N] in/out
  int32_t* quse;          // [Q, R] in/out
};

constexpr int kWaveThreads = 512;
constexpr int kWaveWarps = kWaveThreads / 32;
constexpr int kChunk = 4;          // nodes a lane scores per phase-A chunk
constexpr int kListSlots = kMaxLanes / 32;  // list entries a lane holds
// quota rows go to the leader's shared memory up to this size
constexpr size_t kQuotaSmem = 32768;

struct WaveParams {
  WideParams c;
  int Q, wave, top_m;     // W and M, already capped by the wrapper
  koord::GlobalState<int32_t> g;  // node state; nreq, nest in/out
  int S, resident, uprod_shared, quota_resident;
  int32_t* rounds;        // [1] out
};

// Byte offsets in the wave kernel's dynamic shared memory (the same in
// every CTA; the quota rows are used by the leader only).
struct WaveLayout {
  size_t list_s, list_i, preq, psreq, pest, act, meta, qid, quse, qrt, qlim, slice;
};

__host__ __device__ inline WaveLayout wave_layout(int W, int M, int R, int Q, bool quota_resident) {
  WaveLayout L{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off = koord::align16(off + bytes);
    return at;
  };
  L.list_s = take((size_t)W * M * 4);  // per wave lane: M (score, node)
  L.list_i = take((size_t)W * M * 4);
  L.preq = take((size_t)W * R * 4);    // the wave's pod rows
  L.psreq = take((size_t)W * R * 4);
  L.pest = take((size_t)W * R * 4);
  L.act = take((size_t)W * kMaxResources);  // active resources, in order
  L.meta = take((size_t)W * 4);        // bits 0-1 valid, prod; bits 8+ active count
  L.qid = take((size_t)W * 4);
  if (quota_resident) {
    L.quse = take((size_t)Q * R * 4);
    L.qrt = take((size_t)Q * R * 4);
    L.qlim = take((size_t)Q * R);
  }
  L.slice = off;
  return L;
}

struct Divs {  // reciprocals of the weight sums
  uint32_t fit_m, la_m;
  uint8_t fit_l, la_l;
};

__device__ __forceinline__ int32_t least_recip(int32_t t, int32_t cap, uint32_t m, uint8_t l) {
  if (cap == 0 || t > cap) return 0;
  return koord::div_i32((cap - t) * 100, cap, m, l);
}

__device__ __forceinline__ int32_t most_recip(int32_t t, int32_t cap, uint32_t m, uint8_t l) {
  if (cap == 0) return 0;
  return koord::div_i32((t < cap ? t : cap) * 100, cap, m, l);
}

// Filter and Score of pod p on node n of a view of the node state, with the
// pod's rows and active resources given: the score, or INT_MIN when the
// node fails Fit on a requested resource, its LoadAware flag or the extra
// mask.  Pod validity and quota are node-invariant and checked apart.
__device__ __forceinline__ int32_t view_score(const WideParams& c,
                                              const koord::NodeView<int32_t>& v, int p, int n,
                                              bool prod, const int32_t* req, const int32_t* sreq,
                                              const int32_t* est, const uint8_t* act, int nact,
                                              const int32_t (*s_w)[kMaxResources],
                                              const Divs& d) {
  const unsigned char f = v.flag(n);
  if (!(f & (prod ? kFlagProdOk : kFlagOk))) return INT_MIN;
  const int32_t* usage = prod ? v.uprod : v.usage;
  int32_t fit = 0, la = 0;
  bool fits = true;
  // unrolled without an early exit, so that the loads of several
  // resources issue together and their arithmetic interleaves
#pragma unroll 4
  for (int k = 0; k < nact; ++k) {
    const int r = act[k];
    const int i = v.at(r, n);
    const int32_t cap = v.alloc[i];
    const int32_t nr = v.nreq[i];
    const uint32_t m = v.magic[i];
    const uint8_t l = v.shift[i];
    const int32_t rq = req[r];
    fits = fits & !(rq > 0 && nr + rq > cap);
    const int32_t wf = s_w[0][r];
    const int32_t wl = s_w[1][r];
    if (wf != 0) {
      fit += (c.most_allocated ? most_recip(nr + sreq[r], cap, m, l)
                               : least_recip(nr + sreq[r], cap, m, l)) * wf;
    }
    if (wl != 0) la += least_recip(usage[i] + v.nest[i] + est[r], cap, m, l) * wl;
  }
  if (!fits) return INT_MIN;
  int32_t total = 0;
  if (c.xcomb != nullptr) {
    const int32_t x = c.xcomb[(size_t)p * c.N + n];
    if (x == INT_MIN) return INT_MIN;
    total = x;
  }
  if (c.enable_fit && c.fit_wsum != 0) {
    total += c.fit_pw * koord::div_i32(fit, c.fit_wsum, d.fit_m, d.fit_l);
  }
  if (c.enable_la && c.la_wsum != 0 && (f & kFlagFresh)) {
    total += c.la_pw * koord::div_i32(la, c.la_wsum, d.la_m, d.la_l);
  }
  return total;
}

// Phase B's share of one candidate's re-key on one lane: resource ``r``
// (-1 = none) of node ``node`` (-1 = none) read from the owner's state,
// every load issued before any is used.  The group of lanes of the candidate then sums
// ``fit`` and ``la`` and ANDs ``fits``.
struct RekeyPart {
  int fits;
  int32_t fit, la;
  unsigned char flags;
  int32_t nreq, nest;  // the live state read, kept for a store-only Reserve
};

__device__ __forceinline__ RekeyPart rekey_part(const WideParams& c,
                                                const koord::NodeView<int32_t>& v,
                                                cg::cluster_group& cl, int S, int node, int r,
                                                bool prod, int32_t rq, int32_t sreq, int32_t est,
                                                int32_t wf, int32_t wl) {
  RekeyPart q{1, 0, 0, 0, 0, 0};
  if (node < 0) return q;
  const koord::NodeView<int32_t> o = koord::remote_view(v, cl, v.resident ? node / S : 0, S);
  q.flags = o.flag(node);
  if (r >= 0) {
    const int i = o.at(r, node);
    const int32_t cap = o.alloc[i];
    const int32_t nr = o.nreq[i];
    const int32_t ne = o.nest[i];
    const int32_t u = prod ? o.uprod[i] : o.usage[i];
    const uint32_t m = o.magic[i];
    const uint8_t l = o.shift[i];
    q.fits = !(rq > 0 && nr + rq > cap);
    q.nreq = nr;
    q.nest = ne;
    if (wf != 0) {
      q.fit = (c.most_allocated ? most_recip(nr + sreq, cap, m, l)
                                : least_recip(nr + sreq, cap, m, l)) * wf;
    }
    if (wl != 0) q.la = least_recip(u + ne + est, cap, m, l) * wl;
  }
  return q;
}

// The candidate's score from its group's sums (on the group's lane 0).
__device__ __forceinline__ int32_t rekey_score(const WideParams& c, const RekeyPart& q, int p,
                                               int node, bool prod, const Divs& d) {
  if (!q.fits || !(q.flags & (prod ? kFlagProdOk : kFlagOk))) return INT_MIN;
  int32_t s = 0;
  if (c.xcomb != nullptr) {
    s = c.xcomb[(size_t)p * c.N + node];
    if (s == INT_MIN) return INT_MIN;
  }
  if (c.enable_fit && c.fit_wsum != 0) {
    s += c.fit_pw * koord::div_i32(q.fit, c.fit_wsum, d.fit_m, d.fit_l);
  }
  if (c.enable_la && c.la_wsum != 0 && (q.flags & kFlagFresh)) {
    s += c.la_pw * koord::div_i32(q.la, c.la_wsum, d.la_m, d.la_l);
  }
  return s;
}

// Phase A for one wave lane, by one warp: the top-M (score, node) pairs of
// this CTA's slice, in (score desc, node asc) order, into ls/li.  The slice
// is taken in chunks of 32 x kChunk nodes held in registers; each chunk is
// merged with the running list by M warp-wide lexicographic argmax passes.
// Slots past the slice's feasible nodes hold the sentinel (INT_MIN, 0).
__device__ void slice_top_m(const WideParams& c, const koord::NodeView<int32_t>& v, int p,
                            bool prod, const int32_t* req, const int32_t* sreq,
                            const int32_t* est, const uint8_t* act, int nact,
                            const int32_t (*s_w)[kMaxResources],
                            const Divs& d, int lo, int hi, int M, int32_t* ls, int* li) {
  const int lane = threadIdx.x & 31;
  int count = 0;  // entries of the running list
  for (int c0 = lo; c0 < hi; c0 += 32 * kChunk) {
    int32_t val[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int n = c0 + lane + 32 * j;
      val[j] = n < hi ? view_score(c, v, p, n, prod, req, sreq, est, act, nact, s_w, d) : INT_MIN;
    }
    int32_t old_s[kListSlots];
    int old_i[kListSlots];
#pragma unroll
    for (int t = 0; t < kListSlots; ++t) {
      const int m = lane + 32 * t;
      old_s[t] = m < count ? ls[m] : INT_MIN;
      old_i[t] = m < count ? li[m] : INT_MAX;
    }
    __syncwarp();
    unsigned taken = 0, old_taken = 0;
    int32_t out_s[kListSlots];
    int out_i[kListSlots];
    int filled = 0;
    for (int m = 0; m < M; ++m) {
      int32_t best = INT_MIN;
      int idx = INT_MAX;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (!(taken >> j & 1)) take_better(best, idx, val[j], c0 + lane + 32 * j);
      }
#pragma unroll
      for (int t = 0; t < kListSlots; ++t) {
        if (!(old_taken >> t & 1)) take_better(best, idx, old_s[t], old_i[t]);
      }
      warp_best(best, idx);
      if (best == INT_MIN) break;  // only infeasible nodes remain
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + lane + 32 * j == idx) taken |= 1u << j;
      }
#pragma unroll
      for (int t = 0; t < kListSlots; ++t) {
        if (old_i[t] == idx) old_taken |= 1u << t;
      }
#pragma unroll
      for (int t = 0; t < kListSlots; ++t) {
        if (m == lane + 32 * t) {
          out_s[t] = best;
          out_i[t] = idx;
        }
      }
      filled = m + 1;
    }
#pragma unroll
    for (int t = 0; t < kListSlots; ++t) {
      const int m = lane + 32 * t;
      if (m < filled) {
        ls[m] = out_s[t];
        li[m] = out_i[t];
      }
    }
    count = filled;
    __syncwarp();
  }
  for (int m = count + lane; m < M; m += 32) {
    ls[m] = INT_MIN;
    li[m] = 0;
  }
  __syncwarp();
}

// The leader's merge for one wave lane, by one warp: the global top-M of
// the C slice lists, in place into the leader's own list (lane k < C
// follows rank k's list head through DSMEM).  Every slice list holds its
// feasible nodes first, so the merge stops at the first sentinel.
__device__ void merge_top_m(cg::cluster_group& cl, int C, int M, int32_t* ls, int* li) {
  const int lane = threadIdx.x & 31;
  const int32_t* rs = nullptr;
  const int* ri = nullptr;
  int head = 0;
  int32_t hs = INT_MIN;
  int hi = INT_MAX;
  if (lane < C) {
    rs = cl.map_shared_rank(ls, lane);
    ri = cl.map_shared_rank(li, lane);
    hs = rs[0];
    hi = ri[0];
  }
  int32_t out_s[kListSlots];
  int out_i[kListSlots];
  int filled = 0;
  for (int m = 0; m < M; ++m) {
    int32_t best = hs;
    int idx = hi;
    warp_best(best, idx);
    if (best == INT_MIN) break;
    if (lane < C && hi == idx) {  // node indices are unique across slices
      ++head;
      hs = head < M ? rs[head] : INT_MIN;
      hi = head < M ? ri[head] : INT_MAX;
    }
#pragma unroll
    for (int t = 0; t < kListSlots; ++t) {
      if (m == lane + 32 * t) {
        out_s[t] = best;
        out_i[t] = idx;
      }
    }
    filled = m + 1;
  }
  __syncwarp();  // every head read of the own list is done
#pragma unroll
  for (int t = 0; t < kListSlots; ++t) {
    const int m = lane + 32 * t;
    if (m < M) {
      ls[m] = m < filled ? out_s[t] : INT_MIN;
      li[m] = m < filled ? out_i[t] : 0;
    }
  }
  __syncwarp();
}

#ifdef KOORD_PHASE_CLOCK
// cycles of the leader's thread 0: phase A (staging, scoring, slice lists,
// barrier), the merge, phase B (resolution, barrier); then, within them,
// the staging and the re-keys of phase B
__device__ unsigned long long g_phase_cycles[5];
#define KOORD_STAMP(var) const long long var = clock64()
#else
#define KOORD_STAMP(var)
#endif

__global__ void __launch_bounds__(kWaveThreads, 1) wave_cycle_kernel(WaveParams wp) {
  const WideParams& c = wp.c;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int C = (int)cl.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = c.N, R = c.R, Q = wp.Q, S = wp.S;
  const int W = wp.wave, M = wp.top_m;
  const int lo = min(rank * S, N);
  const int hi = min(lo + S, N);
  extern __shared__ __align__(16) char smem[];
  __shared__ int32_t s_w[2][kMaxResources];
  __shared__ int s_taken[kMaxLanes];  // node committed by wave lane, or -1
  __shared__ int s_ncommit;

  const WaveLayout L = wave_layout(W, M, R, Q, wp.quota_resident);
  int32_t* list_s = reinterpret_cast<int32_t*>(smem + L.list_s);
  int* list_i = reinterpret_cast<int*>(smem + L.list_i);
  int32_t* s_preq = reinterpret_cast<int32_t*>(smem + L.preq);
  int32_t* s_psreq = reinterpret_cast<int32_t*>(smem + L.psreq);
  int32_t* s_pest = reinterpret_cast<int32_t*>(smem + L.pest);
  uint8_t* s_act = reinterpret_cast<uint8_t*>(smem + L.act);
  int* s_meta = reinterpret_cast<int*>(smem + L.meta);
  int* s_qid = reinterpret_cast<int*>(smem + L.qid);
  int32_t* quse = c.quse;
  const int32_t* qrt = c.qrt;
  const uint8_t* qlim = c.qlim;
  if (wp.quota_resident) {
    int32_t* sq = reinterpret_cast<int32_t*>(smem + L.quse);
    int32_t* sr = reinterpret_cast<int32_t*>(smem + L.qrt);
    uint8_t* sl = reinterpret_cast<uint8_t*>(smem + L.qlim);
    if (rank == 0) {
      for (int i = tid; i < Q * R; i += kWaveThreads) {
        sq[i] = c.quse[i];
        sr[i] = c.qrt[i];
        sl[i] = c.qlim[i];
      }
    }
    quse = sq;
    qrt = sr;
    qlim = sl;
  }
  if (tid < R) {
    s_w[0][tid] = c.weights[tid];
    s_w[1][tid] = c.weights[R + tid];
  }
  Divs d;  // once per cycle
  koord::Recip<int32_t>::build(c.fit_wsum, d.fit_m, d.fit_l);
  koord::Recip<int32_t>::build(c.la_wsum, d.la_m, d.la_l);
  const koord::NodeView<int32_t> v = koord::load_slice<int32_t>(
      wp.g, N, R, lo, hi, S, wp.resident, wp.uprod_shared, smem + L.slice);
  cl.sync();  // every CTA has started before any DSMEM access

  int rounds = 0;
  for (int base = 0; base < c.P; base += kBlock) {
    int ptr = 0;  // uniform across the cluster
    while (ptr < kBlock) {
      KOORD_STAMP(t_a);
      // stage the wave's pod rows, a warp per pod, lane r resource r, with
      // each pod's active resources (a non-zero request or estimate, or a
      // Fit or LoadAware weight): the others change nothing and are skipped
      for (int w = warp; w < W; w += kWaveWarps) {
        const int j = ptr + w;
        const int p = base + j;
        const bool ok = j < kBlock && p < c.P && c.pvalid[p];
        bool active = false;
        if (ok && lane < R) {
          const size_t src = (size_t)p * R + lane;
          const int32_t rq = c.preq[src];
          const int32_t est = c.pest[src];
          s_preq[w * R + lane] = rq;
          s_psreq[w * R + lane] = c.psreq[src];
          s_pest[w * R + lane] = est;
          active = rq != 0 || est != 0 || s_w[0][lane] != 0 || s_w[1][lane] != 0;
        }
        const unsigned ballot = __ballot_sync(kFull, active);
        if (active) s_act[w * kMaxResources + __popc(ballot & ((1u << lane) - 1))] = lane;
        if (lane == 0) {
          s_meta[w] = ok ? 1 | (c.pprod[p] ? 2 : 0) | (__popc(ballot) << 8) : 0;
          s_qid[w] = ok ? c.pqid[p] : -1;
        }
      }
      __syncthreads();
      KOORD_STAMP(t_st);

      // Phase A: each CTA freezes each wave pod's top-M over its own slice
      // against the round-start state
      for (int w = warp; w < W; w += kWaveWarps) {
        int32_t* ls = list_s + w * M;
        int* li = list_i + w * M;
        const int meta = s_meta[w];
        if (!(meta & 1)) {
          for (int m = lane; m < M; m += 32) {
            ls[m] = INT_MIN;
            li[m] = 0;
          }
          continue;
        }
        slice_top_m(c, v, base + ptr + w, meta & 2, s_preq + w * R, s_psreq + w * R,
                    s_pest + w * R, s_act + w * kMaxResources, meta >> 8, s_w, d, lo, hi, M,
                    ls, li);
      }
      cl.sync();
      KOORD_STAMP(t_b);

      if (rank == 0) {
        // the global top-M of each wave pod, from the C slice lists
        for (int w = warp; w < W; w += kWaveWarps) {
          if (s_meta[w] & 1) merge_top_m(cl, C, M, list_s + w * M, list_i + w * M);
        }
        __syncthreads();
      }
      KOORD_STAMP(t_m);

      // Phase B: the leader's warp 0 resolves the wave in queue order
      if (rank == 0 && warp == 0) {
        int ncommit = 0;
        const bool most = c.enable_fit && c.most_allocated;
        for (int w = 0; w < W; ++w) {
          const int j = ptr + w;
          const int p = base + j;
          const int meta = s_meta[w];
          if (!(meta & 1)) {
            // node-independent -1: certified, takes no node
            if (lane == 0) {
              if (j < kBlock && p < c.P) c.chosen[p] = -1;
              s_taken[w] = -1;
            }
            ++ncommit;
            __syncwarp();
            continue;
          }
#ifdef KOORD_PHASE_CLOCK
          const long long t_r0 = clock64();
#endif
          const int32_t* req = s_preq + w * R;
          const int qid = s_qid[w];
          // the quota recheck's loads and the re-key's go out together; a
          // blocked pod discards its re-key
          bool viol = false;
          if (qid >= 0 && lane < R) {
            const int q = qid * R + lane;
            viol = qlim[q] && quse[q] + req[lane] > qrt[q];
          }
          const bool prod = meta & 2;
          const int32_t* ls = list_s + w * M;
          const int* li = list_i + w * M;
          int32_t best = INT_MIN;  // seeded (INT_MIN, 0)
          int idx = 0;
          // the last pass's candidates and what their lanes read; when one
          // pass took every candidate, the winner's lanes hold its live
          // state and its Reserve is a plain store
          int na = -1, nb = -1, gr = -1;
          RekeyPart a{}, b{};
          bool one_pass;
          int32_t rq = 0, est = 0;
          {
            // a group of G lanes (the active count rounded up to a power of
            // two) re-keys one candidate, lane g of the group active
            // resource g
            const int nact = meta >> 8;
            int G = 1;
            while (G < nact) G <<= 1;
            const int per_pass = 32 / G;
            const int grp = lane / G;
            const int ga = lane & (G - 1);
            gr = ga < nact ? s_act[w * kMaxResources + ga] : -1;
            const int32_t sreq = gr >= 0 ? s_psreq[w * R + gr] : 0;
            est = gr >= 0 ? s_pest[w * R + gr] : 0;
            rq = gr >= 0 ? req[gr] : 0;
            const int32_t wf = gr >= 0 && c.enable_fit && c.fit_wsum != 0 ? s_w[0][gr] : 0;
            const int32_t wl = gr >= 0 && c.enable_la && c.la_wsum != 0 ? s_w[1][gr] : 0;
            const int K = M + (most ? w : 0);  // own top-M, then the round's commits
            auto candidate = [&](int k) {
              if (k < M) return ls[k] != INT_MIN ? li[k] : -1;  // a sentinel slot is none
              return k < K ? s_taken[k - M] : -1;
            };
            one_pass = K <= 2 * per_pass;
            // two candidates per group and pass, their loads in flight together
            for (int k0 = 0; k0 < K; k0 += 2 * per_pass) {
              na = candidate(k0 + grp);
              nb = candidate(k0 + per_pass + grp);
              a = rekey_part(c, v, cl, S, na, gr, prod, rq, sreq, est, wf, wl);
              b = rekey_part(c, v, cl, S, nb, gr, prod, rq, sreq, est, wf, wl);
              for (int off = G >> 1; off > 0; off >>= 1) {
                a.fits &= __shfl_xor_sync(kFull, a.fits, off);
                b.fits &= __shfl_xor_sync(kFull, b.fits, off);
                a.fit += __shfl_xor_sync(kFull, a.fit, off);
                b.fit += __shfl_xor_sync(kFull, b.fit, off);
                a.la += __shfl_xor_sync(kFull, a.la, off);
                b.la += __shfl_xor_sync(kFull, b.la, off);
              }

              if (ga == 0) {
                if (na >= 0) take_better(best, idx, rekey_score(c, a, p, na, prod, d), na);
                if (nb >= 0) take_better(best, idx, rekey_score(c, b, p, nb, prod, d), nb);
              }
            }
            warp_best(best, idx);
          }
#ifdef KOORD_PHASE_CLOCK
          if (lane == 0) g_phase_cycles[4] += clock64() - t_r0;
#endif
          int choice = -1;
          if (!__any_sync(kFull, viol)) {
            const int32_t ks = ls[M - 1];
            const int ki = li[M - 1];
            const bool certified = best > ks || (best == ks && idx <= ki) ||
                                   ks == INT_MIN || (most && w == 0);
            if (!certified) break;  // ends the commit prefix (warp-uniform)
            choice = best > INT_MIN ? idx : -1;
          }
          // commit, with a live Reserve into the owner's shared memory: every
          // resource it changes is active, so after one pass the lanes that
          // re-keyed the winner store its new state; else a read-modify-write
          if (choice >= 0) {
            const koord::NodeView<int32_t> o =
                koord::remote_view(v, cl, v.resident ? choice / S : 0, S);
            if (one_pass) {
              const bool mine_a = na == choice, mine_b = nb == choice;
              if ((mine_a || mine_b) && gr >= 0) {
                const int i = o.at(gr, choice);
                o.nreq[i] = (mine_a ? a.nreq : b.nreq) + rq;
                o.nest[i] = (mine_a ? a.nest : b.nest) + est;
              }
            } else if (lane < R) {
              const int i = o.at(lane, choice);
              o.nreq[i] += req[lane];
              o.nest[i] += s_pest[w * R + lane];
            }
            if (qid >= 0 && lane < R) quse[qid * R + lane] += req[lane];
          }
          if (lane == 0) {
            c.chosen[p] = choice;
            s_taken[w] = choice;
          }
          ++ncommit;
          __syncwarp();  // the next pod reads this Reserve and s_taken
        }
        if (lane == 0) s_ncommit = ncommit;
      }
      cl.sync();
#ifdef KOORD_PHASE_CLOCK
      if (rank == 0 && tid == 0) {
        const long long t_c = clock64();
        g_phase_cycles[0] += t_b - t_a;
        g_phase_cycles[1] += t_m - t_b;
        g_phase_cycles[2] += t_c - t_m;
        g_phase_cycles[3] += t_st - t_a;
      }
#endif
      ptr += *cl.map_shared_rank(&s_ncommit, 0);
      ++rounds;
      // the leader rewrites s_ncommit only after the next phase A's barrier
    }
  }
  __syncthreads();
  koord::store_slice<int32_t>(wp.g, v, N, R, lo, hi);
  if (rank == 0) {
    if (wp.quota_resident) {
      for (int i = tid; i < Q * R; i += kWaveThreads) c.quse[i] = quse[i];
    }
    if (tid == 0) *wp.rounds = rounds;
  }
  cl.sync();  // no CTA exits while another may read its shared memory
}

size_t wave_quota_bytes(int Q, int R) {
  const size_t cells = (size_t)Q * R;
  return koord::align16(cells * 4) * 2 + koord::align16(cells);
}

cudaError_t wave_plan_for(int N, int R, int Q, int W, int M, int uprod_shared,
                          koord::ClusterPlan* plan, int* quota_resident) {
  static std::mutex mu;
  static int key[6] = {-1, -1, -1, -1, -1, -1};
  static koord::ClusterPlan cached;
  std::lock_guard<std::mutex> lock(mu);
  *quota_resident = wave_quota_bytes(Q, R) <= kQuotaSmem;
  const int k[6] = {N, R, Q, W, M, uprod_shared};
  bool hit = true;
  for (int i = 0; i < 6; ++i) hit = hit && key[i] == k[i];
  if (hit) {
    *plan = cached;
    return cudaSuccess;
  }
  const size_t fixed = wave_layout(W, M, R, Q, *quota_resident).slice;
  const cudaError_t err = koord::plan_cluster(
      wave_cycle_kernel, N, kWaveThreads, fixed,
      [&](int S) { return koord::carve_slice<int32_t>(nullptr, R, S, uprod_shared != 0, nullptr); },
      plan);
  if (err != cudaSuccess) return err;
  cached = *plan;
  for (int i = 0; i < 6; ++i) key[i] = k[i];
  return cudaSuccess;
}

}  // namespace

// Plain C entry points, bound with ctypes (solver/wide.py).

// The wave kernel's cluster plan for this shape: out[0..5] = C, S,
// resident, dynamic shared bytes per CTA, cudaOccupancyMaxActiveClusters
// at C = 8 and at C = 16.  Returns the cudaError_t (0 = success).
extern "C" int koord_wave_plan(int N, int R, int Q, int wave, int top_m, int uprod_shared,
                               int* out) {
  koord::ClusterPlan plan;
  int quota_resident;
  const cudaError_t err = wave_plan_for(N, R, Q, wave, top_m, uprod_shared, &plan, &quota_resident);
  if (err != cudaSuccess) return (int)err;
  out[0] = plan.C;
  out[1] = plan.S;
  out[2] = plan.resident;
  out[3] = (int)plan.smem;
  out[4] = plan.occupancy8;
  out[5] = plan.occupancy16;
  return 0;
}

// Launch the wave cycle on ``stream`` and return the cudaError_t of the
// launch (0 = success).  ``magic``/``shift``: [R, N] scratch for the
// reciprocals of a slice that is not resident.
extern "C" int koord_wave_cycle_launch(
    int P, int N, int R, int Q,
    const int32_t* preq, const int32_t* psreq, const int32_t* pest,
    const int32_t* pqid, const uint8_t* pvalid, const uint8_t* pprod,
    const int32_t* alloc, const int32_t* usage, const int32_t* uprod,
    const uint8_t* flags, const int32_t* qrt, const uint8_t* qlim,
    const int32_t* weights, int32_t fit_wsum, int32_t la_wsum,
    int32_t fit_pw, int32_t la_pw, int most_allocated, int enable_fit,
    int enable_la, const int32_t* xcomb, int32_t* chosen, int32_t* nreq,
    int32_t* nest, int32_t* quse, int wave, int top_m, uint32_t* magic,
    uint8_t* shift, int32_t* rounds, void* stream) {
  if (P < 0 || N < 1 || R < 1 || R > kMaxResources || (int64_t)N * R >= INT_MAX ||
      Q < 0 || wave < 1 || wave > kMaxLanes || top_m < 1 || top_m > kMaxLanes) {
    return (int)cudaErrorInvalidValue;
  }
  const int uprod_shared = uprod == usage;
  koord::ClusterPlan plan;
  int quota_resident;
  cudaError_t err = wave_plan_for(N, R, Q, wave, top_m, uprod_shared, &plan, &quota_resident);
  if (err != cudaSuccess) return (int)err;
  WaveParams wp{
      WideParams{P, N, R, preq, psreq, pest, pqid, pvalid, pprod,
                 alloc, usage, uprod, flags, qrt, qlim, weights,
                 fit_wsum, la_wsum, fit_pw, la_pw,
                 most_allocated, enable_fit, enable_la,
                 xcomb, chosen, nreq, nest, quse},
      Q, wave, top_m,
      koord::GlobalState<int32_t>{alloc, usage, uprod, flags, nreq, nest, magic, shift},
      plan.S, plan.resident, uprod_shared, quota_resident, rounds};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      koord::cluster_config(plan.C, kWaveThreads, plan.smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, wave_cycle_kernel, wp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef KOORD_PHASE_CLOCK
// The instrumented build only: copy the leader's phase cycles (phase A,
// merge, phase B, the staging within phase A, the re-keys within phase B,
// summed over the rounds since the last call) to ``out`` and reset them.
extern "C" int koord_wave_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif
