// The int32 Assign cycle kernels for Hopper (sm_90a): the per-pod wide
// cycle and the wave-batched cycle, one launch per cycle each.
//
// Replace the TPU kernels koordinator_tpu/solver/pallas_cycle.py
// _cycle_kernel (wide_cycle_kernel here) and _wave_cycle_kernel
// (wave_cycle_kernel here), both launched by _run_cycle.  They compute what
// those kernels compute, in 32-bit integers as they do, and share the
// Filter/Score device function node_score as the TPU kernels share
// _kernel_scores.  They do not copy the TPU kernels' lane packing or block
// structure; the 128-pod block survives only where it sets the wave
// kernel's round count (a wave never crosses a block end).
//
// Arithmetic.  Every score is exact int32 with truncating division on
// non-negative operands, which is floor division there.  The wrappers take
// only snapshots that check_i32_bounds admits (node values below 2^31 /
// 100, quota rows with room for every request) and extra scores below
// 2^29, so no intermediate overflows: (cap - t) * 100 and min(t, cap) * 100
// stay below 2^31.  The
// TPU kernels' f32-reciprocal division exists because the TPU's vector unit
// has no integer divide; this card has one.
//
// wide_cycle_kernel: one CTA of 1024 threads; thread t owns the nodes
// n == t (mod 1024).  Per pod: every thread filters and scores its nodes,
// a block reduction finds the lexicographic (max score, min index), the
// owner of the chosen node and thread 0 (quota) commit, and one
// __syncthreads orders the next pod after this Reserve.
//
// wave_cycle_kernel: one CTA of 1024 threads = 32 warps runs every round.
//   Phase A: warp w takes wave lanes w, w + 32, ...; for its pod it scores
//   every node against the round-start state into a scratch row in global
//   memory (L2-resident), then picks the top-M (score, node) pairs by M
//   warp-wide lexicographic argmax passes, masking each winner, exactly as
//   the TPU kernel's pick loop does (once only infeasible nodes remain, a
//   pass yields the sentinel pair (INT_MIN, 0)).
//   Phase B (after __syncthreads): warp 0 resolves the wave in queue order.
//   Per pod its lanes re-key the pod's own candidates, and under
//   MostAllocated the nodes committed to earlier in the round, against the
//   live state; a warp reduction gives the lexicographic best, which is
//   certified against the frozen M-th pair; quota is rechecked against the
//   live quota row (lanes over resources); a certified pod's Reserve lands
//   at once in the node and quota state, so the next pod's re-key reads
//   it.  The first uncertified pod ends the round's commit prefix.
//
// What bounds them on this card: the pods' sequential chain.  The wide
// kernel is latency-bound like the dense one (cycle_cuda.cu).  The wave
// kernel does rounds x W x N scoring cells in phase A, spread over 32
// warps of one SM, and a short sequential phase B; the other 131 SMs are
// idle.  Spreading phase A over a cluster or a cooperative grid is the
// next step (see PERF.md).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxResources = 32;
constexpr int kBlock = 128;  // pod block of the TPU kernel's grid
constexpr int kMaxLanes = 128;  // cap of W and M
constexpr unsigned kFull = 0xffffffffu;

// node flag bits (solver/dense.py FLAG_*)
constexpr unsigned char kFlagOk = 1;      // valid & LoadAware default mask
constexpr unsigned char kFlagProdOk = 2;  // valid & LoadAware prod mask
constexpr unsigned char kFlagFresh = 4;   // NodeMetric fresh

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
  // wave cycle only
  int wave, top_m;        // W and M, already capped by the wrapper
  int32_t* scratch;       // [W, N] frozen scores, then [W, M] x 2 pairs
  int32_t* rounds;        // [1] out
};

__device__ __forceinline__ int32_t least_requested(int32_t t, int32_t cap) {
  if (cap == 0 || t > cap) return 0;
  return (cap - t) * 100 / cap;
}

__device__ __forceinline__ int32_t most_requested(int32_t t, int32_t cap) {
  if (cap == 0) return 0;
  return (t < cap ? t : cap) * 100 / cap;
}

// lexicographic (max score, min index)
__device__ __forceinline__ void take_better(int32_t& best, int& idx,
                                            int32_t ob, int oi) {
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

__device__ __forceinline__ void warp_best(int32_t& best, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    take_better(best, idx, __shfl_xor_sync(kFull, best, off),
                __shfl_xor_sync(kFull, idx, off));
  }
}

// Filter and Score of pod p (queue slot) on node n against the current
// node state: the score, or INT_MIN when the node fails Fit on a requested
// resource, its LoadAware flag or the extra mask.  Pod validity and quota
// are node-invariant and checked by the callers.  s_w: [2][R] weights.
__device__ int32_t node_score(const WideParams& c, int p, int n, bool prod,
                              const int32_t (*s_w)[kMaxResources]) {
  const int N = c.N, R = c.R;
  const unsigned char f = c.flags[n];
  if (!(f & (prod ? kFlagProdOk : kFlagOk))) return INT_MIN;
  const int32_t* req = c.preq + (size_t)p * R;
  for (int r = 0; r < R; ++r) {
    const int32_t rq = req[r];
    if (rq > 0 && c.nreq[(size_t)r * N + n] + rq > c.alloc[(size_t)r * N + n]) {
      return INT_MIN;
    }
  }
  int32_t total = 0;
  if (c.xcomb != nullptr) {
    const int32_t x = c.xcomb[(size_t)p * N + n];
    if (x == INT_MIN) return INT_MIN;
    total = x;
  }
  if (c.enable_fit && c.fit_wsum != 0) {
    const int32_t* sreq = c.psreq + (size_t)p * R;
    int32_t acc = 0;
    for (int r = 0; r < R; ++r) {
      const int32_t w = s_w[0][r];
      if (w == 0) continue;
      const size_t i = (size_t)r * N + n;
      const int32_t t = c.nreq[i] + sreq[r];
      acc += (c.most_allocated ? most_requested(t, c.alloc[i])
                               : least_requested(t, c.alloc[i])) * w;
    }
    total += c.fit_pw * (acc / c.fit_wsum);
  }
  if (c.enable_la && c.la_wsum != 0 && (f & kFlagFresh)) {
    const int32_t* est = c.pest + (size_t)p * R;
    const int32_t* usage = prod ? c.uprod : c.usage;
    int32_t acc = 0;
    for (int r = 0; r < R; ++r) {
      const int32_t w = s_w[1][r];
      if (w == 0) continue;
      const size_t i = (size_t)r * N + n;
      acc += least_requested(usage[i] + c.nest[i] + est[r], c.alloc[i]) * w;
    }
    total += c.la_pw * (acc / c.la_wsum);
  }
  return total;
}

__device__ __forceinline__ void load_weights(const WideParams& c,
                                             int32_t (*s_w)[kMaxResources]) {
  if (threadIdx.x < c.R) {
    s_w[0][threadIdx.x] = c.weights[threadIdx.x];
    s_w[1][threadIdx.x] = c.weights[c.R + threadIdx.x];
  }
  __syncthreads();
}

// ElasticQuota admission of pod p against the live quota row, by the
// calling warp's lanes (one per resource); uniform across the warp.
__device__ __forceinline__ bool quota_blocked_warp(const WideParams& c, int p,
                                                   int lane) {
  const int qid = c.pqid[p];
  if (qid < 0) return false;
  bool viol = false;
  if (lane < c.R) {
    const size_t q = (size_t)qid * c.R + lane;
    viol = c.qlim[q] && c.quse[q] + c.preq[(size_t)p * c.R + lane] > c.qrt[q];
  }
  return __any_sync(kFull, viol);
}

__global__ void __launch_bounds__(kThreads, 1) wide_cycle_kernel(WideParams c) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = c.N, R = c.R;
  __shared__ int32_t s_w[2][kMaxResources];
  __shared__ int32_t s_best[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_blocked;
  load_weights(c, s_w);

  for (int p = 0; p < c.P; ++p) {
    if (!c.pvalid[p]) {  // uniform across the block
      if (tid == 0) c.chosen[p] = -1;
      continue;
    }
    if (warp == 0) {
      const bool blocked = quota_blocked_warp(c, p, lane);
      if (lane == 0) s_blocked = blocked;
    }
    __syncthreads();
    const bool prod = c.pprod[p] != 0;
    // argmax over ALL nodes of where(feasible, score, INT_MIN), first index
    // on ties: start from the lowest owned index at INT_MIN
    int32_t best = INT_MIN;
    int best_idx = tid < N ? tid : INT_MAX;
    if (!s_blocked) {
      for (int n = tid; n < N; n += kThreads) {
        const int32_t s = node_score(c, p, n, prod, s_w);
        if (s > best) {  // n ascends, so ties keep the lower index
          best = s;
          best_idx = n;
        }
      }
    }
    warp_best(best, best_idx);
    if (lane == 0) {
      s_best[warp] = best;
      s_idx[warp] = best_idx;
    }
    __syncthreads();
    best = s_best[lane];
    best_idx = s_idx[lane];
    warp_best(best, best_idx);

    // Reserve (feasible scores are > INT_MIN: extra scores are < 2^29)
    const int chosen = best > INT_MIN ? best_idx : -1;
    if (tid == 0) c.chosen[p] = chosen;
    if (chosen >= 0) {
      if (chosen % kThreads == tid) {
        for (int r = 0; r < R; ++r) {
          c.nreq[(size_t)r * N + chosen] += c.preq[(size_t)p * R + r];
          c.nest[(size_t)r * N + chosen] += c.pest[(size_t)p * R + r];
        }
      }
      const int qid = c.pqid[p];
      if (qid >= 0 && tid == 0) {
        for (int r = 0; r < R; ++r) {
          c.quse[(size_t)qid * R + r] += c.preq[(size_t)p * R + r];
        }
      }
    }
    // the next pod reads this pod's commits and reuses s_*
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1) wave_cycle_kernel(WideParams c) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = c.N, R = c.R;
  const int W = c.wave, M = c.top_m;
  int32_t* frozen = c.scratch;               // [W, N]
  int32_t* cand_s = c.scratch + (size_t)W * N;  // [W, M]
  int* cand_i = cand_s + (size_t)W * M;      // [W, M]
  __shared__ int32_t s_w[2][kMaxResources];
  __shared__ int s_taken[kMaxLanes];  // node committed by wave lane, or -1
  __shared__ int s_ncommit;
  load_weights(c, s_w);

  int rounds = 0;
  for (int base = 0; base < c.P; base += kBlock) {
    int ptr = 0;  // uniform across the block
    while (ptr < kBlock) {
      // Phase A: freeze each wave pod's top-M against the round-start state
      for (int w = warp; w < W; w += kWarps) {
        const int j = ptr + w;
        const int p = base + j;
        int32_t* cs = cand_s + (size_t)w * M;
        int* ci = cand_i + (size_t)w * M;
        if (j >= kBlock || p >= c.P || !c.pvalid[p]) {
          for (int m = lane; m < M; m += 32) {
            cs[m] = INT_MIN;
            ci[m] = 0;
          }
          continue;
        }
        const bool prod = c.pprod[p] != 0;
        int32_t* row = frozen + (size_t)w * N;
        for (int n = lane; n < N; n += 32) row[n] = node_score(c, p, n, prod, s_w);
        __syncwarp();
        for (int m = 0; m < M; ++m) {
          int32_t best = INT_MIN;
          int idx = INT_MAX;
          for (int n = lane; n < N; n += 32) take_better(best, idx, row[n], n);
          warp_best(best, idx);  // all-INT_MIN rows give (INT_MIN, 0)
          if (lane == 0) {
            cs[m] = best;
            ci[m] = idx;
            row[idx] = INT_MIN;
          }
          __syncwarp();
        }
      }
      __syncthreads();

      // Phase B: resolve the wave in queue order (warp 0)
      if (warp == 0) {
        int ncommit = 0;
        const bool most = c.enable_fit && c.most_allocated;
        for (int w = 0; w < W; ++w) {
          const int j = ptr + w;
          const int p = base + j;
          if (j >= kBlock || p >= c.P || !c.pvalid[p]) {
            // node-independent -1: certified, takes no node
            if (lane == 0) {
              if (j < kBlock && p < c.P) c.chosen[p] = -1;
              s_taken[w] = -1;
            }
            ++ncommit;
            __syncwarp();
            continue;
          }
          int choice = -1;
          if (!quota_blocked_warp(c, p, lane)) {
            const bool prod = c.pprod[p] != 0;
            const int32_t* cs = cand_s + (size_t)w * M;
            const int* ci = cand_i + (size_t)w * M;
            int32_t best = INT_MIN;  // seeded (INT_MIN, 0)
            int idx = 0;
            for (int m = lane; m < M; m += 32) {
              // a sentinel slot's index is no real candidate
              if (cs[m] != INT_MIN) take_better(best, idx, node_score(c, p, ci[m], prod, s_w), ci[m]);
            }
            if (most) {
              for (int e = lane; e < w; e += 32) {
                const int node = s_taken[e];
                if (node >= 0) take_better(best, idx, node_score(c, p, node, prod, s_w), node);
              }
            }
            warp_best(best, idx);
            const int32_t ks = cs[M - 1];
            const int ki = ci[M - 1];
            const bool certified = best > ks || (best == ks && idx <= ki) ||
                                   ks == INT_MIN || (most && w == 0);
            if (!certified) break;  // ends the commit prefix (warp-uniform)
            choice = best > INT_MIN ? idx : -1;
          }
          // commit, with a live Reserve
          if (choice >= 0 && lane < R) {
            const int32_t rq = c.preq[(size_t)p * R + lane];
            c.nreq[(size_t)lane * N + choice] += rq;
            c.nest[(size_t)lane * N + choice] += c.pest[(size_t)p * R + lane];
            const int qid = c.pqid[p];
            if (qid >= 0) c.quse[(size_t)qid * R + lane] += rq;
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
      __syncthreads();
      ptr += s_ncommit;
      ++rounds;
      // s_ncommit is rewritten only after the next phase A's barrier
    }
  }
  if (tid == 0) *c.rounds = rounds;
}

int check_dims(int P, int N, int R) {
  if (P < 0 || N < 1 || R < 1 || R > kMaxResources) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Plain C entry points, bound with ctypes (solver/wide.py).  Each launches
// on ``stream`` and returns the cudaError_t of the launch (0 = success).
extern "C" int koord_wide_cycle_launch(
    int P, int N, int R,
    const int32_t* preq, const int32_t* psreq, const int32_t* pest,
    const int32_t* pqid, const uint8_t* pvalid, const uint8_t* pprod,
    const int32_t* alloc, const int32_t* usage, const int32_t* uprod,
    const uint8_t* flags, const int32_t* qrt, const uint8_t* qlim,
    const int32_t* weights, int32_t fit_wsum, int32_t la_wsum,
    int32_t fit_pw, int32_t la_pw, int most_allocated, int enable_fit,
    int enable_la, const int32_t* xcomb, int32_t* chosen, int32_t* nreq,
    int32_t* nest, int32_t* quse, void* stream) {
  if (int err = check_dims(P, N, R)) return err;
  WideParams c{P, N, R, preq, psreq, pest, pqid, pvalid, pprod,
               alloc, usage, uprod, flags, qrt, qlim, weights,
               fit_wsum, la_wsum, fit_pw, la_pw,
               most_allocated, enable_fit, enable_la,
               xcomb, chosen, nreq, nest, quse, 0, 0, nullptr, nullptr};
  wide_cycle_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}

extern "C" int koord_wave_cycle_launch(
    int P, int N, int R,
    const int32_t* preq, const int32_t* psreq, const int32_t* pest,
    const int32_t* pqid, const uint8_t* pvalid, const uint8_t* pprod,
    const int32_t* alloc, const int32_t* usage, const int32_t* uprod,
    const uint8_t* flags, const int32_t* qrt, const uint8_t* qlim,
    const int32_t* weights, int32_t fit_wsum, int32_t la_wsum,
    int32_t fit_pw, int32_t la_pw, int most_allocated, int enable_fit,
    int enable_la, const int32_t* xcomb, int32_t* chosen, int32_t* nreq,
    int32_t* nest, int32_t* quse, int wave, int top_m, int32_t* scratch,
    int32_t* rounds, void* stream) {
  if (int err = check_dims(P, N, R)) return err;
  if (wave < 1 || wave > kMaxLanes || top_m < 1 || top_m > kMaxLanes) {
    return (int)cudaErrorInvalidValue;
  }
  WideParams c{P, N, R, preq, psreq, pest, pqid, pvalid, pprod,
               alloc, usage, uprod, flags, qrt, qlim, weights,
               fit_wsum, la_wsum, fit_pw, la_pw,
               most_allocated, enable_fit, enable_la,
               xcomb, chosen, nreq, nest, quse, wave, top_m, scratch, rounds};
  wave_cycle_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}
