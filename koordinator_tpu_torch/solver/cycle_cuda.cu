// The whole priority-ordered Assign cycle in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel koordinator_tpu/solver/pallas_dense.py
// _cycle_kernel_dense (launched by _run_cycle_dense).  It computes the
// same function: for each pod in queue order, Filter (Fit on the requested
// resources, the node's LoadAware flag, ElasticQuota admission, the extra
// plugin mask), Score (NodeResourcesFit least/most allocated + LoadAware +
// the extra plugin score), argmax with the lowest-index tie-break, then
// Reserve into node requested, node estimated and quota used.  It does not
// copy the TPU kernel's block structure or its lane/sublane layout tricks.
//
// Design.  One CTA of 1024 threads runs the whole cycle; thread t owns the
// nodes n == t (mod 1024), so only the owner ever reads or writes a node's
// carried state and Reserve needs no atomics.  Per pod: every thread
// filters and scores its nodes, a warp-shuffle + shared-memory reduction
// finds the lexicographic (max score, min index), the owner of the chosen
// node commits it, thread 0 commits the quota row, and one __syncthreads
// orders the next pod after this pod's Reserve.  Node state lives in
// global memory in resource-major [R, N] layout (coalesced per resource);
// at 2k nodes x 13 resources it is under 1 MB and stays in L1/L2.
//
// Arithmetic is exact int64 with floor division, the same as the int64
// PyTorch oracle (solver/greedy.py): no 32-bit range limit, no reciprocal
// trick.  The extra-plugin tensor is int64 with INT64_MIN as the
// infeasible sentinel, so it takes extra scores of any int64 magnitude.
//
// What bounds it on this card: the pods are a sequential chain (each pod
// sees the previous pod's Reserve), so the cycle is bound by the latency
// of one pod step on one SM times the number of pods, not by bytes or
// operations (the whole input is a few MB; see PERF.md).  Spreading a pod
// step over a thread-block cluster is the next step.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxResources = 32;
constexpr unsigned kFull = 0xffffffffu;

// node flag bits (solver/dense.py FLAG_*)
constexpr unsigned char kFlagOk = 1;      // valid & LoadAware default mask
constexpr unsigned char kFlagProdOk = 2;  // valid & LoadAware prod mask
constexpr unsigned char kFlagFresh = 4;   // NodeMetric fresh

struct CycleParams {
  int P, N, R;
  const int64_t* preq;   // [P, R] queue order
  const int64_t* psreq;  // [P, R] non-zero score requests
  const int64_t* pest;   // [P, R] LoadAware estimates
  const int32_t* pqid;   // [P] quota id, -1 = none
  const uint8_t* pvalid; // [P]
  const uint8_t* pprod;  // [P] pod takes the prod mask/usage
  const int64_t* alloc;  // [R, N]
  const int64_t* usage;  // [R, N] score usage, non-prod pods
  const int64_t* uprod;  // [R, N] score usage, prod pods
  const uint8_t* flags;  // [N]
  const int64_t* qrt;    // [Q, R]
  const uint8_t* qlim;   // [Q, R]
  const int64_t* weights;  // [2, R]: fit, LoadAware
  int64_t fit_wsum, la_wsum, fit_pw, la_pw;
  int most_allocated, enable_fit, enable_la;
  const int64_t* xcomb;  // [P, N] or null; INT64_MIN = infeasible
  int32_t* chosen;       // [P] out
  int64_t* nreq;         // [R, N] in/out
  int64_t* nest;         // [R, N] in/out
  int64_t* quse;         // [Q, R] in/out
};

__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  int64_t r = a - q * b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int64_t least_requested(int64_t t, int64_t cap) {
  if (cap == 0 || t > cap) return 0;
  return floordiv((cap - t) * 100, cap);
}

__device__ __forceinline__ int64_t most_requested(int64_t t, int64_t cap) {
  if (cap == 0) return 0;
  return floordiv((t < cap ? t : cap) * 100, cap);
}

__device__ __forceinline__ int64_t weighted(int64_t total, int64_t wsum) {
  return wsum == 0 ? 0 : floordiv(total, wsum > 1 ? wsum : 1);
}

// lexicographic (max score, min index)
__device__ __forceinline__ void take_better(int64_t& best, int& idx,
                                            int64_t ob, int oi) {
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

__global__ void __launch_bounds__(kThreads, 1) cycle_kernel(CycleParams c) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = c.N, R = c.R;
  __shared__ int64_t s_w[2][kMaxResources];
  __shared__ int64_t s_best[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_any[kWarps];
  if (tid < R) {
    s_w[0][tid] = c.weights[tid];
    s_w[1][tid] = c.weights[R + tid];
  }
  __syncthreads();

  for (int p = 0; p < c.P; ++p) {
    if (!c.pvalid[p]) {  // uniform across the block
      if (tid == 0) c.chosen[p] = -1;
      continue;
    }
    const int64_t* req = c.preq + (size_t)p * R;
    const int64_t* sreq = c.psreq + (size_t)p * R;
    const int64_t* est = c.pest + (size_t)p * R;
    const int qid = c.pqid[p];

    // ElasticQuota admission: node-invariant, evaluated by every thread
    bool quota_ok = true;
    if (qid >= 0) {
      for (int r = 0; r < R; ++r) {
        const size_t q = (size_t)qid * R + r;
        if (c.qlim[q] && c.quse[q] + req[r] > c.qrt[q]) quota_ok = false;
      }
    }
    const bool prod = c.pprod[p] != 0;
    const unsigned char ok_bit = prod ? kFlagProdOk : kFlagOk;
    const int64_t* usage = prod ? c.uprod : c.usage;

    // argmax over ALL nodes of where(feasible, score, INT64_MIN), first
    // index on ties: start from the lowest owned index at INT64_MIN
    int64_t best = LLONG_MIN;
    int best_idx = tid < N ? tid : INT_MAX;
    int any = 0;
    if (quota_ok) {
      for (int n = tid; n < N; n += kThreads) {
        const unsigned char f = c.flags[n];
        if (!(f & ok_bit)) continue;
        bool fits = true;
        for (int r = 0; r < R; ++r) {
          const int64_t rq = req[r];
          if (rq > 0 && c.nreq[(size_t)r * N + n] + rq > c.alloc[(size_t)r * N + n]) {
            fits = false;
            break;
          }
        }
        if (!fits) continue;
        int64_t total = 0;
        if (c.xcomb != nullptr) {
          const int64_t x = c.xcomb[(size_t)p * N + n];
          if (x == LLONG_MIN) continue;
          total = x;
        }
        if (c.enable_fit) {
          int64_t acc = 0;
          for (int r = 0; r < R; ++r) {
            const int64_t w = s_w[0][r];
            if (w == 0) continue;
            const size_t i = (size_t)r * N + n;
            const int64_t t = c.nreq[i] + sreq[r];
            acc += (c.most_allocated ? most_requested(t, c.alloc[i])
                                     : least_requested(t, c.alloc[i])) * w;
          }
          total += c.fit_pw * weighted(acc, c.fit_wsum);
        }
        if (c.enable_la && (f & kFlagFresh)) {
          int64_t acc = 0;
          for (int r = 0; r < R; ++r) {
            const int64_t w = s_w[1][r];
            if (w == 0) continue;
            const size_t i = (size_t)r * N + n;
            acc += least_requested(usage[i] + c.nest[i] + est[r], c.alloc[i]) * w;
          }
          total += c.la_pw * weighted(acc, c.la_wsum);
        }
        any = 1;
        if (total > best) {  // n ascends, so ties keep the lower index
          best = total;
          best_idx = n;
        }
      }
    }

    // block reduction: warps, then the 32 warp partials in every warp
    for (int off = 16; off > 0; off >>= 1) {
      take_better(best, best_idx,
                  (int64_t)__shfl_down_sync(kFull, (long long)best, off),
                  __shfl_down_sync(kFull, best_idx, off));
    }
    any = __any_sync(kFull, any);
    if (lane == 0) {
      s_best[warp] = best;
      s_idx[warp] = best_idx;
      s_any[warp] = any;
    }
    __syncthreads();
    best = s_best[lane];
    best_idx = s_idx[lane];
    any = __any_sync(kFull, s_any[lane]);
    for (int off = 16; off > 0; off >>= 1) {
      take_better(best, best_idx,
                  (int64_t)__shfl_xor_sync(kFull, (long long)best, off),
                  __shfl_xor_sync(kFull, best_idx, off));
    }

    // Reserve
    const int chosen = any ? best_idx : -1;
    if (tid == 0) c.chosen[p] = chosen;
    if (chosen >= 0) {
      if (chosen % kThreads == tid) {
        for (int r = 0; r < R; ++r) {
          c.nreq[(size_t)r * N + chosen] += req[r];
          c.nest[(size_t)r * N + chosen] += est[r];
        }
      }
      if (qid >= 0 && tid == 0) {
        for (int r = 0; r < R; ++r) c.quse[(size_t)qid * R + r] += req[r];
      }
    }
    // the next pod reads this pod's quota commit and reuses s_*
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (solver/dense.py).  Launches on
// ``stream`` and returns the cudaError_t of the launch (0 = success).
extern "C" int koord_cycle_launch(
    int P, int N, int R,
    const int64_t* preq, const int64_t* psreq, const int64_t* pest,
    const int32_t* pqid, const uint8_t* pvalid, const uint8_t* pprod,
    const int64_t* alloc, const int64_t* usage, const int64_t* uprod,
    const uint8_t* flags, const int64_t* qrt, const uint8_t* qlim,
    const int64_t* weights, int64_t fit_wsum, int64_t la_wsum,
    int64_t fit_pw, int64_t la_pw, int most_allocated, int enable_fit,
    int enable_la, const int64_t* xcomb, int32_t* chosen, int64_t* nreq,
    int64_t* nest, int64_t* quse, void* stream) {
  if (P < 0 || N < 1 || R < 1 || R > kMaxResources) {
    return (int)cudaErrorInvalidValue;
  }
  CycleParams c{P, N, R, preq, psreq, pest, pqid, pvalid, pprod,
                alloc, usage, uprod, flags, qrt, qlim, weights,
                fit_wsum, la_wsum, fit_pw, la_pw,
                most_allocated, enable_fit, enable_la,
                xcomb, chosen, nreq, nest, quse};
  cycle_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}
