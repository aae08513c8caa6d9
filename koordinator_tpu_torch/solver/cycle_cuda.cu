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
// Design: one thread-block cluster of C CTAs (cluster_state.cuh: C = 16 on
// an H100, else 8) of 128 threads each.  CTA k owns the node slice [k*S,
// (k+1)*S) and holds its state (alloc, usage, nreq, nest, flags and one
// reciprocal per (r, n) for the divisions by cap) in its shared memory.
// Per pod:
//   * each thread filters and scores its nodes of the slice (one at the
//     headline) out of shared memory, visiting only the pod's active
//     resources (requested, or weighted by Fit or LoadAware: 3 of 13 at
//     the headline); the next valid pod's rows and active list are staged
//     in shared memory (three deep), and its xcomb value read, while this
//     pod's barrier waits: warp 0 loads each pod's rows into registers a
//     pod step before it stages them, so no thread waits on those loads;
//   * each warp reduces its lexicographic (max score, min index), seeded
//     with the lowest owned index at INT64_MIN, and its any-feasible bit
//     by shuffles and publishes them in a slot of the CTA's shared memory,
//     double-buffered by pod parity, so pod p + 1's publish never
//     overwrites what another CTA may still be reading of pod p;
//   * one cluster barrier (the pod's only barrier); every warp reads the
//     C x 4 slots through DSMEM and merges them (the OR of the any bits;
//     contiguous slices make the lexicographic merge keep the lowest
//     index);
//   * the owner thread of the chosen node commits Reserve to its own
//     shared memory (the same thread scores that node next, so no barrier
//     orders it); rank 0 alone holds the quota rows, checks admission at
//     the start of the pod (its blocked bit rides its slot) and commits
//     quota and chosen[p].
// A slice that does not fit in shared memory (large N) runs the same code
// over the device-memory state, with the reciprocals in a device table.
// Built with -DKOORD_PHASE_CLOCK, rank 0's thread 0 sums clock64 cycles of
// each pod step's parts (koord_cycle_phase_cycles); the main path's build
// carries no timing code.
//
// Arithmetic is exact int64 with floor division, the same as the int64
// PyTorch oracle (solver/greedy.py), wrapping products included.  The
// divisions by cap and by the weight sums use the reciprocals of
// cluster_state.cuh for a non-negative numerator and a positive divisor,
// and the plain floordiv otherwise.  The extra-plugin tensor is int64 with
// INT64_MIN as the infeasible sentinel, so it takes extra scores of any
// int64 magnitude.
//
// What bounds it on this card: the pods are a sequential chain (each pod
// sees the previous pod's Reserve), so the cycle is bound by the latency
// of one pod step times the number of pods: the slice's Filter/Score out of
// shared memory, two warp reductions and one cluster barrier.  Bytes and
// operations are orders of magnitude below it (PERF.md).

#include "cluster_state.cuh"

#include <mutex>

namespace {

namespace cg = cooperative_groups;
using koord::NodeView;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxResources = koord::kMaxResources;
constexpr unsigned kFull = koord::kFull;
// quota rows go to rank 0's shared memory up to this size
constexpr size_t kQuotaSmem = 32768;

struct CycleParams {
  int P, N, R, Q;
  const int64_t* preq;   // [P, R] queue order
  const int64_t* psreq;  // [P, R] non-zero score requests
  const int64_t* pest;   // [P, R] LoadAware estimates
  const int32_t* pqid;   // [P] quota id, -1 = none
  const uint8_t* pvalid; // [P]
  const uint8_t* pprod;  // [P] pod takes the prod mask/usage
  const int64_t* qrt;    // [Q, R]
  const uint8_t* qlim;   // [Q, R]
  const int64_t* weights;  // [2, R]: fit, LoadAware
  int64_t fit_wsum, la_wsum, fit_pw, la_pw;
  int most_allocated, enable_fit, enable_la;
  const int64_t* xcomb;  // [P, N] or null; INT64_MIN = infeasible
  int32_t* chosen;       // [P] out
  int64_t* quse;         // [Q, R] in/out
  koord::GlobalState<int64_t> g;  // node state; nreq, nest in/out
  int S, resident, uprod_shared, quota_resident;
  size_t quota_bytes;    // rank 0's quota rows at the start of dynamic smem
};

// one CTA's slice result for a pod: bit 0 of flags = a node is feasible,
// bit 1 = rank 0 found the pod blocked by its quota
struct alignas(16) Partial {
  int64_t best;
  int idx;
  int flags;
};

__device__ __forceinline__ int64_t least_requested(int64_t t, int64_t cap, uint64_t m, uint8_t l) {
  if (cap == 0 || t > cap) return 0;
  return koord::floordiv_i64((int64_t)(((uint64_t)cap - (uint64_t)t) * 100u), cap, m, l);
}

__device__ __forceinline__ int64_t most_requested(int64_t t, int64_t cap, uint64_t m, uint8_t l) {
  if (cap == 0) return 0;
  return koord::floordiv_i64((int64_t)((uint64_t)(t < cap ? t : cap) * 100u), cap, m, l);
}

__device__ __forceinline__ int64_t weighted(int64_t total, int64_t wsum, uint64_t m, uint8_t l) {
  return wsum == 0 ? 0 : koord::floordiv_i64(total, wsum > 1 ? wsum : 1, m, l);
}

#ifdef KOORD_PHASE_CLOCK
// cycles of rank 0's thread 0 per pod step: quota and Filter/Score of the
// slice, staging the next pod, the warp reduction and the cluster barrier,
// the merge and Reserve
__device__ unsigned long long g_pod_cycles[4];
#define KOORD_STAMP(var) const long long var = clock64()
#else
#define KOORD_STAMP(var)
#endif

// Pod rows staged in shared memory, three deep: the rows of the i-th
// valid pod are read until its Reserve, which every thread finishes before
// the barrier of pod i + 1, and are overwritten by pod i + 3's after it.
constexpr int kStages = 3;
struct PodRows {
  int64_t req[kMaxResources];
  int64_t sreq[kMaxResources];
  int64_t est[kMaxResources];
  // the resources that can change the pod's result: requested, or weighted
  // by Fit or by LoadAware; the others add nothing and are skipped
  uint8_t act[kMaxResources];
  int nact, qid, prod;
};

struct Divs {  // reciprocals of the weight sums
  uint64_t fit_m, la_m;
  uint8_t fit_l, la_l;
};

// The first valid pod at or after p (P when none); ``writer`` writes -1
// for the invalid pods it passes.
__device__ __forceinline__ int next_valid(const CycleParams& c, int p, bool writer) {
  while (p < c.P && !c.pvalid[p]) {
    if (writer) c.chosen[p] = -1;
    ++p;
  }
  return p;
}

// By warp 0 (lane r: resource r), which also wrote s_w.
// One pod's rows in warp 0's registers (lane r: resource r), loaded a pod
// step before they are staged: no thread waits on their loads.
struct HeldRows {
  int64_t req = 0, sreq = 0, est = 0;
  int qid = -1, prod = 0;

  __device__ __forceinline__ void load(const CycleParams& c, int p, int lane) {
    if (lane < c.R) {
      const size_t k = (size_t)p * c.R + lane;
      req = c.preq[k];
      sreq = c.psreq[k];
      est = c.pest[k];
    }
    if (lane == 0) {
      qid = c.pqid[p];
      prod = c.pprod[p];
    }
  }

  // Stage into ``s`` with the pod's active resources; s_w holds the
  // weights (written by these lanes).
  __device__ __forceinline__ void stage(const CycleParams& c, PodRows& s, int lane,
                                        const int64_t (*s_w)[kMaxResources]) const {
    bool active = false;
    if (lane < c.R) {
      s.req[lane] = req;
      s.sreq[lane] = sreq;
      s.est[lane] = est;
      active = req > 0 || s_w[0][lane] != 0 || s_w[1][lane] != 0;
    }
    const unsigned ballot = __ballot_sync(kFull, active);
    if (active) s.act[__popc(ballot & ((1u << lane) - 1))] = (uint8_t)lane;
    if (lane == 0) {
      s.nact = __popc(ballot);
      s.qid = qid;
      s.prod = prod;
    }
  }
};

// Filter and Score of the staged pod on node n: false when the node fails
// its LoadAware flag, Fit on a requested resource or the extra mask
// (``x``, read ahead), else the score in ``total``.  Only the pod's active
// resources are visited.
__device__ __forceinline__ bool score_node(const CycleParams& c, const NodeView<int64_t>& v,
                                           const PodRows& pr, int n, int64_t x,
                                           const int64_t (*s_w)[kMaxResources], const Divs& d,
                                           int64_t& total) {
  const unsigned char f = v.flag(n);
  if (!(f & (pr.prod ? koord::kFlagProdOk : koord::kFlagOk))) return false;
  const int64_t* usage = pr.prod ? v.uprod : v.usage;
  int64_t fit = 0, la = 0;
  bool fits = true;
  // unrolled without an early exit, so that the loads of several
  // resources issue together and their arithmetic interleaves
#pragma unroll 4
  for (int k = 0; k < pr.nact; ++k) {
    const int r = pr.act[k];
    const int i = v.at(r, n);
    const int64_t cap = v.alloc[i];
    const int64_t nr = v.nreq[i];
    const uint64_t m = v.magic[i];
    const uint8_t l = v.shift[i];
    const int64_t rq = pr.req[r];
    fits = fits & !(rq > 0 && nr + rq > cap);
    const int64_t wf = s_w[0][r];
    const int64_t wl = s_w[1][r];
    if (wf != 0) {
      const int64_t t = nr + pr.sreq[r];
      fit += (c.most_allocated ? most_requested(t, cap, m, l) : least_requested(t, cap, m, l)) * wf;
    }
    if (wl != 0) la += least_requested(usage[i] + v.nest[i] + pr.est[r], cap, m, l) * wl;
  }
  if (!fits) return false;
  total = 0;
  if (c.xcomb != nullptr) {
    if (x == LLONG_MIN) return false;
    total = x;
  }
  if (c.enable_fit) total += c.fit_pw * weighted(fit, c.fit_wsum, d.fit_m, d.fit_l);
  if (c.enable_la && (f & koord::kFlagFresh)) {
    total += c.la_pw * weighted(la, c.la_wsum, d.la_m, d.la_l);
  }
  return true;
}

__global__ void __launch_bounds__(kThreads, 1) cycle_kernel(CycleParams c) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int C = (int)cl.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = c.N, R = c.R, Q = c.Q;
  const int lo = min(rank * c.S, N);
  const int hi = min(lo + c.S, N);
  extern __shared__ __align__(16) char smem[];
  __shared__ int64_t s_w[2][kMaxResources];
  __shared__ Partial s_part[2][kWarps];  // by pod parity, then warp
  __shared__ PodRows s_pod[kStages];

  if (tid < kMaxResources) {
    s_w[0][tid] = tid < R ? c.weights[tid] : 0;
    s_w[1][tid] = tid < R ? c.weights[R + tid] : 0;
  }
  Divs d;  // once per cycle
  koord::Recip<int64_t>::build(c.fit_wsum > 1 ? c.fit_wsum : 1, d.fit_m, d.fit_l);
  koord::Recip<int64_t>::build(c.la_wsum > 1 ? c.la_wsum : 1, d.la_m, d.la_l);

  int64_t* quse = c.quse;
  const int64_t* qrt = c.qrt;
  const uint8_t* qlim = c.qlim;
  if (c.quota_resident) {
    int64_t* s_quse = reinterpret_cast<int64_t*>(smem);
    int64_t* s_qrt = s_quse + Q * R;
    uint8_t* s_qlim = reinterpret_cast<uint8_t*>(s_qrt + Q * R);
    if (rank == 0) {
      for (int i = tid; i < Q * R; i += kThreads) {
        s_quse[i] = c.quse[i];
        s_qrt[i] = c.qrt[i];
        s_qlim[i] = c.qlim[i];
      }
    }
    quse = s_quse;
    qrt = s_qrt;
    qlim = s_qlim;
  }
  const bool writer = rank == 0 && tid == 0;  // writes chosen[]
  const int n0 = lo + tid;  // this thread's first node
  int p = next_valid(c, 0, writer);
  int q = p < c.P ? next_valid(c, p + 1, writer) : c.P;  // the next valid pod
  int64_t x_cur = 0;  // xcomb[p, n0], read ahead
  HeldRows held;      // warp 0: the rows of pod q
  if (p < c.P) {
    if (warp == 0) {
      held.load(c, p, lane);
      held.stage(c, s_pod[0], lane, s_w);
      if (q < c.P) held.load(c, q, lane);
    }
    if (c.xcomb != nullptr && n0 < hi) x_cur = c.xcomb[(size_t)p * N + n0];
  }
  const NodeView<int64_t> v = koord::load_slice<int64_t>(
      c.g, N, R, lo, hi, c.S, c.resident, c.uprod_shared, smem + c.quota_bytes);
  cl.sync();  // every CTA has started before any DSMEM read

  for (int i = 0; p < c.P; ++i) {
    KOORD_STAMP(t_0);
    const PodRows& pr = s_pod[i % kStages];
    const int q2 = q < c.P ? next_valid(c, q + 1, writer) : c.P;

    // ElasticQuota admission: node-invariant, rank 0's warp 0 only (it
    // also commits the quota rows, so it reads its own writes)
    bool blocked = false;
    if (rank == 0 && warp == 0 && pr.qid >= 0) {
      bool viol = false;
      if (lane < R) {
        const size_t k = (size_t)pr.qid * R + lane;
        viol = qlim[k] && quse[k] + pr.req[lane] > qrt[k];
      }
      blocked = __any_sync(kFull, viol);
    }

    // argmax over the slice of where(feasible, score, INT64_MIN), first
    // index on ties: start from the lowest owned index at INT64_MIN
    int64_t best = LLONG_MIN;
    int best_idx = n0 < hi ? n0 : INT_MAX;
    int any = 0;
    for (int n = n0; n < hi; n += kThreads) {
      const int64_t x = c.xcomb == nullptr ? 0
                        : n == n0 ? x_cur : c.xcomb[(size_t)p * N + n];
      int64_t total;
      if (!score_node(c, v, pr, n, x, s_w, d, total)) continue;
      any = 1;
      if (total > best) {  // n ascends, so ties keep the lower index
        best = total;
        best_idx = n;
      }
    }
    KOORD_STAMP(t_s);
    // stage the next valid pod from the registers loaded a pod step ago,
    // load the rows of the pod after it, and read the next extra score
    int64_t x_next = 0;
    if (q < c.P) {
      if (warp == 0) {
        held.stage(c, s_pod[(i + 1) % kStages], lane, s_w);
        if (q2 < c.P) held.load(c, q2, lane);
      }
      if (c.xcomb != nullptr && n0 < hi) x_next = c.xcomb[(size_t)q * N + n0];
    }
    KOORD_STAMP(t_1);

    // each warp publishes its partial; one cluster barrier; then every
    // warp merges the C x kWarps partials, lane l reading l, l + 32, ...
    koord::warp_best(best, best_idx);
    any = __any_sync(kFull, any);
    if (lane == 0) s_part[i & 1][warp] = Partial{best, best_idx, any | (blocked ? 2 : 0)};
    cl.sync();
    int64_t mb = LLONG_MIN;
    int mi = INT_MAX;
    int mf = 0;
    for (int k = lane; k < C * kWarps; k += 32) {
      const Partial o = *cl.map_shared_rank(&s_part[i & 1][k % kWarps], k / kWarps);
      koord::take_better(mb, mi, o.best, o.idx);
      mf |= o.flags & 1;
      if (k == 0) mf |= o.flags & 2;  // rank 0, warp 0: the quota verdict
    }
    koord::warp_best(mb, mi);
    const bool feasible = __any_sync(kFull, mf & 1);
    const bool quota_blocked = __shfl_sync(kFull, mf, 0) & 2;
    const int chosen = feasible && !quota_blocked ? mi : -1;
    KOORD_STAMP(t_2);

    // Reserve: the owner thread in its CTA's slice; quota and chosen[p]
    // in rank 0
    if (chosen >= lo && chosen < hi && (chosen - lo) % kThreads == tid) {
      for (int r = 0; r < R; ++r) {
        const int k = v.at(r, chosen);
        v.nreq[k] += pr.req[r];
        v.nest[k] += pr.est[r];
      }
    }
    if (rank == 0) {
      if (warp == 0 && chosen >= 0 && pr.qid >= 0 && lane < R) {
        quse[(size_t)pr.qid * R + lane] += pr.req[lane];
      }
      if (tid == 0) c.chosen[p] = chosen;
    }
#ifdef KOORD_PHASE_CLOCK
    if (rank == 0 && tid == 0) {
      const long long t_3 = clock64();
      g_pod_cycles[0] += t_s - t_0;
      g_pod_cycles[1] += t_1 - t_s;
      g_pod_cycles[2] += t_2 - t_1;
      g_pod_cycles[3] += t_3 - t_2;
    }
#endif
    x_cur = x_next;
    p = q;
    q = q2;
  }

  __syncthreads();
  koord::store_slice<int64_t>(c.g, v, N, R, lo, hi);
  if (rank == 0 && c.quota_resident) {
    for (int i = tid; i < Q * R; i += kThreads) c.quse[i] = quse[i];
  }
  cl.sync();  // no CTA exits while another may read its slots
}

size_t quota_bytes(int Q, int R) {
  const size_t cells = (size_t)Q * R;
  return koord::align16(cells * 8) * 2 + koord::align16(cells);
}

// The launch plan for one shape, cached: the occupancy queries cost more
// than the launch.
cudaError_t plan_for(int N, int R, int Q, int uprod_shared, koord::ClusterPlan* plan,
                     int* quota_resident) {
  static std::mutex mu;
  static int key[4] = {-1, -1, -1, -1};
  static koord::ClusterPlan cached;
  std::lock_guard<std::mutex> lock(mu);
  const size_t qb = quota_bytes(Q, R);
  *quota_resident = qb <= kQuotaSmem;
  if (key[0] == N && key[1] == R && key[2] == Q && key[3] == uprod_shared) {
    *plan = cached;
    return cudaSuccess;
  }
  const cudaError_t err = koord::plan_cluster(
      cycle_kernel, N, kThreads, *quota_resident ? qb : 0,
      [&](int S) { return koord::carve_slice<int64_t>(nullptr, R, S, uprod_shared != 0, nullptr); },
      plan);
  if (err != cudaSuccess) return err;
  cached = *plan;
  key[0] = N;
  key[1] = R;
  key[2] = Q;
  key[3] = uprod_shared;
  return cudaSuccess;
}

}  // namespace

// Plain C entry points, bound with ctypes (solver/dense.py).

// The cluster plan of a cycle of this shape: out[0..5] = C, S, resident,
// dynamic shared bytes per CTA, cudaOccupancyMaxActiveClusters at C = 8
// and at C = 16.  Returns the cudaError_t (0 = success).
extern "C" int koord_cycle_plan(int N, int R, int Q, int uprod_shared, int* out) {
  koord::ClusterPlan plan;
  int quota_resident;
  const cudaError_t err = plan_for(N, R, Q, uprod_shared, &plan, &quota_resident);
  if (err != cudaSuccess) return (int)err;
  out[0] = plan.C;
  out[1] = plan.S;
  out[2] = plan.resident;
  out[3] = (int)plan.smem;
  out[4] = plan.occupancy8;
  out[5] = plan.occupancy16;
  return 0;
}

// Launches the cycle on ``stream`` and returns the cudaError_t of the
// launch (0 = success).  ``magic``/``shift``: [R, N] scratch for the
// reciprocals of a slice that is not resident.
extern "C" int koord_cycle_launch(
    int P, int N, int R, int Q,
    const int64_t* preq, const int64_t* psreq, const int64_t* pest,
    const int32_t* pqid, const uint8_t* pvalid, const uint8_t* pprod,
    const int64_t* alloc, const int64_t* usage, const int64_t* uprod,
    const uint8_t* flags, const int64_t* qrt, const uint8_t* qlim,
    const int64_t* weights, int64_t fit_wsum, int64_t la_wsum,
    int64_t fit_pw, int64_t la_pw, int most_allocated, int enable_fit,
    int enable_la, const int64_t* xcomb, int32_t* chosen, int64_t* nreq,
    int64_t* nest, int64_t* quse, uint64_t* magic, uint8_t* shift, void* stream) {
  if (P < 0 || N < 1 || R < 1 || R > kMaxResources || Q < 0 || (int64_t)N * R >= INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int uprod_shared = uprod == usage;
  koord::ClusterPlan plan;
  int quota_resident;
  cudaError_t err = plan_for(N, R, Q, uprod_shared, &plan, &quota_resident);
  if (err != cudaSuccess) return (int)err;
  CycleParams c{P, N, R, Q, preq, psreq, pest, pqid, pvalid, pprod, qrt, qlim, weights,
                fit_wsum, la_wsum, fit_pw, la_pw, most_allocated, enable_fit, enable_la,
                xcomb, chosen, quse,
                koord::GlobalState<int64_t>{alloc, usage, uprod, flags, nreq, nest, magic, shift},
                plan.S, plan.resident, uprod_shared, quota_resident,
                quota_resident ? quota_bytes(Q, R) : 0};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      koord::cluster_config(plan.C, kThreads, plan.smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, cycle_kernel, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef KOORD_PHASE_CLOCK
// The instrumented build only: copy rank 0's pod-step cycles (quota and
// Filter/Score, staging, reduction and barrier, merge and Reserve, summed
// over the valid pods since the last call) to ``out`` and reset them.
extern "C" int koord_cycle_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_pod_cycles, sizeof(g_pod_cycles));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_pod_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif
