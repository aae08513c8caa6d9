// The whole priority-ordered Assign cycle in one launch, for Hopper (sm_90a),
// in two value types: K1 (int64) and K2 (int32), one templated kernel.
//
// Replaces the TPU kernels koordinator_tpu/solver/pallas_dense.py
// _cycle_kernel_dense (K1, launched by _run_cycle_dense) and
// koordinator_tpu/solver/pallas_cycle.py _cycle_kernel (K2, launched by
// _run_cycle at wave 0).  Both compute the same function: for each pod in
// queue order, Filter (Fit on the requested resources, the node's
// LoadAware flag, ElasticQuota admission, the extra plugin mask), Score
// (NodeResourcesFit least/most allocated + LoadAware + the extra plugin
// score), argmax with the lowest-index tie-break, then Reserve into node
// requested, node estimated and quota used.  It does not copy the TPU
// kernels' block structure or their lane/sublane layout tricks.
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
//     with the lowest owned index at the masked sentinel, and its
//     any-feasible bit by shuffles and publishes them in a slot of the
//     CTA's shared memory, double-buffered by pod parity, so pod p + 1's
//     publish never overwrites what another CTA may still be reading of
//     pod p;
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
// each pod step's parts, K1's and K2's apart (koord_cycle_phase_cycles,
// koord_wide_phase_cycles); the main path's build carries no timing code.
//
// Arithmetic is exact floor division in the value type, as the plain
// versions (dense.cycle_dense_reference, which wide.cycle_wide_reference
// runs on the widened int32 inputs).  The divisions by cap and by the
// weight sums use the reciprocals of cluster_state.cuh for a non-negative
// numerator and a positive divisor, and the plain floordiv otherwise.
// What differs by type:
//   * K1 (int64): the products (cap - t) * 100 wrap as int64, as the int64
//     PyTorch oracle's do (solver/greedy.py); xcomb is int64 with
//     INT64_MIN as the infeasible sentinel, so it takes extra scores of any
//     int64 magnitude.
//   * K2 (int32): its wrapper takes only snapshots that check_i32_bounds
//     admits (node values below 2^31 / 100) and extra scores below 2^29,
//     so no product or sum wraps and every feasible score is above
//     INT_MIN, the sentinel of its int32 xcomb.
//
// What bounds it on this card: the pods are a sequential chain (each pod
// sees the previous pod's Reserve), so the cycle is bound by the latency
// of one pod step times the number of pods: the slice's Filter/Score out of
// shared memory, two warp reductions and one cluster barrier.  Bytes and
// operations are orders of magnitude below it (PERF.md).

#include "cluster_state.cuh"

#include <mutex>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using koord::NodeView;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxResources = koord::kMaxResources;
constexpr unsigned kFull = koord::kFull;
// quota rows go to rank 0's shared memory up to this size
constexpr size_t kQuotaSmem = 32768;

// The value type's masked sentinel and the unsigned type of its products.
template <typename T> struct Value;
template <> struct Value<int64_t> {
  static constexpr int64_t kMin = LLONG_MIN;
  using U = uint64_t;
};
template <> struct Value<int32_t> {
  static constexpr int32_t kMin = INT_MIN;
  using U = uint32_t;
};

template <typename T>
struct CycleParams {
  int P, N, R, Q;
  const T* preq;         // [P, R] queue order
  const T* psreq;        // [P, R] non-zero score requests
  const T* pest;         // [P, R] LoadAware estimates
  const int32_t* pqid;   // [P] quota id, -1 = none
  const uint8_t* pvalid; // [P]
  const uint8_t* pprod;  // [P] pod takes the prod mask/usage
  const T* qrt;          // [Q, R]
  const uint8_t* qlim;   // [Q, R]
  const T* weights;      // [2, R]: fit, LoadAware
  T fit_wsum, la_wsum, fit_pw, la_pw;
  int most_allocated, enable_fit, enable_la;
  const T* xcomb;        // [P, N] or null; Value<T>::kMin = infeasible
  int32_t* chosen;       // [P] out
  T* quse;               // [Q, R] in/out
  koord::GlobalState<T> g;  // node state; nreq, nest in/out
  int S, resident, uprod_shared, quota_resident;
  size_t quota_bytes;    // rank 0's quota rows at the start of dynamic smem
};

// one CTA's slice result for a pod: bit 0 of flags = a node is feasible,
// bit 1 = rank 0 found the pod blocked by its quota
template <typename T>
struct alignas(16) Partial {
  T best;
  int idx;
  int flags;
};

template <typename T, typename M = typename koord::Recip<T>::M>
__device__ __forceinline__ T least_requested(T t, T cap, M m, uint8_t l) {
  using U = typename Value<T>::U;
  if (cap == 0 || t > cap) return 0;
  return koord::floordiv((T)(((U)cap - (U)t) * 100u), cap, m, l);
}

template <typename T, typename M = typename koord::Recip<T>::M>
__device__ __forceinline__ T most_requested(T t, T cap, M m, uint8_t l) {
  using U = typename Value<T>::U;
  if (cap == 0) return 0;
  return koord::floordiv((T)((U)(t < cap ? t : cap) * 100u), cap, m, l);
}

template <typename T, typename M = typename koord::Recip<T>::M>
__device__ __forceinline__ T weighted(T total, T wsum, M m, uint8_t l) {
  return wsum == 0 ? 0 : koord::floordiv(total, wsum > 1 ? wsum : (T)1, m, l);
}

#ifdef KOORD_PHASE_CLOCK
// cycles of rank 0's thread 0 per pod step, K1's and K2's apart: quota and
// Filter/Score of the slice, staging the next pod, the warp reduction and
// the cluster barrier, the merge and Reserve
__device__ unsigned long long g_pod_cycles[4];
__device__ unsigned long long g_wide_pod_cycles[4];
#define KOORD_STAMP(var) const long long var = clock64()
#else
#define KOORD_STAMP(var)
#endif

// Pod rows staged in shared memory, three deep: the rows of the i-th
// valid pod are read until its Reserve, which every thread finishes before
// the barrier of pod i + 1, and are overwritten by pod i + 3's after it.
constexpr int kStages = 3;
template <typename T>
struct PodRows {
  T req[kMaxResources];
  T sreq[kMaxResources];
  T est[kMaxResources];
  // the resources that can change the pod's result: requested, or weighted
  // by Fit or by LoadAware; the others add nothing and are skipped
  uint8_t act[kMaxResources];
  int nact, qid, prod;
};

template <typename T>
struct Divs {  // reciprocals of the weight sums
  typename koord::Recip<T>::M fit_m, la_m;
  uint8_t fit_l, la_l;
};

// The first valid pod at or after p (P when none); ``writer`` writes -1
// for the invalid pods it passes.
template <typename T>
__device__ __forceinline__ int next_valid(const CycleParams<T>& c, int p, bool writer) {
  while (p < c.P && !c.pvalid[p]) {
    if (writer) c.chosen[p] = -1;
    ++p;
  }
  return p;
}

// One pod's rows in warp 0's registers (lane r: resource r), loaded a pod
// step before they are staged: no thread waits on their loads.
template <typename T>
struct HeldRows {
  T req = 0, sreq = 0, est = 0;
  int qid = -1, prod = 0;

  __device__ __forceinline__ void load(const CycleParams<T>& c, int p, int lane) {
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
  __device__ __forceinline__ void stage(const CycleParams<T>& c, PodRows<T>& s, int lane,
                                        const T (*s_w)[kMaxResources]) const {
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
template <typename T>
__device__ __forceinline__ bool score_node(const CycleParams<T>& c, const NodeView<T>& v,
                                           const PodRows<T>& pr, int n, T x,
                                           const T (*s_w)[kMaxResources], const Divs<T>& d,
                                           T& total) {
  const unsigned char f = v.flag(n);
  if (!(f & (pr.prod ? koord::kFlagProdOk : koord::kFlagOk))) return false;
  const T* usage = pr.prod ? v.uprod : v.usage;
  T fit = 0, la = 0;
  bool fits = true;
  // unrolled without an early exit, so that the loads of several
  // resources issue together and their arithmetic interleaves
#pragma unroll 4
  for (int k = 0; k < pr.nact; ++k) {
    const int r = pr.act[k];
    const int i = v.at(r, n);
    const T cap = v.alloc[i];
    const T nr = v.nreq[i];
    const auto m = v.magic[i];
    const uint8_t l = v.shift[i];
    const T rq = pr.req[r];
    fits = fits & !(rq > 0 && nr + rq > cap);
    const T wf = s_w[0][r];
    const T wl = s_w[1][r];
    if (wf != 0) {
      const T t = nr + pr.sreq[r];
      fit += (c.most_allocated ? most_requested(t, cap, m, l) : least_requested(t, cap, m, l)) * wf;
    }
    if (wl != 0) la += least_requested((T)(usage[i] + v.nest[i] + pr.est[r]), cap, m, l) * wl;
  }
  if (!fits) return false;
  total = 0;
  if (c.xcomb != nullptr) {
    if (x == Value<T>::kMin) return false;
    total = x;
  }
  if (c.enable_fit) total += c.fit_pw * weighted(fit, c.fit_wsum, d.fit_m, d.fit_l);
  if (c.enable_la && (f & koord::kFlagFresh)) {
    total += c.la_pw * weighted(la, c.la_wsum, d.la_m, d.la_l);
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) cycle_kernel(CycleParams<T> c) {
  constexpr T kMin = Value<T>::kMin;
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
  __shared__ T s_w[2][kMaxResources];
  __shared__ Partial<T> s_part[2][kWarps];  // by pod parity, then warp
  __shared__ PodRows<T> s_pod[kStages];

  if (tid < kMaxResources) {
    s_w[0][tid] = tid < R ? c.weights[tid] : 0;
    s_w[1][tid] = tid < R ? c.weights[R + tid] : 0;
  }
  Divs<T> d;  // once per cycle
  koord::Recip<T>::build(c.fit_wsum > 1 ? c.fit_wsum : 1, d.fit_m, d.fit_l);
  koord::Recip<T>::build(c.la_wsum > 1 ? c.la_wsum : 1, d.la_m, d.la_l);

  T* quse = c.quse;
  const T* qrt = c.qrt;
  const uint8_t* qlim = c.qlim;
  if (c.quota_resident) {
    T* s_quse = reinterpret_cast<T*>(smem);
    T* s_qrt = s_quse + Q * R;
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
  T x_cur = 0;        // xcomb[p, n0], read ahead
  HeldRows<T> held;   // warp 0: the rows of pod q
  if (p < c.P) {
    if (warp == 0) {
      held.load(c, p, lane);
      held.stage(c, s_pod[0], lane, s_w);
      if (q < c.P) held.load(c, q, lane);
    }
    if (c.xcomb != nullptr && n0 < hi) x_cur = c.xcomb[(size_t)p * N + n0];
  }
  const NodeView<T> v = koord::load_slice<T>(
      c.g, N, R, lo, hi, c.S, c.resident, c.uprod_shared, smem + c.quota_bytes);
  cl.sync();  // every CTA has started before any DSMEM read

  for (int i = 0; p < c.P; ++i) {
    KOORD_STAMP(t_0);
    const PodRows<T>& pr = s_pod[i % kStages];
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

    // argmax over the slice of where(feasible, score, kMin), first index on
    // ties: start from the lowest owned index at kMin
    T best = kMin;
    int best_idx = n0 < hi ? n0 : INT_MAX;
    int any = 0;
    for (int n = n0; n < hi; n += kThreads) {
      const T x = c.xcomb == nullptr ? 0
                  : n == n0 ? x_cur : c.xcomb[(size_t)p * N + n];
      T total;
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
    T x_next = 0;
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
    if (lane == 0) s_part[i & 1][warp] = Partial<T>{best, best_idx, any | (blocked ? 2 : 0)};
    cl.sync();
    T mb = kMin;
    int mi = INT_MAX;
    int mf = 0;
    for (int k = lane; k < C * kWarps; k += 32) {
      const Partial<T> o = *cl.map_shared_rank(&s_part[i & 1][k % kWarps], k / kWarps);
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
      unsigned long long* sums = std::is_same<T, int64_t>::value ? g_pod_cycles : g_wide_pod_cycles;
      sums[0] += t_s - t_0;
      sums[1] += t_1 - t_s;
      sums[2] += t_2 - t_1;
      sums[3] += t_3 - t_2;
    }
#endif
    x_cur = x_next;
    p = q;
    q = q2;
  }

  __syncthreads();
  koord::store_slice<T>(c.g, v, N, R, lo, hi);
  if (rank == 0 && c.quota_resident) {
    for (int i = tid; i < Q * R; i += kThreads) c.quse[i] = quse[i];
  }
  cl.sync();  // no CTA exits while another may read its slots
}

template <typename T>
size_t quota_bytes(int Q, int R) {
  const size_t cells = (size_t)Q * R;
  return koord::align16(cells * sizeof(T)) * 2 + koord::align16(cells);
}

// The launch plan of one kernel for one shape, cached per value type (each
// instantiation has its own cache and its own attributes): the occupancy
// queries cost more than the launch.
template <typename T>
cudaError_t plan_for(int N, int R, int Q, int uprod_shared, koord::ClusterPlan* plan,
                     int* quota_resident) {
  static std::mutex mu;
  static int key[4] = {-1, -1, -1, -1};
  static koord::ClusterPlan cached;
  std::lock_guard<std::mutex> lock(mu);
  const size_t qb = quota_bytes<T>(Q, R);
  *quota_resident = qb <= kQuotaSmem;
  if (key[0] == N && key[1] == R && key[2] == Q && key[3] == uprod_shared) {
    *plan = cached;
    return cudaSuccess;
  }
  void (*kernel)(CycleParams<T>) = cycle_kernel<T>;
  const cudaError_t err = koord::plan_cluster(
      kernel, N, kThreads, *quota_resident ? qb : 0,
      [&](int S) { return koord::carve_slice<T>(nullptr, R, S, uprod_shared != 0, nullptr); },
      plan);
  if (err != cudaSuccess) return err;
  cached = *plan;
  key[0] = N;
  key[1] = R;
  key[2] = Q;
  key[3] = uprod_shared;
  return cudaSuccess;
}

template <typename T>
int write_plan(int N, int R, int Q, int uprod_shared, int* out) {
  koord::ClusterPlan plan;
  int quota_resident;
  const cudaError_t err = plan_for<T>(N, R, Q, uprod_shared, &plan, &quota_resident);
  if (err != cudaSuccess) return (int)err;
  out[0] = plan.C;
  out[1] = plan.S;
  out[2] = plan.resident;
  out[3] = (int)plan.smem;
  out[4] = plan.occupancy8;
  out[5] = plan.occupancy16;
  return 0;
}

template <typename T>
int launch(int P, int N, int R, int Q, const T* preq, const T* psreq, const T* pest,
           const int32_t* pqid, const uint8_t* pvalid, const uint8_t* pprod, const T* alloc,
           const T* usage, const T* uprod, const uint8_t* flags, const T* qrt,
           const uint8_t* qlim, const T* weights, T fit_wsum, T la_wsum, T fit_pw, T la_pw,
           int most_allocated, int enable_fit, int enable_la, const T* xcomb, int32_t* chosen,
           T* nreq, T* nest, T* quse, typename koord::Recip<T>::M* magic, uint8_t* shift,
           void* stream) {
  if (P < 0 || N < 1 || R < 1 || R > kMaxResources || Q < 0 || (int64_t)N * R >= INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int uprod_shared = uprod == usage;
  koord::ClusterPlan plan;
  int quota_resident;
  cudaError_t err = plan_for<T>(N, R, Q, uprod_shared, &plan, &quota_resident);
  if (err != cudaSuccess) return (int)err;
  CycleParams<T> c{P, N, R, Q, preq, psreq, pest, pqid, pvalid, pprod, qrt, qlim, weights,
                   fit_wsum, la_wsum, fit_pw, la_pw, most_allocated, enable_fit, enable_la,
                   xcomb, chosen, quse,
                   koord::GlobalState<T>{alloc, usage, uprod, flags, nreq, nest, magic, shift},
                   plan.S, plan.resident, uprod_shared, quota_resident,
                   quota_resident ? quota_bytes<T>(Q, R) : 0};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      koord::cluster_config(plan.C, kThreads, plan.smem, (cudaStream_t)stream, &attr);
  void (*kernel)(CycleParams<T>) = cycle_kernel<T>;
  err = cudaLaunchKernelEx(&cfg, kernel, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef KOORD_PHASE_CLOCK
// copy four device counters to ``out`` and reset them
int take_counters(const unsigned long long (&sums)[4], unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, sums, sizeof(sums));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(sums, zero, sizeof(zero));
  return (int)err;
}
#endif

}  // namespace

// Plain C entry points, bound with ctypes (K1: solver/dense.py; K2:
// solver/wide.py).

// The cluster plan of a cycle of this shape: out[0..5] = C, S, resident,
// dynamic shared bytes per CTA, cudaOccupancyMaxActiveClusters at C = 8
// and at C = 16.  Returns the cudaError_t (0 = success).
extern "C" int koord_cycle_plan(int N, int R, int Q, int uprod_shared, int* out) {
  return write_plan<int64_t>(N, R, Q, uprod_shared, out);
}

extern "C" int koord_wide_plan(int N, int R, int Q, int uprod_shared, int* out) {
  return write_plan<int32_t>(N, R, Q, uprod_shared, out);
}

// Launch the cycle on ``stream`` and return the cudaError_t of the launch
// (0 = success).  ``magic``/``shift``: [R, N] scratch for the reciprocals
// of a slice that is not resident.
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
  return launch<int64_t>(P, N, R, Q, preq, psreq, pest, pqid, pvalid, pprod, alloc, usage, uprod,
                         flags, qrt, qlim, weights, fit_wsum, la_wsum, fit_pw, la_pw,
                         most_allocated, enable_fit, enable_la, xcomb, chosen, nreq, nest, quse,
                         magic, shift, stream);
}

extern "C" int koord_wide_cycle_launch(
    int P, int N, int R, int Q,
    const int32_t* preq, const int32_t* psreq, const int32_t* pest,
    const int32_t* pqid, const uint8_t* pvalid, const uint8_t* pprod,
    const int32_t* alloc, const int32_t* usage, const int32_t* uprod,
    const uint8_t* flags, const int32_t* qrt, const uint8_t* qlim,
    const int32_t* weights, int32_t fit_wsum, int32_t la_wsum,
    int32_t fit_pw, int32_t la_pw, int most_allocated, int enable_fit,
    int enable_la, const int32_t* xcomb, int32_t* chosen, int32_t* nreq,
    int32_t* nest, int32_t* quse, uint32_t* magic, uint8_t* shift, void* stream) {
  return launch<int32_t>(P, N, R, Q, preq, psreq, pest, pqid, pvalid, pprod, alloc, usage, uprod,
                         flags, qrt, qlim, weights, fit_wsum, la_wsum, fit_pw, la_pw,
                         most_allocated, enable_fit, enable_la, xcomb, chosen, nreq, nest, quse,
                         magic, shift, stream);
}

#ifdef KOORD_PHASE_CLOCK
// The instrumented build only: copy rank 0's pod-step cycles (quota and
// Filter/Score, staging, reduction and barrier, merge and Reserve, summed
// over the valid pods since the last call) of K1 or of K2 to ``out`` and
// reset them.
extern "C" int koord_cycle_phase_cycles(unsigned long long* out) {
  return take_counters(g_pod_cycles, out);
}

extern "C" int koord_wide_phase_cycles(unsigned long long* out) {
  return take_counters(g_wide_pod_cycles, out);
}
#endif
