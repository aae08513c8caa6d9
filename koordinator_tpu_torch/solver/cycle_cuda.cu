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
// Per pod (the full step):
//   * each thread filters and scores its nodes of the slice (one at the
//     headline) out of shared memory, visiting only the pod's active
//     resources (requested, or weighted by Fit or LoadAware: 3 of 13 at
//     the headline); the pod's rows and active list were staged in shared
//     memory (five deep) three steps earlier with its queue slot, so that
//     no thread walks pvalid: at the start of each step warp 0 stages the
//     pod three ahead from registers it loaded a step before, taking the
//     next slot to be valid and walking on where it was not, and the rows'
//     loads land during the scan; the next pod's xcomb value is read while
//     this pod's barrier waits;
//   * each warp reduces its lexicographic (max score, min index), seeded
//     with the lowest owned index at the masked sentinel, and its
//     any-feasible bit by warp reductions and publishes them in a slot of the
//     CTA's shared memory, double-buffered by pod parity, so pod p + 1's
//     publish never overwrites what another CTA may still be reading of
//     pod p;
//   * one cluster barrier (the pod's only barrier); every warp reads the
//     C x 4 slots through DSMEM and merges them (the OR of the any bits;
//     contiguous slices make the lexicographic merge keep the lowest
//     index);
//   * the owner thread of the chosen node commits Reserve to its own
//     shared memory (the same thread scores that node next, so no barrier
//     orders it); rank 0 alone holds the quota rows: its warp 1 checks
//     admission at the start of the pod (the blocked bit rides its slot)
//     and commits quota, and its thread 0 writes chosen[p].
// The run path.  A pod's scores depend on its rows (preq, psreq, pest, the
// prod bit) and on the node state that only Reserve changes, so a pod
// whose rows equal those of the previous valid pod, in a cycle without
// xcomb, scores every node as that pod did except the node that pod
// reserved.  Warp 0 compares each pod's rows with the previous valid pod's
// when it stages them (one vote) and stages the verdict with the rows, so
// every CTA knows it from the same data.  A pod whose next two valid pods
// both join it starts a run (a pair of equal pods takes two full steps,
// which cost less than a run's start and end): its full step also keeps
// every node's masked score where(feasible, score, kMin) as a leaf
// (resident: beside the slice in shared memory) and each group of 32
// leaves' lexicographic (max, min index) and feasible count in a table in
// rank 0's shared memory.  Then
// rank 0's warp 0 alone places the run's pods, with no cluster barrier:
// per pod, quota admission; the root (the table's argmax; -1 when no node
// is feasible); Reserve of the chosen node into its owner's nreq/nest
// through DSMEM; the node rescored over the run's rows with score_node's
// arithmetic, one lane a resource; its leaf, its group's best and the
// feasible count updated (the run's last pod only reserves).  Each lane
// reads back only what it wrote, so the warp needs no synchronisation
// between pods, and the table's argmax over the other groups is taken
// while the node's DSMEM reads are in flight.  The other CTAs wait at one
// cluster barrier for the whole run, which makes the owners' state visible
// to them; the pod after the run takes the full step.  Ties break as the
// full step's merge does, so the placements are the same bit for bit.  The
// kernel counts the run's pods (run_pods).
// A slice that does not fit in shared memory (large N) runs the same code
// over the device-memory state, with the reciprocals in a device table and
// the run path's leaves and groups in a device scratch.
// Built with -DKOORD_PHASE_CLOCK, rank 0's thread 0 sums clock64 cycles of
// each full pod step's parts and of the runs, K1's and K2's apart
// (koord_cycle_phase_cycles, koord_wide_phase_cycles); the main path's
// build carries no timing code.
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
// shared memory, two warp reductions and one cluster barrier a full step;
// one warp's table argmax, DSMEM round trip and rescore of one node a run
// pod.  Bytes and operations are orders of magnitude below it (PERF.md).

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
// the warp of rank 0 that checks and commits a full step's quota (warp 0
// stages the pods)
constexpr int kQuotaWarp = 1;
// the largest cluster plan_cluster picks: the group table's bound
constexpr int kMaxCluster = 16;

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
  int32_t* run_pods;     // [1] out: the pods placed on the run path, or null
  char* run_scratch;     // the run path's leaves and groups when not resident
};

// one CTA's slice result for a pod: bit 0 of flags = a node is feasible,
// bit 1 = rank 0 found the pod blocked by its quota
template <typename T>
struct alignas(16) Partial {
  T best;
  int idx;
  int flags;
};

// One group of 32 consecutive leaves of a slice: its lexicographic (max
// masked score, min index) and its feasible nodes as the run's first pod
// left them.
template <typename T>
struct alignas(16) Group {
  T best;
  int idx;
  int nfeas;
};

// The run path's state: a leaf (the masked score) and a feasibility byte
// per node, leaf[n - first], and the group table, rank-major [C *
// ceil(S / 32)].
template <typename T>
struct RunView {
  T* leaf;
  uint8_t* feas;
  Group<T>* group;
  int first;
};

// Carve the run path's state for ``leaves`` nodes and ``groups`` groups out
// of ``base`` (16-byte aligned) and return the bytes used; with ``base ==
// nullptr`` it only counts.
template <typename T>
__host__ __device__ size_t carve_run(char* base, int leaves, int groups, RunView<T>* r) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off = koord::align16(off + bytes);
    return p;
  };
  T* leaf = (T*)take((size_t)leaves * sizeof(T));
  uint8_t* feas = (uint8_t*)take((size_t)leaves);
  Group<T>* group = (Group<T>*)take((size_t)groups * sizeof(Group<T>));
  if (r != nullptr) *r = RunView<T>{leaf, feas, group, 0};
  return off;
}

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

// lexicographic (max score, min index) over the lanes of a warp, every
// lane ending with it, by warp reductions (int64: the high word, then the
// low word among the lanes that hold the highest)
__device__ __forceinline__ void warp_argmax(int32_t& best, int& idx) {
  const int32_t m = __reduce_max_sync(kFull, best);
  idx = (int)__reduce_min_sync(kFull, best == m ? (unsigned)idx : (unsigned)INT_MAX);
  best = m;
}

__device__ __forceinline__ void warp_argmax(int64_t& best, int& idx) {
  const int hi = (int)(best >> 32);
  const int mhi = __reduce_max_sync(kFull, hi);
  const unsigned mlo = __reduce_max_sync(kFull, hi == mhi ? (unsigned)best : 0u);
  const int64_t m = (int64_t)(((uint64_t)(uint32_t)mhi << 32) | mlo);
  idx = (int)__reduce_min_sync(kFull, best == m ? (unsigned)idx : (unsigned)INT_MAX);
  best = m;
}

// the sum over the lanes of a warp, modulo 2^32 or 2^64
__device__ __forceinline__ uint32_t warp_sum(uint32_t x) { return __reduce_add_sync(kFull, x); }

__device__ __forceinline__ uint64_t warp_sum(uint64_t x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

#ifdef KOORD_PHASE_CLOCK
// cycles of rank 0's thread 0, K1's and K2's apart: per full pod step,
// quota and Filter/Score of the slice, staging the next pod, the warp
// reduction and the cluster barrier, the merge and Reserve; and the runs,
// from the end of their first pod's merge to the next pod's staging
__device__ unsigned long long g_pod_cycles[5];
__device__ unsigned long long g_wide_pod_cycles[5];
#define KOORD_STAMP(var) const long long var = clock64()
#else
#define KOORD_STAMP(var)
#endif

// Pod rows staged in shared memory, five deep, three pods ahead of the one
// being placed: the rows of the i-th valid pod are read until its Reserve,
// which every thread finishes before the barrier of pod i + 1, and are
// overwritten by pod i + 5's, staged after the barrier of pod i + 1.
constexpr int kStages = 5;
template <typename T>
struct PodRows {
  T req[kMaxResources];
  T sreq[kMaxResources];
  T est[kMaxResources];
  // the resources that can change the pod's result: requested, or weighted
  // by Fit or by LoadAware; the others add nothing and are skipped
  uint8_t act[kMaxResources];
  int nact, qid, prod;
  int joins;  // the rows equal the previous valid pod's, with no xcomb
  int idx;    // the pod's queue slot; P past the last valid pod
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

// One pod's rows in warp 0's registers (lane r: resource r), loaded ahead
// of their use: no thread waits on their loads.
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

  // On every lane: these rows equal ``o``'s (one vote, no branch).
  __device__ __forceinline__ bool same(const CycleParams<T>& c, const HeldRows& o,
                                       int lane) const {
    const bool eq = (lane >= c.R) | ((req == o.req) & (sreq == o.sreq) & (est == o.est));
    return __all_sync(kFull, eq & ((lane != 0) | (prod == o.prod)));
  }

  // On every lane: these rows equal the staged rows ``s`` (one vote; every
  // lane reads, lanes past R resource 0, so that no load waits on a branch).
  __device__ __forceinline__ bool same(const CycleParams<T>& c, const PodRows<T>& s,
                                       int lane) const {
    const int r = lane < c.R ? lane : 0;
    const bool eq =
        (lane >= c.R) | ((req == s.req[r]) & (sreq == s.sreq[r]) & (est == s.est[r]));
    return __all_sync(kFull, eq & ((lane != 0) | (prod == s.prod)));
  }

  // These lanes' rows of the staged pod ``s``.
  __device__ __forceinline__ void take(const CycleParams<T>& c, const PodRows<T>& s, int lane) {
    if (lane < c.R) {
      req = s.req[lane];
      sreq = s.sreq[lane];
      est = s.est[lane];
    }
    qid = s.qid;
    prod = s.prod;
  }

  // Stage into ``s`` as queue slot ``idx`` with the pod's active resources
  // and its run verdict ``joins`` (against the previous valid pod);
  // ``has_weight``: this lane's resource has a Fit or a LoadAware weight.
  __device__ __forceinline__ void stage(const CycleParams<T>& c, PodRows<T>& s, int lane,
                                        bool has_weight, bool joins, int idx) const {
    if (lane < c.R) {
      s.req[lane] = req;
      s.sreq[lane] = sreq;
      s.est[lane] = est;
    }
    const bool active = (lane < c.R) & ((req > 0) | has_weight);
    const unsigned ballot = __ballot_sync(kFull, active);
    if (active) s.act[__popc(ballot & ((1u << lane) - 1))] = (uint8_t)lane;
    if (lane == 0) {
      s.nact = __popc(ballot);
      s.qid = qid;
      s.prod = prod;
      s.joins = joins;
      s.idx = idx;
    }
  }
};

// Warp 0: stage the first valid pod at or after ``from`` and the next two
// valid pods in s_pod[slot ...] with their run verdicts (queue slot P past
// the last), and load the rows of the valid pod after them into ``held``
// (its slot ``hc``, its validity ``hv``); the caller synchronises before
// the staged rows are read.
template <typename T>
__device__ __forceinline__ void prime(const CycleParams<T>& c, int from, bool writer, int lane,
                                      PodRows<T>* s_pod, int slot, bool has_weight,
                                      HeldRows<T>& held, int& hc, uint8_t& hv) {
  int at = next_valid(c, from, writer);
  for (int k = 0; k < 3; ++k) {
    const bool live = at < c.P;
    if (live) held.load(c, at, lane);
    const bool joins = k > 0 && live && c.xcomb == nullptr &&
                       held.same(c, s_pod[(slot + k - 1) % kStages], lane);
    held.stage(c, s_pod[(slot + k) % kStages], lane, has_weight, joins, live ? at : c.P);
    at = live ? next_valid(c, at + 1, writer) : c.P;
  }
  hc = at;
  hv = 1;
  if (hc < c.P) held.load(c, hc, lane);
}

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
  using U = typename Value<T>::U;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int C = (int)cl.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = c.N, R = c.R, Q = c.Q;
  const int lo = min(rank * c.S, N);
  const int hi = min(lo + c.S, N);
  const int Gs = (c.S + 31) >> 5;  // groups of 32 leaves in a slice
  extern __shared__ __align__(16) char smem[];
  __shared__ T s_w[2][kMaxResources];
  __shared__ Partial<T> s_part[2][kWarps];  // by pod parity, then warp
  __shared__ PodRows<T> s_pod[kStages];
  __shared__ int s_next;  // rank 0: the first valid pod after a run

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

  // the run path's leaves (this CTA's slice) and rank 0's group table
  RunView<T> rv;
  if (c.resident) {
    carve_run<T>(smem + c.quota_bytes +
                     koord::carve_slice<T>(nullptr, R, c.S, c.uprod_shared != 0, nullptr),
                 c.S, C * Gs, &rv);
    rv.first = lo;
  } else {
    carve_run<T>(c.run_scratch, N, C * Gs, &rv);
  }
  Group<T>* const groups_out = c.resident ? cl.map_shared_rank(rv.group, 0) : rv.group;
  if (rank == 0) {  // a group no slice has stays below every real one
    for (int k = tid; k < C * Gs; k += kThreads) rv.group[k] = Group<T>{kMin, INT_MAX, 0};
  }

  const bool writer = rank == 0 && tid == 0;  // writes chosen[]
  const int n0 = lo + tid;  // this thread's first node
  // warp 0: the rows of the pod to stage next, its queue slot, read ahead
  // on the guess that it is valid, and its validity, checked at its turn
  HeldRows<T> held;
  int hc = c.P;
  uint8_t hv = 1;
  // warp 0, lane r: resource r has a Fit or a LoadAware weight
  const bool has_weight = tid < R && (c.weights[tid] != 0 || c.weights[R + tid] != 0);
  if (warp == 0) prime(c, 0, writer, lane, s_pod, 0, has_weight, held, hc, hv);
  const NodeView<T> v = koord::load_slice<T>(
      c.g, N, R, lo, hi, c.S, c.resident, c.uprod_shared, smem + c.quota_bytes);
  cl.sync();  // every CTA has started before any DSMEM read
  T x_cur = 0;  // xcomb[p, n0], read ahead
  if (c.xcomb != nullptr && s_pod[0].idx < c.P && n0 < hi) {
    x_cur = c.xcomb[(size_t)s_pod[0].idx * N + n0];
  }
  int run_total = 0;  // rank 0's warp 0: the pods placed on the run path

  for (int i = 0;; ++i) {
    KOORD_STAMP(t_0);
    // this pod and the next two valid pods, staged with their slots
    const PodRows<T>& pr = s_pod[i % kStages];
    const PodRows<T>& pr1 = s_pod[(i + 1) % kStages];
    const PodRows<T>& pr2 = s_pod[(i + 2) % kStages];
    const int p = pr.idx;
    const int q = pr1.idx;
    const int q2 = pr2.idx;
    // the next two valid pods join this pod's rows: a run starts after this
    // pod's step, which keeps its leaves (a pair of equal pods takes two
    // full steps, which cost less than a run's start and end)
    const bool run = (q2 < c.P) & (pr1.joins != 0) & (pr2.joins != 0);
    if (p >= c.P) break;

    // warp 0 stages the pod after q2 (q3), with its slot and its run verdict,
    // from the registers loaded a pod step ago (walking to the next valid
    // pod where the guess was invalid), and loads the rows of the slot
    // after it.  At the step's start: the slot held pod i - 2's rows, whose
    // Reserve every thread finished before the last barrier, and the loads
    // land during the scan.
    if (warp == 0) {
      if (hc < c.P && !hv) {
        hc = next_valid(c, hc, writer);
        if (hc < c.P) held.load(c, hc, lane);
      }
      const bool live = hc < c.P;
      const bool joins =
          live && c.xcomb == nullptr && held.same(c, s_pod[(i + 2) % kStages], lane);
      held.stage(c, s_pod[(i + 3) % kStages], lane, has_weight, joins, live ? hc : c.P);
      hc = live ? hc + 1 : c.P;
      if (hc < c.P) {
        held.load(c, hc, lane);
        hv = c.pvalid[hc];
      }
    }
    KOORD_STAMP(t_1);

    // ElasticQuota admission: node-invariant, rank 0's warp 1 only, beside
    // warp 0's staging (it also commits the quota rows of a full step, so it
    // reads its own writes; a run's commits, warp 0's, precede the barrier
    // that ends the run)
    bool blocked = false;
    if (rank == 0 && warp == kQuotaWarp && pr.qid >= 0) {
      const int r = lane < R ? lane : 0;  // every lane reads: no load waits on a branch
      const size_t k = (size_t)pr.qid * R + r;
      blocked = __any_sync(kFull, (lane < R) & (qlim[k] != 0) & (quse[k] + pr.req[r] > qrt[k]));
    }

    // argmax over the slice of where(feasible, score, kMin), first index on
    // ties: start from the lowest owned index at kMin
    T best = kMin;
    int best_idx = n0 < hi ? n0 : INT_MAX;
    int any = 0;
    if (!run) {
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
    } else {
      // the same scan, warp by warp over groups of 32 nodes (each thread
      // visits the nodes of the loop above), keeping every node's masked
      // score as its leaf and each group's best and feasible count in rank
      // 0's table; a run has no xcomb
      for (int base = lo + warp * 32; base < hi; base += kThreads) {
        const int n = base + lane;
        T key = kMin;
        bool ok = false;
        if (n < hi) {
          T total;
          ok = score_node(c, v, pr, n, (T)0, s_w, d, total);
          if (ok) {
            key = total;
            any = 1;
            if (total > best) {
              best = total;
              best_idx = n;
            }
          }
          rv.leaf[n - rv.first] = key;
          rv.feas[n - rv.first] = ok;
        }
        int gi = n < hi ? n : INT_MAX;
        warp_argmax(key, gi);
        const int nf = __popc(__ballot_sync(kFull, ok));
        if (lane == 0) groups_out[rank * Gs + ((base - lo) >> 5)] = Group<T>{key, gi, nf};
      }
    }
    // every thread reads the next pod's extra score
    T x_next = 0;
    if (q < c.P && c.xcomb != nullptr && n0 < hi) x_next = c.xcomb[(size_t)q * N + n0];
    KOORD_STAMP(t_s);

    // each warp publishes its partial; one cluster barrier; then every
    // warp merges the C x kWarps partials, lane l reading l, l + 32, ...
    warp_argmax(best, best_idx);
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
      if (k == kQuotaWarp) mf |= o.flags & 2;  // rank 0's quota warp: the verdict
    }
    warp_argmax(mb, mi);
    const bool feasible = __any_sync(kFull, mf & 1);
    const bool quota_blocked = __shfl_sync(kFull, mf, kQuotaWarp) & 2;  // the lane that read it
    const int chosen = feasible && !quota_blocked ? mi : -1;
    KOORD_STAMP(t_2);

    // Reserve: the owner thread in its CTA's slice (in a run, rank 0's
    // warp 0 below); quota (in a run, warp 0's) and chosen[p] in rank 0
    if (!run && chosen >= lo && chosen < hi && (chosen - lo) % kThreads == tid) {
      for (int r = 0; r < R; ++r) {
        const int k = v.at(r, chosen);
        v.nreq[k] += pr.req[r];
        v.nest[k] += pr.est[r];
      }
    }
    if (rank == 0) {
      if (warp == (run ? 0 : kQuotaWarp) && chosen >= 0 && pr.qid >= 0 && lane < R) {
        quse[(size_t)pr.qid * R + lane] += pr.req[lane];
      }
      if (tid == 0) c.chosen[p] = chosen;
    }
#ifdef KOORD_PHASE_CLOCK
    unsigned long long* sums = std::is_same<T, int64_t>::value ? g_pod_cycles : g_wide_pod_cycles;
    if (rank == 0 && tid == 0) {
      const long long t_3 = clock64();
      sums[0] += t_s - t_1;
      sums[1] += t_1 - t_0;
      sums[2] += t_2 - t_s;
      sums[3] += t_3 - t_2;
    }
#endif
    x_cur = x_next;
    if (!run) continue;

    // The run: pods q, q2 and the valid pods after them whose rows equal
    // this pod's, placed by rank 0's warp 0 on the tournament while every
    // other warp waits at the cluster barrier below.
    KOORD_STAMP(t_r);
    if (rank == 0 && warp == 0) {
      int cnt = 0;  // feasible nodes for the run's rows
      for (int k = lane; k < C * Gs; k += 32) cnt += rv.group[k].nfeas;
      cnt = __reduce_add_sync(kFull, cnt);
      // the run's rows and weights in registers (lane r: resource r)
      HeldRows<T> key;
      T wf = 0, wl = 0;
      if (lane < R) {
        key.req = pr.req[lane];
        key.sreq = pr.sreq[lane];
        key.est = pr.est[lane];
        wf = s_w[0][lane];
        wl = s_w[1][lane];
      }
      key.prod = pr.prod;
      uint32_t s_m;  // cn / S by its reciprocal
      uint8_t s_l;
      koord::recip_u32((uint32_t)c.S, s_m, s_l);

      int cn = chosen;  // the node of the pod just placed, reserved at the loop's top
      bool more = true;  // pod q joins the run
      int j = q;         // the run's next pod to place
      int jqid = s_pod[(i + 1) % kStages].qid;  // staged by this warp
      HeldRows<T> a, b;  // the rows of the two valid pods after j, staged by this warp
      const int q3 = s_pod[(i + 3) % kStages].idx;  // staged this step
      a.take(c, s_pod[(i + 2) % kStages], lane);
      if (q3 < c.P) b.take(c, s_pod[(i + 3) % kStages], lane);
      int ja = q2, jb = q3;
      uint8_t b_valid = 1;    // pvalid[jb], tested at jb's turn
      // Each lane reads back only what it wrote itself (its resource's
      // nreq, nest and quota cell, its leaf of a group, its entries of the
      // table), so the warp needs no synchronisation between pods.
      for (;;) {
        if (cn >= 0 && !more) {  // the run's last pod: its Reserve alone
          const int oc = (int)koord::div_u32((uint32_t)cn, s_m, s_l);
          const NodeView<T> o = koord::remote_view(v, cl, oc, c.S);
          if (lane < R) {
            const int k = o.at(lane, cn);
            o.nreq[k] += key.req;
            o.nest[k] += key.est;
          }
          break;
        }
        // Reserve cn in its owner's state and rescore it for the run's
        // rows, one lane a resource, with score_node's arithmetic; then its
        // leaf, its group's best and the feasible count.  Every operand is
        // read before any write (one DSMEM round trip), and pod j's root
        // over the other groups is taken while those reads are in flight.
        int oc = 0, olo = 0, ohi = 0, gbase = 0, g = -1, k = 0, first = rv.first;
        NodeView<T> o = v;
        T* leaf = rv.leaf;
        uint8_t* feas = rv.feas;
        T lv = kMin, nr = 0, ne = 0, cap = 0, use = 0;
        int lf = 0;
        typename koord::Recip<T>::M m = 0;
        uint8_t l = 0;
        unsigned char f = 0;
        if (cn >= 0) {
          oc = (int)koord::div_u32((uint32_t)cn, s_m, s_l);  // the owner
          olo = oc * c.S;
          ohi = min(olo + c.S, N);
          o = koord::remote_view(v, cl, oc, c.S);
          if (c.resident) {
            leaf = cl.map_shared_rank(rv.leaf, oc);
            feas = cl.map_shared_rank(rv.feas, oc);
            first = olo;
          }
          gbase = olo + ((cn - olo) & ~31);
          g = oc * Gs + ((cn - olo) >> 5);
          if (gbase + lane < ohi) {
            lv = leaf[gbase + lane - first];
            lf = feas[gbase + lane - first];
          }
          if (lane < R) {
            k = o.at(lane, cn);
            nr = o.nreq[k];
            ne = o.nest[k];
            cap = o.alloc[k];
            use = (key.prod ? o.uprod : o.usage)[k];
            m = o.magic[k];
            l = o.shift[k];
          }
          f = o.flag(cn);
        }
        // pod j's quota admission and its root over every group but g
        bool jblocked = false;
        T rb = kMin;
        int ri = INT_MAX;
        if (more) {
          if (jqid >= 0) {
            const size_t qk = (size_t)jqid * R + (lane < R ? lane : 0);
            jblocked = __any_sync(kFull, (lane < R) & (qlim[qk] != 0) & (quse[qk] + key.req > qrt[qk]));
          }
#pragma unroll 4
          for (int e = lane; e < C * Gs; e += 32) {
            const Group<T> ge = rv.group[e];
            if (e != g) koord::take_better(rb, ri, ge.best, ge.idx);
          }
        }
        if (cn >= 0) {
          bool fits = true;
          U fit = 0, la = 0;
          if (lane < R) {
            nr += key.req;
            ne += key.est;
            o.nreq[k] = nr;
            o.nest[k] = ne;
            fits = !(key.req > 0 && nr + key.req > cap);
            if (wf != 0) {
              const T t = nr + key.sreq;
              fit = (U)((c.most_allocated ? most_requested(t, cap, m, l)
                                          : least_requested(t, cap, m, l)) * wf);
            }
            if (wl != 0) la = (U)(least_requested((T)(use + ne + key.est), cap, m, l) * wl);
          }
          fits = __all_sync(kFull, fits);
          fit = warp_sum(fit);
          la = warp_sum(la);
          const bool ok = fits && (f & (key.prod ? koord::kFlagProdOk : koord::kFlagOk));
          T total = 0;
          if (c.enable_fit) total += c.fit_pw * weighted((T)fit, c.fit_wsum, d.fit_m, d.fit_l);
          if (c.enable_la && (f & koord::kFlagFresh)) {
            total += c.la_pw * weighted((T)la, c.la_wsum, d.la_m, d.la_l);
          }
          const int gl = cn - gbase;
          cnt += (int)ok - __shfl_sync(kFull, lf, gl);
          if (lane == gl) {
            lv = ok ? total : kMin;
            leaf[cn - first] = lv;
            feas[cn - first] = ok;
          }
          int gi = gbase + lane < ohi ? gbase + lane : INT_MAX;
          warp_argmax(lv, gi);
          if (lane == (g & 31)) {  // the lane that reads entry g
            rv.group[g].best = lv;
            rv.group[g].idx = gi;
            koord::take_better(rb, ri, lv, gi);
          }
        }
        if (!more) break;

        // place pod j on the root
        warp_argmax(rb, ri);
        cn = !jblocked && cnt > 0 ? ri : -1;
        if (cn >= 0 && jqid >= 0 && lane < R) quse[(size_t)jqid * R + lane] += key.req;
        if (lane == 0) c.chosen[j] = cn;
        ++run_total;

        // the next valid pod joins the run when its rows are the run's
        more = ja < c.P && a.same(c, key, lane);
        if (!more) continue;  // reserve cn, then leave the run at ja
        j = ja;
        jqid = __shfl_sync(kFull, a.qid, 0);
        a = b;
        ja = jb;
        if (ja < c.P && !b_valid) {  // the pod after j was invalid
          ja = next_valid(c, ja, lane == 0);
          if (ja < c.P) a.load(c, ja, lane);
        }
        // load the pod after ja, taking it to be valid; checked at its turn
        jb = ja < c.P ? ja + 1 : c.P;
        b_valid = 1;
        if (jb < c.P) {
          b.load(c, jb, lane);
          b_valid = c.pvalid[jb];
        }
      }
      if (lane == 0) s_next = ja;
    }
    cl.sync();  // the run's Reserves are visible to their owners
    if (warp == 0) {
      prime(c, *cl.map_shared_rank(&s_next, 0), writer, lane, s_pod, (i + 1) % kStages,
            has_weight, held, hc, hv);
    }
    __syncthreads();  // the staged rows before any warp reads them
#ifdef KOORD_PHASE_CLOCK
    if (rank == 0 && tid == 0) sums[4] += clock64() - t_r;
#endif
  }

  __syncthreads();
  koord::store_slice<T>(c.g, v, N, R, lo, hi);
  if (rank == 0 && c.quota_resident) {
    for (int i = tid; i < Q * R; i += kThreads) c.quse[i] = quse[i];
  }
  if (writer && c.run_pods != nullptr) *c.run_pods = run_total;
  cl.sync();  // no CTA exits while another may read its slots
}

template <typename T>
size_t quota_bytes(int Q, int R) {
  const size_t cells = (size_t)Q * R;
  return koord::align16(cells * sizeof(T)) * 2 + koord::align16(cells);
}

// The launch plan of one kernel for one shape, cached per value type (each
// instantiation has its own cache and its own attributes): the occupancy
// queries cost more than the launch.  A resident slice carries the run
// path's leaves and, bounded for 16 CTAs, the group table.
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
      [&](int S) {
        return koord::carve_slice<T>(nullptr, R, S, uprod_shared != 0, nullptr) +
               carve_run<T>(nullptr, S, kMaxCluster * ((S + 31) / 32), nullptr);
      },
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
           int32_t* run_pods, char* run_scratch, size_t run_scratch_bytes, void* stream) {
  if (P < 0 || N < 1 || R < 1 || R > kMaxResources || Q < 0 || (int64_t)N * R >= INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int uprod_shared = uprod == usage;
  koord::ClusterPlan plan;
  int quota_resident;
  cudaError_t err = plan_for<T>(N, R, Q, uprod_shared, &plan, &quota_resident);
  if (err != cudaSuccess) return (int)err;
  if (!plan.resident &&
      (run_scratch == nullptr ||
       run_scratch_bytes < carve_run<T>(nullptr, N, plan.C * ((plan.S + 31) / 32), nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  CycleParams<T> c{P, N, R, Q, preq, psreq, pest, pqid, pvalid, pprod, qrt, qlim, weights,
                   fit_wsum, la_wsum, fit_pw, la_pw, most_allocated, enable_fit, enable_la,
                   xcomb, chosen, quse,
                   koord::GlobalState<T>{alloc, usage, uprod, flags, nreq, nest, magic, shift},
                   plan.S, plan.resident, uprod_shared, quota_resident,
                   quota_resident ? quota_bytes<T>(Q, R) : 0, run_pods, run_scratch};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      koord::cluster_config(plan.C, kThreads, plan.smem, (cudaStream_t)stream, &attr);
  void (*kernel)(CycleParams<T>) = cycle_kernel<T>;
  err = cudaLaunchKernelEx(&cfg, kernel, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef KOORD_PHASE_CLOCK
// copy five device counters to ``out`` and reset them
int take_counters(const unsigned long long (&sums)[5], unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, sums, sizeof(sums));
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
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
// of a slice that is not resident; ``run_scratch``: ``run_scratch_bytes``
// of device memory for the run path's leaves and groups then (a leaf and
// a byte a node, 16 bytes a group of 32 nodes of a slice).  ``run_pods``:
// [1] out, the pods placed on the run path, or null.
extern "C" int koord_cycle_launch(
    int P, int N, int R, int Q,
    const int64_t* preq, const int64_t* psreq, const int64_t* pest,
    const int32_t* pqid, const uint8_t* pvalid, const uint8_t* pprod,
    const int64_t* alloc, const int64_t* usage, const int64_t* uprod,
    const uint8_t* flags, const int64_t* qrt, const uint8_t* qlim,
    const int64_t* weights, int64_t fit_wsum, int64_t la_wsum,
    int64_t fit_pw, int64_t la_pw, int most_allocated, int enable_fit,
    int enable_la, const int64_t* xcomb, int32_t* chosen, int64_t* nreq,
    int64_t* nest, int64_t* quse, uint64_t* magic, uint8_t* shift, int32_t* run_pods,
    char* run_scratch, size_t run_scratch_bytes, void* stream) {
  return launch<int64_t>(P, N, R, Q, preq, psreq, pest, pqid, pvalid, pprod, alloc, usage, uprod,
                         flags, qrt, qlim, weights, fit_wsum, la_wsum, fit_pw, la_pw,
                         most_allocated, enable_fit, enable_la, xcomb, chosen, nreq, nest, quse,
                         magic, shift, run_pods, run_scratch, run_scratch_bytes, stream);
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
    int32_t* nest, int32_t* quse, uint32_t* magic, uint8_t* shift, int32_t* run_pods,
    char* run_scratch, size_t run_scratch_bytes, void* stream) {
  return launch<int32_t>(P, N, R, Q, preq, psreq, pest, pqid, pvalid, pprod, alloc, usage, uprod,
                         flags, qrt, qlim, weights, fit_wsum, la_wsum, fit_pw, la_pw,
                         most_allocated, enable_fit, enable_la, xcomb, chosen, nreq, nest, quse,
                         magic, shift, run_pods, run_scratch, run_scratch_bytes, stream);
}

#ifdef KOORD_PHASE_CLOCK
// The instrumented build only: copy rank 0's cycles (of the full pod
// steps: quota and Filter/Score, staging, reduction and barrier, merge and
// Reserve; then of the runs) summed since the last call, of K1 or of K2,
// to ``out`` and reset them.
extern "C" int koord_cycle_phase_cycles(unsigned long long* out) {
  return take_counters(g_pod_cycles, out);
}

extern "C" int koord_wide_phase_cycles(unsigned long long* out) {
  return take_counters(g_wide_pod_cycles, out);
}
#endif
