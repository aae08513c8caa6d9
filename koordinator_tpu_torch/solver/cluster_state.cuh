// The thread-block-cluster layer shared by the cycle kernels (cycle_cuda.cu:
// K1 and K2, the per-pod cycle in int64 and in int32; cycle_wide_cuda.cu:
// K3, the wave cycle).  Header only; each source includes it and compiles
// on its own.
//
// One cycle runs as one cluster of C CTAs (C = 16, else 8: see
// plan_cluster).  CTA k owns the contiguous node slice [k*S, min((k+1)*S,
// N)), S = ceil(N / C); a CTA may own no node when N < C.  Contiguous
// slices keep the lowest-index tie-break of a merge in rank order: every
// index of rank k is below every index of rank k + 1.
//
// Resident state.  When the slice fits, the prologue copies its node state
// (alloc, usage, uprod, nreq, nest, flags) into the CTA's shared memory and
// builds one reciprocal per (r, n) for the divisions by cap = alloc[r, n];
// the epilogue writes nreq and nest back.  When it does not fit, the same
// code runs over device-memory pointers: a NodeView is a set of base
// pointers, the index of the first node and the stride between resource
// rows, chosen at launch from N, R and C, and the reciprocals go to a
// device-memory table the wrapper allocates.  Other CTAs reach a node's
// resident state through distributed shared memory (cluster.map_shared_rank).
//
// Division by a divisor known once (Granlund and Montgomery, "Division by
// invariant integers using multiplication", PLDI 1994, figure 4.1).  This
// card has no integer divide instruction: nvcc expands an int32 "/" into a
// sequence of about 20 instructions and an int64 "/" into a longer software
// routine.  For 1 <= d < 2^B, l = ceil(log2 d) and m = floor(2^B (2^l - d) /
// d) + 1 (B bits), every 0 <= n < 2^B gives floor(n / d) = (t + ((n - t) >>
// min(l, 1))) >> max(l - 1, 0), t = mulhi(m, n): one __umulhi (or
// __umul64hi), two shifts, an add and a subtract, exact, no correction.
// The kernels take that form for a non-negative numerator and a positive
// divisor and branch to the plain division for any other operand, so the
// result equals the plain division on every value.  solver/cluster.py holds
// the same algorithm in Python for the CPU tests.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace koord {

namespace cg = cooperative_groups;

constexpr int kMaxResources = 32;
constexpr unsigned kFull = 0xffffffffu;
// The shared memory one block may use on this card (232,448 bytes), its
// static and dynamic shared memory together.
constexpr size_t kSmemLimit = 232448;

// node flag bits (solver/dense.py FLAG_*)
constexpr unsigned char kFlagOk = 1;      // valid & LoadAware default mask
constexpr unsigned char kFlagProdOk = 2;  // valid & LoadAware prod mask
constexpr unsigned char kFlagFresh = 4;   // NodeMetric fresh

// ---------------------------------------------------------------- division

__device__ __forceinline__ void recip_u32(uint32_t d, uint32_t& m, uint8_t& l) {
  const int ll = d > 1 ? 32 - __clz((int)(d - 1)) : 0;
  m = (uint32_t)(((((uint64_t)1 << ll) - d) << 32) / d + 1);
  l = (uint8_t)ll;
}

__device__ __forceinline__ uint32_t div_u32(uint32_t n, uint32_t m, uint8_t l) {
  const uint32_t t = __umulhi(m, n);
  return (t + ((n - t) >> (l > 0 ? 1 : 0))) >> (l > 0 ? l - 1 : 0);
}

// d in [1, 2^63): m = floor(2^64 (2^l - d) / d) + 1 by shift-subtract long
// division (2^l - d < d, so the remainder never reaches 2^63 and r << 1
// cannot overflow).  Built once per (r, n) per cycle.
__device__ __forceinline__ void recip_u64(uint64_t d, uint64_t& m, uint8_t& l) {
  const int ll = d > 1 ? 64 - __clzll((long long)(d - 1)) : 0;
  uint64_t r = ((uint64_t)1 << ll) - d;
  uint64_t q = 0;
  for (int i = 0; i < 64; ++i) {
    r <<= 1;
    q <<= 1;
    if (r >= d) {
      r -= d;
      q |= 1;
    }
  }
  m = q + 1;
  l = (uint8_t)ll;
}

__device__ __forceinline__ uint64_t div_u64(uint64_t n, uint64_t m, uint8_t l) {
  const uint64_t t = __umul64hi(m, n);
  return (t + ((n - t) >> (l > 0 ? 1 : 0))) >> (l > 0 ? l - 1 : 0);
}

// x / d, truncating (the wave kernel's plain "/")
__device__ __forceinline__ int32_t div_i32(int32_t x, int32_t d, uint32_t m, uint8_t l) {
  if (x >= 0 && d > 0) return (int32_t)div_u32((uint32_t)x, m, l);
  return x / d;
}

__device__ __forceinline__ int64_t floordiv_plain(int64_t a, int64_t b) {
  int64_t q = a / b;
  int64_t r = a - q * b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}

// floor(x / d), the per-pod kernels' floordiv in either width (the int32
// operands' plain floor division is taken in int64: INT_MIN / -1 fits)
__device__ __forceinline__ int64_t floordiv(int64_t x, int64_t d, uint64_t m, uint8_t l) {
  if (x >= 0 && d > 0) return (int64_t)div_u64((uint64_t)x, m, l);
  return floordiv_plain(x, d);
}

__device__ __forceinline__ int32_t floordiv(int32_t x, int32_t d, uint32_t m, uint8_t l) {
  if (x >= 0 && d > 0) return (int32_t)div_u32((uint32_t)x, m, l);
  return (int32_t)floordiv_plain(x, d);
}

template <typename T> struct Recip;
template <> struct Recip<int32_t> {
  using M = uint32_t;
  __device__ static void build(int32_t d, M& m, uint8_t& l) {
    if (d > 0) {
      recip_u32((uint32_t)d, m, l);
    } else {
      m = 0;
      l = 0;
    }
  }
};
template <> struct Recip<int64_t> {
  using M = uint64_t;
  __device__ static void build(int64_t d, M& m, uint8_t& l) {
    if (d > 0) {
      recip_u64((uint64_t)d, m, l);
    } else {
      m = 0;
      l = 0;
    }
  }
};

// ------------------------------------------------------------- node state

// A view of node state, resident in shared memory or in device memory:
// element (r, n) sits at ptr[r * stride + n - first].
template <typename T>
struct NodeView {
  using M = typename Recip<T>::M;
  const T* alloc;
  const T* usage;
  const T* uprod;
  T* nreq;
  T* nest;
  const M* magic;
  const uint8_t* shift;
  const uint8_t* flags;  // [stride]: flags[n - first]
  int first;
  int stride;
  bool resident;

  // the launchers keep R * N below 2^31
  __device__ __forceinline__ int at(int r, int n) const { return r * stride + n - first; }
  __device__ __forceinline__ uint8_t flag(int n) const { return flags[n - first]; }
};

// The view of rank ``rank``'s slice as this CTA sees it: the owner's shared
// memory through DSMEM when resident, else the same device memory.
template <typename T>
__device__ __forceinline__ NodeView<T> remote_view(const NodeView<T>& v, cg::cluster_group& cl,
                                                   int rank, int slice) {
  if (!v.resident) return v;
  NodeView<T> o = v;
  o.alloc = cl.map_shared_rank(const_cast<T*>(v.alloc), rank);
  o.usage = cl.map_shared_rank(const_cast<T*>(v.usage), rank);
  o.uprod = cl.map_shared_rank(const_cast<T*>(v.uprod), rank);
  o.nreq = cl.map_shared_rank(v.nreq, rank);
  o.nest = cl.map_shared_rank(v.nest, rank);
  o.magic = cl.map_shared_rank(const_cast<typename NodeView<T>::M*>(v.magic), rank);
  o.shift = cl.map_shared_rank(const_cast<uint8_t*>(v.shift), rank);
  o.flags = cl.map_shared_rank(const_cast<uint8_t*>(v.flags), rank);
  o.first = rank * slice;
  return o;
}

// Global node state of a cycle, [R, N] resource-major.
template <typename T>
struct GlobalState {
  const T* alloc;
  const T* usage;
  const T* uprod;
  const uint8_t* flags;
  T* nreq;  // in/out: holds the state before the cycle on entry
  T* nest;  // in/out
  typename Recip<T>::M* magic;  // [R, N] device table, used when not resident
  uint8_t* shift;                // [R, N]
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Carve a resident slice out of ``base`` (16-byte aligned) and return the
// bytes used.  With ``base == nullptr`` it only counts.
template <typename T>
__host__ __device__ size_t carve_slice(char* base, int R, int S, bool uprod_shared,
                                       NodeView<T>* v) {
  using M = typename Recip<T>::M;
  size_t off = 0;
  const size_t cells = (size_t)R * S;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off = align16(off + bytes);
    return p;
  };
  T* alloc = (T*)take(cells * sizeof(T));
  T* usage = (T*)take(cells * sizeof(T));
  T* uprod = uprod_shared ? usage : (T*)take(cells * sizeof(T));
  T* nreq = (T*)take(cells * sizeof(T));
  T* nest = (T*)take(cells * sizeof(T));
  M* magic = (M*)take(cells * sizeof(M));
  uint8_t* shift = (uint8_t*)take(cells);
  uint8_t* flags = (uint8_t*)take(S);
  if (v != nullptr) {
    *v = NodeView<T>{alloc, usage, uprod, nreq, nest, magic, shift, flags, 0, S, true};
  }
  return off;
}

// The prologue: this CTA's view of its slice [lo, hi).  Resident: copy the
// slice into shared memory and build its reciprocals there.  Otherwise:
// view the device-memory state and build the slice's reciprocals into the
// device table.  Ends with __syncthreads.
template <typename T>
__device__ NodeView<T> load_slice(const GlobalState<T>& g, int N, int R, int lo, int hi,
                                  int S, bool resident, bool uprod_shared, char* smem) {
  NodeView<T> v;
  const int width = hi > lo ? hi - lo : 0;
  if (resident) {
    carve_slice<T>(smem, R, S, uprod_shared, &v);
    v.first = lo;
    for (int i = threadIdx.x; i < R * width; i += blockDim.x) {
      const int r = i / width, j = i - r * width;
      const size_t src = (size_t)r * N + lo + j;
      const int dst = r * S + j;
      const T cap = g.alloc[src];
      const_cast<T*>(v.alloc)[dst] = cap;
      const_cast<T*>(v.usage)[dst] = g.usage[src];
      if (!uprod_shared) const_cast<T*>(v.uprod)[dst] = g.uprod[src];
      v.nreq[dst] = g.nreq[src];
      v.nest[dst] = g.nest[src];
      Recip<T>::build(cap, const_cast<typename NodeView<T>::M*>(v.magic)[dst],
                      const_cast<uint8_t*>(v.shift)[dst]);
    }
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      const_cast<uint8_t*>(v.flags)[j] = g.flags[lo + j];
    }
  } else {
    v = NodeView<T>{g.alloc, g.usage, g.uprod, g.nreq, g.nest, g.magic, g.shift, g.flags,
                    0, N, false};
    for (int i = threadIdx.x; i < R * width; i += blockDim.x) {
      const int r = i / width, j = i - r * width;
      const size_t k = (size_t)r * N + lo + j;
      Recip<T>::build(g.alloc[k], g.magic[k], g.shift[k]);
    }
  }
  __syncthreads();
  return v;
}

// The epilogue: write a resident slice's nreq and nest back.
template <typename T>
__device__ void store_slice(const GlobalState<T>& g, const NodeView<T>& v, int N, int R, int lo,
                            int hi) {
  if (!v.resident) return;
  const int width = hi > lo ? hi - lo : 0;
  for (int i = threadIdx.x; i < R * width; i += blockDim.x) {
    const int r = i / width, j = i - r * width;
    g.nreq[(size_t)r * N + lo + j] = v.nreq[r * v.stride + j];
    g.nest[(size_t)r * N + lo + j] = v.nest[r * v.stride + j];
  }
}

// ------------------------------------------------------------- argmax

// lexicographic (max score, min index)
template <typename T>
__device__ __forceinline__ void take_better(T& best, int& idx, T ob, int oi) {
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

// over the lanes of a warp; every lane ends with the result
template <typename T>
__device__ __forceinline__ void warp_best(T& best, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    take_better(best, idx, (T)__shfl_xor_sync(kFull, best, off), __shfl_xor_sync(kFull, idx, off));
  }
}

// ------------------------------------------------------------- launch

struct ClusterPlan {
  int C;           // CTAs in the cluster
  int S;           // nodes per slice, ceil(N / C)
  int resident;    // the slice state lives in shared memory
  size_t smem;     // dynamic shared bytes per CTA
  int occupancy8;  // cudaOccupancyMaxActiveClusters at C = 8 (this smem)
  int occupancy16; // ... at C = 16
};

inline cudaLaunchConfig_t cluster_config(int C, int threads, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Choose C and the slice placement.  ``fixed``: shared bytes every CTA
// needs besides the slice (16-byte aligned); ``slice_bytes(S)``: those of
// a resident slice of S nodes.  The slice is resident when both fit under
// the card's limit less the kernel's static shared memory.
//
// C = 16 is taken when the card can hold one such cluster (a non-portable
// size: the GPCs of an H100 have 16 or more SMs), else C = 8 (portable).
// Sixteen CTAs halve each CTA's slice against eight, so a pod step scores
// half the cells per SM and a resident slice needs half the shared memory,
// while the cluster barrier and a 16-way merge cost little more than an
// 8-way one (PERF.md gives the measured choice).
template <typename Kernel, typename SliceBytes>
cudaError_t plan_cluster(Kernel kernel, int N, int threads, size_t fixed, SliceBytes slice_bytes,
                         ClusterPlan* plan) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const size_t limit = kSmemLimit - fa.sharedSizeBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)limit);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  int occ[2] = {0, 0};
  ClusterPlan p[2];
  const int sizes[2] = {8, 16};
  for (int i = 0; i < 2; ++i) {
    const int C = sizes[i];
    const int S = (N + C - 1) / C;
    const size_t resident_bytes = fixed + slice_bytes(S);
    p[i].C = C;
    p[i].S = S;
    p[i].resident = resident_bytes <= limit;
    p[i].smem = p[i].resident ? resident_bytes : fixed;
    if (p[i].smem > limit) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(C, threads, p[i].smem, 0, &attr);
    err = cudaOccupancyMaxActiveClusters(&occ[i], kernel, &cfg);
    if (err != cudaSuccess) {
      occ[i] = 0;
      cudaGetLastError();  // a refused size is reported as occupancy 0
    }
  }
  const int pick = occ[1] >= 1 ? 1 : 0;
  if (occ[pick] < 1) return cudaErrorInvalidConfiguration;
  *plan = p[pick];
  plan->occupancy8 = occ[0];
  plan->occupancy16 = occ[1];
  return cudaSuccess;
}

}  // namespace koord
