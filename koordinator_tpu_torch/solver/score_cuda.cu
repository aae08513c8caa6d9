// The Score program's cellwise Filter+Score for Hopper (sm_90a): the dense
// form of score_all, one launch per cell set.
//
// Replaces no TPU kernel: the reference's score_all
// (koordinator_tpu/solver/greedy.py) is XLA ops.  It was added because the
// port's eager form of it (solver/greedy.py _score_block, chunked over pod
// rows) writes about 25 [rows, N, R] int64 temporaries through device
// memory for every [rows, N] block it scores, R = 13 resources a cell: at
// the servicer's padded 16,384 x 8,192 grid one such temporary is 14 GB,
// and a full Score or an incremental rescore took about 95-98 ms of the card
// a Score, where the result is 9 bytes a cell.
//
// Function.  For every cell (p, n) of a cell set (every pod row against
// every node row; the node rows node_idx[0 .. Nc) against every pod row;
// or the pod rows pod_idx[0 .. Pc) against every node row) it writes into
// the caller's [P, N] row-major outputs, at (p, n):
//   feasible = pod_ok[p] && (prod[p] ? ok_prod[n] : ok_default[n])
//              && for every resource r with req[p][r] > 0:
//                   requested[n][r] + req[p][r] <= alloc[n][r]
//   score    = fit_plugin * (sum_k fit_w[k] * fit(requested[n][r_k] +
//                 sreq[p][r_k], alloc[n][r_k])) // fit_div
//            + la_plugin * (fresh[n] ? (sum_k la_w[k] * least(use[n][r_k] +
//                 est[p][r_k], alloc[n][r_k])) // la_div : 0)
// with fit = least or most allocated, use = the prod usage for prod pods,
// least(t, c) = c == 0 || t > c ? 0 : ((c - t) * 100) // c and
// most(t, c) = c == 0 ? 0 : (min(t, c) * 100) // c.  Every operation is
// the eager code's: int64 with two's-complement wrap, // floor division as
// torch computes it, the resources of weight 0 left out of the sums (they
// add 0) but never out of the fit mask.  The wrapper (solver/score_kernel.py)
// folds the node masks (valid & the LoadAware filters), the pod validity,
// the non-zero requests and the weight sums into these operands; scores is
// null for the mask-only variant, which writes feasible alone.
//
// What bounds it on this card: the bytes it writes, 9 a cell (1.21 GB at
// 16,384 x 8,192, 0.36 ms at 3.35 TB/s), and the integer divisions, one
// per weighted resource and one per plugin a cell (6 under the default
// weights).  A division whose operands are non-negative and below 2^32, as
// every score's are at real capacities, takes the 32-bit unsigned path,
// exact for them and about a third of the emulated 64-bit one; any other
// value takes the 64-bit floor division, tested per value.
//
// Design.  A block stages a tile of kTile node rows in shared memory, each
// resource as its own array (alloc and requested for every resource, the
// score usages for the LoadAware resources, the three node flags), gathered
// through node_idx where given, so that the cells' reads are conflict-free
// and the tile is read from device memory once for many pod rows.  It then
// walks rows_per_block pod positions, kRowsAtOnce of them side by side; a
// pod row's requests are the same for every thread on it (broadcast loads,
// uniform branches).  A thread takes kCells consecutive node positions of
// one pod row, so its scores go out as one 16-byte store and its flags as
// one 2-byte store where the columns are dense, each warp's stores
// contiguous.  Cells are computed in registers; nothing but the outputs is
// written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsPerRow = 128;
constexpr int kRowsAtOnce = 2;
constexpr int kThreads = kThreadsPerRow * kRowsAtOnce;
constexpr int kCells = 2;
constexpr int kTile = kThreadsPerRow * kCells;
constexpr int kMaxR = 16;
constexpr int kMaxRowsPerBlock = 64;
// blocks an SM holds: the shared tile of 13 resources is 62 KB of its
// 228 KB, so three, which leaves a thread 85 registers
constexpr int kMinBlocks = 3;
constexpr long long kMaxNodeScore = 100;
static_assert(kCells == 2, "the vector stores below write two cells");

struct Params {
  int R;
  int n_fit;  // fit resources with a non-zero weight; 0: the plugin adds 0
  int n_la;   // LoadAware resources with a non-zero weight; 0: adds 0
  int most;   // the fit strategy is MostAllocated
  long long fit_div;  // max(sum of the weights, 1)
  long long la_div;
  long long fit_plugin;
  long long la_plugin;
  int fit_res[kMaxR];
  int la_res[kMaxR];
  long long fit_w[kMaxR];
  long long la_w[kMaxR];
};

__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

__device__ __forceinline__ long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

// a // b (b != 0) as torch's int64 floor division computes it
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  if ((unsigned long long)a <= 0xffffffffull && (unsigned long long)b - 1ull < 0xffffffffull)
    return (long long)((unsigned)a / (unsigned)b);
  const long long q = a / b;
  if ((a < 0) != (b < 0)) return (a % b) != 0 ? q - 1 : q;
  return q;
}

// ops/scoring.py least_requested_score
__device__ __forceinline__ long long least_score(long long t, long long cap) {
  if (cap == 0 || t > cap) return 0;
  return floordiv(wmul(wsub(cap, t), kMaxNodeScore), cap);
}

// ops/scoring.py most_requested_score
__device__ __forceinline__ long long most_score(long long t, long long cap) {
  if (cap == 0) return 0;
  return floordiv(wmul(t < cap ? t : cap, kMaxNodeScore), cap);
}

template <bool kScores, bool kDenseCols>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
score_cells_kernel(const Params prm, const int Pc, const int Nc, const int rows_per_block,
                   const long long* __restrict__ pod_idx, const long long* __restrict__ node_idx,
                   const long long* __restrict__ req, const long long* __restrict__ sreq,
                   const long long* __restrict__ est, const uint8_t* __restrict__ pod_ok,
                   const uint8_t* __restrict__ pod_prod, const long long* __restrict__ alloc,
                   const long long* __restrict__ requested, const long long* __restrict__ usage,
                   const long long* __restrict__ usage_prod, const uint8_t* __restrict__ fresh,
                   const uint8_t* __restrict__ ok_default, const uint8_t* __restrict__ ok_prod,
                   const long long ld, long long* __restrict__ scores,
                   uint8_t* __restrict__ feasible, const int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = prm.R;
  const int n_la = kScores ? prm.n_la : 0;
  long long* s_alloc = reinterpret_cast<long long*>(smem);  // [R][kTile]
  long long* s_req = s_alloc + R * kTile;                   // [R][kTile]
  long long* s_use = s_req + R * kTile;                     // [n_la][kTile]
  long long* s_use_prod = s_use + n_la * kTile;             // [n_la][kTile]
  uint8_t* s_ok_default = reinterpret_cast<uint8_t*>(s_use_prod + n_la * kTile);
  uint8_t* s_ok_prod = s_ok_default + kTile;
  uint8_t* s_fresh = s_ok_prod + kTile;

  const int j0 = blockIdx.x * kTile;
  const int nt = min(kTile, Nc - j0);
  for (int e = threadIdx.x; e < nt * R; e += kThreads) {
    const int j = e / R;
    const int r = e - j * R;
    const long long n = kDenseCols ? (long long)(j0 + j) : node_idx[j0 + j];
    s_alloc[r * kTile + j] = alloc[n * R + r];
    s_req[r * kTile + j] = requested[n * R + r];
  }
  if (kScores) {
#pragma unroll
    for (int k = 0; k < kMaxR; ++k) {
      if (k >= n_la) break;
      const int r = prm.la_res[k];
      for (int j = threadIdx.x; j < nt; j += kThreads) {
        const long long n = kDenseCols ? (long long)(j0 + j) : node_idx[j0 + j];
        s_use[k * kTile + j] = usage[n * R + r];
        s_use_prod[k * kTile + j] = usage_prod[n * R + r];
      }
    }
  }
  for (int j = threadIdx.x; j < nt; j += kThreads) {
    const long long n = kDenseCols ? (long long)(j0 + j) : node_idx[j0 + j];
    s_ok_default[j] = ok_default[n];
    s_ok_prod[j] = ok_prod[n];
    s_fresh[j] = fresh[n];
  }
  __syncthreads();

  const int side = threadIdx.x / kThreadsPerRow;
  const int jb = (threadIdx.x - side * kThreadsPerRow) * kCells;
  bool live[kCells];
  long long col[kCells];
  bool okd[kCells], okp[kCells], fr[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    live[c] = jb + c < nt;
    col[c] = !live[c] ? 0 : kDenseCols ? (long long)(j0 + jb + c) : node_idx[j0 + jb + c];
    okd[c] = live[c] && s_ok_default[jb + c];
    okp[c] = live[c] && s_ok_prod[jb + c];
    fr[c] = live[c] && s_fresh[jb + c];
  }
  if (!live[0]) return;  // no cell of this tile for this thread; no barrier follows
  const bool vec = kDenseCols && vec_ok && live[kCells - 1];

  const int i_end = min(Pc, (blockIdx.y + 1) * rows_per_block);
  for (int i = blockIdx.y * rows_per_block + side; i < i_end; i += kRowsAtOnce) {
    const long long p = pod_idx != nullptr ? pod_idx[i] : (long long)i;
    const long long* rq = req + p * R;
    bool fit[kCells];
#pragma unroll
    for (int c = 0; c < kCells; ++c) fit[c] = true;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      const long long q = __ldg(rq + r);
      if (q > 0) {
#pragma unroll
        for (int c = 0; c < kCells; ++c)
          fit[c] = fit[c] && wadd(s_req[r * kTile + jb + c], q) <= s_alloc[r * kTile + jb + c];
      }
    }
    const bool pok = __ldg(pod_ok + p) != 0;
    const bool prod = __ldg(pod_prod + p) != 0;
    uint8_t f[kCells];
#pragma unroll
    for (int c = 0; c < kCells; ++c) f[c] = pok && fit[c] && (prod ? okp[c] : okd[c]);

    long long total[kCells];
#pragma unroll
    for (int c = 0; c < kCells; ++c) total[c] = 0;
    if (kScores) {
      if (prm.n_fit > 0) {
        long long acc[kCells];
#pragma unroll
        for (int c = 0; c < kCells; ++c) acc[c] = 0;
        const long long* sq = sreq + p * R;
#pragma unroll
        for (int k = 0; k < kMaxR; ++k) {
          if (k >= prm.n_fit) break;
          const int r = prm.fit_res[k];
          const long long s = __ldg(sq + r);
#pragma unroll
          for (int c = 0; c < kCells; ++c) {
            const long long t = wadd(s_req[r * kTile + jb + c], s);
            const long long cap = s_alloc[r * kTile + jb + c];
            const long long per = prm.most ? most_score(t, cap) : least_score(t, cap);
            acc[c] = wadd(acc[c], wmul(per, prm.fit_w[k]));
          }
        }
#pragma unroll
        for (int c = 0; c < kCells; ++c)
          total[c] = wmul(prm.fit_plugin, floordiv(acc[c], prm.fit_div));
      }
      if (n_la > 0) {
        const long long* su = prod ? s_use_prod : s_use;
        const long long* se = est + p * R;
        long long acc[kCells];
#pragma unroll
        for (int c = 0; c < kCells; ++c) acc[c] = 0;
#pragma unroll
        for (int k = 0; k < kMaxR; ++k) {
          if (k >= n_la) break;
          const int r = prm.la_res[k];
          const long long e = __ldg(se + r);
#pragma unroll
          for (int c = 0; c < kCells; ++c) {
            const long long u = wadd(su[k * kTile + jb + c], e);
            const long long per = least_score(u, s_alloc[r * kTile + jb + c]);
            acc[c] = wadd(acc[c], wmul(per, prm.la_w[k]));
          }
        }
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          const long long la = fr[c] ? floordiv(acc[c], prm.la_div) : 0;
          total[c] = wadd(total[c], wmul(prm.la_plugin, la));
        }
      }
    }

    const long long row = p * ld;
    if (vec) {
      if (kScores)
        *reinterpret_cast<longlong2*>(scores + row + col[0]) = make_longlong2(total[0], total[1]);
      *reinterpret_cast<uchar2*>(feasible + row + col[0]) = make_uchar2(f[0], f[1]);
    } else {
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        if (!live[c]) continue;
        if (kScores) scores[row + col[c]] = total[c];
        feasible[row + col[c]] = f[c];
      }
    }
  }
}

template <bool kScores, bool kDenseCols>
cudaError_t launch(const Params& prm, int Pc, int Nc, const long long* pod_idx,
                   const long long* node_idx, const long long* req, const long long* sreq,
                   const long long* est, const uint8_t* pod_ok, const uint8_t* pod_prod,
                   const long long* alloc, const long long* requested, const long long* usage,
                   const long long* usage_prod, const uint8_t* fresh,
                   const uint8_t* ok_default, const uint8_t* ok_prod, long long ld,
                   long long* scores, uint8_t* feasible, int vec_ok, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (Nc + kTile - 1) / kTile;
  // about eight blocks an SM over the whole cell set, at most
  // kMaxRowsPerBlock pod rows a block, a multiple of kRowsAtOnce, and a
  // grid height the card takes
  const long long target = 8LL * (sms > 0 ? sms : 1);
  long long rows = ((long long)Pc * tiles + target - 1) / target;
  rows = rows < kRowsAtOnce ? kRowsAtOnce : rows > kMaxRowsPerBlock ? kMaxRowsPerBlock : rows;
  if ((Pc + rows - 1) / rows > 65535) rows = (Pc + 65534) / 65535;
  rows = (rows + kRowsAtOnce - 1) / kRowsAtOnce * kRowsAtOnce;
  const int n_la = kScores ? prm.n_la : 0;
  const size_t smem = (size_t)(2 * prm.R + 2 * n_la) * kTile * sizeof(long long) + 3 * kTile;

  void (*kernel)(const Params, int, int, int, const long long*, const long long*,
                 const long long*, const long long*, const long long*, const uint8_t*,
                 const uint8_t*, const long long*, const long long*, const long long*,
                 const long long*, const uint8_t*, const uint8_t*, const uint8_t*, long long,
                 long long*, uint8_t*, int) = score_cells_kernel<kScores, kDenseCols>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, (unsigned)((Pc + rows - 1) / rows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, prm, Pc, Nc, (int)rows, pod_idx, node_idx, req, sreq,
                           est, pod_ok, pod_prod, alloc, requested, usage, usage_prod, fresh,
                           ok_default, ok_prod, ld, scores, feasible, vec_ok);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Launch the Filter+Score of a cell set on ``stream`` and return the
// cudaError_t of the launch (0 = success).
//
// params: 8 + 4 * 16 host int64 values: R, n_fit, n_la, most, fit_div,
// la_div, fit_plugin, la_plugin, then fit_res[16], fit_w[16], la_res[16],
// la_w[16] (the first n_fit and n_la entries read).  Pc pod positions and Nc
// node positions: pod_idx and node_idx (int64, in range) or null for the
// identity.  Pod tables req, sreq, est [*, R] int64 and pod_ok, pod_prod
// [*] bool; node tables alloc, requested, usage, usage_prod [*, R] int64 and
// fresh, ok_default, ok_prod [*] bool; all row-major.  Outputs: scores
// (int64, or null for the mask-only variant) and feasible (bool), [*, ld]
// row-major.  vec_ok: the outputs' rows and bases admit the 16- and 2-byte
// stores.  An empty cell set launches nothing.
extern "C" int koord_score_cells_launch(
    int Pc, int Nc, const long long* params, const long long* pod_idx,
    const long long* node_idx, const long long* req, const long long* sreq,
    const long long* est, const uint8_t* pod_ok, const uint8_t* pod_prod,
    const long long* alloc, const long long* requested, const long long* usage,
    const long long* usage_prod, const uint8_t* fresh, const uint8_t* ok_default,
    const uint8_t* ok_prod, long long ld, long long* scores, uint8_t* feasible, int vec_ok,
    void* stream) {
  Params prm = {};
  prm.R = (int)params[0];
  prm.n_fit = (int)params[1];
  prm.n_la = (int)params[2];
  prm.most = (int)params[3];
  prm.fit_div = params[4];
  prm.la_div = params[5];
  prm.fit_plugin = params[6];
  prm.la_plugin = params[7];
  if (Pc < 0 || Nc < 0 || prm.R < 1 || prm.R > kMaxR || prm.n_fit < 0 || prm.n_fit > prm.R ||
      prm.n_la < 0 || prm.n_la > prm.R || prm.fit_div < 1 || prm.la_div < 1 || ld < Nc ||
      feasible == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kMaxR; ++k) {
    prm.fit_res[k] = (int)params[8 + k];
    prm.fit_w[k] = params[8 + kMaxR + k];
    prm.la_res[k] = (int)params[8 + 2 * kMaxR + k];
    prm.la_w[k] = params[8 + 3 * kMaxR + k];
    if ((k < prm.n_fit && (prm.fit_res[k] < 0 || prm.fit_res[k] >= prm.R)) ||
        (k < prm.n_la && (prm.la_res[k] < 0 || prm.la_res[k] >= prm.R)))
      return (int)cudaErrorInvalidValue;
  }
  if (Pc == 0 || Nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dense = node_idx == nullptr;
  if (scores != nullptr) {
    return dense ? (int)launch<true, true>(prm, Pc, Nc, pod_idx, node_idx, req, sreq, est, pod_ok,
                                           pod_prod, alloc, requested, usage, usage_prod, fresh,
                                           ok_default, ok_prod, ld, scores, feasible, vec_ok, s)
                 : (int)launch<true, false>(prm, Pc, Nc, pod_idx, node_idx, req, sreq, est,
                                            pod_ok, pod_prod, alloc, requested, usage,
                                            usage_prod, fresh, ok_default, ok_prod, ld, scores,
                                            feasible, 0, s);
  }
  return dense ? (int)launch<false, true>(prm, Pc, Nc, pod_idx, node_idx, req, sreq, est, pod_ok,
                                          pod_prod, alloc, requested, usage, usage_prod, fresh,
                                          ok_default, ok_prod, ld, nullptr, feasible, vec_ok, s)
               : (int)launch<false, false>(prm, Pc, Nc, pod_idx, node_idx, req, sreq, est,
                                           pod_ok, pod_prod, alloc, requested, usage, usage_prod,
                                           fresh, ok_default, ok_prod, ld, nullptr, feasible, 0,
                                           s);
}
