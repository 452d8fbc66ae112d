// Run-ordered segmented sums in rank space, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of tidb_tpu/copr/streamseg.py
// (launched by `rank_sums` through pl.pallas_call). It computes
//
//     rank(row)  = f[0] + ... + f[row]          (f: host change flags)
//     out[k, r]  = sum of vals[k, row] over rows with rank(row) == r < nd
//
// for K <= 8 value arrays of n rows (f32 holding integers: 12-bit limbs,
// 0/1 masks). Rows at or past nf = len(f) have flag 0. Ranks >= nd are
// dropped; the wrapper zero-fills the output with torch.zeros.
//
// Bound on this card: bytes. The function reads K*n*4 + nf*4 bytes and
// writes K*nd_pad*4; it does about K*n adds, far below any compute peak.
// At TPC-H SF10 (K = 4, n ~ 60M, nd ~ 15M) that is ~1.44 GB, ~0.43 ms at
// 3.35 TB/s.
//
// Design. The TPU kernel is a sequential grid with a sliding VMEM window,
// a log-doubling roll cumsum and a one-hot MXU matmul; none of that
// carries over, because CUDA blocks run in no order. Here:
//   (i)   tile_counts: each block sums the flags of its 4096-row tile;
//   (ii)  scan_tiles: one block turns the tile counts into exclusive
//         tile offsets;
//   (iii) rank_accumulate: each block reloads its tile's flags (coalesced,
//         through cub::BlockLoad), a block scan gives every thread the rank
//         before its 16 contiguous rows, and each thread walks its rows,
//         keeping one partial sum per rank change. A rank strictly inside
//         a thread's rows belongs to that thread alone and is stored; the
//         thread's first and last ranks may be shared with neighbouring
//         threads or tiles and are added with atomicAdd.
// Exactness: every addend, every partial and every total is an integer
// whose magnitude is below 2^24 (the MAX_ROWS_PER_KEY = 4096 gate times
// values below 2^12), so each f32 addition is exact and the result does
// not depend on the order of the atomics: the output equals the plain
// PyTorch version (cumsum + index_add_) bit for bit.
//
// The flags are read twice (steps i and iii); a later version can fuse
// the passes with a decoupled look-back scan.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_load.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // rows per block; _kernels.TILE_ROWS
constexpr int SCAN_THREADS = 1024;

using LoadI = cub::BlockLoad<int32_t, THREADS, ITEMS,
                             cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using LoadF = cub::BlockLoad<float, THREADS, ITEMS,
                             cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using ReduceI = cub::BlockReduce<int32_t, THREADS>;
using ScanI = cub::BlockScan<int32_t, THREADS>;

// Flags of this block's tile in blocked arrangement (thread t holds rows
// t*ITEMS .. t*ITEMS+ITEMS-1); rows at or past nf read as 0. `nvalid` is
// the same for every thread of the block, so the collective load is
// entered by all threads or by none.
__device__ void load_flags(const int32_t* __restrict__ f, int64_t nf,
                           int64_t base, int32_t (&fl)[ITEMS],
                           typename LoadI::TempStorage& tmp) {
  int64_t left = nf - base;
  int nvalid = left <= 0 ? 0 : (left >= TILE ? TILE : (int)left);
  if (nvalid > 0) {
    LoadI(tmp).Load(f + base, fl, nvalid, 0);
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) fl[i] = 0;
  }
}

__global__ void tile_counts(const int32_t* __restrict__ f, int64_t nf,
                            int32_t* __restrict__ counts) {
  __shared__ union {
    typename LoadI::TempStorage load;
    typename ReduceI::TempStorage reduce;
  } tmp;
  int64_t base = (int64_t)blockIdx.x * TILE;
  int32_t fl[ITEMS];
  load_flags(f, nf, base, fl, tmp.load);
  int32_t s = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) s += fl[i];
  __syncthreads();
  int32_t total = ReduceI(tmp.reduce).Sum(s);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void scan_tiles(const int32_t* __restrict__ counts,
                           int32_t* __restrict__ offsets, int ntiles) {
  using Scan = cub::BlockScan<int32_t, SCAN_THREADS>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += SCAN_THREADS) {
    int i = base + threadIdx.x;
    int32_t v = i < ntiles ? counts[i] : 0;
    int32_t excl, total;
    Scan(tmp).ExclusiveSum(v, excl, total);
    if (i < ntiles) offsets[i] = carry + excl;
    __syncthreads();
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
}

__device__ __forceinline__ void flush(float* __restrict__ out_k, int32_t r,
                                      float acc, int32_t r_first,
                                      int32_t r_last, int64_t nd) {
  if (acc == 0.0f || r < 0 || r >= nd) return;
  if (r == r_first || r == r_last) {
    atomicAdd(out_k + r, acc);
  } else {
    out_k[r] = acc;  // rank owned by this thread alone
  }
}

__global__ void rank_accumulate(const float* __restrict__ vals,
                                const int32_t* __restrict__ f,
                                const int32_t* __restrict__ offsets,
                                float* __restrict__ out, int K, int64_t n,
                                int64_t nf, int64_t nd, int64_t nd_pad) {
  __shared__ union {
    typename LoadI::TempStorage li;
    typename LoadF::TempStorage lf;
    typename ScanI::TempStorage scan;
  } tmp;
  int64_t base = (int64_t)blockIdx.x * TILE;
  int64_t left = n - base;
  int rows = left >= TILE ? TILE : (int)left;

  // per-row ranks: tile offset + flags of earlier threads + own prefix
  int32_t fl[ITEMS];
  load_flags(f, nf, base, fl, tmp.li);
  int32_t run = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    run += fl[i];
    fl[i] = run;
  }
  __syncthreads();
  int32_t before;
  ScanI(tmp.scan).ExclusiveSum(run, before);
  __syncthreads();
  const int32_t start = offsets[blockIdx.x] + before;

  const int first_row = threadIdx.x * ITEMS;
  int m = rows - first_row;  // valid rows of this thread
  m = m < 0 ? 0 : (m > ITEMS ? ITEMS : m);
  const int32_t r_first = start + fl[0];
  const int32_t r_last = m > 0 ? start + fl[m - 1] : r_first;

  for (int k = 0; k < K; ++k) {
    float v[ITEMS];
    LoadF(tmp.lf).Load(vals + (int64_t)k * n + base, v, rows, 0.0f);
    __syncthreads();  // tmp is reused by the next array's load
    if (m == 0) continue;
    float* out_k = out + (int64_t)k * nd_pad;
    int32_t cur = r_first;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (i < m) {
        const int32_t r = start + fl[i];
        if (r != cur) {
          flush(out_k, cur, acc, r_first, r_last, nd);
          cur = r;
          acc = 0.0f;
        }
        acc += v[i];
      }
    }
    flush(out_k, cur, acc, r_first, r_last, nd);
  }
}

}  // namespace

// vals f32[K, n], f int32[nf], out f32[K, nd_pad] (zero-filled), counts
// and offsets int32[ceil(n / TILE)] scratch. Launches on `stream`;
// returns cudaGetLastError() after the launches (0 = success).
extern "C" int streamseg_rank_sums(const float* vals, const int32_t* f,
                                   float* out, int32_t* counts,
                                   int32_t* offsets, int K, long long n,
                                   long long nf, long long nd,
                                   long long nd_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (int)((n + TILE - 1) / TILE);
  tile_counts<<<ntiles, THREADS, 0, s>>>(f, nf, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tiles<<<1, SCAN_THREADS, 0, s>>>(counts, offsets, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank_accumulate<<<ntiles, THREADS, 0, s>>>(vals, f, offsets, out, K, n,
                                             nf, nd, nd_pad);
  return (int)cudaGetLastError();
}
