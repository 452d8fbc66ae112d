// Run-ordered segmented sums in rank space, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of tidb_tpu/copr/streamseg.py
// (lines 100-214: the kernel and the pl.pallas_call in `rank_sums`). It
// computes
//
//     rank(row)  = f[0] + ... + f[row]          (f: host change flags, 0/1)
//     out[k, r]  = sum of vals[k, row] over rows with rank(row) == r < nd
//
// for K <= 8 value arrays of n rows (f32 holding integers: 12-bit limbs,
// 0/1 masks). Rows at or past nf = len(f) have flag 0, so they join the
// last rank. Ranks in [nd, nd_pad) are 0. A flag is read as 0 or 1
// (f != 0); the host builds them so.
//
// Bound on this card: bytes. The function reads K*n*4 + nf*4 bytes and
// writes K*nd_pad*4; it does about K*n adds, far below any compute peak.
// At TPC-H SF10 (K = 4, n = 67,108,864, nf = 60,455,502, nd = 15M) that is
// 1.556 GB, 0.464 ms at 3.35 TB/s.
//
// Exactness: every addend, every partial and every total is an integer
// whose magnitude is below 2^24 (the MAX_ROWS_PER_KEY = 4096 gate times
// values below 2^12), so each f32 addition is exact and any order of
// additions gives the same bits: the output equals the plain PyTorch
// version (cumsum + index_add_) bit for bit.
//
// Design: one launch (after the wrapper zeroes the scratch), one pass
// over every input byte, every output element stored exactly once.
//
// 1. Single pass, decoupled look-back. The rows are cut into tiles of
//    T = 1024. Each tile has a 64-bit status word in scratch: its state
//    (invalid, aggregate, inclusive prefix), its flag count (the tile's
//    own, or the count up to its end) and whether it holds a flag. Blocks
//    take tiles in order from an atomic tile counter (one more scratch
//    word), never from blockIdx, so every predecessor of a tile a block
//    holds belongs to a running block that takes its tiles in increasing
//    order: every wait below is on a smaller tile, and the kernel always
//    makes progress. A block's control warp publishes a tile's aggregate
//    count as soon as its flags land (while the workers reduce the tile
//    before it), and reads back 32 * W predecessors' status words a round
//    to the nearest inclusive count; that gives E, the rank of the tile's
//    first row minus its first flag. Status and tail words carry their own
//    valid tags and are written once each (a status word twice: aggregate,
//    then inclusive, with the same has-a-flag bit). No reader infers one
//    word from another: a word it needs it reads until it is nonzero, so
//    relaxed loads suffice without acquire or fence.
// 2. Block-owned ranks. A tile's rows cover the contiguous local slots
//    0..cnt (cnt = its flag count); slot j is rank E + j. Each of the 256
//    workers holds 4 consecutive rows and sums its runs in registers; a
//    run that goes on across workers is summed by a shuffle suffix scan
//    in the warp, and across warps by one shared-memory atomicAdd per warp
//    into the slot the run's owner stored before the barrier. The slot
//    sums land in a shared-memory slot buffer, and consecutive workers
//    store slots 1..cnt-1 to out[k, E+1 .. E+cnt) in 16-byte stores where
//    aligned. Only slot 0 and slot cnt touch other tiles: slot cnt (the
//    tile's last run) may go on into the next tile, so it is not stored
//    but published as the tile's tail; slot 0 (rank E) may have begun in
//    earlier tiles, so it waits one tile: the control warp then adds the
//    tails of the predecessors up to and including the nearest one that
//    holds a flag (where rank E began) and stores it. So every rank is
//    stored once, by the tile in which it ends, and no atomic reaches the
//    output: the order of the writes across blocks does not matter.
// 3. No zero fill. Ranks [0, total) are stored by the tiles in which they
//    end; the last tile stores the last rank and zeros up to nd_pad, and
//    ranks at or past nd are stored as 0. The wrapper allocates the output
//    with torch.empty.
// 4. Loads in flight while a tile reduces. The grid is persistent: the
//    SM count times the blocks per SM that fit (occupancy API). Each block
//    keeps a ring of STAGES stages in shared memory; the tile's flags and
//    its K value rows come by 1-D TMA bulk copies (cp.async.bulk, the
//    flags and the values completing on two mbarriers), so the next tile's
//    loads are in flight while the block reduces the current one. Once the
//    workers hold their rows in registers, the slot buffer overlays the
//    stage they came from. TMA needs 16-byte aligned addresses and sizes:
//    when n % 4 != 0 (row k of vals starts at byte k*n*4) or a pointer is
//    unaligned, and at the ragged tail of a row or of the flags, those
//    rows come by plain loads once the stage has arrived.
// 5. Pad rows in parallel. Rows past nf (9.9% of them at SF10) make tiles
//    without a flag: each is summed by whichever block takes it, and only
//    its tail goes out. The last tile's slot 0 then sums all those tails:
//    the whole block reads THREADS * W of them a round, never one block
//    tile by tile.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // worker threads per block
constexpr int THREADS = NT + 32;  // ... and one control warp
constexpr int ITEMS = 4;       // rows per worker: one int4 / one float4
constexpr int T = NT * ITEMS;  // rows per tile
constexpr int SP = T + 1;      // slots per array in the slot buffer
constexpr int STAGES = 3;      // ring of tile stages per block
constexpr int W = 2;           // status words a lane reads per round
// blocks per SM the registers are budgeted for
constexpr int min_blocks(int K) { return K <= 3 ? 4 : (K <= 5 ? 3 : 2); }

// status word: state << 32 | has-a-flag << 34 | flag count
constexpr unsigned long long ST_AGG = 1, ST_INC = 2, ST_FLAG = 4;

// Scratch, zeroed by the wrapper on every call, all 64-bit words:
//   status[ntiles]   the tile's flag count (aggregate), later the count
//                    up to its end (inclusive), and whether it has a flag
//   counter          the next tile to take
//   tail[K][ntiles]  1 << 32 | f32 bits of the tile's last-run partial
// A word is valid once nonzero and is never seen half written. Readers
// spin on the very word they need (count_lookback waits on a zero status,
// status_of and tail_of spin), never on another word's visibility, so they
// need no fence.
struct Args {
  const float* vals;
  const int32_t* f;
  float* out;
  unsigned long long* status;
  long long n, nf, nd, nd_pad;
  int ntiles;
};

__device__ __forceinline__ unsigned long long* tail_word(const Args& a,
                                                        int k, int t) {
  return a.status + (long long)(k + 1) * a.ntiles + 1 + t;
}

template <int K>
__host__ __device__ constexpr int stage_bytes() { return T * 4 * (K + 1); }

// The slot buffer (K rows of SP floats) overlays the stage it was summed
// from: the workers hold their rows in registers by then.
template <int K>
__host__ __device__ constexpr int smem_bytes() {
  static_assert(K * SP <= (K + 1) * T, "slot buffer overlays a stage");
  return STAGES * stage_bytes<K>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes to shared memory before a later bulk copy into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(
    unsigned long long state, unsigned int count, bool flagged) {
  return ((state | (flagged ? ST_FLAG : 0)) << 32) | count;
}

__device__ __forceinline__ bool has_flag(unsigned long long status) {
  return (status >> 32) & ST_FLAG;
}

// a status word, once its tile has announced it
__device__ __forceinline__ unsigned long long status_of(
    const unsigned long long* p) {
  unsigned long long w;
  while ((w = ld_relaxed(p)) == 0) __nanosleep(32);
  return w;
}

// a tail word's value, once its tile has stored it
__device__ __forceinline__ float tail_of(const unsigned long long* p) {
  unsigned long long w;
  while (((w = ld_relaxed(p)) >> 32) == 0) __nanosleep(32);
  return __uint_as_float((unsigned int)w);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Rows of tile t, and how many of them come by bulk copy (a multiple of
// 4 rows, or 0 when the source is not 16-byte aligned).
struct Geom {
  long long base;
  int rows, frows, f16, r16;
};

__device__ __forceinline__ Geom geom(const Args& a, int t, bool tma_f,
                                     bool tma_v) {
  Geom g;
  g.base = (long long)t * T;
  const long long left = a.n - g.base;
  g.rows = left < T ? (int)left : T;
  const long long fl = a.nf - g.base;
  g.frows = fl <= 0 ? 0 : (fl < g.rows ? (int)fl : g.rows);
  g.f16 = tma_f ? (g.frows & ~3) : 0;
  g.r16 = tma_v ? (g.rows & ~3) : 0;
  return g;
}

template <int K>
__device__ __forceinline__ int32_t* stage_flags(unsigned char* smem, int s) {
  return reinterpret_cast<int32_t*>(smem + s * stage_bytes<K>());
}

template <int K>
__device__ __forceinline__ float* stage_vals(unsigned char* smem, int s) {
  return reinterpret_cast<float*>(smem + s * stage_bytes<K>() + T * 4);
}

// One thread: take the next tile from the counter and start its bulk
// copies into stage s: the flags complete on bars[s], the values on
// bars[STAGES + s].
template <int K>
__device__ void issue(const Args& a, unsigned char* smem, uint64_t* bars,
                      int* tile_of, int s, bool tma_f, bool tma_v) {
  uint64_t* fb = &bars[s];
  uint64_t* vb = &bars[STAGES + s];
  const int t = (int)atomicAdd(a.status + a.ntiles, 1ull);
  tile_of[s] = t;
  if (t >= a.ntiles) {  // no tile left: arrive, nothing to copy
    mbar_expect_tx(fb, 0);
    mbar_expect_tx(vb, 0);
    return;
  }
  const Geom g = geom(a, t, tma_f, tma_v);
  mbar_expect_tx(fb, 4u * (uint32_t)g.f16);
  if (g.f16 > 0)
    bulk_load(stage_flags<K>(smem, s), a.f + g.base, 4u * g.f16, fb);
  mbar_expect_tx(vb, 4u * (uint32_t)(K * g.r16));
  if (g.r16 > 0) {
    float* v = stage_vals<K>(smem, s);
#pragma unroll
    for (int k = 0; k < K; ++k)
      bulk_load(v + k * T, a.vals + k * a.n + g.base, 4u * g.r16, vb);
  }
}

// Control warp: once stage s's flags have arrived, complete them (the rows
// the bulk copy did not bring), count them, and publish the tile's
// aggregate count. A block announces the tile it holds next as soon as
// its flags land, while its workers reduce the current one, so look-backs
// seldom wait for a tile that is not begun.
template <int K>
__device__ void announce(const Args& a, unsigned char* smem,
                         const int* tile_of, unsigned int* cnt_of, int s,
                         bool tma_f, int lane) {
  const int t = tile_of[s];
  if (t >= a.ntiles) return;
  const Geom g = geom(a, t, tma_f, false);
  int32_t* fl = stage_flags<K>(smem, s);
  if (g.f16 < g.frows) {
    for (int i = g.f16 + lane; i < g.frows; i += 32) fl[i] = a.f[g.base + i];
    fence_proxy_async();
    __syncwarp();
  }
  unsigned int cnt = 0;
  for (int i = lane * 4; i < g.frows; i += 128) {
    const int4 q = *reinterpret_cast<const int4*>(fl + i);
    cnt += (q.x != 0) + (i + 1 < g.frows && q.y != 0) +
           (i + 2 < g.frows && q.z != 0) + (i + 3 < g.frows && q.w != 0);
  }
  cnt = __reduce_add_sync(~0u, cnt);
  if (lane == 0) {
    cnt_of[s] = cnt;
    st_relaxed(a.status + t, status_word(ST_AGG, cnt, cnt > 0));
  }
  __syncwarp();
}

// Control warp: the flag count before tile t. Each round reads 32 * W
// predecessors' status words (distance j*32 + lane in load j) and sums
// back to the nearest inclusive count. `idle` runs while it waits.
template <typename Idle>
__device__ unsigned int count_lookback(const Args& a, int t, int lane,
                                       Idle&& idle) {
  constexpr int R = 32 * W;
  unsigned int E = 0;
  for (int hi = t - 1;; hi -= R) {
    unsigned long long s[W];
    int last;
    bool done;
    for (;;) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int idx = hi - (j * 32 + lane);
        s[j] = idx >= 0 ? ld_relaxed(a.status + idx) : (ST_INC << 32);
      }
      // nearest missing status and nearest inclusive count
      int fi = R, pi = R;
#pragma unroll
      for (int j = W - 1; j >= 0; --j) {
        const unsigned int st = (unsigned int)(s[j] >> 32) & 3;
        const unsigned int mi = __ballot_sync(~0u, st == 0);
        const unsigned int mp = __ballot_sync(~0u, st == ST_INC);
        if (mi) fi = j * 32 + __ffs(mi) - 1;
        if (mp) pi = j * 32 + __ffs(mp) - 1;
      }
      if (pi < fi) {  // an inclusive count before any missing status
        last = pi;
        done = true;
        break;
      }
      if (fi == R) {  // R aggregates: take them all, read further back
        last = R - 1;
        done = false;
        break;
      }
      idle();  // a predecessor is not announced yet
      __nanosleep(64);
    }
    unsigned int sum = 0;
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (j * 32 + lane <= last) sum += (unsigned int)s[j];
    E += __reduce_add_sync(~0u, sum);
    if (done) return E;
  }
}

// Control warp: lane l's status word and K tail words of tile p-1-d-l,
// loaded ahead of their use (either may still read 0 here).
template <int K>
__device__ __forceinline__ void load_window(const Args& a, int p, int d,
                                            int lane, unsigned long long& st,
                                            unsigned long long (&tw)[K]) {
  const int idx = p - 1 - d - lane;
  st = ST_FLAG << 32;  // before tile 0: the walk ends
#pragma unroll
  for (int k = 0; k < K; ++k) tw[k] = 0;
  if (idx >= 0) {
    st = ld_relaxed(a.status + idx);
#pragma unroll
    for (int k = 0; k < K; ++k) tw[k] = ld_relaxed(tail_word(a, k, idx));
  }
}

// Control warp: add to `carry` (lane k: array k) the tails of tiles
// p-1-d .. p-32-d up to and including the nearest one that holds a flag;
// true when that tile was among them. A status or tail word not yet seen
// is read again until it is. The spin ends: every tile before p has
// announced its status by now (p's look-back read the statuses back to an
// inclusive count, which its tile stored after its own look-back had done
// the same, and so on back to tile 0). Nothing assumes that those stores
// are visible here already.
template <int K>
__device__ bool carry_window(const Args& a, int p, int d, int lane,
                             unsigned long long st,
                             const unsigned long long (&tw)[K],
                             float& carry) {
  const int idx = p - 1 - d - lane;
  if (idx >= 0 && st == 0) st = status_of(a.status + idx);
  const unsigned int m = __ballot_sync(~0u, has_flag(st));
  const int upto = m ? __ffs(m) - 1 : 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = 0.f;
    if (lane <= upto && idx >= 0)
      x = (tw[k] >> 32) ? __uint_as_float((unsigned int)tw[k])
                        : tail_of(tail_word(a, k, idx));
    x = warp_sum(x);
    if (lane == k) carry += x;
  }
  return m != 0;
}

// All threads: the walk on from distance `from`, THREADS * W tiles a
// round, adding into s_C. Only the last tile comes here, when the pad rows
// past nf fill more than 32 tiles before it.
template <int K>
__device__ void carry_walk(const Args& a, int p, int from, float* s_C,
                           int* s_stop) {
  for (int d0 = from;; d0 += THREADS * W) {
    if (threadIdx.x == 0) *s_stop = INT_MAX;
    __syncthreads();
    int mine = INT_MAX;
#pragma unroll
    for (int j = W - 1; j >= 0; --j) {
      const int d = d0 + j * THREADS + threadIdx.x;
      const int idx = p - 1 - d;
      if (idx < 0 || has_flag(status_of(a.status + idx))) mine = d;
    }
    if (mine != INT_MAX) atomicMin(s_stop, mine);
    __syncthreads();
    const int stop = *s_stop;
    float part[K];
#pragma unroll
    for (int k = 0; k < K; ++k) part[k] = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int d = d0 + j * THREADS + threadIdx.x;
      const int idx = p - 1 - d;
      if (d <= stop && idx >= 0) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          part[k] += tail_of(tail_word(a, k, idx));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (part[k] != 0.f) atomicAdd(s_C + k, part[k]);
    __syncthreads();
    if (stop != INT_MAX) return;
  }
}

// Slot 0 of a tile p > 0 (rank E_p) waits: its carry needs p-1's tail,
// which p-1's block publishes about when this block publishes p's. The
// control warp resolves it one tile later, or the block at its end.
struct Pending {
  int p;      // tile, or -1
  int E;      // its rank
  int stage;  // where the workers left its slot-0 partials
};

template <int K>
__device__ __forceinline__ void store_pending(const Args& a,
                                              const Pending& pd,
                                              const float* s0,
                                              const float* carry, int k) {
  if (k < K && pd.E < a.nd_pad)
    a.out[(long long)k * a.nd_pad + pd.E] =
        pd.E < a.nd ? s0[k] + carry[k] : 0.f;
}

__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
}

// One block: a control warp (tid 0-31) and NT workers (4 rows each).
// Per tile, in stage s, with the next tile in stage s1:
//   workers: values in, slot scan, run sums into S (the slot buffer), the
//            tile's tail out  | control: the look-back for E, the pending
//            slot 0 of the previous tile resolved, the next tile announced
//            as soon as its flags land
//   ---- __syncthreads ----
//   workers: ranks [E+1, E+cnt) stored, S free, the next bulk copies into
//            stage s  | control: the previous slot 0 stored, then on to
//            the next tile's look-back while the workers store
template <int K>
__global__ void __launch_bounds__(THREADS, min_blocks(K))
    rank_sums_kernel(const Args a) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];  // flags, values
  __shared__ int tile_of[STAGES];
  __shared__ unsigned int cnt_of[STAGES];  // announced flag counts
  __shared__ unsigned int E_of[STAGES];    // the tiles' first ranks
  __shared__ float s0_of[STAGES][K];       // slot-0 partials
  __shared__ int w_sum[NW];                // worker warps' flag counts
  __shared__ float s_C[K];
  __shared__ int s_more, s_stop;
  __shared__ Pending pend;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool control = tid < 32;
  const int wid = tid - 32;    // worker index
  const int ww = wid >> 5;     // worker warp
  const bool tma_f = (reinterpret_cast<uintptr_t>(a.f) & 15) == 0;
  const bool tma_v =
      (reinterpret_cast<uintptr_t>(a.vals) & 15) == 0 && (a.n & 3) == 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < 2 * STAGES; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    pend.p = -1;
  }
  __syncthreads();
  if (control) {
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s)
        issue<K>(a, smem, bars, tile_of, s, tma_f, tma_v);
    }
    __syncwarp();
    mbar_wait(&bars[0], 0);
    announce<K>(a, smem, tile_of, cnt_of, 0, tma_f, lane);
  }
  __syncthreads();  // the first tile is announced

  int s = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&bars[s], phase);
    const int t = tile_of[s];
    if (t >= a.ntiles) break;
    const bool last_tile = t == a.ntiles - 1;
    const int s1 = s + 1 == STAGES ? 0 : s + 1;
    const uint32_t ph1 = s1 == 0 ? phase ^ 1 : phase;

    if (control) {
      // E, then the pending slot 0 of the block's previous tile (its loads
      // fly during the look-back); the next tile is announced as soon as
      // its flags land
      bool announced = false;
      auto try_announce = [&]() {
        if (announced) return;
        const int ready = lane == 0 && mbar_test(&bars[s1], ph1);
        if (__shfl_sync(~0u, ready, 0)) {
          announce<K>(a, smem, tile_of, cnt_of, s1, tma_f, lane);
          announced = true;
        }
      };
      try_announce();
      unsigned long long pst, ptw[K];
      if (pend.p > 0) load_window<K>(a, pend.p, 0, lane, pst, ptw);
      const unsigned int E =
          t > 0 ? count_lookback(a, t, lane, try_announce) : 0;
      if (lane == 0) {
        st_relaxed(a.status + t,
                   status_word(ST_INC, E + cnt_of[s], cnt_of[s] > 0));
        E_of[s] = E;
      }
      if (pend.p > 0) {
        float carry = 0.f;
        for (int d = 0;
             !carry_window<K>(a, pend.p, d, lane, pst, ptw, carry);) {
          d += 32;  // a long flagless stretch (not seen under the gate)
          load_window<K>(a, pend.p, d, lane, pst, ptw);
        }
        if (lane < K) s_C[lane] = carry;
      }
      if (!announced) {
        mbar_wait(&bars[s1], ph1);
        announce<K>(a, smem, tile_of, cnt_of, s1, tma_f, lane);
      }
    } else {
      mbar_wait(&bars[STAGES + s], phase);
      const Geom g = geom(a, t, tma_f, tma_v);
      const int32_t* fl = stage_flags<K>(smem, s);
      const float* v = stage_vals<K>(smem, s);
      float* S = reinterpret_cast<float*>(stage_flags<K>(smem, s));
      // value rows the bulk copies did not bring (unaligned, ragged tail)
      if (g.r16 < g.rows) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          for (int i = g.r16 + wid; i < g.rows; i += NT)
            stage_vals<K>(smem, s)[k * T + i] =
                a.vals[k * a.n + g.base + i];
        fence_proxy_async();
        workers_sync();
      }
      // local slot of each row: flags before it in the tile, inclusive
      const int r0 = wid * ITEMS;
      const int4 fq = reinterpret_cast<const int4*>(fl)[wid];
      float4 q[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        q[k] = reinterpret_cast<const float4*>(v + k * T)[wid];
      const int b0 = (r0 < g.frows) & (fq.x != 0);
      const int b1 = (r0 + 1 < g.frows) & (fq.y != 0);
      const int b2 = (r0 + 2 < g.frows) & (fq.z != 0);
      const int b3 = (r0 + 3 < g.frows) & (fq.w != 0);
      const int p1 = b0 + b1, p2 = p1 + b2, p3 = p2 + b3;
      int tb = p3;  // inclusive scan over the workers
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(~0u, tb, d);
        if (lane >= d) tb += o;
      }
      if (lane == 31) w_sum[ww] = tb;
      workers_sync();  // every worker holds its rows: the stage is S now
      tb -= p3;
      int cnt = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w < ww) tb += w_sum[w];
        cnt += w_sum[w];
      }

      // Runs across workers meet in the warp: `own` says this worker's
      // first run starts in its rows; otherwise that run goes on from the
      // lane before, and from lane to lane while a lane holds no flag. A
      // suffix scan over those chains gives each run's owner its rest.
      const bool own = wid == 0 || b0;
      const bool own_next = __shfl_down_sync(~0u, own, 1);
      bool G[5];  // at step i: the chain from this lane reaches lane + 2^i
      {
        bool gl = lane < 31 && p3 == 0 && !own_next;
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          G[i] = gl;
          const bool next = __shfl_down_sync(~0u, gl, 1 << i);
          gl = gl && next;
        }
      }
      const bool cont = lane < 31 && !own_next;  // the last run goes on
      float lead[K];  // lane 0: its warp's part of a run begun before it
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float x0 = r0 < g.rows ? q[k].x : 0.f;
        const float x1 = r0 + 1 < g.rows ? q[k].y : 0.f;
        const float x2 = r0 + 2 < g.rows ? q[k].z : 0.f;
        const float x3 = r0 + 3 < g.rows ? q[k].w : 0.f;
        const float a0 = 0.f + x0;
        const float a1 = (b1 ? 0.f : a0) + x1;
        const float a2 = (b2 ? 0.f : a1) + x2;
        const float a3 = (b3 ? 0.f : a2) + x3;
        // this lane's part of a run begun before it, summed along its chain
        float z = own ? 0.f : (b1 ? a0 : b2 ? a1 : b3 ? a2 : a3);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float o = __shfl_down_sync(~0u, z, 1 << i);
          if (G[i]) z += o;
        }
        const float rest = __shfl_down_sync(~0u, z, 1);
        float* Sk = S + k * SP + tb;
        if (b1 && own) Sk[b0] = a0;                  // a run ends at row 0
        if (b2 && (own || p1 != b0)) Sk[p1] = a1;    // ... at row 1
        if (b3 && (own || p2 != b0)) Sk[p2] = a2;    // ... at row 2
        if (own || p3 != b0) Sk[p3] = a3 + (cont ? rest : 0.f);
        if (wid == 0 && b0) S[k * SP] = 0.f;  // rank E has no row here
        lead[k] = z;
      }
      // runs begun in an earlier warp get the rest from the later ones
      workers_sync();
      if (lane == 0 && !own) {
#pragma unroll
        for (int k = 0; k < K; ++k) atomicAdd(S + k * SP + tb, lead[k]);
      }
      workers_sync();
      // this tile's tail, for the carries of later tiles
      if (wid < K)
        st_relaxed(tail_word(a, wid, t),
                   (1ull << 32) | __float_as_uint(S[wid * SP + cnt]));
    }
    __syncthreads();

    const int E = (int)E_of[s];
    const unsigned int cnt = cnt_of[s];
    const float* S = reinterpret_cast<const float*>(stage_flags<K>(smem, s));
    if (control) {
      if (pend.p > 0) store_pending<K>(a, pend, s0_of[pend.stage], s_C, lane);
      // slot 0 of this tile waits, if it is stored at all
      if (lane == 0) {
        pend.p = t > 0 && (cnt > 0 || last_tile) && E < a.nd_pad ? t : -1;
        pend.E = E;
        pend.stage = s;
      }
      __syncwarp();
    } else {
      if (wid < K) s0_of[s][wid] = S[wid * SP];
      // store ranks [E, E + cnt); the last tile also stores its last rank
      // and zeros up to nd_pad. Ranks at or past nd are stored as 0. Slot
      // 0 of a tile after the first waits for its carry (Pending).
      // (the wrapper keeps K * nd_pad below 2^31, so ranks fit an int)
      const int nd_pad = (int)a.nd_pad;
      const int room = nd_pad > E ? nd_pad - E : 0;
      const int jend = last_tile ? room : ((int)cnt < room ? (int)cnt : room);
      const int j0 = t > 0 ? 1 : 0;
      const int live = a.nd > E ? (int)(a.nd - E) : 0;  // slots below nd
      auto value = [&](int k, int j) -> float {
        return j < live && j <= (int)cnt ? S[k * SP + j] : 0.f;
      };
      // 16-byte groups of ranks (out rows start 16-byte aligned: the
      // wrapper allocates out and keeps nd_pad a multiple of 4)
      const int q0 = (E + j0) >> 2;
      const int nq = jend > j0 ? ((E + jend + 3) >> 2) - q0 : 0;
      for (int i = wid; i < K * nq; i += NT) {
        const int k = i / nq;
        const int j = (q0 + i - k * nq) * 4 - E;  // slot of the first lane
        float* o = a.out + (long long)k * nd_pad + E + j;
        if (j >= j0 && j + 4 <= jend) {
          *reinterpret_cast<float4*>(o) = make_float4(
              value(k, j), value(k, j + 1), value(k, j + 2), value(k, j + 3));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (j + c >= j0 && j + c < jend) o[c] = value(k, j + c);
        }
      }
      fence_proxy_async();  // S is written; the next bulk copy overwrites it
      workers_sync();       // stage s is free again
      if (wid == 0) issue<K>(a, smem, bars, tile_of, s, tma_f, tma_v);
    }
    s = s1;
    phase = ph1;
  }

  // the last pending slot 0; the block walks on past 32 flagless tiles
  __syncthreads();
  if (pend.p > 0) {
    if (control) {
      unsigned long long pst, ptw[K];
      load_window<K>(a, pend.p, 0, lane, pst, ptw);
      float carry = 0.f;
      const bool found = carry_window<K>(a, pend.p, 0, lane, pst, ptw, carry);
      if (lane == 0) s_more = found ? -1 : 32;
      if (lane < K) s_C[lane] = carry;
    }
    __syncthreads();
    if (s_more >= 0) carry_walk<K>(a, pend.p, s_more, s_C, &s_stop);
    if (control) store_pending<K>(a, pend, s0_of[pend.stage], s_C, lane);
  }
}

struct Config {
  int blocks_per_sm, sms, smem;
};

// Launch configuration on the current device (cached per device).
template <int K>
cudaError_t config(Config* c) {
  static Config cache[64];
  static bool ready[64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ready[dev]) {
    *c = cache[dev];
    return cudaSuccess;
  }
  c->smem = smem_bytes<K>();
  e = cudaFuncSetAttribute(rank_sums_kernel<K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           c->smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &c->blocks_per_sm, rank_sums_kernel<K>, THREADS, c->smem);
  if (e != cudaSuccess) return e;
  if (c->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) {
    cache[dev] = *c;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <int K>
int launch(const Args& a, cudaStream_t stream) {
  Config c;
  cudaError_t e = config<K>(&c);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)c.blocks_per_sm * c.sms;
  const int grid = (int)(a.ntiles < resident ? a.ntiles : resident);
  rank_sums_kernel<K><<<grid, THREADS, c.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
int describe(int* out4) {
  Config c;
  cudaError_t e = config<K>(&c);
  if (e != cudaSuccess) return (int)e;
  out4[0] = c.blocks_per_sm;
  out4[1] = c.sms;
  out4[2] = c.smem;
  out4[3] = T;
  return 0;
}

}  // namespace

// vals f32[K, n] (n < 2^31), f int32[nf], out f32[K, nd_pad] (16-byte
// aligned, nd_pad % 4 == 0, uninitialised: every element is written),
// scratch uint64[streamseg_scratch_words(K, n)] zeroed. One launch on
// `stream`; returns cudaGetLastError() after it (0 = success).
extern "C" int streamseg_rank_sums(const float* vals, const int32_t* f,
                                   float* out, unsigned long long* scratch,
                                   int K, long long n, long long nf,
                                   long long nd, long long nd_pad,
                                   void* stream) {
  const Args a{vals, f, out, scratch, n, nf, nd, nd_pad,
               (int)((n + T - 1) / T)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    case 8: return launch<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 64-bit words of zeroed scratch the kernel needs for K arrays of n rows
// (the layout of Args: status, counter, tails).
extern "C" int streamseg_scratch_words(int K, long long n) {
  return (int)((n + T - 1) / T) * (K + 1) + 1;
}

// Launch configuration for K arrays on the current device: out4 gets
// blocks per SM, SM count, dynamic shared memory bytes per block and rows
// per tile.
extern "C" int streamseg_launch_config(int K, int* out4) {
  switch (K) {
    case 1: return describe<1>(out4);
    case 2: return describe<2>(out4);
    case 3: return describe<3>(out4);
    case 4: return describe<4>(out4);
    case 5: return describe<5>(out4);
    case 6: return describe<6>(out4);
    case 7: return describe<7>(out4);
    case 8: return describe<8>(out4);
    default: return (int)cudaErrorInvalidValue;
  }
}
