// Fused systematic resample + particle gather, hand-written for Hopper (sm_90a):
// copy-count prep and expansion from one C entry point, two kernels on one stream.
//
// Replaces pyfilter_tpu/ops/expand.py::_expand_kernel (the Pallas TPU kernel) and
// the counts prep (cumulative sum, ceil, clamp, pin) that feeds it.
//
// What it computes. Input: probabilities probs[0..n) (float32), a uniform u
// (float32, one value read on the device: no host sync) and d value planes
// values[d][n] (float32, plane-major). The copy-count boundaries counts[j] of
// fixed_counts.cuh (the exact fixed-point prefix sum of
// ops/resample.py::copy_counts), then for every output position i:
//     idx[i]       = #{ j < n-1 : counts[j] <= i }
//     out[c][i]    = values[c][idx[i]]
// bit for bit the plain version, ops/expand.py::_expand_probs_plain.
//
// What bounds it. At n = 1e6, d = 1 the function must read probs and values and
// write out and idx: 16 MB, so its least time on an H100 SXM (3.35 TB/s, data
// sheet, 700 W) is about 4.8 us. The work per element is an int64 add, two
// conversions and a few compares: memory-bound. The counts it writes and reads
// back between its two kernels (8 MB more) are the price of the grid-wide
// dependency below.
//
// What the design does about it. An output block's sources can lie anywhere
// (all mass on the last particle), so there is a grid-wide dependency, met by two
// kernels:
// (a) scan_counts_kernel: tiles of 8192 probabilities (123 tiles at n = 1e6, one
//     wave, so the look-back is short), 16 per thread by 16-byte loads,
//     converted to int64 fixed point; the block scans its thread totals
//     and takes its tile's prefix by a decoupled look-back (one warp reads 32
//     predecessors' flags at a time). The sum is exact, so the look-back's order
//     cannot change a bit. Each thread writes its counts (int32 scratch), and the
//     source j whose copies [counts[j-1], counts[j]) cover output block b's first
//     position writes start[b] = j. Tiles take tickets in the order they start,
//     so a tile only waits on tiles that run. Flags carry an epoch that the
//     state buffer holds on the device: kernel (b) resets the ticket and
//     advances the epoch, so a call needs no extra launch and no host state.
// (b) expand_kernel: block b owns 1024 outputs; its sources are
//     [start[b], start[b+1]], staged in shared memory with coalesced loads when
//     they fit (4096 boundaries, 16 KB, so that all 977 blocks at n = 1e6 are
//     resident in one wave; always, unless the weights are degenerate), each
//     thread binary-searching its 4 outputs there (global memory otherwise),
//     then issuing their 4 gathers together. No search outside the window, no
//     host decision, no fallback.
//
// What stops it short of the bound (times in PERF.md, section 6): the scan
// works on one block of 16 warps per SM, with int64 arithmetic and four
// conversions per probability (Hopper issues conversions at 16 a clock per SM),
// then waits on the look-back; the counts make a round trip through memory
// between the two kernels, and the second kernel pays a launch of its own.
//
// The backward (pf_expand_backward, launched by the autograd function around
// ops/expand.py::fused_expand): the transpose of the gather,
//     grad_src[c][j] = sum of grad_out[c][i] over the outputs i with idx[i] = j,
// the scatter-add that JAX's autodiff derives for the gather (the JAX package
// has no kernel for it; this is the port's own), for any monotone idx into
// [0, n): the outputs of source j are one contiguous run of idx. Every source is
// written exactly once, a source that no output names as 0.
//
// What bounds it. It must read grad_out (4 d n bytes) and idx (4 n) and write
// grad_src (4 d n): 12 MB at n = 1e6, d = 1, 3.6 us on an H100 SXM (3.35 TB/s).
// One float64 add an output: memory-bound. Its rules: the same bits at every
// launch (no float atomics, no look-back that groups float partials by
// timing), float64 sums in an order fixed by the shapes alone, rounded once,
// and no host decision by data.
//
// What the design does about it: a reduction by key over output tiles, in one
// launch (expand_backward_kernel).
// - A block owns a tile of 4096 outputs (16 a thread; 245 tiles at n = 1e6, all
//   resident at once, three blocks an SM) and reads its idx once, then each
//   plane of grad_out once, by 16-byte loads, the next plane's loads in flight
//   during this plane's work: the bound's traffic.
// - Each thread sums the runs of its 16 outputs serially in float64; a
//   segmented scan (warp shuffles, then the warps' totals in order through
//   shared memory, segmented_scan.cuh) carries the run that crosses each thread
//   edge, and the thread holding a run's last output has its sum.
// - A tile owns the window of sources (the previous tile's last key, its own
//   last key], the last tile up to n - 1, so the windows split [0, n). A
//   window of up to 16384 sources is staged in shared memory, zeroed, given the
//   sums and written out in coalesced stores, zero-copy sources included.
// - A run that crosses tile edges is written by the tile it ends in: that tile
//   waits for the flags of the tiles the run covers (usually one) and adds
//   their published float64 partials in tile order. The wait sees only values
//   each tile computes alone, so the sum's order is fixed by the inputs, never
//   by timing (unlike a look-back that takes whatever prefix is published
//   first). A degenerate cloud's one run of n is 245 block scans and one fixed
//   tree over 243 partials, not n serial adds by one thread.
// - A window wider than that (a gap of zero-copy sources: half of n on each
//   side of a degenerate cloud's one source) would put megabytes of zeros on
//   one SM. So 32 helper blocks split all wide windows' zeros evenly (each
//   helper reads every tile's last key), and a wide tile writes its sums
//   straight out once the helpers' flags are set.
// - Blocks take tickets in the order they start: helpers first, then tiles in
//   order. A block waits only on blocks with earlier tickets, which run and
//   never wait on later ones, so no wait can deadlock, whatever the grid. The
//   flags carry an epoch in device state that the last ticket advances: no
//   host state, no host sync, graph-safe.
// With n <= 4096 there is one tile, nothing crosses and nothing is wide: no
// tickets, no flags.
//
// What stops it short of the bound (times in PERF.md, section 6): each block
// takes its ticket before its loads (one atomic's round trip), the tile's
// barriers (a window's zeroing, the scan, the write-out), the helpers' reads
// of every tile's last key, and a crossing run's wait for its first tile.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "fixed_counts.cuh"
#include "segmented_scan.cuh"

namespace {

constexpr int kScanThreads = 512;
constexpr int kItems = 16;                         // probabilities per thread: four float4
constexpr int kTile = kScanThreads * kItems;       // 8192 per tile: 123 tiles at n = 1e6, one wave
constexpr int kMaxTiles = (1 << 24) / kTile;       // n < 2^24 (the wrapper checks)
constexpr int kOut = 1024;                         // outputs per expansion block
constexpr int kOutThreads = 256;
constexpr int kPer = kOut / kOutThreads;           // outputs per expansion thread
constexpr int kWindowCap = 4096;                   // boundaries staged in shared memory (16 KB)
// look-back state, int64 words: [0] tile ticket, [1] epoch, then flag, aggregate
// and inclusive prefix of each tile; a flag is epoch << 2 | status
constexpr int kStateWords = 2 + 3 * kMaxTiles;
constexpr long long kAggregate = 1;
constexpr long long kPrefix = 2;

__device__ __forceinline__ long long ld_acquire(const long long* p) {
  long long v;
  asm volatile("ld.acquire.gpu.global.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ long long ld_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(long long* p, long long v) {
  asm volatile("st.relaxed.gpu.global.s64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_release(long long* p, long long v) {
  asm volatile("st.release.gpu.global.s64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The exclusive prefix of tile `tile` (its predecessors' total), by warp 0:
// publishes the tile's aggregate, reads 32 predecessors' flags at a time until
// one holds an inclusive prefix, then publishes its own.
__device__ long long look_back(long long* state, int tile, long long epoch, long long aggregate) {
  long long* flag = state + 2;
  long long* agg = flag + kMaxTiles;
  long long* incl = agg + kMaxTiles;
  const int lane = threadIdx.x;
  long long excl = 0;
  if (tile > 0) {
    if (lane == 0) {
      st_relaxed(agg + tile, aggregate);
      st_release(flag + tile, epoch << 2 | kAggregate);
    }
    for (int top = tile - 1;; top -= 32) {
      const int j = top - lane;
      long long status = kPrefix;
      long long v = 0;
      if (j >= 0) {
        long long f;
        do {
          f = ld_acquire(flag + j);
        } while ((f >> 2) != epoch || (f & 3) == 0);
        status = f & 3;
        v = ld_relaxed((status == kPrefix ? incl : agg) + j);
      }
      const unsigned prefix = __ballot_sync(0xffffffffu, status == kPrefix);
      const int stop = prefix ? __ffs(prefix) - 1 : 31;  // nearest predecessor with a prefix
      excl += warp_sum(lane <= stop ? v : 0);
      if (prefix) break;
    }
  }
  if (lane == 0) {
    st_relaxed(incl + tile, excl + aggregate);
    st_release(flag + tile, epoch << 2 | kPrefix);
  }
  return excl;
}

__global__ void __launch_bounds__(kScanThreads)
scan_counts_kernel(const float* __restrict__ probs, const float* __restrict__ u_ptr,
                   int* __restrict__ counts, int* __restrict__ starts, long long* state, int n) {
  __shared__ long long s_warp[kScanThreads / 32];
  __shared__ long long s_excl;
  __shared__ int s_tile;
  __shared__ long long s_epoch;

  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(reinterpret_cast<unsigned long long*>(state), 1ull));
    s_epoch = ld_relaxed(state + 1);
  }
  __syncthreads();
  const int tile = s_tile;
  const long long epoch = s_epoch;
  const int base = tile * kTile + threadIdx.x * kItems;

  float p[kItems];
  const bool vec = (reinterpret_cast<uintptr_t>(probs) & 15) == 0;
  if (vec && base + kItems <= n) {
    const float4* src = reinterpret_cast<const float4*>(probs + base);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const float4 q = __ldg(src + k);
      p[4 * k] = q.x;
      p[4 * k + 1] = q.y;
      p[4 * k + 2] = q.z;
      p[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) p[k] = base + k < n ? __ldg(probs + base + k) : 0.0f;
  }
  long long total = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) total += pf::fixed_q(p[k]);

  // block scan of the thread totals: warp scans, then the warp totals
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  long long incl = total;
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  long long before = incl - total;
  long long aggregate = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
    if (w < warp) before += s_warp[w];
    aggregate += s_warp[w];
  }
  if (warp == 0) {
    const long long excl = look_back(state, tile, epoch, aggregate);
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();

  // counts, and the first source of every output block whose first position
  // falls in a source's copies
  if (base >= n) return;
  const float u = __ldg(u_ptr);
  long long s = s_excl + before;  // S_{base-1}
  int prev = base == 0 ? 0 : pf::copy_count(s, base - 1, n, u);
  int c[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = base + k;
    if (j < n) {
      s += pf::fixed_q(p[k]);
      c[k] = pf::copy_count(s, j, n, u);
      for (int b = (prev + kOut - 1) / kOut; b * kOut < c[k]; ++b) starts[b] = j;
      prev = c[k];
    }
  }
  if (base + kItems <= n) {  // counts is 16-byte aligned, base a multiple of 16
    int4* dst = reinterpret_cast<int4*>(counts + base);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) dst[k] = make_int4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n) counts[base + k] = c[k];
    }
  }
}

// First position p in [lo, hi) with c[p] > q (hi if none), for monotone c.
__device__ __forceinline__ int first_above(const int* c, int lo, int hi, int q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (c[mid] <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kOutThreads)
expand_kernel(const int* __restrict__ counts, const int* __restrict__ starts,
              const float* __restrict__ values, float* __restrict__ out, int* __restrict__ idx,
              long long* state, int n, int d) {
  __shared__ int s_counts[kWindowCap];

  if (blockIdx.x == 0 && threadIdx.x == 0) {  // the next call's look-back: ticket 0, a new epoch
    state[0] = 0;
    state[1] += 1;
  }
  const int b = blockIdx.x;
  const int first = b * kOut;
  // sources [lo, hi]: counts[hi] exceeds every output of the block
  const int lo = starts[b];
  const int hi = b + 1 < static_cast<int>(gridDim.x) ? starts[b + 1] : n - 1;
  const int w = hi - lo;
  const bool staged = w < kWindowCap;  // uniform across the block: the barrier is safe
  if (staged) {  // kPer loads in flight per thread and round
    for (int k0 = threadIdx.x; k0 < w; k0 += kPer * kOutThreads) {
      int v[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int k = k0 + r * kOutThreads;
        v[r] = k < w ? counts[lo + k] : 0;
      }
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int k = k0 + r * kOutThreads;
        if (k < w) s_counts[k] = v[r];
      }
    }
    __syncthreads();
  }
  // each thread's kPer outputs: their sources first, then their gathers in flight together
  int src[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = first + threadIdx.x + r * kOutThreads;
    if (i < n) {
      src[r] = staged ? lo + first_above(s_counts, 0, w, i) : first_above(counts, lo, hi, i);
      idx[i] = src[r];
    }
  }
  for (int k = 0; k < d; ++k) {
    const size_t plane = static_cast<size_t>(k) * n;
    float v[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (first + threadIdx.x + r * kOutThreads < n) v[r] = __ldg(values + plane + src[r]);
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = first + threadIdx.x + r * kOutThreads;
      if (i < n) out[plane + i] = v[r];
    }
  }
}

constexpr int kBackThreads = 256;
constexpr int kBackItems = 16;                           // outputs per thread: four int4 / float4 loads
constexpr int kBackTile = kBackThreads * kBackItems;     // 4096 outputs per tile: 245 tiles at n = 1e6
constexpr int kMaxBackTiles = (1 << 24) / kBackTile;     // n <= 2^24
constexpr int kBackStage = 4 * kBackTile;                // sources of a tile's window staged in shared memory
constexpr int kBackHelpers = 32;                         // blocks that zero the wide windows
// device state, int64 words: [0] ticket, [1] epoch, then one flag per tile and
// per helper, each epoch + 1 once that block's results are in memory
constexpr int kBackStateWords = 2 + kMaxBackTiles + kBackHelpers;
constexpr int kNoKey = 0x7fffffff;                       // the key of a position past n

// Scratch of a call with more than one tile: what each tile publishes.
struct BackScratch {
  double* part;  // [plane][tile][2]: the sums of the tile's first and last run
  int* keys;     // [tile][3]: their keys, and the key before the tile
};

__device__ __forceinline__ void load16(const float* src, bool vec, int base, int n, float (&v)[kBackItems]) {
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(src + base);
#pragma unroll
    for (int q = 0; q < kBackItems / 4; ++q) {
      const float4 x = __ldg(p + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kBackItems; ++r) v[r] = base + r < n ? __ldg(src + base + r) : 0.0f;
  }
}

// Waits until `flag` holds `want`. Only blocks with earlier tickets are waited
// on, and they never wait on later ones, so the wait ends; a bound turns a
// fault into an error rather than a hang.
__device__ __forceinline__ void wait_flag(const long long* flag, long long want) {
  for (long long spins = 0; ld_acquire(flag) != want; ++spins) {
    if (spins > (1LL << 24)) __trap();
    __nanosleep(32);
  }
}

// One block per ticket. The first `helpers` tickets zero the wide windows;
// ticket helpers + m takes tile m of kBackTile outputs. A tile owns the window
// of sources (the previous tile's last key, its own last key], the last tile up
// to n - 1, so the windows split [0, n). kSingle: one tile, no state, nothing
// crosses and nothing is wide.
template <bool kSingle>
__global__ void __launch_bounds__(kBackThreads, 3)
expand_backward_kernel(const float* __restrict__ grad_out, const int* __restrict__ idx, float* __restrict__ grad_src,
                       BackScratch sc, long long* state, int n, int d, int tiles, int helpers) {
  extern __shared__ int s_dyn[];             // the staged window (a tile), or the windows (a helper)
  __shared__ int s_first[kBackThreads + 1];  // each thread's first key; then the next tile's first
  __shared__ int s_last[kBackThreads];       // each thread's last key
  __shared__ int s_prev;                     // the previous tile's last key
  __shared__ int s_ticket;
  __shared__ long long s_mark;
  __shared__ int s_start;
  __shared__ int s_min;
  __shared__ int s_isum[kBackThreads / 32];
  __shared__ bool s_head[kBackThreads / 32];
  __shared__ double s_sum[kBackThreads / 32];
  __shared__ double s_mid[kBackThreads / 32];
  float* s_win = reinterpret_cast<float*>(s_dyn);
  long long* tile_flag = state + 2;
  long long* helper_flag = tile_flag + kMaxBackTiles;

  if (!kSingle) {
    if (threadIdx.x == 0) {  // the epoch is read before the ticket, so the last ticket may advance it
      const long long epoch = ld_acquire(state + 1);
      __threadfence();
      const int t = static_cast<int>(atomicAdd(reinterpret_cast<unsigned long long*>(state), 1ull));
      if (t == tiles + helpers - 1) {  // every block holds a ticket: reset for the next call
        st_relaxed(state, 0);
        st_release(state + 1, epoch + 1);
      }
      s_ticket = t;
      s_mark = epoch + 1;
    }
    __syncthreads();
  }
  const long long mark = kSingle ? 0 : s_mark;

  if (!kSingle && s_ticket < helpers) {
    // a helper: every tile's window from the tiles' last keys, the wide ones
    // compacted with their widths' prefix, then this helper's even share of
    // their zeros (all but a last key that a later tile writes)
    const int h = s_ticket;
    int* s_bound = s_dyn;                // [tiles] each tile's last key
    int* s_after = s_bound + tiles;      // [tiles] the next tile's first key
    int* s_wide = s_after + tiles;       // the wide windows' tiles
    int* s_zoff = s_wide + tiles;        // their zeros' exclusive prefix
    for (int m = threadIdx.x; m < tiles; m += kBackThreads) {
      s_bound[m] = __ldg(idx + min((m + 1) * kBackTile, n) - 1);
      s_after[m] = m + 1 < tiles ? __ldg(idx + (m + 1) * kBackTile) : -1;
    }
    __syncthreads();
    auto win_lo = [&](int m) { return m == 0 ? 0 : s_bound[m - 1] + 1; };
    auto win_hi = [&](int m) { return m == tiles - 1 ? n - 1 : s_bound[m]; };
    const int per = (tiles + kBackThreads - 1) / kBackThreads;  // thread t: tiles per t ... per t + per - 1
    int count = 0, zeros = 0;
    for (int q = 0; q < per; ++q) {
      const int m = threadIdx.x * per + q;
      if (m < tiles && win_hi(m) - win_lo(m) + 1 > kBackStage) {
        ++count;
        zeros += win_hi(m) - win_lo(m) + 1;
      }
    }
    int wide, total;
    int at = pf::block_exclusive_sum<kBackThreads>(count, s_isum, wide);
    int zoff = pf::block_exclusive_sum<kBackThreads>(zeros, s_isum, total);
    for (int q = 0; q < per; ++q) {
      const int m = threadIdx.x * per + q;
      if (m < tiles && win_hi(m) - win_lo(m) + 1 > kBackStage) {
        s_wide[at] = m;
        s_zoff[at++] = zoff;
        zoff += win_hi(m) - win_lo(m) + 1;
      }
    }
    if (threadIdx.x == 0) s_zoff[wide] = total;
    __syncthreads();
    const int z0 = static_cast<int>(static_cast<long long>(total) * h / helpers);
    const int z1 = static_cast<int>(static_cast<long long>(total) * (h + 1) / helpers);
    int w = 0;
    for (int top = wide; w < top;) {  // the first wide window whose zeros reach past z0
      const int mid = (w + top) / 2;
      if (s_zoff[mid + 1] > z0) {
        top = mid;
      } else {
        w = mid + 1;
      }
    }
    for (; w < wide && s_zoff[w] < z1; ++w) {
      const int m = s_wide[w];
      const int p0 = max(z0, s_zoff[w]);
      const int p1 = min(z1, s_zoff[w + 1]);
      const int src = win_lo(m) + p0 - s_zoff[w];
      const int keep = s_after[m] == s_bound[m] ? s_bound[m] : -1;
      for (int c = 0; c < d; ++c) {
        float* out = grad_src + static_cast<size_t>(c) * n;
        for (int e = threadIdx.x; e < p1 - p0; e += kBackThreads) {
          if (src + e != keep) out[src + e] = 0.0f;
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(helper_flag + h, mark);
    return;
  }

  const int tile = kSingle ? 0 : s_ticket - helpers;
  const int t0 = tile * kBackTile;
  const int base = t0 + threadIdx.x * kBackItems;
  const bool full = base + kBackItems <= n;

  // loads first: idx, planes 0 and 1, the keys either side of the tile
  int k[kBackItems];
  if (full && (reinterpret_cast<uintptr_t>(idx) & 15) == 0) {
    const int4* src = reinterpret_cast<const int4*>(idx + base);
#pragma unroll
    for (int q = 0; q < kBackItems / 4; ++q) {
      const int4 x = __ldg(src + q);
      k[4 * q] = x.x;
      k[4 * q + 1] = x.y;
      k[4 * q + 2] = x.z;
      k[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kBackItems; ++r) k[r] = base + r < n ? __ldg(idx + base + r) : kNoKey;
  }
  auto plane_vec = [&](int c) {
    return full && (reinterpret_cast<uintptr_t>(grad_out + static_cast<size_t>(c) * n) & 15) == 0;
  };
  float v[kBackItems], v_next[kBackItems];
  load16(grad_out, plane_vec(0), base, n, v);
  if (d > 1) load16(grad_out + n, plane_vec(1), base, n, v_next);
  s_first[threadIdx.x] = k[0];
  s_last[threadIdx.x] = k[kBackItems - 1];
  if (threadIdx.x == 0) {
    s_first[kBackThreads] = tile + 1 < tiles ? __ldg(idx + t0 + kBackTile) : -1;
    s_prev = tile > 0 ? __ldg(idx + t0 - 1) : -1;
  }
  __syncthreads();
  const int first = s_first[0];               // the tile's first run's key
  const int last = s_last[kBackThreads - 1];  // its last run's key (kNoKey past n)
  const int before = s_prev;                  // -1 for the first tile
  const int after = s_first[kBackThreads];    // -1 for the last tile
  const bool cross_left = before == first;    // the first run began in an earlier tile
  const bool cross_right = after == last;     // the last run goes on in a later tile
  const int lo = before + 1;                  // the window [lo, hi]
  const int hi = tile == tiles - 1 ? n - 1 : last;
  const int width = hi - lo + 1;
  const bool staged = width <= kBackStage;
  const int next = s_first[threadIdx.x + 1];  // the key after this thread's outputs
  const bool joins = threadIdx.x > 0 && k[0] == s_last[threadIdx.x - 1];
  if (!kSingle && !staged) {  // a wide window: the helpers zero it first, then the sums go straight out
    for (int h = threadIdx.x; h < helpers; h += kBackThreads) wait_flag(helper_flag + h, mark);
    __syncthreads();
  }

  // plane c's staged window, zeros included, in coalesced stores; a last key
  // that a later tile writes is left to it
  auto write_out = [&](int c) {
    if (!staged) return;
    const int skip = cross_right ? last - lo : -1;
    float* out = grad_src + static_cast<size_t>(c) * n + lo;
    for (int e = threadIdx.x; e < width; e += kBackThreads) {
      if (e != skip) out[e] = s_win[e];
    }
  };

  for (int c = 0; c < d; ++c) {
    if (c > 0) {  // plane c is in v_next; start plane c + 1's loads
      write_out(c - 1);
      __syncthreads();  // the window is free again
#pragma unroll
      for (int r = 0; r < kBackItems; ++r) v[r] = v_next[r];
      if (c + 1 < d) load16(grad_out + static_cast<size_t>(c + 1) * n, plane_vec(c + 1), base, n, v_next);
    }
    if (staged) {
      for (int e = threadIdx.x; e < width; e += kBackThreads) s_win[e] = 0.0f;
    }
    __syncthreads();
    // a run's sum, once it is complete: the tile's first and last runs are
    // published; a run that crosses a tile edge is written by the tile it
    // ends in; the rest land in the staged window, or straight out
    auto emit = [&](int key, double sum) {
      if (!kSingle) {
        if (key == first) sc.part[(static_cast<size_t>(c) * tiles + tile) * 2] = sum;
        if (key == last) sc.part[(static_cast<size_t>(c) * tiles + tile) * 2 + 1] = sum;
      }
      if ((key == first && cross_left) || (key == last && cross_right) || key >= n) return;
      if (staged) {
        s_win[key - lo] = static_cast<float>(sum);
      } else {
        grad_src[static_cast<size_t>(c) * n + key] = static_cast<float>(sum);
      }
    };
    // the thread's runs in output order: a run that starts and ends inside it
    // is complete; its first run (head) may continue an earlier thread's
    double acc = 0.0;
    double head = 0.0;
    bool closed = false;
#pragma unroll
    for (int r = 0; r < kBackItems - 1; ++r) {
      acc += static_cast<double>(v[r]);
      if (k[r + 1] != k[r]) {
        if (closed) {
          emit(k[r], acc);
        } else {
          head = acc;
          closed = true;
        }
        acc = 0.0;
      }
    }
    acc += static_cast<double>(v[kBackItems - 1]);  // the thread's last run (tail), so far
    const bool starts = closed || !joins;          // the tail begins in this thread
    bool any;
    const double carry = pf::block_segmented_prefix<kBackThreads>(starts, acc, s_head, s_sum, any);
    if (closed) emit(k[0], joins ? carry + head : head);
    // the tail ends here when the next key differs, and at the tile's end in
    // any case (where emit publishes it)
    if (next != k[kBackItems - 1] || threadIdx.x == kBackThreads - 1) {
      emit(k[kBackItems - 1], starts ? acc : carry + acc);
    }
    __syncthreads();
  }
  if (kSingle) {
    write_out(d - 1);
    return;
  }

  // publish the tile (its runs' keys and sums are in scratch), then write out
  if (threadIdx.x == 0) {
    sc.keys[3 * tile] = first;
    sc.keys[3 * tile + 1] = last;
    sc.keys[3 * tile + 2] = before;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(tile_flag + tile, mark);
  write_out(d - 1);
  if (!cross_left || (first == last && cross_right)) return;

  // The run that crosses into this tile ends here: its sum is its partials in
  // tile order, from the tile it began in (start) to this one. A tile between
  // them is that one run whole, and crossed into as well.
  auto continues = [&](int q) {  // tile q is the run whole and began before it
    const int f = __ldcg(sc.keys + 3 * q), l = __ldcg(sc.keys + 3 * q + 1), b = __ldcg(sc.keys + 3 * q + 2);
    return f == l && b == f;
  };
  if (threadIdx.x == 0) {
    wait_flag(tile_flag + tile - 1, mark);
    s_start = continues(tile - 1) ? -1 : tile - 1;
  }
  __syncthreads();
  for (int top = tile - 2; s_start < 0; top -= kBackThreads) {  // a long run: look back a block's width at a time
    const int q = top - static_cast<int>(threadIdx.x);
    bool stops = false;
    if (q >= 0) {
      wait_flag(tile_flag + q, mark);
      stops = !continues(q);  // tile 0 never continues
    }
    if (threadIdx.x == 0) s_min = kNoKey;
    __syncthreads();
    if (stops) atomicMin(&s_min, static_cast<int>(threadIdx.x));  // the nearest tile that stops
    __syncthreads();
    if (threadIdx.x == 0 && s_min != kNoKey) s_start = top - s_min;
    __syncthreads();
  }
  const int start = s_start;
  if (start + 1 == tile) {  // two tiles: a thread per plane
    for (int c = threadIdx.x; c < d; c += kBackThreads) {
      const double* pc = sc.part + static_cast<size_t>(c) * tiles * 2;
      grad_src[static_cast<size_t>(c) * n + first] =
          static_cast<float>(__ldcg(pc + 2 * start + 1) + __ldcg(pc + 2 * tile));
    }
    return;
  }
  for (int c = 0; c < d; ++c) {
    const double* pc = sc.part + static_cast<size_t>(c) * tiles * 2;
    // the whole tiles between, thread i taking start + 1 + i, + 256, ... in
    // order, then a fixed tree across the block
    double mid = 0.0;
    for (int q = start + 1 + static_cast<int>(threadIdx.x); q < tile; q += kBackThreads) mid += __ldcg(pc + 2 * q);
    for (int o = 16; o > 0; o >>= 1) mid += __shfl_xor_sync(0xffffffffu, mid, o);
    if (threadIdx.x % 32 == 0) s_mid[threadIdx.x / 32] = mid;
    __syncthreads();
    if (threadIdx.x == 0) {
      mid = 0.0;
      for (int w = 0; w < kBackThreads / 32; ++w) mid += s_mid[w];
      grad_src[static_cast<size_t>(c) * n + first] =
          static_cast<float>(__ldcg(pc + 2 * start + 1) + mid + __ldcg(pc + 2 * tile));
    }
    __syncthreads();
  }
}

}  // namespace

// int32 elements of scratch a call at n needs: the counts, then one start per
// output block.
extern "C" long long pf_expand_scratch(int n) { return static_cast<long long>(n) + (n + kOut - 1) / kOut; }

// int64 words of the look-back state; the caller zeroes it once and keeps it
// for the calls of one stream.
extern "C" long long pf_expand_state_words() { return kStateWords; }

// Launch both kernels on `stream` (PyTorch's current stream). probs is (n,), u one
// value, values and out (d, n), all float32; idx is (n,) int32; scratch holds
// pf_expand_scratch(n) int32 (16-byte aligned); state is the stream's look-back
// state. All device memory, allocated by the caller. Returns the first CUDA error
// as an int (0 on success).
extern "C" int pf_expand(const void* probs, const void* u, const void* values, void* out, void* idx,
                         void* scratch, void* state, int n, int d, void* stream) {
  if (n <= 0) return 0;
  if (n > kMaxTiles * kTile) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* counts = static_cast<int*>(scratch);
  auto* starts = counts + n;
  auto* st = static_cast<long long*>(state);
  scan_counts_kernel<<<(n + kTile - 1) / kTile, kScanThreads, 0, s>>>(
      static_cast<const float*>(probs), static_cast<const float*>(u), counts, starts, st, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<<<(n + kOut - 1) / kOut, kOutThreads, 0, s>>>(
      counts, starts, static_cast<const float*>(values), static_cast<float*>(out),
      static_cast<int*>(idx), st, n, d);
  return static_cast<int>(cudaGetLastError());
}

// int64 words of scratch the backward needs at (n, d): none for one tile, else
// per tile two float64 partials a plane and three int32 keys.
extern "C" long long pf_expand_backward_scratch(int n, int d) {
  const long long tiles = (static_cast<long long>(n) + kBackTile - 1) / kBackTile;
  if (tiles <= 1) return 0;
  return tiles * 2 * d + (tiles * 3 + 1) / 2;
}

// int64 words of the backward's device state (tickets, epoch, flags); the
// caller zeroes it once and keeps it for the calls of one stream.
extern "C" long long pf_expand_backward_state_words() { return kBackStateWords; }

// Launch the backward on `stream`: grad_out and grad_src are (d, n) float32, idx
// is (n,) int32 and monotone into [0, n); scratch holds
// pf_expand_backward_scratch(n, d) int64 words (may be null when that is 0),
// state is the stream's backward state. All device memory, allocated by the
// caller. Returns the first CUDA error as an int (0 on success).
extern "C" int pf_expand_backward(const void* grad_out, const void* idx, void* grad_src, void* scratch, void* state,
                                  int n, int d, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (n > kMaxBackTiles * kBackTile) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(grad_out);
  const auto* ix = static_cast<const int*>(idx);
  auto* out = static_cast<float*>(grad_src);
  const int tiles = (n + kBackTile - 1) / kBackTile;
  if (tiles == 1) {
    expand_backward_kernel<true><<<1, kBackThreads, sizeof(float) * n, s>>>(g, ix, out, BackScratch{}, nullptr, n,
                                                                             d, 1, 0);
    return static_cast<int>(cudaGetLastError());
  }
  BackScratch sc;
  sc.part = static_cast<double*>(scratch);
  sc.keys = reinterpret_cast<int*>(sc.part + static_cast<size_t>(2) * d * tiles);
  const int helpers = std::min(tiles, kBackHelpers);
  const int bytes = static_cast<int>(sizeof(int)) * std::max(kBackStage, 4 * tiles + 1);
  const cudaError_t err = cudaFuncSetAttribute(expand_backward_kernel<false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_backward_kernel<false><<<tiles + helpers, kBackThreads, bytes, s>>>(
      g, ix, out, sc, static_cast<long long*>(state), n, d, tiles, helpers);
  return static_cast<int>(cudaGetLastError());
}
