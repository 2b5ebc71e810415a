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
// has no kernel for it; this is the port's own). Systematic ancestors are
// monotone, so the outputs of source j are one contiguous run [lo, hi) of idx:
// one thread per source finds it by two binary searches in idx and sums it in
// output order in float64, rounding once to float32. Every source is written
// exactly once (a zero-copy source as 0): no atomics, so the result is the same
// bits at every launch, and within 1e-6 of the run's sum of |g| of a float64
// sum. A run can be as long as n (all the mass on one particle); such a run is
// summed serially by its one thread, and its time is recorded in PERF.md
// (section 6) rather than split. Bound: it must read grad_out (4 d n bytes) and
// idx (4 n) and write grad_src (4 d n): 12 MB at n = 1e6, d = 1, 3.6 us on an
// H100 SXM (3.35 TB/s); the searches' reads of idx (log2 n each) mostly hit L2.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fixed_counts.cuh"

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

__global__ void __launch_bounds__(kBackThreads)
expand_backward_kernel(const float* __restrict__ grad_out, const int* __restrict__ idx,
                       float* __restrict__ grad_src, int n, int d) {
  const int j = blockIdx.x * kBackThreads + threadIdx.x;
  if (j >= n) return;
  // source j's outputs: [first i with idx[i] >= j, first i with idx[i] > j)
  const int lo = first_above(idx, 0, n, j - 1);
  const int hi = first_above(idx, lo, n, j);
  for (int k = 0; k < d; ++k) {
    const float* g = grad_out + static_cast<size_t>(k) * n;
    double sum = 0.0;
    for (int i = lo; i < hi; ++i) sum += static_cast<double>(__ldg(g + i));
    grad_src[static_cast<size_t>(k) * n + j] = static_cast<float>(sum);
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

// Launch the backward on `stream`: grad_out and grad_src are (d, n) float32, idx
// is (n,) int32 and monotone (the forward's indices). All device memory,
// allocated by the caller. Returns the CUDA error of the launch as an int (0 on
// success).
extern "C" int pf_expand_backward(const void* grad_out, const void* idx, void* grad_src, int n, int d,
                                  void* stream) {
  if (n <= 0) return 0;
  expand_backward_kernel<<<(n + kBackThreads - 1) / kBackThreads, kBackThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_out), static_cast<const int*>(idx), static_cast<float*>(grad_src), n, d);
  return static_cast<int>(cudaGetLastError());
}
