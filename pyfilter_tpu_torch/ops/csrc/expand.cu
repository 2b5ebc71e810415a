// Fused systematic resample + particle gather, hand-written for Hopper (sm_90a).
//
// Replaces pyfilter_tpu/ops/expand.py::_expand_kernel (the Pallas TPU kernel).
//
// What it computes. Input: monotone non-decreasing copy-count boundaries
// counts[0..n) (int32) and d value planes values[d][n] (float32, plane-major).
// For every output position i:
//     idx[i]       = #{ j < n-1 : counts[j] <= i }
//     out[c][i]    = values[c][idx[i]]
// which is counts inversion (scatter-add + cumsum) followed by a gather,
// bit for bit: the plain version in ops/expand.py::_expand_plain. The last
// boundary is never counted, so idx < n for any monotone input, pinned
// (counts[n-1] == n) or not.
//
// What bounds it. At n = 1e6, d = 1 the function must read counts and values
// and write out and idx: 16 MB, so its least time on an H100 SXM is
// 16 MB / 3.35 TB/s ~ 4.8 us (from the data sheet, not measured). It does a
// handful of integer compares per output, so it is memory-bound.
//
// What the design does about that bound. Each block owns 256 consecutive
// outputs (one per thread). Because counts is monotone, the block's sources
// form one window [lo, hi): lo = #{counts <= first output}, hi = #{counts <=
// last output}, found by one binary search each (two threads, L2-resident
// counts). When the window fits (always, unless the weights are
// degenerate), the block stages counts[lo:hi] in shared memory with
// coalesced loads and each thread binary-searches its own index there; when
// it does not fit (e.g. all mass on one particle), threads search global
// memory over [lo, hi) instead. No host decision and no fallback. The gather
// reads a narrow, monotone window of values, so neighbouring threads read
// neighbouring addresses, and both outputs are written coalesced: device
// memory traffic stays close to the 16 MB the bound counts, plus the window
// re-read. What remains above the bound is the latency of the two searches
// per block (TMA staging, persistent blocks and fusing the counts prep are
// later work).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;       // outputs per block, one per thread
constexpr int kWindowCap = 4096;  // count boundaries a block stages in shared memory (16 KB)

// First position p in [lo, hi) with c[p] > q (hi if none), for monotone c.
__device__ __forceinline__ int first_above(const int* __restrict__ c, int lo, int hi, int q) {
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

__global__ void __launch_bounds__(kBlock)
expand_kernel(const int* __restrict__ counts, const float* __restrict__ values,
              float* __restrict__ out, int* __restrict__ idx, int n, int d) {
  __shared__ int s_counts[kWindowCap];
  __shared__ int s_lo, s_hi;

  const int first = blockIdx.x * kBlock;
  const int last = min(first + kBlock, n) - 1;
  const int m = n - 1;  // boundaries that can be counted
  if (threadIdx.x == 0) s_lo = first_above(counts, 0, m, first);
  if (threadIdx.x == 32) s_hi = first_above(counts, 0, m, last);
  __syncthreads();
  const int lo = s_lo;
  const int w = s_hi - lo;
  const int i = first + threadIdx.x;

  int j;
  if (w <= kWindowCap) {  // uniform across the block: the barrier is safe
    for (int k = threadIdx.x; k < w; k += kBlock) s_counts[k] = counts[lo + k];
    __syncthreads();
    j = lo + first_above(s_counts, 0, w, i);
  } else {
    j = first_above(counts, lo, lo + w, i);
  }
  if (i > last) return;

  idx[i] = j;
  for (int c = 0; c < d; ++c) {
    const size_t plane = static_cast<size_t>(c) * n;
    out[plane + i] = values[plane + j];
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Pointers are device
// pointers; out and idx are allocated by the caller. Returns the launch's
// cudaGetLastError() as an int (0 on success).
extern "C" int pf_expand(const void* counts, const void* values, void* out, void* idx,
                         int n, int d, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  expand_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const float*>(values),
      static_cast<float*>(out), static_cast<int*>(idx), n, d);
  return static_cast<int>(cudaGetLastError());
}
