// Segmented scans in a fixed order for the backward kernels (expand.cu,
// expand_lanes.cu): sums of float64 partials that restart at each head, built
// from warp shuffles and shared memory only, never atomics, so their grouping
// depends on the shapes alone and the same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>

namespace pf {

// Inclusive segmented scan across a warp of (head, v): v becomes the sum of v
// over the lanes since the last lane with head set (inclusive), head whether
// any lane up to this one had it.
__device__ __forceinline__ void warp_segmented_scan(bool& head, double& v) {
  const int lane = threadIdx.x % 32;
  for (int o = 1; o < 32; o <<= 1) {
    const double vu = __shfl_up_sync(0xffffffffu, v, o);
    const int hu = __shfl_up_sync(0xffffffffu, static_cast<int>(head), o);
    if (lane >= o) {
      if (!head) v = vu + v;
      head = head || hu;
    }
  }
}

// The exclusive segmented prefix of (head, v) in thread order across a block of
// kThreads: the sum of v over the threads before this one since the last with
// head set, and in `any` whether one of them had it. s_head and s_sum hold
// kThreads / 32 entries in shared memory. Every thread of the block must call it.
template <int kThreads>
__device__ double block_segmented_prefix(bool head, double v, bool* s_head, double* s_sum, bool& any) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  warp_segmented_scan(head, v);
  if (lane == 31) {
    s_head[warp] = head;
    s_sum[warp] = v;
  }
  const double vx = __shfl_up_sync(0xffffffffu, v, 1);
  const int hx = __shfl_up_sync(0xffffffffu, static_cast<int>(head), 1);
  __syncthreads();
  double p = 0.0;
  bool hp = false;
  for (int w = 0; w < warp; ++w) {
    p = s_head[w] ? s_sum[w] : p + s_sum[w];
    hp = hp || s_head[w];
  }
  __syncthreads();  // the next call overwrites s_head and s_sum
  if (lane == 0) {
    any = hp;
    return p;
  }
  any = hp || hx;
  return hx ? vx : p + vx;
}

// The exclusive prefix sum of an int across a block of kThreads, and the
// block's total in `total`. s_sum holds kThreads / 32 ints in shared memory.
template <int kThreads>
__device__ int block_exclusive_sum(int v, int* s_sum, int& total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_sum[warp] = incl;
  __syncthreads();
  int before = incl - v;
  total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += s_sum[w];
    total += s_sum[w];
  }
  __syncthreads();
  return before;
}

}  // namespace pf
