// Lane-batched fused systematic resample + particle gather, hand-written for
// Hopper (sm_90a).
//
// Replaces both lane kernels of the JAX package's Pallas TPU code:
//   pyfilter_tpu/ops/expand.py::_expand_lane_block_kernel  (every source row scanned)
//   pyfilter_tpu/ops/expand.py::_expand_lane_band_kernel   (a 64/128-row source band,
//                                                          falling back to the former)
// Both compute the same function; the band, its stride-8 tables, its host-visible
// fit flag and its lax.cond tiers are TPU (VMEM, vector-unit) artifacts and are not
// carried over. One kernel here takes every monotone input.
//
// What it computes. Inputs: per-lane monotone non-decreasing copy-count boundaries
// counts[l][0..n) (int32, lanes leading: each lane's boundaries are one contiguous
// row, which is what copy_counts produces and what a per-lane search wants), and d
// value planes values[c][i][l] (float32, particle-major and lanes contiguous: the
// package's (N, L) layout, so no transpose feeds the kernel). For every lane l and
// output position i:
//     idx[i][l]    = #{ j < n-1 : counts[l][j] <= i }
//     out[c][i][l] = values[c][idx[i][l]][l]
// which is counts inversion (scatter-add + cumsum) followed by a gather, bit for
// bit: the plain version in ops/expand.py::_expand_lanes_plain. The last boundary
// is never counted, so idx < n for any monotone input, pinned (counts[l][n-1] == n)
// or not.
//
// What bounds it. At n = 400, L = 1000, d = 2 (the SMC^2 main path) the function
// must read counts (4 B) and values (8 B) and write values (8 B) and idx (4 B) for
// each of the 4e5 (particle, lane) pairs: 9.6 MB, so its least time on an H100 SXM
// is 9.6 MB / 3.35 TB/s ~ 2.9 us (from the data sheet, not measured), below a
// kernel launch's own latency. It does a few integer compares per output, so it is
// memory-bound.
//
// What the design does about the bytes. A block owns a tile of 32 lanes x 64
// outputs; its 256 threads are 8 rows of one warp each, and a warp's 32 threads
// always touch 32 neighbouring lanes, so every idx and out store, and every value
// load whose sources coincide across lanes, is one 128-byte row. Counts are
// monotone, so the sources of lane l's 64 outputs form one window [lo_l, hi_l],
// found by one binary search per lane for each end (warps 0 and 1); each thread
// then binary-searches its own outputs inside its lane's window. The window is
// narrow for healthy weights and wide for a degenerate lane (all mass on one
// particle, long zero-copy runs) or after particle doublings at large n: either
// way the search stays in the kernel, over the L2-resident counts row, with no
// host decision and no fallback. Staging windows in shared memory, fusing the
// counts prep (cumsum, ceil, running max, pin) into the launch and making the
// gather's loads wider are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;       // lanes per block: one warp across
constexpr int kRows = 8;         // warps per block
constexpr int kOutputs = 64;     // outputs per block; each thread takes kOutputs / kRows

// First position p in [lo, hi) with c[p] > q (hi if none), for monotone c.
__device__ __forceinline__ int first_above(const int* __restrict__ c, int lo, int hi, int q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(c + mid) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kLanes * kRows)
expand_lanes_kernel(const int* __restrict__ counts, const float* __restrict__ values,
                    float* __restrict__ out, int* __restrict__ idx, int n, int n_lanes, int d,
                    int lane_tiles) {
  __shared__ int s_lo[kLanes];
  __shared__ int s_hi[kLanes];

  const int lane_tile = blockIdx.x % lane_tiles;
  const int out_tile = blockIdx.x / lane_tiles;
  const int l = lane_tile * kLanes + threadIdx.x;
  const int first = out_tile * kOutputs;
  const int last = min(first + kOutputs, n) - 1;
  const int m = n - 1;  // boundaries that can be counted
  const bool lane_ok = l < n_lanes;
  const int* __restrict__ row = counts + static_cast<size_t>(lane_ok ? l : 0) * n;

  if (threadIdx.y == 0) s_lo[threadIdx.x] = lane_ok ? first_above(row, 0, m, first) : 0;
  if (threadIdx.y == 1) s_hi[threadIdx.x] = lane_ok ? first_above(row, 0, m, last) : 0;
  __syncthreads();
  if (!lane_ok) return;
  const int lo = s_lo[threadIdx.x];
  const int hi = s_hi[threadIdx.x];

  const size_t plane = static_cast<size_t>(n) * n_lanes;
  for (int i = first + threadIdx.y; i <= last; i += kRows) {
    const int j = first_above(row, lo, hi, i);  // in [lo, hi]
    const size_t at = static_cast<size_t>(i) * n_lanes + l;
    const size_t src = static_cast<size_t>(j) * n_lanes + l;
    idx[at] = j;
    for (int c = 0; c < d; ++c) out[c * plane + at] = __ldg(values + c * plane + src);
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). counts is (n_lanes, n) int32,
// values and out are (d, n, n_lanes) float32, idx is (n, n_lanes) int32, all
// contiguous device memory; out and idx are allocated by the caller. Returns the
// launch's cudaGetLastError() as an int (0 on success).
extern "C" int pf_expand_lanes(const void* counts, const void* values, void* out, void* idx,
                               int n, int n_lanes, int d, void* stream) {
  if (n <= 0 || n_lanes <= 0) return 0;
  const int lane_tiles = (n_lanes + kLanes - 1) / kLanes;
  const int out_tiles = (n + kOutputs - 1) / kOutputs;
  const dim3 block(kLanes, kRows);
  expand_lanes_kernel<<<lane_tiles * out_tiles, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const float*>(values),
      static_cast<float*>(out), static_cast<int*>(idx), n, n_lanes, d, lane_tiles);
  return static_cast<int>(cudaGetLastError());
}
