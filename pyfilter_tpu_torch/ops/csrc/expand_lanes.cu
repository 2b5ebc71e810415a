// Lane-batched fused systematic resample + particle gather, hand-written for
// Hopper (sm_90a): copy-count prep and expansion in one launch.
//
// Replaces both lane kernels of the JAX package's Pallas TPU code, and the
// counts prep (cumulative sum, ceil, clamp, pin) that feeds them:
//   pyfilter_tpu/ops/expand.py::_expand_lane_block_kernel  (every source row scanned)
//   pyfilter_tpu/ops/expand.py::_expand_lane_band_kernel   (a 64/128-row source band,
//                                                          falling back to the former)
// Both compute the same function; the band, its stride-8 tables, its host-visible
// fit flag and its lax.cond tiers are TPU (VMEM, vector-unit) artifacts and are not
// carried over. One kernel here takes every input and every n.
//
// What it computes. Inputs: probabilities probs[i][l] (float32, (n, L): particles
// leading, lanes contiguous, the package's layout, read with no transpose), one
// uniform u[l] per lane (float32, read on the device: no host sync), and d value
// planes values[c][i][l] (float32, (d, n, L)). Per lane, the copy-count boundaries
// counts[j] of fixed_counts.cuh (the exact fixed-point prefix sum of
// ops/resample.py::copy_counts), then for every output position i:
//     idx[i][l]    = #{ j < n-1 : counts[j] <= i }
//     out[c][i][l] = values[c][idx[i][l]][l]
// bit for bit the plain version, ops/expand.py::_expand_lanes_probs_plain.
//
// What bounds it. At n = 400, L = 1000, d = 2 (the SMC^2 main path) the function
// must read probs (4 B) and values (8 B) and write values (8 B) and idx (4 B) for
// each of the 4e5 (particle, lane) pairs: 9.6 MB, so its least time on an H100 SXM
// (3.35 TB/s, data sheet, 700 W) is about 2.9 us, below a kernel launch's own
// latency. The work per element is an int64 add, two conversions and a few
// compares: memory-bound. There is no product, so tensor cores have no role.
//
// What the design does about it.
// - A block owns kLanes = 8 lanes (one 32-byte sector of a row) and ALL n
//   particles of them, so the prefix sum never leaves the block: 125 blocks at
//   L = 1000 fill the 132 SMs in one wave, where 32-lane tiles would give 32.
// - Its 512 threads are 64 row chunks x 8 lanes; a warp spans 4 chunks x 8 lanes,
//   so every load of probs and every store of idx and out touches whole sectors.
// - Every pass takes its rows kBatch = 8 at a time, loads first, so a thread
//   waits for one memory round trip per 8 rows, not one per row.
// - Pass 1: each thread reads its chunk of one lane's probabilities, stages them
//   in shared memory as c[j][lane] (the bank is the lane, whatever row a thread
//   touches) and sums their fixed-point values. The chunk totals cross chunks
//   through shared memory; integer sums make the order free.
// - Pass 2: each thread re-walks its chunk and overwrites each probability with
//   its copy count.
// - Pass 3: each thread writes the outputs of its own chunk of positions: one
//   binary search for the first source, then a merge walk (a bounded linear
//   step, a search again past a long zero-copy run). The sources of 8 outputs
//   are found first, then their gathers from 2 planes are issued together.
// - Counts of up to kSharedRows rows per lane live in shared memory (up to
//   222 KB a block); past that the C entry point, by shape, gives the kernel a
//   global scratch buffer of the same layout. No host decision by data, no
//   fallback.
//
// What stops it short of the bound (times in PERF.md, section 6): each thread's
// passes are chains of dependent steps (the carry over 64 chunks, a search and a
// merge in shared memory, one gather round trip per 8 outputs), hidden by only
// one block of 16 warps per SM, and the bound itself is below a launch's
// latency. Not done yet: TMA or cp.async staging, and more than one block per
// lane tile for large n (a cluster passing carries through distributed shared
// memory).
//
// The backward (pf_expand_lanes_backward, launched by the autograd function
// around ops/expand.py::fused_expand_lanes): the transpose of the gather, lane
// by lane,
//     grad_src[c][j][l] = sum of grad_out[c][i][l] over the i with idx[i][l] = j,
// the scatter-add that JAX's autodiff derives (the port's own kernel; the JAX
// package has none). Each lane's ancestors are monotone, so source j's outputs
// are one contiguous run of rows: one thread per (source, lane) finds it by two
// binary searches down the lane's column of idx (neighbouring threads are
// neighbouring lanes, so a warp's probes of one row share sectors while their
// searches agree) and sums it in row order in float64, rounding once. Every
// (source, lane) is written exactly once, zero-copy sources as 0: no atomics,
// the same bits at every launch. A run as long as n (a degenerate lane) is
// summed serially by its thread; its time is recorded in PERF.md (section 6).
// Bound: read grad_out (4 d n L bytes) and idx (4 n L), write grad_src
// (4 d n L): 8 MB at n = 400, L = 1000, d = 2, 2.4 us on an H100 SXM.

#include <cuda_runtime.h>

#include <cstddef>

#include "fixed_counts.cuh"

namespace {

constexpr int kLanes = 8;                    // lanes per block: one 32-byte sector of a row
constexpr int kChunks = 64;                  // row chunks per block
constexpr int kThreads = kLanes * kChunks;   // one thread per (chunk, lane)
constexpr int kSharedRows = 7104;            // 7104 rows x 8 lanes x 4 B = 222 KB of counts
constexpr int kWalk = 8;                     // merge steps before a search
constexpr int kBatch = 8;                    // rows (or outputs) whose loads are in flight together
constexpr int kPlanes = 2;                   // value planes gathered together

// First row p in [lo, hi) with c[p][lane] > q (hi if none), for monotone c.
__device__ __forceinline__ int first_above(const int* c, int lane, int lo, int hi, int q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (c[mid * kLanes + lane] <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
expand_lanes_kernel(const float* __restrict__ probs, const float* __restrict__ u,
                    const float* __restrict__ values, float* __restrict__ out,
                    int* __restrict__ idx, int* __restrict__ scratch, int n, int n_lanes, int d) {
  extern __shared__ int s_dyn[];
  __shared__ long long s_total[kChunks][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int chunk = threadIdx.x / kLanes;
  const int l = blockIdx.x * kLanes + lane;
  const bool lane_ok = l < n_lanes;
  // c[j * kLanes + lane]: the probability of row j, then its copy count
  int* c = kShared ? s_dyn : scratch + static_cast<size_t>(blockIdx.x) * n * kLanes;
  const int rows = (n + kChunks - 1) / kChunks;
  const int r0 = min(chunk * rows, n);
  const int r1 = min(r0 + rows, n);

  // pass 1: stage the chunk's probabilities, sum their fixed-point values;
  // kBatch rows' loads in flight at once
  long long total = 0;
  if (lane_ok) {
    for (int j0 = r0; j0 < r1; j0 += kBatch) {
      float p[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        p[b] = j0 + b < r1 ? __ldg(probs + static_cast<size_t>(j0 + b) * n_lanes + l) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j0 + b < r1) c[(j0 + b) * kLanes + lane] = __float_as_int(p[b]);
        total += pf::fixed_q(p[b]);
      }
    }
  }
  s_total[chunk][lane] = total;
  __syncthreads();

  // pass 2: the chunk's carry, then its copy counts in place
  long long s = 0;
#pragma unroll 8
  for (int k = 0; k < chunk; ++k) s += s_total[k][lane];
  const float ul = lane_ok ? __ldg(u + l) : 0.0f;
  if (lane_ok) {
    for (int j0 = r0; j0 < r1; j0 += kBatch) {
      long long q[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) q[b] = j0 + b < r1 ? pf::fixed_q(__int_as_float(c[(j0 + b) * kLanes + lane])) : 0;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        s += q[b];
        if (j0 + b < r1) c[(j0 + b) * kLanes + lane] = pf::copy_count(s, j0 + b, n, ul);
      }
    }
  }
  __syncthreads();
  if (!lane_ok || r0 >= r1) return;

  // pass 3: the chunk's output positions, each from the first source whose
  // boundary exceeds it (the last source, n - 1, if none before it does);
  // kBatch outputs' sources first, then their gathers, all in flight at once
  const int m = n - 1;
  const size_t plane = static_cast<size_t>(n) * n_lanes;
  int j = first_above(c, lane, 0, m, r0);
  for (int i0 = r0; i0 < r1; i0 += kBatch) {
    int src[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b;
      if (i < r1) {
        for (int step = 0; j < m && c[j * kLanes + lane] <= i; ++step) {
          if (step == kWalk) {
            j = first_above(c, lane, j, m, i);
            break;
          }
          ++j;
        }
        src[b] = j;
        idx[static_cast<size_t>(i) * n_lanes + l] = j;
      }
    }
    for (int k0 = 0; k0 < d; k0 += kPlanes) {
      float v[kPlanes][kBatch];
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) {
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k0 + k < d && i0 + b < r1) {
            v[k][b] = __ldg(values + (k0 + k) * plane + static_cast<size_t>(src[b]) * n_lanes + l);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) {
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k0 + k < d && i0 + b < r1) out[(k0 + k) * plane + static_cast<size_t>(i0 + b) * n_lanes + l] = v[k][b];
        }
      }
    }
  }
}

constexpr int kBackThreads = 256;

// First row p in [lo, hi) with c[p * stride] > q (hi if none), for monotone c.
__device__ __forceinline__ int first_above_strided(const int* c, int stride, int lo, int hi, int q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(c + static_cast<size_t>(mid) * stride) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kBackThreads)
expand_lanes_backward_kernel(const float* __restrict__ grad_out, const int* __restrict__ idx,
                             float* __restrict__ grad_src, int n, int n_lanes, int d) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kBackThreads + threadIdx.x;  // j * n_lanes + l
  const size_t plane = static_cast<size_t>(n) * n_lanes;
  if (t >= plane) return;
  const int l = static_cast<int>(t % n_lanes);
  const int j = static_cast<int>(t / n_lanes);
  const int* col = idx + l;
  const int lo = first_above_strided(col, n_lanes, 0, n, j - 1);
  const int hi = first_above_strided(col, n_lanes, lo, n, j);
  for (int k = 0; k < d; ++k) {
    const float* g = grad_out + k * plane + l;
    double sum = 0.0;
    for (int i = lo; i < hi; ++i) sum += static_cast<double>(__ldg(g + static_cast<size_t>(i) * n_lanes));
    grad_src[k * plane + t] = static_cast<float>(sum);
  }
}

}  // namespace

// int32 elements of global scratch a launch at (n, n_lanes) needs: 0 while a
// lane tile's counts fit in shared memory, else one (n, kLanes) slab per tile.
extern "C" long long pf_expand_lanes_scratch(int n, int n_lanes) {
  if (n <= kSharedRows) return 0;
  const long long tiles = (n_lanes + kLanes - 1) / kLanes;
  return tiles * n * kLanes;
}

// Launch on `stream` (PyTorch's current stream). probs is (n, n_lanes), u is
// (n_lanes,), values and out are (d, n, n_lanes), all float32; idx is (n, n_lanes)
// int32; scratch holds pf_expand_lanes_scratch(n, n_lanes) int32 elements (may be
// null when that is 0). All contiguous device memory, allocated by the caller.
// Returns the first CUDA error as an int (0 on success).
extern "C" int pf_expand_lanes(const void* probs, const void* u, const void* values, void* out,
                               void* idx, void* scratch, int n, int n_lanes, int d, void* stream) {
  if (n <= 0 || n_lanes <= 0) return 0;
  const int tiles = (n_lanes + kLanes - 1) / kLanes;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(probs);
  const auto* uu = static_cast<const float*>(u);
  const auto* v = static_cast<const float*>(values);
  auto* o = static_cast<float*>(out);
  auto* ix = static_cast<int*>(idx);
  if (n <= kSharedRows) {
    const size_t bytes = static_cast<size_t>(n) * kLanes * sizeof(int);
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          expand_lanes_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSharedRows * kLanes * static_cast<int>(sizeof(int)));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    expand_lanes_kernel<true><<<tiles, kThreads, bytes, s>>>(p, uu, v, o, ix, nullptr, n, n_lanes, d);
  } else {
    expand_lanes_kernel<false><<<tiles, kThreads, 0, s>>>(p, uu, v, o, ix, static_cast<int*>(scratch),
                                                          n, n_lanes, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the backward on `stream`: grad_out and grad_src are (d, n, n_lanes)
// float32, idx is (n, n_lanes) int32 with every lane's column monotone (the
// forward's indices). All contiguous device memory, allocated by the caller.
// Returns the CUDA error of the launch as an int (0 on success).
extern "C" int pf_expand_lanes_backward(const void* grad_out, const void* idx, void* grad_src, int n, int n_lanes,
                                        int d, void* stream) {
  if (n <= 0 || n_lanes <= 0) return 0;
  const long long total = static_cast<long long>(n) * n_lanes;
  const long long blocks = (total + kBackThreads - 1) / kBackThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  expand_lanes_backward_kernel<<<static_cast<unsigned>(blocks), kBackThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_out), static_cast<const int*>(idx), static_cast<float*>(grad_src), n, n_lanes,
      d);
  return static_cast<int>(cudaGetLastError());
}
