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
// package has none), for any idx whose every column is monotone into [0, n):
// source j's outputs are one contiguous run of rows. Every (source, lane) is
// written exactly once, a zero-copy source as 0.
//
// What bounds it. Read grad_out (4 d n L bytes) and idx (4 n L), write
// grad_src (4 d n L): 8 MB at n = 400, L = 1000, d = 2, 2.4 us on an H100 SXM,
// below a launch's own latency. One float64 add an output: memory-bound. The
// same rules as the single-lane backward (expand.cu): the same bits at every
// launch, float64 sums in an order fixed by the shapes alone, no host decision
// by data.
//
// What the design does about it: the forward's layout. A block owns kLanes = 8
// lanes (one 32-byte sector of a row) and all n rows, so it owns every source of
// its lanes: no search, no scratch, no second kernel, no state across blocks
// (125 blocks at L = 1000, one wave).
// - Its 512 threads are 64 row chunks x 8 lanes, as in the forward; each thread
//   reads its chunk of one lane's idx and of up to kBackPlanes planes of
//   grad_out, kBatch rows' loads in flight at once, whole sectors per warp, so
//   one read of idx serves the planes of a group.
// - It sums the runs of its chunk serially in row order in float64; a run that
//   starts and ends inside the chunk is complete. The chunk's first and last
//   runs go to shared memory; one warp per lane combines them across the 64
//   chunks in chunk order by a segmented scan of shuffles, so a degenerate
//   lane's run of n is 64 partials, not n serial adds.
// - The sums land in a shared-memory copy of the group's planes (zeroed
//   first, so every zero-copy source is written too), which the block then
//   writes row by row in whole sectors. Past kBackStageBytes of planes (n
//   above 5760 for one plane) the sums go to grad_src directly after the
//   block has zeroed its lanes there; the C entry point chooses by shape.
//
// What stops it short of the bound (times in PERF.md, section 6): a launch's
// latency is most of it at these sizes; then the chain of one chunk's loads,
// its serial adds, two barriers and the write-out, with one block of 16 warps
// per SM.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "fixed_counts.cuh"
#include "segmented_scan.cuh"

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

constexpr int kBackPlanes = 4;               // planes summed together: one read of idx serves them
constexpr int kBackStageBytes = 180 * 1024;  // a group's planes staged in shared memory, at most
constexpr int kStaticBytes = 2 * kChunks * kLanes * sizeof(int);       // each chunk's two keys
constexpr int kRecordBytes = 2 * kChunks * kLanes * sizeof(double);    // a plane's two sums a chunk

// One block per kLanes lanes, planes [c0, c0 + group) at a time. kStaged: the
// sums land in s_out[plane][row][lane] and are written out at the end;
// otherwise straight into grad_src.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
expand_lanes_backward_kernel(const float* __restrict__ grad_out, const int* __restrict__ idx,
                             float* __restrict__ grad_src, int n, int n_lanes, int d, int group) {
  extern __shared__ double s_back[];
  __shared__ int s_first[kChunks][kLanes];  // each chunk's first and last key (-1: no rows)
  __shared__ int s_last[kChunks][kLanes];
  // dynamic: each chunk's first and last runs' sums [group][kChunks][kLanes],
  // then (kStaged) the group's planes s_out[group][n][kLanes]
  double* s_head = s_back;
  double* s_tail = s_head + group * kChunks * kLanes;
  float* s_out = reinterpret_cast<float*>(s_tail + group * kChunks * kLanes);

  const int lane = threadIdx.x % kLanes;
  const int chunk = threadIdx.x / kLanes;
  const int l0 = blockIdx.x * kLanes;
  const bool lane_ok = l0 + lane < n_lanes;
  const int rows = (n + kChunks - 1) / kChunks;
  const int r0 = min(chunk * rows, n);
  const int r1 = min(r0 + rows, n);
  const size_t plane = static_cast<size_t>(n) * n_lanes;
  const int span = n * kLanes;  // one staged plane

  for (int c0 = 0; c0 < d; c0 += group) {
    const int gp = min(group, d - c0);
    // kBatch rows of the chunk, loads only: the first batch's are in flight
    // while the block zeroes the group's outputs
    int key[kBatch];
    float v[kBackPlanes][kBatch];
    auto load = [&](int j0) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool ok = lane_ok && j0 + b < r1;
        const size_t at = static_cast<size_t>(j0 + b) * n_lanes + l0 + lane;
        key[b] = ok ? __ldg(idx + at) : -1;
#pragma unroll
        for (int k = 0; k < kBackPlanes; ++k) v[k][b] = ok && k < gp ? __ldg(grad_out + (c0 + k) * plane + at) : 0.0f;
      }
    };
    load(r0);
    // every (source, lane) of the group starts at 0
    for (int e = threadIdx.x; e < gp * span; e += kThreads) {
      if (kStaged) {
        s_out[e] = 0.0f;
      } else {
        const int ln = e % kLanes;
        if (l0 + ln < n_lanes) {
          grad_src[(c0 + e / span) * plane + static_cast<size_t>(e % span / kLanes) * n_lanes + l0 + ln] = 0.0f;
        }
      }
    }
    __syncthreads();
    // a complete run's sum: plane c0 + k, source src, block lane ln
    auto put = [&](int k, int src, int ln, double sum) {
      if (kStaged) {
        s_out[k * span + src * kLanes + ln] = static_cast<float>(sum);
      } else {
        grad_src[(c0 + k) * plane + static_cast<size_t>(src) * n_lanes + l0 + ln] = static_cast<float>(sum);
      }
    };

    // pass 1: the chunk's runs in row order
    int first = -1, cur = -1;
    bool closed = false;
    double acc[kBackPlanes], head[kBackPlanes];
#pragma unroll
    for (int k = 0; k < kBackPlanes; ++k) acc[k] = head[k] = 0.0;
    for (int j0 = r0; j0 < r1; j0 += kBatch) {
      if (j0 > r0) load(j0);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (key[b] >= 0) {
          if (key[b] != cur) {
            if (cur < 0) {
              first = key[b];
            } else if (closed) {
#pragma unroll
              for (int k = 0; k < kBackPlanes; ++k) {
                if (k < gp) put(k, cur, lane, acc[k]);
              }
            } else {
#pragma unroll
              for (int k = 0; k < kBackPlanes; ++k) head[k] = acc[k];
              closed = true;
            }
            cur = key[b];
#pragma unroll
            for (int k = 0; k < kBackPlanes; ++k) acc[k] = 0.0;
          }
#pragma unroll
          for (int k = 0; k < kBackPlanes; ++k) acc[k] += static_cast<double>(v[k][b]);
        }
      }
    }
    s_first[chunk][lane] = first;
    s_last[chunk][lane] = cur;
#pragma unroll
    for (int k = 0; k < kBackPlanes; ++k) {
      if (k < gp) {
        s_head[(k * kChunks + chunk) * kLanes + lane] = closed ? head[k] : acc[k];
        s_tail[(k * kChunks + chunk) * kLanes + lane] = acc[k];
      }
    }
    __syncthreads();

    // the first and last runs of each chunk, across the chunks: warp w takes
    // lane w, its thread t chunks 2t and 2t + 1. A chunk's last run carries
    // the sum of the chunks before it while each is that one run whole.
    const int warp = threadIdx.x / 32;
    const int t = threadIdx.x % 32;
    if (warp < kLanes && l0 + warp < n_lanes) {
      const int ln = warp;
      int f[2], z[2];
      bool cont[2], whole[2], restart[2], ends[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        f[q] = s_first[2 * t + q][ln];
        z[q] = s_last[2 * t + q][ln];
      }
      const int before = t > 0 ? s_last[2 * t - 1][ln] : -1;
      const int after = t < 31 ? s_first[2 * t + 2][ln] : -1;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        cont[q] = f[q] >= 0 && f[q] == (q == 0 ? before : z[0]);
        whole[q] = f[q] >= 0 && f[q] == z[q];
        restart[q] = !(whole[q] && cont[q]);
        ends[q] = f[q] >= 0 && (q == 0 ? f[1] : after) != z[q];
      }
      for (int k = 0; k < gp; ++k) {
        double tail[2], sum = 0.0;
        bool any = false;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          tail[q] = s_tail[(k * kChunks + 2 * t + q) * kLanes + ln];
          sum = restart[q] ? tail[q] : sum + tail[q];
          any = any || restart[q];
        }
        bool hx = any;
        double vx = sum;
        pf::warp_segmented_scan(hx, vx);
        const double up = __shfl_up_sync(0xffffffffu, vx, 1);
        double carry = t > 0 ? up : 0.0;  // the carry of chunk 2t - 1's last run
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const double into = carry;  // the carry of the chunk before
          carry = restart[q] ? tail[q] : carry + tail[q];
          if (ends[q]) put(k, z[q], ln, carry);
          if (f[q] >= 0 && !whole[q]) {
            const double h = s_head[(k * kChunks + 2 * t + q) * kLanes + ln];
            put(k, f[q], ln, cont[q] ? into + h : h);
          }
        }
      }
    }
    __syncthreads();
    if (kStaged) {  // the group's planes, row by row in whole sectors
      for (int e = threadIdx.x; e < gp * span; e += kThreads) {
        const int ln = e % kLanes;
        if (l0 + ln < n_lanes) {
          grad_src[(c0 + e / span) * plane + static_cast<size_t>(e % span / kLanes) * n_lanes + l0 + ln] = s_out[e];
        }
      }
      __syncthreads();
    }
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
// float32, idx is (n, n_lanes) int32 with every lane's column monotone into
// [0, n). All contiguous device memory, allocated by the caller. Returns the
// first CUDA error as an int (0 on success).
extern "C" int pf_expand_lanes_backward(const void* grad_out, const void* idx, void* grad_src, int n, int n_lanes,
                                        int d, void* stream) {
  if (n <= 0 || n_lanes <= 0 || d <= 0) return 0;
  const int tiles = (n_lanes + kLanes - 1) / kLanes;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(grad_out);
  const auto* ix = static_cast<const int*>(idx);
  auto* out = static_cast<float*>(grad_src);
  // planes staged together: as many as fit in kBackStageBytes, at most kBackPlanes
  const long long plane_bytes = static_cast<long long>(n) * kLanes * sizeof(float);
  const int fit = static_cast<int>(std::min<long long>(kBackStageBytes / plane_bytes, kBackPlanes));
  const bool staged = fit >= 1;
  const int group = std::min(d, staged ? fit : kBackPlanes);
  const size_t bytes = static_cast<size_t>(group) * (kRecordBytes + (staged ? plane_bytes : 0));
  if (bytes + kStaticBytes > 48 * 1024) {  // past the default, static and dynamic together
    const cudaError_t err = cudaFuncSetAttribute(staged ? expand_lanes_backward_kernel<true>
                                                        : expand_lanes_backward_kernel<false>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (staged) {
    expand_lanes_backward_kernel<true><<<tiles, kThreads, bytes, s>>>(g, ix, out, n, n_lanes, d, group);
  } else {
    expand_lanes_backward_kernel<false><<<tiles, kThreads, bytes, s>>>(g, ix, out, n, n_lanes, d, group);
  }
  return static_cast<int>(cudaGetLastError());
}
