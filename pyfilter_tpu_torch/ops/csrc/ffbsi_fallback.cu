// Rejection FFBSi's exact fallback, hand-written for Hopper (sm_90a): the exact
// backward-kernel draw for every target that failed all rejection rounds of a
// backward step, in one C call (two kernels on one stream).
//
// Replaces no Pallas kernel. The JAX package finishes the failed slots of
// pyfilter_tpu/filters/particle/smoothing.py::backward_indices in a
// lax.while_loop over passes of its _streaming_categorical (an XLA chain); the
// port ran the same chain eagerly, about 20 launches a pass over a (195, N) block
// and 77 passes a step at N = M = 1e5, 1 GB of temporaries a pass for one argmax
// a target. This kernel keeps every intermediate in registers.
//
// What it computes. Per-particle tables c[i], a[i], b[i] (float32, (3, n)
// rows: the process's loc + scale * mu0, 1 / |scale * s0| and the shifted
// log-weight minus log |scale * s0|, built by ops/backward.py), the targets
// y[0..J) and order[0..n_fail), the failed slots. For each failed slot k, with
// j = order[k]:
//     idx[j] = argmax_i ( b[i] - (a[i] (y[j] - c[i]))^2 / 2 + G[k][i] ),
// G standard Gumbel noise, so idx[j] = i with probability proportional to
// w_i p(y_j | x_i): the law of ops/backward.py::_fallback_plain. The other
// entries of idx are left as they are.
//
// Noise. Philox4x32-10 (Salmon et al. 2011) keyed by two words drawn on the
// device from the step's generator (read through a pointer: no host sync) and
// counted by (particle / 4, failed slot): one call gives the four particles of an
// aligned group their uniforms for one target. A uniform keeps 23 bits, as
// u = (2m + 1) 2^-24 for m in [0, 2^23), in the open interval, so
// G = -log(-log u) is finite; the largest G is about 16.6.
//
// What bounds it. A step draws n_fail x n (target, particle) pairs: 1.5e9 at
// n_fail = 15,000, n = 1e5. The inputs are 12 bytes a particle and 4 a target,
// which stay on chip, so the work is compute-bound. Each pair needs two lg2 on
// the special-function unit (16 a clock on each SM): 2 x 1.5e9 / (132 x 16 x
// 1.98 GHz) = 0.72 ms at that size, the bound PERF.md quotes.
//
// What the design does about it.
// - Everything is in log2 units, so the Gumbel takes exactly two lg2 and no
//   exp or ln: with s = (b - (a d)^2 / 2) log2(e) and E = -ln u,
//   (s + G) log2(e) = s' - lg2(-lg2 u) + const; the tables are scaled once
//   when staged.
// - lg2.approx is accurate to 2^-22 absolute near 1, so -lg2 u would lose its
//   relative precision, and the largest Gumbels with it, as u nears 1: below
//   v = 1 - u = 2^-4 (exact in float32) lg2 u is the series of log2(1 - v) to
//   v^5 (relative error under 3e-7) instead.
// - A thread holds four targets in registers and walks its block's particle
//   slice, staged in shared memory 1024 particles (16 KB) at a time: one
//   broadcast load of a particle's table feeds four targets, and one Philox
//   call four particles of a target. The lg2 is lg2.approx.ftz: __log2f's
//   denormal fix-up took four more instructions a lg2. What is left is about
//   29 issued instructions a pair (467 a loop of 16 pairs in the SASS): 19
//   floating-point, a quarter of a Philox call (two IMAD.WIDE and two LOP3 a
//   round, its first round on the uniform datapath, the particle group being
//   the same across a warp) and the two lg2. So the issue slots (about 1.3 ms
//   at the cell's size; 1.84 ms measured on an H100) bind before the
//   special-function unit.
// - The grid is (target tiles of 1024, particle slices), with enough slices
//   for four blocks of 256 threads on every SM and not one more (15 tiles x
//   35 slices at the cell's size: one wave; on an H100 a 36th slice ran 12
//   blocks in a second wave, 2.88 ms against 2.40 with __log2f), each slice
//   at least 1024 particles. Each block writes one (value, index) partial a
//   target and slice; a second kernel, one thread a target, takes the largest
//   over the slices in slice order (ties to the lower index, as torch.max)
//   and writes the int64 index to idx[order[k]].
// No host decision by data, no atomics, no state between calls.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTargets = 4;                        // targets a thread holds
constexpr int kTile = kThreads * kTargets;         // targets a block
constexpr int kChunk = 1024;                       // particles staged at a time (16 KB)
constexpr int kMinSlice = 1024;                    // particles a slice at least
constexpr int kBlocksPerSm = 4;
constexpr int kReduceThreads = 256;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kHalfLog2eRoot = 0.8493218002880191f;  // sqrt(log2(e) / 2)
constexpr float kSeriesCut = 0.0625f;                  // 2^-4

struct Slicing {
  int slices;
  int length;  // particles a slice, a multiple of 4
};

Slicing slicing(int n, int n_fail, int sms) {
  const int tiles = (n_fail + kTile - 1) / kTile;
  int want = kBlocksPerSm * sms / tiles;  // one wave: a block more would run alone after it
  const int most = (n + kMinSlice - 1) / kMinSlice;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const int length = (((n + want - 1) / want) + 3) & ~3;
  return {(n + length - 1) / length, length};
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u, kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// lg2.approx with denormal inputs flushed: every input here is at least
// 2^-25, so the flush costs nothing and drops the denormal fix-up of __log2f
__device__ __forceinline__ float lg2(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// lg2(-lg2 u), which is lg2 E for E = -ln u up to a constant, from 32 random
// bits: a pair's key is s' minus it
__device__ __forceinline__ float lg2_exponential(uint32_t bits) {
  const float u = __uint_as_float(0x3f800000u | (bits >> 9)) - 0.99999994f;  // (2m + 1) 2^-24
  const float v = 1.0f - u;                                                  // exact
  const float series = v * fmaf(v, fmaf(v, fmaf(v, fmaf(v, -kLog2e / 5.0f, -kLog2e / 4.0f), -kLog2e / 3.0f),
                                        -kLog2e / 2.0f), -kLog2e);
  const float lg2u = v < kSeriesCut ? series : lg2(u);
  return lg2(-lg2u);
}

__device__ __forceinline__ void pair(const float4& t, float y, uint32_t bits, int i, float& best, int& best_i) {
  const float z = t.y * (y - t.x);
  const float key = fmaf(-z, z, t.z) - lg2_exponential(bits);
  if (key > best) {
    best = key;
    best_i = i;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fallback_kernel(const float* __restrict__ tables, const float* __restrict__ targets,
                    const long long* __restrict__ order, const long long* __restrict__ seed,
                    float* __restrict__ part_val, int* __restrict__ part_idx, int n, int n_fail, int length) {
  __shared__ float4 stage[kChunk];
  const float* c = tables;
  const float* a = tables + n;
  const float* b = tables + 2 * static_cast<size_t>(n);
  const uint32_t k0 = static_cast<uint32_t>(seed[0]), k1 = static_cast<uint32_t>(seed[1]);

  const int first_slot = blockIdx.x * kTile + threadIdx.x;
  float y[kTargets], best[kTargets];
  int best_i[kTargets];
#pragma unroll
  for (int j = 0; j < kTargets; ++j) {
    const int k = first_slot + j * kThreads;
    y[j] = k < n_fail ? targets[order[k]] : 0.0f;
    best[j] = -INFINITY;
    best_i[j] = 0;
  }
  const bool active = first_slot < n_fail;

  const int lo = blockIdx.y * length;
  const int hi = min(lo + length, n);
  for (int base = lo; base < hi; base += kChunk) {
    const int len = min(kChunk, hi - base);
    __syncthreads();
    for (int p = threadIdx.x; p < ((len + 3) & ~3); p += kThreads) {
      const int i = base + p;
      stage[p] = p < len ? make_float4(c[i], a[i] * kHalfLog2eRoot, b[i] * kLog2e, 0.0f)
                         : make_float4(0.0f, 0.0f, -INFINITY, 0.0f);
    }
    __syncthreads();
    if (!active) continue;
    for (int p = 0; p < len; p += 4) {
      const float4 t0 = stage[p], t1 = stage[p + 1], t2 = stage[p + 2], t3 = stage[p + 3];
      const int i = base + p;
      const uint32_t group = static_cast<uint32_t>(i) >> 2;
#pragma unroll
      for (int j = 0; j < kTargets; ++j) {
        const uint4 r = philox4x32_10(group, static_cast<uint32_t>(first_slot + j * kThreads), k0, k1);
        pair(t0, y[j], r.x, i, best[j], best_i[j]);
        pair(t1, y[j], r.y, i + 1, best[j], best_i[j]);
        pair(t2, y[j], r.z, i + 2, best[j], best_i[j]);
        pair(t3, y[j], r.w, i + 3, best[j], best_i[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTargets; ++j) {
    const int k = first_slot + j * kThreads;
    if (k < n_fail) {
      const size_t at = static_cast<size_t>(blockIdx.y) * n_fail + k;
      part_val[at] = best[j];
      part_idx[at] = best_i[j];
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                  const long long* __restrict__ order, long long* __restrict__ idx, int n_fail, int slices) {
  const int k = blockIdx.x * kReduceThreads + threadIdx.x;
  if (k >= n_fail) return;
  float best = -INFINITY;
  int best_i = 0;
  for (int s = 0; s < slices; ++s) {
    const size_t at = static_cast<size_t>(s) * n_fail + k;
    const float v = part_val[at];
    if (v > best) {
      best = v;
      best_i = part_idx[at];
    }
  }
  idx[order[k]] = best_i;
}

}  // namespace

// 4-byte words of scratch a call at (n, n_fail) needs on the current device: a
// float and an int32 partial for each failed slot and particle slice.
extern "C" long long pf_ffbsi_fallback_scratch(int n, int n_fail) {
  if (n <= 0 || n_fail <= 0) return 0;
  return 2LL * slicing(n, n_fail, sm_count()).slices * n_fail;
}

// Particles a slice of the grid a call at (n, n_fail) takes on the current
// device (a multiple of 4; the last slice holds the rest): where the law test
// at the smoothing cell's shape puts its live particles.
extern "C" long long pf_ffbsi_fallback_slice_length(int n, int n_fail) {
  if (n <= 0 || n_fail <= 0) return 0;
  return slicing(n, n_fail, sm_count()).length;
}

// Launch both kernels on `stream` (PyTorch's current stream). tables is (3, n)
// float32 (c, a, b rows), targets (J,) float32, order (>= n_fail,) int64 slots
// into targets and idx, seed two int64 words (their low 32 bits key Philox), idx
// (J,) int64, written at order[0..n_fail) only; scratch holds
// pf_ffbsi_fallback_scratch(n, n_fail) 4-byte words. All device memory,
// allocated by the caller. Returns the first CUDA error as an int (0 on success).
extern "C" int pf_ffbsi_fallback(const void* tables, const void* targets, const void* order, const void* seed,
                                 void* idx, void* scratch, int n, int n_fail, void* stream) {
  if (n <= 0 || n_fail <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const Slicing sl = slicing(n, n_fail, sm_count());
  auto* part_val = static_cast<float*>(scratch);
  auto* part_idx = reinterpret_cast<int*>(part_val + static_cast<size_t>(sl.slices) * n_fail);
  const auto* ord = static_cast<const long long*>(order);
  const dim3 grid((n_fail + kTile - 1) / kTile, sl.slices);
  fallback_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(tables), static_cast<const float*>(targets),
                                            ord, static_cast<const long long*>(seed), part_val, part_idx, n,
                                            n_fail, sl.length);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<(n_fail + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part_val, part_idx, ord, static_cast<long long*>(idx), n_fail, sl.slices);
  return static_cast<int>(cudaGetLastError());
}
