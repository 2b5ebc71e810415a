// The copy-count arithmetic of ops/resample.py::copy_counts, shared by the
// resample-and-gather kernels (expand.cu, expand_lanes.cu).
//
// An exact fixed-point prefix sum: q_j = round(p_j * 2^60) as int64, S_j the
// int64 sum of q_0..q_j (any order of addition gives the same bits), then
// cumw_j = float32(float64(S_j) * 2^-60) and counts_j = clamp(ceil(n * cumw_j - u),
// 0, n), the last boundary pinned to n. Every conversion is written out with its
// rounding, and n * cumw and - u are two float32 roundings (no fused
// multiply-add), so the kernels agree bit for bit with the plain version on
// either device.

#pragma once

#include <cuda_runtime.h>

namespace pf {

// q = round(p * 2^60), half to even, for a probability 0 <= p < 8: the value
// torch.round(p.double() * 2**60).long() gives (p * 2^60 is exact in float64).
// Computed on the integer units from p's bits: p = m * 2^(e - 150) with the
// 24-bit mantissa m, so p * 2^60 = m * 2^(e - 90), a left shift when e >= 90 and
// a right shift rounded half to even below. (The float64 route would cost two
// 64-bit conversions a probability, which Hopper issues at 16 a clock per SM.)
__device__ __forceinline__ long long fixed_q(float p) {
  const unsigned bits = __float_as_uint(p);
  const int e = (bits >> 23) & 0xff;
  const unsigned long long m = (bits & 0x7fffffu) | (e ? 0x800000u : 0u);
  const int shift = (e ? e : 1) - 90;  // subnormals share the exponent of the smallest normal
  if (shift >= 0) return static_cast<long long>(m << shift);
  const int k = -shift;
  if (k > 25) return 0;  // m < 2^24: below one half
  const unsigned long long q = m >> k;
  const unsigned long long rem = m & ((1ull << k) - 1);
  const unsigned long long half = 1ull << (k - 1);
  return static_cast<long long>(q + ((rem > half || (rem == half && (q & 1))) ? 1 : 0));
}

// The copy-count boundary of source j from its inclusive prefix S_j.
__device__ __forceinline__ int copy_count(long long s, int j, int n, float u) {
  if (j == n - 1) return n;  // cumw[-1] = 1, then the pin: counts[-1] = n
  const float cumw = __double2float_rn(__dmul_rn(__ll2double_rn(s), 0x1p-60));
  const float x = ceilf(__fsub_rn(__fmul_rn(static_cast<float>(n), cumw), u));
  return static_cast<int>(fminf(fmaxf(x, 0.0f), static_cast<float>(n)));
}

}  // namespace pf
