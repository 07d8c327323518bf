// K1's euclidean epilogue (u8_bin_max.cu): one score's squared distance
// and one bin's value, in the reference's euclidean_u8 op order
// (cosdata_tpu/ops/distance.py:60-77), from terms folded so that a score
// costs one int -> float conversion.
//
// Terms (ops/kernels/u8_scan.py:bin_max_terms): a query's int32 q_code =
// 128 s_q + Dp 128^2, f32 q_u = s_q + 128 Dp and f32 q_sq = |q|^2; a row's
// int32 v_code = 128 s_v, f32 v_u = s_v + 128 Dp and f32 v_sq = |v|^2, +inf
// on an invalid row (s the sum of the centred codes); consts a2, ab, bbd.
//
//   code = cc + q_code + v_code                                int32
//   dot  = (a2 * f32(code) + ab * (q_u + v_u)) + bbd
//   d2   = (q_sq + v_sq) - 2 * dot        one fused multiply-add
//   bin  = -sqrt(max(least d2 of its rows, 0))
//
// Why each is the reference's value, for Dp <= 16,384 (the launch refuses
// more): code is the u8 code dot, at most 255^2 Dp < 2^31, so the int32 sum
// is exact in any order; q_u and v_u are integers of at most 255 Dp < 2^22,
// exact in f32, and so is their sum (< 2^24), which is the reference's
// f32(uq) + f32(uv). 2 * dot is exact, so the fused multiply-add rounds
// (q_sq + v_sq) - 2 * dot once, as the reference's subtraction does; where
// 2 * dot would overflow, both give a d2 that clamps to 0, or +inf, or a
// NaN and +inf that fminf drops alike, so the bins agree for every input.
// An invalid row's d2 is +inf, so fminf never takes it;
// a bin whose least d2 is +inf (every row invalid) is kSink. -sqrt is
// decreasing, so a bin's maximum score is -sqrt of its least d2: one
// correctly rounded root a bin; + 0 turns the root of 0 into +0.
//
// The same source builds for the card and for the host: nvcc makes these
// device functions of the kernel (its host pass has no definition of the
// rounding intrinsics, so they cannot be __host__ there); a host compiler
// makes them plain functions for the CPU test
// (tests/test_torch_u8_euclidean_host.py), with host versions of the
// intrinsics (tests/cuda_emulation/cuda_float_shims.h) and
// -ffp-contract=off.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define U8_EUCLIDEAN_FN __device__ __forceinline__
#else
#define U8_EUCLIDEAN_FN inline
#endif

namespace u8_euclidean {

constexpr float kSink = -3.0e38f;  // a bin of invalid rows only

// The squared distance of one score from its code dot cc (the int8
// product of the centred codes) and its query's and row's terms.
U8_EUCLIDEAN_FN float d2(int32_t cc, int32_t q_code, float q_u, float q_sq, int32_t v_code, float v_u,
                         float v_sq, float a2, float ab, float bbd) {
  const float code = __int2float_rn(cc + q_code + v_code);
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(a2, code), __fmul_rn(ab, __fadd_rn(q_u, v_u))), bbd);
  return __fmaf_rn(-2.0f, dot, __fadd_rn(q_sq, v_sq));
}

// A bin's value from the least d2 of its rows.
U8_EUCLIDEAN_FN float bin_value(float least) {
  return least == __int_as_float(0x7f800000) ? kSink : __fadd_rn(-__fsqrt_rn(fmaxf(least, 0.0f)), 0.0f);
}

}  // namespace u8_euclidean

#undef U8_EUCLIDEAN_FN
