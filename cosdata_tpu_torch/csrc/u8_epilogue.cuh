// The u8 score epilogue that stage 4 of the scan (u8_block_dot.cuh) and the
// graph beam's candidate scoring (u8_row_dot.cuh) run in their kernels: an
// exact int32 code dot of a query with a table row, dequantised and turned
// into the metric's score.
//
// It is the plain PyTorch arithmetic in its op order: distance.dequant_dot
// in wrapping int32 and then f32, then distance.cos_or_dot. Every f32
// operation is an intrinsic rounded to nearest (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn): nothing contracts into a fused multiply-add, so
// each score equals the plain version's bit for bit.
//
// The same source builds for the card and for the host: nvcc makes these
// device functions; a host compiler makes them plain functions for the CPU
// tests, with host versions of the float intrinsics
// (tests/cuda_emulation/cuda_float_shims.h).

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define U8_EPILOGUE_FN __device__ __forceinline__
#else
#define U8_EPILOGUE_FN inline
#endif

namespace u8_epilogue {

constexpr int kCosine = 0, kDot = 1, kEuclidean = 2;  // the metric codes of the launches
constexpr float kNegInf = -3.0e38f;                   // ops/topk.py NEG_INF
constexpr float kEps = 1e-30f;                        // ops/distance.py _EPS

// The query's 0-d terms as dequant_dot combines them: a * a, a * b, (b * b) * dtrue.
struct Consts {
  float aa, ab, bbd;
};

U8_EPILOGUE_FN Consts consts_of(float qa, float qb, float dtrue) {
  return Consts{__fmul_rn(qa, qa), __fmul_rn(qa, qb), __fmul_rn(__fmul_rn(qb, qb), dtrue)};
}

// The score of a query (code sum q_sum, magnitude q_mag) with a row (v_sum,
// v_mag) from their int32 code dot cc.
U8_EPILOGUE_FN float score(int metric, int32_t cc, int32_t q_sum, float q_mag, int32_t v_sum, float v_mag,
                           const Consts& k, int d_pad) {
  // dequant_dot: (cc + 128 (s_q + s_v) + Dp 128^2), f32(s_q + 128 Dp), f32(s_v + 128 Dp), wrapping as int32 does
  const uint32_t dp128 = 128u * static_cast<uint32_t>(d_pad);
  const uint32_t code = static_cast<uint32_t>(cc) + 128u * (static_cast<uint32_t>(q_sum) + static_cast<uint32_t>(v_sum)) +
                        128u * dp128;
  const float uq = __int2float_rn(static_cast<int32_t>(static_cast<uint32_t>(q_sum) + dp128));
  const float uv = __int2float_rn(static_cast<int32_t>(static_cast<uint32_t>(v_sum) + dp128));
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(k.aa, __int2float_rn(static_cast<int32_t>(code))),
                                        __fmul_rn(k.ab, __fadd_rn(uq, uv))),
                              k.bbd);
  if (metric == kDot) return dot;
  if (metric == kCosine) {
    const float den = __fmul_rn(q_mag, v_mag);
    return den > kEps ? __fdiv_rn(dot, den) : 0.0f;  // safe_div
  }
  // euclidean: -sqrt(clamp_min((|q|^2 + |v|^2) - 2 dot, 0)); a NaN stays a NaN, as clamp_min keeps it
  const float d2 = __fsub_rn(__fadd_rn(__fmul_rn(q_mag, q_mag), __fmul_rn(v_mag, v_mag)), __fmul_rn(2.0f, dot));
  return -__fsqrt_rn(d2 < 0.0f ? 0.0f : d2);
}

}  // namespace u8_epilogue

#undef U8_EPILOGUE_FN
