// Host versions of the CUDA float intrinsics that K1's euclidean epilogue
// (cosdata_tpu_torch/csrc/u8_euclidean.cuh) and stage 4's epilogue
// (cosdata_tpu_torch/csrc/u8_block_dot.cuh) call, for tests on machines
// without a card. Each is the IEEE operation rounded to nearest even, as
// on the card; compile with -ffp-contract=off, so that no product and sum
// are fused into one rounding.
#pragma once

#include <math.h>

#include <cstdint>
#include <cstring>

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float x) { return sqrtf(x); }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float __int2float_rn(int32_t x) { return static_cast<float>(x); }
inline float __int_as_float(int32_t x) {
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
}
