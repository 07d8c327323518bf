// A host version of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 for
// stage 4's products (cosdata_tpu_torch/csrc/u8_block_dot.cuh), over the
// warp of warp_emulation.h: each of the 32 threads posts its fragments,
// every thread rebuilds A (16 x 32) and B (32 x 8) from them as the PTX ISA
// lays the fragments out, and takes its own four sums of D = A B + C.
//
// PTX's layout for lane l, group g = l / 4, thread t = l % 4 (element i of
// a register is its byte i, the lowest first):
//   A: a0..a3 (register 0) row g, a4..a7 row g + 8, a8..a11 row g,
//      a12..a15 row g + 8; column 4t + (i % 4), + 16 for a8..a15;
//   B: b0..b3 (register 0) rows 4t + (i % 4), b4..b7 those + 16; column g;
//   C, D: c0, c1 row g, c2, c3 row g + 8; columns 2t + (i % 2).
#pragma once

#include <cstdint>

#include "warp_emulation.h"

inline void mma_m16n8k32_s8(int32_t (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  static uint32_t posted[32][6];
  const int self = static_cast<int>(threadIdx.x);
  for (int r = 0; r < 4; ++r) posted[self][r] = a[r];
  posted[self][4] = b[0];
  posted[self][5] = b[1];
  g_warp->bar.arrive_and_wait();
  int32_t A[16][32], B[32][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    for (int i = 0; i < 16; ++i) {
      const int8_t v = static_cast<int8_t>(posted[l][i / 4] >> (8 * (i % 4)));
      A[g + 8 * ((i / 4) % 2)][4 * t + i % 4 + (i >= 8 ? 16 : 0)] = v;
    }
    for (int i = 0; i < 8; ++i) {
      B[4 * t + i % 4 + (i >= 4 ? 16 : 0)][g] = static_cast<int8_t>(posted[l][4 + i / 4] >> (8 * (i % 4)));
    }
  }
  g_warp->bar.arrive_and_wait();
  const int g = self / 4, t = self % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + i % 2;
    int32_t s = d[i];
    for (int k = 0; k < 32; ++k) s += A[row][k] * B[k][col];
    d[i] = s;
  }
}
