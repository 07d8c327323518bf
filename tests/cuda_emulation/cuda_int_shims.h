// Host versions of the CUDA integer vector type and intrinsic that the
// graph beam's candidate scoring (cosdata_tpu_torch/csrc/u8_row_dot.cuh)
// calls, for tests on machines without a card. __dp4a is the card's: four
// products of signed bytes added to an int32. Compile with
// -fno-strict-aliasing (the header reads int8 rows as 16-byte vectors, as
// the card does).
#pragma once

#include <cstdint>

struct alignas(16) int4 {
  int x, y, z, w;
};

inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }

inline int __dp4a(int a, int b, int c) {
  for (int k = 0; k < 4; ++k) {
    c += int(int8_t(uint32_t(a) >> (8 * k))) * int(int8_t(uint32_t(b) >> (8 * k)));
  }
  return c;
}
