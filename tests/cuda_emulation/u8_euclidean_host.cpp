// Runs K1's euclidean epilogue (cosdata_tpu_torch/csrc/u8_euclidean.cuh)
// on the host over the int8 products of the codes, min-reducing each
// 32-row bin in the kernel's order: a thread's 8 rows, then across the 4
// lanes of its quad (xor 1, then xor 2).
//
//   u8_euclidean_host IN OUT
//
// IN holds B, C, Dp (int64), then q_codes (B, Dp) int8, q_code int32,
// q_u, q_sq f32 (B each), codes (C, Dp) int8, v_code int32, v_u, v_sq f32
// (C each) and consts (3) f32; OUT receives the bins, (B, C / 32) f32.
#include "cuda_float_shims.h"
#include "u8_euclidean.cuh"

#include <cstdio>
#include <vector>

template <class T>
static bool read(FILE* f, std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), f) == v.size();
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  long long hdr[3];
  if (f == nullptr || std::fread(hdr, 8, 3, f) != 3) return 2;
  const size_t B = hdr[0], C = hdr[1], Dp = hdr[2];
  std::vector<int8_t> q_codes(B * Dp), codes(C * Dp);
  std::vector<int32_t> q_code(B), v_code(C);
  std::vector<float> q_u(B), q_sq(B), v_u(C), v_sq(C), consts(3);
  if (!read(f, q_codes) || !read(f, q_code) || !read(f, q_u) || !read(f, q_sq) || !read(f, codes) ||
      !read(f, v_code) || !read(f, v_u) || !read(f, v_sq) || !read(f, consts)) {
    return 2;
  }
  std::fclose(f);
  const float inf = __int_as_float(0x7f800000);
  std::vector<float> out(B * (C / 32));
  for (size_t q = 0; q < B; ++q) {
    for (size_t bin = 0; bin < C / 32; ++bin) {
      float lane[4] = {inf, inf, inf, inf};  // lane k of the quad: rows 8 j + 2 k + e of the bin
      for (int j = 0; j < 4; ++j) {
        for (int k = 0; k < 4; ++k) {
          for (int e = 0; e < 2; ++e) {
            const size_t r = bin * 32 + 8 * j + 2 * k + e;
            int32_t cc = 0;
            for (size_t d = 0; d < Dp; ++d) cc += int32_t(q_codes[q * Dp + d]) * int32_t(codes[r * Dp + d]);
            const float d2 = u8_euclidean::d2(cc, q_code[q], q_u[q], q_sq[q], v_code[r], v_u[r], v_sq[r], consts[0],
                                              consts[1], consts[2]);
            lane[k] = fminf(lane[k], d2);
          }
        }
      }
      float x1[4], x2[4];
      for (int k = 0; k < 4; ++k) x1[k] = fminf(lane[k], lane[k ^ 1]);
      for (int k = 0; k < 4; ++k) x2[k] = fminf(x1[k], x1[k ^ 2]);
      out[q * (C / 32) + bin] = u8_euclidean::bin_value(x2[0]);
    }
  }
  FILE* o = std::fopen(argv[2], "wb");
  if (o == nullptr || std::fwrite(out.data(), 4, out.size(), o) != out.size()) return 2;
  std::fclose(o);
  return 0;
}
