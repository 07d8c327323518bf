// Runs stage 4's dot (cosdata_tpu_torch/csrc/u8_block_dot.cuh) on the host
// as u8_block_dot.cu launches it: a block for each tile of kTileRows
// candidates of each query, each of its threads' partials from
// thread_partials, and a row's dot the sum of its slot's 8 lanes (the
// kernel's xor 4, 2, 1 shuffles).
//
//   u8_block_dot_host IN OUT
//
// IN holds B, K, group, rows, Dp (int64), then q_codes (B, Dp) int8, codes
// (rows, Dp) int8 and block_ids (B, K) int64; OUT receives the dots,
// (B, K * group) int32.
#include "cuda_int_shims.h"
#include "u8_block_dot.cuh"

#include <cstdio>
#include <vector>

template <class T>
static bool read(FILE* f, T* v, size_t n) {
  return std::fread(v, sizeof(T), n, f) == n;
}

int main(int argc, char** argv) {
  using namespace u8_block_dot;
  if (argc != 3) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  long long hdr[5];
  if (f == nullptr || std::fread(hdr, 8, 5, f) != 5) return 2;
  const long long B = hdr[0], rows = hdr[3];
  const int K = static_cast<int>(hdr[1]), group = static_cast<int>(hdr[2]), dp = static_cast<int>(hdr[4]);
  // 16-byte aligned, as the card's tensors are
  std::vector<int4> q_buf(B * dp / 16 + 1), c_buf(rows * dp / 16 + 1);
  auto* q_codes = reinterpret_cast<int8_t*>(q_buf.data());
  auto* codes = reinterpret_cast<int8_t*>(c_buf.data());
  std::vector<long long> block_ids(B * K);
  if (!read(f, q_codes, B * dp) || !read(f, codes, rows * dp) || !read(f, block_ids.data(), block_ids.size())) {
    return 2;
  }
  std::fclose(f);
  const int n_cand = K * group;
  const int tiles = (n_cand + kTileRows - 1) / kTileRows;
  std::vector<int> out(B * n_cand, -1);
  for (long long b = 0; b < B; ++b) {
    for (int tile = 0; tile < tiles; ++tile) {
      int partial[kThreads][kRowsPerThread];
      for (int t = 0; t < kThreads; ++t) {
        thread_partials(q_codes + b * dp, codes, block_ids.data(), b, K, group, rows / group, n_cand, dp, tile,
                        t / kLanes, t % kLanes, partial[t]);
      }
      for (int slot = 0; slot < kRowSlots; ++slot) {
        for (int r = 0; r < kRowsPerThread; ++r) {
          int s[kLanes];
          for (int l = 0; l < kLanes; ++l) s[l] = partial[slot * kLanes + l][r];
          for (int off = 4; off >= 1; off /= 2) {
            int x[kLanes];
            for (int l = 0; l < kLanes; ++l) x[l] = s[l] + s[l ^ off];
            for (int l = 0; l < kLanes; ++l) s[l] = x[l];
          }
          const int p = tile * kTileRows + slot + kRowSlots * r;
          if (p < n_cand) out[b * n_cand + p] = s[0];
        }
      }
    }
  }
  FILE* o = std::fopen(argv[2], "wb");
  if (o == nullptr || std::fwrite(out.data(), 4, out.size(), o) != out.size()) return 2;
  std::fclose(o);
  return 0;
}
