// Runs stage 4 (cosdata_tpu_torch/csrc/u8_block_dot.cuh) on the host as
// u8_block_dot.cu launches it: a CTA for each window of kWindow sorted
// entries and each tile of a block's rows; the window's entry terms read
// (entry_terms) and its keys cut into chunks (plan_chunks); each chunk
// copied in slices as the TMA's boxes of its rows land (swizzled) and by
// the copies of its queries that its threads would issue (query_copy),
// into stages first filled with the byte FILL, the bytes checked against
// step_bytes; then each warp that has rows and entries in the chunk run as
// 32 threads of warp_emulation.h over the slices (slice_products, whose
// mma the host shim of mma_shim.h computes) with its lanes' row terms
// (lane_rows), and the chunk's scores written (write_scores).
//
//   u8_block_dot_host IN OUT FILL
//
// IN holds B, K, group, rows, Dp, d_pad, metric (int64), then q_codes
// (B, Dp) int8, q_sums (B,) int32, q_mags (B,) f32, a, b, dtrue (f32),
// codes (rows, Dp) int8, sums (rows,) int32, mags (rows,) f32, valid
// (rows,) uint8, bin_s (B, K) f32, keys (B * K) int32 and order (B * K)
// int64; OUT receives the scores, (B, K * group) f32, whose slots start as
// the bits 0xffffffff (a NaN) so that a slot never written shows.
#include "cuda_float_shims.h"
#include "mma_shim.h"
#include "u8_block_dot.cuh"

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

thread_local dim3 threadIdx, blockIdx;
Warp* g_warp;

template <class T>
static bool read(FILE* f, std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), f) == v.size();
}

int main(int argc, char** argv) {
  using namespace u8_block_dot;
  if (argc != 4) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  long long hdr[7];
  if (f == nullptr || std::fread(hdr, 8, 7, f) != 7) return 2;
  const long long B = hdr[0], K = hdr[1], rows_n = hdr[3];
  const int group = static_cast<int>(hdr[2]), dp = static_cast<int>(hdr[4]);
  const long long n_blocks = rows_n / group;
  std::vector<int8_t> q_codes(B * dp), codes(rows_n * dp);
  std::vector<int32_t> q_sums(B), sums(rows_n);
  std::vector<float> q_mags(B), abd(3), mags(rows_n), bin_s(B * K);
  std::vector<uint8_t> valid(rows_n);
  std::vector<int32_t> keys(B * K);
  std::vector<long long> order(B * K);
  if (!read(f, q_codes) || !read(f, q_sums) || !read(f, q_mags) || !read(f, abd) || !read(f, codes) ||
      !read(f, sums) || !read(f, mags) || !read(f, valid) || !read(f, bin_s) || !read(f, keys) ||
      !read(f, order)) {
    return 2;
  }
  std::fclose(f);
  std::vector<float> out(B * K * group, __int_as_float(-1));
  const Args a{q_codes.data(), q_sums.data(), q_mags.data(), &abd[0], &abd[1], &abd[2], codes.data(), sums.data(),
               mags.data(), valid.data(), bin_s.data(), keys.data(), order.data(), out.data(), B * K, n_blocks,
               static_cast<int>(K), group, dp, static_cast<int>(hdr[5]), static_cast<int>(hdr[6])};
  const int fill = std::atoi(argv[3]);
  const int tiles = (group + kTileRows - 1) / kTileRows, slices = slices_of(dp);
  const Consts k = consts_of(abd[0], abd[1], abd[2]);
  for (long long w = 0; w * kWindow < B * K; ++w) {
    for (int rt = 0; rt < tiles; ++rt) {
      const Tile t = tile_of(a, w, rt);
      Chunk chunks[kWindow];
      EntryTerms entries[kWindow];
      const int n = window_size(a, t.w0);
      for (int e = 0; e < n; ++e) entries[e] = entry_terms(a, t.w0 + e);
      const int n_chunks = plan_chunks(&keys[t.w0], n, n_blocks, chunks);
      for (int ci = 0; ci < n_chunks; ++ci) {
        const Chunk& c = chunks[ci];
        std::vector<int8_t> rows(static_cast<size_t>(slices) * kRowBytes, static_cast<int8_t>(fill));
        std::vector<int8_t> queries(static_cast<size_t>(slices) * kQueryBytes, static_cast<int8_t>(fill));
        for (int s = 0; s < slices; ++s) {
          // the TMA's boxes, swizzled as the CUDA programming guide lays out the 128-byte swizzle:
          // the 16-byte piece p of a box's row r lands at piece p ^ (r % 8); rows past the table read 0
          uint32_t landed = 0;
          for (int x = 0; x < boxes_of(slice_width(dp, s)); ++x) {
            int8_t* box = &rows[static_cast<size_t>(s) * kRowBytes + x * kTileBytes];
            for (int r = 0; r < t.box_rows; ++r) {
              const long long row = table_row(a, t, c, r);
              for (int col = 0; col < kBox; ++col) {
                box[r * kBox + (((col / 16) ^ (r % 8)) * 16) + col % 16] =
                    row < rows_n ? codes[row * dp + box_col(s, x) + col] : 0;
              }
            }
            landed += t.box_rows * kBox;
          }
          for (int j = 0; j < kThreads; ++j) {
            const Copy cp = query_copy(a, c, entries + c.first, s, j);
            if (cp.bytes == 0) continue;
            if (cp.dst < 0 || cp.dst + cp.bytes > kQueryBytes || cp.dst % 16 || cp.bytes % 16) return 4;
            std::memcpy(&queries[static_cast<size_t>(s) * kQueryBytes + cp.dst], cp.src, cp.bytes);
            landed += cp.bytes;
          }
          if (landed != step_bytes(a, t, c, s)) return 5;
        }
        for (int warp = 0; warp < kThreads / 32; ++warp) {
          const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 8;
          if (m0 >= t.rows || n0 >= c.n) continue;
          Warp wp;
          g_warp = &wp;
          std::vector<std::thread> lanes;
          for (int l = 0; l < 32; ++l) {
            lanes.emplace_back([&, l] {
              threadIdx.x = l;
              int32_t acc[4] = {0, 0, 0, 0};
              RowTerms terms[2] = {};
              lane_rows(a, t, c, m0, l, terms);
              for (int s = 0; s < slices; ++s) {
                slice_products(&rows[static_cast<size_t>(s) * kRowBytes], &queries[static_cast<size_t>(s) * kQueryBytes],
                               m0, n0, slice_width(dp, s), l, acc);
              }
              write_scores(a, t, terms, entries + c.first, c.n, k, m0, n0, l, acc);
            });
          }
          for (auto& th : lanes) th.join();
        }
      }
    }
  }
  FILE* o = std::fopen(argv[2], "wb");
  if (o == nullptr || std::fwrite(out.data(), 4, out.size(), o) != out.size()) return 2;
  std::fclose(o);
  return 0;
}
