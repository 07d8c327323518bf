// Runs the graph beam's candidate scoring (cosdata_tpu_torch/csrc/
// u8_row_dot.cuh) on the host as u8_row_dot.cu launches it: a CTA for each
// tile of kTileRows candidates of each query; its threads copy the query's
// codes into a shared buffer first filled with the byte FILL (load_query),
// then each of its warps runs as 32 threads of warp_emulation.h
// (thread_scores: the partials, the shuffles and the epilogue). Every
// 16-byte load of a table row goes through the __ldg below, which counts
// the loads of each row and stops the run (exit 3) on an address outside
// the table; the kernel's __trap() stops it with exit 4.
//
//   u8_row_dot_host IN OUT READS FILL
//
// IN holds B, K, rows, Dp, d_pad, metric, has_live (int64), then q_codes
// (B, Dp) int8, q_sums (B,) int32, q_mags (B,) f32, a, b, dtrue (f32),
// codes (rows, Dp) int8, sums (rows,) int32, mags (rows,) f32, ids (B, K)
// int64 and, where has_live, live (B, K) uint8; OUT receives the scores,
// (B, K) f32, whose slots start as the bits 0xffffffff (a NaN the kernel
// never writes) so that a slot never written shows; READS receives the
// 16-byte loads of each table row, (rows,) int32.
#include "cuda_float_shims.h"
#include "cuda_int_shims.h"
#include "warp_emulation.h"

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

static const int4* g_table;
static long long g_table_loads;  // 16-byte loads a table holds
static int g_row_loads;          // 16-byte loads a row holds
static std::atomic<int>* g_reads;

[[noreturn]] void __trap() { std::_Exit(4); }

int4 __ldg(const int4* p) {
  const long long i = p - g_table;
  if (i < 0 || i >= g_table_loads) std::exit(3);
  g_reads[i / g_row_loads].fetch_add(1);
  return *p;
}

#include "u8_row_dot.cuh"

thread_local dim3 threadIdx, blockIdx;
Warp* g_warp;

template <class T>
static bool read(FILE* f, T* v, size_t n) {
  return std::fread(v, sizeof(T), n, f) == n;
}

int main(int argc, char** argv) {
  using namespace u8_row_dot;
  if (argc != 5) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  long long hdr[7];
  if (f == nullptr || std::fread(hdr, 8, 7, f) != 7) return 2;
  const long long B = hdr[0], rows = hdr[2];
  const int K = static_cast<int>(hdr[1]), dp = static_cast<int>(hdr[3]);
  // 16-byte aligned, as the card's tensors are
  std::vector<int4> q_buf(B * dp / 16 + 1), c_buf(rows * dp / 16 + 1);
  auto* q_codes = reinterpret_cast<int8_t*>(q_buf.data());
  auto* codes = reinterpret_cast<int8_t*>(c_buf.data());
  std::vector<int32_t> q_sums(B), sums(rows);
  std::vector<float> q_mags(B), abd(3), mags(rows);
  std::vector<long long> ids(B * K);
  std::vector<uint8_t> live(hdr[6] ? B * K : 0);
  if (!read(f, q_codes, B * dp) || !read(f, q_sums.data(), B) || !read(f, q_mags.data(), B) ||
      !read(f, abd.data(), 3) || !read(f, codes, rows * dp) || !read(f, sums.data(), rows) ||
      !read(f, mags.data(), rows) || !read(f, ids.data(), ids.size()) || !read(f, live.data(), live.size())) {
    return 2;
  }
  std::fclose(f);
  std::vector<float> out(B * K, __int_as_float(-1));
  std::vector<std::atomic<int>> reads(rows);
  g_table = c_buf.data();
  g_table_loads = rows * dp / 16;
  g_row_loads = dp / 16;
  g_reads = reads.data();
  const int tiles = (K + kTileRows - 1) / kTileRows;
  const Args a{q_codes, q_sums.data(), q_mags.data(), &abd[0], &abd[1], &abd[2], codes, sums.data(), mags.data(),
               ids.data(), live.empty() ? nullptr : live.data(), out.data(), rows, K, dp,
               static_cast<int>(hdr[4]), static_cast<int>(hdr[5]), tiles};
  const int fill = std::atoi(argv[4]);
  std::vector<int4> smem(dp / 16);
  for (long long b = 0; b < B; ++b) {
    for (int tile = 0; tile < tiles; ++tile) {
      std::memset(smem.data(), fill, dp);
      for (int t = 0; t < kThreads; ++t) load_query(a, b, smem.data(), t);
      for (int warp = 0; warp < kThreads / 32; ++warp) {
        Warp wp;
        g_warp = &wp;
        std::vector<std::thread> lanes;
        for (int l = 0; l < 32; ++l) {
          lanes.emplace_back([&, l] {
            threadIdx.x = l;
            thread_scores(a, smem.data(), b, tile, warp * 32 + l);
          });
        }
        for (auto& th : lanes) th.join();
      }
    }
  }
  std::vector<int32_t> counts(rows);
  for (long long r = 0; r < rows; ++r) counts[r] = reads[r].load();
  FILE* o = std::fopen(argv[2], "wb");
  if (o == nullptr || std::fwrite(out.data(), 4, out.size(), o) != out.size()) return 2;
  std::fclose(o);
  FILE* rd = std::fopen(argv[3], "wb");
  if (rd == nullptr || std::fwrite(counts.data(), 4, counts.size(), rd) != counts.size()) return 2;
  std::fclose(rd);
  return 0;
}
