// Runs group_topk_kernel (its source, with the launch, the shared-memory
// declaration and the copy instructions rewritten for warp_emulation.h,
// included as GROUP_TOPK_SOURCE) on the host, a block at a time.
//
//   group_topk_host IN OUT FILL
//
// IN holds B, C, G, k, start (int64) and then scores, gmax, top_s (f32) and
// top_i (int64); OUT receives out_s, out_i and survivors (B, 2) int32. The
// shared memory of every block starts filled with the int FILL.
#include "warp_emulation.h"
#include GROUP_TOPK_SOURCE

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
  if (argc != 4) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  long long hdr[5];
  if (f == nullptr || std::fread(hdr, 8, 5, f) != 5) return 2;
  const int B = static_cast<int>(hdr[0]), G = static_cast<int>(hdr[2]), k = static_cast<int>(hdr[3]);
  const long long C = hdr[1], start = hdr[4];
  std::vector<float> scores(B * C), gmax(static_cast<size_t>(B) * G), top_s(static_cast<size_t>(B) * k);
  std::vector<long long> top_i(static_cast<size_t>(B) * k);
  if (!read(f, scores) || !read(f, gmax) || !read(f, top_s) || !read(f, top_i)) return 2;
  std::fclose(f);
  int cap;
  size_t smem;
  if (!plan_for(k, G, cap, smem)) return 3;
  std::vector<float> out_s(top_s.size());
  std::vector<long long> out_i(top_i.size());
  std::vector<int> survivors(2 * static_cast<size_t>(B));
  std::vector<int> shared(smem / 4 + 4);
  for (int b = 0; b < B; ++b) {
    std::fill(shared.begin(), shared.end(), std::atoi(argv[3]));
    Warp warp;
    warp.shared = reinterpret_cast<unsigned char*>(shared.data());
    g_warp = &warp;
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l) {
      lanes.emplace_back([&, l] {
        threadIdx.x = l;
        blockIdx.x = b;
        group_topk_kernel(scores.data(), gmax.data(), top_s.data(), top_i.data(), out_s.data(), out_i.data(), C, G,
                          k, start, cap, survivors.data());
      });
    }
    for (auto& t : lanes) t.join();
  }
  FILE* o = std::fopen(argv[2], "wb");
  if (o == nullptr) return 2;
  std::fwrite(out_s.data(), 4, out_s.size(), o);
  std::fwrite(out_i.data(), 8, out_i.size(), o);
  std::fwrite(survivors.data(), 4, survivors.size(), o);
  std::fclose(o);
  return 0;
}
