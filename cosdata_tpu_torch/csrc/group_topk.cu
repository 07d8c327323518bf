// One chunk's step of the sub-byte scan's running top-k, from K2's fused
// output: for each query row, the k best of (the running top-k) ∪ (the
// chunk's rows), where the chunk's rows are taken from its k best 32-row
// groups.
//
// Replaces no TPU kernel. On the TPU the same step is XLA's per-chunk
// approx_max_k (exact on XLA:CPU) and the lax.top_k merge of
// cosdata_tpu/ops/flat_scan.py:flat_scan_topk (:83-96), which XLA fuses
// into the scan's one program. The port's torch version of it
// (ops/kernels/group_topk.py merge_group_topk_plain, this kernel's plain
// version) takes ~55 launches a chunk: on an NVIDIA H100 80GB HBM3 at 700
// W, 5.2 of the 11.9 device ms of a 1M b1024 quaternary batch (selection,
// gathers, index arithmetic) and 922 launches a batch.
//
// Inputs: scores (B, C) and gmax (B, G = ceil(C / 32)) f32 as K2's fused
// entry writes them (masked rows NEG_INF); the running top (B, k) f32
// values and int64 ids; start, the chunk's first row. Outputs: the new
// (B, k) values and ids, in no order (the caller sorts once, after the
// last chunk). k may pass the chunk's rows: the running entries make up
// the count. The chunk's rows past C are no candidates.
//
// What bounds it on an H100: at B=1024, C=65,536, k=200 it reads the group
// maxima (8.4 MB), the kept groups' 6,400 scores a row (26 MB) and the
// running top (2.5 MB) and writes 2.5 MB: 0.012 ms at 3.35 TB/s. It is
// bound by latency: one block of 256 threads per query row runs two radix
// selects of 4 passes each, every pass a block-wide histogram and
// barriers, and the second reads its 6,600 candidates from the L1/L2
// caches in every pass. Measured on that card (chip_smoke.py phase 5):
// 0.163 ms back to back, 0.204 as a single call, 7% of the bound; the
// plain version 0.41-0.51 ms. Keeping the survivors of the second select's
// first pass in shared memory would cut its work; not done.
//
// The design: a block selects the k-th largest group maximum M by radix
// select (8 bits a pass over the f32 values as ordered uint32 keys; each
// warp folds equal digits with __match_any_sync before one shared-memory
// atomic) and keeps the k groups at or above it, ties in index order. The
// chunk holds at least k rows scoring >= M (each kept group's maximum), so
// the merged top-k lies at or above M: candidates below M (most of the
// kept groups' rows, and stale running entries) drop out of the second
// select at once. The second radix select over the running entries and
// the kept groups' rows finds the k-th largest value; the block writes the
// values above it and, in index order (running entries first), as many
// equal to it as make k. Exact up to ties, as the torch version is.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;
constexpr unsigned kFull = 0xffffffffu;

// f32 -> uint32 with the same order (NaN never reaches here).
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Kth {
  uint32_t key;  // the k-th largest key
  int above;     // how many keys are larger
};

// The k-th largest key among the items i < n for which item(i, key) is
// true (at least k of them). hist holds kWarps * 256 ints, bcast 2.
template <class Item>
__device__ Kth radix_select(const Item& item, int n, int k, int* hist, int* bcast) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t prefix = 0, mask = 0;
  int remaining = k, above = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + threadIdx.x;
      uint32_t key = 0;
      const bool ok = i < n && item(i, key) && (key & mask) == prefix;
      const unsigned digit = ok ? (key >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(kFull, digit);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&hist[warp * 256 + digit], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 256) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += hist[w * 256 + threadIdx.x];
      hist[threadIdx.x] = c;  // warp 0's row now holds the block's counts
    }
    __syncthreads();
    if (warp == 0) {
      int c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[lane * 8 + j];
        s += c[j];
      }
      int suffix = s;  // counts of this lane's digits and every higher one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_down_sync(kFull, suffix, off);
        if (lane + off < 32) suffix += v;
      }
      int acc = suffix - s;  // counts of the digits above this lane's
      if (acc < remaining && remaining <= suffix) {
        for (int j = 7; j >= 0; --j) {
          if (acc + c[j] >= remaining) {
            bcast[0] = lane * 8 + j;
            bcast[1] = acc;
            break;
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    const int digit = bcast[0];
    remaining -= bcast[1];
    above += bcast[1];
    prefix |= static_cast<uint32_t>(digit) << shift;
    mask |= 255u << shift;
    __syncthreads();  // bcast and hist are read before the next pass writes them
  }
  return {prefix, above};
}

// The block's exclusive prefix count of flag over the threads, in thread
// order, and the block's total. wsum holds kWarps ints.
__device__ __forceinline__ int block_scan(bool flag, int* wsum, int& total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned b = __ballot_sync(kFull, flag);
  if (lane == 0) wsum[warp] = __popc(b);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = wsum[w];
    before += w < warp ? v : 0;
    total += v;
  }
  __syncthreads();
  return before + __popc(b & ((1u << lane) - 1u));
}

// Calls take(i, slot) for exactly k items: those with key > kth.key, then
// as many with key == kth.key as make k, in index order; slot counts up
// from 0 in index order.
template <class Item, class Take>
__device__ void compact(const Item& item, int n, int k, Kth kth, int* wsum, const Take& take) {
  const int ties = k - kth.above;
  int ties_before = 0, taken_before = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    uint32_t key = 0;
    const bool ok = i < n && item(i, key);
    const bool tie = ok && key == kth.key;
    int tie_total;
    const int tie_rank = ties_before + block_scan(tie, wsum, tie_total);
    const bool keep = (ok && key > kth.key) || (tie && tie_rank < ties);
    int keep_total;
    const int slot = taken_before + block_scan(keep, wsum, keep_total);
    if (keep) take(i, slot);
    ties_before += tie_total;
    taken_before += keep_total;
  }
}

__global__ void __launch_bounds__(kThreads)
group_topk_kernel(const float* __restrict__ scores, const float* __restrict__ gmax,
                  const float* __restrict__ top_s, const long long* __restrict__ top_i,
                  float* __restrict__ out_s, long long* __restrict__ out_i, long long C, int G, int k,
                  long long start) {
  extern __shared__ int smem[];
  int* hist = smem;                      // kWarps * 256
  int* bcast = hist + kWarps * 256;      // 2
  int* wsum = bcast + 2;                 // kWarps
  int* groups = wsum + kWarps;           // min(k, G): the kept groups
  const long long q = blockIdx.x;
  const float* srow = scores + q * C;
  const float* grow = gmax + q * G;
  const float* trow = top_s + q * k;
  const long long* irow = top_i + q * k;

  // the k best groups (all of them when there are no more than k), and the
  // least key a candidate needs
  int kg = G;
  uint32_t floor_key = 0;
  if (G > k) {
    const auto group_item = [&](int i, uint32_t& key) {
      key = key_of(grow[i]);
      return true;
    };
    const Kth kth = radix_select(group_item, G, k, hist, bcast);
    compact(group_item, G, k, kth, wsum, [&](int i, int slot) { groups[slot] = i; });
    kg = k;
    floor_key = kth.key;
  } else {
    for (int i = threadIdx.x; i < G; i += kThreads) groups[i] = i;
  }
  __syncthreads();

  // candidates: the running entries (i < k), then the kept groups' rows
  const int n = k + kg * kGroup;
  const auto cand = [&](int i, uint32_t& key) {
    if (i < k) {
      key = key_of(trow[i]);
    } else {
      const long long r = static_cast<long long>(groups[(i - k) / kGroup]) * kGroup + (i - k) % kGroup;
      if (r >= C) return false;
      key = key_of(srow[r]);
    }
    return key >= floor_key;
  };
  const Kth kth = radix_select(cand, n, k, hist, bcast);
  compact(cand, n, k, kth, wsum, [&](int i, int slot) {
    if (i < k) {
      out_s[q * k + slot] = trow[i];
      out_i[q * k + slot] = irow[i];
    } else {
      const long long r = static_cast<long long>(groups[(i - k) / kGroup]) * kGroup + (i - k) % kGroup;
      out_s[q * k + slot] = srow[r];
      out_i[q * k + slot] = start + r;
    }
  });
}

}  // namespace

// Pointers are device pointers: scores (B, C) and gmax (B, G) f32, top_s
// (B, k) f32 and top_i (B, k) int64 in; out_s, out_i (B, k) out. G must be
// ceil(C / 32). Returns the cudaError_t of the launch.
extern "C" int group_topk_launch(const void* scores, const void* gmax, const void* top_s, const void* top_i,
                                 void* out_s, void* out_i, int B, long long C, int G, int k, long long start,
                                 void* stream) {
  if (B <= 0 || C <= 0 || k <= 0 || G != (C + kGroup - 1) / kGroup || k > INT_MAX / 2 / kGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kg = G < k ? G : k;
  const size_t smem = sizeof(int) * (kWarps * 256 + 2 + kWarps + static_cast<size_t>(kg));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(group_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  group_topk_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(gmax), static_cast<const float*>(top_s),
      static_cast<const long long*>(top_i), static_cast<float*>(out_s), static_cast<long long*>(out_i), C, G, k,
      start);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* group_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
