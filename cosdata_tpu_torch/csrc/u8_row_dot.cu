// The graph beam's candidate scoring: each query's candidate rows read by
// id from the u8 code table, scored in one launch a wave.
//
//   out[b, p] = score(q[b], row max(ids[b, p], 0))                     f32
//
// where score is the exact int32 code dot, dequant_dot, then cosine, dot
// or the negated euclidean distance (distance.cos_or_dot), and NEG_INF
// where live[b, p] is False (no row is read for it).
//
// Replaces no Pallas kernel: on the TPU this step is XLA's gather of each
// query's candidate rows as a (Q, K, D) int8 array and its grouped einsum,
// g rows against the concatenation of their candidate sets at g times the
// operations, only to put a batched gemv on the matrix unit
// (cosdata_tpu/ops/storage.py:_scores_gathered, :856, and _diag_dot,
// :810). The port ran it as a gathered copy of the rows, a cast of that
// copy to f32, a batched f32 gemv and elementwise launches for the rescore
// and the mask.
//
// What bounds it on an H100: memory. A level-0 wave at ef 256 and b1024
// scores K = 256 candidates a query, each its own row of Dp = 768 bytes:
// 201 MB where every candidate is live (0.060 ms at 3.35 TB/s), against
// 2.0e8 int8 multiply-adds, 5.0e7 __dp4a (~0.003 ms). A graph's candidates
// are each query's own, so few rows are shared and there is nothing to
// read once for many queries.
//
// The design (u8_row_dot.cuh): query-major. A CTA of 256 threads owns 128
// candidates of one query, whose codes it holds in shared memory. Each
// live candidate's row is read once, straight from the table by its id,
// by 8 lanes of 16 bytes (one 128-byte line a load), each thread loading
// its 4 rows together, two steps unrolled (8 loads of 16 bytes in flight a
// thread); __dp4a sums in int32, three shuffles within the 8 lanes sum a
// row, and the epilogue (u8_epilogue.cuh) writes its score. Nothing is
// copied, cast or read twice, and a candidate that is not live costs no
// row read.
//
// The kernel's name keeps "dot_kernel", which the benchmark's profiler
// groups count under products.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "u8_row_dot.cuh"

namespace {

using namespace u8_row_dot;

__global__ void __launch_bounds__(kThreads) u8_row_dot_kernel(const Args a) {
  extern __shared__ int4 q_smem[];
  const long long b = blockIdx.x / a.tiles;
  const int tile = static_cast<int>(blockIdx.x % a.tiles);
  load_query(a, b, q_smem, threadIdx.x);
  __syncthreads();
  thread_scores(a, q_smem, b, tile, threadIdx.x);
}

}  // namespace

// Pointers are device pointers: q_codes (B, Dp) int8, q_sums (B,) int32,
// q_mags (B,) f32, q_a, q_b, q_dtrue 0-d f32; codes (rows, Dp) int8 (both
// code tables 16-byte aligned), sums (rows,) int32, mags (rows,) f32; ids
// (B, K) int64; live (B, K) bool or null (all live); out (B, K) f32.
// Returns the cudaError_t of the launch.
extern "C" int u8_row_dot_launch(int metric, const void* q_codes, const void* q_sums, const void* q_mags,
                                 const void* q_a, const void* q_b, const void* q_dtrue, const void* codes,
                                 const void* sums, const void* mags, long long rows, const void* ids,
                                 const void* live, void* out, int B, int K, int Dp, int d_pad, void* stream) {
  if (B <= 0 || K <= 0 || rows < 0 || Dp <= 0 || Dp % kDpMultiple != 0 || Dp > kDpMax || d_pad < 0 ||
      d_pad > kDpMax || metric < kCosine || metric > kEuclidean) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(K) + kTileRows - 1) / kTileRows;
  if (tiles * B > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (Dp > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(u8_row_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Dp);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Args a{static_cast<const int8_t*>(q_codes), static_cast<const int32_t*>(q_sums),
               static_cast<const float*>(q_mags), static_cast<const float*>(q_a), static_cast<const float*>(q_b),
               static_cast<const float*>(q_dtrue), static_cast<const int8_t*>(codes),
               static_cast<const int32_t*>(sums), static_cast<const float*>(mags),
               static_cast<const long long*>(ids), static_cast<const uint8_t*>(live), static_cast<float*>(out),
               rows, K, Dp, d_pad, metric, static_cast<int>(tiles)};
  u8_row_dot_kernel<<<static_cast<unsigned>(tiles * B), kThreads, Dp, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u8_row_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
