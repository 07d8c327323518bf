// Stage 4 of the u8 scan: the exact int8 dots of each query's codes with
// the rows of its winning blocks, read in place from the code table.
//
//   out[b, k * group + j] = sum_d q_codes[b, d] * codes[block_ids[b, k] * group + j, d]     int32
//
// Replaces no TPU kernel: on the TPU this step is XLA's gather of the
// blocks and its grouped int8 einsum (cosdata_tpu/ops/flat_scan.py,
// exp_body, :284-295). The port did it as a gathered copy of the blocks, a
// cast of that copy to f32 and a batched f32 gemv per query
// (ops/distance.py:diag_code_dot), moving each byte five times.
//
// What bounds it on an H100: memory. At B=1024 queries, 64 blocks of 32
// rows, Dp=768, the queries read 1.61 GB of blocks (0.48 ms at 3.35 TB/s;
// fewer bytes where queries share blocks and L2 serves them), against
// 1.6e9 int8 multiply-adds, 0.4e9 __dp4a: a few hundredths of a ms. With one
// query a product, the tensor cores have no work to share.
//
// The design (u8_block_dot.cuh): a block of 256 threads owns 128
// candidates of one query; the query's codes sit in shared memory. Each
// row is read once, by 8 lanes of 16 bytes (one 128-byte line a load), each
// thread loading its 4 rows together, two steps unrolled (8 loads of 16
// bytes in flight a thread); __dp4a accumulates in int32, and three
// shuffles within the 8 lanes sum a row. Nothing is copied: a block of 32
// rows is one contiguous run of 32 Dp bytes in the table.
//
// The kernel's name keeps "dot_kernel", which the benchmark's profiler
// groups count under products.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "u8_block_dot.cuh"

namespace {

using namespace u8_block_dot;

__global__ void __launch_bounds__(kThreads) u8_block_dot_kernel(const int8_t* __restrict__ q_codes,
                                                                const int8_t* __restrict__ codes,
                                                                const long long* __restrict__ block_ids,
                                                                int* __restrict__ out, int k_blocks, int group,
                                                                long long n_blocks, int n_cand, int dp, int tiles) {
  extern __shared__ int4 q_smem[];
  const long long b = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int4* qg = reinterpret_cast<const int4*>(q_codes + b * dp);
  for (int i = threadIdx.x; i < dp / 16; i += kThreads) q_smem[i] = qg[i];
  __syncthreads();
  const int slot = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  int acc[kRowsPerThread];
  thread_partials(reinterpret_cast<const int8_t*>(q_smem), codes, block_ids, b, k_blocks, group, n_blocks, n_cand,
                  dp, tile, slot, lane, acc);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    int s = acc[r];
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    const int p = tile * kTileRows + slot + kRowSlots * r;
    if (lane == 0 && p < n_cand) out[b * n_cand + p] = s;
  }
}

}  // namespace

// Pointers are device pointers: q_codes (B, Dp) int8, codes (n_rows, Dp)
// int8, both 16-byte aligned, block_ids (B, k_blocks) int64, out
// (B, k_blocks * group) int32. Returns the cudaError_t of the launch.
extern "C" int u8_block_dot_launch(const void* q_codes, const void* codes, long long n_rows, const void* block_ids,
                                   void* out, int B, int k_blocks, int group, int Dp, void* stream) {
  if (B <= 0 || k_blocks <= 0 || group <= 0 || n_rows < 0 || n_rows % group != 0 || Dp <= 0 ||
      Dp % kDpMultiple != 0 || Dp > kDpMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_cand = static_cast<long long>(k_blocks) * group;
  const long long tiles = (n_cand + kTileRows - 1) / kTileRows;
  if (n_cand > INT_MAX || tiles * B > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (Dp > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(u8_block_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Dp);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  u8_block_dot_kernel<<<static_cast<unsigned>(tiles * B), kThreads, Dp, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q_codes), static_cast<const int8_t*>(codes),
      static_cast<const long long*>(block_ids), static_cast<int*>(out), k_blocks, group, n_rows / group,
      static_cast<int>(n_cand), Dp, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u8_block_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
