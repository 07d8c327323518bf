// Stage 4 of the u8 scan: each query's winning blocks of the code table
// rescored, from the exact int8 dots of its codes with their rows to the
// f32 scores that the stage's top-k reads.
//
//   out[b, k * group + j] = score(q[b], row block_ids[b, k] * group + j)                 f32
//
// where score is dequant_dot, then cosine, dot or the negated euclidean
// distance (distance.cos_or_dot), and NEG_INF for an invalid row or a bin
// that sank (bin_s[b, k] <= NEG_INF / 2).
//
// Replaces no TPU kernel: on the TPU this step is XLA's gather of the
// blocks, its grouped int8 einsum and the elementwise rescore
// (cosdata_tpu/ops/flat_scan.py, exp_body, :284-304).
//
// What bounds it on an H100: memory. At B=1024 queries, 64 blocks of 32
// rows, Dp=768 (a resident 1M-row scan) the queries chose ~28,600 distinct
// blocks of the table's 32,768: 703 MB, 0.21 ms at 3.35 TB/s, against 1.6e9
// int8 multiply-adds, ~2 us of int8 tensor-core time even where each
// product is padded to 8 queries. A design that reads each query's blocks
// for that query alone reads 1.61 GB (0.48 ms); in a streamed 65,536-row
// chunk (2,048 blocks, 50 a query) it reads each block ~25 times.
//
// The design: block-major. The wrapper sorts the (B, K) block ids, stably
// (fixed sizes, no host sync), so that the (query, slot) entries of each
// table block lie together. A CTA takes a window of 16 sorted entries
// (each CTA the same work, however many queries share a block, and none
// for a block nobody chose), reads their terms once, and cuts the window
// into chunks of one block's entries. It walks its chunks and Dp in slices
// of 256 bytes through a ring of 2 stages of shared memory: each slice of
// the block's 32 rows arrives as two TMA boxes of 32 x 128 bytes (128-byte
// swizzle, so the fragment loads meet no bank conflict) and each of the
// chunk's query codes by a cp.async.bulk, all completing on the stage's
// mbarrier, while the slice before it is multiplied. So a block is read
// from device memory once for all the queries that chose it in a window
// (again, mostly from L2, where its entries run on into the next window),
// and the query codes come from L2. The products run on the int8 tensor
// cores, mma.sync m16n8k32 (u8_block_dot.cuh: the fragments, the walk,
// the epilogue); the block's row sums, magnitudes and valid bytes are read
// beside it, and the epilogue writes each entry's 32 scores in the kernel.
//
// Why these sizes (python3 -m cosdata_tpu_torch.tools.kernel_variants bd
// bd_w32 bd_w64 bd_st3 bd_s128 bd_no_products; H100 80GB HBM3, 700 W):
// each CTA walks its steps one after another, so the card needs many CTAs
// at once. Windows of 16 beat 32 and 64 (more CTAs, the same work each);
// 2 stages beat 3 (less shared memory a CTA, more CTAs an SM); slices of
// 256 bytes beat 128. Without the products and the epilogue the stage
// takes ~90% of its time: what holds it is reading the blocks, 712 MB in
// ~0.27 ms at the resident shape, ~2.6 TB/s of the 3.35.
//
// The kernel's name keeps "dot_kernel", which the benchmark's profiler
// groups count under products.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper_mma.cuh"
#include "u8_block_dot.cuh"

namespace {

using namespace u8_block_dot;

static_assert(kThreads >= kWindow && kThreads >= kChunk, "a thread a key and a query copy");

struct Shared {
  alignas(1024) int8_t rows[kStages][kRowBytes];  // the swizzled boxes want 1024-byte alignment
  alignas(16) int8_t queries[kStages][kQueryBytes];
  uint64_t bar[kStages];                          // a stage's copies landed
  int32_t keys[kWindow];                          // the window's sorted block ids
  EntryTerms entries[kWindow];                    // and its entries' terms
  Chunk chunks[kWindow];                          // its plan
  int n_chunks;
};
constexpr int kSmemBytes = sizeof(Shared) + 1024;  // + the alignment

// Step i's copies into its stage: thread 0 sets the bytes the stage's
// barrier waits for and asks the TMA for the rows' boxes, thread j copies
// the chunk's query j.
__device__ __forceinline__ void issue(const CUtensorMap& map, const Args& a, const Tile& t, Shared& sh, int i,
                                      int slices, int tid) {
  const int st = i % kStages, s = i % slices;
  const Chunk c = sh.chunks[i / slices];
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&sh.bar[st], step_bytes(a, t, c, s));
    const int row = static_cast<int>(table_row(a, t, c, 0));
    for (int x = 0; x < boxes_of(slice_width(a.dp, s)); ++x) {
      hopper::tma_load_2d(sh.rows[st] + x * kTileBytes, &map, &sh.bar[st], box_col(s, x), row);
    }
  }
  const Copy cp = query_copy(a, c, sh.entries + c.first, s, tid);
  if (cp.bytes) hopper::bulk_load(sh.queries[st] + cp.dst, cp.src, cp.bytes, &sh.bar[st]);
}

__global__ void __launch_bounds__(kThreads) u8_block_dot_kernel(const __grid_constant__ CUtensorMap map,
                                                                const Args a) {
  extern __shared__ uint8_t smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(hopper::align1024(smem_raw));
  const Tile t = tile_of(a, blockIdx.x, static_cast<int>(blockIdx.y));
  const int tid = static_cast<int>(threadIdx.x), warp = tid / 32, lane = tid % 32;
  const int n = window_size(a, t.w0);
  if (tid < n) {
    sh.keys[tid] = a.keys[t.w0 + tid];
    sh.entries[tid] = entry_terms(a, t.w0 + tid);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&sh.bar[s], 1);
    hopper::fence_barrier_init();
  }
  const Consts k = consts_of(*a.q_a, *a.q_b, *a.q_dtrue);
  __syncthreads();
  if (tid == 0) sh.n_chunks = plan_chunks(sh.keys, n, a.n_blocks, sh.chunks);
  __syncthreads();
  const int slices = slices_of(a.dp), steps = slices * sh.n_chunks;
  for (int i = 0; i < kStages && i < steps; ++i) issue(map, a, t, sh, i, slices, tid);
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 8;
  int32_t acc[4] = {0, 0, 0, 0};
  RowTerms rows[2] = {};
  for (int i = 0; i < steps; ++i) {
    const int st = i % kStages, s = i % slices;
    const Chunk c = sh.chunks[i / slices];
    hopper::mbar_wait(&sh.bar[st], static_cast<uint32_t>((i / kStages) & 1));
    if (m0 < t.rows && n0 < c.n) {
      if (s == 0) lane_rows(a, t, c, m0, lane, rows);
      slice_products(sh.rows[st], sh.queries[st], m0, n0, slice_width(a.dp, s), lane, acc);
      if (s == slices - 1) write_scores(a, t, rows, sh.entries + c.first, c.n, k, m0, n0, lane, acc);
    }
    if (s == slices - 1) acc[0] = acc[1] = acc[2] = acc[3] = 0;
    __syncthreads();  // every warp is done with stage st
    if (i + kStages < steps) issue(map, a, t, sh, i + kStages, slices, tid);
  }
}

}  // namespace

// Pointers are device pointers (Args, u8_block_dot.cuh): q_codes (B, Dp)
// and codes (rows, Dp) int8, both 16-byte aligned; q_sums (B,) int32,
// q_mags (B,) f32, q_a, q_b, q_dtrue 0-d f32; sums (rows,) int32, mags
// (rows,) f32, valid (rows,) bytes; bin_s (B, K) f32; keys (B * K) int32,
// the block ids sorted, and order (B * K) int64, their flat indices in that
// order; out (B, K * group) f32. Returns the cudaError_t of the launch.
extern "C" int u8_block_dot_launch(int metric, const void* q_codes, const void* q_sums, const void* q_mags,
                                   const void* q_a, const void* q_b, const void* q_dtrue, const void* codes,
                                   const void* sums, const void* mags, const void* valid, long long n_rows,
                                   const void* bin_s, const void* keys, const void* order, void* out, int B,
                                   int k_blocks, int group, int Dp, int d_pad, void* stream) {
  if (B <= 0 || k_blocks <= 0 || group <= 0 || n_rows <= 0 || n_rows % group != 0 || Dp <= 0 ||
      Dp % kDpMultiple != 0 || Dp > kDpMax || d_pad < 0 || d_pad > kDpMax || metric < kCosine ||
      metric > kEuclidean) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_entries = static_cast<long long>(B) * k_blocks, n_blocks = n_rows / group;
  const long long windows = (n_entries + kWindow - 1) / kWindow, tiles = (group + kTileRows - 1) / kTileRows;
  if (n_entries > INT_MAX || n_rows > INT_MAX || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(q_codes), static_cast<const int32_t*>(q_sums),
               static_cast<const float*>(q_mags), static_cast<const float*>(q_a), static_cast<const float*>(q_b),
               static_cast<const float*>(q_dtrue), static_cast<const int8_t*>(codes),
               static_cast<const int32_t*>(sums), static_cast<const float*>(mags),
               static_cast<const uint8_t*>(valid), static_cast<const float*>(bin_s),
               static_cast<const int32_t*>(keys), static_cast<const long long*>(order), static_cast<float*>(out),
               n_entries, n_blocks, k_blocks, group, Dp, d_pad, metric};
  CUtensorMap map;
  const int err = hopper::encode_tma_2d_u8(&map, codes, Dp, n_rows, Dp, kBox, group < kTileRows ? group : kTileRows);
  if (err != 0) return err;
  if (kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(u8_block_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  u8_block_dot_kernel<<<dim3(static_cast<unsigned>(windows), static_cast<unsigned>(tiles)), kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u8_block_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
