// Stage 4 of the u8 scan (u8_block_dot.cu): one thread's share of the
// exact int8 dots of a query's codes with its candidate rows, read in place
// from the code table.
//
// Candidate p of query b (p < K * group) is row
// block_ids[b, p / group] * group + p % group of the (rows, Dp) int8 code
// table: block k of a query is `group` contiguous rows. A block of kThreads
// threads owns kTileRows candidates of one query. Thread t is lane t % 8 of
// row slot t / 8; it owns candidates tile * kTileRows + slot + kRowSlots * r
// (r < kRowsPerThread) and, of each, the 16-byte columns lane + 8 i
// (i < Dp / 128). So the 8 lanes of a slot read 128 contiguous bytes of one
// row a load, and the sum of their 8 partials is the row's dot.
//
// Exact: a product of two int8 codes is at most 2^14 in magnitude, so every
// partial and every row's sum stay below 2^14 Dp < 2^31 for
// Dp <= kDpMax (the launch refuses more), and int32 sums are the same in
// any order.
//
// The same source builds for the card and for the host: nvcc makes these
// device functions of the kernel; a host compiler makes them plain
// functions for the CPU test (tests/test_torch_u8_block_dot.py), with host
// versions of int4, __dp4a and __ldg (tests/cuda_emulation/cuda_int_shims.h).

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define U8_BLOCK_DOT_FN __device__ __forceinline__
#else
#define U8_BLOCK_DOT_FN inline
#endif

namespace u8_block_dot {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                                // lanes a row: 8 x 16 bytes, one 128-byte line a load
constexpr int kRowSlots = kThreads / kLanes;             // rows a block reads at once
constexpr int kRowsPerThread = 4;                        // a thread's rows, loaded together
constexpr int kTileRows = kRowSlots * kRowsPerThread;    // candidates of one query a block
constexpr int kDpMultiple = kLanes * 16;                 // a row is whole 128-byte lines
constexpr int kDpMax = (1 << 17) - kDpMultiple;          // 2^14 Dp < 2^31

// The table row of candidate p of query b; -1 where its block id lies
// outside the table's n_blocks blocks (the kernel then reads nothing and
// writes 0).
U8_BLOCK_DOT_FN long long table_row(const long long* block_ids, long long b, int k_blocks, int group,
                                    long long n_blocks, int p) {
  const long long blk = block_ids[b * k_blocks + p / group];
  return blk < 0 || blk >= n_blocks ? -1 : blk * group + p % group;
}

// acc + the dot of 16 int8 codes of a query with 16 of a row.
U8_BLOCK_DOT_FN int dot16(const int4 q, const int4 v, int acc) {
  acc = __dp4a(q.x, v.x, acc);
  acc = __dp4a(q.y, v.y, acc);
  acc = __dp4a(q.z, v.z, acc);
  return __dp4a(q.w, v.w, acc);
}

// Thread (slot, lane)'s partial dots of query b's codes q (Dp bytes, 16-byte
// aligned) with its candidates of the tile, over its columns: acc[r] for
// candidate tile * kTileRows + slot + kRowSlots * r, 0 past n_cand.
U8_BLOCK_DOT_FN void thread_partials(const int8_t* q, const int8_t* codes, const long long* block_ids, long long b,
                                     int k_blocks, int group, long long n_blocks, int n_cand, int dp, int tile,
                                     int slot, int lane, int (&acc)[kRowsPerThread]) {
  const int4* row[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int p = tile * kTileRows + slot + kRowSlots * r;
    const long long t = p < n_cand ? table_row(block_ids, b, k_blocks, group, n_blocks, p) : -1;
    row[r] = t < 0 ? nullptr : reinterpret_cast<const int4*>(codes + t * dp) + lane;
    acc[r] = 0;
  }
  const int4* qv = reinterpret_cast<const int4*>(q) + lane;
  const int steps = dp / kDpMultiple;
#pragma unroll 2
  for (int i = 0; i < steps; ++i) {
    const int4 qc = qv[kLanes * i];
    int4 v[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) v[r] = row[r] ? __ldg(row[r] + kLanes * i) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = dot16(qc, v[r], acc[r]);
  }
}

}  // namespace u8_block_dot

#undef U8_BLOCK_DOT_FN
