// The graph beam's candidate scoring (u8_row_dot.cu): the pieces of the
// kernel that build for the host as well, each as one thread runs it.
//
// Candidate p of query b (p < K) is row ids[b, p] of the (rows, Dp) int8
// code table, row 0 where the id is negative. A CTA of kThreads threads
// owns the kTileRows candidates tile * kTileRows .. of one query, whose
// codes it first copies into shared memory (load_query). Thread t is lane
// t % 8 of row slot t / 8; it owns candidates tile * kTileRows + slot +
// kRowSlots * r (r < kRowsPerThread) and, of each, the 16-byte columns
// lane + 8 i (i < Dp / 128). So the 8 lanes of a slot read 128 contiguous
// bytes of one row a load, each thread its 4 rows' loads together, and
// __dp4a sums their products in int32. Three xor shuffles within the 8
// lanes give every lane of the slot each row's whole dot (row_sum), and
// lane r scores the slot's row r (write_score).
//
// Exact: a product of two int8 codes is at most 2^14 in magnitude, so every
// partial and every row's sum stay below 2^14 Dp < 2^31 for Dp <= kDpMax
// (the launch refuses more), and int32 sums are the same in any order.
//
// The epilogue is the plain version's (kernels/u8_row_dot.py:
// row_scores_plain): u8_epilogue.cuh's score of the dot with the row's sum
// and magnitude, then NEG_INF where the entry is not live. A dead entry
// reads no row, no sum and no magnitude, and not its id. A live entry's id
// at or past the table's rows stops the launch before any row is read: the
// thread that finds it calls __trap(), and the launch fails with a CUDA
// error, as the plain version's gather stops on it (a device-side assert
// on the card, an IndexError on the CPU).
//
// The same source builds for the card and for the host: nvcc makes these
// device functions of the kernel; a host compiler makes them plain
// functions for the CPU test (tests/test_torch_u8_row_dot.py), with host
// versions of the intrinsics (tests/cuda_emulation/: the float ones, int4
// and __dp4a, and a warp of 32 std::threads for the shuffles).

#pragma once

#include <cstdint>

#include "u8_epilogue.cuh"

#ifdef __CUDACC__
#define U8_ROW_DOT_FN __device__ __forceinline__
#else
#define U8_ROW_DOT_FN inline
#endif

namespace u8_row_dot {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                              // lanes a row: 8 x 16 bytes, one 128-byte line a load
constexpr int kRowSlots = kThreads / kLanes;           // rows a CTA reads at once
constexpr int kRowsPerThread = 4;                      // a thread's rows, loaded together
constexpr int kTileRows = kRowSlots * kRowsPerThread;  // candidates of one query a CTA
constexpr int kDpMultiple = kLanes * 16;               // a row is whole 128-byte lines
constexpr int kDpMax = (1 << 17) - kDpMultiple;        // 2^14 Dp < 2^31
constexpr long long kDead = -1;                        // the row of an entry that is not live: none
static_assert(kRowsPerThread <= kLanes, "lane r of a slot scores its row r");

using u8_epilogue::Consts;
using u8_epilogue::consts_of;
using u8_epilogue::kCosine;
using u8_epilogue::kEuclidean;
using u8_epilogue::kNegInf;

// The launch's inputs: the queries (codes (B, Dp), code sums, magnitudes
// and the 0-d scale, offset and true width of their quantization), the
// table (codes (rows, Dp), sums, magnitudes), the candidates' ids (B, K)
// and live flags (B, K; null: all live), and the (B, K) f32 scores.
struct Args {
  const int8_t* q_codes;
  const int32_t* q_sums;
  const float* q_mags;
  const float* q_a;
  const float* q_b;
  const float* q_dtrue;
  const int8_t* codes;
  const int32_t* sums;
  const float* mags;
  const long long* ids;
  const uint8_t* live;
  float* out;
  long long rows;
  int k, dp, d_pad, metric, tiles;
};

// Thread t's share of the copy of query b's codes into shared memory q_smem
// (Dp bytes, 16-byte aligned): 16 bytes at a time, strided by the CTA.
U8_ROW_DOT_FN void load_query(const Args& a, long long b, int4* q_smem, int t) {
  const int4* qg = reinterpret_cast<const int4*>(a.q_codes + b * a.dp);
  for (int i = t; i < a.dp / 16; i += kThreads) q_smem[i] = qg[i];
}

// The table row that candidate p of query b reads (its id, 0 where
// negative), or kDead where p lies past K or the entry is not live. A live
// entry's id at or past the table's rows stops the launch (__trap).
U8_ROW_DOT_FN long long row_of(const Args& a, long long b, int p) {
  if (p >= a.k) return kDead;
  const long long e = b * a.k + p;
  if (a.live != nullptr && a.live[e] == 0) return kDead;
  const long long id = a.ids[e];
  if (id >= a.rows) __trap();
  return id < 0 ? 0 : id;
}

// acc + the dot of 16 int8 codes of a query with 16 of a row.
U8_ROW_DOT_FN int dot16(const int4 q, const int4 v, int acc) {
  acc = __dp4a(q.x, v.x, acc);
  acc = __dp4a(q.y, v.y, acc);
  acc = __dp4a(q.z, v.z, acc);
  return __dp4a(q.w, v.w, acc);
}

// Thread (slot, lane)'s partial dots of the query's codes q (in shared
// memory) with its candidates of the tile, over its columns: acc[r] for
// candidate tile * kTileRows + slot + kRowSlots * r, whose table row it
// puts in rows[r]; 0 where the candidate reads no row.
U8_ROW_DOT_FN void thread_partials(const Args& a, const int4* q, long long b, int tile, int slot, int lane,
                                   long long (&rows)[kRowsPerThread], int (&acc)[kRowsPerThread]) {
  const int4* row[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    rows[r] = row_of(a, b, tile * kTileRows + slot + kRowSlots * r);
    row[r] = rows[r] < 0 ? nullptr : reinterpret_cast<const int4*>(a.codes + rows[r] * a.dp) + lane;
    acc[r] = 0;
  }
  const int steps = a.dp / kDpMultiple;
#pragma unroll 2
  for (int i = 0; i < steps; ++i) {
    const int4 qc = q[lane + kLanes * i];
    int4 v[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) v[r] = row[r] ? __ldg(row[r] + kLanes * i) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = dot16(qc, v[r], acc[r]);
  }
}

// The sum of a partial over the 8 lanes of its slot, in every one of them
// (every lane of the warp takes part).
U8_ROW_DOT_FN int row_sum(int s) {
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// out[b, p] for candidate p of query b, table row `row` (row_of), from its
// code dot cc.
U8_ROW_DOT_FN void write_score(const Args& a, long long b, int p, long long row, int32_t cc, const Consts& k) {
  a.out[b * a.k + p] = row == kDead ? kNegInf
                                    : u8_epilogue::score(a.metric, cc, a.q_sums[b], a.q_mags[b], a.sums[row],
                                                         a.mags[row], k, a.d_pad);
}

// Thread t of CTA (b, tile), once its query's codes are in q_smem: its
// partials, the slot's sums, and lane r's score of the slot's row r.
U8_ROW_DOT_FN void thread_scores(const Args& a, const int4* q_smem, long long b, int tile, int t) {
  const int slot = t / kLanes, lane = t % kLanes;
  long long rows[kRowsPerThread];
  int acc[kRowsPerThread];
  thread_partials(a, q_smem, b, tile, slot, lane, rows, acc);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = row_sum(acc[r]);
  const Consts k = consts_of(*a.q_a, *a.q_b, *a.q_dtrue);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int p = tile * kTileRows + slot + kRowSlots * r;
    if (lane == r && p < a.k) write_score(a, b, p, rows[r], acc[r], k);
  }
}

}  // namespace u8_row_dot

#undef U8_ROW_DOT_FN
