// Stage 4 of the u8 scan (u8_block_dot.cu): the pieces of the kernel that
// build for the host as well, each as one thread (or lane) runs it.
//
// The wrapper sorts the (B, K) block ids: `keys` holds them in order, and
// `order` the flat index b * K + k of each (query b, slot k), stably. A
// block of the launch (a CTA) owns a window of kWindow consecutive sorted
// entries (and, where a table block has more than kTileRows rows, tile rt
// of them). It cuts its window into chunks (plan_chunks): runs of entries
// of one table block, at most kChunk each. A step is (chunk, slice of Dp):
// each step's stage of shared memory holds the chunk's block rows over
// kSlice bytes of Dp, as the TMA's boxes of kBox bytes land them (the
// 16-byte piece c of row r at piece c ^ (r % 8): swizzled), and its
// entries' query codes, kStride bytes a row (the 16 bytes of padding put
// the 8 rows a fragment load reads on 8 different groups of 4 banks).
//
// The products are mma.sync m16n8k32 (s8 x s8 -> s32): warp w takes the
// 16 rows m0 = 16 (w % 2) and the 8 entries n0 = 8 (w / 2) of a chunk. Lane
// l (group g = l / 4, thread t = l % 4) holds, as PTX lays out the
// fragments, A's rows g and g + 8 at columns 4t .. 4t + 3 and 16 + 4t ..,
// B's entry g at the same columns, and the sums of rows g, g + 8 with
// entries 2t, 2t + 1. Exact: a product of two int8 codes is at most 2^14
// in magnitude, so every sum stays below 2^14 Dp < 2^31 for Dp <= kDpMax
// (the launch refuses more), and int32 sums are the same in any order.
//
// The epilogue is flat_scan.expand_bins' plain arithmetic (kernels/
// u8_block_dot.py:block_scores_plain) in its op order: distance.dequant_dot
// in wrapping int32 and then f32, storage.cos_or_dot, then NEG_INF where
// the row is invalid or the entry's bin sank. Every f32 operation is an
// intrinsic rounded to nearest (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn): nothing contracts into a fused multiply-add. Scores land at
// out[flat * group + row], the (B, K * group) layout of the plain version.
//
// The same source builds for the card and for the host: nvcc makes these
// device functions of the kernel; a host compiler makes them plain
// functions for the CPU test (tests/test_torch_u8_block_dot.py), with host
// versions of the float intrinsics (tests/cuda_emulation/cuda_float_shims.h)
// and of the mma (tests/cuda_emulation/mma_shim.h: a warp of 32 threads
// that exchange their fragments as PTX lays them out).

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define U8_BLOCK_DOT_FN __device__ __forceinline__
#else
#define U8_BLOCK_DOT_FN inline
#endif

namespace u8_block_dot {

constexpr int kThreads = 128;                   // 4 warps: 2 row halves x 2 entry halves
constexpr int kWindow = 16;                     // sorted entries a CTA
constexpr int kTileRows = 32;                   // table rows a CTA (2 m16 tiles)
constexpr int kChunk = 16;                      // entries a pass (2 n8 tiles)
constexpr int kSlice = 256;                     // Dp bytes a stage
constexpr int kBox = 128;                       // Dp bytes a TMA box: the 128-byte swizzle's width
constexpr int kBoxes = kSlice / kBox;           // boxes a slice
constexpr int kTileBytes = kTileRows * kBox;    // a box of the tile's rows in shared memory
constexpr int kStride = kSlice + 16;            // shared bytes a query row of a stage
constexpr int kStages = 2;                      // slices in flight
constexpr int kRowBytes = kBoxes * kTileBytes;  // a stage's rows
constexpr int kQueryBytes = kChunk * kStride;   // a stage's queries
constexpr int kDpMultiple = kBox;               // a row is whole boxes
constexpr int kDpMax = (1 << 17) - kDpMultiple; // 2^14 Dp < 2^31
constexpr int kCosine = 0, kDot = 1, kEuclidean = 2;  // the metric codes of the launch
constexpr float kNegInf = -3.0e38f;             // ops/topk.py NEG_INF
constexpr float kSunk = -1.5e38f;               // NEG_INF / 2: a bin at or below it sank
constexpr float kEps = 1e-30f;                  // ops/distance.py _EPS

// The launch's inputs: the queries (codes, code sums, magnitudes and the
// 0-d scale, offset and true width of their quantization), the table
// (codes, sums, magnitudes, valid bytes), the entries' bin maxima (B, K),
// the sorted block ids and the order of the entries (B * K each), and the
// (B, K * group) f32 scores.
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
  const uint8_t* valid;
  const float* bin_s;
  const int32_t* keys;
  const long long* order;
  float* out;
  long long n_entries, n_blocks;
  int k_blocks, group, dp, d_pad, metric;
};

// What a CTA owns: its window's entries from w0, and rows first_row ..
// first_row + rows - 1 of each block its chunks name, which its boxes
// bring box_rows at a time (rows past the block's are not scored).
struct Tile {
  long long w0;
  int rows, first_row, box_rows;
};

// Entries first .. first + n - 1 of a window, all of table block blk.
struct Chunk {
  int first, n;
  int32_t blk;
};

// A table row's terms, and an entry's.
struct RowTerms {
  int32_t sum;
  float mag;
  int32_t valid;
};
struct EntryTerms {
  long long flat;  // b * K + k: its scores start at out[flat * group]
  int32_t b;       // its query
  int32_t sum;     // the query's code sum and magnitude
  float mag;
  int32_t live;    // its bin did not sink
};

// The query's 0-d terms as dequant_dot combines them: a * a, a * b, (b * b) * dtrue.
struct Consts {
  float aa, ab, bbd;
};

// One bulk copy into a stage: bytes from src to `dst` bytes into the stage (none where bytes is 0).
struct Copy {
  int dst;
  const int8_t* src;
  int bytes;
};

U8_BLOCK_DOT_FN Tile tile_of(const Args& a, long long window, int rt) {
  const int first = rt * kTileRows;
  return Tile{window * kWindow, a.group - first < kTileRows ? a.group - first : kTileRows, first,
              a.group < kTileRows ? a.group : kTileRows};
}

// Entries in window w0 (kWindow but the last).
U8_BLOCK_DOT_FN int window_size(const Args& a, long long w0) {
  return a.n_entries - w0 < kWindow ? static_cast<int>(a.n_entries - w0) : kWindow;
}

// The walk of a window: its n sorted keys cut into chunks, each a run of
// one table block of at most kChunk entries; keys outside the table's
// n_blocks blocks take no chunk (their scores are not written). Returns
// the number of chunks (at most n).
U8_BLOCK_DOT_FN int plan_chunks(const int32_t* keys, int n, long long n_blocks, Chunk* chunks) {
  int m = 0;
  for (int e = 0; e < n; ++e) {
    if (keys[e] < 0 || keys[e] >= n_blocks) continue;
    if (m == 0 || keys[e] != chunks[m - 1].blk || chunks[m - 1].n == kChunk) chunks[m++] = Chunk{e, 0, keys[e]};
    ++chunks[m - 1].n;
  }
  return m;
}

U8_BLOCK_DOT_FN int slices_of(int dp) { return (dp + kSlice - 1) / kSlice; }
// Dp bytes of slice s (the last may be ragged: Dp - s * kSlice, whole boxes).
U8_BLOCK_DOT_FN int slice_width(int dp, int s) { return dp - s * kSlice < kSlice ? dp - s * kSlice : kSlice; }

// The table row of row r of a chunk's tile.
U8_BLOCK_DOT_FN long long table_row(const Args& a, const Tile& t, const Chunk& c, int r) {
  return static_cast<long long>(c.blk) * a.group + t.first_row + r;
}

// A step's boxes of rows: (slice width) / kBox of them, box x at Dp byte
// s * kSlice + x * kBox of the tile's first row, box_rows rows each.
U8_BLOCK_DOT_FN int boxes_of(int width) { return width / kBox; }
U8_BLOCK_DOT_FN int box_col(int s, int x) { return s * kSlice + x * kBox; }

// Where the TMA's 128-byte swizzle puts byte col (< kBox) of row r of a box.
U8_BLOCK_DOT_FN int swizzled(int r, int col) { return r * kBox + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15)); }

// The bytes a step of chunk c brings into its stage: the boxes of its rows
// and the chunk's queries over slice s.
U8_BLOCK_DOT_FN uint32_t step_bytes(const Args& a, const Tile& t, const Chunk& c, int s) {
  const int width = slice_width(a.dp, s);
  return static_cast<uint32_t>(boxes_of(width) * t.box_rows * kBox + c.n * width);
}

// The copy thread j issues for a step (chunk c, slice s): the slice of the
// query of the chunk's entry j (whose terms are entries[j]) into stage
// query row j.
U8_BLOCK_DOT_FN Copy query_copy(const Args& a, const Chunk& c, const EntryTerms* entries, int s, int j) {
  if (j >= c.n) return Copy{0, nullptr, 0};
  return Copy{j * kStride, a.q_codes + static_cast<long long>(entries[j].b) * a.dp + static_cast<long long>(s) * kSlice,
              slice_width(a.dp, s)};
}

U8_BLOCK_DOT_FN RowTerms row_terms(const Args& a, long long row) {
  return RowTerms{a.sums[row], a.mags[row], a.valid[row] != 0};
}

// The terms of the window's sorted entry e (read once, when a CTA starts).
U8_BLOCK_DOT_FN EntryTerms entry_terms(const Args& a, long long e) {
  const long long flat = a.order[e];
  const int32_t b = static_cast<int32_t>(flat / a.k_blocks);
  return EntryTerms{flat, b, a.q_sums[b], a.q_mags[b], a.bin_s[flat] > kSunk};
}

U8_BLOCK_DOT_FN Consts consts_of(float qa, float qb, float dtrue) {
  return Consts{__fmul_rn(qa, qa), __fmul_rn(qa, qb), __fmul_rn(__fmul_rn(qb, qb), dtrue)};
}

// One score from its int32 code dot cc, in the plain version's op order.
U8_BLOCK_DOT_FN float score(int metric, int32_t cc, const EntryTerms& e, const RowTerms& v, const Consts& k,
                            int d_pad) {
  if (!e.live || !v.valid) return kNegInf;
  // dequant_dot: (cc + 128 (s_q + s_v) + Dp 128^2), f32(s_q + 128 Dp), f32(s_v + 128 Dp), wrapping as int32 does
  const uint32_t dp128 = 128u * static_cast<uint32_t>(d_pad);
  const uint32_t code = static_cast<uint32_t>(cc) + 128u * (static_cast<uint32_t>(e.sum) + static_cast<uint32_t>(v.sum)) +
                        128u * dp128;
  const float uq = __int2float_rn(static_cast<int32_t>(static_cast<uint32_t>(e.sum) + dp128));
  const float uv = __int2float_rn(static_cast<int32_t>(static_cast<uint32_t>(v.sum) + dp128));
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(k.aa, __int2float_rn(static_cast<int32_t>(code))),
                                        __fmul_rn(k.ab, __fadd_rn(uq, uv))),
                              k.bbd);
  if (metric == kDot) return dot;
  if (metric == kCosine) {
    const float den = __fmul_rn(e.mag, v.mag);
    return den > kEps ? __fdiv_rn(dot, den) : 0.0f;  // safe_div
  }
  // euclidean: -sqrt(clamp_min((|q|^2 + |v|^2) - 2 dot, 0)); a NaN stays a NaN, as clamp_min keeps it
  const float d2 = __fsub_rn(__fadd_rn(__fmul_rn(e.mag, e.mag), __fmul_rn(v.mag, v.mag)), __fmul_rn(2.0f, dot));
  return -__fsqrt_rn(d2 < 0.0f ? 0.0f : d2);
}

U8_BLOCK_DOT_FN uint32_t lds32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

#ifdef __CUDACC__
// d += A (16 x 32, row) . B (32 x 8, col), s8 x s8 -> s32, on the tensor
// cores. wgmma would want a 64-row A, and a block has 32 rows: mma.sync's
// 16-row tiles fit it.
__device__ __forceinline__ void mma_m16n8k32_s8(int32_t (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// Lane l's products over one slice of `width` bytes of a stage (its rows'
// boxes, swizzled, and its queries): the 16 rows from m0 with the 8
// entries from n0, added to acc (the m16n8 accumulator fragment).
U8_BLOCK_DOT_FN void slice_products(const int8_t* rows, const int8_t* queries, int m0, int n0, int width, int lane,
                                    int32_t (&acc)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* q = queries + (n0 + g) * kStride + 4 * t;
  for (int k = 0; k < width; k += 32) {
    const int8_t* box = rows + (k / kBox) * kTileBytes;
    const int col = k % kBox + 4 * t;
    const uint32_t af[4] = {lds32(box + swizzled(m0 + g, col)), lds32(box + swizzled(m0 + g + 8, col)),
                            lds32(box + swizzled(m0 + g, col + 16)), lds32(box + swizzled(m0 + g + 8, col + 16))};
    const uint32_t bf[2] = {lds32(q + k), lds32(q + k + 16)};
    mma_m16n8k32_s8(acc, af, bf);
  }
}

// Lane l's row terms: rows m0 + g and m0 + g + 8 of the chunk's tile,
// where they lie in it (read when the chunk's first slice is multiplied,
// used with its last).
U8_BLOCK_DOT_FN void lane_rows(const Args& a, const Tile& t, const Chunk& c, int m0, int lane, RowTerms (&rows)[2]) {
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + (lane >> 2) + 8 * h;
    if (r < t.rows) rows[h] = row_terms(a, table_row(a, t, c, r));
  }
}

// The scatter: lane l's four sums of a chunk (rows m0 + g, m0 + g + 8 with
// entries n0 + 2t, n0 + 2t + 1; entries[j] the terms of the chunk's entry
// j) scored and written, where the row lies in the tile and the entry in
// the chunk.
U8_BLOCK_DOT_FN void write_scores(const Args& a, const Tile& t, const RowTerms (&rows)[2], const EntryTerms* entries,
                                  int n, const Consts& k, int m0, int n0, int lane, const int32_t (&acc)[4]) {
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + (lane >> 2) + 8 * (i >> 1), j = n0 + 2 * (lane & 3) + (i & 1);
    if (r < t.rows && j < n) {
      a.out[entries[j].flat * a.group + t.first_row + r] =
          score(a.metric, acc[i], entries[j], rows[i >> 1], k, a.d_pad);
    }
  }
}

}  // namespace u8_block_dot

#undef U8_BLOCK_DOT_FN
