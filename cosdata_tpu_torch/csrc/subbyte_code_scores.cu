// Sub-byte code dots on the int8 tensor cores: out[q, r] = sum_d qcode[q, d]
// * vcode[r, d], exact in int32, for codes 0..2^res-1 given as res packed
// bitplanes (res = 1, 2 or 3); and, from the same product, the scores the
// chunked scan selects on.
//
// Replaces the Pallas TPU kernel cosdata_tpu/ops/pallas/subbyte_scan.py
// (subbyte_code_scores, kernel _make_kernel) and computes the same function
// the same way: unpack the planes to codes on chip, then contract them on
// the matrix unit. Its fused entry also takes in the work that XLA fuses
// around that call on the TPU: the score epilogue of subbyte_scores
// (subbyte_scan.py:90-114), the mask of flat_scan_topk
// (cosdata_tpu/ops/flat_scan.py:79-80) and the maxima the shortlist
// selects on.
//
// Layouts: q_planes (res, B, W) and planes (res, C, W) of 32-bit words;
// rows are contiguous within a plane, planes lie plane_stride words apart
// (a chunk of a larger store is a view, not a copy). The pack is strided
// (bit i of word w is dimension i*W + w). A sum is exact in any order, so
// both sides unpack into the same WORD-MAJOR order instead: position
// w*32 + i holds bit i of word w, and one word expands to 32 consecutive
// code bytes with nothing to un-stride. q_codes is the (B, 32 W) int8
// query side so unpacked.
//
// Two outputs of the one product kernel (entry points _launch and
// _launch_fused):
// - raw: out is the (B, C) int32 code dots;
// - fused (dot or cosine): out is the (B, C) f32 score
//   ((a²·cd) + (a·b)·(s_q + s_v)) + b²·d_true, divided by m_q·m_v for
//   cosine (0 where that is <= 1e-30), NEG_INF where the row's mask byte is
//   0, each product, sum and quotient rounded alone (__fmul_rn, __fadd_rn
//   and the correctly rounded div_rn: nothing contracts into an FMA), so
//   it equals the plain PyTorch epilogue bit for bit; and gmax is the
//   (B, ceil(C / 32)) f32 maxima of 32 consecutive rows, which the scan's
//   shortlist selects on (csrc/group_topk.cu).
//
// What bounds it on an H100: at B=1024, C=65,536, Dp=768, res=2 the
// product is 1.03e11 int8 operations (0.052 ms at the 1,979 TOP/s peak);
// the f32 scores are 268 MB and the group maxima 8.4 MB (0.083 ms at 3.35
// TB/s), the planes and row terms 13.2 MB. So it is bound by writing the
// scores, the same bytes the raw entry's int32 dots take. Before the fused
// entry, the scan read those dots back through a dozen eager passes (the
// int32 -> f32 copy, the epilogue's products and sums, the division, the
// mask) and a full-width top-k: 52 of the 61 device ms of a 1M b1024
// quaternary batch on that card. What bounds the fused kernel in practice
// is its epilogue: it runs between a block's products with the block's 8
// consumer warps, so its ~10 instructions a score (~20 with the division)
// add to the tile's time rather than hide under the next tile's products.
//
// The design: a small kernel (entry point _unpack_queries) unpacks the
// query planes into q_codes, once per batch: a scan of many row chunks
// passes the same q_codes to every chunk's product. The product kernel
// gives each block 128 store rows: its consumer threads unpack the rows'
// planes once into shared memory as int8 codes in the 128-byte-swizzled
// K-major layout wgmma reads (up to 1,024 codes of Dp at a time; a longer
// Dp runs in chunks whose int32 sums pass through out), and the fused
// kernel puts the rows' code sums, magnitudes and mask bytes beside them.
// The block then walks every 128-query tile: a producer warp streams the
// query codes in 128-byte K-slices with TMA through a 3-stage ring, and two
// consumer warpgroups (64 queries each) run wgmma m64n128k32 s8.s8.s32
// against the resident store codes. The fused epilogue turns each
// accumulator into its score in registers and takes the group maxima with
// two quad shuffles; each output tile is staged through shared memory, 64
// columns at a time, and written with coalesced 16-byte stores (4-byte
// stores where C is not a multiple of 4, and at the ragged edge); the
// stores drain while the next tile's products run. Ragged rows and queries
// are masked; any C >= 1 and any W >= 1 are taken. The epilogue keeps its
// loads off the critical path (the query terms are read while the tile's
// products run, each column's row terms once for both of a thread's rows)
// and divides without a branch (div_rn), so its 64 scores a thread
// interleave. Measured on an NVIDIA H100 80GB HBM3 at 700 W at the shape
// above, back to back (tools/kernel_variants.py): the raw entry 0.188 ms,
// 45% of its bound; the fused entry 0.256 ms by dot and 0.328 by cosine,
// 26% of its 0.0866 ms bound (0.401 with __fdiv_rn); 0.434 ms as a single
// call with the query unpack (chip_smoke.py phase 5).

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper_mma.cuh"

namespace {

constexpr int kBM = 128;                          // queries per tile (two warpgroups of 64)
constexpr int kBN = 128;                          // store rows per block
constexpr int kBK = 128;                          // codes per K-slice
constexpr int kKMax = 1024;                       // store codes per row held unpacked at once
constexpr int kStages = 3;                        // query K-slices in flight
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 32;   // + one producer warp
constexpr int kSliceBytes = kBN * kBK;
constexpr int kABytes = kBM * kBK;
constexpr int kHalf = 64;                         // output columns staged per pass
constexpr int kStageStride = kHalf + 4;           // ints per staged row (+4 against bank conflicts)
constexpr int kResBytes = kKMax / kBK * kSliceBytes;
constexpr int kOutBytes = kBM * kStageStride * 4;
constexpr int kRowTermBytes = kBN * (4 + 4 + 1);  // the block's row sums, magnitudes and mask
constexpr int kSmemBytes = kResBytes + kStages * kABytes + kOutBytes + 2 * kStages * 8 + kRowTermBytes + 1024;
constexpr int kConsumerBar = 1;                   // named barrier of the consumer warpgroups
constexpr int kGroup = 32;                        // rows per group maximum
constexpr float kNegInf = -3.0e38f;               // a masked row's score (ops/topk.py NEG_INF)
constexpr float kEps = 1e-30f;                    // the cosine's smallest denominator (ops/distance.py _EPS)

// What the product kernel writes: the raw int32 code dots, or the f32 dot or
// cosine scores with the mask and the group maxima.
enum Mode : int { kRaw = 0, kDot = 1, kCosine = 2 };

// The score epilogue's inputs (device pointers). The scalars a, b and dtrue
// are the quantization's 0-d tensors; their products are rounded here as
// the plain version rounds them.
struct Epilogue {
  const int32_t* q_sums;  // (B,) query code sums
  const float* q_mags;    // (B,) query magnitudes (cosine)
  const int32_t* v_sums;  // (C,) row code sums
  const float* v_mags;    // (C,) row magnitudes (cosine)
  const uint8_t* valid;   // (C,) row mask; nullptr: every row is valid
  const float* a;
  const float* b;
  const float* dtrue;
  float* gmax;            // (B, ceil(C / 32)) maxima of 32 consecutive rows' scores
};

// a / b rounded to nearest f32, as __fdiv_rn gives it, for b >= 1e-30 and
// any finite a, with no branch (__fdiv_rn's slow-path call keeps the
// compiler from interleaving the epilogue's 64 divisions). The quotient is
// taken in f64 from an f32 reciprocal estimate and two Newton steps, within
// 2^-51 of a / b; a quotient of two f32 values is never a midpoint of f32
// and lies at least 2^-49 (relative) from every one, so rounding that f64
// value to f32 gives the correctly rounded quotient.
__device__ __forceinline__ float div_rn(float a, float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  const double bd = b;
  double y = r;
  y = fma(y, fma(-bd, y, 1.0), y);
  y = fma(y, fma(-bd, y, 1.0), y);
  return __double2float_rn(static_cast<double>(a) * y);
}

// The 32 codes of one word position, word-major: byte i of (lo, hi) is
// sum_p bit i of words[p] << (RES - 1 - p) (plane 0 is the MSB). A nibble
// times 0x00204081 puts its bit k at bit 8k, with no carries.
template <int RES>
__device__ __forceinline__ void unpack_word(const uint32_t (&words)[RES], uint4& lo, uint4& hi) {
  uint32_t v[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    uint32_t x = 0;
#pragma unroll
    for (int p = 0; p < RES; ++p) {
      x |= (((words[p] >> (4 * g)) & 0xFu) * 0x00204081u & 0x01010101u) << (RES - 1 - p);
    }
    v[g] = x;
  }
  lo = make_uint4(v[0], v[1], v[2], v[3]);
  hi = make_uint4(v[4], v[5], v[6], v[7]);
}

template <int RES>
__global__ void unpack_queries_kernel(const uint32_t* __restrict__ q_planes, long long q_plane_stride,
                                      uint8_t* __restrict__ q_codes, int B, int W) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * W) return;
  uint32_t words[RES];
#pragma unroll
  for (int p = 0; p < RES; ++p) words[p] = q_planes[p * q_plane_stride + i];
  uint4 lo, hi;
  unpack_word<RES>(words, lo, hi);
  uint4* dst = reinterpret_cast<uint4*>(q_codes + i * 32);  // row q, word w: q*32W + 32w
  dst[0] = lo;
  dst[1] = hi;
}

template <int RES, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
subbyte_code_scores_kernel(const __grid_constant__ CUtensorMap q_map, const uint32_t* __restrict__ planes,
                           long long plane_stride, int32_t* __restrict__ out, const Epilogue ep, int B,
                           long long C, int W, int n_qtiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* codes = smem;                     // resident store codes, kKMax / kBK swizzled slices
  uint8_t* ring = smem + kResBytes;          // query K-slices
  int32_t* staged = reinterpret_cast<int32_t*>(ring + kStages * kABytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kResBytes + kStages * kABytes + kOutBytes);
  uint64_t* empty = full + kStages;
  float* row_sum = reinterpret_cast<float*>(empty + kStages);
  float* row_mag = row_sum + kBN;
  uint8_t* row_ok = reinterpret_cast<uint8_t*>(row_mag + kBN);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * kBN;
  const int dp = 32 * W;
  const int n_kc = (dp + kKMax - 1) / kKMax;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // producer warp: one lane issues every copy
    if (threadIdx.x == kConsumerThreads) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kc = 0; kc < n_kc; ++kc) {
        const int k0 = kc * kKMax;
        const int n_ks = (min(kKMax, dp - k0) + kBK - 1) / kBK;
        for (int qt = 0; qt < n_qtiles; ++qt) {
          for (int ks = 0; ks < n_ks; ++ks) {
            hopper::mbar_wait(&empty[stage], phase ^ 1);
            hopper::mbar_arrive_expect_tx(&full[stage], kABytes);
            hopper::tma_load_2d(ring + stage * kABytes, &q_map, &full[stage], k0 + ks * kBK, qt * kBM);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  const int ctid = threadIdx.x;  // 0 .. kConsumerThreads - 1
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int quad = lane & 3;
  const int row_lo = wg * 64 + (tid / 32) * 16 + lane / 4;  // this thread's tile rows: row_lo, row_lo + 8
  const bool vec_out = C % 4 == 0;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  int32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  // the epilogue's constants: a², a·b and b²·d_true as the plain version
  // rounds them, and the block's row terms (read after the first barrier)
  float aa = 0.f, ab = 0.f, bbd = 0.f;
  const long long n_groups = (C + kGroup - 1) / kGroup;
  if (MODE != kRaw) {
    const float a = __ldg(ep.a), b = __ldg(ep.b);
    aa = __fmul_rn(a, a);
    ab = __fmul_rn(a, b);
    bbd = __fmul_rn(__fmul_rn(b, b), __ldg(ep.dtrue));
    if (ctid < kBN) {
      const long long col = r0 + ctid;
      const bool in = col < C;
      row_sum[ctid] = in ? __int2float_rn(__ldg(ep.v_sums + col)) : 0.f;
      row_mag[ctid] = in && MODE == kCosine ? __ldg(ep.v_mags + col) : 0.f;
      row_ok[ctid] = in && (ep.valid == nullptr || __ldg(ep.valid + col) != 0);
    }
  }

  for (int kc = 0; kc < n_kc; ++kc) {
    const int k0 = kc * kKMax;
    const int n_ks = (min(kKMax, dp - k0) + kBK - 1) / kBK;
    const int w0 = k0 / 32;
    const int n_w = min(kKMax, dp - k0) / 32;  // words of this chunk
    const int n_wpad = n_ks * (kBK / 32);      // words the slices hold (zeros past n_w)

    // unpack this chunk of the block's store rows (the last chunk's products are done)
    hopper::bar_sync(kConsumerBar, kConsumerThreads);
    for (int i = ctid; i < kBN * n_wpad; i += kConsumerThreads) {
      const int row = i / n_wpad;
      const int w = i % n_wpad;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u);
      uint4 hi = lo;
      if (r0 + row < C && w < n_w) {
        const uint32_t* src = planes + (r0 + row) * W + w0 + w;
        uint32_t words[RES];
#pragma unroll
        for (int p = 0; p < RES; ++p) words[p] = __ldg(src + p * plane_stride);
        unpack_word<RES>(words, lo, hi);
      }
      uint8_t* dst = codes + (w / 4) * kSliceBytes + row * kBK;
      const int c = 2 * (w % 4);
      *reinterpret_cast<uint4*>(dst + ((c ^ (row & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(dst + (((c + 1) ^ (row & 7)) << 4)) = hi;
    }
    hopper::fence_proxy_async();
    hopper::bar_sync(kConsumerBar, kConsumerThreads);

    const bool last = kc == n_kc - 1;
    for (int qt = 0; qt < n_qtiles; ++qt) {
      // the epilogue's query terms, loaded while the products run
      float sq[2] = {0.f, 0.f}, mq[2] = {0.f, 0.f};
      bool q_in[2] = {false, false};
      if (MODE != kRaw && last) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = qt * kBM + row_lo + 8 * h;
          q_in[h] = q < B;
          if (q_in[h]) {
            sq[h] = __int2float_rn(__ldg(ep.q_sums + q));
            if (MODE == kCosine) mq[h] = __ldg(ep.q_mags + q);
          }
        }
      }
      for (int ks = 0; ks < n_ks; ++ks) {
        hopper::mbar_wait(&full[stage], phase);
        const uint8_t* a = ring + stage * kABytes + wg * 64 * kBK;
        const uint8_t* b = codes + ks * kSliceBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          hopper::wgmma_m64n128k32_s8(acc, hopper::sw128_desc(a + kk * 32), hopper::sw128_desc(b + kk * 32),
                                      (ks | kk) != 0);
        }
        hopper::wgmma_commit();
        // one group stays in flight: the previous slice's is done, release its stage
        hopper::wgmma_wait<1>();
        if (ks > 0 && tid == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (tid == 0) hopper::mbar_arrive(&empty[prev]);

      // the score epilogue, on the last K-chunk's accumulators: each code dot
      // (plus the earlier chunks' int32 sums, which this block wrote to out)
      // becomes ((a²·cd) + (a·b)·(s_q + s_v)) + b²·d_true, each step rounded
      // alone, then / (m_q·m_v) for cosine (0 where that is <= kEps); a masked
      // row scores kNegInf. The f32 bits go back into acc for the stores below.
      // A group of 32 rows is 4 column blocks of 8: this thread's 8 values,
      // then the 4 threads of its quad (lane & 3) hold the rest.
      if (MODE != kRaw && last) {
        if (kc > 0) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int q = qt * kBM + row_lo + 8 * ((i / 2) % 2);
            const long long col = r0 + 8 * (i / 4) + 2 * quad + i % 2;
            if (q < B && col < C) acc[i] += out[static_cast<long long>(q) * C + col];
          }
        }
        float gm[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int g = 0; g < 4; ++g) gm[h][g] = kNegInf;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * quad + e;
            const float sv = row_sum[col];
            const float mv = row_mag[col];
            const bool ok = row_ok[col] != 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              const float dot = __fadd_rn(
                  __fadd_rn(__fmul_rn(aa, __int2float_rn(acc[i])), __fmul_rn(ab, __fadd_rn(sq[h], sv))), bbd);
              float score = dot;
              if (MODE == kCosine) {
                const float den = __fmul_rn(mq[h], mv);
                score = den > kEps ? div_rn(dot, den) : 0.f;
              }
              score = ok ? score : kNegInf;
              acc[i] = __float_as_int(score);
              gm[h][j / 4] = fmaxf(gm[h][j / 4], score);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = qt * kBM + row_lo + 8 * h;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float m = gm[h][g];
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            const long long grp = r0 / kGroup + g;
            if (quad == g && q_in[h] && grp < n_groups) ep.gmax[static_cast<long long>(q) * n_groups + grp] = m;
          }
        }
      }
      // earlier K-chunks' sums are added at the store, except where the
      // epilogue has taken them
      const bool add = kc > 0 && (MODE == kRaw || !last);

      // the (128, 128) tile, staged 64 columns at a time, stored row by row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        hopper::bar_sync(kConsumerBar, kConsumerThreads);  // the staging buffer is free
#pragma unroll
        for (int jj = 0; jj < kHalf / 8; ++jj) {
          const int j = half * (kHalf / 8) + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<int2*>(staged + (row_lo + 8 * h) * kStageStride + 8 * jj + 2 * quad) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        hopper::bar_sync(kConsumerBar, kConsumerThreads);
#pragma unroll
        for (int it = 0; it < kBM * kHalf / 4 / kConsumerThreads; ++it) {
          const int idx = it * kConsumerThreads + ctid;
          const int row = idx / (kHalf / 4);
          const int c4 = idx % (kHalf / 4);
          const int q = qt * kBM + row;
          const long long col = r0 + half * kHalf + 4 * c4;
          if (q >= B || col >= C) continue;
          int4 v = *reinterpret_cast<const int4*>(staged + row * kStageStride + 4 * c4);
          int32_t* dst = out + static_cast<long long>(q) * C + col;
          if (vec_out && col + 3 < C) {
            if (add) {
              const int4 o = *reinterpret_cast<const int4*>(dst);
              v.x += o.x;
              v.y += o.y;
              v.z += o.z;
              v.w += o.w;
            }
            *reinterpret_cast<int4*>(dst) = v;
          } else {
            const int32_t vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (col + e < C) dst[e] = add ? dst[e] + vals[e] : vals[e];
            }
          }
        }
      }
    }
  }
}

template <int RES>
int unpack(const void* q_planes, long long q_plane_stride, void* q_codes, int B, int W, cudaStream_t stream) {
  const long long words = static_cast<long long>(B) * W;
  unpack_queries_kernel<RES><<<static_cast<unsigned>((words + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint32_t*>(q_planes), q_plane_stride, static_cast<uint8_t*>(q_codes), B, W);
  return static_cast<int>(cudaGetLastError());
}

template <int RES, int MODE>
int launch(const void* q_codes, const void* planes, long long plane_stride, void* out, const Epilogue& ep, int B,
           long long C, int W, cudaStream_t stream) {
  CUtensorMap q_map;
  const int dp = 32 * W;
  const int err = hopper::encode_tma_2d_u8(&q_map, q_codes, dp, B, dp, kBK, kBM);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(subbyte_code_scores_kernel<RES, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((C + kBN - 1) / kBN);
  subbyte_code_scores_kernel<RES, MODE><<<blocks, kThreads, kSmemBytes, stream>>>(
      q_map, static_cast<const uint32_t*>(planes), plane_stride, static_cast<int32_t*>(out), ep, B, C, W,
      (B + kBM - 1) / kBM);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_res(int res, const void* q_codes, const void* planes, long long plane_stride, void* out,
               const Epilogue& ep, int B, long long C, int W, cudaStream_t stream) {
  switch (res) {
    case 1:
      return launch<1, MODE>(q_codes, planes, plane_stride, out, ep, B, C, W, stream);
    case 2:
      return launch<2, MODE>(q_codes, planes, plane_stride, out, ep, B, C, W, stream);
    case 3:
      return launch<3, MODE>(q_codes, planes, plane_stride, out, ep, B, C, W, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int B, long long C, int W) {
  return B <= 0 || C <= 0 || W <= 0 || (C + kBN - 1) / kBN > INT_MAX || W > INT_MAX / 32;
}

}  // namespace

// Pointers are device pointers: q_planes to 32-bit words, q_codes to the
// (B, 32 W) int8 query codes (16-byte aligned). The plane stride counts
// words. Returns the cudaError_t of the launch.
extern "C" int subbyte_code_scores_unpack_queries(int res, const void* q_planes, long long q_plane_stride,
                                                  void* q_codes, int B, int W, void* stream) {
  if (B <= 0 || W <= 0 || W > INT_MAX / 32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (res) {
    case 1:
      return unpack<1>(q_planes, q_plane_stride, q_codes, B, W, s);
    case 2:
      return unpack<2>(q_planes, q_plane_stride, q_codes, B, W, s);
    case 3:
      return unpack<3>(q_planes, q_plane_stride, q_codes, B, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q_codes as subbyte_code_scores_unpack_queries wrote it; planes to 32-bit
// words, plane_stride words apart; out to (B, C) int32. Returns the
// cudaError_t of the launch.
extern "C" int subbyte_code_scores_launch(const void* q_codes, const void* planes, long long plane_stride, void* out,
                                          int res, int B, long long C, int W, void* stream) {
  if (bad_shape(B, C, W)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_res<kRaw>(res, q_codes, planes, plane_stride, out, Epilogue{}, B, C, W,
                          static_cast<cudaStream_t>(stream));
}

// The same product with the score epilogue: out to (B, C) f32 scores and
// gmax to (B, ceil(C / 32)) f32 group maxima; metric 1 is dot, 2 cosine.
// q_sums, v_sums int32; q_mags, v_mags f32 (read for cosine only); valid one
// byte per row, or null for every row; a, b, dtrue f32 scalars on the card.
// Returns the cudaError_t of the launch.
extern "C" int subbyte_code_scores_launch_fused(const void* q_codes, const void* planes, long long plane_stride,
                                                void* out, void* gmax, const void* q_sums, const void* q_mags,
                                                const void* v_sums, const void* v_mags, const void* valid,
                                                const void* a, const void* b, const void* dtrue, int metric, int res,
                                                int B, long long C, int W, void* stream) {
  if (bad_shape(B, C, W)) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{static_cast<const int32_t*>(q_sums), static_cast<const float*>(q_mags),
                    static_cast<const int32_t*>(v_sums), static_cast<const float*>(v_mags),
                    static_cast<const uint8_t*>(valid),   static_cast<const float*>(a),
                    static_cast<const float*>(b),         static_cast<const float*>(dtrue),
                    static_cast<float*>(gmax)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kDot:
      return launch_res<kDot>(res, q_codes, planes, plane_stride, out, ep, B, C, W, s);
    case kCosine:
      return launch_res<kCosine>(res, q_codes, planes, plane_stride, out, ep, B, C, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* subbyte_code_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
