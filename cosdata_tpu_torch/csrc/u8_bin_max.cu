// u8 scan with the dequantization epilogue and the per-bin max fused in:
// the (B, C) score matrix is never written to device memory.
//
// Replaces the Pallas TPU kernel cosdata_tpu/ops/pallas/u8_scan.py
// (u8_bin_max, kernel _make_kernel) and computes the same function:
//
//   cc  = q_codes . codes^T                    int8 x int8 -> int32
//   dot = (a2 * cc + v_add[row]) + q_add[q]
//   sc  = dot * v_inv[row] * q_inv[q]          (cosine)
//   sc  = dot * v_inv[row]                     (dot)
//   sc  = sc + v_sink[row]                     (-3e38 on invalid rows)
//   out[q, j] = max over rows j*32 .. j*32+31 of sc[q, row]
//
// and, for euclidean (which the Pallas kernel does not compute), the
// reference's euclidean_u8 (cosdata_tpu/ops/distance.py:60-77) in its own
// op order: the least d2 of a bin's rows and one square root a bin, from
// terms in the types that epilogue needs, so that a score costs one int ->
// float conversion (u8_euclidean.cuh, which states why each is exact).
//
// The bins are CONTIGUOUS groups of 32 rows, out is (B, C/32) f32. (The
// Pallas kernel emits strided row groups, transposed, because Mosaic lowers
// nothing else; the torch engine expands contiguous bins.)
//
// What bounds it on an H100: at B=1024, C=1,048,576, Dp=768 the product is
// 1.65e12 int8 operations against 0.81 GB of codes, 0.83 ms at the 1,979
// TOP/s int8 tensor-core peak against 0.28 ms for the bytes, so it is bound
// by the tensor cores; at B <= 128 (one served request) it is bound by
// reading the codes once (0.25 ms).
//
// The design: the product runs on the int8 tensor cores (wgmma m64n128k32
// s8.s8.s32 from shared memory), both operands K-major, i.e. the (B, Dp)
// and (C, Dp) row-major codes as they lie. A block owns a tile of 128
// queries (two consumer warpgroups of 64) by 256 store rows and computes
// it as two halves of 128 rows, each into an accumulator of its own (64
// registers a thread). A warpgroup issues one half's products, then runs
// the epilogue of the other accumulator (this tile's other half, or the
// tile before's) while the ring loads the next half's K-slices, then
// issues that half's products: the epilogue runs under loads, not under
// products. Under products it does not pay: the tensor cores keep busy
// only while both consumer warpgroups issue, and an epilogue sliced
// between K-slices ran slower than whole (PERF.md, section 6, PR 18). A
// half needs the query codes again, so they cross L2 once per
// 128 store rows, not once per 256: the products alone take longer than
// the one 256-column accumulator's did, and the epilogue hides under that.
//
// A producer warpgroup keeps a ring of 6 K-slices (128 bytes of Dp for the
// 128 queries and a half's 128 rows, 32 KB) in flight with TMA, guarded by
// full/empty mbarriers; rows past B or C read as zeros. One of its threads
// issues the copies; the warpgroup hands its registers to the consumers
// (setmaxnreg). The grid is persistent (one block per SM) and walks the
// tiles query tile fastest, so the query tiles that share a store tile run
// back to back on neighbouring SMs and the codes come from device memory
// about once.
//
// The epilogue runs in registers in the Pallas kernel's f32 op order
// (__fmul_rn/__fadd_rn keep nvcc from contracting it into FMAs): a 32-row
// bin is 8 accumulator columns of one thread times the 4 lanes of a quad,
// so its max (or least d2) is a tree over 8 values and two __shfl_xor_sync
// steps. The row terms of a tile reach shared memory by bulk copies a tile
// ahead and are read with ld.shared; the query terms load under the
// products.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, back to back at the shape
// above (tools/kernel_times.py and tools/kernel_variants.py, PR 18; every
// run in PERF.md): cosine 1.37-1.38 ms, 60% of the bound (the earlier
// single accumulator: 1.46-1.48), euclidean 1.54 (earlier 2.22-2.27),
// 0.29 at B=128 (bytes-bound, unchanged). Without its epilogue the kernel
// takes 1.27-1.35: what holds it there is the query codes read twice a
// tile, and what remains of the euclidean epilogue (10 instructions a score
// to cosine's 8) is exposed above it.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper_mma.cuh"
#include "u8_euclidean.cuh"

namespace {

constexpr int kGroup = 32;                 // store rows per bin
constexpr int kBM = 128;                   // queries per tile (two warpgroups of 64)
constexpr int kBN = 256;                   // store rows per tile
constexpr int kHalf = kBN / 2;             // store rows per pass (one n128 product)
constexpr int kBK = 128;                   // code bytes per K-slice (one swizzle row)
constexpr int kStages = 6;                 // K-slices in flight
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kABytes = kBM * kBK;
constexpr int kBBytes = kHalf * kBK;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kTermBytes = 3 * kBN * 4;    // a tile's three 4-byte row terms
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kTermBytes + (2 * kStages + 4) * 8 + 1024;
constexpr int kBinsPerHalf = kHalf / kGroup;
constexpr int kCosine = 0, kDot = 1, kEuclidean = 2;  // the metric codes of the launch

// A tile's query terms for the two rows of a thread, and where its output goes.
struct TileRows {
  uint32_t t0[2];      // cosine, dot: q_add's bits; euclidean: q_code
  float t1[2], t2[2];  // cosine, dot: q_inv, unused; euclidean: q_u, q_sq
  int q_lo;            // the thread's rows are q_lo and q_lo + 8
  int bin0;            // the tile's first bin
  int tb;              // the tile's buffer of row terms
  uint32_t tb_parity;  // the phase of terms_full[tb] that holds them
};

// What the epilogue reads and writes besides a tile's rows.
struct Epilogue {
  uint32_t terms;  // [2][3][kBN] row terms: their shared-memory address
  float* out;
  int B, n_bins, quad;
  float a2, ab, bbd;
};

// Two 4-byte words of shared memory at address a.
__device__ __forceinline__ uint2 lds2(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

// Bin kBin of one half of a tile: this thread's 8 scores of it for each of
// its two rows, reduced as a tree, then across its quad; lane kBin of the
// quad keeps the bin (cosine, dot: the maximum; euclidean: the least d2).
// t0: the shared-memory address of the half's first row term.
template <int kMetric, int kBin>
__device__ __forceinline__ void half_bin(const int32_t (&acc)[64], uint32_t t0, const TileRows& r, float a2,
                                         float ab, float bbd, int quad, float (&keep)[2]) {
  float sc[2][kGroup / 4];
#pragma unroll
  for (int jj = 0; jj < kGroup / 8; ++jj) {
    const int j = kBin * (kGroup / 8) + jj;  // n8 block of the accumulator
    const uint32_t col = t0 + 4 * (8 * j + 2 * quad);  // this thread's rows col, col + 1 of the half
    const uint2 w0 = lds2(col);
    const uint2 w1 = lds2(col + 4 * kBN);
    const uint2 w2 = lds2(col + 8 * kBN);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int32_t cc = acc[4 * j + 2 * h + e];
        const uint32_t v0 = e ? w0.y : w0.x;
        const float v1 = __uint_as_float(e ? w1.y : w1.x);
        const float v2 = __uint_as_float(e ? w2.y : w2.x);
        if constexpr (kMetric == kEuclidean) {
          sc[h][2 * jj + e] = u8_euclidean::d2(cc, static_cast<int32_t>(r.t0[h]), r.t1[h], r.t2[h],
                                               static_cast<int32_t>(v0), v1, v2, a2, ab, bbd);
        } else {
          const float dot = __fadd_rn(__fadd_rn(__fmul_rn(a2, __int2float_rn(cc)), __uint_as_float(v0)),
                                      __uint_as_float(r.t0[h]));
          float x = __fmul_rn(dot, v1);
          if (kMetric == kCosine) x = __fmul_rn(x, r.t1[h]);
          sc[h][2 * jj + e] = __fadd_rn(x, v2);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m;
    if constexpr (kMetric == kEuclidean) {
      m = fminf(fminf(fminf(sc[h][0], sc[h][1]), fminf(sc[h][2], sc[h][3])),
                fminf(fminf(sc[h][4], sc[h][5]), fminf(sc[h][6], sc[h][7])));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    } else {
      m = fmaxf(fmaxf(fmaxf(sc[h][0], sc[h][1]), fmaxf(sc[h][2], sc[h][3])),
                fmaxf(fmaxf(sc[h][4], sc[h][5]), fmaxf(sc[h][6], sc[h][7])));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    }
    if (quad == kBin) keep[h] = m;
  }
}

// The epilogue of half `half` of tile r, from acc: its 4 bins, then its
// output, lane quad k of the quad storing bin k of the half for both its
// rows. A bin lies wholly inside or past C.
template <int kMetric>
__device__ __forceinline__ void half_epilogue(const int32_t (&acc)[64], const Epilogue& x, const TileRows& r,
                                              int half) {
  const uint32_t t0 = x.terms + 4 * (r.tb * 3 * kBN + half * kHalf);
  const int bin = r.bin0 + half * kBinsPerHalf;  // the half's first
  float keep[2] = {0.0f, 0.0f};
  if (bin < x.n_bins) half_bin<kMetric, 0>(acc, t0, r, x.a2, x.ab, x.bbd, x.quad, keep);
  if (bin + 1 < x.n_bins) half_bin<kMetric, 1>(acc, t0, r, x.a2, x.ab, x.bbd, x.quad, keep);
  if (bin + 2 < x.n_bins) half_bin<kMetric, 2>(acc, t0, r, x.a2, x.ab, x.bbd, x.quad, keep);
  if (bin + 3 < x.n_bins) half_bin<kMetric, 3>(acc, t0, r, x.a2, x.ab, x.bbd, x.quad, keep);
  if (bin + x.quad >= x.n_bins) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = r.q_lo + 8 * h;
    if (q < x.B) {
      x.out[static_cast<long long>(q) * x.n_bins + bin + x.quad] =
          kMetric == kEuclidean ? u8_euclidean::bin_value(keep[h]) : keep[h];
    }
  }
}

// The ring of K-slices as a consumer walks it.
struct Ring {
  int stage;
  uint32_t phase;
  int prev;  // the stage of the last product group issued (-1: none yet)
};

// One pass of a consumer warpgroup: the products of one half of a tile
// into acc, K-slice by K-slice through the ring, one group in flight; the
// pass's last group stays in flight when it returns.
__device__ __forceinline__ void products(int32_t (&acc)[64], Ring& ring, const uint8_t* smem, uint64_t* full,
                                         uint64_t* empty, int wg, int tid, int n_ks) {
  for (int ks = 0; ks < n_ks; ++ks) {
    hopper::mbar_wait(&full[ring.stage], ring.phase);
    const uint8_t* a = smem + ring.stage * kStageBytes + wg * 64 * kBK;
    const uint8_t* b = smem + ring.stage * kStageBytes + kABytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      hopper::wgmma_m64n128k32_s8(acc, hopper::sw128_desc(a + kk * 32), hopper::sw128_desc(b + kk * 32),
                                  (ks | kk) != 0);
    }
    hopper::wgmma_commit();
    // one group stays in flight: the one before is done, release its stage
    hopper::wgmma_wait<1>();
    if (ring.prev >= 0 && tid == 0) hopper::mbar_arrive(&empty[ring.prev]);
    ring.prev = ring.stage;
    if (++ring.stage == kStages) {
      ring.stage = 0;
      ring.phase ^= 1;
    }
  }
}

// q_t*: the three query terms, v_t*: the three row terms (4 bytes each):
// cosine, dot: q_add, q_inv, unused; v_add, v_inv, v_sink (0 or -3e38).
// euclidean: q_code, q_u, q_sq; v_code, v_u, v_sq (u8_euclidean.cuh).
template <int kMetric>
__global__ void __launch_bounds__(kThreads, 1)
u8_bin_max_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap c_map,
                  const uint32_t* __restrict__ q_t0, const float* __restrict__ q_t1,
                  const float* __restrict__ q_t2, const uint32_t* __restrict__ v_t0,
                  const uint32_t* __restrict__ v_t1, const uint32_t* __restrict__ v_t2,
                  const float* __restrict__ consts, float* __restrict__ out, int B, int C, int n_ks,
                  int n_qtiles, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint32_t* terms = reinterpret_cast<uint32_t*>(smem + kStages * kStageBytes);  // [2][3][kBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + 2 * kTermBytes);
  uint64_t* empty = full + kStages;
  uint64_t* terms_full = empty + kStages;  // [2]
  uint64_t* terms_empty = terms_full + 2;  // [2]
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&terms_full[s], 1);
      hopper::mbar_init(&terms_empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: one thread issues every copy, the rest lend their registers
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x, n = 0; t < n_tiles; t += gridDim.x, ++n) {
        const int q0 = t % n_qtiles * kBM;
        const int r0 = t / n_qtiles * kBN;
        // the tile's row terms, for its epilogue (double-buffered)
        const int tb = n & 1;
        const uint32_t rows = min(kBN, C - r0);
        hopper::mbar_wait(&terms_empty[tb], ((n >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&terms_full[tb], 3 * rows * 4);
        uint32_t* dst = terms + tb * 3 * kBN;
        hopper::bulk_load(dst, v_t0 + r0, rows * 4, &terms_full[tb]);
        hopper::bulk_load(dst + kBN, v_t1 + r0, rows * 4, &terms_full[tb]);
        hopper::bulk_load(dst + 2 * kBN, v_t2 + r0, rows * 4, &terms_full[tb]);
        // the K-slices of the tile's lo half, then those of its hi half: the
        // query codes come twice, so that each half's products stand alone
        for (int half = 0; half < 2; ++half) {
          for (int ks = 0; ks < n_ks; ++ks) {
            hopper::mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* a = smem + stage * kStageBytes;
            hopper::mbar_arrive_expect_tx(&full[stage], kStageBytes);
            hopper::tma_load_2d(a, &q_map, &full[stage], ks * kBK, q0);
            hopper::tma_load_2d(a + kABytes, &c_map, &full[stage], ks * kBK, r0 + half * kHalf);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const Epilogue x{hopper::smem_u32(terms), out, B, C / kGroup, lane & 3, consts[0], consts[1], consts[2]};
    Ring ring{0, 0, -1};
    int32_t acc_lo[64], acc_hi[64];  // the products of a tile's two halves
    TileRows cur, old;  // this tile's and the one before's
    for (int t = blockIdx.x, n = 0; t < n_tiles; t += gridDim.x, ++n) {
      cur.q_lo = t % n_qtiles * kBM + wg * 64 + (tid / 32) * 16 + lane / 4;
      cur.bin0 = t / n_qtiles * (kBN / kGroup);
      cur.tb = n & 1;
      cur.tb_parity = (n >> 1) & 1;
      // the query terms load under the lo half's products
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = min(cur.q_lo + 8 * h, B - 1);
        cur.t0[h] = __ldg(q_t0 + q);
        cur.t1[h] = __ldg(q_t1 + q);
        cur.t2[h] = kMetric == kEuclidean ? __ldg(q_t2 + q) : 0.0f;
      }
      // the lo half's products; then, with their last group in flight and
      // the next slices loading, the epilogue of the tile before's hi half,
      // which frees that tile's row terms
      products(acc_lo, ring, smem, full, empty, wg, tid, n_ks);
      if (n > 0) {
        hopper::fence_regs(acc_hi);
        half_epilogue<kMetric>(acc_hi, x, old, 1);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&terms_empty[old.tb]);
      }
      // the hi half's products; then the epilogue of this tile's lo half
      products(acc_hi, ring, smem, full, empty, wg, tid, n_ks);
      hopper::fence_regs(acc_lo);
      hopper::mbar_wait(&terms_full[cur.tb], cur.tb_parity);
      half_epilogue<kMetric>(acc_lo, x, cur, 0);
      old = cur;
    }
    // the last tile's hi half
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_hi);
    half_epilogue<kMetric>(acc_hi, x, old, 1);
  }
}

}  // namespace

// metric: 0 = cosine, 1 = dot, 2 = euclidean. Pointers are device
// pointers: the codes, three query terms and three row terms of 4 bytes
// each (the kernel's order; q_t2 unused by cosine and dot), and consts,
// three floats (a2, ab, bbd). Returns the cudaError_t of the launch.
extern "C" int u8_bin_max_launch(int metric, const void* q_codes, const void* q_t0, const void* q_t1,
                                 const void* q_t2, const void* codes, const void* v_t0, const void* v_t1,
                                 const void* v_t2, const void* consts, void* out, int B, long long C, int Dp,
                                 void* stream) {
  if (B <= 0 || C <= 0 || C % kGroup != 0 || C > INT_MAX - kBN || Dp <= 0 || Dp % kBK != 0 ||
      metric < kCosine || metric > kEuclidean || (metric == kEuclidean && Dp > 16384)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap q_map, c_map;
  int err = hopper::encode_tma_2d_u8(&q_map, q_codes, Dp, B, Dp, kBK, kBM);
  if (err == 0) err = hopper::encode_tma_2d_u8(&c_map, codes, Dp, C, Dp, kBK, kHalf);
  if (err != 0) return err;
  const int n_qtiles = (B + kBM - 1) / kBM;
  const long long n_tiles = (C + kBN - 1) / kBN * n_qtiles;
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = hopper::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const unsigned grid = static_cast<unsigned>(n_tiles < sms ? n_tiles : sms);
  auto kernel = metric == kCosine ? u8_bin_max_kernel<kCosine>
                : metric == kDot  ? u8_bin_max_kernel<kDot>
                                  : u8_bin_max_kernel<kEuclidean>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, c_map, static_cast<const uint32_t*>(q_t0), static_cast<const float*>(q_t1),
      static_cast<const float*>(q_t2), static_cast<const uint32_t*>(v_t0), static_cast<const uint32_t*>(v_t1),
      static_cast<const uint32_t*>(v_t2), static_cast<const float*>(consts), static_cast<float*>(out), B,
      static_cast<int>(C), Dp / kBK, n_qtiles, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u8_bin_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
