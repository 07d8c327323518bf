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
// reference's euclidean_u8 (cosdata_tpu/ops/distance.py:74-77) in its own
// op order, from the code sums s (q_add, v_add: exact integers in f32) and
// the squared magnitudes (q_inv, v_inv), with consts = (a2, ab, bbd):
//
//   code = cc + 128 * (s[q] + s[row]) + Dp * 128 * 128       int32
//   dot  = (a2 * f32(code) + ab * f32(s[q] + s[row] + 256 * Dp)) + bbd
//   d2   = (q_inv[q] + v_inv[row]) - 2 * dot
//   sc   = -sqrt(max(d2, 0)) + v_sink[row]
//
// (f32(s[q] + s[row] + 256 * Dp) is the reference's f32 uq + uv, exact
// while it stays below 2^24.) -sqrt is decreasing, so a bin's maximum is
// -sqrt of its least d2 over its valid rows: the epilogue keeps that least
// d2 and takes one correctly rounded square root per bin. A row whose sink
// is not 0 is invalid (the wrapper writes 0 or kSink); a bin of invalid
// rows only is kSink, which is what kSink plus -sqrt of any finite d2
// rounds to.
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
// The design: the product runs on the int8 tensor cores (wgmma m64n256k32
// s8.s8.s32 from shared memory). A block owns a tile of 128 queries (the M
// operand, two consumer warpgroups of 64 rows) by 256 store rows (the N
// operand); both are K-major, i.e. the (B, Dp) and (C, Dp) row-major codes
// as they lie. A producer warpgroup keeps a ring of 4 K-slices (128 bytes
// of Dp for both tiles, 48 KB) in flight with TMA, guarded by full/empty
// mbarriers, so loads overlap the product; rows past B or C read as zeros.
// One of its threads issues the copies; the warpgroup hands its registers
// to the consumers (setmaxnreg), whose accumulators take 128 each.
// The grid is persistent (one block per SM) and walks the tiles query tile
// fastest, so the query tiles that share a store tile run back to back on
// neighbouring SMs and the codes come from device memory about once; the
// ring runs on across tiles, so the next tile's loads overlap an epilogue.
// The epilogue runs in registers in the Pallas kernel's f32 op order
// (__fmul_rn/__fadd_rn keep nvcc from contracting it into FMAs): a 32-row
// bin is 8 accumulator columns of one thread times the 4 lanes of a quad,
// so its max is a thread-local max and two __shfl_xor_sync steps. The row
// terms of a tile reach shared memory by bulk copies one tile ahead, so no
// device-memory latency sits in the epilogue (8 warps per SM cannot hide
// it); the query terms load under the product. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 2): 1.45 ms at the shape above
// back to back, 57% of the bound (1.52 ms as a single call, host time
// included), and 0.29 ms at B=128 (0.33). About 0.44 ms of it is the f32
// epilogue, which runs while the tensor cores wait (tools/kernel_variants.py).

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper_mma.cuh"

namespace {

constexpr int kGroup = 32;                 // store rows per bin
constexpr int kBM = 128;                   // queries per tile (two warpgroups of 64)
constexpr int kBN = 256;                   // store rows per tile
constexpr int kBK = 128;                   // code bytes per K-slice (one swizzle row)
constexpr int kStages = 4;                 // K-slices in flight
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kABytes = kBM * kBK;
constexpr int kBBytes = kBN * kBK;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kTermBytes = 3 * kBN * 4;    // a tile's v_add, v_inv, v_sink
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kTermBytes + 2 * (kStages + 2) * 8 + 1024;
constexpr int kBinsPerTile = kBN / kGroup;
constexpr int kCosine = 0, kDot = 1, kEuclidean = 2;  // the metric codes of the launch
constexpr float kSink = -3.0e38f;                     // an invalid row's v_sink

template <int kMetric>
__global__ void __launch_bounds__(kThreads, 1)
u8_bin_max_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap c_map,
                  const float* __restrict__ q_add, const float* __restrict__ q_inv,
                  const float* __restrict__ v_add, const float* __restrict__ v_inv,
                  const float* __restrict__ v_sink, const float* __restrict__ consts,
                  float* __restrict__ out, int B, int C, int n_ks, int n_qtiles, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  float* terms = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [2][3][kBN]
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
        float* dst = terms + tb * 3 * kBN;
        hopper::bulk_load(dst, v_add + r0, rows * 4, &terms_full[tb]);
        hopper::bulk_load(dst + kBN, v_inv + r0, rows * 4, &terms_full[tb]);
        hopper::bulk_load(dst + 2 * kBN, v_sink + r0, rows * 4, &terms_full[tb]);
        for (int ks = 0; ks < n_ks; ++ks) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a = smem + stage * kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[stage], kStageBytes);
          hopper::tma_load_2d(a, &q_map, &full[stage], ks * kBK, q0);
          hopper::tma_load_2d(a + kABytes, &c_map, &full[stage], ks * kBK, r0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int quad = lane & 3;
    const float a2 = consts[0];
    const float ab = consts[1];   // euclidean only
    const float bbd = consts[2];  // euclidean only
    const int code0 = n_ks * kBK * 128 * 128;  // euclidean: Dp * 128^2
    const int u0 = n_ks * kBK * 256;           // euclidean: 2 * 128 * Dp
    const float kInf = __int_as_float(0x7f800000);
    const float kNegInf = -kInf;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    int32_t acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;

    for (int t = blockIdx.x, n = 0; t < n_tiles; t += gridDim.x, ++n) {
      const int q0 = t % n_qtiles * kBM;
      const int r0 = t / n_qtiles * kBN;
      // this thread's rows are q_lo and q_lo + 8; their terms load under the product
      const int q_lo = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;
      float qa[2], qi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = min(q_lo + 8 * h, B - 1);
        qa[h] = __ldg(q_add + q);
        qi[h] = __ldg(q_inv + q);
      }

      for (int ks = 0; ks < n_ks; ++ks) {
        hopper::mbar_wait(&full[stage], phase);
        const uint8_t* a = smem + stage * kStageBytes + wg * 64 * kBK;
        const uint8_t* b = smem + stage * kStageBytes + kABytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          hopper::wgmma_m64n256k32_s8(acc, hopper::sw128_desc(a + kk * 32), hopper::sw128_desc(b + kk * 32),
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

      // epilogue, from the row terms in shared memory
      const int tb = n & 1;
      hopper::mbar_wait(&terms_full[tb], (n >> 1) & 1);
      const float* t_add = terms + tb * 3 * kBN;
      const float* t_inv = t_add + kBN;
      const float* t_sink = t_add + 2 * kBN;
      const int bin0 = r0 / kGroup;
      const int n_bins = C / kGroup;
      float keep[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int bn = 0; bn < kBinsPerTile; ++bn) {
        if (bin0 + bn >= n_bins) continue;  // uniform: a bin lies wholly inside or past C
        // cosine, dot: the running max of sc; euclidean: the least d2 of valid rows
        float m[2] = {kMetric == kEuclidean ? kInf : kNegInf, kMetric == kEuclidean ? kInf : kNegInf};
#pragma unroll
        for (int jj = 0; jj < kGroup / 8; ++jj) {
          const int j = bn * (kGroup / 8) + jj;  // n8 block of the accumulator
          const int col = 8 * j + 2 * quad;      // this thread's rows col, col + 1 of the tile
          const float2 va = *reinterpret_cast<const float2*>(t_add + col);
          const float2 vi = *reinterpret_cast<const float2*>(t_inv + col);
          const float2 vs = *reinterpret_cast<const float2*>(t_sink + col);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int32_t cc = acc[4 * j + 2 * h + e];
              if constexpr (kMetric == kEuclidean) {
                const int s = __float2int_rn(qa[h]) + __float2int_rn(e ? va.y : va.x);
                const float cd = __int2float_rn(cc + 128 * s + code0);
                const float u = __int2float_rn(s + u0);
                const float dot = __fadd_rn(__fadd_rn(__fmul_rn(a2, cd), __fmul_rn(ab, u)), bbd);
                const float d2 = __fsub_rn(__fadd_rn(qi[h], e ? vi.y : vi.x), __fadd_rn(dot, dot));
                if ((e ? vs.y : vs.x) == 0.0f) m[h] = fminf(m[h], d2);
              } else {
                const float dot =
                    __fadd_rn(__fadd_rn(__fmul_rn(a2, __int2float_rn(cc)), e ? va.y : va.x), qa[h]);
                float sc = __fmul_rn(dot, e ? vi.y : vi.x);
                if (kMetric == kCosine) sc = __fmul_rn(sc, qi[h]);
                sc = __fadd_rn(sc, e ? vs.y : vs.x);
                m[h] = fmaxf(m[h], sc);
              }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (kMetric == kEuclidean) {
            m[h] = fminf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
            m[h] = fminf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
            m[h] = m[h] == kInf ? kSink : __fadd_rn(-__fsqrt_rn(fmaxf(m[h], 0.0f)), 0.0f);
          } else {
            m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
            m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
          }
          if ((bn >> 1) == quad) keep[h][bn & 1] = m[h];
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&terms_empty[tb]);
      // lane quad k of the quad stores bins 2k and 2k + 1 of both its rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q_lo + 8 * h;
        if (q >= B) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bin = bin0 + 2 * quad + e;
          if (bin < n_bins) out[static_cast<long long>(q) * n_bins + bin] = keep[h][e];
        }
      }
    }
  }
}

}  // namespace

// metric: 0 = cosine, 1 = dot, 2 = euclidean. Pointers are device
// pointers; consts points at three floats on the device (a2, ab, bbd).
// Returns the cudaError_t of the launch.
extern "C" int u8_bin_max_launch(int metric, const void* q_codes, const void* q_add,
                                 const void* q_inv, const void* codes, const void* v_add,
                                 const void* v_inv, const void* v_sink, const void* consts,
                                 void* out, int B, long long C, int Dp, void* stream) {
  if (B <= 0 || C <= 0 || C % kGroup != 0 || C > INT_MAX - kBN || Dp <= 0 || Dp % kBK != 0 ||
      metric < kCosine || metric > kEuclidean || (metric == kEuclidean && Dp > 16384)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap q_map, c_map;
  int err = hopper::encode_tma_2d_u8(&q_map, q_codes, Dp, B, Dp, kBK, kBM);
  if (err == 0) err = hopper::encode_tma_2d_u8(&c_map, codes, Dp, C, Dp, kBK, kBN);
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
      q_map, c_map, static_cast<const float*>(q_add), static_cast<const float*>(q_inv),
      static_cast<const float*>(v_add), static_cast<const float*>(v_inv), static_cast<const float*>(v_sink),
      static_cast<const float*>(consts), static_cast<float*>(out), B, static_cast<int>(C), Dp / kBK, n_qtiles, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u8_bin_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
