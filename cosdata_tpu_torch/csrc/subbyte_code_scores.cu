// Sub-byte code dots on the int8 tensor cores: out[q, r] = sum_d qcode[q, d]
// * vcode[r, d], exact in int32, for codes 0..2^res-1 given as res packed
// bitplanes (res = 1, 2 or 3).
//
// Replaces the Pallas TPU kernel cosdata_tpu/ops/pallas/subbyte_scan.py
// (subbyte_code_scores, kernel _make_kernel) and computes the same function
// the same way: unpack the planes to codes on chip, then contract them on
// the matrix unit.
//
// Layouts: q_planes (res, B, W) and planes (res, C, W) of 32-bit words;
// rows are contiguous within a plane, planes lie plane_stride words apart
// (a chunk of a larger store is a view, not a copy). The pack is strided
// (bit i of word w is dimension i*W + w). A sum is exact in any order, so
// both sides unpack into the same WORD-MAJOR order instead: position
// w*32 + i holds bit i of word w, and one word expands to 32 consecutive
// code bytes with nothing to un-stride. q_codes is the (B, 32 W) int8
// query side so unpacked; out is (B, C) int32.
//
// What bounds it on an H100: at B=1024, C=65,536, Dp=768, res=2 the
// product is 1.03e11 int8 operations (0.052 ms at the 1,979 TOP/s peak) and
// the int32 result is 268 MB (0.080 ms at 3.35 TB/s); the planes are 12.6
// MB. So it is bound by writing the result.
//
// The design: a small kernel (entry point _unpack_queries) unpacks the
// query planes into q_codes, once per batch: a scan of many row chunks
// passes the same q_codes to every chunk's product. The product kernel
// (entry point _launch) gives each block 128 store rows: its consumer threads
// unpack the rows' planes once into shared memory as int8 codes in the
// 128-byte-swizzled K-major layout wgmma reads (up to 1,024 codes of Dp at
// a time; a longer Dp runs in chunks that add into out). The block then
// walks every 128-query tile: a producer warp streams the query codes in
// 128-byte K-slices with TMA through a 3-stage ring, and two consumer
// warpgroups (64 queries each) run wgmma m64n128k32 s8.s8.s32 against the
// resident store codes. Each output tile is staged through shared memory,
// 64 columns at a time, and written with coalesced 16-byte stores (4-byte
// stores where C is not a multiple of 4, and at the ragged edge); the
// stores drain while the next tile's products run. Ragged rows and queries
// are masked; any C >= 1 and any W >= 1 are taken. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 5): 0.187 ms at the shape
// above back to back, 45% of the bound (0.22-0.245 ms as a single call
// with the query unpack, host time included). Fusing the score epilogue,
// the mask and the per-chunk top-k, so the (B, C) result never reaches
// device memory, is later work.

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
constexpr int kSmemBytes = kResBytes + kStages * kABytes + kOutBytes + 2 * kStages * 8 + 1024;
constexpr int kConsumerBar = 1;                   // named barrier of the consumer warpgroups

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

template <int RES>
__global__ void __launch_bounds__(kThreads, 1)
subbyte_code_scores_kernel(const __grid_constant__ CUtensorMap q_map, const uint32_t* __restrict__ planes,
                           long long plane_stride, int32_t* __restrict__ out, int B, long long C, int W,
                           int n_qtiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* codes = smem;                     // resident store codes, kKMax / kBK swizzled slices
  uint8_t* ring = smem + kResBytes;          // query K-slices
  int32_t* staged = reinterpret_cast<int32_t*>(ring + kStages * kABytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kResBytes + kStages * kABytes + kOutBytes);
  uint64_t* empty = full + kStages;
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

    for (int qt = 0; qt < n_qtiles; ++qt) {
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
            if (kc > 0) {
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
              if (col + e < C) dst[e] = kc > 0 ? dst[e] + vals[e] : vals[e];
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

template <int RES>
int launch(const void* q_codes, const void* planes, long long plane_stride, void* out, int B, long long C, int W,
           cudaStream_t stream) {
  CUtensorMap q_map;
  const int dp = 32 * W;
  const int err = hopper::encode_tma_2d_u8(&q_map, q_codes, dp, B, dp, kBK, kBM);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(subbyte_code_scores_kernel<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((C + kBN - 1) / kBN);
  subbyte_code_scores_kernel<RES><<<blocks, kThreads, kSmemBytes, stream>>>(
      q_map, static_cast<const uint32_t*>(planes), plane_stride, static_cast<int32_t*>(out), B, C, W,
      (B + kBM - 1) / kBM);
  return static_cast<int>(cudaGetLastError());
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
  if (B <= 0 || C <= 0 || W <= 0 || (C + kBN - 1) / kBN > INT_MAX || W > INT_MAX / 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (res) {
    case 1:
      return launch<1>(q_codes, planes, plane_stride, out, B, C, W, s);
    case 2:
      return launch<2>(q_codes, planes, plane_stride, out, B, C, W, s);
    case 3:
      return launch<3>(q_codes, planes, plane_stride, out, B, C, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* subbyte_code_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
