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
// The bins are CONTIGUOUS groups of 32 rows, out is (B, C/32) f32. (The
// Pallas kernel emits strided row groups, transposed, because Mosaic lowers
// nothing else; the torch engine expands contiguous bins.)
//
// What bounds it on an H100: at B=1024, C=1,048,576, Dp=768 the product is
// 1.6 TOP of int8 against 0.8 GB of codes, about 2,000 operations per byte
// read, so once it runs on the tensor cores it is compute-bound; the output
// is C/32 x B floats, 32 times less than the scores.
//
// What this first design does about it: it is the simple, exact version.
// One warp owns one bin (lane l scores row j*32+l), a block owns 8 bins and
// a tile of 32 queries. The query tile is staged through shared memory in
// 128-byte slices of Dp and read back as warp-wide broadcasts; each lane
// streams its own row with 16-byte loads and accumulates 32 int32 dots with
// __dp4a (CUDA cores, not tensor cores). The epilogue runs in registers in
// the Pallas kernel's f32 op order (__fmul_rn/__fadd_rn keep nvcc from
// contracting it into FMAs), then a __shfl_xor_sync butterfly takes each
// query's max over the warp and lane i stores query i's bin. Blocks are
// ordered query tile fastest, so the query tiles that share a slice of the
// store run back to back and find it in L2. The tensor-core versions
// (mma.sync s8 m16n8k32, then wgmma with TMA) are later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kGroup = 32;   // store rows per bin == lanes per warp
constexpr int kWarps = 8;    // bins per block
constexpr int kQTile = 32;   // queries per block
constexpr int kSlice = 128;  // code bytes staged per step (Dp % 128 == 0)
constexpr int kChunks = kSlice / 16;
constexpr int kThreads = kWarps * 32;
static_assert(kQTile * kChunks == kThreads, "one uint4 of the query tile per thread");

template <bool kCosine>
__global__ void __launch_bounds__(kThreads)
u8_bin_max_kernel(const int8_t* __restrict__ q_codes,
                  const float* __restrict__ q_add,
                  const float* __restrict__ q_inv,
                  const int8_t* __restrict__ codes,
                  const float* __restrict__ v_add,
                  const float* __restrict__ v_inv,
                  const float* __restrict__ v_sink,
                  const float* __restrict__ a2_ptr,
                  float* __restrict__ out,
                  int B, long long n_bins, int Dp, int n_qtiles) {
  __shared__ uint4 q_tile[kQTile][kChunks];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = static_cast<int>(blockIdx.x % n_qtiles) * kQTile;
  const long long bin = static_cast<long long>(blockIdx.x / n_qtiles) * kWarps + warp;
  const bool active = bin < n_bins;  // uniform across the warp
  const long long row = active ? bin * kGroup + lane : 0;
  const uint4* row_ptr = reinterpret_cast<const uint4*>(codes + row * Dp);

  int acc[kQTile];
#pragma unroll
  for (int i = 0; i < kQTile; ++i) acc[i] = 0;

  const int stage_q = threadIdx.x / kChunks;
  const int stage_c = threadIdx.x % kChunks;
  for (int d0 = 0; d0 < Dp; d0 += kSlice) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + stage_q < B) {
      v = *reinterpret_cast<const uint4*>(
          q_codes + static_cast<long long>(q0 + stage_q) * Dp + d0 + stage_c * 16);
    }
    q_tile[stage_q][stage_c] = v;
    __syncthreads();
    if (active) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint4 r = __ldg(row_ptr + d0 / 16 + c);
#pragma unroll
        for (int i = 0; i < kQTile; ++i) {
          const uint4 qv = q_tile[i][c];
          int s = acc[i];
          s = __dp4a(static_cast<int>(r.x), static_cast<int>(qv.x), s);
          s = __dp4a(static_cast<int>(r.y), static_cast<int>(qv.y), s);
          s = __dp4a(static_cast<int>(r.z), static_cast<int>(qv.z), s);
          s = __dp4a(static_cast<int>(r.w), static_cast<int>(qv.w), s);
          acc[i] = s;
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const float a2 = *a2_ptr;
  const float va = v_add[row];
  const float vi = v_inv[row];
  const float vs = v_sink[row];
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < kQTile; ++i) {
    const int qi = min(q0 + i, B - 1);
    const float dot = __fadd_rn(__fadd_rn(__fmul_rn(a2, __int2float_rn(acc[i])), va), q_add[qi]);
    float sc = kCosine ? __fmul_rn(__fmul_rn(dot, vi), q_inv[qi]) : __fmul_rn(dot, vi);
    sc = __fadd_rn(sc, vs);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sc = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, off));
    }
    if (lane == i) mine = sc;
  }
  if (q0 + lane < B) out[static_cast<long long>(q0 + lane) * n_bins + bin] = mine;
}

}  // namespace

// metric: 0 = cosine, 1 = dot. Pointers are device pointers; a2 points at
// one float on the device. Returns the cudaError_t of the launch.
extern "C" int u8_bin_max_launch(int metric, const void* q_codes, const void* q_add,
                                 const void* q_inv, const void* codes, const void* v_add,
                                 const void* v_inv, const void* v_sink, const void* a2,
                                 void* out, int B, long long C, int Dp, void* stream) {
  if (B <= 0 || C <= 0 || C % kGroup != 0 || Dp <= 0 || Dp % kSlice != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_bins = C / kGroup;
  const int n_qtiles = (B + kQTile - 1) / kQTile;
  const long long blocks = (n_bins + kWarps - 1) / kWarps * n_qtiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  auto kernel = metric == 0 ? u8_bin_max_kernel<true> : u8_bin_max_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q_codes), static_cast<const float*>(q_add),
      static_cast<const float*>(q_inv), static_cast<const int8_t*>(codes),
      static_cast<const float*>(v_add), static_cast<const float*>(v_inv),
      static_cast<const float*>(v_sink), static_cast<const float*>(a2),
      static_cast<float*>(out), B, n_bins, Dp, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u8_bin_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
