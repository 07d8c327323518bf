// Sub-byte code dots by bitplane popcounts: out[q, r] = sum_d qcode[q, d] *
// vcode[r, d], exact in int32, for codes 0..2^res-1 given as res packed
// bitplanes (res = 1, 2 or 3).
//
// Replaces the Pallas TPU kernel cosdata_tpu/ops/pallas/subbyte_scan.py
// (subbyte_code_scores, kernel _make_kernel) and computes the same function
// without its unpack: that kernel expands the planes into an int32 codes
// scratch in VMEM and contracts it on the MXU. Here, with
// qcode = sum_p 2^(res-1-p) qbit_p and vcode likewise,
//
//   q . v = sum_{p, p'} 2^((res-1-p) + (res-1-p')) * popc(qword_p & vword_p')
//
// summed over the W = Dp/32 words of a row: the reference Rust's bitplane
// popcount form (src/models/dot_product.rs:35-90). Query and store share
// the strided pack (bit i of word w is dimension i*W + w), so the AND lines
// up dimension by dimension, and padded lanes carry code 0 on both sides.
//
// Layouts: q_planes (res, B, W) and planes (res, C, W) of 32-bit words;
// rows are contiguous within a plane, planes lie plane_stride words apart
// (a chunk of a larger store is a view, not a copy). out is (B, C) int32.
//
// What bounds it on an H100: per (query, row) pair it issues res^2 * W
// __popc (96 for res=2 at Dp=768) and about as many AND and shift-add
// instructions; __popc retires at a quarter of the integer rate (16 per
// clock per SM), so at B=1024, C=65,536, Dp=768, res=2 the 6.4e9 popcounts
// take about 1.7 ms at 1.75 GHz, while writing the 256 MB int32 result takes
// about 0.08 ms at 3.35 TB/s. Reading the planes is small beside both (12.6
// MB per 65,536 rows at res=2, which stays in the 50 MB L2 across query
// tiles). So this design is bound by the popcount rate: measured at that
// shape on an NVIDIA H100 80GB HBM3 at 700 W it takes 1.635 ms, about 94%
// of that rate at the 1.98 GHz boost clock (the clock was not read),
// against 3.887 ms for the plain PyTorch version (unpack + f32 cuBLAS).
// What it does about that: nothing yet beyond doing no unpack at all. A
// block stages a tile of 32 queries' words in shared memory, 8 words of
// each plane at a time, and each thread owns one store row, keeps its
// res x 8 words in registers and loops over the tile's queries, reading the
// staged words as warp-wide broadcasts. Threads write out[q, row] so
// neighbouring threads write neighbouring rows. Ragged rows and queries are
// masked; any C >= 1 and any W >= 1 are taken. Fusing the score epilogue, the mask and the per-chunk
// top-k into the kernel (so the (B, C) result never reaches device memory),
// or an int8 tensor-core product of the unpacked codes, is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 128;   // store rows per block, one per thread
constexpr int kQTile = 32;   // queries per block
constexpr int kWSlice = 8;   // words of each plane staged per step

template <int RES>
__global__ void __launch_bounds__(kRows)
subbyte_code_scores_kernel(const uint32_t* __restrict__ q_planes, long long q_plane_stride,
                           const uint32_t* __restrict__ planes, long long plane_stride,
                           int32_t* __restrict__ out, int B, long long C, int W) {
  __shared__ uint32_t q_tile[RES][kQTile][kWSlice];

  const long long row = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  const bool active = row < C;
  const int q0 = static_cast<int>(blockIdx.y) * kQTile;
  const uint32_t* row_ptr = planes + (active ? row : 0LL) * W;

  int acc[kQTile];
#pragma unroll
  for (int i = 0; i < kQTile; ++i) acc[i] = 0;

  for (int w0 = 0; w0 < W; w0 += kWSlice) {
    for (int idx = threadIdx.x; idx < RES * kQTile * kWSlice; idx += kRows) {
      const int p = idx / (kQTile * kWSlice);
      const int qi = (idx / kWSlice) % kQTile;
      const int w = idx % kWSlice;
      uint32_t v = 0u;
      if (q0 + qi < B && w0 + w < W) {
        v = q_planes[p * q_plane_stride + static_cast<long long>(q0 + qi) * W + w0 + w];
      }
      q_tile[p][qi][w] = v;
    }
    uint32_t vw[RES][kWSlice];
#pragma unroll
    for (int p = 0; p < RES; ++p) {
#pragma unroll
      for (int w = 0; w < kWSlice; ++w) {
        vw[p][w] = (active && w0 + w < W) ? __ldg(row_ptr + p * plane_stride + w0 + w) : 0u;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kQTile; ++i) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWSlice; ++w) {
#pragma unroll
        for (int p = 0; p < RES; ++p) {
          const uint32_t qw = q_tile[p][i][w];
#pragma unroll
          for (int pp = 0; pp < RES; ++pp) {
            s += __popc(qw & vw[pp][w]) << (2 * RES - 2 - p - pp);
          }
        }
      }
      acc[i] += s;
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kQTile; ++i) {
    if (q0 + i < B) out[static_cast<long long>(q0 + i) * C + row] = acc[i];
  }
}

}  // namespace

// Pointers are device pointers to 32-bit words (q_planes, planes) and int32
// (out); strides count words. Returns the cudaError_t of the launch.
extern "C" int subbyte_code_scores_launch(int res, const void* q_planes, long long q_plane_stride,
                                          const void* planes, long long plane_stride, void* out,
                                          int B, long long C, int W, void* stream) {
  if (B <= 0 || C <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_tiles = (C + kRows - 1) / kRows;
  const int q_tiles = (B + kQTile - 1) / kQTile;
  if (row_tiles > INT_MAX || q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(q_tiles));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint32_t*>(q_planes);
  const auto* vp = static_cast<const uint32_t*>(planes);
  auto* o = static_cast<int32_t*>(out);
  switch (res) {
    case 1:
      subbyte_code_scores_kernel<1><<<grid, kRows, 0, s>>>(qp, q_plane_stride, vp, plane_stride, o, B, C, W);
      break;
    case 2:
      subbyte_code_scores_kernel<2><<<grid, kRows, 0, s>>>(qp, q_plane_stride, vp, plane_stride, o, B, C, W);
      break;
    case 3:
      subbyte_code_scores_kernel<3><<<grid, kRows, 0, s>>>(qp, q_plane_stride, vp, plane_stride, o, B, C, W);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subbyte_code_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
