// A host emulation of the CUDA features that a kernel of one warp a block
// uses (cosdata_tpu_torch/csrc/group_topk.cu): each block's 32 threads run
// as std::threads, meeting at every warp intrinsic. Asynchronous copies are
// plain copies. For tests on machines without a card.
#pragma once

#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>

using std::max;
using std::min;

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local dim3 threadIdx, blockIdx;

struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};

// The block's meeting point and its shared memory.
struct Warp {
  std::barrier<> bar{32};
  uint64_t v[32];
  unsigned char* shared;
};
extern Warp* g_warp;

template <class T>
inline void exchange(T x, uint64_t (&all)[32]) {
  uint64_t b = 0;
  std::memcpy(&b, &x, sizeof(T));
  g_warp->v[threadIdx.x] = b;
  g_warp->bar.arrive_and_wait();
  std::memcpy(all, g_warp->v, sizeof(all));
  g_warp->bar.arrive_and_wait();
}

template <class T>
inline T as(uint64_t b) {
  T x;
  std::memcpy(&x, &b, sizeof(T));
  return x;
}

inline void __syncwarp(unsigned = 0xffffffffu) { g_warp->bar.arrive_and_wait(); }

template <class T>
T __shfl_up_sync(unsigned, T x, int off) {
  uint64_t a[32];
  exchange(x, a);
  const int l = threadIdx.x;
  return l >= off ? as<T>(a[l - off]) : x;
}

template <class T>
T __shfl_sync(unsigned, T x, int src) {
  uint64_t a[32];
  exchange(x, a);
  return as<T>(a[src & 31]);
}

inline int __any_sync(unsigned, int p) {
  uint64_t a[32];
  exchange<int>(p != 0, a);
  for (uint64_t x : a) {
    if (x) return 1;
  }
  return 0;
}

template <class T, class Op>
T reduce(T v, Op op) {
  uint64_t a[32];
  exchange(v, a);
  T r = as<T>(a[0]);
  for (int i = 1; i < 32; ++i) r = op(r, as<T>(a[i]));
  return r;
}

inline unsigned __reduce_min_sync(unsigned, unsigned v) { return reduce(v, [](unsigned a, unsigned b) { return std::min(a, b); }); }
inline int __reduce_max_sync(unsigned, int v) { return reduce(v, [](int a, int b) { return std::max(a, b); }); }
inline int __reduce_add_sync(unsigned, int v) { return reduce(v, [](int a, int b) { return a + b; }); }
inline unsigned __reduce_and_sync(unsigned, unsigned v) { return reduce(v, [](unsigned a, unsigned b) { return a & b; }); }
inline unsigned __reduce_or_sync(unsigned, unsigned v) { return reduce(v, [](unsigned a, unsigned b) { return a | b; }); }

inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <class T>
T __ldg(const T* p) {
  return *p;
}

// Shared addresses are offsets into the block's shared memory.
inline unsigned __cvta_generic_to_shared(const void* p) {
  return static_cast<unsigned>(static_cast<const unsigned char*>(p) - g_warp->shared);
}
inline void emu_copy(unsigned dst, const void* src, int n) { std::memcpy(g_warp->shared + dst, src, n); }

typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
