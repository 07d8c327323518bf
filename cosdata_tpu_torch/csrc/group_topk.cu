// One chunk's step of the sub-byte scan's running top-k, from K2's fused
// output: for each query row, the k best of (the running top-k) ∪ (the
// chunk's rows), where the chunk's rows are taken from its best 32-row
// groups.
//
// Replaces no TPU kernel. On the TPU the same step is XLA's per-chunk
// approx_max_k (exact on XLA:CPU) and the lax.top_k merge of
// cosdata_tpu/ops/flat_scan.py:flat_scan_topk (:83-96), which XLA fuses
// into the scan's one program. The port's torch version of it
// (ops/kernels/group_topk.py merge_group_topk_plain, this kernel's plain
// version) takes ~55 launches a chunk.
//
// Inputs: scores (B, C) and gmax (B, G = ceil(C / 32)) f32 as K2's fused
// entry writes them (masked rows NEG_INF; gmax must be the exact maxima of
// the scores); the running top (B, k) f32 values and int64 ids; start, the
// chunk's first row. Outputs: the new (B, k) values and ids, in no order
// (the caller sorts once, after the last chunk). k may pass the chunk's
// rows: the running entries make up the count. The chunk's rows past C are
// no candidates. Optionally (B, 2) int32, survivors: each row's count of
// survivors (step 2) and its buffer's capacity, and nothing else (a row
// past its capacity took the rare route; the main path passes none,
// chip_smoke.py phase 5 prints it).
//
// The design: one warp per query row (a block is one warp), no block-wide
// barrier, built around the one bound the step is handed for free: T, the
// least of the k running values. The merged k-th value is at least T, so a
// group whose maximum is below T holds no row of the result.
//  1. One round trip of asynchronous copies (cp.async) brings the running
//     top and the row's 8 KB of group maxima into shared memory; the warp
//     reduces T and holds the maxima in registers (64 a lane). It counts
//     the groups reaching T and lists them in index order. Only when more
//     than k reach it does it select M, the k-th largest maximum, and list
//     the k groups at or above it, ties in index order: the chunk holds k
//     rows at or above M, so the floor becomes max(T, M). After a scan's
//     first chunks T is high and few groups pass, so this select and the
//     reading of rows that cannot enter are mostly skipped.
//  2. The survivors, the candidates at or above the floor, go in index
//     order (running entries first) into a buffer of (key, id) pairs in
//     shared memory of k + 512 entries: with the floor at T every running
//     entry survives and is copied as is; the listed groups' rows are
//     staged 32 groups at a time, a group a lane, double-buffered.
//  3. The k best survivors: where at most 256 survive and at most 32 past
//     k (a late chunk), rounds of warp-wide minima drop the smallest, else
//     the select keeps the k best; one compaction writes them. At most 256
//     are held in registers, more are read from the buffer. (Each register
//     path measured against the buffer's select: tools/kernel_variants.py
//     gt_no_drop, gt_buffer.)
//  A select is a bisection on the keys' bits (the f32 values as ordered
//  uint32), from the highest that differs, counting the keys under the
//  prefix a bit at a time. A compaction is one warp scan of the lanes'
//  counts a chunk, a chunk in which no lane keeps an item costing a vote.
//  Ties fall in index order. A row whose survivors pass the buffer takes
//  step 3 over the candidates read where they lie (its rare route: every
//  score tied, k past the groups). Exact up to ties, as the torch version
//  is.
//
// What bounds it on an H100: latency. The bytes these inputs need (the
// group maxima, 8.4 MB at B=1024, C=65,536; the running top in and out, 2.5
// MB each; the rows of the groups whose maximum reaches the final k-th
// value) take 4-12 us at 3.35 TB/s; a warp's chain of dependent steps takes
// longer, and 1,024 rows on 132 SMs leave 8 warps an SM to hide it. A
// block of 256 threads a row (this kernel's earlier designs) is bound by
// issue slots instead: block scans and histograms around a few hundred
// survivors. Measured times, survivor counts and the
// phases of a row's warp: PERF.md §6 (chip_smoke.py phase 5,
// cosdata_tpu_torch/tools/kernel_times.py, tools/kernel_variants.py
// gt_trace).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kGroup = 32;
constexpr int kMaxima = 2048;      // group maxima a warp holds in registers (64 a lane)
constexpr int kBatch = 32;         // groups a batch of staged rows: one a lane
constexpr int kPitch = kGroup + 4; // floats between staged groups: lanes' rows fall on different banks
constexpr int kStage = kMaxima > 2 * kBatch * kPitch ? kMaxima : 2 * kBatch * kPitch;
constexpr int kSlack = 512;        // the survivor buffer's entries beyond k
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// f32 -> uint32 with the same order, and back. No value but NaN (which
// never reaches here) has key 0, so key 0 marks "no item".
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ int lane_id() { return static_cast<int>(threadIdx.x); }  // a block is one warp

// One asynchronous copy of kBytes (16, or 4) from global src to shared dst.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
  }
}

// Starts the warp's asynchronous copy of nbytes from global src to shared
// dst: 16-byte pieces where both lie on 16 bytes and nbytes is a multiple
// of 16, else 4-byte ones.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int nbytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (aligned16(d) && aligned16(s) && nbytes % 16 == 0) {
    for (int o = lane_id() * 16; o < nbytes; o += 32 * 16) cp_async<16>(d + o, s + o);
  } else {
    for (int o = lane_id() * 4; o < nbytes; o += 32 * 4) cp_async<4>(d + o, s + o);
  }
}

// Closes the warp's group of copies issued so far; waits for all of its
// copies, or for all but the newest group.
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
}

__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncwarp();
}

// Which keys a compaction keeps: those whose masked key is above prefix,
// and the first quota (in index order) of those whose masked key equals it.
struct Sel {
  uint32_t prefix, mask;
  int quota;
};
constexpr Sel kAll = {0, 0, INT_MAX};

// A warp visits its items a chunk at a time, R consecutive items a lane:
// chunks(visit) calls visit(base, key) for each chunk, lane l holding the
// keys of items base + l * R .. base + l * R + R - 1 in key[R] (0 where
// there is none). Two kinds: items read a chunk at a time (sweep), and a
// chunk held in registers (Held).

// The chunks of the items i < n, each read by load(i0, key), i0 = base +
// lane * R < n (a lane past n holds no item).
template <int R, class Load, class Visit>
__device__ __forceinline__ void sweep(const Load& load, int n, const Visit& visit) {
#pragma unroll 1
  for (int base = 0; base < n; base += 32 * R) {
    const int i0 = base + R * lane_id();
    uint32_t key[R];
    if (i0 < n) {
      load(i0, key);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) key[r] = 0;
    }
    visit(base, key);
  }
}

template <int R>
struct Held {
  uint32_t key[R];
  template <class Visit>
  __device__ __forceinline__ void operator()(const Visit& visit) const {
    visit(0, key);
  }
};

// S chunks of 4 items a lane held in registers: chunk u covers items
// 128u .. 128u + 127.
template <int S>
struct HeldSteps {
  uint32_t key[S][4];
  template <class Visit>
  __device__ __forceinline__ void operator()(const Visit& visit) const {
#pragma unroll
    for (int u = 0; u < S; ++u) visit(128 * u, key[u]);
  }
};

// A compaction: calls take(i, key, slot) for the items that sel keeps,
// slot counting up from `before` in index order, and returns the count
// after them (whether or not take stores them); ties carries the count of
// ties seen from one call to the next. A chunk costs one vote where no
// lane keeps an item, else one warp scan of the lanes' counts.
template <class Chunks, class Take>
__device__ int warp_compact(const Chunks& chunks, Sel sel, int before, int& ties, const Take& take) {
  const int lane = lane_id();
  int gt_before = before - min(ties, sel.quota);
  chunks([&](int base, const auto& key) {
    constexpr int R = sizeof(key) / sizeof(key[0]);
    int gt[4] = {0, 0, 0, 0}, tie[4] = {0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t m = key[r] & sel.mask;
      gt[r % 4] += key[r] != 0 && m > sel.prefix;
      tie[r % 4] += key[r] != 0 && m == sel.prefix;
    }
    const int mine = (gt[0] + gt[1] + gt[2] + gt[3]) << 16 | (tie[0] + tie[1] + tie[2] + tie[3]);  // fits 16 bits
    if (!__any_sync(kFull, mine)) return;
    int x = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    const int total = __shfl_sync(kFull, x, 31);
    int g = gt_before + ((x - mine) >> 16), t = ties + ((x - mine) & 0xffff);
    if (mine != 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t m = key[r] & sel.mask;
        if (key[r] != 0 && m > sel.prefix) {
          take(base + lane * R + r, key[r], g + min(t, sel.quota));
          ++g;
        } else if (key[r] != 0 && m == sel.prefix) {
          if (t < sel.quota) take(base + lane * R + r, key[r], g + t);
          ++t;
        }
      }
    }
    gt_before += total >> 16;
    ties += total & 0xffff;
  });
  return gt_before + min(ties, sel.quota);
}

template <class Chunks, class Take>
__device__ int warp_compact(const Chunks& chunks, Sel sel, const Take& take) {
  int ties = 0;
  return warp_compact(chunks, sel, 0, ties, take);
}

// The selection of the k largest keys among the items (at least k of
// them), as a Sel: a bisection on the keys' bits from the highest that
// differs (one visit of the items finds it; all equal: done), each bit a
// visit that counts the keys under the prefix with the bit set, stopping
// once the keys under the prefix are exactly those still wanted.
template <class Chunks>
__device__ Sel warp_select(const Chunks& chunks, int k) {
  uint32_t all_and = kFull, all_or = 0;
  int live = 0;
  chunks([&](int, const auto& key) {
    constexpr int R = sizeof(key) / sizeof(key[0]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (key[r] != 0) all_and &= key[r], all_or |= key[r], ++live;
    }
  });
  all_and = __reduce_and_sync(kFull, all_and);
  all_or = __reduce_or_sync(kFull, all_or);
  live = __reduce_add_sync(kFull, live);  // the keys under the prefix
  if (all_and == all_or) return {all_and, kFull, k};
  const int top = 31 - __clz(all_and ^ all_or);
  uint32_t mask = top == 31 ? 0u : kFull << (top + 1);
  uint32_t prefix = all_and & mask;
  int remaining = k;
#pragma unroll 1
  for (int bit = top; bit >= 0 && live > remaining; --bit) {
    const uint32_t m = mask | 1u << bit, want = prefix | 1u << bit;  // key 0 never matches
    int ones = 0;
    chunks([&](int, const auto& key) {
      constexpr int R = sizeof(key) / sizeof(key[0]);
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < R; ++r) c[r % 4] += (key[r] & m) == want;
      ones += c[0] + c[1] + c[2] + c[3];
    });
    ones = __reduce_add_sync(kFull, ones);
    mask = m;
    if (ones >= remaining) {
      prefix = want;
      live = ones;
    } else {
      remaining -= ones;
      live -= ones;
    }
  }
  return {prefix, mask, remaining};
}

// Drops the `drop` smallest of the held items, ties the later in index
// order first: a round a dropped item, each a warp-wide minimum.
template <int R>
__device__ void drop_smallest(Held<R>& h, int drop) {
  const int lane = lane_id();
#pragma unroll 1
  for (int d = 0; d < drop; ++d) {
    uint32_t low = kFull;
    int at = -1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (h.key[r] != 0 && h.key[r] <= low) low = h.key[r], at = lane * R + r;
    }
    const uint32_t least = __reduce_min_sync(kFull, low);
    const int last = __reduce_max_sync(kFull, low == least ? at : -1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane * R + r == last) h.key[r] = 0;
    }
  }
}

// The keys of p[i0 .. i0 + R) (0 at and past n); p a float array in shared
// memory on 16 bytes, i0 a multiple of 4.
template <int R>
__device__ __forceinline__ void shared_keys(const float* p, int i0, int n, uint32_t (&key)[R]) {
#pragma unroll
  for (int v = 0; v < R / 4; ++v) {
    const float4 f = *reinterpret_cast<const float4*>(p + i0 + 4 * v);
    const float x[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) key[4 * v + j] = i0 + 4 * v + j < n ? key_of(x[j]) : 0u;
  }
}

// The same from global memory at any alignment.
template <int R>
__device__ __forceinline__ void global_keys(const float* p, long long i0, long long n, uint32_t (&key)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) key[r] = i0 + r < n ? key_of(__ldg(p + i0 + r)) : 0u;
}

__global__ void __launch_bounds__(32)
group_topk_kernel(const float* __restrict__ scores, const float* __restrict__ gmax,
                  const float* __restrict__ top_s, const long long* __restrict__ top_i,
                  float* __restrict__ out_s, long long* __restrict__ out_i, long long C, int G, int k,
                  long long start, int cap, int* __restrict__ survivors) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long q = blockIdx.x;
  const int k2 = (k + 1) & ~1, k8 = (k + 7) & ~7;
  long long* rid = reinterpret_cast<long long*>(smem);   // k2: the running ids
  long long* bid = rid + k2;                              // cap: the survivors' ids
  float* stage = reinterpret_cast<float*>(bid + cap);     // kStage
  float* rs = stage + kStage;                             // k8: the running values
  uint32_t* bkey = reinterpret_cast<uint32_t*>(rs + k8);  // cap: the survivors' keys
  int* groups = reinterpret_cast<int*>(bkey + cap);       // min(k, G): the candidate groups
  const int lane = lane_id();
  const float* srow = scores + q * C;
  const float* grow = gmax + q * G;

  // the running top and the group maxima into shared memory, one round trip
  const bool held_maxima = G <= kMaxima;
  copy_async(rs, top_s + q * k, 4 * k);
  copy_async(rid, top_i + q * k, 8 * k);
  if (held_maxima) copy_async(stage, grow, 4 * G);
  copy_wait();
  uint32_t tkey = kFull;  // T
#pragma unroll 1
  for (int i = lane; i < k; i += 32) tkey = min(tkey, key_of(rs[i]));
  tkey = __reduce_min_sync(kFull, tkey);

  // the candidate groups: those reaching T, or the k best of them
  int kg = 0;
  uint32_t floor_key = tkey;
  const auto pick = [&](const auto& chunks) {
    int reach[4] = {0, 0, 0, 0};
    chunks([&](int, const auto& key) {
      constexpr int R = sizeof(key) / sizeof(key[0]);
#pragma unroll
      for (int r = 0; r < R; ++r) reach[r % 4] += key[r] >= tkey;  // key 0 never reaches
    });
    kg = __reduce_add_sync(kFull, reach[0] + reach[1] + reach[2] + reach[3]);
    Sel sel = {tkey, kFull, INT_MAX};
    if (kg > k) {
      sel = warp_select(chunks, k);
      kg = k;
      floor_key = max(tkey, sel.prefix);  // sel.prefix <= M, the k-th largest maximum
    }
    warp_compact(chunks, sel, [&](int i, uint32_t, int slot) { groups[slot] = i; });
  };
  if (held_maxima) {
    HeldSteps<kMaxima / 128> held;
#pragma unroll
    for (int u = 0; u < kMaxima / 128; ++u) shared_keys(stage, 128 * u + 4 * lane, G, held.key[u]);
    pick(held);
  } else {
    pick([&](const auto& visit) {
      sweep<4>([&](int i0, uint32_t(&key)[4]) { global_keys(grow, i0, G, key); }, G, visit);
    });
  }
  __syncwarp();

  // the survivors: the running entries, then the groups' rows, at or above
  // the floor, in index order. The rows are staged kBatch groups at a time,
  // a group a lane, in the two halves of the staging area: a batch's copies
  // are in flight while the one before is read.
  const Sel at_floor = {floor_key, kFull, INT_MAX};
  const auto keep = [&](long long id, uint32_t key, int slot) {
    if (slot < cap) bkey[slot] = key, bid[slot] = id;
  };
  const bool vec = aligned16(scores) && C % 4 == 0;
  const auto fetch = [&](int gb) {  // batch gb's rows into its half
    if (gb + lane < kg) {
      float* to = stage + (gb / kBatch % 2) * kBatch * kPitch + lane * kPitch;
      const long long row0 = static_cast<long long>(groups[gb + lane]) * kGroup;
      if (vec) {
#pragma unroll
        for (int r = 0; r < kGroup; r += 4) {
          if (row0 + r < C) cp_async<16>(to + r, srow + row0 + r);
        }
      } else {
#pragma unroll 4
        for (int r = 0; r < kGroup; ++r) {
          if (row0 + r < C) cp_async<4>(to + r, srow + row0 + r);
        }
      }
    }
    cp_commit();
  };
  if (kg > 0) fetch(0);
  int ties = 0, n = k;
  if (floor_key == tkey) {  // every running entry is at or above T: all survive, in order
#pragma unroll 1
    for (int i = lane; i < k; i += 32) keep(rid[i], key_of(rs[i]), i);
    ties = k;  // as ties of the floor; the rows' slots follow theirs
  } else {
    n = warp_compact(
        [&](const auto& visit) { sweep<8>([&](int i0, uint32_t(&key)[8]) { shared_keys(rs, i0, k, key); }, k, visit); },
        at_floor, 0, ties, [&](int i, uint32_t key, int slot) { keep(rid[i], key, slot); });
  }
#pragma unroll 1
  for (int gb = 0; gb < kg; gb += kBatch) {
    if (gb + kBatch < kg) {
      fetch(gb + kBatch);
      cp_wait_all_but_one();
    } else {
      copy_wait();
    }
    Held<kGroup> rows;  // lane l: group gb + l
    const long long row0 = gb + lane < kg ? static_cast<long long>(groups[gb + lane]) * kGroup : C;
    shared_keys(stage + (gb / kBatch % 2) * kBatch * kPitch + lane * kPitch, 0, static_cast<int>(min(C - row0, 32LL)),
                rows.key);
    n = warp_compact(rows, at_floor, n, ties, [&](int i, uint32_t key, int slot) {
      keep(start + static_cast<long long>(groups[gb + i / kGroup]) * kGroup + i % kGroup, key, slot);
    });
    __syncwarp();  // this half is read before its next batch lands
  }
  if (survivors != nullptr && lane == 0) {
    survivors[2 * q] = n;
    survivors[2 * q + 1] = cap;
  }
  __syncwarp();

  // the k best survivors
  const auto emit = [&](int i, uint32_t key, int slot) {
    out_s[q * k + slot] = value_of(key);
    out_i[q * k + slot] = bid[i];
  };
  if (n <= 8 * 32) {
    // held in registers; a few to drop (a late chunk) by rounds, else the select
    Held<8> held;
#pragma unroll
    for (int r = 0; r < 8; r += 4) {
      const uint4 t = *reinterpret_cast<const uint4*>(bkey + lane * 8 + r);
      const uint32_t x[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) held.key[r + j] = lane * 8 + r + j < n ? x[j] : 0u;
    }
    if (n - k <= 32) {
      drop_smallest(held, n - k);
      warp_compact(held, kAll, emit);
    } else {
      warp_compact(held, warp_select(held, k), emit);
    }
  } else if (n <= cap) {
    const auto buffered = [&](const auto& visit) {
      sweep<4>([&](int i0, uint32_t(&key)[4]) {
        const uint4 t = *reinterpret_cast<const uint4*>(bkey + i0);
        const uint32_t x[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) key[j] = i0 + j < n ? x[j] : 0u;
      }, n, visit);
    };
    warp_compact(buffered, warp_select(buffered, k), emit);
  } else {
    // the rare route: every candidate read where it lies, the floor as the filter
    const int kpad = (k + kGroup - 1) / kGroup * kGroup;
    const auto row_of = [&](int i) {
      return static_cast<long long>(groups[(i - kpad) / kGroup]) * kGroup + (i - kpad) % kGroup;
    };
    const auto cand = [&](const auto& visit) {
      sweep<4>([&](int i0, uint32_t(&key)[4]) {
        if (i0 < kpad) {
          shared_keys(rs, i0, k, key);
        } else {
          global_keys(srow, row_of(i0), C, key);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) key[j] = key[j] >= floor_key ? key[j] : 0u;
      }, kpad + kg * kGroup, visit);
    };
    warp_compact(cand, warp_select(cand, k), [&](int i, uint32_t key, int slot) {
      out_s[q * k + slot] = value_of(key);
      out_i[q * k + slot] = i < kpad ? rid[i] : start + row_of(i);
    });
  }
}

// Shared memory of a row's warp (a multiple of 16 bytes) and its survivor
// buffer's capacity for (k, G): the running ids and values, the staging
// area, the candidate groups, and k + kSlack survivors (a multiple of 4),
// or as many as fit.
bool plan_for(int k, int G, int& cap, size_t& smem) {
  const size_t kk = static_cast<size_t>(k);
  const size_t fixed = 8 * ((kk + 1) & ~size_t{1}) + 4 * kStage + 4 * ((kk + 7) & ~size_t{7}) + 4 * (k < G ? kk : G);
  const size_t per = sizeof(long long) + sizeof(uint32_t);
  if (fixed + per * 4 > kMaxSmem) return false;
  const size_t want = (kk + kSlack + 3) / 4 * 4;
  const size_t room = (kMaxSmem - fixed) / per / 4 * 4;
  cap = static_cast<int>(want < room ? want : room);
  smem = (fixed + per * static_cast<size_t>(cap) + 15) / 16 * 16;
  return true;
}

}  // namespace

// Pointers are device pointers: scores (B, C) and gmax (B, G) f32, top_s
// (B, k) f32 and top_i (B, k) int64 in; out_s, out_i (B, k) out; survivors
// (B, 2) int32 or null. G must be ceil(C / 32). Returns the cudaError_t of
// the launch.
extern "C" int group_topk_launch(const void* scores, const void* gmax, const void* top_s, const void* top_i,
                                 void* out_s, void* out_i, int B, long long C, int G, int k, long long start,
                                 void* survivors, void* stream) {
  int cap;
  size_t smem;
  if (B <= 0 || C <= 0 || k <= 0 || G != (C + kGroup - 1) / kGroup || k > INT_MAX / 2 / kGroup ||
      C > INT_MAX - k || !plan_for(k, G, cap, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(group_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  group_topk_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(gmax), static_cast<const float*>(top_s),
      static_cast<const long long*>(top_i), static_cast<float*>(out_s), static_cast<long long*>(out_i), C, G, k,
      start, cap, static_cast<int*>(survivors));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* group_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
