// Device code shared by the search kernels (batched_search.cu for the
// flat pass, ivf_search.cu for the IVF candidate slab): the chunk
// geometry, the two-key bitonic sort, the co-rank merge of two sorted
// lists, the running per-block top-k (admission behind a bar, warp-ballot
// compaction, merge of the candidate buffer into the list), the staging
// of LUT tiles and code rows, the codebook-order LUT sums, and the scan
// block (shared-memory layout, tiling, plan) with its two kernels: the
// crude kernel that the flat and the IVF crude pass launch, and the
// refine kernel that the flat and the IVF refine pass launch.
//
// Each source is compiled into its own shared library, so every helper
// here has internal linkage (anonymous namespace) in the one
// translation unit that includes it.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 1024;    // rows per block step; the widest sort
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kChunk / kThreads;   // a thread's chunk points
constexpr size_t kMaxSmem = 227 * 1024;
// candidate buffers up to this size merge by rank (no sort); larger ones
// are bitonic-sorted (128 pairs a warp, so a chunk takes every warp) and
// merged by co-rank
constexpr int kRankMerge = 64;
static_assert(kRankMerge >= 64 && kChunk == 128 * kWarps,
              "bitonic_sort_n sorts 128 to kChunk pairs, 128 a warp");

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared scratch of the running top-k (list_round): the +inf candidates
// of each (point group r, warp) of a round.
constexpr int kListScratchInts = kPerThread * kWarps;
constexpr size_t kListScratchBytes = align16(kListScratchInts * sizeof(int));

__device__ __forceinline__ bool key_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// Bitonic steps (stage k, distances j, j / 2, ..., 1) over a warp's
// 128 consecutive pairs from position base, held in registers: lane l
// holds positions base + l + 32 e (e < 4).  Distances 64 and 32 pair a
// lane's own registers, shorter ones two lanes (one shuffle each for
// value and index).  The pair's lower position keeps the smaller key in
// an ascending run ((position & k) == 0), the larger in a descending one.
__device__ __forceinline__ void warp_bitonic_steps(float (&v)[4], int (&ix)[4],
                                                   int base, int k, int j) {
  const int lane = threadIdx.x & 31;
  auto pair = [&](int lo, int hi) {   // lo, hi: constant register slots
    const bool up = ((base + lane + 32 * lo) & k) == 0;
    if (key_less(v[hi], ix[hi], v[lo], ix[lo]) == up) {
      const float tv = v[lo];
      const int ti = ix[lo];
      v[lo] = v[hi];
      ix[lo] = ix[hi];
      v[hi] = tv;
      ix[hi] = ti;
    }
  };
  for (; j > 0; j >>= 1) {
    if (j == 64) {
      pair(0, 2);
      pair(1, 3);
    } else if (j == 32) {
      pair(0, 1);
      pair(2, 3);
    } else {
      const bool lower = (lane & j) == 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float b = __shfl_xor_sync(0xffffffffu, v[e], j);
        const int ib = __shfl_xor_sync(0xffffffffu, ix[e], j);
        const bool up = ((base + lane + 32 * e) & k) == 0;
        // the lower position takes the smaller key going up, the larger
        // going down; its partner the other
        if (key_less(b, ib, v[e], ix[e]) == (lower == up)) {
          v[e] = b;
          ix[e] = ib;
        }
      }
    }
  }
}

// Ascending bitonic sort of P (value, index) pairs in shared memory, P a
// power of two in [128, 4 * blockDim.x].  Each warp sorts 128 pairs in
// registers (stages up to 128, no barrier); each later stage k takes
// its distances >= 128 as shared-memory steps across warps (a barrier
// each) and the rest in registers again, so P = 1024 costs 10 barriers
// where a barrier a step costs 55.  The caller synchronises before; the
// sort ends with a barrier.
__device__ void bitonic_sort_n(float* v, int* ix, int P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = warp * 128;
  const bool mine = base < P;
  float rv[4];
  int ri[4];
  auto load = [&]() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rv[e] = v[base + lane + 32 * e];
      ri[e] = ix[base + lane + 32 * e];
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[base + lane + 32 * e] = rv[e];
      ix[base + lane + 32 * e] = ri[e];
    }
  };
  if (mine) {
    load();
    for (int k = 2; k <= 128; k <<= 1)
      warp_bitonic_steps(rv, ri, base, k, k >> 1);
    store();
  }
  __syncthreads();
  for (int k = 256; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 128; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const float a = v[i], b = v[l];
          const int ia = ix[i], ib = ix[l];
          const bool up = (i & k) == 0;
          if (up ? key_less(b, ib, a, ia) : key_less(a, ia, b, ib)) {
            v[i] = b;
            v[l] = a;
            ix[i] = ib;
            ix[l] = ia;
          }
        }
      }
      __syncthreads();
    }
    if (mine) {
      load();
      warp_bitonic_steps(rv, ri, base, k, 64);
      store();
    }
    __syncthreads();
  }
}

// Element t of the merge of two ascending lists A (wa pairs) and B (wb
// pairs), A first on equal keys: a co-rank binary search for the number
// a of A's pairs among the merge's first t, then the smaller head.
// t < wa + wb.  The pointers may address shared or global memory.
__device__ __forceinline__ void merged_at(const float* av, const int* ai,
                                          int wa, const float* bv,
                                          const int* bi, int wb, int t,
                                          float& v, int& id) {
  int lo = max(0, t - wb), hi = min(t, wa);
  while (lo < hi) {   // A[mid] precedes B[t - mid - 1]: take more of A
    const int mid = (lo + hi) >> 1;
    if (key_less(bv[t - mid - 1], bi[t - mid - 1], av[mid], ai[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  const int a = lo, b = t - lo;
  if (a < wa && (b >= wb || !key_less(bv[b], bi[b], av[a], ai[a]))) {
    v = av[a];
    id = ai[a];
  } else {
    v = bv[b];
    id = bi[b];
  }
}

// Merge the c sorted candidates (bv, bi) into the ascending list (lv, li)
// of topk pairs, keeping its first topk, in place: rounds of blockDim.x
// output positions from the back, each computed (co-rank search over
// the list and the buffer) before any is written.  A round reads list
// pairs at positions <= its own, which later (lower) rounds have not
// written yet.  All threads call it; it synchronises after each round.
__device__ void merge_into_list(float* lv, int* li, int topk,
                                const float* bv, const int* bi, int c) {
  for (int start = (topk - 1) / int(blockDim.x) * int(blockDim.x);
       start >= 0; start -= int(blockDim.x)) {
    const int t = start + threadIdx.x;
    float v = 0.0f;
    int id = 0;
    if (t < topk) merged_at(lv, li, topk, bv, bi, c, t, v, id);
    __syncthreads();
    if (t < topk) {
      lv[t] = v;
      li[t] = id;
    }
    __syncthreads();
  }
}

// Merge a small unsorted candidate buffer (c <= blockDim.x pairs) into
// the ascending list, in place, without sorting it: list pair i moves to
// i + #(candidates below it), candidate b to #(list pairs below it) +
// #(candidates below it), and whatever lands at topk or past it falls
// off.  Keys are distinct (pads only repeat in the list, and keep their
// order), so the positions below topk are each taken once.  Candidate
// positions are taken from the
// list before it moves and written last, into the holes; list pairs move
// right only, in rounds from the back as in merge_into_list.
__device__ void rank_into_list(float* lv, int* li, int topk,
                               const float* bv, const int* bi, int c) {
  int cpos = topk;
  float cv = 0.0f;
  int ci = 0;
  if (int(threadIdx.x) < c) {
    cv = bv[threadIdx.x];
    ci = bi[threadIdx.x];
    int lo = 0, hi = topk;           // list pairs below the candidate
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_less(lv[mid], li[mid], cv, ci))
        lo = mid + 1;
      else
        hi = mid;
    }
    cpos = lo;
    for (int b = 0; b < c; ++b) cpos += key_less(bv[b], bi[b], cv, ci);
  }
  for (int start = (topk - 1) / int(blockDim.x) * int(blockDim.x);
       start >= 0; start -= int(blockDim.x)) {
    const int t = start + threadIdx.x;
    float v = 0.0f;
    int id = 0, to = topk;
    if (t < topk) {
      v = lv[t];
      id = li[t];
      to = t;
      for (int b = 0; b < c; ++b) to += key_less(bv[b], bi[b], v, id);
    }
    __syncthreads();
    if (to < topk) {
      lv[to] = v;
      li[to] = id;
    }
    __syncthreads();
  }
  if (cpos < topk) {
    lv[cpos] = cv;
    li[cpos] = ci;
  }
  __syncthreads();
}

// A block's running top-k of one query: the ascending list (v, i) of
// topk (value, index) pairs, its pending buffer (bv, bi; kChunk pairs)
// of candidates not merged yet, and two ints of shared memory: the
// buffer's count and the first position a round could not write.
struct RunningList {
  float* v;
  int* i;
  float* bv;
  int* bi;
  int* count;   // count[0]: pending pairs; count[1]: first unwritten
  int topk;
};

// An empty running list: topk pads (+inf, INT_MAX), which sort after
// every real point, the +inf ones included; nothing pending.
__device__ void start_list(const RunningList& L) {
  for (int t = threadIdx.x; t < L.topk; t += blockDim.x) {
    L.v[t] = CUDART_INF_F;
    L.i[t] = INT_MAX;
  }
  if (threadIdx.x == 0) {
    L.count[0] = 0;
    L.count[1] = INT_MAX;
  }
}

// Merge the first c pending pairs into the list: up to kRankMerge by
// rank, more by a bitonic sort of the buffer (padded to P >= 128 pairs)
// and a co-rank merge.  c is uniform; all threads call it and it ends
// with a barrier.
__device__ void merge_pending(const RunningList& L, int c) {
  if (c <= kRankMerge) {
    rank_into_list(L.v, L.i, L.topk, L.bv, L.bi, c);
    return;
  }
  int P = 1;
  while (P < c) P <<= 1;
  for (int t = c + threadIdx.x; t < P; t += blockDim.x) {
    L.bv[t] = CUDART_INF_F;
    L.bi[t] = INT_MAX;
  }
  __syncthreads();
  bitonic_sort_n(L.bv, L.bi, P);
  merge_into_list(L.v, L.i, L.topk, L.bv, L.bi, c);
}

// Merge whatever is pending (at the end of a block's walk).  All threads
// call it.
__device__ void flush_list(const RunningList& L) {
  __syncthreads();
  const int c = L.count[0];
  if (c > 0) {
    merge_pending(L, c);
    if (threadIdx.x == 0) L.count[0] = 0;
  }
}

__device__ void store_list(float* out_v, int* out_i, const float* lv,
                           const int* li, int topk) {
  for (int t = threadIdx.x; t < topk; t += blockDim.x) {
    out_v[t] = lv[t];
    out_i[t] = li[t];
  }
}

// One round of a running top-k: the points of one chunk for one query
// enter the list L.  Thread t holds the chunk's points t + r * kThreads
// (r < kPerThread), of index base + t + r * kThreads and value v[r];
// indices >= limit are absent.  The list's last pair is the bar tau: a
// point is a candidate only if its key is below it.  Candidates are
// compacted into the pending buffer with one ballot per point group and
// one shared-memory add per warp.
//
// Without KEEP the buffer is merged into the list at the end of the
// round (the crude pass: one buffer serves every query of its tile).
// With KEEP it is merged only when the list still holds pads, when it
// would overflow, and at the end of the walk (flush_list): the bar stays
// where the last merge left it, so later rounds admit more candidates
// than a fresh bar would, which only costs buffer room, and a round
// whose candidates fit costs one barrier and no merge.
//
// +inf points (pruned by a margin test) rank by index, lowest first, and
// fill the list while it holds pads.  In such a round a +inf point is a
// candidate only if fewer than topk +inf candidates of the chunk have a
// lower index (a block-wide prefix count): the others would fall off
// the list behind those.  Membership is decided by the keys alone; the
// cap only keeps the first chunk of a block from filling the buffer.
// Once a block's list is full, +inf points of its later (higher) chunks
// are above the bar, since a block walks its chunks in ascending order.
//
// scratch: kListScratchInts ints, shared by the block's lists.  The list
// and its buffer are read and written only between barriers, so every
// thread sees the same bar and counts.  All threads call it.
template <bool KEEP>
__device__ __forceinline__ void list_round(const RunningList& L,
                                           int* scratch,
                                           const float (&v)[kPerThread],
                                           int base, int limit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* inf_count = scratch;
  const float tau_v = L.v[L.topk - 1];
  const int tau_i = L.i[L.topk - 1];
  const bool pads = tau_i == INT_MAX;
  bool enter[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int id = base + int(threadIdx.x) + r * kThreads;
    enter[r] = id < limit && key_less(v[r], id, tau_v, tau_i);
  }
  if (pads) {                        // cap the +inf candidates
    unsigned inf_mask[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      inf_mask[r] = __ballot_sync(0xffffffffu,
                                  enter[r] && v[r] == CUDART_INF_F);
      if (lane == 0) inf_count[r * kWarps + warp] = __popc(inf_mask[r]);
    }
    __syncthreads();
    int before = 0;                  // +inf candidates of lower index
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      for (int j = r == 0 ? 0 : (r - 1) * kWarps + warp; j < r * kWarps + warp;
           ++j)
        before += inf_count[j];
      if (inf_mask[r] >> lane & 1u)
        enter[r] = before + __popc(inf_mask[r] & below) < L.topk;
    }
  }
  unsigned mask[kPerThread];
  int total = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    mask[r] = __ballot_sync(0xffffffffu, enter[r]);
    total += __popc(mask[r]);
  }
  // a warp writes its candidates only if all of them fit; else it marks
  // the first position it could not write, and writes after a merge
  // (without KEEP the buffer is empty at the start of a round and holds
  // a chunk, so everything fits)
  auto place = [&]() {
    int at = 0;
    if (lane == 0 && total != 0) at = atomicAdd(L.count, total);
    at = __shfl_sync(0xffffffffu, at, 0);
    if (KEEP && at + total > kChunk) {
      if (lane == 0) atomicMin(L.count + 1, at);
      return false;
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (enter[r]) {
        const int pos = at + __popc(mask[r] & below);
        L.bv[pos] = v[r];
        L.bi[pos] = base + int(threadIdx.x) + r * kThreads;
      }
      at += __popc(mask[r]);
    }
    return true;
  };
  const bool placed = place();
  __syncthreads();
  int c = L.count[0];
  if (KEEP && c > kChunk) {          // uniform: merge what was written
    merge_pending(L, L.count[1]);
    if (threadIdx.x == 0) {
      L.count[0] = 0;
      L.count[1] = INT_MAX;
    }
    __syncthreads();
    if (!placed) place();            // this round's candidates all fit
    __syncthreads();
    c = L.count[0];
  }
  if (c > 0 && (!KEEP || pads)) {
    merge_pending(L, c);
    if (threadIdx.x == 0) L.count[0] = 0;
  }
}

// Rows [q0, q0 + qt) of a row-major (nq, Km) table into shared memory,
// rows past nq zeroed; eight independent loads in flight per thread.
template <typename T>
__device__ void load_table_tile(T* dst, const T* __restrict__ src, int q0,
                                int qt, int nq, int Km) {
  const int total = qt * Km, valid = (min(q0 + qt, nq) - q0) * Km;
  src += long(q0) * Km;
  for (int i0 = threadIdx.x; i0 < total; i0 += 8 * int(blockDim.x)) {
    T t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * int(blockDim.x);
      t[u] = i < valid ? src[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * int(blockDim.x);
      if (i < total) dst[i] = t[u];
    }
  }
}

// 16- and 4-byte copies from global to shared memory that complete
// asynchronously (cp.async), and the wait for all of a thread's copies.
template <int BYTES, typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == BYTES, "one element per copy");
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Copy nbytes from global to shared memory (the destination 16-byte
// aligned): 16-byte pieces when the source is 16-byte aligned, 4-byte
// words when it is 4-byte aligned, bytes for the rest.  With async, the
// pieces and words are cp.async copies that the caller waits for
// (cp_async_wait_all) before the barrier that publishes them.
template <typename T>
__device__ __forceinline__ int stage_pieces(void* dst, const void* src,
                                            int nbytes, bool async) {
  const int n = nbytes / int(sizeof(T));
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (async)
      cp_async<sizeof(T)>(d + i, s + i);
    else
      d[i] = s[i];
  }
  return n * int(sizeof(T));
}
__device__ void stage_bytes(void* dst, const void* src, int nbytes,
                            bool async) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  int done = 0;
  if ((a & 15) == 0)
    done = stage_pieces<uint4>(dst, src, nbytes, async);
  else if ((a & 3) == 0)
    done = stage_pieces<uint32_t>(dst, src, nbytes, async);
  for (int i = done + threadIdx.x; i < nbytes; i += blockDim.x)
    static_cast<uint8_t*>(dst)[i] = static_cast<const uint8_t*>(src)[i];
}

// Stage the code rows [base, base + kChunk) of the (n, Kc) codes: uint8
// rows (m <= 256) or int32 rows (wider codes, as the index stores them).
template <typename CodeT>
__device__ void load_codes(CodeT* dst, const CodeT* __restrict__ codes,
                           long base, long n, int Kc, bool async = false) {
  const long rows = min(long(kChunk), n - base);
  stage_bytes(dst, codes + base * Kc, int(rows) * Kc * int(sizeof(CodeT)),
              async);
}

// Code kc of a staged row, in codebook order.  uint8 rows of a multiple
// of 4 bytes are read as 32-bit words (a staged row starts 4-aligned),
// int32 rows of a multiple of 4 codes as 16-byte vectors (a staged row
// then starts 16-aligned); the sum order is the same either way.
template <typename Add>
__device__ __forceinline__ void for_row_codes(const uint8_t* row, int Kc,
                                              Add add) {
  if ((Kc & 3) == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
    for (int k4 = 0; k4 < (Kc >> 2); ++k4) {
      const uint32_t v = w[k4];
      add(4 * k4, int(v & 255u));
      add(4 * k4 + 1, int((v >> 8) & 255u));
      add(4 * k4 + 2, int((v >> 16) & 255u));
      add(4 * k4 + 3, int(v >> 24));
    }
  } else {
    for (int kc = 0; kc < Kc; ++kc) add(kc, int(row[kc]));
  }
}
template <typename Add>
__device__ __forceinline__ void for_row_codes(const int32_t* row, int Kc,
                                              Add add) {
  if ((Kc & 3) == 0) {
    const int4* w = reinterpret_cast<const int4*>(row);
    for (int k4 = 0; k4 < (Kc >> 2); ++k4) {
      const int4 v = w[k4];
      add(4 * k4, v.x);
      add(4 * k4 + 1, v.y);
      add(4 * k4 + 2, v.z);
      add(4 * k4 + 3, v.w);
    }
  } else {
    for (int kc = 0; kc < Kc; ++kc) add(kc, row[kc]);
  }
}

// f32 LUT sum of one code row, codebooks in order from 0.0.  Nibble byte
// kc holds codebooks (2kc, 2kc+1) in its (low, high) nibble; the odd-K
// sentinel codebook has an all-zero LUT column.  Nibbles come in uint8
// rows only.
template <bool NIBBLE, typename CodeT>
__device__ __forceinline__ float row_sum_f32(const float* lut,
                                             const CodeT* row, int Kc,
                                             int m) {
  static_assert(!NIBBLE || sizeof(CodeT) == 1, "nibbles are bytes");
  float acc = 0.0f;
  for_row_codes(row, Kc, [&](int kc, int b) {
    if (NIBBLE) {
      acc = __fadd_rn(acc, lut[(2 * kc) * m + (b & 15)]);
      acc = __fadd_rn(acc, lut[(2 * kc + 1) * m + (b >> 4)]);
    } else {
      acc = __fadd_rn(acc, lut[kc * m + b]);
    }
  });
  return acc;
}

// int8 LUT sum of one code row: exact in int32.
template <bool NIBBLE, typename CodeT>
__device__ __forceinline__ int row_sum_i8(const int8_t* lut,
                                          const CodeT* row, int Kc, int m) {
  static_assert(!NIBBLE || sizeof(CodeT) == 1, "nibbles are bytes");
  int acc = 0;
  for_row_codes(row, Kc, [&](int kc, int b) {
    if (NIBBLE) {
      acc += lut[(2 * kc) * m + (b & 15)];
      acc += lut[(2 * kc + 1) * m + (b >> 4)];
    } else {
      acc += lut[kc * m + b];
    }
  });
  return acc;
}

// The int8 dequant scale * acc + offset as two roundings (no FMA), the
// plain version's expression.
__device__ __forceinline__ float dequant(float scale, int acc, float offset) {
  return __fadd_rn(__fmul_rn(scale, float(acc)), offset);
}

template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ---- scan blocks: the crude and the refine pass, flat and IVF ---------
//
// A scan block walks its chunks (strided over the rows, in ascending
// order) for a tile of qt queries and keeps a running list per query.
// The flat passes share each chunk's code rows among the tile's queries
// (codes_q_stride 0); the IVF passes give each query its own slab of n
// rows (codes_q_stride n * Kc, qt = 1), where a row's index is its slab
// position.

// Dynamic shared memory of one scan block: candidate buffers (the crude
// pass one for its tile, the refine pass one per query, which keeps its
// candidates pending across chunks), `stages` staging buffers of code
// rows (row_bytes each: Kc bytes for uint8 rows, 4 Kc for int32 rows;
// with two stages the refine pass stages the crude values of its tile
// beside them, with one it reads them from global memory), LUTs of the
// query tile, per-query scalars (scale/offset or threshold), the
// running top-k's scratch and counts and, when they fit, the qt running
// lists of topk pairs.
__host__ __device__ size_t stage_bytes_per_buf(int row_bytes, int qt,
                                               bool with_crude) {
  return align16(size_t(kChunk) * row_bytes) +
         (with_crude ? size_t(qt) * kChunk * sizeof(float) : 0);
}
__host__ __device__ size_t scan_smem_bytes(int row_bytes, int qt, int Km,
                                           int lut_esize, int n_scalars,
                                           int topk, bool lists_in_smem,
                                           bool refine, int stages) {
  const int buffers = refine ? qt : 1;
  return size_t(buffers) * kChunk * (sizeof(float) + sizeof(int)) +
         stages * stage_bytes_per_buf(row_bytes, qt, refine && stages == 2) +
         align16(size_t(qt) * Km * lut_esize) +
         align16(size_t(n_scalars) * qt * sizeof(float)) + kListScratchBytes +
         align16(size_t(2) * qt * sizeof(int)) +
         (lists_in_smem ? size_t(qt) * topk * (sizeof(float) + sizeof(int))
                        : 0);
}

struct ScanSmem {
  float* val;       // candidate buffers of kChunk pairs
  int* idx;
  uint8_t* stage;   // staging buffers: kChunk code rows (then, in the
  size_t stage_buf; // two-stage refine pass, qt rows of kChunk crude
  size_t crude_off; // values); bytes between buffers; the crude offset
  unsigned char* lut;
  float* scalars;
  int* scratch;
  int* counts;      // two per query
  float* list_v;    // qt lists of topk pairs, when they fit
  int* list_i;
};

__device__ ScanSmem carve(unsigned char* base, int row_bytes, int qt, int Km,
                          int lut_esize, int n_scalars, int topk,
                          bool refine, int stages) {
  const int buffers = refine ? qt : 1;
  ScanSmem s;
  s.val = reinterpret_cast<float*>(base);
  s.idx = reinterpret_cast<int*>(s.val + size_t(buffers) * kChunk);
  size_t off = size_t(buffers) * kChunk * (sizeof(float) + sizeof(int));
  s.stage = base + off;
  s.stage_buf = stage_bytes_per_buf(row_bytes, qt, refine && stages == 2);
  s.crude_off = align16(size_t(kChunk) * row_bytes);
  off += stages * s.stage_buf;
  s.lut = base + off;
  off += align16(size_t(qt) * Km * lut_esize);
  s.scalars = reinterpret_cast<float*>(base + off);
  off += align16(size_t(n_scalars) * qt * sizeof(float));
  s.scratch = reinterpret_cast<int*>(base + off);
  off += kListScratchBytes;
  s.counts = reinterpret_cast<int*>(base + off);
  off += align16(size_t(2) * qt * sizeof(int));
  s.list_v = reinterpret_cast<float*>(base + off);
  s.list_i = reinterpret_cast<int*>(s.list_v + size_t(qt) * topk);
  return s;
}

// Block x's running lists of the queries of its tile: in shared memory,
// or (lists_in_smem = false) its own output rows q * gridDim.x + x of
// the (nq, gridDim.x, topk) candidate lists.  Query q's candidates go to
// buffer q (the refine pass) or all to buffer 0 (the crude pass).
struct BlockLists {
  const ScanSmem& s;
  float* out_v;
  int* out_i;
  int q0, topk;
  bool in_smem, buffer_per_query;
  __device__ long row(int q) const {
    return (long(q0 + q) * gridDim.x + blockIdx.x) * topk;
  }
  __device__ RunningList operator[](int q) const {
    const size_t b = buffer_per_query ? size_t(q) * kChunk : 0;
    return RunningList{in_smem ? s.list_v + size_t(q) * topk : out_v + row(q),
                       in_smem ? s.list_i + size_t(q) * topk : out_i + row(q),
                       s.val + b, s.idx + b, s.counts + 2 * q, topk};
  }
  __device__ void start(int nql) const {
    for (int q = 0; q < nql; ++q) start_list((*this)[q]);
  }
  // pending candidates merged, the lists in shared memory written out;
  // all threads call it
  __device__ void finish(int nql) const {
    for (int q = 0; q < nql; ++q) flush_list((*this)[q]);
    if (!in_smem) return;
    __syncthreads();
    for (int q = 0; q < nql; ++q)
      store_list(out_v + row(q), out_i + row(q), (*this)[q].v, (*this)[q].i,
                 topk);
  }
};

// Phase 1, flat and IVF: the fast-masked LUT sum of every row for every
// query of the tile (int8 LUTs dequantized as scale * acc + offset), the
// dense crude rows and the crude top-k.  grid (x: blocks strided over
// the n rows' chunks, y: query tiles of qt).  codes (n, Kc) of CodeT
// (uint8, or int32 for codes wider than a byte) shared by the tile or
// each query's own slab (codes_q_stride, above); crude (nq, n), or null:
// no dense matrix is written.  MASK (kNoMask, kSlabIds, kRowPred) names
// the rows that are +inf, in the dense crude row and in the ranking,
// never summed (under int8 never offset + scale * acc either): with
// kSlabIds, mask is the (nq, n) int32 id slab and a row whose id is < 0
// (the IVF slab's pads, its filtered candidates) is +inf; with
// kRowPred, mask is a flat filter's (n,) uint8 predicate, shared by
// every query of the tile, and a row whose byte is 0 is +inf.  out_v /
// out_i (nq, gridDim.x, topk): block x's list of query q is row (q *
// gridDim.x + x).
//
// A running list per query, its candidates merged at the end of each
// round (list_round<false>, one buffer for the tile): the block's first
// chunk fills the list, after it the bar prunes almost every row, so a
// later round is a ballot, a barrier and a merge by rank of the few rows
// below the bar.  +inf rows enter only while the list holds pads, lowest
// position first, so a slab row with fewer valid rows than topk ends in
// its lowest invalid positions, and a filtered flat row in its lowest
// filtered rows (the order of one two-key sort of the masked crude
// row).  Each chunk's code rows are loaded
// between two barriers (double-buffering them with cp.async gained 1-4%
// on the slab pass on the H100, which the IVF tile's host time hides).
// The launch bound asks for two blocks an SM, which the shared memory
// allows anyway: without it ptxas settles for 48 registers and spills
// in the int8 variant.  The int32-row instances compile on their own,
// so the uint8 ones keep their registers.
constexpr int kNoMask = 0, kSlabIds = 1, kRowPred = 2;

template <typename CodeT, bool QUANT, bool NIBBLE, int MASK>
__global__ void __launch_bounds__(kThreads, 2)
crude_scan_kernel(const CodeT* __restrict__ codes, long codes_q_stride,
                  const void* __restrict__ mask,
                  const void* __restrict__ lut_g,
                  const float* __restrict__ scale_g,
                  const float* __restrict__ offset_g,
                  float* __restrict__ crude, float* out_v, int* out_i,
                  int n, int Kc, int nq, int Km, int m, int topk, int qt,
                  bool lists_in_smem) {
  // named apart from the other sources' own dynamic shared arrays
  extern __shared__ __align__(16) unsigned char scan_smem[];
  const ScanSmem s = carve(scan_smem, Kc * int(sizeof(CodeT)), qt, Km,
                           QUANT ? 1 : 4, QUANT ? 2 : 0, topk, false, 1);
  const CodeT* staged = reinterpret_cast<const CodeT*>(s.stage);
  const int q0 = blockIdx.y * qt;
  const int nql = min(qt, nq - q0);              // queries of this tile
  const int nchunks = (n + kChunk - 1) / kChunk;
  const BlockLists lists{s, out_v, out_i, q0, topk, lists_in_smem, false};
  codes += long(blockIdx.y) * codes_q_stride;
  if (QUANT)
    load_table_tile(reinterpret_cast<int8_t*>(s.lut),
                    static_cast<const int8_t*>(lut_g), q0, qt, nq, Km);
  else
    load_table_tile(reinterpret_cast<float*>(s.lut),
                    static_cast<const float*>(lut_g), q0, qt, nq, Km);
  if (QUANT) {
    for (int i = threadIdx.x; i < qt; i += blockDim.x) {
      const int q = q0 + i;
      s.scalars[i] = q < nq ? scale_g[q] : 0.0f;
      s.scalars[qt + i] = q < nq ? offset_g[q] : 0.0f;
    }
  }
  lists.start(nql);
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const long base = long(chunk) * kChunk;
    __syncthreads();  // the previous chunk's readers are done
    load_codes(reinterpret_cast<CodeT*>(s.stage), codes, base, n, Kc);
    __syncthreads();
    // a flat filter's bytes of the thread's points, read once for the
    // tile's queries
    bool keep[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const long gi = base + threadIdx.x + r * kThreads;
      keep[r] = MASK != kRowPred ||
                (gi < n && static_cast<const uint8_t*>(mask)[gi] != 0);
    }
    for (int q = 0; q < nql; ++q) {
      const long qrow = long(q0 + q) * n;
      // the thread's kPerThread points first (independent gather
      // chains), then one shared-memory add per warp for all of them
      float dv[kPerThread];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int p = threadIdx.x + r * kThreads;
        const long gi = base + p;
        float d = CUDART_INF_F;
        if (gi < n) {
          const bool valid =
              MASK == kSlabIds
                  ? static_cast<const int*>(mask)[qrow + gi] >= 0
                  : keep[r];
          if (valid) {
            const CodeT* row = staged + p * Kc;
            if (QUANT) {
              const int acc = row_sum_i8<NIBBLE>(
                  reinterpret_cast<const int8_t*>(s.lut) + q * Km, row, Kc,
                  m);
              d = dequant(s.scalars[q], acc, s.scalars[qt + q]);
            } else {
              d = row_sum_f32<NIBBLE>(
                  reinterpret_cast<const float*>(s.lut) + q * Km, row, Kc,
                  m);
            }
          }
          if (crude != nullptr) crude[qrow + gi] = d;
        }
        dv[r] = d;
      }
      list_round<false>(lists[q], s.scratch, dv, int(base), n);
    }
  }
  lists.finish(nql);
}

// Phase 2, flat and IVF: the margin test crude < thr, the slow-masked
// f32 LUT sum for survivors, full = crude + slow; pruned points rank
// +inf.  grid (x: blocks strided over the n rows' chunks, y: query
// tiles of qt).  codes as in the crude kernel; crude (nq, n); out_v /
// out_i (nq, gridDim.x, topk): block x's list of query q is row (q *
// gridDim.x + x).
//
// A running list per query with a pending buffer (list_round<true>):
// the served cells let a few rows per chunk and query through, so a
// round is a margin test, a few slow sums and one barrier, and a list
// merges rarely.  STAGES = 2: the next chunk's code rows and crude
// values are staged (cp.async) into the other buffer while the block
// works on the current chunk; 1 (codes too wide for two): the code rows
// are staged after it and the crude values read from global memory,
// one coalesced word per thread and point.
//
// SELECT (the refine_cap survivor selection): no code rows, no LUTs and
// no slow sum; a survivor's key is its crude value, so each query's
// list is the top-topk of its margin-test survivors by crude (the cap
// best-crude survivors, topk = cap), pruned rows ranking (+inf, index)
// behind them as in the refine pass.  codes and lut_g are null and Kc
// = Km = 0: a staging buffer holds the tile's crude rows only.
template <typename CodeT, bool NIBBLE, int STAGES, bool SELECT = false>
__global__ void __launch_bounds__(kThreads)
refine_scan_kernel(const CodeT* __restrict__ codes, long codes_q_stride,
                   const float* __restrict__ lut_g,
                   const float* __restrict__ crude,
                   const float* __restrict__ thr_g, float* out_v, int* out_i,
                   int n, int Kc, int nq, int Km, int m, int topk, int qt,
                   bool lists_in_smem) {
  // named apart from the other sources' own dynamic shared arrays
  extern __shared__ __align__(16) unsigned char scan_smem[];
  const ScanSmem s = carve(scan_smem, Kc * int(sizeof(CodeT)), qt, Km, 4, 1,
                           topk, true, STAGES);
  const float* lut = reinterpret_cast<const float*>(s.lut);
  const int q0 = blockIdx.y * qt;
  const int nql = min(qt, nq - q0);
  const int nchunks = (n + kChunk - 1) / kChunk;
  const BlockLists lists{s, out_v, out_i, q0, topk, lists_in_smem, true};
  codes += long(blockIdx.y) * codes_q_stride;
  // a chunk's code rows (with two stages also its crude rows of the
  // tile) into buffer b
  auto stage = [&](int chunk, int b) {
    const long base = long(chunk) * kChunk;
    uint8_t* dst = s.stage + b * s.stage_buf;
    if (!SELECT)
      load_codes(reinterpret_cast<CodeT*>(dst), codes, base, n, Kc, true);
    if (STAGES == 1) return;
    const int rows = int(min(long(kChunk), n - base));
    for (int q = 0; q < nql; ++q)
      stage_bytes(dst + s.crude_off + size_t(q) * kChunk * sizeof(float),
                  crude + long(q0 + q) * n + base, rows * int(sizeof(float)),
                  true);
  };
  if (blockIdx.x < nchunks) stage(blockIdx.x, 0);
  if (!SELECT)
    load_table_tile(reinterpret_cast<float*>(s.lut), lut_g, q0, qt, nq, Km);
  for (int i = threadIdx.x; i < qt; i += blockDim.x)
    s.scalars[i] = q0 + i < nq ? thr_g[q0 + i] : 0.0f;
  lists.start(nql);
  int buf = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const long base = long(chunk) * kChunk;
    const int next = chunk + int(gridDim.x);
    cp_async_wait_all();   // this chunk's rows
    __syncthreads();       // ... for every thread; the other buffer's
                           // readers (the previous chunk) are done
    if (STAGES == 2 && next < nchunks) stage(next, buf ^ 1);
    const uint8_t* rows = s.stage + buf * s.stage_buf;
    const CodeT* staged = reinterpret_cast<const CodeT*>(rows);
    const float* cr = reinterpret_cast<const float*>(rows + s.crude_off);
    for (int q = 0; q < nql; ++q) {
      const float thr = s.scalars[q];
      float v[kPerThread];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int p = threadIdx.x + r * kThreads;
        v[r] = CUDART_INF_F;
        if (base + p < n) {
          const float c = STAGES == 2 ? cr[q * kChunk + p]
                                      : crude[long(q0 + q) * n + base + p];
          if (c < thr)
            v[r] = SELECT ? c
                          : __fadd_rn(c, row_sum_f32<NIBBLE>(
                                             lut + q * Km, staged + p * Kc,
                                             Kc, m));
        }
      }
      list_round<true>(lists[q], s.scratch, v, int(base), n);
    }
    if (STAGES == 1 && next < nchunks) {
      __syncthreads();     // this chunk's readers are done
      stage(next, 0);
    }
    buf ^= STAGES - 1;
  }
  lists.finish(nql);
}

// A scan pass's shape: the largest query tile (at most max_qt) whose
// running lists fit in shared memory beside the LUTs; if none does, the
// largest tile without them (lists in global memory).  The refine pass
// double-buffers its staging (stages = 2) unless not even one query
// fits that way, and then stages after each chunk; the crude pass loads
// each chunk between barriers (stages = 1).  Wide codes (m > 256: int32
// rows, 4 Kc bytes, and K * m LUT entries a query) take the same search:
// at m = 1024 a query's f32 LUT is 4 K KB, so the flat crude's tile of 8
// shrinks to what fits.  qt = 0: nothing fits.
struct ScanTiling {
  int qt, stages;
  bool lists_in_smem;
  size_t smem;
};

ScanTiling scan_tiling(int row_bytes, int Km, int lut_esize, int n_scalars,
                       int topk, bool refine, int max_qt) {
  for (int stages = refine ? 2 : 1; stages >= 1; --stages) {
    for (int lists = 1; lists >= 0; --lists) {
      for (int qt = max_qt; qt >= 1; qt >>= 1) {
        const size_t b = scan_smem_bytes(row_bytes, qt, Km, lut_esize,
                                         n_scalars, topk, lists, refine,
                                         stages);
        if (b <= kMaxSmem) return ScanTiling{qt, stages, lists == 1, b};
      }
    }
  }
  return ScanTiling{0, 1, true, 0};
}

ScanTiling refine_tiling(int row_bytes, int Km, int topk, int max_qt) {
  return scan_tiling(row_bytes, Km, 4, 1, topk, true, max_qt);
}

ScanTiling crude_tiling(int row_bytes, int Km, int quant, int topk,
                        int max_qt) {
  return scan_tiling(row_bytes, Km, quant ? 1 : 4, quant ? 2 : 0, topk, false,
                     max_qt);
}

bool scan_args_ok(const ScanTiling& t, int n, int nq, int topk) {
  return t.qt > 0 && n >= 1 && nq >= 1 && (nq + t.qt - 1) / t.qt <= 65535 &&
         topk >= 1 && topk <= n;
}

// A row of code_bytes bytes a code: 1 (uint8, nibbles too) or 4 (int32,
// never nibbles).
bool code_bytes_ok(int code_bytes, int nibble) {
  return code_bytes == 1 || (code_bytes == 4 && !nibble);
}

// Blocks along the rows of a scan launch, for the caller to size its
// candidate lists (nq, out[0], topk): one wave of blocks (as many as fit
// on all SMs at this shared memory, divided among the query tiles), at
// most one per 1024-row chunk and one per topk rows (the lists then
// hold at most nq x n pairs).
template <typename Kernel>
int scan_plan(Kernel kernel, const ScanTiling& t, int n, int nq, int topk,
              int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(t.smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, t.smem);
  if (e != cudaSuccess) return int(e);
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int qtiles = (nq + t.qt - 1) / t.qt;
  const int wave = max(1, per_sm) * sms / qtiles;
  out[0] = max(1, min(min(nchunks, n / topk), wave));
  return int(cudaSuccess);
}

// The kernels' instances for a row type, LUT type, code width and stage
// count (nibbles only in uint8 rows).
template <typename CodeT, int MASK>
auto crude_instance(int quant, int nibble) {
  if constexpr (sizeof(CodeT) == 1) {
    if (quant)
      return nibble ? crude_scan_kernel<CodeT, true, true, MASK>
                    : crude_scan_kernel<CodeT, true, false, MASK>;
    return nibble ? crude_scan_kernel<CodeT, false, true, MASK>
                  : crude_scan_kernel<CodeT, false, false, MASK>;
  } else {
    return quant ? crude_scan_kernel<CodeT, true, false, MASK>
                 : crude_scan_kernel<CodeT, false, false, MASK>;
  }
}
template <typename CodeT, int STAGES>
auto refine_instance(int nibble) {
  if constexpr (sizeof(CodeT) == 1)
    return nibble ? refine_scan_kernel<CodeT, true, STAGES>
                  : refine_scan_kernel<CodeT, false, STAGES>;
  else
    return refine_scan_kernel<CodeT, false, STAGES>;
}

// The crude pass's plan and launch, flat (MAX_QT > 1, codes_q_stride 0,
// kNoMask, or kRowPred by a filter) and IVF (MAX_QT = 1, codes_q_stride
// n * Kc, kSlabIds); the refine pass's, flat (MAX_QT > 1) and IVF
// (MAX_QT = 1), and its survivor selection (select_*); for
// uint8 rows (code_bytes 1) or int32 rows (4).  Each returns
// cudaErrorInvalidValue for a shape that no tiling serves.  Templates,
// so that only the sources that launch a kernel compile it.
template <typename CodeT, int MAX_QT, int MASK>
int crude_plan_rows(int n, int Kc, int nq, int Km, int quant, int nibble,
                    int topk, int* out) {
  const ScanTiling t = crude_tiling(Kc * int(sizeof(CodeT)), Km, quant, topk,
                                    MAX_QT);
  if (!scan_args_ok(t, n, nq, topk)) return int(cudaErrorInvalidValue);
  return scan_plan(crude_instance<CodeT, MASK>(quant, nibble), t, n, nq,
                   topk, out);
}

template <int MAX_QT, int MASK>
int crude_plan(int n, int Kc, int nq, int Km, int quant, int nibble,
               int code_bytes, int topk, int* out) {
  if (!code_bytes_ok(code_bytes, nibble)) return int(cudaErrorInvalidValue);
  return code_bytes == 4
             ? crude_plan_rows<int32_t, MAX_QT, MASK>(n, Kc, nq, Km, quant,
                                                      nibble, topk, out)
             : crude_plan_rows<uint8_t, MAX_QT, MASK>(n, Kc, nq, Km, quant,
                                                      nibble, topk, out);
}

template <typename CodeT, int MAX_QT, int MASK>
int crude_launch_rows(const void* codes, long codes_q_stride,
                      const void* mask,
                      const void* lut, const void* scale, const void* offset,
                      void* crude, void* out_v, void* out_i, int n, int Kc,
                      int nq, int Km, int m, int quant, int nibble, int topk,
                      int grid_x, void* stream) {
  const ScanTiling t = crude_tiling(Kc * int(sizeof(CodeT)), Km, quant, topk,
                                    MAX_QT);
  if (!scan_args_ok(t, n, nq, topk) || grid_x < 1)
    return int(cudaErrorInvalidValue);
  return int(launch_with_smem(
      crude_instance<CodeT, MASK>(quant, nibble),
      dim3(grid_x, (nq + t.qt - 1) / t.qt), t.smem,
      static_cast<cudaStream_t>(stream), static_cast<const CodeT*>(codes),
      codes_q_stride, mask, lut,
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<float*>(crude), static_cast<float*>(out_v),
      static_cast<int*>(out_i), n, Kc, nq, Km, m, topk, t.qt,
      t.lists_in_smem));
}

template <int MAX_QT, int MASK>
int crude_launch(const void* codes, long codes_q_stride, const void* mask,
                 const void* lut, const void* scale, const void* offset,
                 void* crude, void* out_v, void* out_i, int n, int Kc,
                 int nq, int Km, int m, int quant, int nibble, int code_bytes,
                 int topk, int grid_x, void* stream) {
  if (!code_bytes_ok(code_bytes, nibble)) return int(cudaErrorInvalidValue);
  return code_bytes == 4
             ? crude_launch_rows<int32_t, MAX_QT, MASK>(
                   codes, codes_q_stride, mask, lut, scale, offset, crude,
                   out_v, out_i, n, Kc, nq, Km, m, quant, nibble, topk,
                   grid_x, stream)
             : crude_launch_rows<uint8_t, MAX_QT, MASK>(
                   codes, codes_q_stride, mask, lut, scale, offset, crude,
                   out_v, out_i, n, Kc, nq, Km, m, quant, nibble, topk,
                   grid_x, stream);
}

template <typename CodeT, int MAX_QT>
int refine_plan_rows(int n, int Kc, int nq, int Km, int nibble, int topk,
                     int* out) {
  const ScanTiling t = refine_tiling(Kc * int(sizeof(CodeT)), Km, topk,
                                     MAX_QT);
  if (!scan_args_ok(t, n, nq, topk)) return int(cudaErrorInvalidValue);
  return scan_plan(t.stages == 2 ? refine_instance<CodeT, 2>(nibble)
                                  : refine_instance<CodeT, 1>(nibble),
                   t, n, nq, topk, out);
}

template <int MAX_QT>
int refine_plan(int n, int Kc, int nq, int Km, int nibble, int code_bytes,
                int topk, int* out) {
  if (!code_bytes_ok(code_bytes, nibble)) return int(cudaErrorInvalidValue);
  return code_bytes == 4
             ? refine_plan_rows<int32_t, MAX_QT>(n, Kc, nq, Km, nibble, topk,
                                                 out)
             : refine_plan_rows<uint8_t, MAX_QT>(n, Kc, nq, Km, nibble, topk,
                                                 out);
}

template <typename CodeT, int MAX_QT>
int refine_launch_rows(const void* codes, long codes_q_stride,
                       const void* lut, const void* crude, const void* thr,
                       void* out_v, void* out_i, int n, int Kc, int nq,
                       int Km, int m, int nibble, int topk, int grid_x,
                       void* stream) {
  const ScanTiling t = refine_tiling(Kc * int(sizeof(CodeT)), Km, topk,
                                     MAX_QT);
  if (!scan_args_ok(t, n, nq, topk) || grid_x < 1)
    return int(cudaErrorInvalidValue);
  return int(launch_with_smem(
      t.stages == 2 ? refine_instance<CodeT, 2>(nibble)
                    : refine_instance<CodeT, 1>(nibble),
      dim3(grid_x, (nq + t.qt - 1) / t.qt), t.smem,
      static_cast<cudaStream_t>(stream), static_cast<const CodeT*>(codes),
      codes_q_stride, static_cast<const float*>(lut),
      static_cast<const float*>(crude), static_cast<const float*>(thr),
      static_cast<float*>(out_v), static_cast<int*>(out_i), n, Kc, nq, Km, m,
      topk, t.qt, t.lists_in_smem));
}

template <int MAX_QT>
int refine_launch(const void* codes, long codes_q_stride, const void* lut,
                  const void* crude, const void* thr, void* out_v,
                  void* out_i, int n, int Kc, int nq, int Km, int m,
                  int nibble, int code_bytes, int topk, int grid_x,
                  void* stream) {
  if (!code_bytes_ok(code_bytes, nibble)) return int(cudaErrorInvalidValue);
  return code_bytes == 4
             ? refine_launch_rows<int32_t, MAX_QT>(
                   codes, codes_q_stride, lut, crude, thr, out_v, out_i, n,
                   Kc, nq, Km, m, nibble, topk, grid_x, stream)
             : refine_launch_rows<uint8_t, MAX_QT>(
                   codes, codes_q_stride, lut, crude, thr, out_v, out_i, n,
                   Kc, nq, Km, m, nibble, topk, grid_x, stream);
}

// The survivor selection (refine_scan_kernel<..., SELECT>) over a dense
// (nq, n) crude matrix, flat or slab alike (it reads no code rows): the
// refine tiling with no code bytes and no LUT, lists of cap pairs.
template <int STAGES>
auto select_instance() {
  return refine_scan_kernel<uint8_t, false, STAGES, true>;
}

template <int MAX_QT>
int select_plan(int n, int nq, int cap, int* out) {
  const ScanTiling t = refine_tiling(0, 0, cap, MAX_QT);
  if (!scan_args_ok(t, n, nq, cap)) return int(cudaErrorInvalidValue);
  return t.stages == 2 ? scan_plan(select_instance<2>(), t, n, nq, cap, out)
                       : scan_plan(select_instance<1>(), t, n, nq, cap, out);
}

template <int MAX_QT>
int select_launch(const void* crude, const void* thr, void* out_v,
                  void* out_i, int n, int nq, int cap, int grid_x,
                  void* stream) {
  const ScanTiling t = refine_tiling(0, 0, cap, MAX_QT);
  if (!scan_args_ok(t, n, nq, cap) || grid_x < 1)
    return int(cudaErrorInvalidValue);
  return int(launch_with_smem(
      t.stages == 2 ? select_instance<2>() : select_instance<1>(),
      dim3(grid_x, (nq + t.qt - 1) / t.qt), t.smem,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(nullptr),
      0L, static_cast<const float*>(nullptr),
      static_cast<const float*>(crude), static_cast<const float*>(thr),
      static_cast<float*>(out_v), static_cast<int*>(out_i), n, 0, nq, 0, 0,
      cap, t.qt, t.lists_in_smem));
}

}  // namespace

extern "C" const char* icq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
