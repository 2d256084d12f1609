// Batched two-step search kernels for Hopper (sm_90a): the crude and the
// refine pass of the ICQ two-step search (paper eq. 2), each fused with a
// top-k selection on the two keys (distance, global index), and the
// pairwise merge of sorted candidate lists that all four search kernels
// (these two and the IVF slab pair of ivf_search.cu) end with.
//
// Replaces the TPU kernels of src/repro/kernels/batched_search.py:
//   icq_crude_topk   <- crude_topk_pallas  (_crude_topk_kernel)
//   icq_refine_topk  <- refine_topk_pallas (_refine_topk_kernel)
//
// What bounds them on this card: memory bytes.  At the serving shape
// (64 queries x 1M points, K = 8, m = 256) the crude pass must write the
// dense (nq, n) f32 crude matrix (256 MB) and read 8 MB of codes; the
// refine pass reads the same 264 MB.  Each pass does only nq * n * K
// float adds (about 0.5 GFLOP), far below the card's f32 rate; the LUT
// gathers are ~2 GB of shared-memory reads.
//
// What the design does about it:
//   * The TPU kernels turn the LUT gather into a one-hot x LUT matmul
//     because the MXU is the TPU's only fast unit.  Here a gather from
//     shared memory is cheap, so each block pins the flattened LUTs of a
//     query tile (up to 8 queries, 8 KB each at K = 8, m = 256 f32) in
//     shared memory, stages a chunk of 1024 code rows (1 byte per code,
//     read once per query tile) and sums the K gathered entries per row.
//   * Dense crude values are written row-major, neighbouring threads on
//     neighbouring points, so the 256 MB store is coalesced.
//   * Crude top-k: a running list per block, as the TPU kernel carries
//     its top-k across the n-grid (_merge_topk).  Each block walks its
//     chunks (strided over the points) and keeps, per query of its tile,
//     one ascending (distance, index) list of topk pairs in shared
//     memory; its last pair is the bar tau.  A point enters a candidate
//     buffer only if its key is below tau, compacted with one warp
//     ballot and one shared-memory add per warp.  At the end of each
//     (chunk, query) a non-empty buffer is merged into the list in
//     place: up to 64 candidates by rank (each pair's new position is
//     counted, nothing is sorted), more by a bitonic sort of the buffer
//     and a co-rank merge, back to front.  After the first chunks tau
//     prunes almost every point, so almost no chunk is sorted.  Each block
//     writes one list per query: (nq, gridDim.x, topk) candidates, one
//     wave of blocks (occupancy calculator, icq_crude_plan), but no more
//     than n / topk, so that a block sees topk points on average and the
//     lists stay within nq x n pairs at a large topk.  A topk
//     whose lists do not fit beside the LUTs gets a smaller query tile;
//     past one query, the lists live in the block's own output rows in
//     global memory, so any topk <= n is served.
//   * The refine pass gathers slow entries only for points that pass the
//     margin test crude < thr; the TPU computes them for every point only
//     because its matmul is dense.  The result is the same.  It keeps the
//     bitonic sort of every 1024-point chunk and writes its first
//     w = min(topk, 1024) pairs (the whole chunk when topk >= 1024).
//   * Merge: the sorted lists of each query are merged two by two,
//     keeping the first min(topk, 2w) pairs of each pair of lists (a
//     co-rank search per output pair), until one list of topk remains:
//     icq_merge_lists runs one level per launch, one thread per output
//     pair, while the lists are too many for shared memory; then
//     icq_merge_block runs the remaining levels in one launch, one block
//     per query, in shared memory.  Pads are (+inf, INT_MAX) and sort
//     after every real point, the +inf tail of pruned points included.
//     The order is total (distance, then index), so the result equals
//     one global sort: lowest index first among ties, and the +inf tail
//     carries the lowest pruned indices.
//   * Sum order and rounding match the plain PyTorch version bit for
//     bit: the K entries are added in codebook order starting from 0.0,
//     and every add and multiply is an explicit __fadd_rn / __fmul_rn so
//     nvcc cannot contract the int8 dequant (scale * acc + offset) or
//     full = crude + slow into an FMA.
//   The chunk sort, the merge step, the code-row staging and the LUT
//   sums live in search_common.cuh, shared with the IVF slab kernels
//   (ivf_search.cu).
#include "search_common.cuh"

namespace {

constexpr int kMaxQueryTile = 8;
// candidate buffers up to this size merge by rank (no sort); larger ones
// are bitonic-sorted and merged by co-rank
constexpr int kRankMerge = 64;
// pairs per buffer of the one-block final merge: two buffers of
// (value, index) pairs, 192 KB of shared memory
constexpr long kMergeBlockCap = 12288;
constexpr int kPerThread = kChunk / kThreads;   // a thread's chunk points

// Dynamic shared memory of one scan block: sort keys (the refine pass's
// chunk, the crude pass's candidate buffer), code rows, LUTs of the
// query tile and per-query scalars (scale/offset or threshold); the
// crude pass adds three buffer counts and, when they fit, its qt running
// lists of topk pairs.
__host__ __device__ size_t scan_smem_bytes(int Kc, int qt, int Km,
                                           int lut_esize, int n_scalars) {
  return size_t(kChunk) * (sizeof(float) + sizeof(int)) +
         align16(size_t(kChunk) * Kc) +
         align16(size_t(qt) * Km * lut_esize) +
         align16(size_t(n_scalars) * qt * sizeof(float));
}
__host__ __device__ size_t crude_smem_bytes(int Kc, int qt, int Km,
                                            int lut_esize, int n_scalars,
                                            int topk, bool lists_in_smem) {
  return scan_smem_bytes(Kc, qt, Km, lut_esize, n_scalars) + 16 +
         (lists_in_smem ? size_t(qt) * topk * (sizeof(float) + sizeof(int))
                        : 0);
}

struct ScanSmem {
  float* val;
  int* idx;
  uint8_t* codes;
  unsigned char* lut;
  float* scalars;
  unsigned char* tail;   // the crude pass's counts and lists
};

__device__ ScanSmem carve(unsigned char* base, int Kc, int qt, int Km,
                          int lut_esize, int n_scalars) {
  ScanSmem s;
  s.val = reinterpret_cast<float*>(base);
  s.idx = reinterpret_cast<int*>(base + kChunk * sizeof(float));
  size_t off = size_t(kChunk) * (sizeof(float) + sizeof(int));
  s.codes = base + off;
  off += align16(size_t(kChunk) * Kc);
  s.lut = base + off;
  off += align16(size_t(qt) * Km * lut_esize);
  s.scalars = reinterpret_cast<float*>(base + off);
  off += align16(size_t(n_scalars) * qt * sizeof(float));
  s.tail = base + off;
  return s;
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

// Merge a small unsorted candidate buffer (c <= blockDim.x pairs, every
// key below the list's last) into the ascending list, in place, without
// sorting it: list pair i moves to i + #(candidates below it), candidate
// b to #(list pairs below it) + #(candidates below it).  Keys are
// distinct (pads only repeat in the list, and keep their order), so the
// positions are a permutation.  Candidate positions are taken from the
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

// Phase 1.  grid (x: blocks strided over point chunks, y: query tiles of
// qt).  crude may be null (want_crude = false): no dense matrix is
// written.  out_v / out_i (nq, gridDim.x, topk): block x's list of query
// q is row (q * gridDim.x + x); with lists_in_smem = false that row is
// also the running list.
template <bool QUANT, bool NIBBLE>
__global__ void __launch_bounds__(kThreads)
crude_scan_kernel(const uint8_t* __restrict__ codes,
                  const void* __restrict__ lut_g,
                  const float* __restrict__ scale_g,
                  const float* __restrict__ offset_g,
                  float* __restrict__ crude, float* out_v, int* out_i,
                  int n, int Kc, int nq, int Km, int m, int topk, int qt,
                  bool lists_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanSmem s = carve(smem, Kc, qt, Km, QUANT ? 1 : 4, QUANT ? 2 : 0);
  int* count = reinterpret_cast<int*>(s.tail);   // 3 rotating counts
  float* slv = reinterpret_cast<float*>(s.tail + 16);
  int* sli = reinterpret_cast<int*>(slv + size_t(qt) * topk);
  const int q0 = blockIdx.y * qt;
  const int nql = min(qt, nq - q0);              // queries of this tile
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31;
  auto list_v = [&](int q) {
    return lists_in_smem
               ? slv + size_t(q) * topk
               : out_v + (long(q0 + q) * gridDim.x + blockIdx.x) * topk;
  };
  auto list_i = [&](int q) {
    return lists_in_smem
               ? sli + size_t(q) * topk
               : out_i + (long(q0 + q) * gridDim.x + blockIdx.x) * topk;
  };
  for (int i = threadIdx.x; i < qt * Km; i += blockDim.x) {
    const int q = q0 + i / Km;
    const long src = long(q) * Km + i % Km;
    if (QUANT)
      reinterpret_cast<int8_t*>(s.lut)[i] =
          q < nq ? static_cast<const int8_t*>(lut_g)[src] : int8_t(0);
    else
      reinterpret_cast<float*>(s.lut)[i] =
          q < nq ? static_cast<const float*>(lut_g)[src] : 0.0f;
  }
  if (QUANT) {
    for (int i = threadIdx.x; i < qt; i += blockDim.x) {
      const int q = q0 + i;
      s.scalars[i] = q < nq ? scale_g[q] : 0.0f;
      s.scalars[qt + i] = q < nq ? offset_g[q] : 0.0f;
    }
  }
  for (int q = 0; q < nql; ++q) {   // empty lists: every pair a pad
    float* lv = list_v(q);
    int* li = list_i(q);
    for (int t = threadIdx.x; t < topk; t += blockDim.x) {
      lv[t] = CUDART_INF_F;
      li[t] = INT_MAX;
    }
  }
  if (threadIdx.x < 3) count[threadIdx.x] = 0;
  int round = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const long base = long(chunk) * kChunk;
    __syncthreads();  // the previous chunk's readers are done
    load_codes(s.codes, codes, base, n, Kc);
    __syncthreads();
    for (int q = 0; q < nql; ++q, ++round) {
      const int qg = q0 + q;
      float* lv = list_v(q);
      int* li = list_i(q);
      const float tau_v = lv[topk - 1];
      const int tau_i = li[topk - 1];
      int* cnt = count + round % 3;
      // the count read two rounds ago: every thread has passed the
      // barrier after that read
      if (threadIdx.x == 0) count[(round + 1) % 3] = 0;
      // the thread's kPerThread points first (independent gather
      // chains), then one shared-memory add per warp for all of them
      float dv[kPerThread];
      bool enter[kPerThread];
      unsigned mask[kPerThread];
      int total = 0;
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int p = threadIdx.x + r * kThreads;
        const long gi = base + p;
        float d = CUDART_INF_F;
        if (gi < n) {
          const uint8_t* row = s.codes + p * Kc;
          if (QUANT) {
            const int acc = row_sum_i8<NIBBLE>(
                reinterpret_cast<const int8_t*>(s.lut) + q * Km, row, Kc, m);
            d = dequant(s.scalars[q], acc, s.scalars[qt + q]);
          } else {
            d = row_sum_f32<NIBBLE>(
                reinterpret_cast<const float*>(s.lut) + q * Km, row, Kc, m);
          }
          if (crude != nullptr) crude[long(qg) * n + gi] = d;
        }
        dv[r] = d;
        enter[r] = gi < n && key_less(d, int(gi), tau_v, tau_i);
      }
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        mask[r] = __ballot_sync(0xffffffffu, enter[r]);
        total += __popc(mask[r]);
      }
      int at = 0;
      if (lane == 0 && total != 0) at = atomicAdd(cnt, total);
      at = __shfl_sync(0xffffffffu, at, 0);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        if (enter[r]) {
          const int pos = at + __popc(mask[r] & ((1u << lane) - 1u));
          s.val[pos] = dv[r];
          s.idx[pos] = int(base) + threadIdx.x + r * kThreads;
        }
        at += __popc(mask[r]);
      }
      __syncthreads();
      const int c = *cnt;
      if (c > 0 && c <= kRankMerge) {   // uniform: one count for all
        rank_into_list(lv, li, topk, s.val, s.idx, c);
      } else if (c > 0) {
        int P = 1;
        while (P < c) P <<= 1;
        for (int t = c + threadIdx.x; t < P; t += blockDim.x) {
          s.val[t] = CUDART_INF_F;
          s.idx[t] = INT_MAX;
        }
        __syncthreads();
        bitonic_sort_n(s.val, s.idx, P);
        merge_into_list(lv, li, topk, s.val, s.idx, c);
      }
    }
  }
  if (lists_in_smem) {
    __syncthreads();
    for (int q = 0; q < nql; ++q) {
      const long out = (long(q0 + q) * gridDim.x + blockIdx.x) * topk;
      for (int t = threadIdx.x; t < topk; t += blockDim.x) {
        out_v[out + t] = slv[size_t(q) * topk + t];
        out_i[out + t] = sli[size_t(q) * topk + t];
      }
    }
  }
}

// Phase 2: the margin test crude < thr, the slow-masked f32 LUT sum for
// survivors, full = crude + slow; pruned points rank +inf.  Each chunk's
// first w = min(topk, kChunk) pairs become its list.
template <bool NIBBLE>
__global__ void __launch_bounds__(kThreads)
refine_scan_kernel(const uint8_t* __restrict__ codes,
                   const float* __restrict__ lut_g,
                   const float* __restrict__ crude,
                   const float* __restrict__ thr_g,
                   float* __restrict__ cand_v, int* __restrict__ cand_i,
                   int n, int Kc, int nq, int Km, int m, int w, int qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanSmem s = carve(smem, Kc, qt, Km, 4, 1);
  float* lut = reinterpret_cast<float*>(s.lut);
  const int q0 = blockIdx.y * qt;
  const int nchunks = (n + kChunk - 1) / kChunk;
  for (int i = threadIdx.x; i < qt * Km; i += blockDim.x) {
    const int q = q0 + i / Km;
    lut[i] = q < nq ? lut_g[long(q) * Km + i % Km] : 0.0f;
  }
  for (int i = threadIdx.x; i < qt; i += blockDim.x)
    s.scalars[i] = q0 + i < nq ? thr_g[q0 + i] : 0.0f;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const long base = long(chunk) * kChunk;
    __syncthreads();
    load_codes(s.codes, codes, base, n, Kc);
    __syncthreads();
    for (int q = 0; q < qt && q0 + q < nq; ++q) {
      const int qg = q0 + q;
      const float thr = s.scalars[q];
      for (int p = threadIdx.x; p < kChunk; p += blockDim.x) {
        const long gi = base + p;
        float d = CUDART_INF_F;
        int id = INT_MAX;
        if (gi < n) {
          const float c = crude[long(qg) * n + gi];
          if (c < thr)
            d = __fadd_rn(c, row_sum_f32<NIBBLE>(lut + q * Km,
                                                 s.codes + p * Kc, Kc, m));
          id = int(gi);
        }
        s.val[p] = d;
        s.idx[p] = id;
      }
      __syncthreads();
      bitonic_sort(s.val, s.idx);
      write_list(s.val, s.idx, cand_v, cand_i, qg, nchunks, chunk, w);
      __syncthreads();
    }
  }
}

// One merge level, one thread per output pair: lists 2j and 2j + 1 of
// each query's L lists of w pairs (in (nq, L, w)) -> list j of wo =
// min(topk, 2w) pairs (out (nq, ceil(L / 2), wo)); an unpaired last
// list is copied and padded with (+inf, INT_MAX).
__global__ void __launch_bounds__(kThreads)
merge_lists_kernel(const float* __restrict__ in_v,
                   const int* __restrict__ in_i, float* __restrict__ out_v,
                   int* __restrict__ out_i, int nq, int L, int w, int wo) {
  const int Lo = (L + 1) / 2;
  const long e = long(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= long(nq) * Lo * wo) return;
  const int t = int(e % wo);
  const long pair = e / wo;                  // q * Lo + j
  const int q = int(pair / Lo), j = int(pair % Lo);
  const long a = (long(q) * L + 2 * j) * w;
  const int wb = 2 * j + 1 < L ? w : 0;
  float v = CUDART_INF_F;
  int id = INT_MAX;
  if (t < w + wb)
    merged_at(in_v + a, in_i + a, w, in_v + a + w, in_i + a + w, wb, t, v,
              id);
  out_v[e] = v;
  out_i[e] = id;
}

// The last merge levels of one query in one block: its L lists of w
// pairs (in (nq, L, w)) are loaded into shared memory and merged two by
// two there, level after level (two buffers of cap pairs), down to its
// topk (out (nq, topk)).  grid (nq).
__global__ void __launch_bounds__(kThreads)
merge_block_kernel(const float* __restrict__ in_v,
                   const int* __restrict__ in_i, float* __restrict__ out_v,
                   int* __restrict__ out_i, int L, int w, int topk,
                   int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* av = reinterpret_cast<float*>(smem);
  int* ai = reinterpret_cast<int*>(av + cap);
  float* bv = reinterpret_cast<float*>(ai + cap);
  int* bi = reinterpret_cast<int*>(bv + cap);
  const long base = long(blockIdx.x) * L * w;
  for (int e = threadIdx.x; e < L * w; e += blockDim.x) {
    av[e] = in_v[base + e];
    ai[e] = in_i[base + e];
  }
  __syncthreads();
  while (L > 1) {
    const int wo = min(topk, 2 * w), Lo = (L + 1) / 2;
    for (int e = threadIdx.x; e < Lo * wo; e += blockDim.x) {
      const int j = e / wo, t = e % wo;
      const int a = 2 * j * w, wb = 2 * j + 1 < L ? w : 0;
      float v = CUDART_INF_F;
      int id = INT_MAX;
      if (t < w + wb)
        merged_at(av + a, ai + a, w, av + a + w, ai + a + w, wb, t, v, id);
      bv[e] = v;
      bi[e] = id;
    }
    __syncthreads();
    float* tv = av;
    av = bv;
    bv = tv;
    int* ti = ai;
    ai = bi;
    bi = ti;
    L = Lo;
    w = wo;
  }
  for (int t = threadIdx.x; t < topk; t += blockDim.x) {
    out_v[long(blockIdx.x) * topk + t] = av[t];
    out_i[long(blockIdx.x) * topk + t] = ai[t];
  }
}

// Pairs the block merge needs per buffer for L lists of w: the largest
// level, padded unpaired lists included.
long merge_block_pairs(int L, int w, int topk) {
  long most = long(L) * w;
  while (L > 1) {
    w = min(topk, 2 * w);
    L = (L + 1) / 2;
    most = max(most, long(L) * w);
  }
  return most;
}

// Largest query tile (<= kMaxQueryTile) whose shared memory fits, or 0.
int pick_query_tile(int Kc, int Km, int lut_esize, int n_scalars) {
  for (int qt = kMaxQueryTile; qt >= 1; qt >>= 1)
    if (scan_smem_bytes(Kc, qt, Km, lut_esize, n_scalars) <= kMaxSmem)
      return qt;
  return 0;
}

// The crude pass's shape: the largest query tile whose running lists fit
// in shared memory beside the LUTs; if none does, the largest tile
// without them (lists in global memory).  qt = 0: not even that fits.
struct CrudeTiling {
  int qt;
  bool lists_in_smem;
  size_t smem;
};

CrudeTiling crude_tiling(int Kc, int Km, int quant, int topk) {
  const int esize = quant ? 1 : 4, ns = quant ? 2 : 0;
  CrudeTiling t{0, true, 0};
  for (int lists = 1; lists >= 0; --lists) {
    for (int qt = kMaxQueryTile; qt >= 1; qt >>= 1) {
      const size_t b = crude_smem_bytes(Kc, qt, Km, esize, ns, topk, lists);
      if (b <= kMaxSmem) return CrudeTiling{qt, lists == 1, b};
    }
  }
  return t;
}

template <bool QUANT, bool NIBBLE>
cudaError_t crude_occupancy(size_t smem, int* per_sm) {
  auto kernel = crude_scan_kernel<QUANT, NIBBLE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

// Enough blocks to give every SM a few; each block walks its chunks.
dim3 scan_grid(int n, int nq, int qt, int num_sms) {
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int qtiles = (nq + qt - 1) / qt;
  const int want = (4 * num_sms + qtiles - 1) / qtiles;
  return dim3(max(1, min(nchunks, want)), qtiles);
}

}  // namespace

extern "C" {

// The crude pass's block count along the points, for the caller to size
// its candidate lists (nq, out[0], topk): one wave of blocks (as many as
// fit on all SMs at this shared memory, divided among the query tiles),
// at most one per 1024-point chunk and one per topk points (the lists
// then hold at most nq x n pairs).  Returns cudaErrorInvalidValue for
// another shape.
int icq_crude_plan(int n, int Kc, int nq, int Km, int quant, int nibble,
                   int topk, int* out) {
  if (n < 1 || nq < 1 || topk < 1 || topk > n)
    return int(cudaErrorInvalidValue);
  const CrudeTiling t = crude_tiling(Kc, Km, quant, topk);
  if (t.qt == 0) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    if (quant && nibble)
      e = crude_occupancy<true, true>(t.smem, &per_sm);
    else if (quant)
      e = crude_occupancy<true, false>(t.smem, &per_sm);
    else if (nibble)
      e = crude_occupancy<false, true>(t.smem, &per_sm);
    else
      e = crude_occupancy<false, false>(t.smem, &per_sm);
  }
  if (e != cudaSuccess) return int(e);
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int qtiles = (nq + t.qt - 1) / t.qt;
  const int wave = max(1, per_sm) * sms / qtiles;
  out[0] = max(1, min(min(nchunks, n / topk), wave));
  return int(cudaSuccess);
}

// Phase 1.  codes (n, Kc) uint8; lut (nq, Km) f32, or int8 with scale /
// offset (nq,) f32; crude (nq, n) f32 or null; out_v / out_i (nq, grid,
// topk), grid from icq_crude_plan.  Returns cudaGetLastError().
int icq_crude_topk(const void* codes, const void* lut, const void* scale,
                   const void* offset, void* crude, void* out_v,
                   void* out_i, int n, int Kc, int nq, int Km, int m,
                   int quant, int nibble, int topk, int grid_x,
                   void* stream) {
  const CrudeTiling t = crude_tiling(Kc, Km, quant, topk);
  if (t.qt == 0 || topk < 1 || topk > n || n < 1 || nq < 1 || grid_x < 1)
    return int(cudaErrorInvalidValue);
  const dim3 grid(grid_x, (nq + t.qt - 1) / t.qt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  float* cr = static_cast<float*>(crude);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  const int qt = t.qt;
  const bool ls = t.lists_in_smem;
  cudaError_t e;
  if (quant && nibble)
    e = launch_with_smem(crude_scan_kernel<true, true>, grid, t.smem, s, c,
                         lut, sc, of, cr, ov, oi, n, Kc, nq, Km, m, topk, qt,
                         ls);
  else if (quant)
    e = launch_with_smem(crude_scan_kernel<true, false>, grid, t.smem, s, c,
                         lut, sc, of, cr, ov, oi, n, Kc, nq, Km, m, topk, qt,
                         ls);
  else if (nibble)
    e = launch_with_smem(crude_scan_kernel<false, true>, grid, t.smem, s, c,
                         lut, sc, of, cr, ov, oi, n, Kc, nq, Km, m, topk, qt,
                         ls);
  else
    e = launch_with_smem(crude_scan_kernel<false, false>, grid, t.smem, s, c,
                         lut, sc, of, cr, ov, oi, n, Kc, nq, Km, m, topk, qt,
                         ls);
  return int(e);
}

// Phase 2.  codes as in phase 1; lut (nq, Km) f32 slow-masked; crude
// (nq, n) f32; thr (nq,) f32; cand_v / cand_i (nq, ceil(n / chunk),
// min(topk, chunk)).
int icq_refine_topk(const void* codes, const void* lut, const void* crude,
                    const void* thr, void* cand_v, void* cand_i, int n,
                    int Kc, int nq, int Km, int m, int nibble, int topk,
                    int num_sms, void* stream) {
  const int qt = pick_query_tile(Kc, Km, 4, 1);
  if (qt == 0 || topk < 1 || topk > n || n < 1 || nq < 1)
    return int(cudaErrorInvalidValue);
  const int w = min(topk, kChunk);
  const size_t smem = scan_smem_bytes(Kc, qt, Km, 4, 1);
  const dim3 grid = scan_grid(n, nq, qt, num_sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* l = static_cast<const float*>(lut);
  const float* cr = static_cast<const float*>(crude);
  const float* t = static_cast<const float*>(thr);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  cudaError_t e;
  if (nibble)
    e = launch_with_smem(refine_scan_kernel<true>, grid, smem, s, c, l, cr,
                         t, cv, ci, n, Kc, nq, Km, m, w, qt);
  else
    e = launch_with_smem(refine_scan_kernel<false>, grid, smem, s, c, l, cr,
                         t, cv, ci, n, Kc, nq, Km, m, w, qt);
  return int(e);
}

// One merge level: in (nq, L, w) sorted lists -> out (nq, ceil(L / 2),
// wo) with wo = min(topk, 2 w).
int icq_merge_lists(const void* in_v, const void* in_i, void* out_v,
                    void* out_i, int nq, int L, int w, int topk,
                    void* stream) {
  if (nq < 1 || L < 2 || w < 1 || topk < w) return int(cudaErrorInvalidValue);
  const int wo = min(topk, 2 * w);
  const long total = long(nq) * ((L + 1) / 2) * wo;
  merge_lists_kernel<<<unsigned((total + kThreads - 1) / kThreads), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_v), static_cast<const int*>(in_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), nq, L, w, wo);
  return int(cudaGetLastError());
}

// The last merge levels in one launch: in (nq, L, w) sorted lists ->
// out (nq, topk), one block per query; returns cudaErrorInvalidValue
// unless icq_merge_block_fits(L, w, topk).
int icq_merge_block(const void* in_v, const void* in_i, void* out_v,
                    void* out_i, int nq, int L, int w, int topk,
                    void* stream) {
  if (nq < 1 || nq > 65535 || L < 1 || w < 1 || topk < w ||
      long(L) * w < topk)
    return int(cudaErrorInvalidValue);
  const long cap = merge_block_pairs(L, w, topk);
  if (cap > kMergeBlockCap) return int(cudaErrorInvalidValue);
  return int(launch_with_smem(
      merge_block_kernel, dim3(nq), size_t(cap) * 4 * sizeof(float),
      static_cast<cudaStream_t>(stream), static_cast<const float*>(in_v),
      static_cast<const int*>(in_i), static_cast<float*>(out_v),
      static_cast<int*>(out_i), L, w, topk, int(cap)));
}

// 1 if icq_merge_block takes L lists of w (its levels fit one block's
// shared memory), else 0: the caller runs icq_merge_lists levels until
// they do.
int icq_merge_block_fits(int L, int w, int topk) {
  return merge_block_pairs(L, w, topk) <= kMergeBlockCap;
}

}  // extern "C"
