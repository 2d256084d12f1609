// Batched two-step search kernels for Hopper (sm_90a): the crude and the
// refine pass of the ICQ two-step search (paper eq. 2), each fused with a
// top-k selection on the two keys (distance, global index), and the
// pairwise merge of sorted candidate lists that all four search kernels
// (these two and the IVF slab pair of ivf_search.cu) end with.
//
// Replaces the TPU kernels of src/repro/kernels/batched_search.py:
//   icq_crude_topk   <- crude_topk_pallas  (_crude_topk_kernel); with a
//                       row predicate, the jnp engine's filtered crude
//                       (src/repro/kernels/stages.py CrudeStage, pred=)
//   icq_refine_topk  <- refine_topk_pallas (_refine_topk_kernel)
//   icq_select_topk  <- the jnp engine's refine_cap survivor selection
//                       (src/repro/index/flat.py _flat_refine_phase,
//                       src/repro/index/ivf.py; XLA on the TPU): an
//                       instance of the refine pass
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
//     or 4 for codes wider than a byte (m > 256: int32 rows, as the
//     index stores them; those instances compile on their own), read
//     once per query tile) and sums the K gathered entries per row.
//   * Dense crude values are written row-major, neighbouring threads on
//     neighbouring points, so the 256 MB store is coalesced.
//   * Top-k: a running list per block, as the TPU kernels carry their
//     top-k across the n-grid (_merge_topk).  Each block walks its
//     chunks (strided over the points, in ascending order) and keeps,
//     per query of its tile, one ascending (distance, index) list of
//     topk pairs in shared memory; its last pair is the bar tau.  A point
//     enters a candidate buffer only if its key is below tau, compacted
//     with one warp ballot and one shared-memory add per warp.  A
//     non-empty buffer is merged into the list in place: up to 64
//     candidates by rank (each pair's new position is counted, nothing
//     is sorted), more by a bitonic sort of the buffer and a co-rank
//     merge, back to front.  The crude pass merges at the end of each
//     (chunk, query); after the first chunks tau prunes almost every
//     point, so almost no chunk is sorted.  The IVF crude pass launches
//     this same kernel over each query's own slab (ivf_search.cu).
//     Each block writes one list per query: (nq, gridDim.x, topk)
//     candidates, one wave of blocks (occupancy calculator,
//     icq_crude_plan / icq_refine_plan), but no more than n / topk, so
//     that a block sees topk points on average and the lists stay within
//     nq x n pairs at a large topk.  A topk whose lists do not fit beside
//     the LUTs gets a smaller query tile; past one query, the lists live
//     in the block's own output rows in global memory, so any topk <= n
//     is served.
//   * The refine pass gathers slow entries only for points that pass the
//     margin test crude < thr; the TPU computes them for every point only
//     because its matmul is dense.  The result is the same.  Pruned
//     points rank (+inf, index): while a block's list still holds pads
//     they enter it, lowest index first (at most topk of a chunk), so a
//     query with fewer than topk survivors ends in its lowest pruned
//     indices, as in one global sort.  At the served threshold about
//     0.3% of the points survive, a few per chunk and query, so the
//     refine pass keeps each query's candidates pending across chunks
//     and merges when the list still holds pads, when the buffer would
//     overflow, and at the end: a round is a margin test, a few slow
//     sums and one barrier.  Its byte bound is the dense crude read; the
//     next chunk's crude values and code rows are staged with cp.async
//     while the current one is worked on (after it, for codes too wide
//     for two staging buffers).  The IVF refine pass launches this same
//     kernel over each query's own slab (ivf_search.cu).
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
//   * filter= (the jnp engine's row predicate): the crude kernel's
//     kRowPred instance reads the (n,) filter as one byte a row, once
//     per chunk for the whole query tile, and scores a filtered row +inf
//     without summing it; +inf rows enter a list only while it holds
//     pads, lowest index first, so the candidate list is the two-key top-k
//     of the masked crude row, its +inf slots the lowest filtered rows,
//     which the jnp engine's threshold bootstrap reads.
//   * refine_cap: the refine kernel's SELECT instance keeps per query the
//     cap best-crude survivors of the margin test (no code rows, no slow
//     sum: it reads the crude matrix and writes lists of cap pairs, with
//     the refine pass's tiling and merge); their re-rank by one full-table
//     f32 sum is the IVF refine kernel over the survivors' gathered code
//     rows, every codebook as its "slow" table and a zero crude operand
//     (kernels/stages.py CappedStage).
//   * Sum order and rounding match the plain PyTorch version bit for
//     bit: the K entries are added in codebook order starting from 0.0,
//     and every add and multiply is an explicit __fadd_rn / __fmul_rn so
//     nvcc cannot contract the int8 dequant (scale * acc + offset) or
//     full = crude + slow into an FMA.
//   The running list, the scan block's layout, tiling and plan, the
//   crude and the refine kernel, the sort, the merge step, the code-row
//   staging and the LUT sums live in search_common.cuh, shared with the
//   IVF slab passes (ivf_search.cu); this file launches them at a query
//   tile of up to 8 (crude) and 2 (refine) queries.
#include "search_common.cuh"

namespace {

constexpr int kMaxQueryTile = 8;
// the refine pass's largest query tile: its rounds are short chains of
// shared-memory steps and barriers, so it wants resident blocks more
// than LUT reuse (2 queries: ~66 KB of shared memory, 3 blocks an SM; 4
// queries halve the blocks and ran slower on the H100)
constexpr int kRefineQueryTile = 2;
// pairs per buffer of the one-block final merge: two buffers of
// (value, index) pairs, 192 KB of shared memory
constexpr long kMergeBlockCap = 12288;

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

}  // namespace

extern "C" {

// The crude pass's block count along the points (scan_plan), of the
// instance with a row predicate (pred 1) or without (0).  Returns
// cudaErrorInvalidValue for another shape.
int icq_crude_plan(int n, int Kc, int nq, int Km, int quant, int nibble,
                   int code_bytes, int topk, int pred, int* out) {
  return pred ? crude_plan<kMaxQueryTile, kRowPred>(n, Kc, nq, Km, quant,
                                                    nibble, code_bytes, topk,
                                                    out)
              : crude_plan<kMaxQueryTile, kNoMask>(n, Kc, nq, Km, quant,
                                                   nibble, code_bytes, topk,
                                                   out);
}

// The refine pass's block count along the points (scan_plan).
int icq_refine_plan(int n, int Kc, int nq, int Km, int nibble,
                    int code_bytes, int topk, int* out) {
  return refine_plan<kRefineQueryTile>(n, Kc, nq, Km, nibble, code_bytes,
                                       topk, out);
}

// Phase 1.  codes (n, Kc) of code_bytes a code: uint8 (1) or int32 (4,
// no nibbles); pred (n,) uint8 (0 = filtered: +inf) or null (no
// filter); lut (nq, Km) f32, or int8 with scale / offset (nq,) f32;
// crude (nq, n) f32 or null; out_v / out_i (nq, grid, topk), grid from
// icq_crude_plan with pred set alike.  Returns cudaGetLastError().
int icq_crude_topk(const void* codes, const void* pred, const void* lut,
                   const void* scale, const void* offset, void* crude,
                   void* out_v, void* out_i, int n, int Kc, int nq, int Km,
                   int m, int quant, int nibble, int code_bytes, int topk,
                   int grid_x, void* stream) {
  if (pred != nullptr)
    return crude_launch<kMaxQueryTile, kRowPred>(
        codes, 0, pred, lut, scale, offset, crude, out_v, out_i, n, Kc, nq,
        Km, m, quant, nibble, code_bytes, topk, grid_x, stream);
  return crude_launch<kMaxQueryTile, kNoMask>(
      codes, 0, nullptr, lut, scale, offset, crude, out_v, out_i, n, Kc, nq,
      Km, m, quant, nibble, code_bytes, topk, grid_x, stream);
}

// Phase 2.  codes as in phase 1; lut (nq, Km) f32 slow-masked; crude
// (nq, n) f32; thr (nq,) f32; out_v / out_i (nq, grid, topk), grid from
// icq_refine_plan.
int icq_refine_topk(const void* codes, const void* lut, const void* crude,
                    const void* thr, void* out_v, void* out_i, int n,
                    int Kc, int nq, int Km, int m, int nibble,
                    int code_bytes, int topk, int grid_x, void* stream) {
  return refine_launch<kRefineQueryTile>(codes, 0, lut, crude, thr, out_v,
                                         out_i, n, Kc, nq, Km, m, nibble,
                                         code_bytes, topk, grid_x, stream);
}

// The survivor selection's block count along the points (scan_plan).
int icq_select_plan(int n, int nq, int cap, int* out) {
  return select_plan<kRefineQueryTile>(n, nq, cap, out);
}

// The refine_cap selection: crude (nq, n) f32 (a flat crude matrix or a
// slab's), thr (nq,) f32; out_v / out_i (nq, grid, cap): per query the
// cap best-crude rows with crude < thr, pruned rows (+inf, index) after
// them; grid from icq_select_plan.
int icq_select_topk(const void* crude, const void* thr, void* out_v,
                    void* out_i, int n, int nq, int cap, int grid_x,
                    void* stream) {
  return select_launch<kRefineQueryTile>(crude, thr, out_v, out_i, n, nq,
                                         cap, grid_x, stream);
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
