// IVF candidate-slab search kernels for Hopper (sm_90a): the crude and
// the refine pass of the two-step search over each query's own gathered
// candidate slab, each fused with a top-k of slab positions on the two
// keys (distance, slab position).
//
// Replaces the TPU kernels of src/repro/kernels/batched_search.py:
//   icq_ivf_crude_topk   <- ivf_crude_topk_pallas  (_ivf_crude_kernel,
//                                                   _slab_distances)
//   icq_ivf_refine_topk  <- ivf_refine_topk_pallas (_ivf_refine_kernel)
//
// What bounds them on this card: memory bytes.  At the serving shape
// (64 queries, 8 of 1024 lists probed over 1M points, K = 8, m = 256)
// a query's slab holds nc ~ 8 * max_len rows; the crude pass reads the
// slab's codes (Kc bytes a row) and ids (4 bytes) and writes the dense
// crude row (4 bytes), the refine pass reads codes and crude.  Each row
// costs K float adds, far below the card's f32 rate.
//
// What the design does about it:
//   * Every query has its own slab, so there is no reuse of code rows
//     across queries (the flat kernels' query tile has nothing to
//     share).  One block serves one query: it pins that query's
//     flattened LUT in shared memory (8 KB at K = 8, m = 256 f32),
//     stages 1024 slab rows at a time with 16-byte loads and sums the K
//     gathered entries per row.  The TPU kernel's one-hot x LUT batched
//     matvec exists for the MXU and does not carry over.
//   * Invalid slab columns (id < 0) are +inf in the dense crude output,
//     so the refine pass inherits the mask through crude < thr.
//   * Crude top-k: the chunk sort of search_common.cuh keeps the first
//     w = min(topk, 1024) (value, position) pairs of each chunk, so a
//     list holds its whole chunk when topk >= 1024.
//   * Refine: the flat refine kernel itself (refine_scan_kernel in
//     search_common.cuh), launched with a query tile of one and each
//     query's own slab as its code rows; a row's index is its slab
//     position.  A block walks its chunks of the slab in ascending
//     order, admits only points below its list's bar into a pending
//     buffer and merges it when the list still holds pads, when it
//     would overflow, and at the end; the next chunk's code rows and
//     crude values are staged with cp.async meanwhile.  A few percent of
//     the valid columns survive on the served cells, so after its first
//     chunk a round is a margin test, a few slow sums and a barrier.
//     Blocks per query: one wave (occupancy calculator), at most one per
//     chunk and one per topk columns (icq_ivf_refine_plan), so a query
//     has a few lists to merge.
//   * Both write sorted lists per query that the flat kernels' merge
//     launches (icq_merge_lists levels, then icq_merge_block, in
//     batched_search.cu) merge two by two.  The order is total, so the
//     result equals one sort of the whole slab row: lowest position
//     first among ties, and the +inf tail carries the lowest +inf
//     positions.  Pads past the slab are (+inf, INT_MAX) and sort after
//     it.  Any topk <= nc is served.
//   * Sum order and rounding equal the plain PyTorch version bit for bit
//     (codebook order from 0.0, __fadd_rn / __fmul_rn), as in the flat
//     kernels.
#include "search_common.cuh"

namespace {

// Dynamic shared memory of one slab crude block: the chunk's sort keys,
// its code rows and the query's flattened LUT.
__host__ __device__ size_t slab_smem_bytes(int Kc, int Km, int lut_esize) {
  return size_t(kChunk) * (sizeof(float) + sizeof(int)) +
         align16(size_t(kChunk) * Kc) + align16(size_t(Km) * lut_esize);
}

struct SlabSmem {
  float* val;
  int* idx;
  uint8_t* codes;
  unsigned char* lut;
};

__device__ SlabSmem carve_slab(unsigned char* base, int Kc, int Km,
                               int lut_esize) {
  SlabSmem s;
  s.val = reinterpret_cast<float*>(base);
  s.idx = reinterpret_cast<int*>(base + kChunk * sizeof(float));
  size_t off = size_t(kChunk) * (sizeof(float) + sizeof(int));
  s.codes = base + off;
  off += align16(size_t(kChunk) * Kc);
  s.lut = base + off;
  return s;
}

// Phase 1.  grid (x: strided over the slab's chunks, y: queries).
template <bool QUANT, bool NIBBLE>
__global__ void __launch_bounds__(kThreads)
slab_crude_kernel(const uint8_t* __restrict__ codes,
                  const int* __restrict__ ids,
                  const void* __restrict__ lut_g,
                  const float* __restrict__ scale_g,
                  const float* __restrict__ offset_g,
                  float* __restrict__ crude, float* __restrict__ cand_v,
                  int* __restrict__ cand_i, int nc, int Kc, int Km, int m,
                  int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SlabSmem s = carve_slab(smem, Kc, Km, QUANT ? 1 : 4);
  const int q = blockIdx.y;
  const long row0 = long(q) * nc;
  const int nchunks = (nc + kChunk - 1) / kChunk;
  for (int i = threadIdx.x; i < Km; i += blockDim.x) {
    if (QUANT)
      reinterpret_cast<int8_t*>(s.lut)[i] =
          static_cast<const int8_t*>(lut_g)[long(q) * Km + i];
    else
      reinterpret_cast<float*>(s.lut)[i] =
          static_cast<const float*>(lut_g)[long(q) * Km + i];
  }
  const float scale = QUANT ? scale_g[q] : 0.0f;
  const float offset = QUANT ? offset_g[q] : 0.0f;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const long base = long(chunk) * kChunk;
    __syncthreads();  // the previous chunk's readers are done
    load_codes(s.codes, codes + row0 * Kc, base, nc, Kc);
    __syncthreads();
    for (int p = threadIdx.x; p < kChunk; p += blockDim.x) {
      const long gi = base + p;
      float d = CUDART_INF_F;
      int pos = INT_MAX;
      if (gi < nc) {
        if (ids[row0 + gi] >= 0) {
          const uint8_t* row = s.codes + p * Kc;
          if (QUANT)
            d = dequant(scale,
                        row_sum_i8<NIBBLE>(
                            reinterpret_cast<const int8_t*>(s.lut), row, Kc,
                            m),
                        offset);
          else
            d = row_sum_f32<NIBBLE>(reinterpret_cast<const float*>(s.lut),
                                    row, Kc, m);
        }
        crude[row0 + gi] = d;
        pos = int(gi);
      }
      s.val[p] = d;
      s.idx[p] = pos;
    }
    __syncthreads();
    bitonic_sort(s.val, s.idx);
    write_list(s.val, s.idx, cand_v, cand_i, q, nchunks, chunk, w);
  }
}

// One query per grid row; enough chunk blocks per query to give every SM
// a few blocks in all.
dim3 slab_grid(int nc, int nq, int num_sms) {
  const int nchunks = (nc + kChunk - 1) / kChunk;
  const int want = (4 * num_sms + nq - 1) / nq;
  return dim3(max(1, min(nchunks, want)), nq);
}

bool slab_args_ok(int nq, int nc, int topk, size_t smem) {
  return nq >= 1 && nq <= 65535 && nc >= 1 && topk >= 1 && topk <= nc &&
         smem <= kMaxSmem;
}

}  // namespace

extern "C" {

// Phase 1.  codes (nq, nc, Kc) uint8; ids (nq, nc) int32, -1 = invalid;
// lut (nq, Km) f32, or int8 with scale / offset (nq,) f32; crude
// (nq, nc) f32; cand_v / cand_i (nq, ceil(nc / chunk), min(topk,
// chunk)).  Returns cudaGetLastError().
int icq_ivf_crude_topk(const void* codes, const void* ids, const void* lut,
                       const void* scale, const void* offset, void* crude,
                       void* cand_v, void* cand_i, int nq, int nc, int Kc,
                       int Km, int m, int quant, int nibble, int topk,
                       int num_sms, void* stream) {
  const size_t smem = slab_smem_bytes(Kc, Km, quant ? 1 : 4);
  if (!slab_args_ok(nq, nc, topk, smem)) return int(cudaErrorInvalidValue);
  const int w = min(topk, kChunk);
  const dim3 grid = slab_grid(nc, nq, num_sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const int* id = static_cast<const int*>(ids);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  float* cr = static_cast<float*>(crude);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  cudaError_t e;
  if (quant && nibble)
    e = launch_with_smem(slab_crude_kernel<true, true>, grid, smem, s, c, id,
                         lut, sc, of, cr, cv, ci, nc, Kc, Km, m, w);
  else if (quant)
    e = launch_with_smem(slab_crude_kernel<true, false>, grid, smem, s, c,
                         id, lut, sc, of, cr, cv, ci, nc, Kc, Km, m, w);
  else if (nibble)
    e = launch_with_smem(slab_crude_kernel<false, true>, grid, smem, s, c,
                         id, lut, sc, of, cr, cv, ci, nc, Kc, Km, m, w);
  else
    e = launch_with_smem(slab_crude_kernel<false, false>, grid, smem, s, c,
                         id, lut, sc, of, cr, cv, ci, nc, Kc, Km, m, w);
  return int(e);
}

// The slab refine's blocks per query, for the caller to size its
// candidate lists (nq, out[0], topk): one wave of blocks (as many as fit
// on all SMs at this shared memory, divided among the queries), at most
// one per 1024-row chunk and one per topk columns.  Returns
// cudaErrorInvalidValue for another shape.
int icq_ivf_refine_plan(int nq, int nc, int Kc, int Km, int nibble,
                        int topk, int* out) {
  return refine_plan<1>(nc, Kc, nq, Km, nibble, topk, out);
}

// Phase 2.  codes as in phase 1; lut (nq, Km) f32 slow-masked; crude
// (nq, nc) f32 from phase 1; thr (nq,) f32; out_v / out_i (nq, grid,
// topk), grid from icq_ivf_refine_plan.
int icq_ivf_refine_topk(const void* codes, const void* lut, const void* crude,
                        const void* thr, void* out_v, void* out_i, int nq,
                        int nc, int Kc, int Km, int m, int nibble, int topk,
                        int grid_x, void* stream) {
  return refine_launch<1>(codes, long(nc) * Kc, lut, crude, thr, out_v,
                          out_i, nc, Kc, nq, Km, m, nibble, topk, grid_x,
                          stream);
}

}  // extern "C"
