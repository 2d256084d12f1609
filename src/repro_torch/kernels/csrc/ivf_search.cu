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
// What the design does about it: both passes launch the flat passes'
// scan kernels (search_common.cuh) at a query tile of one, each query's
// own slab as its code rows (a per-query code stride); a row's index is
// its slab position.
//   * Every query has its own slab, so there is no reuse of code rows
//     across queries.  A block pins its query's flattened LUT in shared
//     memory (8 KB at K = 8, m = 256 f32), stages 1024 slab rows at a
//     time with 16-byte loads and sums the K gathered entries per row.
//     The TPU kernel's one-hot x LUT batched matvec exists for the MXU
//     and does not carry over.
//   * Crude (crude_scan_kernel, masked by the id slab, kSlabIds): invalid
//     columns (id < 0: the slab's pads and, under a filter, the filtered
//     candidates, which the caller sets to -1) are +inf in the dense
//     crude output, so the refine pass inherits the mask through crude
//     < thr, and rank as (+inf, position).  A block walks its chunks of the slab in ascending
//     order and keeps a running top-k (list_round<false>): its first
//     chunk fills the list (one sort), later chunks admit only the few
//     rows below the bar and merge them by rank; +inf columns enter only
//     while the list holds pads, so a slab row thinner than topk ends in
//     its lowest invalid positions.  A sort is the costly step, so a
//     block's first round sorts 128 candidates a warp in registers and
//     takes only the distances across warps through shared memory
//     (bitonic_sort_n).
//   * Refine (refine_scan_kernel): admits only rows below its list's bar
//     into a pending buffer and merges it when the list still holds
//     pads, when it would overflow, and at the end; the next chunk's
//     code rows and crude values are staged with cp.async meanwhile.  A
//     few percent of the valid columns survive on the served cells, so
//     after its first chunk a round is a margin test, a few slow sums
//     and a barrier.
//   * Blocks per query, both passes: one wave (occupancy calculator), at
//     most one per chunk and one per topk columns (icq_ivf_crude_plan,
//     icq_ivf_refine_plan), so a query has a few lists to merge.  Both
//     write sorted lists per query that the flat kernels' merge
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

extern "C" {

// The slab crude pass's blocks per query, for the caller to size its
// candidate lists (nq, out[0], topk).  Returns cudaErrorInvalidValue for
// a shape that no tiling serves.
int icq_ivf_crude_plan(int nq, int nc, int Kc, int Km, int quant,
                       int nibble, int code_bytes, int topk, int* out) {
  return crude_plan<1, kSlabIds>(nc, Kc, nq, Km, quant, nibble, code_bytes,
                                 topk, out);
}

// Phase 1.  codes (nq, nc, Kc) uint8 or int32 (code_bytes 1 or 4); ids
// (nq, nc) int32, -1 = invalid; lut (nq, Km) f32, or int8 with scale /
// offset (nq,) f32; crude (nq, nc) f32; out_v / out_i (nq, grid, topk),
// grid from icq_ivf_crude_plan.  Returns cudaGetLastError().
int icq_ivf_crude_topk(const void* codes, const void* ids, const void* lut,
                       const void* scale, const void* offset, void* crude,
                       void* out_v, void* out_i, int nq, int nc, int Kc,
                       int Km, int m, int quant, int nibble,
                       int code_bytes, int topk, int grid_x, void* stream) {
  return crude_launch<1, kSlabIds>(codes, long(nc) * Kc, ids, lut, scale,
                                   offset, crude, out_v, out_i, nc, Kc, nq,
                                   Km, m, quant, nibble, code_bytes, topk,
                                   grid_x, stream);
}

// The slab refine's blocks per query, as icq_ivf_crude_plan.
int icq_ivf_refine_plan(int nq, int nc, int Kc, int Km, int nibble,
                        int code_bytes, int topk, int* out) {
  return refine_plan<1>(nc, Kc, nq, Km, nibble, code_bytes, topk, out);
}

// Phase 2.  codes as in phase 1; lut (nq, Km) f32 slow-masked; crude
// (nq, nc) f32 from phase 1; thr (nq,) f32; out_v / out_i (nq, grid,
// topk), grid from icq_ivf_refine_plan.
int icq_ivf_refine_topk(const void* codes, const void* lut, const void* crude,
                        const void* thr, void* out_v, void* out_i, int nq,
                        int nc, int Kc, int Km, int m, int nibble,
                        int code_bytes, int topk, int grid_x, void* stream) {
  return refine_launch<1>(codes, long(nc) * Kc, lut, crude, thr, out_v,
                          out_i, nc, Kc, nq, Km, m, nibble, code_bytes, topk,
                          grid_x, stream);
}

}  // extern "C"
