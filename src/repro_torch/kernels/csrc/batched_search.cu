// Batched two-step search kernels for Hopper (sm_90a): the crude and the
// refine pass of the ICQ two-step search (paper eq. 2), each fused with a
// top-k selection on the two keys (distance, global index).
//
// Replaces the TPU kernels of src/repro/kernels/batched_search.py:
//   icq_crude_topk   <- crude_topk_pallas  (_crude_topk_kernel)
//   icq_refine_topk  <- refine_topk_pallas (_refine_topk_kernel)
//
// What bounds them on this card: memory bytes.  At the serving shape
// (64 queries x 1M points, K = 8, m = 256) the crude pass must write the
// dense (nq, n) f32 crude matrix (256 MB) and read 8 MB of codes; the
// refine pass reads the same 264 MB.  Each pass does only nq * n * K
// float adds (about 0.5 GFLOP), far below the card's f32 rate.
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
//   * The refine pass gathers slow entries only for points that pass the
//     margin test crude < thr; the TPU computes them for every point only
//     because its matmul is dense.  The result is the same.
//   * Top-k: blocks run in no order, so nothing carries across chunks.
//     Each block sorts its chunk's 1024 (distance, index) pairs with a
//     bitonic sort in shared memory and keeps the first topk; a small
//     select launch (icq_select_topk) then reduces the per-chunk lists
//     per query, 1024 candidates per block, until one list remains.  The
//     order is total (distance, then index), so the result equals one
//     global sort: lowest index first among ties, and the +inf tail of
//     pruned points carries the lowest pruned indices.
//   * Sum order and rounding match the plain PyTorch version bit for
//     bit: the K entries are added in codebook order starting from 0.0,
//     and every add and multiply is an explicit __fadd_rn / __fmul_rn so
//     nvcc cannot contract the int8 dequant (scale * acc + offset) or
//     full = crude + slow into an FMA.
//   This first version is simple and right; the bitonic sort of every
//   chunk is its known cost (see PERF.md).  The chunk sort, the code-row
//   staging and the LUT sums live in search_common.cuh, shared with the
//   IVF slab kernels (ivf_search.cu).
#include "search_common.cuh"

namespace {

constexpr int kMaxQueryTile = 8;

// Dynamic shared memory of one scan block: sort keys, code rows, LUTs of
// the query tile and per-query scalars (scale/offset or threshold).
__host__ __device__ size_t scan_smem_bytes(int Kc, int qt, int Km,
                                           int lut_esize, int n_scalars) {
  return size_t(kChunk) * (sizeof(float) + sizeof(int)) +
         align16(size_t(kChunk) * Kc) +
         align16(size_t(qt) * Km * lut_esize) +
         size_t(n_scalars) * qt * sizeof(float);
}

struct ScanSmem {
  float* val;
  int* idx;
  uint8_t* codes;
  unsigned char* lut;
  float* scalars;
};

__device__ ScanSmem carve(unsigned char* base, int Kc, int qt, int Km,
                          int lut_esize) {
  ScanSmem s;
  s.val = reinterpret_cast<float*>(base);
  s.idx = reinterpret_cast<int*>(base + kChunk * sizeof(float));
  size_t off = size_t(kChunk) * (sizeof(float) + sizeof(int));
  s.codes = base + off;
  off += align16(size_t(kChunk) * Kc);
  s.lut = base + off;
  off += align16(size_t(qt) * Km * lut_esize);
  s.scalars = reinterpret_cast<float*>(base + off);
  return s;
}

// Phase 1.  grid (x: strided over point chunks, y: query tiles of qt).
// crude may be null (want_crude = false): no dense matrix is written.
template <bool QUANT, bool NIBBLE>
__global__ void __launch_bounds__(kThreads)
crude_scan_kernel(const uint8_t* __restrict__ codes,
                  const void* __restrict__ lut_g,
                  const float* __restrict__ scale_g,
                  const float* __restrict__ offset_g,
                  float* __restrict__ crude, float* __restrict__ cand_v,
                  int* __restrict__ cand_i, int n, int Kc, int nq, int Km,
                  int m, int topk, int qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanSmem s = carve(smem, Kc, qt, Km, QUANT ? 1 : 4);
  const int q0 = blockIdx.y * qt;
  const int nchunks = (n + kChunk - 1) / kChunk;
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
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const long base = long(chunk) * kChunk;
    __syncthreads();  // the previous chunk's readers are done
    load_codes(s.codes, codes, base, n, Kc);
    __syncthreads();
    for (int q = 0; q < qt && q0 + q < nq; ++q) {
      const int qg = q0 + q;
      for (int p = threadIdx.x; p < kChunk; p += blockDim.x) {
        const long gi = base + p;
        float d = CUDART_INF_F;
        int id = INT_MAX;
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
          id = int(gi);
        }
        s.val[p] = d;
        s.idx[p] = id;
      }
      __syncthreads();
      bitonic_sort(s.val, s.idx);
      write_topk(s.val, s.idx, cand_v, cand_i, qg, nchunks, chunk, topk);
      __syncthreads();
    }
  }
}

// Phase 2: the margin test crude < thr, the slow-masked f32 LUT sum for
// survivors, full = crude + slow; pruned points rank +inf.
template <bool NIBBLE>
__global__ void __launch_bounds__(kThreads)
refine_scan_kernel(const uint8_t* __restrict__ codes,
                   const float* __restrict__ lut_g,
                   const float* __restrict__ crude,
                   const float* __restrict__ thr_g,
                   float* __restrict__ cand_v, int* __restrict__ cand_i,
                   int n, int Kc, int nq, int Km, int m, int topk, int qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanSmem s = carve(smem, Kc, qt, Km, 4);
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
      write_topk(s.val, s.idx, cand_v, cand_i, qg, nchunks, chunk, topk);
      __syncthreads();
    }
  }
}

// One reduction level: (nq, L) candidate pairs -> (nq, ceil(L/kChunk),
// topk).  grid (x: candidate chunks, y: queries).
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ in_v, const int* __restrict__ in_i,
              float* __restrict__ out_v, int* __restrict__ out_i, long L,
              int topk) {
  __shared__ float val[kChunk];
  __shared__ int idx[kChunk];
  const int q = blockIdx.y;
  const long base = long(blockIdx.x) * kChunk;
  for (int p = threadIdx.x; p < kChunk; p += blockDim.x) {
    const long j = base + p;
    val[p] = j < L ? in_v[q * L + j] : CUDART_INF_F;
    idx[p] = j < L ? in_i[q * L + j] : INT_MAX;
  }
  __syncthreads();
  bitonic_sort(val, idx);
  write_topk(val, idx, out_v, out_i, q, gridDim.x, blockIdx.x, topk);
}

// Largest query tile (<= kMaxQueryTile) whose shared memory fits, or 0.
int pick_query_tile(int Kc, int Km, int lut_esize, int n_scalars) {
  for (int qt = kMaxQueryTile; qt >= 1; qt >>= 1)
    if (scan_smem_bytes(Kc, qt, Km, lut_esize, n_scalars) <= kMaxSmem)
      return qt;
  return 0;
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

// Phase 1.  codes (n, Kc) uint8; lut (nq, Km) f32, or int8 with scale /
// offset (nq,) f32; crude (nq, n) f32 or null; cand_v / cand_i
// (nq, ceil(n / chunk), topk).  Returns cudaGetLastError().
int icq_crude_topk(const void* codes, const void* lut, const void* scale,
                   const void* offset, void* crude, void* cand_v,
                   void* cand_i, int n, int Kc, int nq, int Km, int m,
                   int quant, int nibble, int topk, int num_sms,
                   void* stream) {
  const int esize = quant ? 1 : 4;
  const int n_scalars = quant ? 2 : 0;
  const int qt = pick_query_tile(Kc, Km, esize, n_scalars);
  if (qt == 0 || topk < 1 || topk > kChunk || n < 1 || nq < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = scan_smem_bytes(Kc, qt, Km, esize, n_scalars);
  const dim3 grid = scan_grid(n, nq, qt, num_sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  float* cr = static_cast<float*>(crude);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  cudaError_t e;
  if (quant && nibble)
    e = launch_with_smem(crude_scan_kernel<true, true>, grid, smem, s, c,
                         lut, sc, of, cr, cv, ci, n, Kc, nq, Km, m, topk, qt);
  else if (quant)
    e = launch_with_smem(crude_scan_kernel<true, false>, grid, smem, s, c,
                         lut, sc, of, cr, cv, ci, n, Kc, nq, Km, m, topk, qt);
  else if (nibble)
    e = launch_with_smem(crude_scan_kernel<false, true>, grid, smem, s, c,
                         lut, sc, of, cr, cv, ci, n, Kc, nq, Km, m, topk, qt);
  else
    e = launch_with_smem(crude_scan_kernel<false, false>, grid, smem, s, c,
                         lut, sc, of, cr, cv, ci, n, Kc, nq, Km, m, topk, qt);
  return int(e);
}

// Phase 2.  codes as in phase 1; lut (nq, Km) f32 slow-masked; crude
// (nq, n) f32; thr (nq,) f32; cand_v / cand_i as in phase 1.
int icq_refine_topk(const void* codes, const void* lut, const void* crude,
                    const void* thr, void* cand_v, void* cand_i, int n,
                    int Kc, int nq, int Km, int m, int nibble, int topk,
                    int num_sms, void* stream) {
  const int qt = pick_query_tile(Kc, Km, 4, 1);
  if (qt == 0 || topk < 1 || topk > kChunk || n < 1 || nq < 1)
    return int(cudaErrorInvalidValue);
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
                         t, cv, ci, n, Kc, nq, Km, m, topk, qt);
  else
    e = launch_with_smem(refine_scan_kernel<false>, grid, smem, s, c, l, cr,
                         t, cv, ci, n, Kc, nq, Km, m, topk, qt);
  return int(e);
}

// One merge level: in (nq, L) pairs -> out (nq, ceil(L / chunk), topk).
int icq_select_topk(const void* in_v, const void* in_i, void* out_v,
                    void* out_i, int nq, long L, int topk, void* stream) {
  if (topk < 1 || topk > kChunk || L < 1 || nq < 1)
    return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((L + kChunk - 1) / kChunk), nq);
  select_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_v), static_cast<const int*>(in_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), L, topk);
  return int(cudaGetLastError());
}

}  // extern "C"
