// k-means assignment (nearest centroid) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kmeans.py:
//   icq_kmeans_assign  <- kmeans_assign_pallas (_kmeans_kernel)
//
// For every point x: scores_c = ||c||^2 - 2 x.c over all L centroids,
// id = the first index of the minimum, dist = min + ||x||^2.
//
// What bounds it on this card: operations.  The coarse build of the IVF
// index assigns n = 1M points of d = 128 to L = 1024 centroids, 2 n L d
// = 2.7e11 f32 operations (4.0 ms at 67 TFLOP/s) against 0.5 GB of
// points read once (0.16 ms at 3.35 TB/s).
//
// What the design does about it:
//   * The dot products are computed here, in f32 FMAs on the SIMT cores
//     (no cuBLAS): a 64-point x 64-centroid tile per block, each of 256
//     threads holding a 4 x 4 register tile, both operands staged in
//     shared memory 32 dimensions at a time, transposed so that a thread
//     reads its 4 points and 4 centroids as two 16-byte loads.
//   * The TPU kernel pins all centroids in VMEM (<= 256 rows); here the
//     block walks centroid tiles, so L is bounded only by int range.
//     The (n, L) score matrix never leaves registers: each thread keeps
//     a running (min, index) per point over its centroids, visited in
//     ascending index with a strict <, and the 16 threads that share a
//     point reduce on (score, index), so the first index of the minimum
//     wins, as torch.argmin and jnp.argmin pick it.
//   This first version is simple and right; tensor cores (TF32 would
//   move scores by ~1e-3 relative and change assignments) and a point
//   tile kept resident across centroid tiles are left for later.
#include "search_common.cuh"

namespace {

constexpr int kBM = 64;   // points per block
constexpr int kBN = 64;   // centroids per tile
constexpr int kBK = 32;   // dimensions per staging step
constexpr int kPad = 4;   // keeps the float4 reads aligned

// Stage rows [r0, r0 + 64) x dims [k0, k0 + 32) of the (rows, d) matrix
// src transposed into dst[k][r]; rows or dims past the edge read 0.
__device__ __forceinline__ void stage_tile(float (*dst)[kBM + kPad],
                                           const float* __restrict__ src,
                                           long r0, long rows, int k0,
                                           int d) {
  for (int e = threadIdx.x; e < kBM * kBK; e += blockDim.x) {
    const int r = e / kBK, k = e % kBK;
    const long gr = r0 + r;
    const int gk = k0 + k;
    dst[k][r] = (gr < rows && gk < d) ? src[gr * d + gk] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x,
                     const float* __restrict__ cent,
                     const float* __restrict__ csq, int* __restrict__ ids,
                     float* __restrict__ dist, long n, int L, int d) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float cs[kBK][kBN + kPad];
  const int tx = threadIdx.x % 16;   // centroid group of 4
  const int ty = threadIdx.x / 16;   // point group of 4
  const long m0 = long(blockIdx.x) * kBM;
  float best[4], xsq[4];
  int bidx[4];
  for (int i = 0; i < 4; ++i) {
    best[i] = CUDART_INF_F;
    bidx[i] = INT_MAX;
    xsq[i] = 0.0f;
  }
  for (int c0 = 0; c0 < L; c0 += kBN) {
    float acc[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += kBK) {
      stage_tile(xs, x, m0, n, k0, d);
      stage_tile(cs, cent, c0, L, k0, d);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
        if (c0 == 0 && tx == 0)
          for (int i = 0; i < 4; ++i)
            xsq[i] = __fmaf_rn(av[i], av[i], xsq[i]);
      }
      __syncthreads();
    }
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < L) {
        const float cc = csq[c];
        for (int i = 0; i < 4; ++i) {
          const float sc = __fsub_rn(cc, __fmul_rn(2.0f, acc[i][j]));
          if (sc < best[i]) {
            best[i] = sc;
            bidx[i] = c;
          }
        }
      }
    }
  }
  // the 16 threads of a point group are 16 neighbouring lanes of a warp
  for (int i = 0; i < 4; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (key_less(ov, oi, best[i], bidx[i])) {
        best[i] = ov;
        bidx[i] = oi;
      }
    }
  }
  if (tx == 0) {
    for (int i = 0; i < 4; ++i) {
      const long gm = m0 + ty * 4 + i;
      if (gm < n) {
        ids[gm] = bidx[i];
        dist[gm] = __fadd_rn(best[i], xsq[i]);
      }
    }
  }
}

}  // namespace

extern "C" {

// x (n, d) f32; cent (L, d) f32; csq (L,) f32 = ||c||^2; ids (n,) int32;
// dist (n,) f32.  Returns cudaGetLastError().
int icq_kmeans_assign(const void* x, const void* cent, const void* csq,
                      void* ids, void* dist, long n, int L, int d,
                      void* stream) {
  if (n < 1 || L < 1 || d < 1 || (n + kBM - 1) / kBM > INT_MAX)
    return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((n + kBM - 1) / kBM));
  kmeans_assign_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cent),
      static_cast<const float*>(csq), static_cast<int*>(ids),
      static_cast<float*>(dist), n, L, d);
  return int(cudaGetLastError());
}

}  // extern "C"
