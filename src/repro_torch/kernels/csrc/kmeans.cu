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
// points read once (0.16 ms at 3.35 TB/s).  The dot products stay f32
// FMAs on the SIMT cores: TF32 tensor cores would move scores by ~1e-3
// relative and change assignments.
//
// What the design does about it: a register-blocked SIMT GEMM with the
// argmin fused, so the (n, L) score matrix never leaves registers.
//   * A block of 256 threads owns 128 points and walks 128-centroid
//     tiles; each thread holds an 8 x 8 register tile (points 4 ty + i
//     and 64 + 4 ty + i, centroids 4 tx + j and 64 + 4 tx + j): 64 FMAs
//     per four 16-byte shared loads.
//   * The point tile is staged once, with 16-byte loads, transposed on
//     the way in, and stays resident in shared memory across all
//     centroid tiles (up to 256 dimensions; a larger d is staged in
//     256-dimension parts, again for every centroid tile).  ||x||^2 is
//     summed once, from the staged tile.
//   * Centroids are first transposed and zero-padded to (dp, Lp) by a
//     small launch (transpose_centroids_kernel); ||c||^2 comes from the
//     wrapper, the plain version's own sum.  The centroids' 32-dimension
//     x 128-centroid chunks then stream through a two-stage
//     cp.async ring while the previous chunk is multiplied.  96 KB of
//     shared memory at d = 128 and registers capped at 128 (a 72-byte
//     spill): two blocks per SM, measured faster on the H100 than 160
//     registers and one block.
//   * Every (point, centroid) dot product is summed with __fmaf_rn in
//     ascending dimension order (zero padding adds exact zeros), so a
//     score does not depend on the tiling.  Each thread keeps a running
//     (min, index) per point over its centroids in ascending index with
//     a strict <, and the 16 threads that share a point reduce on
//     (score, index): the first index of the minimum wins, as
//     torch.argmin and jnp.argmin pick it.
//   * Split-L: where the point tiles alone would not fill the card
//     (icq_kmeans_plan: fewer tiles than the blocks that fit on all SMs
//     at this d), the centroid tiles are split into S slices (grid.y);
//     each block writes its slice's (score, index) minimum to an (S, n)
//     scratch, and a second small launch reduces the slices on
//     (score, index) and adds ||x||^2.  The minimum of a total order
//     does not depend on the partition, so the split output equals the
//     unsplit one bit for bit.
#include "search_common.cuh"

namespace {

constexpr int kBM = 128;      // points per block
constexpr int kBN = 128;      // centroids per tile
constexpr int kBK = 32;       // dimensions per streamed chunk
constexpr int kMaxDX = 256;   // dimensions of the resident point tile
constexpr int kTransposeWarps = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One warp per padded centroid c < Lp: centT[k][c] = cent[c][k] for
// k < d and c < L, else 0 (for k < dp).
__global__ void __launch_bounds__(32 * kTransposeWarps)
transpose_centroids_kernel(const float* __restrict__ cent,
                           float* __restrict__ centT, int L, int Lp, int d,
                           int dp) {
  const int c = blockIdx.x * kTransposeWarps + threadIdx.x / 32;
  if (c >= Lp) return;
  for (int k = threadIdx.x % 32; k < dp; k += 32)
    centT[long(k) * Lp + c] = (c < L && k < d) ? cent[long(c) * d + k] : 0.0f;
}

// Stage dims [k0, k0 + dx) of points [m0, m0 + 128) transposed into
// xs[k][m] (dx x 128); points past n and dims past d read 0.  With vec
// (d % 4 == 0 and x 16-byte aligned) each thread reads float4s, four in
// flight before it stores them.
__device__ __forceinline__ void stage_points(float* xs,
                                             const float* __restrict__ x,
                                             long m0, long n, int k0,
                                             int dx, int d, bool vec) {
  if (vec) {
    const int total = kBM * (dx / 4);
    for (int e0 = threadIdx.x; e0 < total; e0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        const long gm = m0 + e % kBM;
        const int gk = k0 + (e / kBM) * 4;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (e < total && gm < n && gk < d)
          v[u] = *reinterpret_cast<const float4*>(x + gm * d + gk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= total) break;
        float* dst = xs + (e / kBM) * 4 * kBM + e % kBM;
        dst[0] = v[u].x;
        dst[kBM] = v[u].y;
        dst[2 * kBM] = v[u].z;
        dst[3 * kBM] = v[u].w;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kBM * dx; e += kThreads) {
      const int m = e % kBM, k = e / kBM;
      const long gm = m0 + m;
      const int gk = k0 + k;
      xs[k * kBM + m] = (gm < n && gk < d) ? x[gm * d + gk] : 0.0f;
    }
  }
}

// cp.async chunk `step` (centroid tile ct0 + step / nk, dims 32 (step %
// nk) onward) of centT (dp, Lp) into cs (32 x 128).
__device__ __forceinline__ void issue_chunk(float* cs,
                                            const float* __restrict__ centT,
                                            int step, int ct0, int nk,
                                            int Lp) {
  const int c0 = (ct0 + step / nk) * kBN, k0 = (step % nk) * kBK;
  constexpr int kPerRow = kBN / 4;            // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kBK * kPerRow / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = e / kPerRow, c = (e % kPerRow) * 4;
    cp_async16(smem_addr(cs + k * kBN + c),
               centT + long(k0 + k) * Lp + c0 + c);
  }
}

// grid (ceil(n / 128), S): slice s walks centroid tiles [s cps, (s + 1)
// cps) of the n_ct.  S == 1 writes ids and dist; S > 1 writes the
// slice's (score, index) minimum to part_v / part_i (S, n) and slice 0
// writes ||x||^2 to xsq.
__global__ void __launch_bounds__(kThreads, 2)
kmeans_assign_kernel(const float* __restrict__ x,
                     const float* __restrict__ centT,
                     const float* __restrict__ csq, int* __restrict__ ids,
                     float* __restrict__ dist, float* __restrict__ part_v,
                     int* __restrict__ part_i, float* __restrict__ xsq_out,
                     long n, int L, int Lp, int d, int dp, int dx, int cps,
                     bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // dx x 128, transposed points
  float* cs = xs + dx * kBM;          // 2 stages of 32 x 128 centroids
  __shared__ float xsq_s[kBM];
  const int tx = threadIdx.x % 16;    // centroids 4 tx + j, 64 + 4 tx + j
  const int ty = threadIdx.x / 16;    // points 4 ty + i, 64 + 4 ty + i
  const long m0 = long(blockIdx.x) * kBM;
  const int n_ct = Lp / kBN;
  const int ct0 = blockIdx.y * cps;
  const int ct1 = min(ct0 + cps, n_ct);
  const int nk = dp / kBK;            // chunks per centroid tile
  const int kpx = dx / kBK;           // chunks per resident point part
  const bool one_part = dx == dp;
  const int steps = (ct1 - ct0) * nk;

  issue_chunk(cs, centT, 0, ct0, nk, Lp);
  cp_async_commit();
  if (one_part) stage_points(xs, x, m0, n, 0, dx, d, vec);

  float acc[8][8], best[8], xsq = 0.0f;
  int bidx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = CUDART_INF_F;
    bidx[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  for (int step = 0; step < steps; ++step) {
    const int ct = ct0 + step / nk, kc = step % nk;
    if (step + 1 < steps)
      issue_chunk(cs + ((step + 1) & 1) * kBK * kBN, centT, step + 1, ct0,
                  nk, Lp);
    cp_async_commit();
    if (!one_part && kc % kpx == 0) {
      __syncthreads();      // the previous part is no longer read
      stage_points(xs, x, m0, n, kc * kBK, dx, d, vec);
    }
    cp_async_wait1();       // chunk `step`
    __syncthreads();
    // ||x||^2 of point threadIdx.x, from the staged tile, once
    if (ct == ct0 && threadIdx.x < kBM && (one_part ? kc == 0
                                                    : kc % kpx == 0)) {
      const int kb = one_part ? 0 : kc * kBK;
      const int ke = min(d, kb + dx);
      for (int k = kb; k < ke; ++k) {
        const float v = xs[(k - kb) * kBM + threadIdx.x];
        xsq = __fmaf_rn(v, v, xsq);
      }
    }
    const float* xk = xs + ((one_part ? kc : kc % kpx) * kBK) * kBM;
    const float* ck = cs + (step & 1) * kBK * kBN;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          xk + k * kBM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(
          xk + k * kBM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(
          ck + k * kBN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          ck + k * kBN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    if (kc == nk - 1) {     // the tile's dot products are complete
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = ct * kBN + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        const float cc = c < L ? csq[c] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float sc = __fsub_rn(cc, __fmul_rn(2.0f, acc[i][j]));
          if (c < L && sc < best[i]) {
            best[i] = sc;
            bidx[i] = c;
          }
          acc[i][j] = 0.0f;
        }
      }
    }
    __syncthreads();        // chunk `step` consumed before its refill
  }
  if (threadIdx.x < kBM) xsq_s[threadIdx.x] = xsq;
  __syncthreads();

  // the 16 threads of a point group are 16 neighbouring lanes of a warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
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
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
      const long gm = m0 + p;
      if (gm >= n) continue;
      if (gridDim.y == 1) {
        ids[gm] = bidx[i];
        dist[gm] = __fadd_rn(best[i], xsq_s[p]);
      } else {
        part_v[blockIdx.y * n + gm] = best[i];
        part_i[blockIdx.y * n + gm] = bidx[i];
        if (blockIdx.y == 0) xsq_out[gm] = xsq_s[p];
      }
    }
  }
}

// The split's second launch: per point, the (score, index) minimum over
// the S slices in order, plus ||x||^2.
__global__ void __launch_bounds__(kThreads)
reduce_slices_kernel(const float* __restrict__ part_v,
                     const int* __restrict__ part_i,
                     const float* __restrict__ xsq, int* __restrict__ ids,
                     float* __restrict__ dist, long n, int S) {
  const long i = long(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = part_v[i];
  int id = part_i[i];
  for (int s = 1; s < S; ++s) {
    const float ov = part_v[s * n + i];
    const int oi = part_i[s * n + i];
    if (key_less(ov, oi, v, id)) {
      v = ov;
      id = oi;
    }
  }
  ids[i] = id;
  dist[i] = __fadd_rn(v, xsq[i]);
}

// The tiling of one call: Lp = L rounded up to 128 centroids, dp = d
// rounded up to 32 dims, dx the dims of the resident point tile and smem
// the kernel's dynamic shared memory.  The one place these are decided.
struct Tiling {
  int Lp, dp, n_ct, dx;
  size_t smem;
};

Tiling tiling(int L, int d) {
  Tiling t;
  t.n_ct = (L + kBN - 1) / kBN;
  t.Lp = t.n_ct * kBN;
  t.dp = (d + kBK - 1) / kBK * kBK;
  t.dx = t.dp < kMaxDX ? t.dp : kMaxDX;
  t.smem = sizeof(float) * (size_t(t.dx) * kBM + 2 * kBK * kBN);
  return t;
}

// S lowered to the slice count that ceil(n_ct / S) centroid tiles per
// slice give, so that no slice is empty.
int nonempty_slices(int n_ct, int S) {
  const int cps = (n_ct + S - 1) / S;
  return (n_ct + cps - 1) / cps;
}

bool valid_shape(long n, int L, int d) {
  return n >= 1 && L >= 1 && d >= 1 && (n + kBM - 1) / kBM <= INT_MAX;
}

}  // namespace

extern "C" {

// The tiling of one call, for the caller to size its scratch: out[0..2]
// = {Lp, dp, S}.  split >= 1 asks for that many centroid slices, at most
// ceil(L / 128) (lowered so that none is empty); split == 0 lets the
// kernel choose for the current device: 1 where the ceil(n / 128) point
// tiles fill every SM with as many blocks as fit there at this d, else
// enough slices to fill them, at most one per 128-centroid tile.
// Returns cudaErrorInvalidValue for another shape or split.
int icq_kmeans_plan(long n, int L, int d, int split, int* out) {
  if (!valid_shape(n, L, d)) return int(cudaErrorInvalidValue);
  const Tiling t = tiling(L, d);
  if (split < 0 || split > t.n_ct) return int(cudaErrorInvalidValue);
  int S = split;
  if (S == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kmeans_assign_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(t.smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kmeans_assign_kernel, kThreads, t.smem);
    if (e != cudaSuccess) return int(e);
    const long tiles = (n + kBM - 1) / kBM, want = long(per_sm) * sms;
    const long fill = (want + tiles - 1) / tiles;
    S = tiles >= want ? 1 : (fill < t.n_ct ? int(fill) : t.n_ct);
  }
  out[0] = t.Lp;
  out[1] = t.dp;
  out[2] = nonempty_slices(t.n_ct, S);
  return int(cudaSuccess);
}

// x (n, d) f32; cent (L, d) f32; csq (L,) f32 = ||c||^2.  Scratch from
// the caller, sized by icq_kmeans_plan's {Lp, dp, S}: centT (dp, Lp)
// f32; with S > 1 also part_v (S, n) f32, part_i (S, n) int32 and xsq
// (n,) f32 (else null).  Outputs ids (n,) int32, dist (n,) f32.
// Returns cudaGetLastError() of the last launch, or
// cudaErrorInvalidValue for another shape or S.
int icq_kmeans_assign(const void* x, const void* cent, const void* csq,
                      void* centT, void* part_v, void* part_i, void* xsq,
                      void* ids, void* dist, long n, int L, int d, int S,
                      void* stream) {
  if (!valid_shape(n, L, d)) return int(cudaErrorInvalidValue);
  const Tiling t = tiling(L, d);
  if (S < 1 || S > t.n_ct || long(S) * n > INT_MAX ||
      S != nonempty_slices(t.n_ct, S))
    return int(cudaErrorInvalidValue);
  if (S > 1 && (!part_v || !part_i || !xsq))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  transpose_centroids_kernel<<<(t.Lp + kTransposeWarps - 1) /
                                   kTransposeWarps,
                               32 * kTransposeWarps, 0, s>>>(
      static_cast<const float*>(cent), static_cast<float*>(centT), L, t.Lp,
      d, t.dp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);

  const int cps = (t.n_ct + S - 1) / S;       // centroid tiles per slice
  const bool vec =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  e = cudaFuncSetAttribute(kmeans_assign_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(t.smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(unsigned((n + kBM - 1) / kBM), unsigned(S));
  kmeans_assign_kernel<<<grid, kThreads, t.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(centT),
      static_cast<const float*>(csq), static_cast<int*>(ids),
      static_cast<float*>(dist), static_cast<float*>(part_v),
      static_cast<int*>(part_i), static_cast<float*>(xsq), n, L, t.Lp, d,
      t.dp, t.dx, cps, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return int(e);
  reduce_slices_kernel<<<unsigned((n + kThreads - 1) / kThreads), kThreads,
                         0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float*>(xsq), static_cast<int*>(ids),
      static_cast<float*>(dist), n, S);
  return int(cudaGetLastError());
}

}  // extern "C"
