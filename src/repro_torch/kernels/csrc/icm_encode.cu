// ICM encoding for additive codebooks on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/icm_encode.py:
//   icq_icm_encode  <- icm_encode_pallas (_icm_kernel)
//
// For every point x, from its warm-start codes b and recon = sum_k
// c_{k,b_k} (added in codebook order), `iters` sweeps over the codebooks
// k = 0 .. K-1 in order:
//   r      = recon - c_{k,b_k}
//   scores = ||c_{k,j}||^2 - 2 <x - r, c_{k,j}>      for j < m
//   b_k    = the first index of the minimum;  recon = r + c_{k,b_k}
//
// What bounds it on this card: operations.  At SIFT1M geometry (n = 1M,
// d = 128, K = 8, m = 256, 3 sweeps) the dot products are 2 n iters K m d
// = 1.6e12 f32 operations (23 ms at 67 TFLOP/s) against ~0.6 GB of points,
// codes and codebooks read or written once (0.2 ms at 3.35 TB/s).
//
// What the design does about it:
//   * Each codebook step is a nearest-codeword search of the target
//     x - r against C[k], so the block runs the f32 FMA loop of
//     kmeans.cu: a 64-point x 64-codeword tile per block, each of 256
//     threads holding a 4 x 4 register tile.  Here the 64-point target
//     tile stays resident in shared memory (transposed, full d) for the
//     whole step, and only the codeword tiles are staged, 32 dimensions
//     at a time, from C[k], which L2 serves after the first blocks.
//     All K m d of C (1 MB here) does not fit a block's shared memory,
//     which is why it is streamed and not pinned as on the TPU.
//   * The TPU kernel gathers codewords with one-hot matmuls (a trick for
//     its matrix unit); here they are plain row reads of C[k].
//   * All sweeps run in one launch: the tile's codes and recon (64 x d
//     f32) stay in shared memory from the warm start to the last sweep,
//     and the codes are written back once.
//   * The recon chain is computed with __fsub_rn / __fadd_rn in the plain
//     version's order, so it is bitwise the plain version's; only the dot
//     products sum in their own order (ascending dimension, one FMA
//     chain per score).  A point's codes depend on nothing but its own
//     row: no atomics, no dependence on its tile or position, so
//     encoding in chunks or in any row order gives the same codes.
//   * Codewords are visited in ascending index with a strict <, and the
//     16 threads that share a point reduce on (score, index), so the
//     first index of the minimum wins, as torch.argmin and jnp.argmin
//     pick it.  Codeword tiles past m and dimensions past d read 0 and
//     are never scored; pad rows past n run on x = 0, codes = 0 and are
//     not written.
//   This first version is simple and right; tensor cores (TF32 would
//   move scores by ~1e-3 relative and change codes) are left for later.
#include "search_common.cuh"

namespace {

constexpr int kBM = 64;   // points per block
constexpr int kBN = 64;   // codewords per tile
constexpr int kBK = 32;   // dimensions per staging step
constexpr int kPad = 4;   // keeps the float4 reads aligned

__host__ __device__ constexpr int padded_dim(int d) {
  return (d + kBK - 1) / kBK * kBK;
}

// Dynamic shared memory of one block: the transposed target tile (dpad x
// (kBM + kPad)), the recon tile (kBM x d), one staged codeword tile
// (kBK x (kBN + kPad)) and the tile's codes (kBM x K).
__host__ __device__ constexpr size_t target_bytes(int d) {
  return align16(sizeof(float) * size_t(padded_dim(d)) * (kBM + kPad));
}
__host__ __device__ constexpr size_t recon_bytes(int d) {
  return align16(sizeof(float) * size_t(kBM) * d);
}
__host__ __device__ constexpr size_t staged_bytes() {
  return align16(sizeof(float) * size_t(kBK) * (kBN + kPad));
}
__host__ __device__ constexpr size_t smem_bytes(int K, int d) {
  return target_bytes(d) + recon_bytes(d) + staged_bytes() +
         align16(sizeof(int) * size_t(kBM) * K);
}

__global__ void __launch_bounds__(kThreads)
icm_encode_kernel(const float* __restrict__ x,
                  const int* __restrict__ codes0,
                  const float* __restrict__ C, const float* __restrict__ sq,
                  int* __restrict__ out, long n, int K, int m, int d,
                  int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  float(*ts)[kBM + kPad] = reinterpret_cast<float(*)[kBM + kPad]>(smem);
  float* rs = reinterpret_cast<float*>(smem + target_bytes(d));
  float(*cs)[kBN + kPad] = reinterpret_cast<float(*)[kBN + kPad]>(
      smem + target_bytes(d) + recon_bytes(d));
  int* cd = reinterpret_cast<int*>(smem + target_bytes(d) + recon_bytes(d) +
                                   staged_bytes());
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // codeword group of 4
  const int ty = tid / 16;   // point group of 4
  const int dpad = padded_dim(d);
  const long p0 = long(blockIdx.x) * kBM;

  for (int e = tid; e < kBM * K; e += blockDim.x)
    cd[e] = p0 + e / K < n ? codes0[p0 * K + e] : 0;
  for (int e = tid; e < (dpad - d) * kBM; e += blockDim.x)
    ts[d + e / kBM][e % kBM] = 0.0f;   // dims past d: never written again
  __syncthreads();
  // recon = c_{0,b_0} + c_{1,b_1} + ..., in codebook order
  for (int e = tid; e < kBM * d; e += blockDim.x) {
    const int p = e / d, j = e % d;
    float acc = C[long(cd[p * K]) * d + j];
    for (int k = 1; k < K; ++k)
      acc = __fadd_rn(acc, C[(long(k) * m + cd[p * K + k]) * d + j]);
    rs[e] = acc;
  }

  for (int it = 0; it < iters; ++it) {
    for (int k = 0; k < K; ++k) {
      const float* Ck = C + long(k) * m * d;
      // r = recon - c_{k,b_k} (kept in rs), target = x - r (into ts);
      // each thread touches the recon elements it wrote before
      for (int e = tid; e < kBM * d; e += blockDim.x) {
        const int p = e / d, j = e % d;
        const float r = __fsub_rn(rs[e], Ck[long(cd[p * K + k]) * d + j]);
        rs[e] = r;
        const float xv = p0 + p < n ? x[(p0 + p) * d + j] : 0.0f;
        ts[j][p] = __fsub_rn(xv, r);
      }
      __syncthreads();

      float best[4];
      int bidx[4];
      for (int i = 0; i < 4; ++i) {
        best[i] = CUDART_INF_F;
        bidx[i] = INT_MAX;
      }
      for (int c0 = 0; c0 < m; c0 += kBN) {
        float acc[4][4];
        for (int i = 0; i < 4; ++i)
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
        for (int k0 = 0; k0 < dpad; k0 += kBK) {
          for (int e = tid; e < kBN * kBK; e += blockDim.x) {
            const int r = e / kBK, kk = e % kBK;
            const int gc = c0 + r, gk = k0 + kk;
            cs[kk][r] = (gc < m && gk < d) ? Ck[long(gc) * d + gk] : 0.0f;
          }
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < kBK; ++kk) {
            const float4 a =
                *reinterpret_cast<const float4*>(&ts[k0 + kk][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&cs[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
            for (int i = 0; i < 4; ++i)
              for (int jj = 0; jj < 4; ++jj)
                acc[i][jj] = __fmaf_rn(av[i], bv[jj], acc[i][jj]);
          }
          __syncthreads();
        }
        for (int jj = 0; jj < 4; ++jj) {
          const int c = c0 + tx * 4 + jj;
          if (c < m) {
            const float cc = sq[long(k) * m + c];
            for (int i = 0; i < 4; ++i) {
              const float sc = __fsub_rn(cc, __fmul_rn(2.0f, acc[i][jj]));
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
      if (tx == 0)
        for (int i = 0; i < 4; ++i)   // every score +inf: argmin's index 0
          cd[(ty * 4 + i) * K + k] = bidx[i] < m ? bidx[i] : 0;
      __syncthreads();
      for (int e = tid; e < kBM * d; e += blockDim.x) {
        const int p = e / d, j = e % d;
        rs[e] = __fadd_rn(rs[e], Ck[long(cd[p * K + k]) * d + j]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kBM * K; e += blockDim.x)
    if (p0 + e / K < n) out[p0 * K + e] = cd[e];
}

}  // namespace

extern "C" {

// x (n, d) f32; codes0 (n, K) int32 warm start; C (K, m, d) f32; sq (K, m)
// f32 = ||c||^2; out (n, K) int32.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty operand or a (K, d) whose tile needs
// more shared memory than a block has (d up to ~440 at K = 8).
int icq_icm_encode(const void* x, const void* codes0, const void* C,
                   const void* sq, void* out, long n, int K, int m, int d,
                   int iters, void* stream) {
  if (n < 1 || K < 1 || m < 1 || d < 1 || iters < 0 ||
      (n + kBM - 1) / kBM > INT_MAX || smem_bytes(K, d) > kMaxSmem)
    return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((n + kBM - 1) / kBM));
  return int(launch_with_smem(
      icm_encode_kernel, grid, smem_bytes(K, d),
      static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
      static_cast<const int*>(codes0), static_cast<const float*>(C),
      static_cast<const float*>(sq), static_cast<int*>(out), n, K, m, d,
      iters));
}

}  // extern "C"
