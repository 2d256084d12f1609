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
// codes and codebooks read or written once (0.2 ms at 3.35 TB/s).  The
// encoder launches it on 8192-point chunks (1.3e10 operations, 0.195 ms).
//
// What the design does about it:
//   * Each codebook step is a nearest-codeword search of the target
//     x - r against C[k]: a register-blocked SIMT GEMM with the argmin
//     fused, kmeans.cu's tiling.  128 threads, each holding an 8 x 8
//     register tile (points 4 ty + i and BM/2 + 4 ty + i, codewords
//     4 tx + j and BN/2 + 4 tx + j): 64 FMAs per four 16-byte shared
//     loads.  The point tile's target stays resident in shared memory
//     (transposed); C is transposed and zero-padded once per launch to
//     (K, dpad, mpad) and its 32-dimension x BN-codeword chunks stream
//     through a two-stage cp.async ring.  The first chunk of a step is
//     requested before the step's recon update, so it lands meanwhile.
//   * Filling the card at 8192 points.  Each codebook step depends on the
//     previous one, so the codeword axis cannot be split across
//     independent blocks.  The point tile is small instead: 32 points,
//     each CTA scoring all m codewords in 256-codeword tiles, so 8192
//     points are 256 blocks of 128 threads (two per SM at d = 128).  A
//     thread-block cluster of two CTAs per 64-point tile, each scoring
//     half the codewords and exchanging (score, index) minima through
//     distributed shared memory, measured slower at every shape on the
//     H100 (PERF.md) and was removed.
//   * Blocks are persistent: one wave (occupancy calculator) walks the
//     point tiles.
//   * Any d: up to 256 padded dimensions the target (dpad x BM) and the
//     recon (BM x d) tiles live in shared memory; above, the recon and
//     the target go to a per-CTA global scratch that the wrapper
//     allocates (grid x BM x d f32 each), and the target is staged into
//     shared memory in 256-dimension parts, as kmeans.cu stages x.  The
//     kernel allocates nothing.
//   * The recon loops run one warp per block of four point rows and one
//     lane per (four) dimensions: the four rows' codeword, recon and x
//     loads are issued together, rows are read as float4 when d % 4 ==
//     0, the transposed target is stored as one float4 across the four
//     rows, and the update that adds the previous step's codeword and
//     subtracts this step's old one is one pass.  No per-element
//     division.
//   * The recon chain is computed with __fsub_rn / __fadd_rn in the plain
//     version's order, so it is bitwise the plain version's; only the dot
//     products sum in their own order: one ascending-dimension
//     __fmaf_rn chain per score, kept across the staged parts (zero
//     padding adds exact zeros).  That is the order of the previous
//     kernel too, so codes equal its codes.  A point's codes depend on
//     nothing but its own row: no atomics, no dependence on its tile, the
//     staging or its position, so encoding in chunks or
//     in any row order gives the same codes.
//   * Codewords are visited in ascending index with a strict <, and the
//     lanes that share a point reduce on (score, index), so the first index of the minimum wins, as
//     torch.argmin and jnp.argmin pick it.  Codeword tiles past m and
//     dimensions past d read 0 and are never scored; pad rows past n run
//     on x = 0, codes = 0 and are not written.
//   Tensor cores (TF32 would move scores by ~1e-3 relative and change
//   codes) are not used.
#include "search_common.cuh"

namespace {

constexpr int kIcmThreads = 128;
constexpr int kIcmWarps = kIcmThreads / 32;
constexpr int kBK = 32;       // dimensions per streamed chunk
constexpr int kMaxDX = 256;   // dimensions of the resident target tile
constexpr int kPad = 4;       // keeps the float4 reads of the target aligned
constexpr int kRows = 4;      // rows a warp's recon loops take at a time
constexpr int kBM = 32;       // points per tile
constexpr int kBN = 256;      // codewords per tile

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

// The shape of one launch: C padded to (dpad, mpad) per codebook; DX
// target dimensions resident at a time; staged = recon and target in
// global scratch.  The one place these are decided (host and device).
struct IcmTiling {
  int n_ct, mpad, dpad, DX;
  bool staged;
};

__host__ __device__ IcmTiling icm_tiling(int m, int d) {
  IcmTiling t;
  t.n_ct = (m + kBN - 1) / kBN;
  t.mpad = t.n_ct * kBN;
  t.dpad = (d + kBK - 1) / kBK * kBK;
  t.staged = t.dpad > kMaxDX;
  t.DX = t.staged ? kMaxDX : t.dpad;
  return t;
}

// Dynamic shared memory: the transposed target (DX x (BM + kPad)), the
// recon (BM x d, unless staged), the two ring stages (2 x kBK x BN) and
// the tile's codes (BM x K).
struct IcmSmem {
  size_t ts, rs, cs, cd, total;
};

__host__ __device__ IcmSmem icm_smem(const IcmTiling& t, int K, int d) {
  IcmSmem s;
  s.ts = 0;
  s.rs = s.ts + align16(sizeof(float) * size_t(t.DX) * (kBM + kPad));
  s.cs = s.rs + (t.staged ? 0 : align16(sizeof(float) * size_t(kBM) * d));
  s.cd = s.cs + sizeof(float) * 2 * kBK * kBN;
  s.total = s.cd + align16(sizeof(int) * size_t(kBM) * K);
  return s;
}

// CT[k][j][c] = C[k][c][j] for j < d and c < m, else 0; (K, dpad, mpad).
__global__ void __launch_bounds__(256)
transpose_codebooks_kernel(const float* __restrict__ C,
                           float* __restrict__ CT, int K, int m, int d,
                           int mpad, int dpad) {
  const long total = long(K) * dpad * mpad;
  for (long e = long(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += long(gridDim.x) * blockDim.x) {
    const int c = int(e % mpad);
    const long kj = e / mpad;
    const int j = int(kj % dpad), k = int(kj / dpad);
    CT[e] = (c < m && j < d) ? C[(long(k) * m + c) * d + j] : 0.0f;
  }
}

__global__ void __launch_bounds__(kIcmThreads)
icm_encode_kernel(const float* __restrict__ x,
                  const int* __restrict__ codes0,
                  const float* __restrict__ C,
                  const float* __restrict__ CT,
                  const float* __restrict__ sq, int* __restrict__ out,
                  float* __restrict__ tg, float* __restrict__ rg, long n,
                  int K, int m, int d, int iters, long ntiles, bool vec) {
  constexpr int BM = kBM, BN = kBN;
  static_assert(BM * BN == 64 * kIcmThreads, "8 x 8 per thread");
  static_assert(BM % (kIcmWarps * kRows) == 0 && kRows == 4,
                "whole row blocks; float4 target stores across 4 rows");
  extern __shared__ __align__(16) unsigned char smem[];
  const IcmTiling t = icm_tiling(m, d);
  const IcmSmem sl = icm_smem(t, K, d);
  float* ts = reinterpret_cast<float*>(smem + sl.ts);
  float* rs = reinterpret_cast<float*>(smem + sl.rs);
  float* cs = reinterpret_cast<float*>(smem + sl.cs);
  int* cd = reinterpret_cast<int*>(smem + sl.cd);
  constexpr int TS = BM + kPad;       // target row pitch
  constexpr int NTX = BN / 8;         // lanes that share a point
  const int tid = threadIdx.x;
  const int tx = tid % NTX, ty = tid / NTX;
  const int warp = tid / 32, lane = tid % 32;
  const int mpad = t.mpad, dpad = t.dpad;
  const bool staged = t.staged;
  const int nk = dpad / kBK;                    // chunks per codeword tile
  const int part_chunks = t.DX / kBK;           // chunks per staged part
  const int steps = t.n_ct * nk;
  float* tg_cta = staged ? tg + long(blockIdx.x) * BM * d : nullptr;
  float* rec = staged ? rg + long(blockIdx.x) * BM * d : rs;

  // chunk `step` of codebook k: codeword tile step / nk, dims kBK (step %
  // nk) onward, into ring stage `stage`
  auto issue = [&](int k, int step, int stage) {
    const int c0 = (step / nk) * BN, k0 = (step % nk) * kBK;
    const float* src = CT + (long(k) * dpad + k0) * mpad + c0;
    float* dst = cs + stage * kBK * BN;
    constexpr int kPerRow = BN / 4;
#pragma unroll
    for (int i = 0; i < kBK * kPerRow / kIcmThreads; ++i) {
      const int e = tid + i * kIcmThreads;
      const int kk = e / kPerRow, c = (e % kPerRow) * 4;
      cp_async16(smem_addr(dst + kk * BN + c), src + long(kk) * mpad + c);
    }
  };

  if (!staged)   // dims past d stay zero: never written again
    for (int e = tid; e < (dpad - d) * BM; e += kIcmThreads)
      ts[(d + e / BM) * TS + e % BM] = 0.0f;

  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long p0 = tile * BM;
    __syncthreads();   // the previous tile's codes are written out
    for (int e = tid; e < BM * K; e += kIcmThreads)
      cd[e] = p0 + e / K < n ? codes0[p0 * K + e] : 0;
    __syncthreads();
    // recon = c_{0,b_0} + c_{1,b_1} + ..., in codebook order.  A warp
    // owns blocks of kRows rows and a lane dims (4) lane + 32 i of them,
    // here and in the update below; the kRows rows' loads are issued
    // together.
    for (int pb = warp * kRows; pb < BM; pb += kIcmWarps * kRows) {
      if (vec) {
        for (int j4 = lane; j4 < d / 4; j4 += 32) {
          float4 a[kRows];
#pragma unroll
          for (int u = 0; u < kRows; ++u)
            a[u] = reinterpret_cast<const float4*>(
                C + long(cd[(pb + u) * K]) * d)[j4];
          for (int k = 1; k < K; ++k) {
            float4 b[kRows];
#pragma unroll
            for (int u = 0; u < kRows; ++u)
              b[u] = reinterpret_cast<const float4*>(
                  C + (long(k) * m + cd[(pb + u) * K + k]) * d)[j4];
#pragma unroll
            for (int u = 0; u < kRows; ++u)
              a[u] = make_float4(__fadd_rn(a[u].x, b[u].x),
                                 __fadd_rn(a[u].y, b[u].y),
                                 __fadd_rn(a[u].z, b[u].z),
                                 __fadd_rn(a[u].w, b[u].w));
          }
#pragma unroll
          for (int u = 0; u < kRows; ++u)
            reinterpret_cast<float4*>(rec + long(pb + u) * d)[j4] = a[u];
        }
      } else {
        for (int j = lane; j < d; j += 32) {
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            const int p = pb + u;
            float a = C[long(cd[p * K]) * d + j];
            for (int k = 1; k < K; ++k)
              a = __fadd_rn(a, C[(long(k) * m + cd[p * K + k]) * d + j]);
            rec[long(p) * d + j] = a;
          }
        }
      }
    }

    int kp = -1;   // the previous step's codebook (its new code in cd)
    for (int it = 0; it < iters; ++it) {
      for (int k = 0; k < K; ++k) {
        issue(k, 0, 0);
        cp_async_commit();
        // recon += c_{kp, new} (the previous step), r = recon - c_{k,b_k}
        // (kept in the recon), target = x - r; the target goes to the
        // transposed tile as one float4 across the kRows rows
        for (int pb = warp * kRows; pb < BM; pb += kIcmWarps * kRows) {
          if (vec) {
            for (int j4 = lane; j4 < d / 4; j4 += 32) {
              float4 r[kRows], o[kRows], b[kRows], xv[kRows];
#pragma unroll
              for (int u = 0; u < kRows; ++u) {
                const int p = pb + u;
                r[u] = reinterpret_cast<const float4*>(rec + long(p) * d)[j4];
                o[u] = reinterpret_cast<const float4*>(
                    C + (long(k) * m + cd[p * K + k]) * d)[j4];
                b[u] = kp >= 0 ? reinterpret_cast<const float4*>(
                                     C + (long(kp) * m + cd[p * K + kp]) *
                                             d)[j4]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                xv[u] = p0 + p < n ? reinterpret_cast<const float4*>(
                                         x + (p0 + p) * d)[j4]
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              }
#pragma unroll
              for (int u = 0; u < kRows; ++u) {
                if (kp >= 0)
                  r[u] = make_float4(
                      __fadd_rn(r[u].x, b[u].x), __fadd_rn(r[u].y, b[u].y),
                      __fadd_rn(r[u].z, b[u].z), __fadd_rn(r[u].w, b[u].w));
                r[u] = make_float4(
                    __fsub_rn(r[u].x, o[u].x), __fsub_rn(r[u].y, o[u].y),
                    __fsub_rn(r[u].z, o[u].z), __fsub_rn(r[u].w, o[u].w));
                reinterpret_cast<float4*>(rec + long(pb + u) * d)[j4] = r[u];
                xv[u] = make_float4(
                    __fsub_rn(xv[u].x, r[u].x), __fsub_rn(xv[u].y, r[u].y),
                    __fsub_rn(xv[u].z, r[u].z), __fsub_rn(xv[u].w, r[u].w));
              }
              if (staged) {
#pragma unroll
                for (int u = 0; u < kRows; ++u)
                  reinterpret_cast<float4*>(tg_cta + long(pb + u) * d)[j4] =
                      xv[u];
              } else {
                float* col = ts + (4 * j4) * TS + pb;
                *reinterpret_cast<float4*>(col) =
                    make_float4(xv[0].x, xv[1].x, xv[2].x, xv[3].x);
                *reinterpret_cast<float4*>(col + TS) =
                    make_float4(xv[0].y, xv[1].y, xv[2].y, xv[3].y);
                *reinterpret_cast<float4*>(col + 2 * TS) =
                    make_float4(xv[0].z, xv[1].z, xv[2].z, xv[3].z);
                *reinterpret_cast<float4*>(col + 3 * TS) =
                    make_float4(xv[0].w, xv[1].w, xv[2].w, xv[3].w);
              }
            }
          } else {
            for (int j = lane; j < d; j += 32) {
              float tv[kRows];
#pragma unroll
              for (int u = 0; u < kRows; ++u) {
                const int p = pb + u;
                float r = rec[long(p) * d + j];
                if (kp >= 0)
                  r = __fadd_rn(r, C[(long(kp) * m + cd[p * K + kp]) * d + j]);
                r = __fsub_rn(r, C[(long(k) * m + cd[p * K + k]) * d + j]);
                rec[long(p) * d + j] = r;
                tv[u] = __fsub_rn(p0 + p < n ? x[(p0 + p) * d + j] : 0.0f, r);
              }
              if (staged) {
#pragma unroll
                for (int u = 0; u < kRows; ++u)
                  tg_cta[long(pb + u) * d + j] = tv[u];
              } else {
                *reinterpret_cast<float4*>(ts + j * TS + pb) =
                    make_float4(tv[0], tv[1], tv[2], tv[3]);
              }
            }
          }
        }
        __syncthreads();

        float acc[8][8], best[8];
        int bidx[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          best[i] = CUDART_INF_F;
          bidx[i] = INT_MAX;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        }
        for (int step = 0; step < steps; ++step) {
          const int kc = step % nk;
          if (step + 1 < steps) issue(k, step + 1, (step + 1) & 1);
          cp_async_commit();
          if (staged && kc % part_chunks == 0) {
            __syncthreads();   // the previous part is no longer read
            const int kb = kc * kBK;
            for (int e = tid; e < BM * kMaxDX; e += kIcmThreads) {
              const int p = e / kMaxDX, kk = e % kMaxDX;
              ts[kk * TS + p] =
                  kb + kk < d ? tg_cta[long(p) * d + kb + kk] : 0.0f;
            }
          }
          cp_async_wait1();   // chunk `step`
          __syncthreads();
          const float* tk = ts + (kc % part_chunks) * kBK * TS;
          const float* ck = cs + (step & 1) * kBK * BN;
#pragma unroll 4
          for (int kk = 0; kk < kBK; ++kk) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(tk + kk * TS + ty * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(
                tk + kk * TS + BM / 2 + ty * 4);
            const float4 b0 =
                *reinterpret_cast<const float4*>(ck + kk * BN + tx * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(
                ck + kk * BN + BN / 2 + tx * 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
          }
          if (kc == nk - 1) {   // the tile's dot products are complete
            const int ct = step / nk;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c =
                  ct * BN + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
              const float cc = c < m ? sq[long(k) * m + c] : 0.0f;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float sc = __fsub_rn(cc, __fmul_rn(2.0f, acc[i][j]));
                if (c < m && sc < best[i]) {
                  best[i] = sc;
                  bidx[i] = c;
                }
                acc[i][j] = 0.0f;
              }
            }
          }
          __syncthreads();   // chunk `step` consumed before its refill
        }
        // the NTX lanes of a point group are neighbouring lanes of a warp
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int off = NTX / 2; off > 0; off >>= 1) {
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
            const int p = i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4;
            cd[p * K + k] = bidx[i] < m ? bidx[i] : 0;   // all +inf: index 0
          }
        }
        __syncthreads();
        kp = k;
      }
    }
    for (int e = tid; e < BM * K; e += kIcmThreads)
      if (p0 + e / K < n) out[p0 * K + e] = cd[e];
  }
}

bool valid_shape(long n, int K, int m, int d, int iters) {
  return n >= 1 && K >= 1 && m >= 1 && d >= 1 && iters >= 0;
}

// One wave of persistent blocks (occupancy calculator), no more than the
// tiles.
cudaError_t plan_grid(size_t smem, long ntiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(icm_encode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, icm_encode_kernel, kIcmThreads, smem);
  if (e != cudaSuccess) return e;
  const long blocks = long(per_sm) * sms;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  *grid = int(ntiles < blocks ? ntiles : blocks);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The shape of one launch, for the caller to size its scratch: out[0..4]
// = {grid (CTAs), mpad, dpad, staged, BM}.  The caller allocates CT (K,
// dpad, mpad) f32 and, when staged, the target and recon scratch (grid x
// BM x d f32 each).  Returns cudaErrorInvalidValue for another shape.
int icq_icm_plan(long n, int K, int m, int d, int iters, int* out) {
  if (!valid_shape(n, K, m, d, iters)) return int(cudaErrorInvalidValue);
  const IcmTiling t = icm_tiling(m, d);
  const size_t smem = icm_smem(t, K, d).total;
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  int grid = 0;
  const cudaError_t e = plan_grid(smem, (n + kBM - 1) / kBM, &grid);
  if (e != cudaSuccess) return int(e);
  out[0] = grid;
  out[1] = t.mpad;
  out[2] = t.dpad;
  out[3] = int(t.staged);
  out[4] = kBM;
  return int(cudaSuccess);
}

// x (n, d) f32; codes0 (n, K) int32 warm start; C (K, m, d) f32; sq
// (K, m) f32 = ||c||^2; scratch from icq_icm_plan's shape: CT (K, dpad,
// mpad) f32, tg / rg (grid x BM x d) f32 when staged (else null); out
// (n, K) int32.  Returns cudaGetLastError() of the last launch, or
// cudaErrorInvalidValue for another shape or grid.
int icq_icm_encode(const void* x, const void* codes0, const void* C,
                   const void* sq, void* CT, void* tg, void* rg, void* out,
                   long n, int K, int m, int d, int iters, int grid,
                   void* stream) {
  if (!valid_shape(n, K, m, d, iters)) return int(cudaErrorInvalidValue);
  const IcmTiling t = icm_tiling(m, d);
  const size_t smem = icm_smem(t, K, d).total;
  if (smem > kMaxSmem || grid < 1 ||
      (t.staged && (tg == nullptr || rg == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long total = long(K) * t.dpad * t.mpad;
  const unsigned tblocks =
      unsigned(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  transpose_codebooks_kernel<<<tblocks, 256, 0, s>>>(
      static_cast<const float*>(C), static_cast<float*>(CT), K, m, d, t.mpad,
      t.dpad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);

  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = d % 4 == 0 && aligned(x) && aligned(C) && aligned(tg) &&
                   aligned(rg);
  e = cudaFuncSetAttribute(icm_encode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return int(e);
  icm_encode_kernel<<<unsigned(grid), kIcmThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(codes0),
      static_cast<const float*>(C), static_cast<const float*>(CT),
      static_cast<const float*>(sq), static_cast<int*>(out),
      static_cast<float*>(tg), static_cast<float*>(rg), n, K, m, d, iters,
      (n + kBM - 1) / kBM, vec);
  return int(cudaGetLastError());
}

}  // extern "C"
