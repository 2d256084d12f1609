// Forward flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
//   icq_flash_attention  <- flash_attention_pallas (_flash_kernel), with
//                           the GQA head folding of ops.flash_attention
//
// q (b, sq, H, dh), k and v (b, sk, KVH, dh), f32 or bf16, H a multiple
// of KVH; query head h reads key/value head h / (H / KVH).  For every
// query row, over key tiles in order, with running max m and sum l in f32:
//   s    = (q . k^T in f32) * scale            scale = dh ** -0.5
//   s    = NEG_INF = -1e30 where causal and q_pos < k_pos (top-left
//          aligned, both counted from 0, also when sq != sk)
//   m'   = max(m, max_j s);  corr = exp(m - m');  p = exp(s - m')
//   l    = l * corr + sum_j p
//   o    = o * corr + (p cast to v's type) . v     (f32 sums)
// and out = o / max(l, 1e-30) cast to v's type.  Key tiles wholly above
// the diagonal are skipped; key rows past sk (the ragged last tile) get
// s = -inf and contribute exactly 0.  The finite NEG_INF keeps a row
// that sees only masked keys in a tile free of NaN, as in the reference.
//
// What bounds it on this card: operations.  Causal attention at s = 4096
// does 4 dh H s (s + 1) / 2 operations: 0.55e12 for llama3-405b's 128
// heads of 128 (0.56 ms at the 989 TFLOP/s of bf16 tensor cores) and
// 0.07e12 for tinyllama's 32 heads of 64 (1.0 ms at 67 TFLOP/s f32),
// against 0.3 GB and 0.08 GB of q, k, v and out.
//
// What the design does about it, in this first version:
//   * One block of 256 threads per (64-query tile, head, batch); query
//     tiles are visited from the last, so the causal tiles with the most
//     key tiles start first.  The Q tile (f32, 64 x dh) stays in shared
//     memory; each 64-key tile of K, then of V, is staged into one shared
//     buffer (bf16 widened to f32 on the way in), read from the
//     (b, s, heads, dh) layout with 16-byte loads: no repeat of K/V for
//     GQA and no transposes.  Rows are padded by 4 floats, so the float4
//     reads of 8 neighbouring lanes fall in distinct banks.
//   * Each thread holds a 4 x 4 tile of S (rows 4 ty + i, keys tx + 16 j)
//     and a 4 x dh/16 tile of O, in registers; both products are f32 FMAs
//     on the SIMT cores.  The row max and row sum reduce over the 16 lanes
//     of a row group with shuffles; P goes through shared memory, cast to
//     v's type first as the reference does.
//   * f32 FMAs run at 67 TFLOP/s at most, so bf16 stays far from its
//     tensor-core bound; mma.sync / wgmma, TMA and a pipelined K/V ring
//     are left for later.
#include <cuda_bf16.h>

#include "search_common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBKey = 64;     // keys per tile
constexpr int kPadF = 4;      // row padding of every shared tile (floats)
constexpr float kNegInf = -1e30f;

template <int DH>
struct Geometry {
  static constexpr int kLd = DH + kPadF;            // Q / K / V row stride
  static constexpr int kLdp = kBKey + kPadF;        // P row stride
  static constexpr int kVW = DH >= 64 ? 4 : 2;      // O columns per load
  static constexpr int kNG = DH / (16 * kVW);       // loads per O row
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(kBQ) * kLd + size_t(kBKey) * kLd +
                       size_t(kBQ) * kLdp);
};

// 16 bytes of T at src (16-byte aligned) widened to f32 at dst.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// x rounded to T and back (the cast of p before the P . V product).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// VW f32 values at v stored as T at dst (VW * sizeof(T) aligned).
template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}
template <int VW>
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float* v) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(v[0], v[1]);
  if constexpr (VW == 4) d[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// Stage rows [row0, row0 + 64) of one head into dst (64 x kLd f32); rows
// at or past `rows` read 0.  src points at row 0 of the head; rows are
// `stride` elements apart.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int rows, long stride) {
  constexpr int kVE = 16 / int(sizeof(T));
  constexpr int kPerRow = DH / kVE;
  for (int e = threadIdx.x; e < kBQ * kPerRow; e += blockDim.x) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVE;
    float* d = dst + r * Geometry<DH>::kLd + c;
    if (row0 + r < rows) {
      load16(src + long(row0 + r) * stride + c, d);
    } else {
#pragma unroll
      for (int i = 0; i < kVE; ++i) d[i] = 0.0f;
    }
  }
}

__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             int H, int KVH, float scale, bool causal) {
  using G = Geometry<DH>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // kBQ x kLd
  float* kvs = qs + kBQ * G::kLd;          // kBKey x kLd: K, then V
  float* ps = kvs + kBKey * G::kLd;        // kBQ x kLdp
  const int tx = threadIdx.x % 16;         // key / column group
  const int ty = threadIdx.x / 16;         // rows 4 ty .. 4 ty + 3
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_stride = long(H) * DH, kv_stride = long(KVH) * DH;
  const T* q_head = q + long(b) * sq * q_stride + long(h) * DH;
  const T* k_head = k + long(b) * sk * kv_stride + long(kvh) * DH;
  const T* v_head = v + long(b) * sk * kv_stride + long(kvh) * DH;

  // key tiles up to the one holding the tile's last row's own position
  int n_kt = (sk + kBKey - 1) / kBKey;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, sq) - 1) / kBKey + 1);

  float o[4][DH / 16], m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) o[i][c] = 0.0f;
  }

  stage<T, DH>(qs, q_head, q0, sq, q_stride);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBKey;
    stage<T, DH>(kvs, k_head, k0, sk, kv_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &qs[(4 * ty + i) * G::kLd + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(
            &kvs[(tx + 16 * j) * G::kLd + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = __fmaf_rn(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // scale, mask, online softmax; P (cast to v's type) to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = __fmul_rn(s[i][j], scale);
        if (kpos >= sk)
          x = -CUDART_INF_F;
        else if (causal && qpos < kpos)
          x = kNegInf;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m_run[i], group_max(mt));
      const float corr = expf(m_run[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(4 * ty + i) * G::kLdp + tx + 16 * j] = round_to<T>(p);
      }
      l_run[i] = l_run[i] * corr + group_sum(rs);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) o[i][c] *= corr;
    }
    __syncthreads();   // S done with K; P complete

    stage<T, DH>(kvs, v_head, k0, sk, kv_stride);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBKey; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            &ps[(4 * ty + i) * G::kLdp + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = kvs + (j + jj) * G::kLd;
        float vv[DH / 16];
#pragma unroll
        for (int g = 0; g < G::kNG; ++g) {
          const float* src = vrow + g * 16 * G::kVW + tx * G::kVW;
          if constexpr (G::kVW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[g * 4 + 0] = t.x;
            vv[g * 4 + 1] = t.y;
            vv[g * 4 + 2] = t.z;
            vv[g * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[g * 2 + 0] = t.x;
            vv[g * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0   ? p4[i].x
                          : jj == 1 ? p4[i].y
                          : jj == 2 ? p4[i].z
                                    : p4[i].w;
#pragma unroll
          for (int c = 0; c < DH / 16; ++c)
            o[i][c] = __fmaf_rn(p, vv[c], o[i][c]);
        }
      }
    }
    __syncthreads();   // P and V consumed before the next tile
  }

  T* out_head = out + long(b) * sq * q_stride + long(h) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < G::kNG; ++g) {
      float w[G::kVW];
#pragma unroll
      for (int e = 0; e < G::kVW; ++e)
        w[e] = __fdiv_rn(o[i][g * G::kVW + e], den);
      store_vec<G::kVW>(
          out_head + long(row) * q_stride + g * 16 * G::kVW + tx * G::kVW,
          w);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int H, int KVH, float scale, bool causal,
           cudaStream_t stream) {
  auto kernel = flash_kernel<T, DH>;
  const size_t smem = Geometry<DH>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(unsigned((sq + kBQ - 1) / kBQ), unsigned(H), unsigned(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, H, KVH, scale,
      causal);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                void* out, int b, int sq, int sk, int H, int KVH,
                float scale, bool causal, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, out, b, sq, sk, H, KVH, scale,
                                  causal, s);
    case 64: return launch<T, 64>(q, k, v, out, b, sq, sk, H, KVH, scale,
                                  causal, s);
    case 128: return launch<T, 128>(q, k, v, out, b, sq, sk, H, KVH, scale,
                                    causal, s);
    case 256: return launch<T, 256>(q, k, v, out, b, sq, sk, H, KVH, scale,
                                    causal, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (b, sq, H, dh), k / v (b, sk, KVH, dh), out (b, sq, H, dh), all of
// one type: dtype 0 = f32, 1 = bf16; every pointer 16-byte aligned.
// dh in {32, 64, 128, 256}, H a multiple of KVH, b and H at most 65535.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another shape
// or type.
int icq_flash_attention(const void* q, const void* k, const void* v,
                        void* out, int dtype, int b, int sq, int sk, int H,
                        int KVH, int dh, float scale, int causal,
                        void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || H < 1 || KVH < 1 || H % KVH != 0 ||
      b > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, out, b, sq, sk, H, KVH, scale,
                              causal != 0, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, out, b, sq, sk, H, KVH,
                                      scale, causal != 0, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
