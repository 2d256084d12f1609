// Forward flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
//   icq_flash_attention  <- flash_attention_pallas (_flash_kernel), with
//                           the GQA head folding of ops.flash_attention
//
// q (b, sq, H, dqk), k (b, sk, KVH, dqk) and v (b, sk, KVH, dv), f32 or
// bf16, H a multiple of KVH; query head h reads key/value head h / (H /
// KVH).  The compiled (dqk, dv) pairs: (32, 32), (64, 64), (128, 128),
// (256, 256) and DeepSeek-V2's MLA prefill, (192, 128): 128 nope + 64
// rope dims of q and k, 128 of v.  The output is (b, sq, H, dv).  For
// every query row, over key tiles in order, with running max m and sum l
// in f32:
//   s    = (q . k^T in f32) * scale            scale = dqk ** -0.5
//   s    = NEG_INF = -1e30 where causal and q_pos < k_pos (top-left
//          aligned, both counted from 0, also when sq != sk)
//   m'   = max(m, max_j s);  corr = exp(m - m');  p = exp(s - m')
//   l    = l * corr + sum_j p                  (p unrounded)
//   o    = o * corr + (p cast to v's type) . v     (f32 sums)
// and out = o / max(l, 1e-30) cast to v's type.  Key tiles wholly above
// the diagonal are skipped; key rows past sk (the ragged last tile) get
// s = -inf and contribute exactly 0.  The finite NEG_INF keeps a row
// that sees only masked keys in a tile free of NaN, as in the reference.
//
// What bounds it on this card: operations.  Causal attention at s = 4096
// does 2 (dqk + dv) H s (s + 1) / 2 operations: 0.55e12 for
// llama3-405b's 128 heads of 128 (0.56 ms at the 989 TFLOP/s of bf16
// tensor cores) and 0.07e12 for tinyllama's 32 heads of 64 (0.07 ms in
// bf16, 1.0 ms at the 67 TFLOP/s of f32 FMAs), against 0.3 GB and 0.08 GB
// of q, k, v and out; DeepSeek-V2's 128 MLA heads at s = 2048 do 0.17e12
// (0.17 ms) against 0.34 GB (0.10 ms).
//
// Two bodies, chosen by the type; no runtime fallback between them.
//
// bf16: tensor cores (flash_mma_kernel), the FlashAttention-2 structure.
//   * One block of 4 warps per (head, 64-query tile, batch); each warp
//     owns 16 query rows.  blockIdx.x is the head, so the first wave
//     holds every head's last query tile: the causal tiles with the most
//     key tiles start first.
//   * Both products are mma.sync m16n8k16 (bf16 in, f32 accumulate).
//     The Q fragments are read once with ldmatrix and stay in registers
//     (dqk <= 128; at dqk 192 and 256 they are re-read from shared memory
//     each tile, so that the 64 or 128 f32 of O per thread stay in
//     registers).  S comes from ldmatrix.x4 fragments of K and stays in
//     its accumulator fragments; scale, masks and the online softmax run
//     there (exp2 of log2-scaled scores, one MUFU instruction each), the
//     row max and sum reducing over the quad that shares a row (shuffles
//     1 and 2).
//     P is rounded to bf16 straight into the A fragments of P . V (an
//     accumulator pair of m16n8 is an A-fragment pair of m16n8k16), so
//     it never touches shared memory; l sums the unrounded p.  V is read
//     with ldmatrix.x4.trans; O stays in f32 accumulators.
//   * K and V stream through their own two-stage cp.async rings (16-byte
//     copies; rows past sk zero-filled through the source-size operand):
//     the next K tile loads during this tile's S and softmax, the next V
//     tile during this tile's P . V, with two barriers per tile.  Shared
//     rows are padded by 16 bytes, so the 8 row addresses of an ldmatrix
//     fall in 8 distinct 16-byte bank groups.
//   * K's rows are dqk + 8 wide and V's dv + 8, each ring sized for its
//     own width.  At (192, 128) Q (25 KB), the K ring (50 KB) and the V
//     ring (34 KB) take 109 KB, so two blocks share an SM.
//   * Keys per tile: 64, and 32 at dh 256 (registers).  At dh 128 the Q
//     tile is staged in V's second stage and the registers are capped at
//     168, so three blocks (12 warps) share an SM instead of two; at dh
//     64 a cap of 128 registers lets four share it instead of three.
//     Both measured faster on the H100 despite small spills (60 and 8
//     bytes).
//   * What still bounds it: every warp reads the whole K and V tile
//     through ldmatrix, so shared-memory reads take about as long as the
//     mma.sync work, which itself reaches about a third of the bf16 peak;
//     wgmma (operands read once per warpgroup) with TMA-fed rings is the
//     next step.
//
// f32: f32 FMAs on the SIMT cores (flash_kernel), the first port's design.
//   * One block of 256 threads per (64-query tile, head, batch); query
//     tiles are visited from the last.  The Q tile (64 x dqk) stays in
//     shared memory; each 64-key tile of K, then of V, is staged into one
//     shared buffer max(dqk, dv) wide, read from the (b, s, heads, width)
//     layout with 16-byte loads: no repeat of K/V for GQA and no
//     transposes.  Rows are padded by 4 floats, so the float4 reads of 8
//     neighbouring lanes fall in distinct banks.
//   * Each thread holds a 4 x 4 tile of S (rows 4 ty + i, keys tx + 16 j)
//     and a 4 x dv/16 tile of O, in registers.  The row max and row sum
//     reduce over the 16 lanes of a row group with shuffles; P goes
//     through shared memory.  It keeps 2e-5 against the plain version,
//     which TF32 tensor cores would not.
#include <cstdint>

#include <cuda_bf16.h>

#include "search_common.cuh"

namespace {

// ------------------------------------------------------ f32: SIMT FMAs ----


constexpr int kBQ = 64;       // query rows per block
constexpr int kBKey = 64;     // keys per tile
constexpr int kPadF = 4;      // row padding of every shared tile (floats)
constexpr float kNegInf = -1e30f;

template <int DQK, int DV>
struct Geometry {
  static constexpr int kLd = (DQK > DV ? DQK : DV) + kPadF;  // Q / K / V
  static constexpr int kLdp = kBKey + kPadF;        // P row stride
  static constexpr int kVW = DV >= 64 ? 4 : 2;      // O columns per load
  static constexpr int kNG = DV / (16 * kVW);       // loads per O row
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(kBQ) * kLd + size_t(kBKey) * kLd +
                       size_t(kBQ) * kLdp);
};

// 16 bytes of T at src (16-byte aligned) widened to f32 at dst.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
// x rounded to T and back (the cast of p before the P . V product).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
// VW f32 values at v stored as T at dst (VW * sizeof(T) aligned).
template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}
// Stage W columns of rows [row0, row0 + 64) of one head into dst (64 x
// LD f32); rows at or past `rows` read 0.  src points at row 0 of the
// head; rows are `stride` elements apart.
template <typename T, int W, int LD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int rows, long stride) {
  constexpr int kVE = 16 / int(sizeof(T));
  constexpr int kPerRow = W / kVE;
  for (int e = threadIdx.x; e < kBQ * kPerRow; e += blockDim.x) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVE;
    float* d = dst + r * LD + c;
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

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             int H, int KVH, float scale, bool causal) {
  using G = Geometry<DQK, DV>;
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
  const long q_stride = long(H) * DQK, k_stride = long(KVH) * DQK;
  const long v_stride = long(KVH) * DV, o_stride = long(H) * DV;
  const T* q_head = q + long(b) * sq * q_stride + long(h) * DQK;
  const T* k_head = k + long(b) * sk * k_stride + long(kvh) * DQK;
  const T* v_head = v + long(b) * sk * v_stride + long(kvh) * DV;

  // key tiles up to the one holding the tile's last row's own position
  int n_kt = (sk + kBKey - 1) / kBKey;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, sq) - 1) / kBKey + 1);

  float o[4][DV / 16], m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DV / 16; ++c) o[i][c] = 0.0f;
  }

  stage<T, DQK, G::kLd>(qs, q_head, q0, sq, q_stride);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBKey;
    stage<T, DQK, G::kLd>(kvs, k_head, k0, sk, k_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DQK; d += 4) {
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
      for (int c = 0; c < DV / 16; ++c) o[i][c] *= corr;
    }
    __syncthreads();   // S done with K; P complete

    stage<T, DV, G::kLd>(kvs, v_head, k0, sk, v_stride);
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
        float vv[DV / 16];
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
          for (int c = 0; c < DV / 16; ++c)
            o[i][c] = __fmaf_rn(p, vv[c], o[i][c]);
        }
      }
    }
    __syncthreads();   // P and V consumed before the next tile
  }

  T* out_head = out + long(b) * sq * o_stride + long(h) * DV;
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
          out_head + long(row) * o_stride + g * 16 * G::kVW + tx * G::kVW,
          w);
    }
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int H, int KVH, float scale, bool causal,
           cudaStream_t stream) {
  auto kernel = flash_kernel<T, DQK, DV>;
  const size_t smem = Geometry<DQK, DV>::kSmem;
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


// ------------------------------------------- bf16: mma.sync tensor cores ----

constexpr int kMmaWarps = 4;                  // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;        // query rows per block

template <int DQK, int DV>
struct MmaGeometry {
  static constexpr int kBK = DQK >= 256 ? 32 : 64;  // keys per tile
  static constexpr int kLdK = DQK + 8;              // Q / K row stride
  static constexpr int kLdV = DV + 8;               // V row stride
  static constexpr bool kQInRegs = DQK <= 128;
  // at dh 128 the Q tile is staged in V's second stage (read into
  // registers before that stage is first filled) and the registers are
  // capped at 168, so that three blocks share an SM; at dh 64 they are
  // capped at 128, so that four do; at (192, 128) shared memory admits
  // two
  static constexpr bool kQInV = DQK == 128 && DV == 128;
  static constexpr int kMinBlocks =
      kQInV ? 3 : (DQK == 64 ? 4 : (DQK == 192 ? 2 : 1));
  static constexpr int kTileK = kBK * kLdK;         // one K stage
  static constexpr int kTileV = kBK * kLdV;         // one V stage
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) *
      ((kQInV ? 0 : size_t(kMmaBQ) * kLdK) + 2 * size_t(kTileK) +
       2 * size_t(kTileV));
  static_assert(!kQInV || (kQInRegs && kMmaBQ <= kBK && kLdK == kLdV),
                "Q fits one V stage");
};

// 2^x in one MUFU instruction (no denormal handling: every x here is
// <= 0, and a result that underflows adds nothing).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst; with src_bytes = 0 nothing is read and
// dst is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a . b over one m16 n8 k16 step, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 in one 32-bit register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// cp.async W columns of rows [row0, row0 + ROWS) of one head (rows
// `stride` elements apart, src at row 0) into dst (ROWS x LD); rows at or
// past `rows` are zero-filled.
template <int W, int LD, int ROWS>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int row0,
    int rows, long stride) {
  constexpr int kChunks = W / 8;                   // 16 bytes each
  constexpr int kIters = ROWS * kChunks / kMmaThreads;
  static_assert(ROWS * kChunks % kMmaThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(smem_addr(dst + r * LD + c),
               src + (ok ? long(row0 + r) * stride + c : 0), ok ? 16 : 0);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kMmaThreads,
                                  MmaGeometry<DQK, DV>::kMinBlocks)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int sq, int sk, int H,
                 int KVH, float scale, bool causal) {
  using G = MmaGeometry<DQK, DV>;
  constexpr int kBK = G::kBK, kLdK = G::kLdK, kLdV = G::kLdV;
  constexpr int kKS = DQK / 16;   // k-steps of S = Q . K^T
  constexpr int kNT = kBK / 8;    // 8-key column tiles of S
  constexpr int kPS = kBK / 16;   // k-steps of O += P . V
  constexpr int kDT = DV / 8;     // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* k_sm = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* v_sm = k_sm + 2 * G::kTileK;      // 2 stages each
  __nv_bfloat16* q_sm = v_sm + (G::kQInV ? 1 : 2) * G::kTileV;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row, column pair
  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (sq + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (n_qt - 1 - int(blockIdx.y)) * kMmaBQ;
  const int kvh = h / (H / KVH);
  const long q_stride = long(H) * DQK, k_stride = long(KVH) * DQK;
  const long v_stride = long(KVH) * DV, o_stride = long(H) * DV;
  const __nv_bfloat16* q_head =
      q + long(b) * sq * q_stride + long(h) * DQK;
  const __nv_bfloat16* k_head =
      k + long(b) * sk * k_stride + long(kvh) * DQK;
  const __nv_bfloat16* v_head =
      v + long(b) * sk * v_stride + long(kvh) * DV;

  // key tiles up to the one holding the tile's last row's own position
  int n_kt = (sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kMmaBQ, sq) - 1) / kBK + 1);

  // per-lane ldmatrix offsets (elements): Q as A (rows lane % 16, column
  // half lane / 16); K as B of two 8-key tiles (keys lane & 7 and + 8
  // for lanes 16-31, column half bit 3 of the lane); V as B^T of two
  // 8-column tiles (keys lane & 7 and + 8 for bit 3, column half lane /
  // 16)
  const int a_off = (warp * 16 + lane % 16) * kLdK + (lane / 16) * 8;
  const int k_off =
      ((lane & 7) + ((lane >> 4) << 3)) * kLdK + ((lane >> 3) & 1) * 8;
  const int v_off =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLdV + (lane >> 4) * 8;
  const uint32_t q_a = smem_addr(q_sm) + 2 * a_off;
  const uint32_t k_a = smem_addr(k_sm) + 2 * k_off;
  const uint32_t v_a = smem_addr(v_sm) + 2 * v_off;

  load_tile_async<DQK, kLdK, kMmaBQ>(q_sm, q_head, q0, sq, q_stride);
  load_tile_async<DQK, kLdK, kBK>(k_sm, k_head, 0, sk, k_stride);
  cp_async_commit();
  load_tile_async<DV, kLdV, kBK>(v_sm, v_head, 0, sk, v_stride);
  cp_async_commit();

  uint32_t qf[G::kQInRegs ? kKS : 1][4];
  cp_async_wait<1>();     // Q and the first K tile
  __syncthreads();
  if constexpr (G::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) ldmatrix_x4(qf[kk], q_a + 32 * kk);
  }

  const float sl2 = scale * 1.4426950408889634f;   // scores in log2 units
  const int row_w = q0 + warp * 16;                // the warp's first row
  const int rows[2] = {row_w + g, row_w + g + 8};
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};      // this lane's share of the row sum

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int st = kt & 1;
    if (kt + 1 < n_kt)
      load_tile_async<DQK, kLdK, kBK>(k_sm + (st ^ 1) * G::kTileK, k_head,
                                      k0 + kBK, sk, k_stride);
    cp_async_commit();
    cp_async_wait<2>();   // K tile kt
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      if constexpr (G::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, q_a + 32 * kk);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_x4(bb,
                    k_a + 2 * (st * G::kTileK + np * 16 * kLdK + kk * 16));
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // scale, mask and the online softmax on the accumulator fragments:
    // element e of column tile nt is row rows[e / 2], key
    // k0 + 8 nt + 2 t + e % 2
    const bool mask = k0 + kBK > sk || (causal && k0 + kBK - 1 > row_w);
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sl2;
        if (mask) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          if (key >= sk)
            x = -CUDART_INF_F;
          else if (causal && rows[e >> 1] < key)
            x = kNegInf;
        }
        s[nt][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m_run[i], mt[i]);
      corr[i] = ex2(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
    // P as the A fragments of P . V: k-step j takes column tiles 2j and
    // 2j + 1, (rows g, g + 8) each
    uint32_t pf[kPS][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float p0 = ex2(s[nt][0] - m_run[0]);
      const float p1 = ex2(s[nt][1] - m_run[0]);
      const float p2 = ex2(s[nt][2] - m_run[1]);
      const float p3 = ex2(s[nt][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pf[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    if (kt + 1 < n_kt)
      load_tile_async<DV, kLdV, kBK>(v_sm + (st ^ 1) * G::kTileV, v_head,
                                     k0 + kBK, sk, v_stride);
    cp_async_commit();
    cp_async_wait<2>();   // V tile kt
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kPS; ++kk)
#pragma unroll
      for (int nd = 0; nd < kDT / 2; ++nd) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, v_a + 2 * (st * G::kTileV + kk * 16 * kLdV +
                                         nd * 16));
        mma_bf16(o[2 * nd], pf[kk], bb[0], bb[1]);
        mma_bf16(o[2 * nd + 1], pf[kk], bb[2], bb[3]);
      }
  }

  __nv_bfloat16* out_head =
      out + long(b) * sq * o_stride + long(h) * DV;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (rows[i] >= sq) continue;
    const float den = fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = out_head + long(rows[i]) * o_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(__fdiv_rn(o[dt][2 * i], den),
                                __fdiv_rn(o[dt][2 * i + 1], den));
  }
}

template <int DQK, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int b, int sq, int sk, int H, int KVH, float scale,
               bool causal, cudaStream_t stream) {
  auto kernel = flash_mma_kernel<DQK, DV>;
  const size_t smem = MmaGeometry<DQK, DV>::kSmem;
  const int n_qt = (sq + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > 65535) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(n_qt),
                  static_cast<unsigned>(b));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), sq, sk, H, KVH, scale, causal);
  return int(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch ----

template <int DQK, int DV>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* out, int b, int sq, int sk, int H, int KVH,
                 float scale, bool causal, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, DQK, DV>(q, k, v, out, b, sq, sk, H, KVH, scale,
                                  causal, s);
  if (dtype == 1)
    return launch_mma<DQK, DV>(q, k, v, out, b, sq, sk, H, KVH, scale,
                               causal, s);
  return int(cudaErrorInvalidValue);
}

template <int DQK, int DV>
cudaError_t attributes(int dtype, cudaFuncAttributes* attr) {
  if (dtype == 0)
    return cudaFuncGetAttributes(attr, flash_kernel<float, DQK, DV>);
  if (dtype == 1)
    return cudaFuncGetAttributes(attr, flash_mma_kernel<DQK, DV>);
  return cudaErrorInvalidValue;
}

// The compiled (dqk, dv) pairs, each as one case value.
constexpr int pair(int dqk, int dv) { return dqk * 1024 + dv; }

}  // namespace

extern "C" {

// q (b, sq, H, dqk), k (b, sk, KVH, dqk), v (b, sk, KVH, dv), out (b, sq,
// H, dv), all of one type: dtype 0 = f32 (FMA body), 1 = bf16
// (tensor-core body); every pointer 16-byte aligned.  (dqk, dv) in
// {(32, 32), (64, 64), (128, 128), (256, 256), (192, 128)}, H a multiple
// of KVH, b and H at most 65535.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another shape or type.
int icq_flash_attention(const void* q, const void* k, const void* v,
                        void* out, int dtype, int b, int sq, int sk, int H,
                        int KVH, int dqk, int dv, float scale, int causal,
                        void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || H < 1 || KVH < 1 || H % KVH != 0 ||
      b > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  switch (pair(dqk, dv)) {
#define ICQ_FLASH_CASE(DQK, DV)                                          \
  case pair(DQK, DV):                                                    \
    return launch_dtype<DQK, DV>(dtype, q, k, v, out, b, sq, sk, H, KVH, \
                                 scale, c, s);
    ICQ_FLASH_CASE(32, 32)
    ICQ_FLASH_CASE(64, 64)
    ICQ_FLASH_CASE(128, 128)
    ICQ_FLASH_CASE(256, 256)
    ICQ_FLASH_CASE(192, 128)
#undef ICQ_FLASH_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

// The registers per thread and local-memory bytes per thread (spills and
// local arrays) of the body that runs for dtype and (dqk, dv).
int icq_flash_attention_attributes(int dtype, int dqk, int dv, int* regs,
                                   int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (pair(dqk, dv)) {
#define ICQ_FLASH_CASE(DQK, DV) \
  case pair(DQK, DV): e = attributes<DQK, DV>(dtype, &attr); break;
    ICQ_FLASH_CASE(32, 32)
    ICQ_FLASH_CASE(64, 64)
    ICQ_FLASH_CASE(128, 128)
    ICQ_FLASH_CASE(256, 256)
    ICQ_FLASH_CASE(192, 128)
#undef ICQ_FLASH_CASE
    default: return int(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return int(e);
  *regs = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
