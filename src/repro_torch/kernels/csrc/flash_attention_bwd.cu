// The backward of flash attention for Hopper (sm_90a): two kernels on
// mma.sync tensor cores, in both types.
//
// Replaces no Pallas kernel: the reference has no backward kernel.  It
// trains through jax.checkpoint'ed chunked_attention
// (src/repro/models/attention.py), whose autodiff recomputes the
// probabilities chunk by chunk; these kernels compute that gradient from
// the forward's row log-sum-exp LSE (icq_flash_attention in
// flash_attention.cu, with lse).
//
// Operands and masks are the forward's: q (b, sq, H, dqk), k (b, sk,
// KVH, dqk), v (b, sk, KVH, dv), the output o and its gradient dO (b, sq,
// H, dv), one type (f32 or bf16); the (dqk, dv) pairs (32, 32), (64,
// 64), (128, 128), (256, 256) and (192, 128); causal, window, kv_valid,
// the query offset and the mask operand as in the forward.  Per visible
// (query i, key j) pair, recomputed tile by tile:
//   P_ij  = exp(s_ij * scale - LSE_i)        (exactly 0 where masked)
//   D_i   = sum_c dO_ic O_ic                 (f32 FMAs)
//   dP_ij = dO_i . v_j,  dS_ij = P_ij (dP_ij - D_i)
//   dV_j += P_ij dO_i,  dQ_i += scale dS_ij k_j,  dK_j += scale dS_ij q_i
// with f32 sums.  No atomics: every output element is summed by one
// thread in a fixed order, so two launches are equal bit for bit.  A row
// that saw no key (its LSE below kEmptyLse, flash_mma.cuh) had the
// reference's uniform softmax: it adds nothing to dQ or dK and dO_i / sk
// (1 / sk cast to the operands' type, as the forward's P) to every key's
// dV; in the kernels' kGeneral instance (general_instance: a call with a
// query offset, a mask operand or a window past the last key, the calls
// where such a row can occur) the dK/dV kernel sums those rows' dO over
// its KV head's G query heads, one warp a run of 32 rows, and adds it to
// every key.
//
// What bounds it: operations.  Five products a visible pair (S, dP, dV,
// dQ, dK: 2 (3 dqk + 2 dv) operations, against the forward's 2 (dqk +
// dv)); each kernel recomputes S and dP, so seven are computed.  At the
// LM train cell's attention (tinyllama-1.1b, f32, 8 x 2048, 32 / 4 heads
// of 64, causal) the five are 3.4e11 operations: 5.1 ms at the 67
// TFLOP/s of f32 FMAs, 2.1 ms at the 165 TFLOP/s that 3xTF32 leaves of
// the 495 TFLOP/s TF32 peak; at gemma-7b's (bf16, 1 x 2048, 16 heads of
// 256) 8.6e10, 0.087 ms at the 989 TFLOP/s bf16 peak.
//
// Design (the FlashAttention-2 backward):
//   * flash_bwd_dq_kernel: one block of 4 warps per (64-query tile, head,
//     batch), query tiles from the last (the causal tiles with the most
//     key tiles start first); each warp owns 16 query rows.  It first
//     writes D = rowsum(dO o O) for its rows (read by the second kernel),
//     then walks the forward's key tiles in order: S = Q K^T, P, dP =
//     dO V^T, dS = P (dP - D), dQ += dS K.  Q and dO stay in shared
//     memory (bf16 at dqk <= 64: their A fragments in registers); K and V
//     stream through a two-stage cp.async ring.
//   * flash_bwd_dkdv_kernel: one block per (key tile, KV head, batch); it
//     walks the G query heads of its KV head and, for each, the query
//     tiles that see the key tile, in order, and a key tile no query
//     sees (past kv_valid, right of every causal row) writes zeros.  Each
//     warp owns 16 keys; K and V are loaded once; Q and dO tiles, with
//     their LSE and D rows, stream through a two-stage cp.async ring.
//     Per query tile: S^T = K Q^T, P^T on the accumulator fragments, dV
//     += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q; dK
//     and dV stay in f32 accumulators and are stored at the end as
//     scale dK and dV.  At dqk >= 192 two warps share a 16-key slab, each
//     accumulating half of dK's and dV's columns (both compute the slab's
//     S^T and dP^T), so that the accumulators fit in registers, and a
//     block holds 32 keys (4 warps): bf16 dK / dV at cell D's (192, 128)
//     2.28 against 2.84 ms with 64 keys (8 warps), at cell B's dh 256
//     0.55 against 0.61, and 1.6x faster with one KV head (NVIDIA H100
//     80GB HBM3, 700 W).
//   * P and dS never touch shared memory: a product's accumulator
//     fragments become the A fragments of the next product in registers.
//     Masks are applied per element only in a warp's tiles that cross the
//     diagonal, the band's edge, kv_valid or sq; P = 2^(s scale log2(e) -
//     LSE log2(e)) in one MUFU instruction.
//   * Tiles: the dQ kernel takes 32 keys a tile (16 in f32 at dh 256:
//     shared memory); the dK/dV kernel 64 keys a block (32 at dqk >= 192)
//     and 64 streamed query rows in bf16 at dqk <= 128, else 32 rows (f32
//     at the LM train cell: 11.1 against 12.3 ms the pair with 64; bf16
//     dQ at dh 64: 1.06 against 1.32 ms with 64 keys; NVIDIA H100 80GB
//     HBM3, 700 W).
//
// Two bodies, chosen by the type (the Body traits below); no runtime
// fallback between them.  Each kernel is compiled twice, as the forward
// is: the kGeneral instance of a call with a query offset, a mask operand
// or rows with no key, and the one for every other call, compiled with
// q_offset 0, no mask and no no-key rule.
//   bf16: mma.sync m16n8k16, bf16 in, f32 accumulate; fragments read with
//     ldmatrix (.trans for an operand whose k runs down its rows: dO, Q
//     and K as the B of dV, dK and dQ).  Shared rows are padded by 16
//     bytes.  Roundings beside the plain version's all-f32 arithmetic:
//     P is rounded to bf16 before dV += P^T dO (the forward's cast of p
//     before P . V), and dS is rounded to bf16 before it multiplies K
//     (dQ) or Q (dK); D, P and dS - before that rounding - are f32.
//   f32: mma.sync m16n8k8 .tf32 with the 3xTF32 split of both operands:
//     hi = x rounded to TF32, lo = (x - hi) rounded to TF32 (the bits of
//     cvt.rna.tf32.f32, computed with an integer add and mask: the cvt
//     runs on a slow pipe, and the split made the kernels 1.3x slower
//     with it), a . b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b in f32 (the
//     dropped lo_a lo_b and the rounding of lo are ~2^-21 of a product);
//     one-pass TF32 (~2^-11) would break the 2e-5 gate.  The operands a
//     block keeps for its whole walk (Q and dO in the dQ kernel, K and V
//     in the dK/dV kernel) are split once into hi and lo planes in shared
//     memory at dqk <= 128 (4-9% faster than splitting them for every
//     tile); the streamed ones are split as they are read.  Each tile's
//     dQ, dK and dV product is summed in a fresh accumulator and added to
//     the running sum in f32 (mma_add: the tensor cores' accumulation
//     truncates).  Shared rows are f32, padded by 4 floats, read with
//     scalar loads free of bank conflicts.  The k index of a product
//     whose A comes from accumulators (P, dS) is permuted within each
//     8-step (slot t <-> 2t, t + 4 <-> 2t + 1), so that the accumulator
//     fragment is the A fragment without shuffles.
#include <cstdint>

#include <cuda_bf16.h>

#include "flash_mma.cuh"
#include "search_common.cuh"

namespace {

// 4 bytes from src to shared dst; with src_bytes = 0 dst is zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// ---------------------------------------------------- the two bodies ----
//
// A product acc (16 x N) += A (16 x K) . B (K x N) in steps of kK along
// K; A is read from shared rows (load_a: 16 rows, k along each row) or
// taken from accumulator fragments (a_from_acc: k = the accumulator's
// columns); B is read two n8 tiles at a time, from rows that each hold
// one n (load_b_rows: k along the row) or one k (load_b_cols: n along the
// row).  Fragment lane g = lane / 4 holds rows g and g + 8, t = lane % 4
// columns 2t and 2t + 1 of each n8 accumulator tile.

template <typename T>
struct Body;

template <>
struct Body<__nv_bfloat16> {
  using E = __nv_bfloat16;
  static constexpr int kPad = 8;   // elements a shared row is padded by
  static constexpr int kK = 16;
  static constexpr bool kFreshSums = false;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[4]; };     // n8 tile 0: r[0..1], tile 1: r[2..3]

  static __device__ __forceinline__ void load_a(A& a, const E* rows, int ld,
                                                int kk) {
    const int lane = threadIdx.x % 32;
    ldmatrix_x4(a.r, smem_addr(rows + (lane % 16) * ld + (lane / 16) * 8 +
                               kk * 16));
  }
  static __device__ __forceinline__ void load_b_rows(B& b, const E* rows,
                                                     int ld, int kk) {
    const int lane = threadIdx.x % 32;
    ldmatrix_x4(b.r, smem_addr(rows + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                               ((lane >> 3) & 1) * 8 + kk * 16));
  }
  static __device__ __forceinline__ void load_b_cols(B& b, const E* rows,
                                                     int ld, int kk, int n0) {
    const int lane = threadIdx.x % 32;
    ldmatrix_x4_trans(
        b.r, smem_addr(rows + ((lane & 7) + (((lane >> 3) & 1) << 3) +
                               kk * 16) * ld + (lane >> 4) * 8 + n0));
  }
  // k-step kk takes accumulator tiles 2 kk and 2 kk + 1, rounded to bf16
  template <int N>
  static __device__ __forceinline__ void a_from_acc(A& a,
                                                    const float (&c)[N][4],
                                                    int kk) {
    a.r[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a.r[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a.r[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a.r[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b, int half) {
    mma_bf16(c, a.r, b.r[2 * half], b.r[2 * half + 1]);
  }
  static __device__ __forceinline__ void store2(E* dst, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
  static __device__ __forceinline__ float widen(E x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ E narrow(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Body<float> {
  using E = float;
  static constexpr int kPad = 4;   // row stride = 4 mod 32 words
  static constexpr int kK = 8;
  static constexpr bool kFreshSums = true;
  using A = Tf32Frag;
  using B = Tf32Frag;   // tile 0: [0..1], tile 1: [2..3]

  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
  static __device__ __forceinline__ void load_a(A& a, const E* rows, int ld,
                                                int kk) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const E* p = rows + g * ld + kk * 8 + t;
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
    split_tf32(p[4], a.hi[2], a.lo[2]);
    split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  // the same from rows already split by split_rows (hi in place, lo in a
  // plane of the same layout)
  static __device__ __forceinline__ void load_a_split(A& a, const E* hi,
                                                      const E* lo, int ld,
                                                      int kk) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int o[4] = {g * ld + kk * 8 + t, (g + 8) * ld + kk * 8 + t,
                      g * ld + kk * 8 + t + 4, (g + 8) * ld + kk * 8 + t + 4};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.hi[i] = __float_as_uint(hi[o[i]]);
      a.lo[i] = __float_as_uint(lo[o[i]]);
    }
  }
  // b0 (k t, n g), b1 (k t + 4, n g); n = a row
  static __device__ __forceinline__ void load_b_rows(B& b, const E* rows,
                                                     int ld, int kk) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const E* p = rows + (8 * i + g) * ld + kk * 8 + t;
      split_tf32(p[0], b.hi[2 * i], b.lo[2 * i]);
      split_tf32(p[4], b.hi[2 * i + 1], b.lo[2 * i + 1]);
    }
  }
  // the permuted k: slot t <-> row 2t, slot t + 4 <-> row 2t + 1
  static __device__ __forceinline__ void load_b_cols(B& b, const E* rows,
                                                     int ld, int kk, int n0) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const E* p = rows + (kk * 8 + 2 * t) * ld + n0 + 8 * i + g;
      split_tf32(p[0], b.hi[2 * i], b.lo[2 * i]);
      split_tf32(p[ld], b.hi[2 * i + 1], b.lo[2 * i + 1]);
    }
  }
  // k-step kk is accumulator tile kk: (g, 2t) -> slot t, (g, 2t + 1) ->
  // slot t + 4, the same for row g + 8
  template <int N>
  static __device__ __forceinline__ void a_from_acc(A& a,
                                                    const float (&c)[N][4],
                                                    int kk) {
    split_tf32(c[kk][0], a.hi[0], a.lo[0]);
    split_tf32(c[kk][2], a.hi[1], a.lo[1]);
    split_tf32(c[kk][1], a.hi[2], a.lo[2]);
    split_tf32(c[kk][3], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b, int half) {
    mma_3xtf32(c, a, b, half);
  }
  static __device__ __forceinline__ void store2(E* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  }
  static __device__ __forceinline__ float widen(E x) { return x; }
  static __device__ __forceinline__ E narrow(float x) { return x; }
};

// acc[2 NP][4] += A . B over KS k-steps: load_a(a, kk) fills the A
// fragment of step kk, load_b(b, kk, np) the B fragments of n8 tiles
// 2 np and 2 np + 1.
template <class Bd, int KS, int NP, class FA, class FB>
__device__ __forceinline__ void mma_loop(float (&acc)[2 * NP][4], FA load_a,
                                         FB load_b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    typename Bd::A a;
    load_a(a, kk);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      typename Bd::B bb;
      load_b(bb, kk, np);
      Bd::mma(acc[2 * np], a, bb, 0);
      Bd::mma(acc[2 * np + 1], a, bb, 1);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
}

// A gradient's running sum += one tile's product.  The tensor cores'
// f32 accumulation truncates, so over the thousands of steps of a long
// sum (dK and dV: G heads x sq queries) its error grows with their
// count: at the LM train cell (16,384 queries a key) 1e-4 of dK's and
// dV's largest magnitude, past the f32 gate.  With kFreshSums (f32) each
// tile's product starts from zero (a few dozen steps) and is added to
// the running sum with a rounded f32 add.
template <class Bd, int KS, int NP, class FA, class FB>
__device__ __forceinline__ void mma_add(float (&acc)[2 * NP][4], FA load_a,
                                        FB load_b) {
  if constexpr (Bd::kFreshSums) {
    float part[2 * NP][4];
    zero(part);
    mma_loop<Bd, KS, NP>(part, load_a, load_b);
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
  } else {
    mma_loop<Bd, KS, NP>(acc, load_a, load_b);
  }
}

// Split W columns of rows [0, ROWS) of hi (row stride LD) into TF32 hi,
// in place, and lo, into the plane lo of the same layout, by NT threads:
// an A operand that stays in shared memory for the whole block is split
// once, not again for every tile that reads it.
template <int W, int LD, int ROWS, int NT>
__device__ __forceinline__ void split_rows(float* hi, float* lo) {
  for (int e = threadIdx.x; e < ROWS * W; e += NT) {
    const int i = (e / W) * LD + e % W;
    uint32_t h, l;
    split_tf32(hi[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// The forward's static masks and the mask operand of one call.  Query
// row i sits at position i + q_offset; keys at their index.
struct Masks {
  int sq, kv_end, window, q_offset;
  bool causal;
  MaskArg op;
};

// The query offset an instance reads: the call's in the kGeneral one, 0
// in the other (Masks is read, never written: writing a field of a
// by-value struct parameter copies the struct out of the parameter space,
// which cost the f32 dK/dV kernels 8-24 bytes of spills a thread).
template <bool kGeneral>
__device__ __forceinline__ int offset_of(const Masks& m) {
  return kGeneral ? m.q_offset : 0;
}

// Whether query row `row` of head h, batch b sees key kpos under the
// forward's masks (and both lie inside the operands: kv_end <= sk).
template <bool kGeneral>
__device__ __forceinline__ bool visible(const Masks& m, int b, int h,
                                        int row, int kpos) {
  const int qpos = row + offset_of<kGeneral>(m);
  return row < m.sq && kpos < m.kv_end && !(m.causal && qpos < kpos) &&
         !(m.window > 0 && qpos - kpos >= m.window) &&
         (!kGeneral || mask_keeps(m.op, b, h, row, kpos));
}

// Whether a tile of query rows [q0, q0 + nq) and keys [k0, k0 + nk) holds
// a pair that visible() drops: always under the mask operand.
template <bool kGeneral>
__device__ __forceinline__ bool needs_mask(const Masks& m, int q0, int nq,
                                           int k0, int nk) {
  const int qp0 = q0 + offset_of<kGeneral>(m);   // the first row's position
  return (kGeneral && m.op.p != nullptr) || q0 + nq > m.sq ||
         k0 + nk > m.kv_end ||
         (m.causal && k0 + nk - 1 > qp0) ||
         (m.window > 0 && qp0 + nq - 1 - k0 >= m.window);
}

// -------------------------------------------------------- dQ and D ----

template <typename T, int DQK, int DV>
struct DqGeometry {
  using Bd = Body<T>;
  using E = typename Bd::E;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;             // query rows a block
  static constexpr int kBK = (kF32 && DQK == 256) ? 16 : 32;  // keys a tile
  static constexpr int kLdK = DQK + Bd::kPad, kLdV = DV + Bd::kPad;
  // Q's and dO's A fragments in registers (bf16, dqk <= 64), or split
  // once into TF32 hi and lo planes (f32, dqk <= 128: shared memory)
  static constexpr bool kAInRegs = !kF32 && DQK <= 64;
  static constexpr bool kPreSplit = kF32 && DQK <= 128;
  static constexpr int kTileK = kBK * kLdK, kTileV = kBK * kLdV;
  // Q, dO, two stages of K and of V, LSE and D of the rows, then the lo
  // planes of Q and dO
  static constexpr size_t kSmemLo =
      kPreSplit ? sizeof(E) * size_t(kBQ) * (kLdK + kLdV) : 0;
  static constexpr size_t kSmem =
      sizeof(E) * (size_t(kBQ) * (kLdK + kLdV) + 2 * size_t(kTileK + kTileV)) +
      sizeof(float) * 2 * kBQ + kSmemLo;
};

// At least one block an SM: ptxas may then take up to 255 registers a
// thread.  Without the minimum it held the f32 kernels at 131 / 168
// registers at the LM train cell, and the pair ran in 12.50 ms against
// 10.73 (NVIDIA H100 80GB HBM3, 700 W).
// kGeneral: the instance of a call with a query offset, a mask operand or
// rows with no key (general_instance); the other takes q_offset as 0.
template <typename T, int DQK, int DV, bool kGeneral>
__global__ void __launch_bounds__(DqGeometry<T, DQK, DV>::kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ dbuf, int sk, int H, int KVH,
                    float scale, Masks mk) {
  using G = DqGeometry<T, DQK, DV>;
  using Bd = typename G::Bd;
  using E = typename G::E;
  constexpr int kBQ = G::kBQ, kBK = G::kBK, kLdK = G::kLdK, kLdV = G::kLdV;
  constexpr int kK = Bd::kK;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  E* q_sm = reinterpret_cast<E*>(dq_smem);         // kBQ x kLdK
  E* o_sm = q_sm + kBQ * kLdK;                     // dO: kBQ x kLdV
  E* k_sm = o_sm + kBQ * kLdV;                     // 2 stages
  E* v_sm = k_sm + 2 * G::kTileK;                  // 2 stages
  float* lse_s = reinterpret_cast<float*>(v_sm + 2 * G::kTileV);
  float* d_s = lse_s + kBQ;
  E* q_lo = reinterpret_cast<E*>(d_s + kBQ);       // kPreSplit: kBQ x kLdK
  E* o_lo = q_lo + kBQ * kLdK;                     // kBQ x kLdV

  const int sq = mk.sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_stride = long(H) * DQK, k_stride = long(KVH) * DQK;
  const long v_stride = long(KVH) * DV, o_stride = long(H) * DV;
  const long row_stat = (long(b) * H + h) * sq;   // LSE / D of the head
  const T* q_head = q + long(b) * sq * q_stride + long(h) * DQK;
  const T* do_head = dout + long(b) * sq * o_stride + long(h) * DV;
  const T* o_head = o + long(b) * sq * o_stride + long(h) * DV;
  const T* k_head = k + long(b) * sk * k_stride + long(kvh) * DQK;
  const T* v_head = v + long(b) * sk * v_stride + long(kvh) * DV;

  // the forward's key tiles of this query tile: up to the one holding
  // its last row's position (none when that is before key 0), from the
  // one holding the first key of its first row's band
  const int q_offset = offset_of<kGeneral>(mk);
  int n_kt = (mk.kv_end + kBK - 1) / kBK;
  if (mk.causal) {
    const int last = min(q0 + kBQ, sq) - 1 + q_offset;
    n_kt = last < 0 ? 0 : min(n_kt, last / kBK + 1);
  }
  const int kt0 =
      mk.window > 0 ? max(0, q0 + q_offset - mk.window + 1) / kBK : 0;

  auto load_kv = [&](int kt, int st) {
    load_rows<E, DQK, kLdK, kBK, G::kThreads>(
        k_sm + st * G::kTileK, k_head, kt * kBK, sk, k_stride);
    load_rows<E, DV, kLdV, kBK, G::kThreads>(
        v_sm + st * G::kTileV, v_head, kt * kBK, sk, v_stride);
  };
  load_rows<E, DQK, kLdK, kBQ, G::kThreads>(q_sm, q_head, q0, sq, q_stride);
  load_rows<E, DV, kLdV, kBQ, G::kThreads>(o_sm, do_head, q0, sq, o_stride);
  if (kt0 < n_kt) load_kv(kt0, 0);
  cp_async_commit();

  // D = rowsum(dO o O) from device memory: one warp a row, lanes over
  // the columns; written for the dK / dV kernel
  for (int r = warp; r < kBQ; r += G::kWarps) {
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < sq)
      for (int c = lane; c < DV; c += 32)
        acc = __fmaf_rn(Bd::widen(do_head[long(row) * o_stride + c]),
                        Bd::widen(o_head[long(row) * o_stride + c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      d_s[r] = acc;
      lse_s[r] = row < sq ? lse[row_stat + row] : 0.0f;
      if (row < sq) dbuf[row_stat + row] = acc;
    }
  }
  __syncthreads();
  const int row_w = q0 + warp * 16;                 // the warp's first row
  const int rows[2] = {row_w + g, row_w + g + 8};
  float lse2[2], dd[2];                              // LSE log2(e), D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_s[warp * 16 + g + 8 * i] * kLog2e;
    dd[i] = d_s[warp * 16 + g + 8 * i];
  }
  const E* q_w = q_sm + warp * 16 * kLdK;
  const E* o_w = o_sm + warp * 16 * kLdV;
  const E* q_lo_w = q_lo + warp * 16 * kLdK;
  const E* o_lo_w = o_lo + warp * 16 * kLdV;
  typename Bd::A qf[G::kAInRegs ? DQK / kK : 1], of[G::kAInRegs ? DV / kK : 1];
  if constexpr (G::kAInRegs) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DQK / kK; ++kk) Bd::load_a(qf[kk], q_w, kLdK, kk);
#pragma unroll
    for (int kk = 0; kk < DV / kK; ++kk) Bd::load_a(of[kk], o_w, kLdV, kk);
  }
  if constexpr (G::kPreSplit) {   // read after the loop's first barrier
    cp_async_wait<0>();
    __syncthreads();
    split_rows<DQK, kLdK, kBQ, G::kThreads>(q_sm, q_lo);
    split_rows<DV, kLdV, kBQ, G::kThreads>(o_sm, o_lo);
  }

  const float sl2 = scale * kLog2e;
  float acc[DQK / 8][4];
  zero(acc);
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int st = (kt - kt0) & 1;
    if (kt + 1 < n_kt) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile kt (and Q, dO)
    __syncthreads();
    const E* ks = k_sm + st * G::kTileK;
    const E* vs = v_sm + st * G::kTileV;

    float s[kBK / 8][4];    // S, then P
    zero(s);
    mma_loop<Bd, DQK / kK, kBK / 16>(
        s,
        [&](typename Bd::A& a, int kk) {
          if constexpr (G::kAInRegs) a = qf[kk];
          else if constexpr (G::kPreSplit)
            Bd::load_a_split(a, q_w, q_lo_w, kLdK, kk);
          else Bd::load_a(a, q_w, kLdK, kk);
        },
        [&](typename Bd::B& bb, int kk, int np) {
          Bd::load_b_rows(bb, ks + np * 16 * kLdK, kLdK, kk);
        });
    const bool mask = needs_mask<kGeneral>(mk, row_w, 16, k0, kBK);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(__fmaf_rn(s[nt][e], sl2, -lse2[e >> 1]));
        if (mask && !visible<kGeneral>(mk, b, h, rows[e >> 1],
                                    k0 + nt * 8 + 2 * t + (e & 1)))
          p = 0.0f;
        s[nt][e] = p;
      }

    float dp[kBK / 8][4];   // dP, then dS
    zero(dp);
    mma_loop<Bd, DV / kK, kBK / 16>(
        dp,
        [&](typename Bd::A& a, int kk) {
          if constexpr (G::kAInRegs) a = of[kk];
          else if constexpr (G::kPreSplit)
            Bd::load_a_split(a, o_w, o_lo_w, kLdV, kk);
          else Bd::load_a(a, o_w, kLdV, kk);
        },
        [&](typename Bd::B& bb, int kk, int np) {
          Bd::load_b_rows(bb, vs + np * 16 * kLdV, kLdV, kk);
        });
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - dd[e >> 1]);

    mma_add<Bd, kBK / kK, DQK / 16>(
        acc,
        [&](typename Bd::A& a, int kk) { Bd::a_from_acc(a, dp, kk); },
        [&](typename Bd::B& bb, int kk, int np) {
          Bd::load_b_cols(bb, ks, kLdK, kk, np * 16);
        });
    __syncthreads();   // this stage consumed before it is refilled
  }
  cp_async_wait<0>();   // no copy outlives the block (no key tile: Q, dO)

  T* dq_head = dq + long(b) * sq * q_stride + long(h) * DQK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= sq) continue;
    T* dst = dq_head + long(rows[i]) * q_stride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DQK / 8; ++nt)
      Bd::store2(dst + nt * 8, __fmul_rn(acc[nt][2 * i], scale),
                 __fmul_rn(acc[nt][2 * i + 1], scale));
  }
}

// -------------------------------------------------------- dK and dV ----

template <typename T, int DQK, int DV>
struct DkdvGeometry {
  using Bd = Body<T>;
  using E = typename Bd::E;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kSlabs = DQK >= 192 ? 2 : 4;   // 16 keys each
  static constexpr int kSplit = DQK >= 192 ? 2 : 1;  // warps a slab
  static constexpr int kWarps = kSlabs * kSplit, kThreads = 32 * kWarps;
  static constexpr int kBK = 16 * kSlabs;            // keys a block
  static constexpr int kBQ = (kF32 || DQK >= 192) ? 32 : 64;  // streamed
  static constexpr int kCK = DQK / kSplit, kCV = DV / kSplit;   // a warp's
  static constexpr int kLdK = DQK + Bd::kPad, kLdV = DV + Bd::kPad;
  static constexpr int kTileQ = kBQ * kLdK, kTileO = kBQ * kLdV;
  // K and V split once into TF32 hi and lo planes (f32, dqk <= 128)
  static constexpr bool kPreSplit = kF32 && DQK <= 128;
  // K, V, two stages of Q and of dO, two stages of LSE and D, then the lo
  // planes of K and V
  static constexpr size_t kSmemLo =
      kPreSplit ? sizeof(E) * size_t(kBK) * (kLdK + kLdV) : 0;
  static constexpr size_t kSmem =
      sizeof(E) * (size_t(kBK) * (kLdK + kLdV) + 2 * size_t(kTileQ + kTileO)) +
      sizeof(float) * 2 * 2 * kBQ + kSmemLo;
};

template <typename T, int DQK, int DV, bool kGeneral>
__global__ void __launch_bounds__(DkdvGeometry<T, DQK, DV>::kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dbuf, T* __restrict__ dk,
                      T* __restrict__ dv, int sk, int H, int KVH,
                      float scale, Masks mk) {
  using G = DkdvGeometry<T, DQK, DV>;
  using Bd = typename G::Bd;
  using E = typename G::E;
  constexpr int kBQ = G::kBQ, kBK = G::kBK, kLdK = G::kLdK, kLdV = G::kLdV;
  constexpr int kK = Bd::kK;
  extern __shared__ __align__(16) unsigned char dkdv_smem[];
  E* k_sm = reinterpret_cast<E*>(dkdv_smem);       // kBK x kLdK
  E* v_sm = k_sm + kBK * kLdK;                     // kBK x kLdV
  E* q_sm = v_sm + kBK * kLdV;                     // 2 stages
  E* o_sm = q_sm + 2 * G::kTileQ;                  // dO: 2 stages
  float* stat = reinterpret_cast<float*>(o_sm + 2 * G::kTileO);  // LSE, D
  E* k_lo = reinterpret_cast<E*>(stat + 2 * 2 * kBQ);   // kPreSplit
  E* v_lo = k_lo + kBK * kLdK;

  const int sq = mk.sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int slab = warp % G::kSlabs, part = warp / G::kSlabs;
  const int k0 = int(blockIdx.x) * kBK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KVH;
  const long q_stride = long(H) * DQK, k_stride = long(KVH) * DQK;
  const long v_stride = long(KVH) * DV, o_stride = long(H) * DV;
  const long kvo = long(b) * sk;

  // the query tiles that see a key of [k0, k0 + kBK): under causal the
  // rows at positions from k0 on, under a window those at positions up to
  // k0 + kBK + window - 2; none when the tile lies past kv_valid
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q_offset = offset_of<kGeneral>(mk);
  const int qt0 = mk.causal ? max(0, k0 - q_offset) / kBQ : 0;
  int qt1 = n_qt;
  if (mk.window > 0) {
    const int last = k0 + kBK + mk.window - 2 - q_offset;
    qt1 = last < 0 ? 0 : min(qt1, last / kBQ + 1);
  }
  if (k0 >= mk.kv_end) qt1 = qt0;
  const int per_head = max(0, qt1 - qt0);
  const int n_it = group * per_head;   // (query head, query tile) in order

  float adk[G::kCK / 8][4], adv[G::kCV / 8][4];
  zero(adk);
  zero(adv);
  if constexpr (kGeneral) {
    // the rows that saw no key, first (before the walk's registers are
    // live): esum[w][c] = warp w's sum of their dO over the G query
    // heads, each warp taking runs of 32 (head, row) slots in order,
    // lanes testing one slot each, in the Q stages; dV starts at their
    // sum times 1 / sk
    constexpr int kC = (DV + 31) / 32;
    float* esum = reinterpret_cast<float*>(q_sm);   // kWarps x DV
    float part_e[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) part_e[c] = 0.0f;
    const long stat0 = (long(b) * H + long(kvh) * group) * sq;
    for (int base = warp * 32; base < group * sq; base += G::kWarps * 32) {
      const int slot = base + lane;
      unsigned run = __ballot_sync(
          0xffffffffu, slot < group * sq && lse[stat0 + slot] < kEmptyLse);
      while (run) {
        const int at = base + __ffs(run) - 1;   // slot = head * sq + row
        run &= run - 1;
        const T* src = dout + (long(b) * sq + at % sq) * o_stride +
                       long(kvh * group + at / sq) * DV;
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (lane + 32 * c < DV) part_e[c] += Bd::widen(src[lane + 32 * c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (lane + 32 * c < DV) esum[warp * DV + lane + 32 * c] = part_e[c];
    __syncthreads();
    // dV_j = (1 / sk in the operands' type) * sum, for this thread's keys
    const float r = Bd::widen(Bd::narrow(1.0f / float(sk)));
#pragma unroll
    for (int nt = 0; nt < G::kCV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = part * G::kCV + nt * 8 + 2 * t + e;
        float sum = 0.0f;
        for (int w = 0; w < G::kWarps; ++w) sum += esum[w * DV + col];
        adv[nt][e] = r * sum;
        adv[nt][2 + e] = r * sum;
      }
    __syncthreads();   // esum read before the Q stages are filled
  }

  load_rows<E, DQK, kLdK, kBK, G::kThreads>(
      k_sm, k + kvo * k_stride + long(kvh) * DQK, k0, sk, k_stride);
  load_rows<E, DV, kLdV, kBK, G::kThreads>(
      v_sm, v + kvo * v_stride + long(kvh) * DV, k0, sk, v_stride);
  cp_async_commit();
  auto prefetch = [&](int it, int st) {   // Q, dO, LSE and D of iteration it
    const int h = kvh * group + it / per_head;
    const int q0 = (qt0 + it % per_head) * kBQ;
    const long qo = long(b) * sq;
    load_rows<E, DQK, kLdK, kBQ, G::kThreads>(
        q_sm + st * G::kTileQ, q + qo * q_stride + long(h) * DQK, q0, sq,
        q_stride);
    load_rows<E, DV, kLdV, kBQ, G::kThreads>(
        o_sm + st * G::kTileO, dout + qo * o_stride + long(h) * DV, q0, sq,
        o_stride);
    const long row_stat = (long(b) * H + h) * sq;
    float* dst = stat + st * 2 * kBQ;
    for (int r = threadIdx.x; r < kBQ; r += G::kThreads) {
      const bool in = q0 + r < sq;
      const long at = row_stat + (in ? q0 + r : 0);
      cp_async4(smem_addr(dst + r), lse + at, in ? 4 : 0);
      cp_async4(smem_addr(dst + kBQ + r), dbuf + at, in ? 4 : 0);
    }
  };
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();
  if constexpr (G::kPreSplit) {   // read after the loop's first barrier
    cp_async_wait<1>();   // K and V
    __syncthreads();
    split_rows<DQK, kLdK, kBK, G::kThreads>(k_sm, k_lo);
    split_rows<DV, kLdV, kBK, G::kThreads>(v_sm, v_lo);
  }

  const E* k_w = k_sm + slab * 16 * kLdK;
  const E* v_w = v_sm + slab * 16 * kLdV;
  const E* k_lo_w = k_lo + slab * 16 * kLdK;
  const E* v_lo_w = v_lo + slab * 16 * kLdV;
  const int key_w = k0 + slab * 16;                 // the warp's first key
  const int keys[2] = {key_w + g, key_w + g + 8};
  const float sl2 = scale * kLog2e;
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) prefetch(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // iteration it (and K, V)
    __syncthreads();
    const int q0 = (qt0 + it % per_head) * kBQ;
    const int h = kvh * group + it / per_head;
    const E* qs = q_sm + st * G::kTileQ;
    const E* os = o_sm + st * G::kTileO;
    const float* lse_s = stat + st * 2 * kBQ;
    const float* d_s = lse_s + kBQ;

    float s[kBQ / 8][4];   // S^T (keys x queries), then P^T
    zero(s);
    mma_loop<Bd, DQK / kK, kBQ / 16>(
        s,
        [&](typename Bd::A& a, int kk) {
          if constexpr (G::kPreSplit)
            Bd::load_a_split(a, k_w, k_lo_w, kLdK, kk);
          else Bd::load_a(a, k_w, kLdK, kk);
        },
        [&](typename Bd::B& bb, int kk, int np) {
          Bd::load_b_rows(bb, qs + np * 16 * kLdK, kLdK, kk);
        });
    const bool mask = needs_mask<kGeneral>(mk, q0, kBQ, key_w, 16);
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);     // query in the tile
        float p = ex2(__fmaf_rn(s[nt][e], sl2, -lse_s[c] * kLog2e));
        if (mask && !visible<kGeneral>(mk, b, h, q0 + c, keys[e >> 1]))
          p = 0.0f;
        s[nt][e] = p;
      }

    // dV += P^T dO over this warp's columns
    mma_add<Bd, kBQ / kK, G::kCV / 16>(
        adv,
        [&](typename Bd::A& a, int kk) { Bd::a_from_acc(a, s, kk); },
        [&](typename Bd::B& bb, int kk, int np) {
          Bd::load_b_cols(bb, os, kLdV, kk, part * G::kCV + np * 16);
        });

    float dp[kBQ / 8][4];  // dP^T, then dS^T
    zero(dp);
    mma_loop<Bd, DV / kK, kBQ / 16>(
        dp,
        [&](typename Bd::A& a, int kk) {
          if constexpr (G::kPreSplit)
            Bd::load_a_split(a, v_w, v_lo_w, kLdV, kk);
          else Bd::load_a(a, v_w, kLdV, kk);
        },
        [&](typename Bd::B& bb, int kk, int np) {
          Bd::load_b_rows(bb, os + np * 16 * kLdV, kLdV, kk);
        });
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - d_s[nt * 8 + 2 * t + (e & 1)]);

    // dK += dS^T Q over this warp's columns
    mma_add<Bd, kBQ / kK, G::kCK / 16>(
        adk,
        [&](typename Bd::A& a, int kk) { Bd::a_from_acc(a, dp, kk); },
        [&](typename Bd::B& bb, int kk, int np) {
          Bd::load_b_cols(bb, qs, kLdK, kk, part * G::kCK + np * 16);
        });
    __syncthreads();   // this stage consumed before it is refilled
  }
  cp_async_wait<0>();   // no copy outlives the block (no query tile: K, V)

  T* dk_head = dk + kvo * k_stride + long(kvh) * DQK + part * G::kCK;
  T* dv_head = dv + kvo * v_stride + long(kvh) * DV + part * G::kCV;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= sk) continue;
    T* dst = dk_head + long(keys[i]) * k_stride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < G::kCK / 8; ++nt)
      Bd::store2(dst + nt * 8, __fmul_rn(adk[nt][2 * i], scale),
                 __fmul_rn(adk[nt][2 * i + 1], scale));
    dst = dv_head + long(keys[i]) * v_stride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < G::kCV / 8; ++nt)
      Bd::store2(dst + nt * 8, adv[nt][2 * i], adv[nt][2 * i + 1]);
  }
}

// ---------------------------------------------------------- launches ----

// kernel 0: dQ and D; kernel 1: dK and dV (after kernel 0: reads D)
template <typename T, int DQK, int DV, bool kGeneral>
int launch_bwd(int which, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const void* lse, void* dq,
               void* dk, void* dv, void* dbuf, int b, int sk, int H, int KVH,
               float scale, const Masks& mk, cudaStream_t stream) {
  const int sq = mk.sq;
  if (which == 0) {
    using G = DqGeometry<T, DQK, DV>;
    const int n_qt = (sq + G::kBQ - 1) / G::kBQ;
    if (H > 65535) return int(cudaErrorInvalidValue);
    auto kernel = flash_bwd_dq_kernel<T, DQK, DV, kGeneral>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::kSmem));
    if (e != cudaSuccess) return int(e);
    kernel<<<dim3(unsigned(n_qt), unsigned(H), unsigned(b)), G::kThreads,
             G::kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<T*>(dq), static_cast<float*>(dbuf), sk, H, KVH, scale,
        mk);
    return int(cudaGetLastError());
  }
  using G = DkdvGeometry<T, DQK, DV>;
  const int n_kt = (sk + G::kBK - 1) / G::kBK;
  if (KVH > 65535) return int(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dkdv_kernel<T, DQK, DV, kGeneral>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::kSmem));
  if (e != cudaSuccess) return int(e);
  kernel<<<dim3(unsigned(n_kt), unsigned(KVH), unsigned(b)), G::kThreads,
           G::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dbuf),
      static_cast<T*>(dk), static_cast<T*>(dv), sk, H, KVH, scale, mk);
  return int(cudaGetLastError());
}

template <int DQK, int DV, bool kGeneral>
int launch_bwd_dtype(int dtype, int which, const void* q, const void* k,
                     const void* v, const void* o, const void* dout,
                     const void* lse, void* dq, void* dk, void* dv,
                     void* dbuf, int b, int sk, int H, int KVH, float scale,
                     const Masks& mk, cudaStream_t s) {
  if (dtype == 0)
    return launch_bwd<float, DQK, DV, kGeneral>(which, q, k, v, o, dout, lse,
                                                dq, dk, dv, dbuf, b, sk, H,
                                                KVH, scale, mk, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, DQK, DV, kGeneral>(
        which, q, k, v, o, dout, lse, dq, dk, dv, dbuf, b, sk, H, KVH, scale,
        mk, s);
  return int(cudaErrorInvalidValue);
}

template <int DQK, int DV>
int launch_bwd_pair(int dtype, int which, const void* q, const void* k,
                    const void* v, const void* o, const void* dout,
                    const void* lse, void* dq, void* dk, void* dv, void* dbuf,
                    int b, int sk, int H, int KVH, float scale,
                    const Masks& mk, cudaStream_t s) {
  if (general_instance(mk.op.p != nullptr, mk.window, mk.q_offset, mk.sq,
                       sk))
    return launch_bwd_dtype<DQK, DV, true>(dtype, which, q, k, v, o, dout,
                                           lse, dq, dk, dv, dbuf, b, sk, H,
                                           KVH, scale, mk, s);
  return launch_bwd_dtype<DQK, DV, false>(dtype, which, q, k, v, o, dout, lse,
                                          dq, dk, dv, dbuf, b, sk, H, KVH,
                                          scale, mk, s);
}

template <typename T, int DQK, int DV, bool kGeneral>
cudaError_t bwd_kernel_attributes(int which, cudaFuncAttributes* attr) {
  return which == 0
             ? cudaFuncGetAttributes(attr,
                                     flash_bwd_dq_kernel<T, DQK, DV, kGeneral>)
             : cudaFuncGetAttributes(
                   attr, flash_bwd_dkdv_kernel<T, DQK, DV, kGeneral>);
}

template <int DQK, int DV>
cudaError_t bwd_attributes(int dtype, int which, int general,
                           cudaFuncAttributes* attr) {
  if (dtype == 0)
    return general ? bwd_kernel_attributes<float, DQK, DV, true>(which, attr)
                   : bwd_kernel_attributes<float, DQK, DV, false>(which, attr);
  if (dtype == 1)
    return general
               ? bwd_kernel_attributes<__nv_bfloat16, DQK, DV, true>(which,
                                                                      attr)
               : bwd_kernel_attributes<__nv_bfloat16, DQK, DV, false>(which,
                                                                       attr);
  return cudaErrorInvalidValue;
}

// The compiled (dqk, dv) pairs, each as one case value.
constexpr int pair(int dqk, int dv) { return dqk * 1024 + dv; }

}  // namespace

extern "C" {

// The backward of icq_flash_attention with the same operands, masks and
// types: which 0 launches the dQ kernel (dq (b, sq, H, dqk), and D
// (b, H, sq) f32 into dbuf), which 1 the dK/dV kernel (dk (b, sk, KVH,
// dqk), dv (b, sk, KVH, dv); reads dbuf, so it runs after which 0 on the
// stream).  o and dout (b, sq, H, dv) of the type, lse (b, H, sq) f32 from
// the forward; dtype 0 = f32 (3xTF32 body), 1 = bf16; every pointer
// 16-byte aligned (but the mask's); q_offset and the mask operand (null,
// or uint8 by four element strides) as in icq_flash_attention.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another shape or type.
int icq_flash_attention_bwd(int which, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const void* lse, void* dq, void* dk, void* dv,
                            void* dbuf, int dtype, int b, int sq, int sk,
                            int H, int KVH, int dqk, int dvw, float scale,
                            int causal, int window, int kv_valid,
                            int q_offset, const void* mask, long long mask_b,
                            long long mask_h, long long mask_q,
                            long long mask_k, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || H < 1 || KVH < 1 || H % KVH != 0 ||
      b > 65535 || window < 0 || kv_valid < 0 || kv_valid > sk ||
      (kv_valid > 0 && (causal != 0 || window > 0 || mask != nullptr)) ||
      q_offset > (1 << 30) || q_offset < -(1 << 30) ||
      (which != 0 && which != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Masks mk{sq, kv_valid > 0 ? kv_valid : sk, window, q_offset,
                 causal != 0,
                 MaskArg{static_cast<const uint8_t*>(mask), mask_b, mask_h,
                         mask_q, mask_k}};
  switch (pair(dqk, dvw)) {
#define ICQ_FLASH_CASE(DQK, DV)                                             \
  case pair(DQK, DV):                                                       \
    return launch_bwd_pair<DQK, DV>(dtype, which, q, k, v, o, dout, lse,    \
                                    dq, dk, dv, dbuf, b, sk, H, KVH, scale, \
                                    mk, s);
    ICQ_FLASH_CASE(32, 32)
    ICQ_FLASH_CASE(64, 64)
    ICQ_FLASH_CASE(128, 128)
    ICQ_FLASH_CASE(256, 256)
    ICQ_FLASH_CASE(192, 128)
#undef ICQ_FLASH_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

// Registers and local-memory bytes per thread of backward kernel `which`
// (0 = dQ, 1 = dK/dV) for dtype and (dqk, dv), the kGeneral instance (a call
// with an offset, a mask or rows with no key) when general is nonzero.
int icq_flash_attention_bwd_attributes(int dtype, int which, int dqk, int dv,
                                       int general, int* regs,
                                       int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (pair(dqk, dv)) {
#define ICQ_FLASH_CASE(DQK, DV)                                  \
  case pair(DQK, DV):                                            \
    e = bwd_attributes<DQK, DV>(dtype, which, general, &attr);   \
    break;
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
