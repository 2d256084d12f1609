// Flash attention for Hopper (sm_90a): the forward.  Its backward is
// flash_attention_bwd.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
//   icq_flash_attention  <- flash_attention_pallas (_flash_kernel), with
//                           the GQA head folding of ops.flash_attention;
//                           optionally also writes each row's log-sum-exp
//                           (the Pallas kernel's m and l outputs), which
//                           the backward reads
//
// q (b, sq, H, dqk), k (b, sk, KVH, dqk) and v (b, sk, KVH, dv), f32 or
// bf16, H a multiple of KVH; query head h reads key/value head h / (H /
// KVH).  The compiled (dqk, dv) pairs: (32, 32), (64, 64), (128, 128),
// (256, 256) and DeepSeek-V2's MLA prefill, (192, 128): 128 nope + 64
// rope dims of q and k, 128 of v.  The output is (b, sq, H, dv).  For
// every query row, over key tiles in order, with running max m and sum l
// in f32:
//   s    = (q . k^T in f32) * scale            scale = dqk ** -0.5
//   s    = NEG_INF = -1e30 where causal and q_pos < k_pos, with q_pos =
//          row + q_offset and k_pos = key (q_offset 0: top-left aligned,
//          also when sq != sk; sk - sq: bottom-right, the triangular
//          scan's prefix keys), and where window > 0 and q_pos - k_pos >=
//          window (the sliding band of the hybrid's local layers; window
//          0 = none), and where kv_valid > 0 and k_pos >= kv_valid (the
//          key-padding bound of the reference's padded cross attention; 0
//          = none, and only in a non-causal call with no window and no
//          mask operand), and where the mask operand (optional, uint8,
//          (b, H, sq, sk) by element strides, MaskArg) is 0
//   m'   = max(m, max_j s);  corr = exp(m - m');  p = exp(s - m')
//   l    = l * corr + sum_j p                  (p unrounded)
//   o    = o * corr + (p cast to v's type) . v     (f32 sums)
// and out = o / max(l, 1e-30) cast to v's type.  Key tiles wholly above
// the diagonal are skipped, and so are those wholly left of the band: a
// block's key loop starts at the tile holding q0 + q_offset - window + 1,
// the first key its first row keeps; under kv_valid the loop ends at the
// tile holding key kv_valid - 1, so fully padded tiles are never read (sk
// stays the row count of the loads and the batch stride: a padded tensor
// is read in place).  The mask operand skips no tile: a tile is skipped
// only where the static masks skip it, and every element of every other
// tile reads it.  Key rows past sk (the ragged last tile) get s = -inf
// and contribute exactly 0.  The finite NEG_INF keeps a row that sees
// only masked keys in a tile free of NaN, as in the reference; a row may
// see only masked keys in its first tiles, and its first unmasked tile's
// correction exp(NEG_INF - m) = 0 clears what they added.  A row that
// sees no key at all (m still NEG_INF after the loop) takes the
// reference's uniform softmax (flash_mma.cuh, kEmptyLse): the mean of V
// over all sk keys, summed in f32 from device memory, lse NEG_INF.
//
// What bounds it on this card: operations.  Causal attention at s = 4096
// does 2 (dqk + dv) H s (s + 1) / 2 operations: 0.55e12 for
// llama3-405b's 128 heads of 128 (0.56 ms at the 989 TFLOP/s of bf16
// tensor cores) and 0.07e12 for tinyllama's 32 heads of 64 (0.07 ms in
// bf16; in f32 0.42 ms at the 165 TFLOP/s that 3xTF32 leaves of the 495
// TFLOP/s TF32 peak, 1.0 ms at the 67 TFLOP/s of f32 FMAs), against 0.3
// GB and 0.08 GB of q, k, v and out; the LM train cell's (tinyllama, f32,
// 8 x 2048) does 0.14e12 (0.83 ms at 3xTF32's rate) against 0.13 GB
// (0.04 ms).  DeepSeek-V2's 128 MLA heads at s = 2048 do 0.17e12 (0.17
// ms) against 0.34 GB (0.10 ms).  A window of W keeps at most W
// keys a row: recurrentgemma-9b's local layers (16 heads of 256, one KV
// head, W = 2048) at s = 4096 do 2 (dqk + dv) H (W (W + 1) / 2 + (s - W)
// W) = 0.10e12 operations (0.10 ms) against 71 MB (0.02 ms).  A
// non-causal call keeps every key: whisper-large-v3's encoder (20 heads
// of 64, 8 x 1500 frames) does 2 (dqk + dv) H b s^2 = 0.092e12 (0.093
// ms) against 61 MB a layer.
//
// Two bodies, chosen by the type; no runtime fallback between them.  Each
// is compiled twice: the kGeneral instance of a call with a query offset,
// a mask operand (read per element of every tile the static masks keep)
// or a row that may see no key (it holds the no-key rule), and the one
// for every other call, compiled with q_offset 0 and neither, so that
// the offset, the mask and the rule cost those calls nothing.  Both take
// the FlashAttention-2 structure:
//   * One block of 4 warps per (head, 64-query tile, batch); each warp
//     owns 16 query rows.  blockIdx.x is the head, so the first wave
//     holds every head's last query tile: the causal tiles with the most
//     key tiles start first.
//   * S stays in its mma.sync accumulator fragments; scale, masks and the
//     online softmax run there (exp2 of log2-scaled scores, one MUFU
//     instruction each), the row max and sum reducing over the quad that
//     shares a row (shuffles 1 and 2).  P goes from S's accumulators
//     straight into the A fragments of P . V, so it never touches shared
//     memory; l sums the unrounded p.  O stays in f32 accumulators.
//   * K and V stream through their own two-stage cp.async rings (16-byte
//     copies; rows past sk zero-filled through the source-size operand,
//     their scores set to -inf): the next K tile loads during this tile's
//     S and softmax, the next V tile during this tile's P . V, with two
//     barriers per tile.
//
// bf16: mma.sync m16n8k16 tensor cores (flash_mma_kernel).
//   * Both products are bf16 in, f32 accumulate.  The Q fragments are
//     read once with ldmatrix and stay in registers (dqk <= 128; at dqk
//     192 and 256 they are re-read from shared memory each tile, so that
//     the 64 or 128 f32 of O per thread stay in registers).  S comes from
//     ldmatrix.x4 fragments of K.  P is rounded to bf16 into the A
//     fragments of P . V (an accumulator pair of m16n8 is an A-fragment
//     pair of m16n8k16).  V is read with ldmatrix.x4.trans.
//   * Shared rows are padded by 16 bytes, so the 8 row addresses of an
//     ldmatrix fall in 8 distinct 16-byte bank groups.
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
// f32: mma.sync m16n8k8 TF32 tensor cores with the 3xTF32 split
// (flash_tf32_kernel), the f32 backward's arithmetic
// (flash_attention_bwd.cu).
//   * Every operand of both products is split as it enters a fragment:
//     hi = x rounded to TF32, lo = (x - hi) rounded to TF32 (split_tf32,
//     flash_mma.cuh), and a . b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b in f32
//     (mma_3xtf32): ~2^-21 of a product, within the 2e-5 gate, which
//     one-pass TF32 (~2^-11) is not.  Three TF32 products a product:
//     operations bound it at 165 TFLOP/s, a third of the TF32 peak.
//   * The k index of both products is permuted within each 8-step (slot
//     t <-> 2t, t + 4 <-> 2t + 1; the f32 backward's P trick): each
//     fragment takes a row's two k values as one float2 of shared memory,
//     P's accumulator fragment is P . V's A fragment without shuffles,
//     and O's two n8 tiles of each 16 columns are interleaved so that a
//     lane reads V's columns 2g, 2g + 1 as one float2 and stores four
//     adjacent columns of the output as one float4.  Q and K rows are
//     dqk + 8 floats apart, V rows dv + 4: the float2 reads of each
//     half-warp hit 32 distinct banks.
//   * Every fragment is split as its warp reads it (4 integer and 1 f32
//     instruction an element).  Splitting Q once into registers or into
//     hi / lo planes, or each K and V tile once by the block (hi in
//     place, lo beside it), measured slower at the LM train cell: fewer
//     blocks an SM, or two more barriers a tile.
//   * Each tile's P . V is summed from zero on the tensor cores and added
//     to O corr in f32 (one FMA): their f32 accumulation truncates, and
//     over a row's thousands of keys the error of one running sum would
//     grow with their count.  The tile's P . V runs over O's 16-column
//     pairs in turn, so that its fresh sum takes 8 registers, not O's
//     width; P's split fragments (2 x 4 registers a k-step) are formed once
//     a tile.
//   * Keys per tile: 64 at dh 32, 32 at dh 64, 16 at dqk >= 128, where O's
//     64 or 128 f32 a thread fill the registers; at (192, 128) 16 keys
//     also let two blocks share an SM (94 KB of shared memory).  At MLA's
//     causal 1024 x 1024 block 1.05 ms against 1.41 with 32 keys, at
//     recurrentgemma's window (dh 256) 3.99-4.03 against 4.74.  At dh 64
//     the registers are capped at 168, so that three blocks (12 warps)
//     share an SM: the LM train cell's call with its log-sum-exp 2.80 ms
//     against 3.09 at two blocks.  (scripts/time_flash_fwd.py, NVIDIA
//     H100 80GB HBM3, 700 W.)  A warp whose 16 rows all lie before a
//     causal tile's first key skips its products.
//   * What still bounds it: at the LM train cell it reaches 49 TFLOP/s,
//     30% of 3xTF32's rate.  Likely, not measured (no profile of the
//     SM's pipes was taken): mma.sync issues each of a
//     step's three products on its own, and the splits, the softmax and
//     the fragment loads take about as many issue slots again; wgmma
//     (operands read once per warpgroup from shared memory) is the next
//     step.
#include <cstdint>

#include <cuda_bf16.h>

#include "flash_mma.cuh"
#include "search_common.cuh"

namespace {

constexpr int kMmaWarps = 4;                  // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;        // query rows per block
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// The key tiles of BK keys a causal block reads: those up to the one
// holding key last_pos (its last row's position, clamped to n_kt), none
// when last_pos < 0 (every row before key 0).
__device__ __forceinline__ int key_tiles_to(int n_kt, int last_pos, int bk) {
  return last_pos < 0 ? 0 : min(n_kt, last_pos / bk + 1);
}

// ------------------------------------------ f32: mma.sync 3xTF32 cores ----

template <int DQK, int DV>
struct Tf32Geometry {
  static constexpr int kBK = DQK == 32 ? 64 : (DQK >= 128 ? 16 : 32);
  static constexpr int kMinBlocks = DQK == 64 ? 3 : (DQK == 256 ? 1 : 2);
  // Q and K rows 8 mod 32 words apart, V rows 4 mod 32: the float2 reads
  // of a half-warp fall in 32 distinct banks
  static constexpr int kLdK = DQK + 8;
  static constexpr int kLdV = DV + 4;
  static constexpr int kTileK = kBK * kLdK;          // one K stage
  static constexpr int kTileV = kBK * kLdV;          // one V stage
  // two stages each of K and V, and Q
  static constexpr size_t kSmem =
      sizeof(float) * (2 * size_t(kTileK + kTileV) + size_t(kMmaBQ) * kLdK);
  static_assert(kBK % 16 == 0 && DV % 16 == 0, "whole fragment pairs");
};

// A fragment, split, from one float2 of each of its rows g and g + 8
// (k slots t and t + 4); also the B fragments of two n8 tiles from one
// float2 of each k slot (b0 from x0, b1 from x1; tile 0 the .x, tile 1
// the .y).
__device__ __forceinline__ void split_pairs(Tf32Frag& f, float2 x0,
                                            float2 x1) {
  split_tf32(x0.x, f.hi[0], f.lo[0]);
  split_tf32(x1.x, f.hi[1], f.lo[1]);
  split_tf32(x0.y, f.hi[2], f.lo[2]);
  split_tf32(x1.y, f.hi[3], f.lo[3]);
}
// The B fragments of two n8 tiles, split, from one float2 (b0, b1) of
// each tile.
__device__ __forceinline__ void split_tiles(Tf32Frag& f, float2 x0,
                                            float2 x1) {
  split_tf32(x0.x, f.hi[0], f.lo[0]);
  split_tf32(x0.y, f.hi[1], f.lo[1]);
  split_tf32(x1.x, f.hi[2], f.lo[2]);
  split_tf32(x1.y, f.hi[3], f.lo[3]);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// kGeneral: the instance of a call with a query offset, a mask operand or
// rows with no key (general_instance); the other takes q_offset as 0 and
// does none of it.
template <int DQK, int DV, bool kGeneral>
__global__ void __launch_bounds__(kMmaThreads,
                                  Tf32Geometry<DQK, DV>::kMinBlocks)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int sq, int sk, int H, int KVH,
                  float scale, bool causal, int window, int kv_end,
                  int q_offset, MaskArg mask) {
  if constexpr (!kGeneral) q_offset = 0;
  using G = Tf32Geometry<DQK, DV>;
  constexpr int kBK = G::kBK, kLdK = G::kLdK, kLdV = G::kLdV;
  constexpr int kKS = DQK / 8;    // k-steps of S = Q . K^T
  constexpr int kNT = kBK / 8;    // 8-key tiles of S: k-steps of P . V
  constexpr int kDP = DV / 16;    // 16-column pairs of O
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  float* k_sm = reinterpret_cast<float*>(tf32_smem);   // 2 stages
  float* v_sm = k_sm + 2 * G::kTileK;                  // 2 stages
  float* q_sm = v_sm + 2 * G::kTileV;                  // kMmaBQ x kLdK

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row, column pair
  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (sq + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (n_qt - 1 - int(blockIdx.y)) * kMmaBQ;
  const int kvh = h / (H / KVH);
  const long q_stride = long(H) * DQK, k_stride = long(KVH) * DQK;
  const long v_stride = long(KVH) * DV, o_stride = long(H) * DV;
  const float* q_head = q + long(b) * sq * q_stride + long(h) * DQK;
  const float* k_head = k + long(b) * sk * k_stride + long(kvh) * DQK;
  const float* v_head = v + long(b) * sk * v_stride + long(kvh) * DV;

  // key tiles up to the one holding key kv_end - 1 and the tile's last
  // row's own position, from the one holding the first key of the first
  // row's band
  int n_kt = (kv_end + kBK - 1) / kBK;
  if (causal)
    n_kt = key_tiles_to(n_kt, min(q0 + kMmaBQ, sq) - 1 + q_offset, kBK);
  const int kt0 = window > 0 ? max(0, q0 + q_offset - window + 1) / kBK : 0;

  load_rows<float, DQK, kLdK, kMmaBQ, kMmaThreads>(q_sm, q_head, q0, sq,
                                                   q_stride);
  load_rows<float, DQK, kLdK, kBK, kMmaThreads>(k_sm, k_head, kt0 * kBK, sk,
                                                k_stride);
  cp_async_commit();
  load_rows<float, DV, kLdV, kBK, kMmaThreads>(v_sm, v_head, kt0 * kBK, sk,
                                               v_stride);
  cp_async_commit();

  // The k index of both products is permuted within each 8-step (slot t
  // <-> 2t, slot t + 4 <-> 2t + 1), so that a fragment's two k values of
  // a row are one float2 of shared memory and P's accumulator fragment
  // is P . V's A fragment.  Q: rows g, g + 8 of the warp's 16 from
  // q_w; K: key g of each 8-key tile from k_w; V: keys 2t, 2t + 1 of each
  // 8, and O's n8 tiles interleaved in pairs (tile i of pair np holds
  // columns 16 np + 2n + i), so that lane g reads columns 2g, 2g + 1
  // from v_w and lane t holds columns 16 np + 4t .. + 3 of O.
  const int q_w = (warp * 16 + g) * kLdK + 2 * t;
  const int k_w = g * kLdK + 2 * t;
  const int v_w = 2 * t * kLdV + 2 * g;

  const float sl2 = scale * kLog2e;                // scores in log2 units
  const int row_w = q0 + warp * 16;                // the warp's first row
  const int rows[2] = {row_w + g, row_w + g + 8};
  float o[2 * kDP][4];
#pragma unroll
  for (int dt = 0; dt < 2 * kDP; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};      // this lane's share of the row sum

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int st = (kt - kt0) & 1;   // tile kt0 sits in stage 0
    if (kt + 1 < n_kt)
      load_rows<float, DQK, kLdK, kBK, kMmaThreads>(
          k_sm + (st ^ 1) * G::kTileK, k_head, k0 + kBK, sk, k_stride);
    cp_async_commit();
    cp_async_wait<2>();   // K tile kt (and Q)
    __syncthreads();

    // a warp whose rows all lie before the tile's first key (causal)
    // skips the tile: its scores are all masked, and a tile that adds
    // p = 0 with correction 1 (or is cleared by the next correction, 0)
    // leaves O, m and l as they were
    const bool live = !causal || k0 <= row_w + 15 + q_offset;
    float s[kNT][4];
    Tf32Frag pf[kNT];
    float corr[2];
    if (live) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const float* qs = q_sm + q_w;
      const float* ks = k_sm + st * G::kTileK + k_w;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        // Q's rows g and g + 8: split as read (Q split once into registers
        // or into hi / lo planes measured slower: fewer blocks an SM)
        Tf32Frag a;
        split_pairs(a, ld2(qs + 8 * kk), ld2(qs + 8 * kLdK + 8 * kk));
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          // key tiles 2 np (keys g) and 2 np + 1 (g + 8)
          const int o0 = 16 * np * kLdK + 8 * kk;
          Tf32Frag bb;
          split_tiles(bb, ld2(ks + o0), ld2(ks + o0 + 8 * kLdK));
          mma_3xtf32(s[2 * np], a, bb, 0);
          mma_3xtf32(s[2 * np + 1], a, bb, 1);
        }
      }

      // scale, mask and the online softmax on the accumulator fragments:
      // element e of key tile nt is row rows[e / 2], key
      // k0 + 8 nt + 2 t + e % 2.  The tile needs a mask where it runs past
      // kv_end (<= sk), past the warp's first row's diagonal, (under a
      // window) left of the warp's last row's band, and always under the
      // mask operand
      const bool tile_mask =
          (kGeneral && mask.p != nullptr) || k0 + kBK > kv_end ||
          (causal && k0 + kBK - 1 > row_w + q_offset) ||
          (window > 0 && row_w + 15 + q_offset - k0 >= window);
      float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sl2;
          if (tile_mask) {
            const int key = k0 + nt * 8 + 2 * t + (e & 1);
            const int row = rows[e >> 1], qpos = row + q_offset;
            if (key >= sk)
              x = -CUDART_INF_F;
            else if (key >= kv_end || (causal && qpos < key) ||
                     (window > 0 && qpos - key >= window) ||
                     (kGeneral && row < sq &&
                      !mask_keeps(mask, b, h, row, key)))
              x = kNegInf;
          }
          s[nt][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        const float m_new = fmaxf(m_run[i], mt[i]);
        corr[i] = ex2(m_run[i] - m_new);
        m_run[i] = m_new;
        l_run[i] *= corr[i];
      }
      // P as the A fragments of P . V, split: k-step nt is key tile nt,
      // (g, 2t) -> slot t, (g, 2t + 1) -> slot t + 4, the same for g + 8
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float p0 = ex2(s[nt][0] - m_run[0]);
        const float p1 = ex2(s[nt][1] - m_run[0]);
        const float p2 = ex2(s[nt][2] - m_run[1]);
        const float p3 = ex2(s[nt][3] - m_run[1]);
        l_run[0] += p0 + p1;
        l_run[1] += p2 + p3;
        split_pairs(pf[nt], make_float2(p0, p1), make_float2(p2, p3));
      }
    }

    if (kt + 1 < n_kt)
      load_rows<float, DV, kLdV, kBK, kMmaThreads>(
          v_sm + (st ^ 1) * G::kTileV, v_head, k0 + kBK, sk, v_stride);
    cp_async_commit();
    cp_async_wait<2>();   // V tile kt
    __syncthreads();

    if (live) {
      // O = O corr + this tile's P . V, the tile's product summed from
      // zero on the tensor cores (their f32 accumulation truncates: over
      // a whole row of keys its error would grow with their count) and
      // added in f32
      const float* vs = v_sm + st * G::kTileV + v_w;
#pragma unroll
      for (int np = 0; np < kDP; ++np) {
        float part[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kNT; ++kk) {
          // keys 2t (slot t) and 2t + 1 (slot t + 4)
          const int o0 = 8 * kk * kLdV + 16 * np;
          Tf32Frag bb;
          split_pairs(bb, ld2(vs + o0), ld2(vs + o0 + kLdV));
          mma_3xtf32(part[0], pf[kk], bb, 0);
          mma_3xtf32(part[1], pf[kk], bb, 1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[2 * np + i][e] =
                __fmaf_rn(o[2 * np + i][e], corr[e >> 1], part[i][e]);
      }
    }
  }
  // no copy outlives the block (a block of rows with no key has no tile)
  if constexpr (kGeneral) cp_async_wait<0>();

  // lane t holds columns 16 np + 4t + (0, 1, 2, 3) = tiles (2np, 2np + 1)
  // of pair np at accumulator columns (2t, 2t, 2t + 1, 2t + 1)
  float* out_head = out + long(b) * sq * o_stride + long(h) * DV;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (rows[i] >= sq) continue;
    const bool empty = kGeneral && m_run[i] == kNegInf;
    if (empty) {   // no key seen: the mean of V over sk keys
#pragma unroll
      for (int dt = 0; dt < 2 * kDP; ++dt)
        o[dt][2 * i] = o[dt][2 * i + 1] = 0.0f;
      for (int j = 0; j < sk; ++j) {
        const float* vr = v_head + long(j) * v_stride + 4 * t;
#pragma unroll
        for (int np = 0; np < kDP; ++np) {
          const float4 x = *reinterpret_cast<const float4*>(vr + 16 * np);
          o[2 * np][2 * i] += x.x;
          o[2 * np + 1][2 * i] += x.y;
          o[2 * np][2 * i + 1] += x.z;
          o[2 * np + 1][2 * i + 1] += x.w;
        }
      }
      l = float(sk);
    }
    const float den = fmaxf(l, 1e-30f);
    float* dst = out_head + long(rows[i]) * o_stride + 4 * t;
#pragma unroll
    for (int np = 0; np < kDP; ++np)
      *reinterpret_cast<float4*>(dst + 16 * np) = make_float4(
          __fdiv_rn(o[2 * np][2 * i], den),
          __fdiv_rn(o[2 * np + 1][2 * i], den),
          __fdiv_rn(o[2 * np][2 * i + 1], den),
          __fdiv_rn(o[2 * np + 1][2 * i + 1], den));
    // the row's log-sum-exp, m_run in log2 units: m ln 2 + log(l) (l >= 1:
    // the row's largest term is 2^0); NEG_INF for a row that saw no key
    if (lse != nullptr && t == 0) {
      if constexpr (kGeneral)
        lse[(long(b) * H + h) * sq + rows[i]] =
            empty ? kNegInf : m_run[i] * kLn2 + logf(l);
      else
        lse[(long(b) * H + h) * sq + rows[i]] = m_run[i] * kLn2 + logf(l);
    }
  }
}

template <int DQK, int DV, bool kGeneral>
int launch_tf32(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int sq, int sk, int H, int KVH,
                float scale, bool causal, int window, int kv_end,
                int q_offset, const MaskArg& mask, cudaStream_t stream) {
  auto kernel = flash_tf32_kernel<DQK, DV, kGeneral>;
  const size_t smem = Tf32Geometry<DQK, DV>::kSmem;
  const int n_qt = (sq + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > 65535) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(n_qt),
                  static_cast<unsigned>(b));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk, H,
      KVH, scale, causal, window, kv_end, q_offset, mask);
  return int(cudaGetLastError());
}


// ------------------------------------------- bf16: mma.sync tensor cores ----

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
  // the general instance (an offset, a mask: the positions and the mask's
  // address live beside the rows) spilled 88 bytes a thread at dh 128 under
  // the cap of 168 registers; at two blocks an SM it takes up to 255
  static constexpr int kMinBlocksGeneral = kQInV ? 2 : kMinBlocks;
  static constexpr int kTileK = kBK * kLdK;         // one K stage
  static constexpr int kTileV = kBK * kLdV;         // one V stage
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) *
      ((kQInV ? 0 : size_t(kMmaBQ) * kLdK) + 2 * size_t(kTileK) +
       2 * size_t(kTileV));
  static_assert(!kQInV || (kQInRegs && kMmaBQ <= kBK && kLdK == kLdV),
                "Q fits one V stage");
};

template <int DQK, int DV, bool kGeneral>
__global__ void __launch_bounds__(
    kMmaThreads, kGeneral ? MmaGeometry<DQK, DV>::kMinBlocksGeneral
                          : MmaGeometry<DQK, DV>::kMinBlocks)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int sq, int sk, int H, int KVH, float scale, bool causal,
                 int window, int kv_end, int q_offset, MaskArg mask) {
  if constexpr (!kGeneral) q_offset = 0;
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

  // key tiles up to the one holding key kv_end - 1 and the tile's last
  // row's own position, from the one holding the first key of the first
  // row's band
  int n_kt = (kv_end + kBK - 1) / kBK;
  if (causal)
    n_kt = key_tiles_to(n_kt, min(q0 + kMmaBQ, sq) - 1 + q_offset, kBK);
  const int kt0 = window > 0 ? max(0, q0 + q_offset - window + 1) / kBK : 0;

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

  load_rows<__nv_bfloat16, DQK, kLdK, kMmaBQ, kMmaThreads>(
      q_sm, q_head, q0, sq, q_stride);
  load_rows<__nv_bfloat16, DQK, kLdK, kBK, kMmaThreads>(
      k_sm, k_head, kt0 * kBK, sk, k_stride);
  cp_async_commit();
  load_rows<__nv_bfloat16, DV, kLdV, kBK, kMmaThreads>(
      v_sm, v_head, kt0 * kBK, sk, v_stride);
  cp_async_commit();

  uint32_t qf[G::kQInRegs ? kKS : 1][4];
  cp_async_wait<1>();     // Q and the first K tile
  __syncthreads();
  if constexpr (G::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) ldmatrix_x4(qf[kk], q_a + 32 * kk);
  }

  const float sl2 = scale * kLog2e;                // scores in log2 units
  const int row_w = q0 + warp * 16;                // the warp's first row
  const int rows[2] = {row_w + g, row_w + g + 8};
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};      // this lane's share of the row sum

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int st = (kt - kt0) & 1;   // tile kt0 sits in stage 0
    if (kt + 1 < n_kt)
      load_rows<__nv_bfloat16, DQK, kLdK, kBK, kMmaThreads>(
          k_sm + (st ^ 1) * G::kTileK, k_head, k0 + kBK, sk, k_stride);
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
    // k0 + 8 nt + 2 t + e % 2.  The tile needs a mask where it runs past
    // kv_end (<= sk), past the warp's first row's diagonal, (under a
    // window) left of the warp's last row's band, and always under the
    // mask operand
    const bool tile_mask = (kGeneral && mask.p != nullptr) ||
                           k0 + kBK > kv_end ||
                           (causal && k0 + kBK - 1 > row_w + q_offset) ||
                           (window > 0 && row_w + 15 + q_offset - k0 >= window);
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sl2;
        if (tile_mask) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = rows[e >> 1], qpos = row + q_offset;
          if (key >= sk)
            x = -CUDART_INF_F;
          else if (key >= kv_end || (causal && qpos < key) ||
                   (window > 0 && qpos - key >= window) ||
                   (kGeneral && row < sq && !mask_keeps(mask, b, h, row, key)))
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
      load_rows<__nv_bfloat16, DV, kLdV, kBK, kMmaThreads>(
          v_sm + (st ^ 1) * G::kTileV, v_head, k0 + kBK, sk, v_stride);
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
  // no copy outlives the block (a block of rows with no key has no tile)
  if constexpr (kGeneral) cp_async_wait<0>();

  __nv_bfloat16* out_head =
      out + long(b) * sq * o_stride + long(h) * DV;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (rows[i] >= sq) continue;
    const bool empty = kGeneral && m_run[i] == kNegInf;
    if (empty) {   // no key seen: the mean of V over sk keys
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) o[dt][2 * i] = o[dt][2 * i + 1] = 0.0f;
      for (int j = 0; j < sk; ++j) {
        const __nv_bfloat16* vr = v_head + long(j) * v_stride + 2 * t;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vr + dt * 8));
          o[dt][2 * i] += x.x;
          o[dt][2 * i + 1] += x.y;
        }
      }
      l = float(sk);
    }
    const float den = fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = out_head + long(rows[i]) * o_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(__fdiv_rn(o[dt][2 * i], den),
                                __fdiv_rn(o[dt][2 * i + 1], den));
    // the row's log-sum-exp, m_run in log2 units: m ln 2 + log(l);
    // NEG_INF for a row that saw no key
    if (lse != nullptr && t == 0) {
      if constexpr (kGeneral)
        lse[(long(b) * H + h) * sq + rows[i]] =
            empty ? kNegInf : m_run[i] * kLn2 + logf(l);
      else
        lse[(long(b) * H + h) * sq + rows[i]] = m_run[i] * kLn2 + logf(l);
    }
  }
}

template <int DQK, int DV, bool kGeneral>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int sq, int sk, int H, int KVH,
               float scale, bool causal, int window, int kv_end, int q_offset,
               const MaskArg& mask, cudaStream_t stream) {
  auto kernel = flash_mma_kernel<DQK, DV, kGeneral>;
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
      static_cast<__nv_bfloat16*>(out), lse, sq, sk, H, KVH, scale, causal,
      window, kv_end, q_offset, mask);
  return int(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch ----

template <int DQK, int DV, bool kGeneral>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* out, float* lse, int b, int sq, int sk, int H,
                 int KVH, float scale, bool causal, int window, int kv_end,
                 int q_offset, const MaskArg& mask, cudaStream_t s) {
  if (dtype == 0)
    return launch_tf32<DQK, DV, kGeneral>(q, k, v, out, lse, b, sq, sk, H,
                                          KVH, scale, causal, window, kv_end,
                                          q_offset, mask, s);
  if (dtype == 1)
    return launch_mma<DQK, DV, kGeneral>(q, k, v, out, lse, b, sq, sk, H, KVH,
                                      scale, causal, window, kv_end,
                                      q_offset, mask, s);
  return int(cudaErrorInvalidValue);
}

template <int DQK, int DV>
int launch_pair(int dtype, const void* q, const void* k, const void* v,
                void* out, float* lse, int b, int sq, int sk, int H, int KVH,
                float scale, bool causal, int window, int kv_end,
                int q_offset, const MaskArg& mask, cudaStream_t s) {
  if (general_instance(mask.p != nullptr, window, q_offset, sq, sk))
    return launch_dtype<DQK, DV, true>(dtype, q, k, v, out, lse, b, sq, sk,
                                       H, KVH, scale, causal, window, kv_end,
                                       q_offset, mask, s);
  return launch_dtype<DQK, DV, false>(dtype, q, k, v, out, lse, b, sq, sk, H,
                                      KVH, scale, causal, window, kv_end,
                                      q_offset, mask, s);
}

template <int DQK, int DV, bool kGeneral>
cudaError_t attributes(int dtype, cudaFuncAttributes* attr) {
  if (dtype == 0)
    return cudaFuncGetAttributes(attr, flash_tf32_kernel<DQK, DV, kGeneral>);
  if (dtype == 1)
    return cudaFuncGetAttributes(attr, flash_mma_kernel<DQK, DV, kGeneral>);
  return cudaErrorInvalidValue;
}

// The compiled (dqk, dv) pairs, each as one case value.
constexpr int pair(int dqk, int dv) { return dqk * 1024 + dv; }

}  // namespace

extern "C" {

// q (b, sq, H, dqk), k (b, sk, KVH, dqk), v (b, sk, KVH, dv), out (b, sq,
// H, dv), all of one type: dtype 0 = f32 (3xTF32 tensor-core body), 1 =
// bf16 (bf16 tensor-core body); every pointer 16-byte aligned.  (dqk, dv) in
// {(32, 32), (64, 64), (128, 128), (256, 256), (192, 128)}, H a multiple
// of KVH, b and H at most 65535; window >= 0 (0 = no band); 0 <= kv_valid
// <= sk (0 = every key), and kv_valid > 0 only with causal 0, window 0 and
// no mask; |q_offset| <= 2^30 (query row i sits at position i +
// q_offset).  mask: null, or uint8 (nonzero = kept) with element (b, h,
// i, j) at mask + b mask_b + h mask_h + i mask_q + j mask_k.  lse: null,
// or (b, H, sq) f32, which receives each row's log-sum-exp m + log(l) for
// the backward (the output is the same either way).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another shape or type.
int icq_flash_attention(const void* q, const void* k, const void* v,
                        void* out, void* lse, int dtype, int b, int sq,
                        int sk, int H, int KVH, int dqk, int dv, float scale,
                        int causal, int window, int kv_valid, int q_offset,
                        const void* mask, long long mask_b, long long mask_h,
                        long long mask_q, long long mask_k, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || H < 1 || KVH < 1 || H % KVH != 0 ||
      b > 65535 || H > 65535 || window < 0 || kv_valid < 0 || kv_valid > sk ||
      (kv_valid > 0 && (causal != 0 || window > 0 || mask != nullptr)) ||
      q_offset > (1 << 30) || q_offset < -(1 << 30))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  const int kv_end = kv_valid > 0 ? kv_valid : sk;
  const MaskArg m{static_cast<const uint8_t*>(mask), mask_b, mask_h, mask_q,
                  mask_k};
  switch (pair(dqk, dv)) {
#define ICQ_FLASH_CASE(DQK, DV)                                          \
  case pair(DQK, DV):                                                    \
    return launch_pair<DQK, DV>(dtype, q, k, v, out,                     \
                                static_cast<float*>(lse), b, sq, sk, H,   \
                                KVH, scale, c, window, kv_end, q_offset,  \
                                m, s);
    ICQ_FLASH_CASE(32, 32)
    ICQ_FLASH_CASE(64, 64)
    ICQ_FLASH_CASE(128, 128)
    ICQ_FLASH_CASE(256, 256)
    ICQ_FLASH_CASE(192, 128)
#undef ICQ_FLASH_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

// Whether a call with these arguments runs the kGeneral instance of the
// forward and of both backward kernels (general_instance), nonzero if so.
int icq_flash_general_instance(int has_mask, int window, int q_offset,
                               int sq, int sk) {
  return int(general_instance(has_mask != 0, window, q_offset, sq, sk));
}

// The registers per thread and local-memory bytes per thread (spills and
// local arrays) of the body that runs for dtype and (dqk, dv), the kGeneral
// instance (a call with an offset, a mask or rows with no key) when
// general is nonzero.
int icq_flash_attention_attributes(int dtype, int dqk, int dv, int general,
                                   int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (pair(dqk, dv)) {
#define ICQ_FLASH_CASE(DQK, DV)                                  \
  case pair(DQK, DV):                                            \
    e = general ? attributes<DQK, DV, true>(dtype, &attr)        \
                : attributes<DQK, DV, false>(dtype, &attr);      \
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
