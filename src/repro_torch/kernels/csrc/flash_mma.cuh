// Device helpers shared by the flash attention forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu): 2^x in
// one MUFU instruction, cp.async copies of head rows into shared memory,
// ldmatrix fragment loads and the bf16 mma.sync step of the bf16 bodies,
// the TF32 split and the 3xTF32 mma.sync step of the f32 bodies; the
// mask operand's reader and the rule for a row that sees no key.
//
// Each source is compiled into its own shared library, so every helper
// here has internal linkage (anonymous namespace) in the one
// translation unit that includes it.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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

// cp.async W columns of rows [row0, row0 + ROWS) of one head (rows
// `stride` elements apart, src at row 0) into dst (ROWS x LD) by NT
// threads; rows at or past `rows` are zero-filled.
template <typename E, int W, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(E* dst, const E* __restrict__ src,
                                          int row0, int rows, long stride) {
  constexpr int kVE = 16 / int(sizeof(E));
  constexpr int kChunks = W / kVE;
  constexpr int kIters = (ROWS * kChunks + NT - 1) / NT;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int e = int(threadIdx.x) + i * NT;
    if (ROWS * kChunks % NT != 0 && e >= ROWS * kChunks) break;
    const int r = e / kChunks, c = (e % kChunks) * kVE;
    const bool ok = row0 + r < rows;
    cp_async16(smem_addr(dst + r * LD + c),
               src + (ok ? long(row0 + r) * stride + c : 0), ok ? 16 : 0);
  }
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

// x rounded to TF32 (nearest, ties away), as a 32-bit pattern: the bits
// of cvt.rna.tf32.f32, in two integer instructions of the full-rate
// pipes (the 13 dropped mantissa bits rounded on the magnitude, a carry
// moving into the exponent; the cvt runs on a slow pipe, and the split
// made the backward kernels 1.3x slower with it).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// The 3xTF32 split: hi = x rounded to TF32, lo = (x - hi) rounded to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a . b over one m16 n8 k8 step, TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split fragments of a 3xTF32 product: an A fragment of m16 k8
// (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), or the B
// fragments of two n8 k8 tiles (tile 0 in [0..1], tile 1 in [2..3]; b0
// (k t, n g), b1 (k t + 4, n g)), with g = lane / 4, t = lane % 4.
struct Tf32Frag {
  uint32_t hi[4], lo[4];
};

// c += a . b over one m16 n8 k8 step with B tile `half` of b, in 3xTF32:
// lo_a hi_b + hi_a lo_b + hi_a hi_b, the small terms first (the dropped
// lo_a lo_b and the rounding of lo are ~2^-21 of a product).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32Frag& a,
                                           const Tf32Frag& b, int half) {
  mma_tf32(c, a.lo, b.hi[2 * half], b.hi[2 * half + 1]);
  mma_tf32(c, a.hi, b.lo[2 * half], b.lo[2 * half + 1]);
  mma_tf32(c, a.hi, b.hi[2 * half], b.hi[2 * half + 1]);
}

// The mask operand of a masked call: element (b, h, i, j) (batch, query
// head, query row, key) at p + b sb + h sh + i sq + j sk (element strides;
// a broadcast dimension has stride 0), nonzero where the pair is kept;
// p null: no mask operand.  It is ANDed into the causal, window and
// kv_valid masks.
struct MaskArg {
  const uint8_t* p;
  long long sb, sh, sq, sk;
};
__device__ __forceinline__ bool mask_keeps(const MaskArg& m, int b, int h,
                                           int i, int j) {
  return m.p == nullptr || m.p[b * m.sb + h * m.sh + i * m.sq + j * m.sk] != 0;
}

// Whether a call runs the kernels' kGeneral instance: a call with a query
// offset, or one that can leave a row with no key (a mask operand, a row
// past the last key's band).  That instance reads the offset and the mask
// operand and applies the no-key rule below; the other is the kernel of
// every call with neither (q_offset 0, no mask, a key for every row: the
// calls the served models make), compiled with q_offset 0 and no rule.
inline bool general_instance(bool has_mask, int window, int q_offset,
                             int sq, int sk) {
  return q_offset != 0 || has_mask || (window > 0 && sq - sk >= window);
}

// A row that sees no key (possible only under a mask operand, a negative
// query offset with causal, or a window past the last key) takes the
// reference's softmax of all-NEG_INF scores: uniform over the sk keys.
// The forward writes it the mean of V over all sk keys and the log-sum-exp
// NEG_INF (NEG_INF + log(sk) in f32); the backward reads a log-sum-exp
// below kEmptyLse as such a row: no gradient to q or k, dV_j += dO_i / sk
// for every key j.
constexpr float kEmptyLse = -5e29f;

// (lo, hi) rounded to bf16 in one 32-bit register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace
