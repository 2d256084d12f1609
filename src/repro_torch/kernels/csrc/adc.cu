// Single-LUT ADC and the fused two-step phase 1 for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   icq_adc       <- src/repro/kernels/adc.py       adc_pallas (_adc_kernel)
//   icq_two_step  <- src/repro/kernels/two_step.py  two_step_pallas
//                                                   (_two_step_kernel)
//
// For every point i: dist_i = sum_k T[k, codes[i, k]] over one (K, m) f32
// LUT.  The two-step entry folds the (K,) fast mask into the LUT as the
// reference does (T * mask, an f32 multiply by 0 or 1), writes the crude
// sum and passed_i = crude_i < thr as int32.
//
// What bounds it on this card: bytes.  At SIFT1M geometry (n = 1M, K = 8,
// m = 256, uint8 rows) the function reads 8 MB of codes and writes 4 MB
// (ADC) or 8 MB (two-step) of outputs: ~4 us at 3.35 TB/s, against 8 M
// adds.
//
// What the design does about it:
//   * The TPU body is a one-hot x LUT matmul, a trick for its matrix
//     unit.  Here it is the gather it stands for: each block stages the
//     (K, m) LUT (8 KB at K = 8, m = 256; masked on the way in for the
//     two-step) in shared memory, and each thread sums one point's row,
//     walking the points with a grid stride so that a block stages its LUT
//     once for many points.  The grid is one full wave of the card.
//   * A thread reads its code row with the widest load that the row's
//     size and address allow (16, 8 or 4 bytes), so a warp reads 32
//     neighbouring rows in one or two wide loads each.
//   * The sum is __fadd_rn in codebook order from 0.0, the plain
//     version's order, so kernel == plain version bit for bit.  One
//     template body serves uint8 rows (the index's storage) and int32
//     rows (the reference's contract).
//   * The random gather into the LUT meets shared-memory bank conflicts
//     (32 lanes into 8 banks' worth of one codebook's 256 entries); they
//     are accepted in this first version.  Codes are not range-checked:
//     the reference requires them in [0, m) and checks nothing either.
#include "search_common.cuh"

namespace {

template <int BYTES>
struct VecOf;
template <>
struct VecOf<16> { using type = uint4; };
template <>
struct VecOf<8> { using type = uint2; };
template <>
struct VecOf<4> { using type = uint32_t; };
template <>
struct VecOf<1> { using type = uint8_t; };

// Sum one point's row, read as row_bytes / VEC loads of VEC bytes, each
// split into its codes in order.
template <typename CodeT, int VEC>
__device__ __forceinline__ float row_adc(const float* lut,
                                         const uint8_t* row, int row_bytes,
                                         int m) {
  using V = typename VecOf<VEC>::type;
  constexpr int kPer = VEC / int(sizeof(CodeT));
  float acc = 0.0f;
  int k = 0;
  for (int off = 0; off < row_bytes; off += VEC) {
    const V v = *reinterpret_cast<const V*>(row + off);
    const CodeT* c = reinterpret_cast<const CodeT*>(&v);
#pragma unroll
    for (int e = 0; e < kPer; ++e, ++k)
      acc = __fadd_rn(acc, lut[k * m + int(c[e])]);
  }
  return acc;
}

// TWO_STEP: mask (K,) bool folded into the staged LUT; out = crude,
// passed = crude < *thr.  Otherwise out = the ADC sum, mask / thr /
// passed unused.
template <typename CodeT, int VEC, bool TWO_STEP>
__global__ void __launch_bounds__(kThreads)
adc_kernel(const CodeT* __restrict__ codes, const float* __restrict__ lut,
           const uint8_t* __restrict__ mask, const float* __restrict__ thr,
           float* __restrict__ out, int* __restrict__ passed, long n, int K,
           int m) {
  extern __shared__ __align__(16) float lut_s[];
  for (int e = threadIdx.x; e < K * m; e += blockDim.x) {
    if constexpr (TWO_STEP)
      lut_s[e] = __fmul_rn(lut[e], mask[e / m] ? 1.0f : 0.0f);
    else
      lut_s[e] = lut[e];
  }
  __syncthreads();
  float t = 0.0f;
  if constexpr (TWO_STEP) t = *thr;
  const int row_bytes = K * int(sizeof(CodeT));
  const uint8_t* base = reinterpret_cast<const uint8_t*>(codes);
  const long stride = long(gridDim.x) * blockDim.x;
  for (long i = long(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s =
        row_adc<CodeT, VEC>(lut_s, base + i * row_bytes, row_bytes, m);
    out[i] = s;
    if constexpr (TWO_STEP) passed[i] = s < t ? 1 : 0;
  }
}

template <typename CodeT, int VEC, bool TWO_STEP>
cudaError_t launch(const void* codes, const void* lut, const void* mask,
                   const void* thr, void* out, void* passed, long n, int K,
                   int m, cudaStream_t stream) {
  auto kernel = adc_kernel<CodeT, VEC, TWO_STEP>;
  const size_t smem = sizeof(float) * size_t(K) * m;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return e;
  const long wave = long(sms) * (per_sm > 0 ? per_sm : 1);
  const long blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(unsigned(blocks < wave ? blocks : wave));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), static_cast<const float*>(lut),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(thr),
      static_cast<float*>(out), static_cast<int*>(passed), n, K, m);
  return cudaGetLastError();
}

// The widest load (16, 8, 4 or 1 bytes) that divides both the row's size
// and the codes' address, never narrower than one code.
int row_vector_bytes(const void* codes, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(codes);
  for (int v = 16; v >= 4; v >>= 1)
    if (row_bytes % v == 0 && a % v == 0) return v;
  return 1;
}

template <bool TWO_STEP>
int dispatch(const void* codes, int code_bytes, const void* lut,
             const void* mask, const void* thr, void* out, void* passed,
             long n, int K, int m, void* stream) {
  if (n < 1 || K < 1 || m < 1 || (code_bytes != 1 && code_bytes != 4) ||
      sizeof(float) * size_t(K) * m > kMaxSmem)
    return int(cudaErrorInvalidValue);
  const int vec = row_vector_bytes(codes, K * code_bytes);
  if (vec < code_bytes) return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (code_bytes == 1) {
    switch (vec) {
      case 16: e = launch<uint8_t, 16, TWO_STEP>(codes, lut, mask, thr, out,
                                                 passed, n, K, m, s); break;
      case 8: e = launch<uint8_t, 8, TWO_STEP>(codes, lut, mask, thr, out,
                                               passed, n, K, m, s); break;
      case 4: e = launch<uint8_t, 4, TWO_STEP>(codes, lut, mask, thr, out,
                                               passed, n, K, m, s); break;
      default: e = launch<uint8_t, 1, TWO_STEP>(codes, lut, mask, thr, out,
                                                passed, n, K, m, s);
    }
  } else {
    switch (vec) {
      case 16: e = launch<int, 16, TWO_STEP>(codes, lut, mask, thr, out,
                                             passed, n, K, m, s); break;
      case 8: e = launch<int, 8, TWO_STEP>(codes, lut, mask, thr, out,
                                           passed, n, K, m, s); break;
      default: e = launch<int, 4, TWO_STEP>(codes, lut, mask, thr, out,
                                            passed, n, K, m, s);
    }
  }
  return int(e);
}

}  // namespace

extern "C" {

// The largest (K, m) LUT, in bytes, that a block stages in shared memory.
long icq_adc_max_lut_bytes() { return long(kMaxSmem); }

// codes (n, K) uint8 (code_bytes = 1) or int32 (code_bytes = 4), rows in
// [0, m); lut (K, m) f32; out (n,) f32.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty operand, another code width or a
// LUT larger than icq_adc_max_lut_bytes().
int icq_adc(const void* codes, int code_bytes, const void* lut, void* out,
            long n, int K, int m, void* stream) {
  return dispatch<false>(codes, code_bytes, lut, nullptr, nullptr, out,
                         nullptr, n, K, m, stream);
}

// As icq_adc, with mask (K,) bool folded into the LUT, thr a device f32
// scalar; crude (n,) f32 and passed (n,) int32 = crude < thr.
int icq_two_step(const void* codes, int code_bytes, const void* lut,
                 const void* mask, const void* thr, void* crude,
                 void* passed, long n, int K, int m, void* stream) {
  return dispatch<true>(codes, code_bytes, lut, mask, thr, crude, passed, n,
                        K, m, stream);
}

}  // extern "C"
