// Device code shared by the search kernels (batched_search.cu for the
// flat pass, ivf_search.cu for the IVF candidate slab): the chunk
// geometry, the two-key bitonic chunk sort, the staging of code rows,
// the codebook-order LUT sums and the per-chunk top-k write.
//
// Each source is compiled into its own shared library, so every helper
// here has internal linkage (anonymous namespace) in the one
// translation unit that includes it.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 1024;    // rows per block step == sort width
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__device__ __forceinline__ bool key_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// Ascending bitonic sort of kChunk (value, index) pairs in shared memory.
// The caller synchronises before; the sort synchronises after each step.
__device__ void bitonic_sort(float* v, int* ix) {
  for (int k = 2; k <= kChunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const float a = v[i], b = v[l];
          const int ia = ix[i], ib = ix[l];
          const bool up = (i & k) == 0;
          if (up ? key_less(b, ib, a, ia) : key_less(a, ia, b, ib)) {
            v[i] = b;
            v[l] = a;
            ix[i] = ib;
            ix[l] = ia;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Stage the code rows [base, base + kChunk) of the (n, Kc) uint8 codes.
__device__ void load_codes(uint8_t* dst, const uint8_t* __restrict__ codes,
                           long base, long n, int Kc) {
  const long rows = min(long(kChunk), n - base);
  const int nbytes = int(rows) * Kc;
  const uint8_t* src = codes + base * Kc;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nvec = nbytes >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) d4[i] = s4[i];
    done = nvec << 4;
  }
  for (int i = done + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = src[i];
}

// f32 LUT sum of one code row, codebooks in order from 0.0.  Nibble byte
// kc holds codebooks (2kc, 2kc+1) in its (low, high) nibble; the odd-K
// sentinel codebook has an all-zero LUT column.
template <bool NIBBLE>
__device__ __forceinline__ float row_sum_f32(const float* lut,
                                             const uint8_t* row, int Kc,
                                             int m) {
  float acc = 0.0f;
  for (int kc = 0; kc < Kc; ++kc) {
    const int b = row[kc];
    if (NIBBLE) {
      acc = __fadd_rn(acc, lut[(2 * kc) * m + (b & 15)]);
      acc = __fadd_rn(acc, lut[(2 * kc + 1) * m + (b >> 4)]);
    } else {
      acc = __fadd_rn(acc, lut[kc * m + b]);
    }
  }
  return acc;
}

// int8 LUT sum of one code row: exact in int32.
template <bool NIBBLE>
__device__ __forceinline__ int row_sum_i8(const int8_t* lut,
                                          const uint8_t* row, int Kc, int m) {
  int acc = 0;
  for (int kc = 0; kc < Kc; ++kc) {
    const int b = row[kc];
    if (NIBBLE) {
      acc += lut[(2 * kc) * m + (b & 15)];
      acc += lut[(2 * kc + 1) * m + (b >> 4)];
    } else {
      acc += lut[kc * m + b];
    }
  }
  return acc;
}

// The int8 dequant scale * acc + offset as two roundings (no FMA), the
// plain version's expression.
__device__ __forceinline__ float dequant(float scale, int acc, float offset) {
  return __fadd_rn(__fmul_rn(scale, float(acc)), offset);
}

// Write the first topk sorted pairs as list `chunk` of query qg.
__device__ void write_topk(const float* v, const int* ix, float* out_v,
                           int* out_i, int qg, int nchunks, int chunk,
                           int topk) {
  const long out = (long(qg) * nchunks + chunk) * topk;
  for (int t = threadIdx.x; t < topk; t += blockDim.x) {
    out_v[out + t] = v[t];
    out_i[out + t] = ix[t];
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" int icq_chunk_points() { return kChunk; }

extern "C" const char* icq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
