// Device code shared by the search kernels (batched_search.cu for the
// flat pass, ivf_search.cu for the IVF candidate slab): the chunk
// geometry, the two-key bitonic sort, the co-rank merge of two sorted
// lists, the staging of code rows, the codebook-order LUT sums and the
// per-chunk list write.
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

// Ascending bitonic sort of P (value, index) pairs in shared memory, P
// a power of two.  The caller synchronises before; the sort
// synchronises after each step.
__device__ void bitonic_sort_n(float* v, int* ix, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
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

__device__ __forceinline__ void bitonic_sort(float* v, int* ix) {
  bitonic_sort_n(v, ix, kChunk);
}

// Element t of the merge of two ascending lists A (wa pairs) and B (wb
// pairs), A first on equal keys: a co-rank binary search for the number
// a of A's pairs among the merge's first t, then the smaller head.
// t < wa + wb.  The pointers may address shared or global memory.
__device__ __forceinline__ void merged_at(const float* av, const int* ai,
                                          int wa, const float* bv,
                                          const int* bi, int wb, int t,
                                          float& v, int& id) {
  int lo = max(0, t - wb), hi = min(t, wa);
  while (lo < hi) {   // A[mid] precedes B[t - mid - 1]: take more of A
    const int mid = (lo + hi) >> 1;
    if (key_less(bv[t - mid - 1], bi[t - mid - 1], av[mid], ai[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  const int a = lo, b = t - lo;
  if (a < wa && (b >= wb || !key_less(bv[b], bi[b], av[a], ai[a]))) {
    v = av[a];
    id = ai[a];
  } else {
    v = bv[b];
    id = bi[b];
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

// Byte kc of a code row.  Rows of a multiple of 4 bytes are read as
// 32-bit words (a staged row starts 4-aligned); the sum order is the
// same either way.
template <typename Add>
__device__ __forceinline__ void for_row_bytes(const uint8_t* row, int Kc,
                                              Add add) {
  if ((Kc & 3) == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
    for (int k4 = 0; k4 < (Kc >> 2); ++k4) {
      const uint32_t v = w[k4];
      add(4 * k4, int(v & 255u));
      add(4 * k4 + 1, int((v >> 8) & 255u));
      add(4 * k4 + 2, int((v >> 16) & 255u));
      add(4 * k4 + 3, int(v >> 24));
    }
  } else {
    for (int kc = 0; kc < Kc; ++kc) add(kc, int(row[kc]));
  }
}

// f32 LUT sum of one code row, codebooks in order from 0.0.  Nibble byte
// kc holds codebooks (2kc, 2kc+1) in its (low, high) nibble; the odd-K
// sentinel codebook has an all-zero LUT column.
template <bool NIBBLE>
__device__ __forceinline__ float row_sum_f32(const float* lut,
                                             const uint8_t* row, int Kc,
                                             int m) {
  float acc = 0.0f;
  for_row_bytes(row, Kc, [&](int kc, int b) {
    if (NIBBLE) {
      acc = __fadd_rn(acc, lut[(2 * kc) * m + (b & 15)]);
      acc = __fadd_rn(acc, lut[(2 * kc + 1) * m + (b >> 4)]);
    } else {
      acc = __fadd_rn(acc, lut[kc * m + b]);
    }
  });
  return acc;
}

// int8 LUT sum of one code row: exact in int32.
template <bool NIBBLE>
__device__ __forceinline__ int row_sum_i8(const int8_t* lut,
                                          const uint8_t* row, int Kc, int m) {
  int acc = 0;
  for_row_bytes(row, Kc, [&](int kc, int b) {
    if (NIBBLE) {
      acc += lut[(2 * kc) * m + (b & 15)];
      acc += lut[(2 * kc + 1) * m + (b >> 4)];
    } else {
      acc += lut[kc * m + b];
    }
  });
  return acc;
}

// The int8 dequant scale * acc + offset as two roundings (no FMA), the
// plain version's expression.
__device__ __forceinline__ float dequant(float scale, int acc, float offset) {
  return __fadd_rn(__fmul_rn(scale, float(acc)), offset);
}

// Write the first w sorted pairs as list `chunk` (of nchunks lists of
// w pairs) of query qg; w = min(topk, kChunk), so a list holds every
// point of its chunk when topk >= kChunk.
__device__ void write_list(const float* v, const int* ix, float* out_v,
                           int* out_i, int qg, int nchunks, int chunk,
                           int w) {
  const long out = (long(qg) * nchunks + chunk) * w;
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
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
