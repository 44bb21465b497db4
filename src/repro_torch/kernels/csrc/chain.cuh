// Shared pieces of the sketched power-chain kernels K4 (sketch_step.cu)
// and K5 (sketch_chain.cu): the products V' = R @ V of the chain
// V_i = R V_{i-1}, V_0 = St ([n, p], p <= 16), with R streamed from
// device memory.
//
// Work split: a warp carries CHAIN_ROWS rows of R at a time.  Its lanes
// stride over the contraction dimension with 16-byte loads of R (4 fp32 or
// 8 bf16 values; a scalar path covers an n that is not a multiple of
// that), and each lane keeps CHAIN_ROWS x p fp32 partial sums in
// registers.  V lives in shared memory TRANSPOSED, as [p][ldv], so that the
// lanes' 16-byte reads of one V row walk consecutive addresses, and each V
// value read from shared memory feeds CHAIN_ROWS FMAs.  A butterfly of
// warp shuffles then leaves every lane with the same fp32 sums.  Every
// order of summation is fixed by the thread layout, so a trace reduced from
// these sums is the same from run to run.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace prism {

constexpr int CHAIN_THREADS = 256;
constexpr int CHAIN_WARPS = CHAIN_THREADS / 32;
constexpr int CHAIN_ROWS = 4;
constexpr int MAX_SKETCH = 16;

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// 16 bytes of operands, unpacked to fp32 without a round trip through
// local memory.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4 u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the top half of the fp32 with the same value; element 2i
  // is the low half of word i (little endian)
  static __device__ __forceinline__ void unpack(const uint4 u, float* o) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// VEC consecutive operands at p (16-byte aligned when VEC > 1) as fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = Num<T>::to_f32(*p);
  } else {
    static_assert(VEC == Vec16<T>::N, "a vector load moves 16 bytes");
    Vec16<T>::unpack(*reinterpret_cast<const uint4*>(p), out);
  }
}

// acc[j][c] += sum over k in [k_lo, k_hi) of R[row0 + j, k] * vt[c, k - vk0]
// for j < nrows, c < p.  R is row-major with leading dimension n (device
// memory); vt is [p][ldv] in shared memory.  With VEC > 1, n, ldv, k_lo
// and vk0 are multiples of VEC and R is 16-byte aligned.
template <typename T, int VEC, int PB>
__device__ __forceinline__ void row_group_dot(
    const T* __restrict__ R, int n, int row0, int nrows, int k_lo, int k_hi,
    const T* vt, int ldv, int vk0, int p, float (&acc)[CHAIN_ROWS][PB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k = k_lo + lane * VEC; k < k_hi; k += 32 * VEC) {
    float r[CHAIN_ROWS][VEC];
#pragma unroll
    for (int j = 0; j < CHAIN_ROWS; ++j) {
      if (j < nrows) {
        load_vec<T, VEC>(R + (size_t)(row0 + j) * n + k, r[j]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < PB; ++c) {
      if (c < p) {
        float v[VEC];
        load_vec<T, VEC>(vt + (size_t)c * ldv + (k - vk0), v);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
#pragma unroll
          for (int j = 0; j < CHAIN_ROWS; ++j)
            acc[j][c] = fmaf(r[j][e], v[e], acc[j][c]);
      }
    }
  }
}

// Every lane ends with the full sums (a butterfly: each step adds the
// same two values on both lanes of a pair, so all lanes agree bit for
// bit).  p is the same on every lane.
template <int PB>
__device__ __forceinline__ void warp_allreduce(float (&acc)[CHAIN_ROWS][PB],
                                               int p) {
#pragma unroll
  for (int j = 0; j < CHAIN_ROWS; ++j)
#pragma unroll
    for (int c = 0; c < PB; ++c)
      if (c < p)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[j][c] += __shfl_xor_sync(0xffffffffu, acc[j][c], off);
}

// Picks the vector width (16-byte loads when n and R allow them) and the
// register tile width PB (8 or 16 >= p) of a chain kernel.
template <typename T, template <typename, int, int> class Launch,
          typename... Args>
int dispatch_chain(const void* R, int n, int p, Args... args) {
  const bool vec = n % Vec16<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(R) % 16 == 0;
  if (p <= 8)
    return vec ? Launch<T, Vec16<T>::N, 8>::run(R, n, p, args...)
               : Launch<T, 1, 8>::run(R, n, p, args...);
  return vec ? Launch<T, Vec16<T>::N, 16>::run(R, n, p, args...)
             : Launch<T, 1, 16>::run(R, n, p, args...);
}

}  // namespace prism
