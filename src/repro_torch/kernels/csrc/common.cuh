// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel keeps the reference's precision contract (DESIGN.md §9):
// operands are fp32 or bf16, products accumulate in fp32 (a bf16 x bf16
// product is exact in fp32), the epilogues run on the fp32 accumulator,
// and the output rounds once, to nearest even, to the operand dtype.
// The epilogues use __fmul_rn / __fadd_rn so that the compiler cannot
// contract them into FMAs: they round exactly where the plain PyTorch
// versions (kernels/ref.py) round.
//
// Each source is built on its own into a shared library with a plain C
// interface (kernels/_build.py); a launcher returns cudaGetLastError()
// right after the launch and the Python wrapper raises on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace prism {

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Tiled SIMT GEMM: one block of 256 threads computes one 128 x 128 fp32
// output tile; each thread holds an 8 x 8 register tile (rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise with tx), so that
// the 16 threads of a half-warp read 256 contiguous bytes of each shared
// row with 16-byte loads.  The contraction runs as a loop over BK-deep
// stages staged through shared memory, converted to fp32 on the way in.
// Ragged edges are masked on load (zeros), never padded in device memory.
constexpr int TILE = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ int frag_index(int t, int i) {
  return t * 4 + (i & 3) + (i >> 2) * 64;
}

// acc += op(A)[row0:row0+TILE, :] @ B[:, col0:col0+TILE], contraction K.
//   A_T == false: A is [M, K] row-major, op(A) = A.
//   A_T == true:  A is [K, M] row-major, op(A) = A^T  (the Gram X^T X).
//   B is [K, N] row-major.
template <typename T, bool A_T>
__device__ __forceinline__ void tile_gemm(const T* __restrict__ A,
                                          const T* __restrict__ B, int M,
                                          int N, int K, int row0, int col0,
                                          float (&acc)[8][8],
                                          float (*As)[TILE],
                                          float (*Bs)[TILE]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BK * TILE) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      // A stage: neighbouring threads walk the dimension that is
      // contiguous in memory (M for A^T, K otherwise)
      const int ar = A_T ? idx % TILE : idx / BK;
      const int ak = A_T ? idx / TILE : idx % BK;
      const int gr = row0 + ar;
      const int gk = k0 + ak;
      float a = 0.f;
      if (gr < M && gk < K)
        a = Num<T>::to_f32(A_T ? A[(size_t)gk * M + gr]
                               : A[(size_t)gr * K + gk]);
      As[ak][ar] = a;
      const int bk = idx / TILE;
      const int bc = idx % TILE;
      const int gbk = k0 + bk;
      const int gc = col0 + bc;
      float b = 0.f;
      if (gbk < K && gc < N) b = Num<T>::to_f32(B[(size_t)gbk * N + gc]);
      Bs[bk][bc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace prism

extern "C" const char* prism_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
