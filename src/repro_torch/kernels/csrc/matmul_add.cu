// K1: D = alpha * A @ B + beta * C, batched, one launch per [B, m, n] bucket.
//
// Replaces the TPU kernel repro/kernels/matmul_add.py::matmul_add (the
// Horner GEMMs of the grid-tier Newton-Schulz update, newton_schulz._mm).
//
// What bounds it on the H100: operations.  On the main path's shapes
// ([40, 1024, 1024] @ [40, 1024, 1024] and [20, 4096, 1024] @
// [20, 1024, 1024]) a launch does 2*m*n*k flops per slice against about
// 4 bytes * (m*k + k*n + 2*m*n) of traffic, some 170 flops a byte in fp32:
// far above the 20 flops a byte where the fp32 SIMT units (67 TFLOP/s) stop
// waiting on memory (3.35 TB/s).  fp32 operands must not use TF32, so the
// rate to reach is the plain-FMA one.
//
// Design: the TPU kernel's sequential K grid axis with its fp32 VMEM
// scratch becomes a loop over K stages inside one block, with the fp32
// accumulator in registers (an 8 x 8 tile per thread, 128 x 128 per block,
// prism::tile_gemm).  The grid is (col tiles, row tiles, batch), so a
// whole bucket is one launch (DESIGN.md §7).  C is read only in the
// epilogue: alpha * acc + beta * C in fp32, then one rounding.  Ragged
// edges are masked instead of zero-padded copies.  bf16 operands run the
// same fp32 FMA loop (exact products, fp32 sums); tensor cores, TMA and
// software pipelining are later work.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(prism::THREADS)
    matmul_add_kernel(const T* __restrict__ A, const T* __restrict__ B,
                      const T* __restrict__ C, T* __restrict__ D, int M,
                      int N, int K, float alpha, float beta, int has_c) {
  __shared__ __align__(16) float As[prism::BK][prism::TILE];
  __shared__ __align__(16) float Bs[prism::BK][prism::TILE];
  const size_t b = blockIdx.z;
  A += b * (size_t)M * K;
  B += b * (size_t)K * N;
  D += b * (size_t)M * N;
  if (has_c) C += b * (size_t)M * N;
  const int row0 = blockIdx.y * prism::TILE;
  const int col0 = blockIdx.x * prism::TILE;
  float acc[8][8];
  prism::tile_gemm<T, false>(A, B, M, N, K, row0, col0, acc, As, Bs);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + prism::frag_index(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + prism::frag_index(tx, j);
      if (c >= N) continue;
      const size_t o = (size_t)r * N + c;
      float v = __fmul_rn(alpha, acc[i][j]);
      if (has_c)
        v = __fadd_rn(v, __fmul_rn(beta, prism::Num<T>::to_f32(C[o])));
      D[o] = prism::Num<T>::from_f32(v);
    }
  }
}

}  // namespace

extern "C" int prism_matmul_add(const void* A, const void* B, const void* C,
                                void* D, int batch, int M, int N, int K,
                                float alpha, float beta, int has_c, int bf16,
                                void* stream) {
  const dim3 grid((N + prism::TILE - 1) / prism::TILE,
                  (M + prism::TILE - 1) / prism::TILE, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    matmul_add_kernel<__nv_bfloat16><<<grid, prism::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), static_cast<__nv_bfloat16*>(D),
        M, N, K, alpha, beta, has_c);
  } else {
    matmul_add_kernel<float><<<grid, prism::THREADS, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<float*>(D), M, N, K, alpha,
        beta, has_c);
  }
  return static_cast<int>(cudaGetLastError());
}
