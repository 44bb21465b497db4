// K2: R = alpha * I + beta * X^T X, batched, computing only the upper block
// triangle and mirroring it in the epilogue.
//
// Replaces the TPU kernel repro/kernels/gram.py::gram_upper together with
// its separate mirror pass (gram.py::mirror_upper): the residual
// I - X^T X of every grid-tier Newton-Schulz iteration
// (newton_schulz._gram_residual).
//
// What bounds it on the H100: operations.  X [m, n] -> R [n, n] needs
// m*n*(n+1) flops (the upper triangle) against 4 bytes * (m*n + n*n);
// at n = 1024 that is several hundred flops a byte in fp32, far above
// the fp32 SIMT ridge of about 20.
//
// Design: one block per (upper tile, batch slice).  The TPU unranks a
// linear tile index in closed form inside its index maps; here blocks
// are independent, so the launch stays linear over the nb(nb+1)/2 upper
// tiles and each block unranks its own index with a short loop.  The
// product is X^T X, so both operand stages are row segments of X
// (coalesced loads along n, prism::tile_gemm with A_T).  alpha * I is
// added on the diagonal in fp32 before the one rounding, and an
// off-diagonal tile writes its transpose too, which removes the mirror
// pass and its extra read and write of R.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(prism::THREADS)
    gram_upper_kernel(const T* __restrict__ X, T* __restrict__ R, int m,
                      int n, int nb, float alpha, float beta) {
  __shared__ __align__(16) float As[prism::BK][prism::TILE];
  __shared__ __align__(16) float Bs[prism::BK][prism::TILE];
  const size_t b = blockIdx.z;
  X += b * (size_t)m * n;
  R += b * (size_t)n * n;
  // row-major unranking of the upper triangle: t -> (bi, bj), bi <= bj
  int t = blockIdx.x;
  int bi = 0;
  while (t >= nb - bi) {
    t -= nb - bi;
    ++bi;
  }
  const int bj = bi + t;
  const int row0 = bi * prism::TILE;
  const int col0 = bj * prism::TILE;
  float acc[8][8];
  prism::tile_gemm<T, true>(X, X, n, n, m, row0, col0, acc, As, Bs);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + prism::frag_index(ty, i);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + prism::frag_index(tx, j);
      if (c >= n) continue;
      float v = __fmul_rn(beta, acc[i][j]);
      if (r == c) v = __fadd_rn(alpha, v);
      const T o = prism::Num<T>::from_f32(v);
      R[(size_t)r * n + c] = o;
      if (bi != bj) R[(size_t)c * n + r] = o;
    }
  }
}

}  // namespace

extern "C" int prism_gram_upper(const void* X, void* R, int batch, int m,
                                int n, float alpha, float beta, int bf16,
                                void* stream) {
  const int nb = (n + prism::TILE - 1) / prism::TILE;
  const dim3 grid(nb * (nb + 1) / 2, 1, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    gram_upper_kernel<__nv_bfloat16><<<grid, prism::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), static_cast<__nv_bfloat16*>(R),
        m, n, nb, alpha, beta);
  } else {
    gram_upper_kernel<float><<<grid, prism::THREADS, 0, s>>>(
        static_cast<const float*>(X), static_cast<float*>(R), m, n, nb, alpha,
        beta);
  }
  return static_cast<int>(cudaGetLastError());
}
