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
// tiles (the wrapper sizes the grid, kernels/gram.py::upper_tiles) and
// each block unranks its own index with a short loop.  The product is
// X^T X on the core of gemm.cuh with op(A) = X^T, so both operand tiles
// are row segments of X (16-byte copies along n).  The epilogue adds
// alpha * I on the diagonal in fp32, rounds once, and stages the rounded
// tile in shared memory; a diagonal tile copies its upper triangle onto
// its lower one there (whatever order the tensor cores summed in, R is
// symmetric bit for bit), and an off-diagonal tile is written twice, as
// itself and as its transpose, both with coalesced 16-byte stores: this
// removes the mirror pass and its extra read and write of R.
#include "gemm.cuh"

namespace {

using prism::gemm::Core;
using prism::gemm::out_off;
using prism::gemm::THREADS;
using prism::gemm::TILE;

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, ALIGNED ? 2 : 1)
    gram_upper_kernel(const T* __restrict__ X, T* __restrict__ R, int m,
                      int n, int nb, float alpha, float beta) {
  extern __shared__ __align__(16) char smem[];
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
  const int row0 = bi * TILE;
  const int col0 = bj * TILE;

  Core<T, true, ALIGNED> core{X, X, n, n, m, row0, col0};
  float acc[64];
  core.run(smem, acc);
  float* out = reinterpret_cast<float*>(smem);
  Core<T, true, ALIGNED>::stage_out(out, acc, [=](float v, int r, int c) {
    float w = __fmul_rn(beta, v);
    if (row0 + r == col0 + c) w = __fadd_rn(alpha, w);
    return prism::Num<T>::to_f32(prism::Num<T>::from_f32(w));
  });
  __syncthreads();
  if (bi == bj) {
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
      const int r = idx / TILE;
      const int c = idx % TILE;
      if (r > c) out[out_off(r, c)] = out[out_off(c, r)];
    }
    __syncthreads();
  }

  if constexpr (ALIGNED) {
    constexpr int VEC = Core<T, true, ALIGNED>::VEC;
    // the tile itself, rows of R at row0
    for (int idx = threadIdx.x; idx < TILE * TILE / VEC; idx += THREADS) {
      const int r = idx / (TILE / VEC);
      const int c = (idx % (TILE / VEC)) * VEC;
      if (row0 + r >= n || col0 + c >= n) continue;
      float v[VEC];
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        *reinterpret_cast<float4*>(&v[q]) =
            *reinterpret_cast<const float4*>(out + out_off(r, c + q));
      *reinterpret_cast<uint4*>(R + (size_t)(row0 + r) * n + col0 + c) =
          prism::gemm::pack<T>(v);
    }
    if (bi == bj) return;
    // its transpose, rows of R at col0: a thread reads a VEC x 4 block of
    // the tile (VEC rows, 4 columns) and writes 4 rows of VEC values
    for (int idx = threadIdx.x; idx < (TILE / VEC) * (TILE / 4);
         idx += THREADS) {
      const int rv = (idx % (TILE / VEC)) * VEC;
      const int c4 = (idx / (TILE / VEC)) * 4;
      if (row0 + rv >= n) continue;
      float blk[VEC][4];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        *reinterpret_cast<float4*>(blk[i]) =
            *reinterpret_cast<const float4*>(out + out_off(rv + i, c4));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + c4 + j >= n) break;
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = blk[i][j];
        *reinterpret_cast<uint4*>(R + (size_t)(col0 + c4 + j) * n + row0 +
                                  rv) = prism::gemm::pack<T>(v);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
      const int r = idx / TILE;
      const int c = idx % TILE;
      if (row0 + r < n && col0 + c < n)
        R[(size_t)(row0 + r) * n + col0 + c] =
            prism::Num<T>::from_f32(out[out_off(r, c)]);
    }
    if (bi == bj) return;
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
      const int r = idx % TILE;
      const int c = idx / TILE;
      if (row0 + r < n && col0 + c < n)
        R[(size_t)(col0 + c) * n + row0 + r] =
            prism::Num<T>::from_f32(out[out_off(r, c)]);
    }
  }
}

template <typename T, bool ALIGNED>
int launch(const void* X, void* R, int batch, int m, int n, int tiles,
           float alpha, float beta, int smem, cudaStream_t s) {
  auto kernel = gram_upper_kernel<T, ALIGNED>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + TILE - 1) / TILE;
  kernel<<<dim3(tiles, 1, batch), THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<T*>(R), m, n, nb, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tiles: the grid's upper tiles, nb(nb+1)/2 (kernels/gram.py::upper_tiles);
// smem: as for prism_matmul_add.
extern "C" int prism_gram_upper(const void* X, void* R, int batch, int m,
                                int n, int tiles, float alpha, float beta,
                                int bf16, int aligned, int smem,
                                void* stream) {
  if (smem != prism::gemm::SMEM_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return aligned ? launch<__nv_bfloat16, true>(X, R, batch, m, n, tiles,
                                                 alpha, beta, smem, s)
                   : launch<__nv_bfloat16, false>(X, R, batch, m, n, tiles,
                                                  alpha, beta, smem, s);
  return aligned ? launch<float, true>(X, R, batch, m, n, tiles, alpha, beta,
                                       smem, s)
                 : launch<float, false>(X, R, batch, m, n, tiles, alpha,
                                        beta, smem, s);
}
