// K1: D = alpha * A @ B + beta * C, batched, one launch per [B, m, n] bucket.
//
// Replaces the TPU kernel repro/kernels/matmul_add.py::matmul_add (the
// Horner GEMMs of the grid-tier Newton-Schulz update, newton_schulz._mm).
//
// What bounds it on the H100: operations.  On the main path's shapes
// ([40 or 100, 1024, 1024] @ [., 1024, 1024] and [20, 4096, 1024] @
// [20, 1024, 1024]) a launch does 2*m*n*k flops per slice against about
// 4 bytes * (m*k + k*n + 2*m*n) of traffic, some 170 flops a byte in fp32:
// far above the 20 flops a byte where the fp32 SIMT units (67 TFLOP/s) stop
// waiting on memory (3.35 TB/s).  fp32 operands must not use TF32, so the
// rate to reach is the plain-FMA one; bf16 runs on the tensor cores.
//
// Design: the TPU kernel's sequential K grid axis with its fp32 VMEM
// scratch becomes the pipelined loop of gemm.cuh inside one block, with
// the fp32 accumulator in registers.  The grid is (output tiles, 1,
// batch), so a whole bucket is one launch (DESIGN.md §7); inside a slice
// the tiles run in groups of GROUP row tiles, column by column.  C is read
// only in the epilogue: alpha * acc + beta * C in fp32, then one rounding,
// C read and D written with 16-byte accesses along the rows.  Ragged
// edges are zero-filled in shared memory, never padded in device memory.
#include "gemm.cuh"

namespace {

using prism::gemm::Core;
using prism::gemm::GROUP;
using prism::gemm::THREADS;
using prism::gemm::TILE;

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, ALIGNED ? 2 : 1)
    matmul_add_kernel(const T* __restrict__ A, const T* __restrict__ B,
                      const T* __restrict__ C, T* __restrict__ D, int M,
                      int N, int K, float alpha, float beta, int has_c) {
  extern __shared__ __align__(16) char smem[];
  const size_t b = blockIdx.z;
  A += b * (size_t)M * K;
  B += b * (size_t)K * N;
  D += b * (size_t)M * N;
  if (has_c) C += b * (size_t)M * N;
  // grouped order: GROUP row tiles at a time, column-major inside a group
  const int mt = (M + TILE - 1) / TILE;
  const int nt = (N + TILE - 1) / TILE;
  const int t = blockIdx.x;
  const int first = (t / (GROUP * nt)) * GROUP;
  const int rows = min(mt - first, GROUP);
  const int w = t - first * nt;
  const int bi = first + w % rows;
  const int bj = w / rows;

  Core<T, false, ALIGNED> core{A, B, M, N, K, bi * TILE, bj * TILE};
  float acc[64];
  core.run(smem, acc);
  float* out = reinterpret_cast<float*>(smem);
  Core<T, false, ALIGNED>::stage_out(out, acc,
                                     [](float v, int, int) { return v; });
  __syncthreads();

  const int row0 = bi * TILE;
  const int col0 = bj * TILE;
  if constexpr (ALIGNED) {
    constexpr int VEC = Core<T, false, ALIGNED>::VEC;
    for (int idx = threadIdx.x; idx < TILE * TILE / VEC; idx += THREADS) {
      const int r = idx / (TILE / VEC);
      const int c = (idx % (TILE / VEC)) * VEC;
      if (row0 + r >= M || col0 + c >= N) continue;
      const size_t o = (size_t)(row0 + r) * N + col0 + c;
      float v[VEC];
      float cv[VEC];
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        *reinterpret_cast<float4*>(&v[q]) = *reinterpret_cast<const float4*>(
            out + prism::gemm::out_off(r, c + q));
      if (has_c)
        prism::gemm::unpack<T>(*reinterpret_cast<const uint4*>(C + o), cv);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        v[q] = __fmul_rn(alpha, v[q]);
        if (has_c) v[q] = __fadd_rn(v[q], __fmul_rn(beta, cv[q]));
      }
      *reinterpret_cast<uint4*>(D + o) = prism::gemm::pack<T>(v);
    }
  } else {
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
      const int r = idx / TILE;
      const int c = idx % TILE;
      if (row0 + r >= M || col0 + c >= N) continue;
      const size_t o = (size_t)(row0 + r) * N + col0 + c;
      float v = __fmul_rn(alpha, out[prism::gemm::out_off(r, c)]);
      if (has_c)
        v = __fadd_rn(v, __fmul_rn(beta, prism::Num<T>::to_f32(C[o])));
      D[o] = prism::Num<T>::from_f32(v);
    }
  }
}

template <typename T, bool ALIGNED>
int launch(const void* A, const void* B, const void* C, void* D, int batch,
           int M, int N, int K, float alpha, float beta, int has_c,
           int smem, cudaStream_t s) {
  auto kernel = matmul_add_kernel<T, ALIGNED>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
  kernel<<<dim3(tiles, 1, batch), THREADS, smem, s>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(D), M, N, K, alpha, beta,
      has_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem: the dynamic shared memory the wrapper sized the launch with
// (kernels/matmul_add.py::smem_bytes); refused unless it is the core's.
extern "C" int prism_matmul_add(const void* A, const void* B, const void* C,
                                void* D, int batch, int M, int N, int K,
                                float alpha, float beta, int has_c, int bf16,
                                int aligned, int smem, void* stream) {
  if (smem != prism::gemm::SMEM_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return aligned ? launch<__nv_bfloat16, true>(A, B, C, D, batch, M, N, K,
                                                 alpha, beta, has_c, smem, s)
                   : launch<__nv_bfloat16, false>(A, B, C, D, batch, M, N,
                                                  K, alpha, beta, has_c,
                                                  smem, s);
  return aligned ? launch<float, true>(A, B, C, D, batch, M, N, K, alpha,
                                       beta, has_c, smem, s)
                 : launch<float, false>(A, B, C, D, batch, M, N, K, alpha,
                                        beta, has_c, smem, s);
}
