// K3: a whole run of constant-alpha polar Newton-Schulz iterations in one
// launch (the warm tail of DESIGN.md §10), polar family.
//
// Replaces the TPU kernel repro/kernels/fused_iter.py::warm_tail (its
// helpers _residual32 / _horner32): per iteration
//   R   = round(I - X^T X)                    (fp32 accumulator)
//   acc = alpha * X                            (fp32)
//   for j = d-1 .. 0:  acc = round(acc) @ R + f_j * X   (fp32, f_j * X
//                                                         never rounds)
//   X   = round(acc)
// with alpha read from a small device array, one value per iteration.
//
// What bounds it on the H100: neither the card's memory nor its arithmetic.
// The main path's warm-tail bucket is the q/k/v bias view [30, 64, 16]
// (3 iterations): X is read once and written once (about 250 KB in fp32),
// and the work is a few MFLOP, so one block per slice leaves most of the
// 132 SMs idle and the launch and the block's dependent chain of small
// products set the time.
//
// Design: the TPU grid (B, iters), whose X ping-pongs between two VMEM
// buffers, becomes one block per batch slice that loops over the
// iterations; X, R, the rounded Horner operand and the fp32 Horner
// accumulator all stay in shared memory, so device memory sees one read
// and one write of X for the whole run.  The footprint is
//   2 * align16(m*n*item) + align16(n*n*item) + 4*m*n   bytes,
// the model kernels/ops.py::fused_smem_bytes uses to pick the fused tier
// (at most 232,448 bytes a block; the [64, 16] bias view needs 13 KB in
// fp32, a [1024, 1024] view would need 16 MB and takes the grid tier).
#include "common.cuh"

namespace {

constexpr int WARM_THREADS = 256;
constexpr int MAX_DEGREE = 4;

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t warm_smem_bytes(int m, int n, int item) {
  return 2 * align16((size_t)m * n * item) + align16((size_t)n * n * item) +
         (size_t)m * n * 4;
}

struct Coeffs {
  float f[MAX_DEGREE];
};

template <typename T>
__global__ void __launch_bounds__(WARM_THREADS)
    warm_tail_kernel(const T* __restrict__ X_in, T* __restrict__ X_out,
                     const float* __restrict__ alphas, int n_iters, int m,
                     int n, int degree, Coeffs coeffs) {
  extern __shared__ __align__(16) unsigned char smem[];
  using N = prism::Num<T>;
  const size_t mn = (size_t)m * n;
  const size_t nn = (size_t)n * n;
  T* x = reinterpret_cast<T*>(smem);
  T* lo = reinterpret_cast<T*>(smem + align16(mn * sizeof(T)));
  T* r = reinterpret_cast<T*>(smem + 2 * align16(mn * sizeof(T)));
  float* acc = reinterpret_cast<float*>(smem + 2 * align16(mn * sizeof(T)) +
                                        align16(nn * sizeof(T)));
  const size_t b = blockIdx.x;
  X_in += b * mn;
  X_out += b * mn;
  const int tid = threadIdx.x;

  for (size_t i = tid; i < mn; i += WARM_THREADS) x[i] = X_in[i];
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // residual R = I - X^T X, rounded once
    for (size_t idx = tid; idx < nn; idx += WARM_THREADS) {
      const int i = idx / n;
      const int j = idx % n;
      float s = 0.f;
      for (int k = 0; k < m; ++k)
        s = fmaf(N::to_f32(x[(size_t)k * n + i]),
                 N::to_f32(x[(size_t)k * n + j]), s);
      r[idx] = N::from_f32(__fsub_rn(i == j ? 1.f : 0.f, s));
    }
    const float a = alphas[it];
    for (size_t idx = tid; idx < mn; idx += WARM_THREADS)
      acc[idx] = __fmul_rn(a, N::to_f32(x[idx]));
    __syncthreads();
    // Horner on R: acc = round(acc) @ R + f_j * X, j = d-1 .. 0
    for (int j = degree - 1; j >= 0; --j) {
      for (size_t idx = tid; idx < mn; idx += WARM_THREADS)
        lo[idx] = N::from_f32(acc[idx]);
      __syncthreads();
      const float f = coeffs.f[j];
      for (size_t idx = tid; idx < mn; idx += WARM_THREADS) {
        const int row = idx / n;
        const int col = idx % n;
        float s = 0.f;
        for (int k = 0; k < n; ++k)
          s = fmaf(N::to_f32(lo[(size_t)row * n + k]),
                   N::to_f32(r[(size_t)k * n + col]), s);
        acc[idx] = __fadd_rn(s, __fmul_rn(f, N::to_f32(x[idx])));
      }
      __syncthreads();
    }
    for (size_t idx = tid; idx < mn; idx += WARM_THREADS)
      x[idx] = N::from_f32(acc[idx]);
    __syncthreads();
  }

  for (size_t i = tid; i < mn; i += WARM_THREADS) X_out[i] = x[i];
}

template <typename T>
int launch(const void* X, void* out, const float* alphas, int n_iters,
           int batch, int m, int n, int degree, Coeffs coeffs, size_t smem,
           cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(warm_tail_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  warm_tail_kernel<T><<<batch, WARM_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<T*>(out), alphas, n_iters, m, n,
      degree, coeffs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem_bytes is the footprint the caller's model computed; a launch whose
// model disagrees with the kernel's own layout is refused rather than run
// out of bounds.
extern "C" int prism_warm_tail(const void* X, void* out, const void* alphas,
                               int n_iters, int batch, int m, int n,
                               int degree, const float* coeffs,
                               long long smem_bytes, int bf16, void* stream) {
  if (degree < 1 || degree > MAX_DEGREE) return cudaErrorInvalidValue;
  const size_t need = warm_smem_bytes(m, n, bf16 ? 2 : 4);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  Coeffs c = {};
  for (int j = 0; j < degree; ++j) c.f[j] = coeffs[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alphas);
  if (bf16)
    return launch<__nv_bfloat16>(X, out, a, n_iters, batch, m, n, degree, c,
                                 need, s);
  return launch<float>(X, out, a, n_iters, batch, m, n, degree, c, need, s);
}
