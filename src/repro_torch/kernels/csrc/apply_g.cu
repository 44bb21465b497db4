// K7: the second launch of a fused-tier fitted PRISM iteration:
// X' = X g_d(R; alpha) with a fitted alpha per batch slice and, for the
// coupled sqrt family, Y' = g_d(R; alpha) Y from the same R, in the same
// launch.
//
// Replaces the TPU kernel repro/kernels/fused_iter.py::apply_g
// (_apply_kernel with _horner32, right side and, coupled, left side):
//   acc = alpha_b * X                                  (fp32)
//   for j = d-1 .. 0:  acc = round(acc) @ R + f_j * X   (fp32, f_j * X
//                                                        never rounds)
//   X'  = round(acc)
// and, coupled, acc = alpha_b * Y; acc = R @ round(acc) + f_j * Y;
// Y' = round(acc).  alpha is a [B] fp32 device tensor (the fit's output)
// that each block reads for its own slice: it is never rounded to the
// operand dtype and never passes through the host (DESIGN.md §9/§10).
//
// What bounds it on the H100: neither memory nor arithmetic.  On the main
// paths (the q/k/v bias view [30, 64, 16], degree 1, Muon PRISM-3; the bias
// preconditioners [30, 16, 16] and [30, 64, 64], degree 2, coupled,
// Shampoo) a slice moves under 70 KB and does under 2 MFLOP; the launch
// sets the time, and one block per slice leaves most of the 132 SMs idle.
//
// Design: the TPU's grid (B,) with the Horner accumulator in VMEM becomes
// one block per slice with X (and Y), the rounded Horner operand, R and the
// fp32 accumulator in shared memory; the two coupled Horner chains run one
// after the other through the same operand and accumulator buffers, so the
// footprint is
//   2 align16(m n item) + (1 + coupled) align16(n n item) + 4 m n
// bytes (kernels/fused_iter.py::apply_g_smem_bytes).  The epilogues use
// __fmul_rn / __fadd_rn so that they round where the plain version does.
#include "common.cuh"

namespace {

constexpr int AG_THREADS = 256;
constexpr int MAX_DEGREE = 4;

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t ag_smem_bytes(int m, int n, int item,
                                                int coupled) {
  return 2 * align16((size_t)m * n * item) +
         (1 + coupled) * align16((size_t)n * n * item) + (size_t)m * n * 4;
}

struct Coeffs {
  float f[MAX_DEGREE];
};

// out = round(src g_d(R; a)) (LEFT false) or round(g_d(R; a) src) (LEFT
// true); src [m, n] in shared memory, out [m, n] in device memory.
template <typename T, bool LEFT>
__device__ __forceinline__ void horner(const T* src, T* __restrict__ out,
                                       const T* r, T* lo, float* acc, int m,
                                       int n, float a, int degree,
                                       const Coeffs& coeffs) {
  using N = prism::Num<T>;
  const size_t mn = (size_t)m * n;
  const int tid = threadIdx.x;
  for (size_t i = tid; i < mn; i += AG_THREADS)
    acc[i] = __fmul_rn(a, N::to_f32(src[i]));
  __syncthreads();
  for (int j = degree - 1; j >= 0; --j) {
    for (size_t idx = tid; idx < mn; idx += AG_THREADS)
      lo[idx] = N::from_f32(acc[idx]);
    __syncthreads();
    const float f = coeffs.f[j];
    for (size_t idx = tid; idx < mn; idx += AG_THREADS) {
      const size_t row = idx / n;
      const size_t col = idx % n;
      float s = 0.f;
      if (LEFT) {
        for (int k = 0; k < n; ++k)
          s = fmaf(N::to_f32(r[row * n + k]),
                   N::to_f32(lo[(size_t)k * n + col]), s);
      } else {
        for (int k = 0; k < n; ++k)
          s = fmaf(N::to_f32(lo[row * n + k]),
                   N::to_f32(r[(size_t)k * n + col]), s);
      }
      acc[idx] = __fadd_rn(s, __fmul_rn(f, N::to_f32(src[idx])));
    }
    __syncthreads();
  }
  for (size_t i = tid; i < mn; i += AG_THREADS) out[i] = N::from_f32(acc[i]);
  __syncthreads();
}

template <typename T, bool COUPLED>
__global__ void __launch_bounds__(AG_THREADS)
    apply_g_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                   const T* __restrict__ R, const float* __restrict__ alpha,
                   T* __restrict__ X_out, T* __restrict__ Y_out, int m, int n,
                   int degree, Coeffs coeffs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t mn = (size_t)m * n;
  const size_t nn = (size_t)n * n;
  unsigned char* base = smem;
  T* x = reinterpret_cast<T*>(base);
  base += align16(mn * sizeof(T));
  T* lo = reinterpret_cast<T*>(base);
  base += align16(mn * sizeof(T));
  T* r = reinterpret_cast<T*>(base);
  base += align16(nn * sizeof(T));
  T* y = reinterpret_cast<T*>(base);  // coupled only
  if (COUPLED) base += align16(nn * sizeof(T));
  float* acc = reinterpret_cast<float*>(base);
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const float a = alpha[b];

  for (size_t i = tid; i < mn; i += AG_THREADS) x[i] = X[b * mn + i];
  for (size_t i = tid; i < nn; i += AG_THREADS) r[i] = R[b * nn + i];
  if (COUPLED)
    for (size_t i = tid; i < nn; i += AG_THREADS) y[i] = Y[b * nn + i];
  __syncthreads();
  horner<T, false>(x, X_out + b * mn, r, lo, acc, m, n, a, degree, coeffs);
  if (COUPLED)
    horner<T, true>(y, Y_out + b * nn, r, lo, acc, n, n, a, degree, coeffs);
}

template <typename T, bool COUPLED>
int launch(const void* X, const void* Y, const void* R, const float* alpha,
           void* X_out, void* Y_out, int batch, int m, int n, int degree,
           const Coeffs& coeffs, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        apply_g_kernel<T, COUPLED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  apply_g_kernel<T, COUPLED><<<batch, AG_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<const T*>(R), alpha, static_cast<T*>(X_out),
      static_cast<T*>(Y_out), m, n, degree, coeffs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_coupled(int coupled, const void* X, const void* Y, const void* R,
                   const float* alpha, void* X_out, void* Y_out, int batch,
                   int m, int n, int degree, const Coeffs& coeffs,
                   size_t smem, cudaStream_t s) {
  if (coupled)
    return launch<T, true>(X, Y, R, alpha, X_out, Y_out, batch, m, n, degree,
                           coeffs, smem, s);
  return launch<T, false>(X, Y, R, alpha, X_out, Y_out, batch, m, n, degree,
                          coeffs, smem, s);
}

}  // namespace

// Y and Y_out are null for the one-sided application and both set for the
// coupled one (which needs m == n).  smem_bytes is the footprint the
// caller's model computed; a launch whose model disagrees with the layout
// above is refused rather than run out of bounds.
extern "C" int prism_apply_g(const void* X, const void* Y, const void* R,
                             const void* alpha, void* X_out, void* Y_out,
                             int batch, int m, int n, int degree,
                             const float* coeffs, long long smem_bytes,
                             int bf16, void* stream) {
  const int coupled = Y != nullptr ? 1 : 0;
  if (batch < 1 || m < 1 || n < 1 || degree < 1 || degree > MAX_DEGREE ||
      (Y_out != nullptr) != (coupled == 1) || (coupled && m != n))
    return cudaErrorInvalidValue;
  const size_t need = ag_smem_bytes(m, n, bf16 ? 2 : 4, coupled);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  Coeffs c = {};
  for (int j = 0; j < degree; ++j) c.f[j] = coeffs[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  if (bf16)
    return launch_coupled<__nv_bfloat16>(coupled, X, Y, R, a, X_out, Y_out,
                                         batch, m, n, degree, c, need, s);
  return launch_coupled<float>(coupled, X, Y, R, a, X_out, Y_out, batch, m,
                               n, degree, c, need, s);
}
