// K7: the second launch of a fused-tier fitted PRISM iteration, polar
// family: X' = X g_d(R; alpha) with a fitted alpha per batch slice.
//
// Replaces the TPU kernel repro/kernels/fused_iter.py::apply_g
// (_apply_kernel with _horner32, right side):
//   acc = alpha_b * X                                  (fp32)
//   for j = d-1 .. 0:  acc = round(acc) @ R + f_j * X   (fp32, f_j * X
//                                                        never rounds)
//   X'  = round(acc)
// alpha is a [B] fp32 device tensor (the fit's output) that each block
// reads for its own slice: it is never rounded to the operand dtype and
// never passes through the host (DESIGN.md §9/§10).
//
// What bounds it on the H100: neither memory nor arithmetic.  On the main
// path (the q/k/v bias view [30, 64, 16], degree 1) a slice moves ~5 KB and
// does ~40 kFLOP; the launch sets the time, and one block per slice leaves
// most of the 132 SMs idle.
//
// Design: the TPU's grid (B,) with the Horner accumulator in VMEM becomes
// one block per slice with X, the rounded Horner operand, R and the fp32
// accumulator in shared memory — the layout of K3 (warm_tail.cu), so the
// footprint is the same  2 align16(m n item) + align16(n n item) + 4 m n
// bytes (kernels/fused_iter.py::apply_g_smem_bytes).  The epilogues use
// __fmul_rn / __fadd_rn so that they round where the plain version does.
// The left-side application of the coupled sqrt family comes with Shampoo.
#include "common.cuh"

namespace {

constexpr int AG_THREADS = 256;
constexpr int MAX_DEGREE = 4;

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t ag_smem_bytes(int m, int n, int item) {
  return 2 * align16((size_t)m * n * item) + align16((size_t)n * n * item) +
         (size_t)m * n * 4;
}

struct Coeffs {
  float f[MAX_DEGREE];
};

template <typename T>
__global__ void __launch_bounds__(AG_THREADS)
    apply_g_kernel(const T* __restrict__ X, const T* __restrict__ R,
                   const float* __restrict__ alpha, T* __restrict__ out,
                   int m, int n, int degree, Coeffs coeffs) {
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
  X += b * mn;
  R += b * nn;
  out += b * mn;
  const int tid = threadIdx.x;
  const float a = alpha[b];

  for (size_t i = tid; i < mn; i += AG_THREADS) {
    const T v = X[i];
    x[i] = v;
    acc[i] = __fmul_rn(a, N::to_f32(v));
  }
  for (size_t i = tid; i < nn; i += AG_THREADS) r[i] = R[i];
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
      for (int k = 0; k < n; ++k)
        s = fmaf(N::to_f32(lo[row * n + k]), N::to_f32(r[(size_t)k * n + col]),
                 s);
      acc[idx] = __fadd_rn(s, __fmul_rn(f, N::to_f32(x[idx])));
    }
    __syncthreads();
  }
  for (size_t i = tid; i < mn; i += AG_THREADS) out[i] = N::from_f32(acc[i]);
}

template <typename T>
int launch(const void* X, const void* R, const float* alpha, void* out,
           int batch, int m, int n, int degree, Coeffs coeffs, size_t smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        apply_g_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  apply_g_kernel<T><<<batch, AG_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(R), alpha,
      static_cast<T*>(out), m, n, degree, coeffs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem_bytes is the footprint the caller's model computed; a launch whose
// model disagrees with the layout above is refused rather than run out of
// bounds.
extern "C" int prism_apply_g(const void* X, const void* R, const void* alpha,
                             void* out, int batch, int m, int n, int degree,
                             const float* coeffs, long long smem_bytes,
                             int bf16, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || degree < 1 || degree > MAX_DEGREE)
    return cudaErrorInvalidValue;
  const size_t need = ag_smem_bytes(m, n, bf16 ? 2 : 4);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  Coeffs c = {};
  for (int j = 0; j < degree; ++j) c.f[j] = coeffs[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  if (bf16)
    return launch<__nv_bfloat16>(X, R, a, out, batch, m, n, degree, c, need,
                                 s);
  return launch<float>(X, R, a, out, batch, m, n, degree, c, need, s);
}
