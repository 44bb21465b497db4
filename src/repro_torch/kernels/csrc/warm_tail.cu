// K3: a whole run of constant-alpha Newton-Schulz iterations in one launch
// (the warm tail of DESIGN.md §10), for the three families
//
//   polar  R = I - X^T X                     X <- X g_d(R; a)
//   sign   R = I - X X                       X <- X g_d(R; a)
//   sqrt   R = sym(I - Y X)  (coupled)       X <- X g_d(R; a),
//                                            Y <- g_d(R; a) Y
//
// Replaces the TPU kernel repro/kernels/fused_iter.py::warm_tail (its
// helpers _residual32 / _horner32).  Per iteration:
//   R   = round(I - <product>)                 (fp32 accumulator; for sqrt
//                                               the fp32 I - Y X is
//                                               symmetrized, 0.5 (R + R^T),
//                                               and rounds once after it)
//   acc = alpha * X                            (fp32)
//   for j = d-1 .. 0:  acc = round(acc) @ R + f_j * X   (fp32, f_j * X
//                                                         never rounds)
//   X   = round(acc)
// and, coupled, the same Horner on the left, acc = R @ round(acc) + f_j Y,
// from the same stored R.  The alphas, one per iteration, and the Taylor
// coefficients are kernel arguments passed by value: the launch copies
// nothing from the host to the device beforehand.
//
// What bounds it on the H100: neither the card's memory nor its arithmetic.
// The main paths' warm-tail buckets are small — the q/k/v bias view
// [30, 64, 16] (Muon, polar) and the bias preconditioners [30, 16, 16] and
// [30, 64, 64] (Shampoo, sqrt), 3 iterations each: X (and Y) are read once
// and written once (under 1 MB), and the work is tens of MFLOP, so one
// block per slice leaves most of the 132 SMs idle and the launch and the
// block's dependent chain of small products set the time.
//
// Design: the TPU grid (B, iters), whose X ping-pongs between two VMEM
// buffers, becomes one block per batch slice that loops over the
// iterations; X (and Y), R, the rounded Horner operand and the fp32
// accumulator all stay in shared memory, so device memory sees one read and
// one write of each iterate for the whole run.  The coupled residual reads
// the fp32 accumulator transposed, so its rows are padded to n + 1 floats:
// the 32 lanes of a warp then read 32 different banks.  X's Horner may
// overwrite X in place before Y's runs because R is already stored.  The
// footprint is
//   2 align16(m n item) + (1 + coupled) align16(n n item) + 4 m ld,
//   ld = n + coupled,
// the model kernels/fused_iter.py::smem_bytes gives kernels/ops.py to pick
// the fused tier with (at most 232,448 bytes a block: the [64, 64] coupled
// slice needs 82 KB in fp32, a [1024, 1024] one would need 21 MB and takes
// the grid tier).
#include "common.cuh"

namespace {

constexpr int WARM_THREADS = 256;
constexpr int MAX_DEGREE = 4;
constexpr int MAX_ITERS = 64;  // alphas of one launch (kernel argument)
enum Family { POLAR = 0, SIGN = 1, SQRT = 2 };

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t warm_smem_bytes(int m, int n, int item,
                                                  int family) {
  const size_t coupled = family == SQRT ? 1 : 0;
  const size_t ld = n + coupled;
  return 2 * align16((size_t)m * n * item) +
         (1 + coupled) * align16((size_t)n * n * item) + (size_t)m * ld * 4;
}

struct Coeffs {
  float f[MAX_DEGREE];
};

struct Alphas {
  float a[MAX_ITERS];
};

// dst = round(Horner of src on R): src g_d(R; a) (LEFT false) or
// g_d(R; a) src (LEFT true), src and dst [m, n] (they may alias); the
// fp32 accumulator has row stride ld.  Ends after a barrier.
template <typename T, bool LEFT>
__device__ __forceinline__ void horner(const T* src, T* dst, const T* r,
                                       T* lo, float* acc, int m, int n,
                                       int ld, float a, int degree,
                                       const Coeffs& coeffs) {
  using N = prism::Num<T>;
  const size_t mn = (size_t)m * n;
  const int tid = threadIdx.x;
  for (size_t idx = tid; idx < mn; idx += WARM_THREADS)
    acc[(idx / n) * ld + idx % n] = __fmul_rn(a, N::to_f32(src[idx]));
  __syncthreads();
  for (int j = degree - 1; j >= 0; --j) {
    for (size_t idx = tid; idx < mn; idx += WARM_THREADS)
      lo[idx] = N::from_f32(acc[(idx / n) * ld + idx % n]);
    __syncthreads();
    const float f = coeffs.f[j];
    for (size_t idx = tid; idx < mn; idx += WARM_THREADS) {
      const int row = idx / n;
      const int col = idx % n;
      float s = 0.f;
      if (LEFT) {
        for (int k = 0; k < n; ++k)
          s = fmaf(N::to_f32(r[(size_t)row * n + k]),
                   N::to_f32(lo[(size_t)k * n + col]), s);
      } else {
        for (int k = 0; k < n; ++k)
          s = fmaf(N::to_f32(lo[(size_t)row * n + k]),
                   N::to_f32(r[(size_t)k * n + col]), s);
      }
      acc[(size_t)row * ld + col] =
          __fadd_rn(s, __fmul_rn(f, N::to_f32(src[idx])));
    }
    __syncthreads();
  }
  for (size_t idx = tid; idx < mn; idx += WARM_THREADS)
    dst[idx] = N::from_f32(acc[(idx / n) * ld + idx % n]);
  __syncthreads();
}

template <typename T, int FAMILY>
__global__ void __launch_bounds__(WARM_THREADS)
    warm_tail_kernel(const T* __restrict__ X_in, const T* __restrict__ Y_in,
                     T* __restrict__ X_out, T* __restrict__ Y_out,
                     Alphas alphas, int n_iters, int m, int n, int degree,
                     Coeffs coeffs) {
  extern __shared__ __align__(16) unsigned char smem[];
  using N = prism::Num<T>;
  constexpr bool coupled = FAMILY == SQRT;
  const int ld = n + (coupled ? 1 : 0);
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
  if (coupled) base += align16(nn * sizeof(T));
  float* acc = reinterpret_cast<float*>(base);
  const size_t b = blockIdx.x;
  X_in += b * mn;
  X_out += b * mn;
  const int tid = threadIdx.x;

  for (size_t i = tid; i < mn; i += WARM_THREADS) x[i] = X_in[i];
  if (coupled)
    for (size_t i = tid; i < nn; i += WARM_THREADS) y[i] = Y_in[b * nn + i];
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    if (coupled) {
      // the fp32 residual I - Y X, then 0.5 (R + R^T) rounded once
      for (size_t idx = tid; idx < nn; idx += WARM_THREADS) {
        const int i = idx / n;
        const int j = idx % n;
        float s = 0.f;
        for (int k = 0; k < n; ++k)
          s = fmaf(N::to_f32(y[(size_t)i * n + k]),
                   N::to_f32(x[(size_t)k * n + j]), s);
        acc[(size_t)i * ld + j] = __fsub_rn(i == j ? 1.f : 0.f, s);
      }
      __syncthreads();
      for (size_t idx = tid; idx < nn; idx += WARM_THREADS) {
        const int i = idx / n;
        const int j = idx % n;
        const float sym =
            __fmul_rn(0.5f, __fadd_rn(acc[(size_t)i * ld + j],
                                      acc[(size_t)j * ld + i]));
        r[idx] = N::from_f32(sym);
      }
    } else {
      // R = I - X^T X (polar) or I - X X (sign), rounded once
      for (size_t idx = tid; idx < nn; idx += WARM_THREADS) {
        const int i = idx / n;
        const int j = idx % n;
        float s = 0.f;
        for (int k = 0; k < m; ++k) {
          const float xi = FAMILY == POLAR ? N::to_f32(x[(size_t)k * n + i])
                                           : N::to_f32(x[(size_t)i * n + k]);
          s = fmaf(xi, N::to_f32(x[(size_t)k * n + j]), s);
        }
        r[idx] = N::from_f32(__fsub_rn(i == j ? 1.f : 0.f, s));
      }
    }
    __syncthreads();
    const float a = alphas.a[it];
    horner<T, false>(x, x, r, lo, acc, m, n, ld, a, degree, coeffs);
    if (coupled)
      horner<T, true>(y, y, r, lo, acc, n, n, ld, a, degree, coeffs);
  }

  for (size_t i = tid; i < mn; i += WARM_THREADS) X_out[i] = x[i];
  if (coupled)
    for (size_t i = tid; i < nn; i += WARM_THREADS) Y_out[b * nn + i] = y[i];
}

template <typename T, int FAMILY>
int launch(const void* X, const void* Y, void* X_out, void* Y_out,
           const Alphas& alphas, int n_iters, int batch, int m, int n,
           int degree, const Coeffs& coeffs, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        warm_tail_kernel<T, FAMILY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  warm_tail_kernel<T, FAMILY><<<batch, WARM_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(X_out), static_cast<T*>(Y_out), alphas, n_iters, m, n,
      degree, coeffs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_family(int family, const void* X, const void* Y, void* X_out,
                  void* Y_out, const Alphas& alphas, int n_iters, int batch,
                  int m, int n, int degree, const Coeffs& coeffs, size_t smem,
                  cudaStream_t s) {
  if (family == SIGN)
    return launch<T, SIGN>(X, Y, X_out, Y_out, alphas, n_iters, batch, m, n,
                           degree, coeffs, smem, s);
  if (family == SQRT)
    return launch<T, SQRT>(X, Y, X_out, Y_out, alphas, n_iters, batch, m, n,
                           degree, coeffs, smem, s);
  return launch<T, POLAR>(X, Y, X_out, Y_out, alphas, n_iters, batch, m, n,
                          degree, coeffs, smem, s);
}

}  // namespace

// family: 0 polar, 1 sign, 2 sqrt (Y and Y_out are read only for sqrt;
// sign and sqrt need m == n).  alphas and coeffs are host arrays, copied
// into the kernel's arguments.  smem_bytes is the footprint the caller's
// model computed; a launch whose model disagrees with the kernel's own
// layout is refused rather than run out of bounds.
extern "C" int prism_warm_tail(const void* X, const void* Y, void* X_out,
                               void* Y_out, const float* alphas, int n_iters,
                               int batch, int m, int n, int degree,
                               const float* coeffs, int family,
                               long long smem_bytes, int bf16, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || degree < 1 || degree > MAX_DEGREE ||
      n_iters < 1 || n_iters > MAX_ITERS || family < POLAR ||
      family > SQRT || (family != POLAR && m != n) ||
      (family == SQRT && (Y == nullptr || Y_out == nullptr)))
    return cudaErrorInvalidValue;
  const size_t need = warm_smem_bytes(m, n, bf16 ? 2 : 4, family);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  Coeffs c = {};
  for (int j = 0; j < degree; ++j) c.f[j] = coeffs[j];
  Alphas a = {};
  for (int i = 0; i < n_iters; ++i) a.a[i] = alphas[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_family<__nv_bfloat16>(family, X, Y, X_out, Y_out, a,
                                        n_iters, batch, m, n, degree, c,
                                        need, s);
  return launch_family<float>(family, X, Y, X_out, Y_out, a, n_iters, batch,
                              m, n, degree, c, need, s);
}
