// K6: the first launch of a fused-tier fitted PRISM iteration: the family
// residual R AND its whole sketched power-trace chain
// t_i = tr(S R^i S^T), i = 1..max_power, in one launch per bucket, with
//
//   polar  R = I - X^T X      sign  R = I - X X
//   sqrt   R = sym(I - Y X) = 0.5 (I - Y X + (I - Y X)^T)   (coupled)
//
// Replaces the TPU kernel repro/kernels/fused_iter.py::residual_chain
// (_res_chain_kernel).  Per slice: I - <product> is formed on an fp32
// accumulator (and, for sqrt, symmetrized there) and rounded ONCE to the
// operand dtype; that rounded R is written out (the Horner launch K7
// reads it) and the chain runs on it from shared memory, each trace
// reduced from the fp32 accumulator of R @ V before V rounds (DESIGN.md
// §9).
//
// What bounds it on the H100: neither memory nor arithmetic.  On the main
// paths (the q/k/v bias view [30, 64, 16], 6 powers, Muon PRISM-3; the
// bias preconditioners [30, 16, 16] and [30, 64, 64], 10 powers, Shampoo)
// a slice moves under 50 KB and does under 2 MFLOP, so the launch and the
// block's chain of dependent small steps set the time; one block per slice
// leaves most of the 132 SMs idle.
//
// Design: the TPU's grid (B,) with X, R and the chain in VMEM becomes one
// block per slice with X (and Y), R, St and two V buffers (all [p][n]
// transposed) in shared memory.  The coupled residual is kept in fp32 in
// an [n][n + 1] buffer, padded so that the transposed read of the
// symmetrization hits 32 different banks.  Each power computes V' element
// by element (thread per (column, row) of V', k ascending with FMAs); each
// thread adds its trace terms in a fixed order and thread 0 sums the
// threads' partials in order, so the traces are deterministic.  Footprint:
//   align16(m n item) + align16(n n item) + 3 align16(p n item) + 4 THREADS
//   + coupled (align16(n n item) + 4 n (n + 1))
// (kernels/fused_iter.py::residual_chain_smem_bytes), part of the model
// kernels/ops.py::fused_fits picks the fused tier with.
#include "common.cuh"

namespace {

constexpr int RC_THREADS = 256;
constexpr int MAX_SKETCH = 16;
enum Family { POLAR = 0, SIGN = 1, SQRT = 2 };

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t rc_smem_bytes(int m, int n, int p,
                                                int item, int family) {
  size_t b = align16((size_t)m * n * item) + align16((size_t)n * n * item) +
             3 * align16((size_t)p * n * item) + 4 * RC_THREADS;
  if (family == SQRT)
    b += align16((size_t)n * n * item) + (size_t)n * (n + 1) * 4;
  return b;
}

template <typename T, int FAMILY>
__global__ void __launch_bounds__(RC_THREADS)
    residual_chain_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                          const T* __restrict__ St, T* __restrict__ R_out,
                          float* __restrict__ t, int m, int n, int p,
                          int max_power) {
  extern __shared__ __align__(16) unsigned char smem[];
  using N = prism::Num<T>;
  const size_t mn = (size_t)m * n;
  const size_t nn = (size_t)n * n;
  const size_t pn = (size_t)p * n;
  const size_t vbytes = align16(pn * sizeof(T));
  unsigned char* base = smem;
  T* x = reinterpret_cast<T*>(base);
  base += align16(mn * sizeof(T));
  T* r = reinterpret_cast<T*>(base);
  base += align16(nn * sizeof(T));
  T* stt = reinterpret_cast<T*>(base);
  T* v0 = reinterpret_cast<T*>(base + vbytes);
  T* v1 = reinterpret_cast<T*>(base + 2 * vbytes);
  base += 3 * vbytes;
  float* part = reinterpret_cast<float*>(base);
  base += 4 * RC_THREADS;
  // coupled only: Y, and the fp32 residual with rows padded to n + 1
  T* y = reinterpret_cast<T*>(base);
  float* r32 = reinterpret_cast<float*>(base + align16(nn * sizeof(T)));
  const int ld = n + 1;
  const size_t b = blockIdx.x;
  X += b * mn;
  R_out += b * nn;
  t += b * (size_t)max_power;
  const int tid = threadIdx.x;

  for (size_t i = tid; i < mn; i += RC_THREADS) x[i] = X[i];
  if (FAMILY == SQRT)
    for (size_t i = tid; i < nn; i += RC_THREADS) y[i] = Y[b * nn + i];
  for (size_t i = tid; i < pn; i += RC_THREADS)
    stt[(i % p) * n + i / p] = St[i];
  __syncthreads();

  if (FAMILY == SQRT) {
    // the fp32 residual I - Y X, then 0.5 (R + R^T) rounded once
    for (size_t idx = tid; idx < nn; idx += RC_THREADS) {
      const int i = idx / n;
      const int j = idx % n;
      float s = 0.f;
      for (int k = 0; k < n; ++k)
        s = fmaf(N::to_f32(y[(size_t)i * n + k]),
                 N::to_f32(x[(size_t)k * n + j]), s);
      r32[(size_t)i * ld + j] = __fsub_rn(i == j ? 1.f : 0.f, s);
    }
    __syncthreads();
    for (size_t idx = tid; idx < nn; idx += RC_THREADS) {
      const int i = idx / n;
      const int j = idx % n;
      const float sym =
          __fmul_rn(0.5f, __fadd_rn(r32[(size_t)i * ld + j],
                                    r32[(size_t)j * ld + i]));
      const T o = N::from_f32(sym);
      r[idx] = o;
      R_out[idx] = o;
    }
  } else {
    // R = I - X^T X (polar) or I - X X (sign) on the fp32 accumulator,
    // rounded once
    for (size_t idx = tid; idx < nn; idx += RC_THREADS) {
      const int i = idx / n;
      const int j = idx % n;
      float s = 0.f;
      for (int k = 0; k < m; ++k) {
        const float xi = FAMILY == POLAR ? N::to_f32(x[(size_t)k * n + i])
                                         : N::to_f32(x[(size_t)i * n + k]);
        s = fmaf(xi, N::to_f32(x[(size_t)k * n + j]), s);
      }
      const T o = N::from_f32(__fsub_rn(i == j ? 1.f : 0.f, s));
      r[idx] = o;
      R_out[idx] = o;
    }
  }
  __syncthreads();

  for (int pw = 0; pw < max_power; ++pw) {
    const T* vin = pw == 0 ? stt : ((pw & 1) ? v0 : v1);
    T* vout = (pw & 1) ? v1 : v0;
    float tpart = 0.f;
    for (size_t idx = tid; idx < pn; idx += RC_THREADS) {
      const size_t c = idx / n;
      const size_t row = idx % n;
      float s = 0.f;
      for (int k = 0; k < n; ++k)
        s = fmaf(N::to_f32(r[row * n + k]), N::to_f32(vin[c * n + k]), s);
      // the trace reads the fp32 sum, before V rounds
      tpart = fmaf(N::to_f32(stt[idx]), s, tpart);
      vout[idx] = N::from_f32(s);
    }
    part[tid] = tpart;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < RC_THREADS; ++i) s = __fadd_rn(s, part[i]);
      t[pw] = s;
    }
    __syncthreads();
  }
}

template <typename T, int FAMILY>
int launch(const void* X, const void* Y, const void* St, void* R, float* t,
           int batch, int m, int n, int p, int max_power, size_t smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        residual_chain_kernel<T, FAMILY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  residual_chain_kernel<T, FAMILY><<<batch, RC_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<const T*>(St), static_cast<T*>(R), t, m, n, p, max_power);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_family(int family, const void* X, const void* Y, const void* St,
                  void* R, float* t, int batch, int m, int n, int p,
                  int max_power, size_t smem, cudaStream_t s) {
  if (family == SIGN)
    return launch<T, SIGN>(X, Y, St, R, t, batch, m, n, p, max_power, smem,
                           s);
  if (family == SQRT)
    return launch<T, SQRT>(X, Y, St, R, t, batch, m, n, p, max_power, smem,
                           s);
  return launch<T, POLAR>(X, Y, St, R, t, batch, m, n, p, max_power, smem,
                          s);
}

}  // namespace

// family: 0 polar, 1 sign, 2 sqrt (Y is read only for sqrt; sign and sqrt
// need m == n).  smem_bytes is the footprint the caller's model computed;
// a launch whose model disagrees with the layout above is refused rather
// than run out of bounds.
extern "C" int prism_residual_chain(const void* X, const void* Y,
                                    const void* St, void* R, void* t,
                                    int batch, int m, int n, int p,
                                    int max_power, int family,
                                    long long smem_bytes, int bf16,
                                    void* stream) {
  if (batch < 1 || m < 1 || n < 1 || p < 1 || p > MAX_SKETCH ||
      max_power < 0 || family < POLAR || family > SQRT ||
      (family != POLAR && m != n) || (family == SQRT && Y == nullptr))
    return cudaErrorInvalidValue;
  const size_t need = rc_smem_bytes(m, n, p, bf16 ? 2 : 4, family);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tf = static_cast<float*>(t);
  if (bf16)
    return launch_family<__nv_bfloat16>(family, X, Y, St, R, tf, batch, m, n,
                                        p, max_power, need, s);
  return launch_family<float>(family, X, Y, St, R, tf, batch, m, n, p,
                              max_power, need, s);
}
