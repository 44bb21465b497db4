// K6: the first launch of a fused-tier fitted PRISM iteration, polar
// family: the residual R = I - X^T X AND its whole sketched power-trace
// chain t_i = tr(S R^i S^T), i = 1..max_power, in one launch per bucket.
//
// Replaces the TPU kernel repro/kernels/fused_iter.py::residual_chain
// (_res_chain_kernel, polar).  Per slice: I - X^T X is formed on an fp32
// accumulator and rounded ONCE to the operand dtype; that rounded R is
// written out (the Horner launch K7 reads it) and the chain runs on it
// from shared memory, each trace reduced from the fp32 accumulator of
// R @ V before V rounds (DESIGN.md §9).
//
// What bounds it on the H100: neither memory nor arithmetic.  On the main
// path (the q/k/v bias view [30, 64, 16], 6 powers at degree 1) a slice
// moves ~5 KB and does ~0.1 MFLOP, so the launch and the block's chain of
// dependent small steps set the time; one block per slice leaves most of
// the 132 SMs idle.
//
// Design: the TPU's grid (B,) with X, R and the chain in VMEM becomes one
// block per slice with X, R, St and two V buffers (all [p][n] transposed)
// in shared memory.  Each power computes V' element by element (thread
// per (column, row) of V', k ascending with FMAs); each thread adds its
// trace terms in a fixed order and thread 0 sums the threads' partials in
// order, so the traces are deterministic.  Footprint:
//   align16(m n item) + align16(n n item) + 3 align16(p n item) + 4 THREADS
// (kernels/fused_iter.py::residual_chain_smem_bytes), part of the model
// kernels/ops.py::fused_fits picks the fused tier with.
#include "common.cuh"

namespace {

constexpr int RC_THREADS = 256;
constexpr int MAX_SKETCH = 16;

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t rc_smem_bytes(int m, int n, int p,
                                                int item) {
  return align16((size_t)m * n * item) + align16((size_t)n * n * item) +
         3 * align16((size_t)p * n * item) + 4 * RC_THREADS;
}

template <typename T>
__global__ void __launch_bounds__(RC_THREADS)
    residual_chain_kernel(const T* __restrict__ X, const T* __restrict__ St,
                          T* __restrict__ R_out, float* __restrict__ t,
                          int m, int n, int p, int max_power) {
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
  float* part = reinterpret_cast<float*>(base + 3 * vbytes);
  const size_t b = blockIdx.x;
  X += b * mn;
  R_out += b * nn;
  t += b * (size_t)max_power;
  const int tid = threadIdx.x;

  for (size_t i = tid; i < mn; i += RC_THREADS) x[i] = X[i];
  for (size_t i = tid; i < pn; i += RC_THREADS)
    stt[(i % p) * n + i / p] = St[i];
  __syncthreads();

  // R = I - X^T X on the fp32 accumulator, rounded once
  for (size_t idx = tid; idx < nn; idx += RC_THREADS) {
    const int i = idx / n;
    const int j = idx % n;
    float s = 0.f;
    for (int k = 0; k < m; ++k)
      s = fmaf(N::to_f32(x[(size_t)k * n + i]),
               N::to_f32(x[(size_t)k * n + j]), s);
    const T o = N::from_f32(__fsub_rn(i == j ? 1.f : 0.f, s));
    r[idx] = o;
    R_out[idx] = o;
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

template <typename T>
int launch(const void* X, const void* St, void* R, float* t, int batch,
           int m, int n, int p, int max_power, size_t smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        residual_chain_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  residual_chain_kernel<T><<<batch, RC_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(St),
      static_cast<T*>(R), t, m, n, p, max_power);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem_bytes is the footprint the caller's model computed; a launch whose
// model disagrees with the layout above is refused rather than run out of
// bounds.
extern "C" int prism_residual_chain(const void* X, const void* St, void* R,
                                    void* t, int batch, int m, int n, int p,
                                    int max_power, long long smem_bytes,
                                    int bf16, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || p < 1 || p > MAX_SKETCH ||
      max_power < 0)
    return cudaErrorInvalidValue;
  const size_t need = rc_smem_bytes(m, n, p, bf16 ? 2 : 4);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tf = static_cast<float*>(t);
  if (bf16)
    return launch<__nv_bfloat16>(X, St, R, tf, batch, m, n, p, max_power,
                                 need, s);
  return launch<float>(X, St, R, tf, batch, m, n, p, max_power, need, s);
}
