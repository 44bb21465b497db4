// K5: the whole sketched power-trace chain of a [B, n, n] residual bucket
// in ONE launch:  t_i = tr(S R^i S^T), i = 1..max_power.
//
// Replaces the TPU kernel repro/kernels/sketch_traces.py::sketch_chain
// (_chain_kernel), the alpha fit of every grid-tier fitted PRISM
// iteration.  Per power: V_i = R @ V_{i-1} with an fp32 accumulator, the
// trace sum(St * (R @ V)) reduced from that fp32 accumulator, and only
// then V_i rounded to the operand dtype (DESIGN.md §9).
//
// What bounds it on the H100: device-memory bytes.  R is read once per
// power; a power does 2 n^2 p flops against 4 n^2 bytes of R (fp32), i.e.
// p/2 = 4 flops a byte at p = 8, far below the ~20 where fp32 arithmetic
// would take over.  The least time counts R read once (the bucket's
// [40, 1024, 1024] fp32 R is 168 MB, ~0.05 ms); this design reads it
// max_power times (6 at degree 1: ~1.0 GB, ~0.30 ms at 3.35 TB/s).  One
// block per slice also leaves SMs idle: 40 or 20 blocks on 132 SMs, so a
// block's own load rate, not the card's, sets the time.
//
// Design: the TPU's sequential grid (B, powers, i, k) with V ping-ponging
// in VMEM becomes one block per batch slice that loops over the powers.
// St and the two V buffers stay in shared memory, transposed to [p][n]
// (chain.cuh), so V never touches device memory; R's rows stream from
// device memory in groups of CHAIN_ROWS per warp, 16 bytes a lane a load,
// and a __syncthreads() separates the powers.  Each warp adds its rows'
// trace terms in a fixed order and thread 0 sums the warps' partials in
// order, so the traces are deterministic.  Footprint:
//   3 * align16(p * n * item) + 4 * CHAIN_WARPS   bytes
// (96 KiB at n = 1024, p = 8 in fp32; n = 4096 in fp32 does not fit the
// 232,448 bytes of a block and kernels/ops.py loops K4 instead).
// Clusters, to spread one slice over several SMs, are later work.
#include "chain.cuh"

namespace {

using prism::CHAIN_ROWS;
using prism::CHAIN_THREADS;
using prism::CHAIN_WARPS;

__host__ __device__ inline size_t chain_smem_bytes(int n, int p, int item) {
  return 3 * prism::align16((size_t)p * n * item) + 4 * CHAIN_WARPS;
}

template <typename T, int VEC, int PB>
__global__ void __launch_bounds__(CHAIN_THREADS)
    sketch_chain_kernel(const T* __restrict__ R, const T* __restrict__ St,
                        float* __restrict__ t, int n, int p,
                        int max_power) {
  extern __shared__ __align__(16) unsigned char smem[];
  using N = prism::Num<T>;
  const size_t vbytes = prism::align16((size_t)p * n * sizeof(T));
  T* stt = reinterpret_cast<T*>(smem);
  T* v0 = reinterpret_cast<T*>(smem + vbytes);
  T* v1 = reinterpret_cast<T*>(smem + 2 * vbytes);
  float* wsum = reinterpret_cast<float*>(smem + 3 * vbytes);
  const size_t b = blockIdx.x;
  R += b * (size_t)n * n;
  t += b * (size_t)max_power;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < n * p; i += CHAIN_THREADS)
    stt[(size_t)(i % p) * n + i / p] = St[i];
  __syncthreads();

  for (int pw = 0; pw < max_power; ++pw) {
    const T* vin = pw == 0 ? stt : ((pw & 1) ? v0 : v1);
    T* vout = (pw & 1) ? v1 : v0;
    float tpart = 0.f;
    for (int row0 = warp * CHAIN_ROWS; row0 < n;
         row0 += CHAIN_WARPS * CHAIN_ROWS) {
      const int nrows = min(CHAIN_ROWS, n - row0);
      float acc[CHAIN_ROWS][PB];
#pragma unroll
      for (int j = 0; j < CHAIN_ROWS; ++j)
#pragma unroll
        for (int c = 0; c < PB; ++c) acc[j][c] = 0.f;
      prism::row_group_dot<T, VEC, PB>(R, n, row0, nrows, 0, n, vin, n, 0,
                                       p, acc);
      prism::warp_allreduce<PB>(acc, p);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < CHAIN_ROWS; ++j) {
          if (j >= nrows) continue;
#pragma unroll
          for (int c = 0; c < PB; ++c) {
            if (c >= p) continue;
            const size_t o = (size_t)c * n + row0 + j;
            // the trace reads the fp32 sum, before V rounds
            tpart = fmaf(N::to_f32(stt[o]), acc[j][c], tpart);
            vout[o] = N::from_f32(acc[j][c]);
          }
        }
      }
    }
    if (lane == 0) wsum[warp] = tpart;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < CHAIN_WARPS; ++w) s = __fadd_rn(s, wsum[w]);
      t[pw] = s;
    }
    __syncthreads();
  }
}

template <typename T, int VEC, int PB>
struct Launch {
  static int run(const void* R, int n, int p, const void* St, float* t,
                 int batch, int max_power, size_t smem, cudaStream_t s) {
    auto kernel = sketch_chain_kernel<T, VEC, PB>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<batch, CHAIN_THREADS, smem, s>>>(
        static_cast<const T*>(R), static_cast<const T*>(St), t, n, p,
        max_power);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// smem_bytes is the footprint the caller's model computed
// (kernels/sketch_traces.py::chain_smem_bytes); a launch whose model
// disagrees with the layout above is refused rather than run out of bounds.
extern "C" int prism_sketch_chain(const void* R, const void* St, void* t,
                                  int batch, int n, int p, int max_power,
                                  long long smem_bytes, int bf16,
                                  void* stream) {
  if (batch < 1 || n < 1 || p < 1 || p > prism::MAX_SKETCH ||
      max_power < 1)
    return cudaErrorInvalidValue;
  const size_t need = chain_smem_bytes(n, p, bf16 ? 2 : 4);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tf = static_cast<float*>(t);
  if (bf16)
    return prism::dispatch_chain<__nv_bfloat16, Launch>(R, n, p, St, tf,
                                                        batch, max_power,
                                                        need, s);
  return prism::dispatch_chain<float, Launch>(R, n, p, St, tf, batch,
                                              max_power, need, s);
}
