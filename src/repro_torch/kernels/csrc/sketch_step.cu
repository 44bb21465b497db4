// K4: one power of the sketched chain, V' = R @ V and t' = sum(St * (R @ V)),
// for a [B, n, n] bucket in one launch.
//
// Replaces the TPU kernel repro/kernels/sketch_traces.py::sketch_step
// (_kernel): the bounded-footprint fallback that kernels/ops.py loops,
// one launch per power, when the whole-chain kernel K5 would not fit one
// block's shared memory (n = 4096 in fp32, or a budget forced down).  The
// trace is reduced from the fp32 accumulator before V' rounds to the
// operand dtype (DESIGN.md §9).
//
// What bounds it on the H100: device-memory bytes.  It reads R once
// (2 n^2 p flops against 4 n^2 bytes in fp32: p/2 flops a byte) plus V and
// St, and writes V'.
//
// Design: the TPU grid (B, row tiles, k tiles) carried the trace and the
// fp32 tile accumulator from one k step to the next in order; blocks here
// run in parallel and in no order.  So each block owns STEP_ROWS rows of
// one slice (CHAIN_ROWS per warp, accumulators in registers, chain.cuh)
// and loops over the contraction itself, staging each STEP_KT-row tile of
// V in shared memory (transposed): the footprint is bounded, whatever n.
// The trace is a sum across the row-tile blocks of a slice.  An fp32
// atomicAdd would sum them in a different order from run to run, and the
// sum feeds alpha, so each block writes its partial, and the last block of
// the slice to finish (a __threadfence() and a counter) adds the partials
// in tile order.
#include "chain.cuh"

namespace {

using prism::CHAIN_ROWS;
using prism::CHAIN_THREADS;
using prism::CHAIN_WARPS;

constexpr int STEP_ROWS = CHAIN_WARPS * CHAIN_ROWS;  // rows of R a block owns
constexpr int STEP_KT = 256;  // contraction rows of V staged at a time

template <typename T, int VEC, int PB>
__global__ void __launch_bounds__(CHAIN_THREADS)
    sketch_step_kernel(const T* __restrict__ R, const T* __restrict__ V,
                       const T* __restrict__ St, T* __restrict__ Vout,
                       float* __restrict__ t, float* partial, int* counter,
                       int n, int p) {
  __shared__ __align__(16) unsigned char vt_raw[PB * STEP_KT * sizeof(T)];
  __shared__ float wsum[CHAIN_WARPS];
  __shared__ bool last;
  using N = prism::Num<T>;
  T* vt = reinterpret_cast<T*>(vt_raw);
  const int tiles = gridDim.x;
  const int tile = blockIdx.x;
  const size_t b = blockIdx.y;
  R += b * (size_t)n * n;
  V += b * (size_t)n * p;
  Vout += b * (size_t)n * p;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = tile * STEP_ROWS + warp * CHAIN_ROWS;
  const int nrows = max(0, min(CHAIN_ROWS, n - row0));

  float acc[CHAIN_ROWS][PB];
#pragma unroll
  for (int j = 0; j < CHAIN_ROWS; ++j)
#pragma unroll
    for (int c = 0; c < PB; ++c) acc[j][c] = 0.f;
  for (int k0 = 0; k0 < n; k0 += STEP_KT) {
    const int kt = min(STEP_KT, n - k0);
    for (int i = tid; i < kt * p; i += CHAIN_THREADS)
      vt[(i % p) * STEP_KT + i / p] = V[(size_t)k0 * p + i];
    __syncthreads();
    if (nrows > 0)
      prism::row_group_dot<T, VEC, PB>(R, n, row0, nrows, k0, k0 + kt, vt,
                                       STEP_KT, k0, p, acc);
    __syncthreads();
  }
  prism::warp_allreduce<PB>(acc, p);

  if (lane == 0) {
    float tpart = 0.f;
#pragma unroll
    for (int j = 0; j < CHAIN_ROWS; ++j) {
      if (j >= nrows) continue;
#pragma unroll
      for (int c = 0; c < PB; ++c) {
        if (c >= p) continue;
        const size_t o = (size_t)(row0 + j) * p + c;
        // the trace reads the fp32 sum, before V' rounds
        tpart = fmaf(N::to_f32(St[o]), acc[j][c], tpart);
        Vout[o] = N::from_f32(acc[j][c]);
      }
    }
    wsum[warp] = tpart;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < CHAIN_WARPS; ++w) s = __fadd_rn(s, wsum[w]);
    partial[b * tiles + tile] = s;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(counter + b, 1) == tiles - 1;
  }
  __syncthreads();
  if (last && tid == 0) {
    __threadfence();
    float s = 0.f;
    for (int i = 0; i < tiles; ++i)
      s = __fadd_rn(s, __ldcg(partial + b * tiles + i));
    t[b] = s;
  }
}

template <typename T, int VEC, int PB>
struct Launch {
  static int run(const void* R, int n, int p, const void* V, const void* St,
                 void* Vout, float* t, float* partial, int* counter,
                 int batch, cudaStream_t s) {
    const dim3 grid((n + STEP_ROWS - 1) / STEP_ROWS, batch);
    sketch_step_kernel<T, VEC, PB><<<grid, CHAIN_THREADS, 0, s>>>(
        static_cast<const T*>(R), static_cast<const T*>(V),
        static_cast<const T*>(St), static_cast<T*>(Vout), t, partial,
        counter, n, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// partial: [batch, ceil(n / 32)] fp32 scratch; counter: [batch] int32,
// zero on entry (the caller allocates both).
extern "C" int prism_sketch_step(const void* R, const void* V, const void* St,
                                 void* Vout, void* t, void* partial,
                                 void* counter, int batch, int n, int p,
                                 int bf16, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || p < 1 ||
      p > prism::MAX_SKETCH)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tf = static_cast<float*>(t);
  float* pf = static_cast<float*>(partial);
  int* ci = static_cast<int*>(counter);
  if (bf16)
    return prism::dispatch_chain<__nv_bfloat16, Launch>(
        R, n, p, V, St, Vout, tf, pf, ci, batch, s);
  return prism::dispatch_chain<float, Launch>(R, n, p, V, St, Vout, tf, pf,
                                              ci, batch, s);
}
