// K4: one power of the sketched chain, V' = R @ V and t' = sum(St * (R @ V)),
// for a [B, n, n] bucket in one launch.
//
// Replaces the TPU kernel repro/kernels/sketch_traces.py::sketch_step
// (_kernel): the bounded-footprint fallback that kernels/ops.py loops,
// one launch per power, where the whole-chain kernel K5 cannot run: its
// block does not fit the shared-memory budget (n = 4096 in fp32, or a
// budget forced down), or the card holds none of its clusters.  So K4
// needs no cluster, and its footprint does not grow with n.  The trace is
// reduced from the fp32 accumulator before V' rounds to the operand dtype
// (DESIGN.md §9).
//
// What bounds it on the H100: device-memory bytes.  It reads R once
// (2 n^2 p flops against 4 n^2 bytes in fp32: p/2 flops a byte) plus V and
// St, and writes V' (0.0509 ms at [40, 1024, 1024], p = 8, fp32).
//
// Design (redesigned for Hopper): the TPU grid (B, row tiles, k tiles)
// carried the trace and the fp32 tile accumulator from one k step to the
// next in order; blocks here run in parallel and in no order.  A block
// owns BLOCK_ROWS rows of one slice and loops over the contraction
// itself, with K5's row-group product (chain.cuh): a warp carries ROWS =
// 64 / PB rows (8 at p <= 8), 64 fp32 sums a lane, reduce-scattered at
// the end, each V'[row, c] summed in K5's order.  R never waits on a
// barrier: each thread streams its own 16-byte pieces of R through a
// private cp.async ring of STAGES slots, STAGES - 1 steps ahead, straight
// across V's tiles.  V is staged in shared memory KT rows at a time,
// transposed ([PB][LDV], rows past p zero), in two buffers: while a tile
// computes, each thread's share of the next one is already loading into
// registers, and is stored into the other buffer after the compute, so a
// tile needs one barrier.  LDV pads a row by 16 bytes: the transposed
// stores of one warp (p = 8: 8 columns x 4 rows) then hit 32 different
// banks.  The footprint is a constant of each instantiation (Layout
// below: 81 KB at p <= 8 in fp32, of which V's two tiles 16.6 KB),
// whatever n.
//
// The trace is a sum across the row-tile blocks of a slice.  An fp32
// atomicAdd would sum them in a different order from run to run, and the
// sum feeds alpha, so each block writes its partial (the lanes' terms in
// order, a butterfly in its warps, the warps in order), and the last
// block of the slice to arrive (a __threadfence() and a counter) adds the
// partials in tile order, then sets the slice's counter back to 0: the
// counters are zero on entry to every launch, so the wrapper zeroes them
// once, when it allocates them, and never per call.
#include "chain.cuh"

namespace {

using prism::fetch;
using prism::reduce_scatter;
using prism::ring_commit;
using prism::ring_wait;
using prism::unpack;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;       // ring slots a thread: steps of R in flight
constexpr int GROUP_SUMS = 64;  // sums a lane carries: ROWS x PB (K5's)
constexpr int KT = 256;         // rows of V a staged tile holds

template <typename T, int PB>
struct Layout {
  static constexpr int ROWS = GROUP_SUMS / PB;          // rows a warp
  static constexpr int BLOCK_ROWS = WARPS * ROWS;       // rows a block
  static constexpr int LDV = KT + 16 / (int)sizeof(T);  // V tile's pitch
  static constexpr int VLOADS = KT * PB / THREADS;      // V values a thread
  static constexpr size_t RING = (size_t)STAGES * ROWS * THREADS * 16;
  static constexpr size_t VTILE = (size_t)PB * LDV * sizeof(T);
  static constexpr size_t BYTES = RING + 2 * VTILE + 4 * WARPS;
};

template <typename T, int VEC, int PB>
__global__ void __launch_bounds__(THREADS, 1)
    sketch_step_kernel(const T* __restrict__ R, const T* __restrict__ V,
                       const T* __restrict__ St, T* __restrict__ Vout,
                       float* __restrict__ t, float* partial, int* counter,
                       int n, int p) {
  using L = Layout<T, PB>;
  using N = prism::Num<T>;
  constexpr int ROWS = L::ROWS;
  constexpr int LDV = L::LDV;
  constexpr int PER_LANE = GROUP_SUMS / 32;
  constexpr int KSTEP = 32 * VEC;         // columns a warp covers a step
  constexpr int TILE_STEPS = KT / KSTEP;  // steps a V tile feeds
  static_assert(KT % KSTEP == 0, "a V tile holds whole steps");
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* const ring = reinterpret_cast<uint4*>(smem);
  T* const vt0 = reinterpret_cast<T*>(smem + L::RING);
  T* const vt1 = reinterpret_cast<T*>(smem + L::RING + L::VTILE);
  float* const wsum = reinterpret_cast<float*>(smem + L::RING + 2 * L::VTILE);
  const int tiles = gridDim.x;
  const int tile = blockIdx.x;
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the warp's rows [row0, row0 + rows) of R
  const int row0 = tile * L::BLOCK_ROWS + warp * ROWS;
  const int rows = max(0, min(ROWS, n - row0));
  R += b * (size_t)n * n;
  V += b * (size_t)n * p;
  Vout += b * (size_t)n * p;

  // V's rows [k0, k0 + KT) into registers (consecutive threads on
  // consecutive elements of V: coalesced), zero past n, and from there
  // into a tile buffer transposed
  T vreg[L::VLOADS];
  const int tile_elems = KT * p;
  auto fetch_v = [&](int k0) {
#pragma unroll
    for (int s = 0; s < L::VLOADS; ++s) {
      const int i = tid + s * THREADS;
      const bool ok = i < tile_elems && k0 + i / p < n;
      vreg[s] = ok ? V[(size_t)k0 * p + i] : N::from_f32(0.f);
    }
  };
  auto store_v = [&](T* dst) {
#pragma unroll
    for (int s = 0; s < L::VLOADS; ++s) {
      const int i = tid + s * THREADS;
      if (i < tile_elems) dst[(i % p) * LDV + i / p] = vreg[s];
    }
  };
  // the rows of both buffers past p stay zero (no FMA asks for c < p)
  for (int i = tid; i < PB * LDV; i += THREADS)
    if (i / LDV >= p) vt0[i] = vt1[i] = N::from_f32(0.f);
  fetch_v(0);
  store_v(vt0);

  // R's ring: this lane's pieces of the warp's rows, one k step a slot
  const int ksteps = (n + KSTEP - 1) / KSTEP;
  int lk = 0, lslot = 0;  // the next load's k step and slot
  const T* lsrc = R + (size_t)row0 * n + lane * VEC;
  auto load_next = [&]() {
    if (lk < ksteps) {
      const bool kok = lk * KSTEP + lane * VEC < n;
      uint4* slot = ring + (size_t)lslot * ROWS * THREADS + tid;
      const T* src = lsrc;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const bool ok = j < rows && kok;
        fetch<T, VEC>(slot + j * THREADS, ok ? src : R, ok);
        src += n;
      }
      ++lk;
      lsrc += KSTEP;
    }
    ring_commit();  // an empty group at the end keeps the count
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
  };
  for (int i = 0; i < STAGES - 1; ++i) load_next();
  __syncthreads();  // V's first tile is in place

  float acc[GROUP_SUMS];  // [ROWS][PB]
#pragma unroll
  for (int i = 0; i < GROUP_SUMS; ++i) acc[i] = 0.f;
  const int vtiles = (n + KT - 1) / KT;
  int cslot = 0;
  for (int kt = 0; kt < vtiles; ++kt) {
    const T* vin = (kt & 1) ? vt1 : vt0;
    const bool more = kt + 1 < vtiles;
    if (more) fetch_v((kt + 1) * KT);  // in flight while this tile computes
    for (int s = 0; s < TILE_STEPS; ++s) {
      const int ks = kt * TILE_STEPS + s;
      if (ks >= ksteps) break;
      load_next();
      ring_wait<STAGES - 1>();
      const uint4* slot = ring + (size_t)cslot * ROWS * THREADS + tid;
      cslot = cslot + 1 == STAGES ? 0 : cslot + 1;
      const int k = ks * KSTEP + lane * VEC;
      if (k < n) {
        float r[ROWS][VEC];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) unpack<T, VEC>(slot + j * THREADS,
                                                      r[j]);
#pragma unroll
        for (int c = 0; c < PB; ++c) {
          float v[VEC];
          prism::load_vec<T, VEC>(vin + c * LDV + (k - kt * KT), v);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
#pragma unroll
            for (int j = 0; j < ROWS; ++j)
              acc[j * PB + c] = fmaf(r[j][e], v[e], acc[j * PB + c]);
        }
      }
    }
    // the other buffer was last read in tile kt - 1, before the barrier
    // that ended it
    if (more) store_v((kt & 1) ? vt0 : vt1);
    __syncthreads();  // the next tile is in place
  }

  reduce_scatter<PER_LANE>(acc, lane);
  float tsum = 0.f;
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) {
    const int i = lane * PER_LANE + m;
    const int j = i / PB;
    const int c = i % PB;
    if (j < rows && c < p) {
      const size_t o = (size_t)(row0 + j) * p + c;
      // the trace reads the fp32 sum, before V' rounds
      tsum = fmaf(N::to_f32(St[o]), acc[m], tsum);
      Vout[o] = N::from_f32(acc[m]);
    }
  }
  // the block's partial: the lanes (a butterfly: every lane gets the same
  // sum), then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
  if (lane == 0) wsum[warp] = tsum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, wsum[w]);
    partial[b * tiles + tile] = s;
    __threadfence();  // the partial is visible before the count says so
    if (atomicAdd(counter + b, 1) == tiles - 1) {
      // the slice's last block: every partial is written
      __threadfence();
      float sum = 0.f;
      for (int i = 0; i < tiles; ++i)
        sum = __fadd_rn(sum, __ldcg(partial + b * tiles + i));
      t[b] = sum;
      atomicExch(counter + b, 0);  // zero for the next launch
    }
  }
}

template <typename T, int VEC, int PB>
struct Launch {
  static int run(const void* R, int n, int p, const void* V, const void* St,
                 void* Vout, float* t, float* partial, int* counter,
                 int batch, int tiles, cudaStream_t s) {
    using L = Layout<T, PB>;
    if (tiles != (n + L::BLOCK_ROWS - 1) / L::BLOCK_ROWS)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        sketch_step_kernel<T, VEC, PB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    sketch_step_kernel<T, VEC, PB><<<dim3(tiles, batch), THREADS, L::BYTES,
                                     s>>>(
        static_cast<const T*>(R), static_cast<const T*>(V),
        static_cast<const T*>(St), static_cast<T*>(Vout), t, partial,
        counter, n, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// tiles: row-tile blocks a slice, ceil(n / BLOCK_ROWS) with BLOCK_ROWS =
// 8 warps x 64 / (8 or 16 >= p) rows (kernels/sketch_traces.py::
// step_tiles; a launch that disagrees is refused); partial: [batch, tiles]
// fp32 scratch; counter: [batch] int32, zero on entry and on exit.
extern "C" int prism_sketch_step(const void* R, const void* V, const void* St,
                                 void* Vout, void* t, void* partial,
                                 void* counter, int batch, int n, int p,
                                 int tiles, int bf16, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || p < 1 ||
      p > prism::MAX_SKETCH)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tf = static_cast<float*>(t);
  float* pf = static_cast<float*>(partial);
  int* ci = static_cast<int*>(counter);
  if (bf16)
    return prism::dispatch_chain<__nv_bfloat16, Launch>(
        R, n, p, V, St, Vout, tf, pf, ci, batch, tiles, s);
  return prism::dispatch_chain<float, Launch>(R, n, p, V, St, Vout, tf, pf,
                                              ci, batch, tiles, s);
}
