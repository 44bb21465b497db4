// K5: the whole sketched power-trace chain of a [B, n, n] residual bucket
// in ONE launch:  t_i = tr(S R^i S^T), i = 1..max_power.
//
// Replaces the TPU kernel repro/kernels/sketch_traces.py::sketch_chain
// (_chain_kernel), the alpha fit of every grid-tier fitted PRISM
// iteration.  Per power: V_i = R @ V_{i-1} with an fp32 accumulator, the
// trace sum(St * (R @ V)) reduced from that fp32 accumulator, and only
// then V_i rounded to the operand dtype (DESIGN.md §9).
//
// What bounds it on the H100: bytes by the roofline (a power does 2 n^2 p
// flops against 4 n^2 bytes of R in fp32, p/2 = 4 flops a byte at p = 8),
// and a chain must finish V_{i-1} before any row of V_i, so a design that
// streams R every power reads it max_power times (1.0 GB at
// [40, 1024, 1024] x 6: 0.30 ms at 3.35 TB/s).
//
// Design: one thread-block CLUSTER a slice, so that every SM works on R
// (one block a slice left 92 of 132 SMs idle at B = 40, and one SM's rate
// set the time).  Rank r of the cluster owns rows [r q, r q + q) of R,
// q = ceil(n / CLUSTER) (ranks past n own none); a cluster carries its
// slice through every power.  Per power, each rank:
//   1. computes its rows of R V_{i-1} into fp32 registers: a warp carries
//      ROWS rows at a time (ROWS x PB = GROUP_SUMS sums a lane), its lanes
//      stride the contraction 16 bytes at a time;
//   2. reduce-scatters the GROUP_SUMS sums across the lanes (31 shuffles
//      for each 32 sums), so that every lane holds finished sums;
//   3. adds each sum's trace term St[row, c] * sum in a fixed order;
//   4. rounds it to V_i[row, c] and stores it into V_i's buffer of every
//      rank of the cluster (distributed shared memory), except on the last
//      power, and stores its trace partial into rank 0;
//   5. meets the cluster barrier, which makes V_i whole in every rank;
//   6. rank 0 then adds the ranks' partials in rank order and writes
//      t[b, i].
// V lives in shared memory TRANSPOSED, as [PB][n] (rows past p zero, so
// that the FMA loop needs no test of p), in two ping-pong buffers:
// power i reads one and writes the other, which everyone finished reading
// before the barrier of power i - 1, so one barrier a power suffices; all
// stores into other blocks come before the last barrier, so a block may
// leave after it.
//
// R never waits on V: each thread streams its own 16-byte pieces of R
// through a private ring of STAGES slots with cp.async (no barrier: a
// thread reads only what it copied itself), STAGES - 1 steps ahead, across
// row groups and across powers (R is the same every power), so the loads
// of power i + 1 are in flight through the barrier of power i.  An n that
// is not a multiple of the vector width, or an R that does not start on 16
// bytes, takes the scalar instantiation (VEC = 1: one element a lane a
// step, loaded through registers into the same ring).
//
// Measured on the H100 (tools/chain_probe.py, PERF.md §6): a 16-block
// cluster streams R at ~440 GB/s whether 2 or 7 run and whether R sits in
// L2 or not, and a power costs the same with no byte of R read at all:
// the arithmetic loop (shared-memory reads of V and of the ring) and its
// waits, not the bytes, set the time, and keeping part of R in shared
// memory across powers gained nothing.  8 rows a warp (GROUP_SUMS = 64:
// each V value read from shared memory feeds 8 FMAs) beat 4 by 16-20%;
// a 2-slot ring tied a 4-slot one at two thirds of the footprint; 16
// blocks a slice (7 clusters resident, 112 SMs) tied 8 and 4 at 40 and
// 100 slices and held up best at 20 slices or fewer.  The loop is issue-
// bound, so instructions count: one row pointer a group in the loader
// took 4-7% off, and V padded to the tile width (no test of p in the FMA
// loop, so the compiler hoists V's loads) 8-13% more.
//
// Determinism: every sum has a fixed order (lanes by the shuffle pattern,
// row groups in order, warps in order, ranks in order); no atomics.
// Footprint of one block (chain_smem_bytes; kernels/sketch_traces.py
// mirrors it):
//   2 align16(PB n item) + STAGES (GROUP_SUMS / PB) 16 THREADS
//     + align16(q p item) + 4 (WARPS + 2 CLUSTER)
// (133,280 bytes at n = 1024, p = 8 in fp32; n = 4096 fits in bf16, not
// in fp32, where kernels/ops.py loops K4 instead).
#include <cooperative_groups.h>

#include <mutex>

#include "chain.cuh"

namespace cg = cooperative_groups;

namespace {

using prism::align16;

constexpr int CLUSTER = 16;     // blocks a slice (> 8: non-portable size)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 1;   // __launch_bounds__ blocks an SM
constexpr int STAGES = 2;       // ring slots a thread: steps of R in flight
constexpr int GROUP_SUMS = 64;  // sums a lane carries: ROWS x PB

__host__ __device__ inline int rank_rows(int n) {
  return (n + CLUSTER - 1) / CLUSTER;
}

// the register tile's width: V's rows in shared memory (those past p zero)
__host__ __device__ inline int tile_width(int p) { return p <= 8 ? 8 : 16; }

__host__ __device__ inline size_t ring_bytes(int p) {
  return (size_t)STAGES * (GROUP_SUMS / tile_width(p)) * 16 * THREADS;
}

__host__ __device__ inline size_t chain_smem_bytes(int n, int p, int item) {
  return 2 * align16((size_t)tile_width(p) * n * item) + ring_bytes(p) +
         align16((size_t)rank_rows(n) * p * item) +
         4 * (WARPS + 2 * CLUSTER);
}

// cp.async with "memory" clobbers: no barrier follows the wait here, so
// the clobber is what keeps the compiler from moving a ring read above it
__device__ __forceinline__ void ring_copy16(uint4* dst, const void* src,
                                            bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one lane's piece of one row of R for one step into its ring slot: 16
// bytes by cp.async (zero-filled past the rank's rows or n), or one element
// through registers, as fp32
template <typename T, int VEC>
__device__ __forceinline__ void fetch(uint4* slot, const T* src, bool ok) {
  if constexpr (VEC == 1) {
    *reinterpret_cast<float*>(slot) = ok ? prism::Num<T>::to_f32(*src) : 0.f;
  } else {
    ring_copy16(slot, src, ok);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4* slot, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = *reinterpret_cast<const float*>(slot);
  } else {
    prism::Vec16<T>::unpack(*slot, out);
  }
}

// v[0 .. 32 M) on every lane -> lane L holds in v[0 .. M) the warp's sums
// of indices L M .. L M + M - 1.  Each step (OFF = 16, 8, .., 1) sends the
// half a lane gives up to its partner and keeps the other half (16 M + ..
// + M = 31 M shuffles); the order of every sum is fixed by the lane
// pattern.  A recursion, so that every index is a constant and v stays in
// registers.
template <int M, int OFF = 16>
__device__ __forceinline__ void reduce_scatter(float (&v)[32 * M],
                                               int lane) {
  constexpr int HALF = OFF * M;
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (OFF > 1) reduce_scatter<M, OFF / 2>(v, lane);
}

template <typename T, int VEC, int PB>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    sketch_chain_kernel(const T* __restrict__ R, const T* __restrict__ St,
                        float* __restrict__ t, int n, int p,
                        int max_power) {
  constexpr int ROWS = GROUP_SUMS / PB;  // rows of R a warp carries
  constexpr int PER_LANE = GROUP_SUMS / 32;
  constexpr int KSTEP = 32 * VEC;        // columns a warp covers a step
  extern __shared__ __align__(16) unsigned char smem[];
  using N = prism::Num<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // the rank's rows [r0, r0 + rows) of R
  const int q = rank_rows(n);
  const int r0 = min(n, rank * q);
  const int rows = min(q, n - r0);

  const size_t vbytes = align16((size_t)PB * n * sizeof(T));
  T* const v0 = reinterpret_cast<T*>(smem);
  T* const v1 = reinterpret_cast<T*>(smem + vbytes);
  uint4* const ring = reinterpret_cast<uint4*>(smem + 2 * vbytes);
  T* const sto = reinterpret_cast<T*>(smem + 2 * vbytes + ring_bytes(p));
  float* const wsum = reinterpret_cast<float*>(
      smem + 2 * vbytes + ring_bytes(p) + align16((size_t)q * p * sizeof(T)));
  // the ranks' partials, by power parity; rank 0's are read
  float* const part = wsum + WARPS;
  R += b * (size_t)n * n + (size_t)r0 * n;
  t += b * (size_t)max_power;

  // V_0 = St (consecutive threads on consecutive k: no bank conflict),
  // the rows of both V buffers past p zero (no FMA then asks for c < p),
  // and St at the rank's rows for the trace terms
  for (int i = tid; i < n * PB; i += THREADS) {
    const int c = i / n;
    v0[i] = c < p ? St[(size_t)(i % n) * p + c] : N::from_f32(0.f);
    if (c >= p) v1[i] = N::from_f32(0.f);
  }
  for (int i = tid; i < rows * p; i += THREADS)
    sto[i] = St[(size_t)r0 * p + i];

  // this warp's row groups: warp, warp + WARPS, ... of ceil(rows / ROWS)
  const int groups = (rows + ROWS - 1) / ROWS;
  const int my_groups =
      warp < groups ? (groups - warp + WARPS - 1) / WARPS : 0;
  const int ksteps = (n + KSTEP - 1) / KSTEP;
  int to_load = my_groups * ksteps * max_power;  // steps not yet loaded
  int lg = 0, lk = 0, lslot = 0;  // the next load's group, k step, slot
  // this lane's first element of group g's first row
  auto group_src = [&](int g) {
    return R + (size_t)((warp + WARPS * g) * ROWS) * n + lane * VEC;
  };
  const T* lsrc = group_src(0);     // ... advanced to the next load's step
  int lrows = rows - warp * ROWS;   // rows of the next load's group (or more)
  auto load_next = [&]() {
    if (to_load > 0) {
      const bool kok = lk * KSTEP + lane * VEC < n;
      uint4* slot = ring + (size_t)lslot * ROWS * THREADS + tid;
      const T* src = lsrc;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const bool ok = j < lrows && kok;
        fetch<T, VEC>(slot + j * THREADS, ok ? src : R, ok);
        src += n;
      }
      --to_load;
      lsrc += KSTEP;
      if (++lk == ksteps) {
        lk = 0;
        if (++lg == my_groups) lg = 0;
        lsrc = group_src(lg);
        lrows = rows - (warp + WARPS * lg) * ROWS;
      }
    }
    ring_commit();  // an empty group at the end keeps the count
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
  };
  for (int i = 0; i < STAGES - 1; ++i) load_next();
  // V_0 is in place, and every block of the cluster runs (its shared
  // memory may be written)
  cluster.sync();

  int cslot = 0;
  for (int pw = 0; pw < max_power; ++pw) {
    const T* vin = (pw & 1) ? v1 : v0;
    T* vout = (pw & 1) ? v0 : v1;
    const bool push = pw + 1 < max_power;
    float tsum = 0.f;
    for (int g = 0; g < my_groups; ++g) {
      const int row0 = (warp + WARPS * g) * ROWS;
      float acc[GROUP_SUMS];  // [ROWS][PB]
#pragma unroll
      for (int i = 0; i < GROUP_SUMS; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < ksteps; ++ks) {
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
            prism::load_vec<T, VEC>(vin + (size_t)c * n + k, v);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
#pragma unroll
              for (int j = 0; j < ROWS; ++j)
                acc[j * PB + c] = fmaf(r[j][e], v[e], acc[j * PB + c]);
          }
        }
      }
      reduce_scatter<PER_LANE>(acc, lane);
#pragma unroll
      for (int m = 0; m < PER_LANE; ++m) {
        const int i = lane * PER_LANE + m;
        const int row = row0 + i / PB;
        const int c = i % PB;
        if (row < rows && c < p) {
          const float s = acc[m];
          // the trace reads the fp32 sum, before V_i rounds
          tsum = fmaf(N::to_f32(sto[row * p + c]), s, tsum);
          if (push) {
            const T val = N::from_f32(s);
            T* dst = vout + (size_t)c * n + r0 + row;
#pragma unroll
            for (int dst_rank = 0; dst_rank < CLUSTER; ++dst_rank)
              *cluster.map_shared_rank(dst, dst_rank) = val;
          }
        }
      }
    }
    // the rank's partial: the lanes (a butterfly: every lane gets the same
    // sum), then the warps in order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
    if (lane == 0) wsum[warp] = tsum;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, wsum[w]);
      *cluster.map_shared_rank(part + (pw & 1) * CLUSTER + rank, 0) = s;
    }
    // V_i is whole in every rank, and every partial of power i is in rank 0
    cluster.sync();
    if (rank == 0 && tid == 0) {
      float s = 0.f;
      for (int src = 0; src < CLUSTER; ++src)
        s = __fadd_rn(s, part[(pw & 1) * CLUSTER + src]);
      t[pw] = s;
    }
  }
  // every store into another block's shared memory came before the last
  // barrier, so a block may leave now
}

template <typename T, int VEC, int PB>
struct Launch {
  static cudaLaunchConfig_t config(int clusters, size_t smem, cudaStream_t s,
                                   cudaLaunchAttribute* attr) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = CLUSTER;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  // Sets the kernel's shared-memory and cluster-size attributes and
  // returns how many of its clusters the card holds at once with smem
  // bytes a block (cached per device and footprint: the fit launches K5
  // every fitted iteration).
  static int prepare(size_t smem, int* clusters) {
    static std::mutex mu;
    static int last_device = -1;
    static size_t last_smem = 0;
    static int last_clusters = 0;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    std::lock_guard<std::mutex> lock(mu);
    if (device == last_device && smem == last_smem) {
      *clusters = last_clusters;
      return 0;
    }
    auto kernel = sketch_chain_kernel<T, VEC, PB>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && CLUSTER > 8)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(1, smem, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_device = device;
    last_smem = smem;
    last_clusters = *clusters;
    return 0;
  }

  static int run(const void* R, int n, int p, const void* St, float* t,
                 int batch, int max_power, size_t smem, cudaStream_t s) {
    int clusters = 0;
    const int err = prepare(smem, &clusters);
    if (err != 0) return err;
    // a cluster that cannot be resident is refused, never run another way
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(batch, smem, s, &attr);
    const cudaError_t launched = cudaLaunchKernelEx(
        &cfg, sketch_chain_kernel<T, VEC, PB>, static_cast<const T*>(R),
        static_cast<const T*>(St), t, n, p, max_power);
    if (launched != cudaSuccess) return static_cast<int>(launched);
    return static_cast<int>(cudaGetLastError());
  }
};

// out: cluster size, clusters resident at once, registers a thread, local
// (spilled) bytes a thread, threads a block, STAGES, rows a warp
template <typename T, int VEC, int PB>
struct Info {
  static int run(const void*, int, int, size_t smem, int* out) {
    int clusters = 0;
    const int err = Launch<T, VEC, PB>::prepare(smem, &clusters);
    if (err != 0) return err;
    cudaFuncAttributes fa;
    const cudaError_t got =
        cudaFuncGetAttributes(&fa, sketch_chain_kernel<T, VEC, PB>);
    if (got != cudaSuccess) return static_cast<int>(got);
    out[0] = CLUSTER;
    out[1] = clusters;
    out[2] = fa.numRegs;
    out[3] = static_cast<int>(fa.localSizeBytes);
    out[4] = THREADS;
    out[5] = STAGES;
    out[6] = GROUP_SUMS / PB;
    return 0;
  }
};

bool valid(int n, int p, long long smem_bytes, int bf16) {
  return n >= 1 && p >= 1 && p <= prism::MAX_SKETCH && smem_bytes >= 0 &&
         static_cast<size_t>(smem_bytes) == chain_smem_bytes(n, p,
                                                             bf16 ? 2 : 4);
}

}  // namespace

// smem_bytes is the footprint the caller's model computed
// (kernels/sketch_traces.py::chain_smem_bytes); a launch whose model
// disagrees with the layout above is refused rather than run out of bounds.
extern "C" int prism_sketch_chain(const void* R, const void* St, void* t,
                                  int batch, int n, int p, int max_power,
                                  long long smem_bytes, int bf16,
                                  void* stream) {
  if (batch < 1 || batch > 0x7fffffff / CLUSTER || max_power < 1 ||
      !valid(n, p, smem_bytes, bf16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tf = static_cast<float*>(t);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (bf16)
    return prism::dispatch_chain<__nv_bfloat16, Launch>(R, n, p, St, tf,
                                                        batch, max_power,
                                                        smem, s);
  return prism::dispatch_chain<float, Launch>(R, n, p, St, tf, batch,
                                              max_power, smem, s);
}

// The launch K5 would make for this R (its instantiation follows R's
// alignment and n): see Info for the seven ints written to out.
extern "C" int prism_sketch_chain_info(const void* R, int n, int p,
                                       long long smem_bytes, int bf16,
                                       int* out) {
  if (!valid(n, p, smem_bytes, bf16)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (bf16)
    return prism::dispatch_chain<__nv_bfloat16, Info>(R, n, p, smem, out);
  return prism::dispatch_chain<float, Info>(R, n, p, smem, out);
}
