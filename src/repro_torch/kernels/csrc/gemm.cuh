// The GEMM core of K1 (matmul_add.cu) and K2 (gram_upper.cu):
//
//   acc[128 x 128] = op(A)[row0 : row0 + 128, :] @ B[:, col0 : col0 + 128]
//
// for op(A) = A (K1, A [M, K] row-major) and op(A) = A^T (K2, A = X
// [K, M] row-major), B [K, N] row-major.  One block of 256 threads (8
// warps as 2 x 4, each a 64 x 32 sub-tile) computes one output tile; the
// accumulator lives in registers, 64 fp32 values a thread.
//
// Precision (DESIGN.md §9).  fp32 operands run exact fp32 on the FFMA
// pipe, never TF32: one accumulator per output element, fmaf, k
// ascending, the order of the plain version's loop and of the kernels
// before this core.  bf16 operands stay bf16 in shared memory and run on
// the tensor cores (mma.sync m16n8k16, fed by ldmatrix); a bf16 x bf16
// product is exact in fp32, only the order of the fp32 sums changes.
//
// The ring.  STAGES slots in dynamic shared memory, each a BK-deep stage
// of both operands (16 KB in either dtype: BK = 16 fp32 or 32 bf16).  The
// loop waits for one stage (cp.async.wait_group) and passes one barrier
// per stage; the barrier also frees the slot that the previous stage was
// read from, which is refilled right after it, so STAGES - 1 stages are in
// flight while one is computed.
//
// Loads.  Tiles that arrive contiguous along the output dimension (B, and
// X for the Gram; in bf16 also K1's A, whose tile is kept k-contiguous for
// ldmatrix) go straight into the ring with 16-byte cp.async.cg copies;
// a tile edge is zero-filled through cp.async's src-size operand, with
// the source pointer clamped inside the tensor.  K1's fp32 A must be
// transposed on the way in (the FFMA loop reads it along m): it takes the
// register route, the next stage's float4 loads issued while half of this
// stage computes and stored as scalars into the freed slot after it (one
// float4 a thread in flight at a time, which keeps the kernel within 128
// registers).  Shared layouts are XOR-swizzled instead of padded:
//   fp32 [BK][128]: column x ^ 8 * ((k / 4) % 4).  The transposing
//     stores (8 rows x 4 k-quads a warp) hit 32 distinct banks; the
//     fragment reads (16-byte, 8 consecutive quads a quarter-warp, or one
//     broadcast quad) are free of conflicts.
//   bf16 [BK][128]: 16-byte chunk c ^ (k % 8); bf16 [128][BK]: chunk
//     c ^ ((m / 2) % 4).  The eight rows of each ldmatrix 8 x 8 matrix
//     land in eight distinct bank groups.
// A row length that is not a multiple of 16 bytes, or an operand that
// does not start on 16 bytes, takes the second instantiation (ALIGNED =
// false) of the same kernels: predicated scalar loads through registers,
// stored into the same ring layouts.  The wrappers choose the variant.
//
// Epilogue.  After the loop the ring is free, and the accumulator is
// staged there as a 128 x 128 fp32 tile (16-byte chunk c ^ ((r / 4) % 8):
// row and column reads of whole chunks are free of conflicts), from where
// the kernels write their output with coalesced 16-byte stores.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace prism {
namespace gemm {

constexpr int TILE = 128;
constexpr int THREADS = 256;
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = 2 * TILE * 64;  // both operands, 64 bytes of k
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int OUT_BYTES = TILE * TILE * 4;  // the staged fp32 output tile
constexpr int SMEM_BYTES = RING_BYTES > OUT_BYTES ? RING_BYTES : OUT_BYTES;
// K1's block order: row tiles in groups of GROUP, columns inside a group
// (blocks that run together share B's column panels in L2)
constexpr int GROUP = 8;

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- layouts

// element offsets inside one operand's stage tile
__device__ __forceinline__ int km32(int k, int x) {  // fp32 [16][128]
  return k * TILE + (x ^ (((k >> 2) & 3) << 3));
}
__device__ __forceinline__ int km16(int k, int x) {  // bf16 [32][128]
  return k * TILE + ((((x >> 3) ^ (k & 7))) << 3) + (x & 7);
}
__device__ __forceinline__ int mk16(int m, int k) {  // bf16 [128][32]
  return m * 32 + ((((k >> 3) ^ ((m >> 1) & 3))) << 3) + (k & 7);
}
// the staged fp32 output tile [128][128]
__device__ __forceinline__ int out_off(int r, int c) {
  return r * TILE + ((((c >> 2) ^ ((r >> 2) & 7))) << 2) + (c & 3);
}

// ---------------------------------------------------------------- core

template <typename T, bool A_T, bool ALIGNED>
struct Core {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int BK = 64 / static_cast<int>(sizeof(T));
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int ELEMS = TILE * BK;  // of one operand's stage tile
  // K1's fp32 A: float4 loads through registers, transposed on the store
  static constexpr bool A_REGS = !A_T && !BF16 && ALIGNED;

  const T* __restrict__ a;  // [M, K], or [K, M] when A_T
  const T* __restrict__ b;  // [K, N]
  int M, N, K, row0, col0;
  float4 areg;

  __device__ __forceinline__ static T* slot_a(char* ring, int s) {
    return reinterpret_cast<T*>(ring + s * STAGE_BYTES);
  }
  __device__ __forceinline__ static T* slot_b(char* ring, int s) {
    return reinterpret_cast<T*>(ring + s * STAGE_BYTES + STAGE_BYTES / 2);
  }
  __device__ __forceinline__ static int km(int k, int x) {
    if constexpr (BF16) return km16(k, x);
    else return km32(k, x);
  }

  // a [K, ld] operand whose tile (k, x) is g[(k0 + k) * ld + c0 + x],
  // x < cols - c0, stored k-major
  __device__ __forceinline__ void load_km(T* s, const T* __restrict__ g,
                                          int ld, int cols, int c0,
                                          int k0) const {
    if constexpr (ALIGNED) {
#pragma unroll
      for (int l = 0; l < ELEMS / VEC / THREADS; ++l) {
        const int idx = threadIdx.x + l * THREADS;
        const int k = idx / (TILE / VEC);
        const int x = (idx % (TILE / VEC)) * VEC;
        const bool ok = k0 + k < K && c0 + x < cols;
        cp_async16(s + km(k, x), ok ? g + (size_t)(k0 + k) * ld + c0 + x : g,
                   ok);
      }
    } else {
      for (int l = 0; l < ELEMS / THREADS; ++l) {
        const int idx = threadIdx.x + l * THREADS;
        const int k = idx / TILE;
        const int x = idx % TILE;
        T v = Num<T>::from_f32(0.f);
        if (k0 + k < K && c0 + x < cols) v = g[(size_t)(k0 + k) * ld + c0 + x];
        s[km(k, x)] = v;
      }
    }
  }

  // K1's row-major A: tile (m, k) is a[(row0 + m) * K + k0 + k]
  __device__ __forceinline__ void load_a_rows(T* s, int k0) const {
    if constexpr (BF16 && ALIGNED) {
#pragma unroll
      for (int l = 0; l < ELEMS / VEC / THREADS; ++l) {
        const int idx = threadIdx.x + l * THREADS;
        const int m = idx / (BK / VEC);
        const int k = (idx % (BK / VEC)) * VEC;
        const bool ok = row0 + m < M && k0 + k < K;
        cp_async16(s + mk16(m, k),
                   ok ? a + (size_t)(row0 + m) * K + k0 + k : a, ok);
      }
    } else if constexpr (!ALIGNED) {
      for (int l = 0; l < ELEMS / THREADS; ++l) {
        const int idx = threadIdx.x + l * THREADS;
        const int m = idx / BK;
        const int k = idx % BK;
        T v = Num<T>::from_f32(0.f);
        if (row0 + m < M && k0 + k < K) v = a[(size_t)(row0 + m) * K + k0 + k];
        if constexpr (BF16) s[mk16(m, k)] = v;
        else s[km32(k, m)] = v;
      }
    }
  }

  // the register route of K1's fp32 A, in two halves of 64 rows: one
  // float4 (4 k of one row) a thread and half
  __device__ __forceinline__ void fetch_a(int k0, int half) {
    if constexpr (A_REGS) {
      const int m = half * 64 + (threadIdx.x >> 2);
      const int k = (threadIdx.x & 3) * 4;
      areg = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + m < M && k0 + k < K)
        areg = *reinterpret_cast<const float4*>(a + (size_t)(row0 + m) * K +
                                                k0 + k);
    }
  }
  __device__ __forceinline__ void stash_a(T* s, int half) const {
    if constexpr (A_REGS) {
      const int m = half * 64 + (threadIdx.x >> 2);
      const int k = (threadIdx.x & 3) * 4;
      s[km32(k + 0, m)] = areg.x;
      s[km32(k + 1, m)] = areg.y;
      s[km32(k + 2, m)] = areg.z;
      s[km32(k + 3, m)] = areg.w;
    }
  }

  // every copy of one stage except the register route's stores
  __device__ __forceinline__ void load_stage(char* ring, int s, int k0) const {
    if constexpr (A_T) load_km(slot_a(ring, s), a, M, M, row0, k0);
    else load_a_rows(slot_a(ring, s), k0);
    load_km(slot_b(ring, s), b, N, N, col0, k0);
  }

  // ------------------------------------------------------------ math

  // fp32: thread rows am + {0..3, 32..35}, columns bn + {0..3, 16..19};
  // acc[i * 8 + j]; k from k_lo to k_hi - 1
  template <int k_lo, int k_hi>
  __device__ __forceinline__ void math32(const float* sa, const float* sb,
                                         float (&acc)[64]) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int am = (warp >> 2) * 64 + (lane & 7) * 4;
    const int bn = (warp & 3) * 32 + (lane >> 3) * 4;
#pragma unroll
    for (int kk = k_lo; kk < k_hi; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + km32(kk, am));
      const float4 a1 =
          *reinterpret_cast<const float4*>(sa + km32(kk, am + 32));
      const float4 b0 = *reinterpret_cast<const float4*>(sb + km32(kk, bn));
      const float4 b1 =
          *reinterpret_cast<const float4*>(sb + km32(kk, bn + 16));
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
    }
  }

  // bf16: warp tile 64 x 32 as 4 x 4 mma tiles of 16 x 8;
  // acc[(mt * 4 + nt) * 4 + e] in the mma accumulator layout
  __device__ __forceinline__ void math16(const T* sa, const T* sb,
                                         float (&acc)[64]) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = (warp >> 2) * 64;
    const int wn = (warp & 3) * 32;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4];
      uint32_t bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if constexpr (A_T) {
          const int k = ks + (lane & 7) + ((lane >> 4) << 3);
          const int m = wm + mt * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4<true>(af[mt], sa + km16(k, m));
        } else {
          const int m = wm + mt * 16 + (lane & 15);
          const int k = ks + (lane >> 4) * 8;
          ldmatrix_x4<false>(af[mt], sa + mk16(m, k));
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int k = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn + np * 16 + (lane >> 4) * 8;
        ldmatrix_x4<true>(bfr[np], sb + km16(k, n));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(&acc[(mt * 4 + nt) * 4], af[mt], bfr[nt >> 1][(nt & 1) * 2],
                   bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }

  // ------------------------------------------------------------ mainloop

  __device__ __forceinline__ void run(char* ring, float (&acc)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int kt_n = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < kt_n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          fetch_a(s * BK, half);
          stash_a(slot_a(ring, s), half);
        }
        load_stage(ring, s, s * BK);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < kt_n; ++kt) {
      // stage kt has landed, and every thread is done with stage kt - 1,
      // whose slot the loads of stage kt + STAGES - 1 refill
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int next = kt + STAGES - 1;
      const bool more = next < kt_n;
      if (more) load_stage(ring, next % STAGES, next * BK);
      cp_async_commit();
      const int cur = kt % STAGES;
      const T* sa = slot_a(ring, cur);
      const T* sb = slot_b(ring, cur);
      if constexpr (BF16) {
        math16(sa, sb, acc);
      } else {
        // the register route's loads fly while half a stage computes
        if (more) fetch_a(next * BK, 0);
        math32<0, BK / 2>(sa, sb, acc);
        if (more) {
          stash_a(slot_a(ring, next % STAGES), 0);
          fetch_a(next * BK, 1);
        }
        math32<BK / 2, BK>(sa, sb, acc);
        if (more) stash_a(slot_a(ring, next % STAGES), 1);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the output tile
  }

  // f(acc value, tile row, tile column) -> the fp32 value staged for it
  template <typename F>
  __device__ __forceinline__ static void stage_out(float* out,
                                                   const float (&acc)[64],
                                                   F f) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if constexpr (BF16) {
      const int wm = (warp >> 2) * 64;
      const int wn = (warp & 3) * 32;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm + mt * 16 + (lane >> 2) + h * 8;
            const int c = wn + nt * 8 + (lane & 3) * 2;
            const float* v = &acc[(mt * 4 + nt) * 4 + h * 2];
            *reinterpret_cast<float2*>(out + out_off(r, c)) =
                make_float2(f(v[0], r, c), f(v[1], r, c + 1));
          }
    } else {
      const int am = (warp >> 2) * 64 + (lane & 7) * 4;
      const int bn = (warp & 3) * 32 + (lane >> 3) * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = am + (i & 3) + (i >> 2) * 32;
          const int c = bn + h * 16;
          const float* v = &acc[i * 8 + h * 4];
          *reinterpret_cast<float4*>(out + out_off(r, c)) =
              make_float4(f(v[0], r, c), f(v[1], r, c + 1),
                          f(v[2], r, c + 2), f(v[3], r, c + 3));
        }
    }
  }
};

// 16 bytes of T (4 fp32 or 8 bf16) to and from fp32 values
template <typename T>
__device__ __forceinline__ void unpack(uint4 w, float* v) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(u[i]);
    } else {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      u[i] = __float_as_uint(v[i]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

}  // namespace gemm
}  // namespace prism
