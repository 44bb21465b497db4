// Shared pieces of the sketched power-chain kernels K4 (sketch_step.cu)
// and K5 (sketch_chain.cu): the products V' = R @ V of the chain
// V_i = R V_{i-1}, V_0 = St ([n, p], p <= 16), with R streamed from
// device memory.
//
// Both kernels carry the same row-group product: a warp holds ROWS rows of
// R at a time (ROWS x PB = 64 fp32 sums a lane, PB = 8 or 16 >= p, the
// register tile's width), its lanes stride the contraction 16 bytes at a
// time (4 fp32 or 8 bf16 values; VEC = 1, one element, where n or R's
// alignment does not allow that), each lane streams its own pieces of R
// through a private cp.async ring in shared memory (fetch / unpack below:
// no barrier, a thread reads only what it copied itself), V is read from
// shared memory TRANSPOSED ([PB][ld]: a lane's VEC consecutive values of
// one column as one 16-byte load, each feeding ROWS FMAs), and the lanes'
// partial sums are reduce-scattered (reduce_scatter), so that every lane
// ends with finished sums.  Each sum V'[row, c] is therefore one fixed
// order: the lane's k ascending (k = step * 32 VEC + lane * VEC + e), then
// the reduce-scatter's tree; K4 and K5 take the same order, so the V' of a
// K4 launch is bitwise the V_i of K5's chain on the same R and V.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace prism {

constexpr int MAX_SKETCH = 16;

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// 16 bytes of operands, unpacked to fp32 without a round trip through
// local memory.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4 u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the top half of the fp32 with the same value; element 2i
  // is the low half of word i (little endian)
  static __device__ __forceinline__ void unpack(const uint4 u, float* o) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// VEC consecutive operands at p (16-byte aligned when VEC > 1) as fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = Num<T>::to_f32(*p);
  } else {
    static_assert(VEC == Vec16<T>::N, "a vector load moves 16 bytes");
    Vec16<T>::unpack(*reinterpret_cast<const uint4*>(p), out);
  }
}

// cp.async with "memory" clobbers: no barrier follows the wait, so the
// clobber is what keeps the compiler from moving a ring read above it
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
// bytes by cp.async (zero-filled where `ok` is false), or one element
// through registers, as fp32
template <typename T, int VEC>
__device__ __forceinline__ void fetch(uint4* slot, const T* src, bool ok) {
  if constexpr (VEC == 1) {
    *reinterpret_cast<float*>(slot) = ok ? Num<T>::to_f32(*src) : 0.f;
  } else {
    ring_copy16(slot, src, ok);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4* slot, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = *reinterpret_cast<const float*>(slot);
  } else {
    Vec16<T>::unpack(*slot, out);
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

// Picks the vector width (16-byte loads when n and R allow them) and the
// register tile width PB (8 or 16 >= p) of a chain kernel.
template <typename T, template <typename, int, int> class Launch,
          typename... Args>
int dispatch_chain(const void* R, int n, int p, Args... args) {
  const bool vec = n % Vec16<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(R) % 16 == 0;
  if (p <= 8)
    return vec ? Launch<T, Vec16<T>::N, 8>::run(R, n, p, args...)
               : Launch<T, 1, 8>::run(R, n, p, args...);
  return vec ? Launch<T, Vec16<T>::N, 16>::run(R, n, p, args...)
             : Launch<T, 1, 16>::run(R, n, p, args...);
}

}  // namespace prism
