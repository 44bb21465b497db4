// Register-tiled small products in shared memory, shared by the fused
// fitted-iteration kernels K6 (residual_chain.cu) and K7 (apply_g.cu).
//
// Every operand lives in shared memory in the operand dtype T, row-major,
// with a row pitch of tile_pitch(cols) elements: a multiple of 4 (so that
// four neighbours load as one 16-byte fp32 or 8-byte bf16 access) whose
// quarter is odd.  Four ADJACENT rows then start in four different 16-byte
// bank groups (eight, for the 8-byte bf16 accesses of a half warp), so
// lanes that read one 4-wide chunk each of adjacent rows never conflict.
//
// A thread computes a 4 x 4 tile of outputs (a 1 x 4 tile in K6's chain)
// from values it holds in registers: per step of 4 in the contraction it
// loads 4 chunks of A (1) and 4 of B and issues 64 (16) FMAs.  Each
// output keeps its own fp32 sum, k ascending, one fmaf per term: exactly
// the order of the element-by-element kernels these replace, so the
// results are bitwise the same.  The lanes of a warp take consecutive tile
// ROWS; with the rows of a tile interleaved (row ti + a TI, a = 0..3, TI
// tiles of rows) adjacent lanes read adjacent rows of A (no conflict) and
// share the chunk of B (a broadcast).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace prism {
namespace tiles {

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// row pitch (elements) of a shared operand with `cols` columns
__host__ __device__ inline int tile_pitch(int cols) {
  return (cols + 7) / 8 * 8 + 4;
}

__host__ __device__ inline int ceil4(int v) { return (v + 3) / 4; }

// four neighbours from shared memory (16-byte fp32 / 8-byte bf16 access)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// a bf16 is the top half of the fp32 with the same value; element 2i is
// the low half of word i (little endian)
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void vstore4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void vstore4(__nv_bfloat16* p,
                                        const __nv_bfloat16 (&v)[4]) {
  uint2 u;
  u.x = (unsigned)__bfloat16_as_ushort(v[0]) |
        ((unsigned)__bfloat16_as_ushort(v[1]) << 16);
  u.y = (unsigned)__bfloat16_as_ushort(v[2]) |
        ((unsigned)__bfloat16_as_ushort(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

// the first `count` of four rounded values to p; one vector store when all
// four go and p is aligned for it (`vec`)
template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&v)[4], int count,
                                       bool vec) {
  if (vec && count == 4) {
    vstore4(p, v);
    return;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < count) p[b] = v[b];
}

// s[a][b] = sum_k A[u_a][k] B[k][w0 + b], k = 0..K-1 ascending, u_a =
// ti + a TI.  A rows past `rows` read row 0 (their sums are not used);
// B's columns w0..w0+3 must lie inside its pitch.
template <typename T>
__device__ __forceinline__ void tile_rows(const T* A, int lda, int rows,
                                          int ti, int TI, const T* B,
                                          int ldb, int w0, int K,
                                          float (&s)[4][4]) {
  using N = Num<T>;
  const T* ap[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int u = ti + a * TI;
    ap[a] = A + (size_t)(u < rows ? u : 0) * lda;
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
  }
  const T* bp = B + w0;
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= K; k += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) load4(ap[a] + k, av[a]);
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(bp + (size_t)(k + q) * ldb, bv[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          s[a][b] = fmaf(av[a][q], bv[q][b], s[a][b]);
  }
  for (; k < K; ++k) {
    float bv[4];
    load4(bp + (size_t)k * ldb, bv);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float av = N::to_f32(ap[a][k]);
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av, bv[b], s[a][b]);
    }
  }
}

// s[a][b] = sum_k At[k][u0 + a] B[k][w0 + b], k ascending: A given
// transposed (A^T row-major), both operands read as chunks of row k; lanes
// on consecutive w0 read consecutive chunks and share At's (K6's polar
// residual, whose A is X^T).
template <typename T>
__device__ __forceinline__ void tile_outer(const T* At, int lda, int u0,
                                           const T* B, int ldb, int w0, int K,
                                           float (&s)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
    load4(At + (size_t)k * lda + u0, av);
    load4(B + (size_t)k * ldb + w0, bv);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
}

// s[b] = sum_k A[u][k] B[k][c0 + b], k ascending: one row of A against
// four columns of B.  Lanes on consecutive rows u read adjacent rows of A
// and the same chunks of B (a broadcast), so each chunk of A feeds 16
// FMAs and A is read once per four columns (K6's chain, B = V).
template <typename T>
__device__ __forceinline__ void tile_row(const T* A, int lda, int u,
                                         const T* B, int ldb, int c0, int K,
                                         float (&s)[4]) {
  using N = Num<T>;
  const T* ap = A + (size_t)u * lda;
  const T* bp = B + c0;
#pragma unroll
  for (int b = 0; b < 4; ++b) s[b] = 0.f;
  int k = 0;
#pragma unroll 4
  for (; k + 4 <= K; k += 4) {
    float av[4], bv[4][4];
    load4(ap + k, av);
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(bp + (size_t)(k + q) * ldb, bv[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[b] = fmaf(av[q], bv[q][b], s[b]);
  }
  for (; k < K; ++k) {
    float bv[4];
    load4(bp + (size_t)k * ldb, bv);
    const float av = N::to_f32(ap[k]);
#pragma unroll
    for (int b = 0; b < 4; ++b) s[b] = fmaf(av, bv[b], s[b]);
  }
}

// four neighbours as one access: 16 bytes of fp32, 8 of bf16
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
};
template <>
struct Quad<__nv_bfloat16> {
  using type = uint2;
};

// copy a [rows, cols] block with row stride `lds` from device memory into
// shared memory with row pitch `ld` (the pad columns are left as they
// are): four neighbours an access when the rows allow it, so that a
// thread's loads are few and all in flight at once
template <typename T, int THREADS>
__device__ __forceinline__ void stage(T* dst, int ld,
                                      const T* __restrict__ src, size_t lds,
                                      int rows, int cols) {
  using Q = typename Quad<T>::type;
  if ((cols & 3) == 0 && (lds & 3) == 0 &&
      reinterpret_cast<uintptr_t>(src) % sizeof(Q) == 0) {
    const int quads = cols / 4;
    const int total = rows * quads;
#pragma unroll 4
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int r = i / quads;
      const int c = 4 * (i - r * quads);
      *reinterpret_cast<Q*>(dst + (size_t)r * ld + c) =
          *reinterpret_cast<const Q*>(src + (size_t)r * lds + c);
    }
    return;
  }
  const int total = rows * cols;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / cols;
    const int c = i - r * cols;
    dst[(size_t)r * ld + c] = src[(size_t)r * lds + c];
  }
}

}  // namespace tiles
}  // namespace prism
