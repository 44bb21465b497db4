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
// What bounds it on the H100: neither the card's memory nor its peak
// arithmetic.  The main paths' warm-tail buckets are small — the q/k/v
// bias view [30, 64, 16] (Muon, polar) and the bias preconditioners
// [30, 16, 16] and [30, 64, 64] (Shampoo, sqrt), 3 iterations each: X (and
// Y) are read once and written once (under 1 MB), and the work is tens of
// MFLOP in a chain of dependent small products, each of which needs the
// whole of the one before; a slice stays in one block, so one SM's
// shared-memory loads set the time (an LDS.128 costs four wavefronts even
// where the lanes share its address: a 4 x 4 tile's 8 loads take longer
// than its 64 FMAs).
//
// Design (redesigned for Hopper): one block per batch slice loops over
// the iterations; X (and Y), R and two rounded Horner operands live in
// shared memory in the operand dtype with the row pitch warm_pitch(n) (a
// multiple of 4 whose quarter is odd, as tiles.cuh's tile_pitch, but the
// smallest one: the coupled family's five operands at [107, 107] fp32
// then fit one block).  Every product is register-tiled (tiles.cuh): a
// thread holds a 4 x 4 tile of outputs and reads 16-byte chunks (8-byte
// in bf16) that adjacent lanes take from adjacent rows or share — no bank
// conflicts, 8 FMAs a load:
//   polar R = I - X^T X      tile_outer (outer products of rows of X)
//   sign R = I - X X, sqrt I - Y X, X's Horner round(acc) @ R:  tile_rows
//   Y's Horner R @ round(acc):                     tile_rows with R as A;
// a product whose 4 x 4 tiles would leave most threads idle (the [16, 16]
// slices, the [64, 16] Horner) takes 1 x 4 tiles (tile_row) instead.
// Each output keeps its own fp32 sum, k ascending with one fmaf a term,
// and its epilogue round(sum + f_j X) runs with __fmul_rn / __fadd_rn on
// it: exactly the element-by-element kernel's arithmetic, so X' and Y' are
// bitwise what it gave.  The fp32 Horner accumulator never reaches shared
// memory: a thread owns the same tiles through every step of an
// iteration, so acc stays in its registers from the product to the
// epilogue, and only round(acc), the next step's operand, is stored (the
// two operand buffers alternate: one barrier a step); the last step
// rounds into X itself (each thread reads X only at its own tiles, for
// the f_0 X term).  The coupled residual keeps the fp32 I - Y X in an
// [n][n + 1] buffer over the two operand buffers (idle until the Horner
// starts; the pad puts the transposed read of the symmetrization on 32
// different banks).  Footprint, ld = warm_pitch(n), op = align16(m ld
// item):
//   op (X) + max(2 op, coupled align16(4 n (n + 1))) (operands, fp32 R)
//   + align16(n ld item) (R) + coupled op (Y)
// (kernels/fused_iter.py::smem_bytes, part of the model kernels/ops.py
// picks the fused tier with; at most 232,448 bytes a block: the [64, 64]
// coupled slice needs 87 KB in fp32, a [1024, 1024] one 21 MB and takes
// the grid tier).
#include "tiles.cuh"

namespace {

using prism::tiles::align16;
using prism::tiles::ceil4;
using prism::tiles::load4;
using prism::tiles::store4;

constexpr int WARM_THREADS = 256;
constexpr int MAX_DEGREE = 4;
constexpr int MAX_ITERS = 64;  // alphas of one launch (kernel argument)
enum Family { POLAR = 0, SIGN = 1, SQRT = 2 };

// row pitch (elements) of a shared operand with `cols` columns: the
// smallest multiple of 4 that holds them whose quarter is odd
__host__ __device__ inline int warm_pitch(int cols) {
  return 4 * (((cols + 3) / 4) | 1);
}

// bytes of the two rounded Horner operands, which the coupled family's
// fp32 residual [n][n + 1] shares
__host__ __device__ inline size_t horner_bytes(size_t op, int n,
                                               int family) {
  const size_t r32 = align16((size_t)4 * n * (n + 1));
  return family == SQRT && r32 > 2 * op ? r32 : 2 * op;
}

__host__ __device__ inline size_t warm_smem_bytes(int m, int n, int item,
                                                  int family) {
  const size_t ld = warm_pitch(n);
  const size_t op = align16((size_t)m * ld * item);
  return op + horner_bytes(op, n, family) + align16((size_t)n * ld * item) +
         (family == SQRT ? op : 0);
}

struct Coeffs {
  float f[MAX_DEGREE];
};

struct Alphas {
  float a[MAX_ITERS];
};

// Whether a product with `rows` output rows and n columns takes 1 x 4
// tiles: where its 4 x 4 tiles would leave most of the block idle (fewer
// than half as many as threads: the [16, 16] slices, the [64, 16] Horner),
// four times as many threads share it.  Chosen once a launch, from the
// Horner's products ([m, n]; sign and sqrt have m = n, and polar's
// residual takes outer products), as a template argument: each
// instantiation holds one shape's code, and its products run a few
// percent faster than with both (PERF.md §6).
__host__ __device__ inline bool narrow_tiles(int rows, int n) {
  return ceil4(rows) * ceil4(n) < WARM_THREADS / 2;
}

// The block's share of P = A @ B (A [rows, K], B [K, n], both with pitch
// ld): each thread takes tiles tid, tid + WARM_THREADS, ... — 4 x 4 (rows
// ti + a TI, lanes on consecutive ti) or, narrow, 1 x 4 (one row, lanes
// on consecutive rows); lanes share B's chunks — and calls emit(u, w0,
// cnt, s) with the fp32 sums s[b] = P[u][w0 + b], b < cnt, of each of its
// rows.  Every sum is one fmaf a term, k ascending, in either shape.
template <bool NARROW, typename T, typename Emit>
__device__ __forceinline__ void row_products(const T* A, const T* B,
                                             int rows, int n, int K, int ld,
                                             Emit emit) {
  const int TJ = ceil4(n);
  if (NARROW) {
    for (int tile = threadIdx.x; tile < rows * TJ; tile += WARM_THREADS) {
      const int tj = tile / rows;
      const int u = tile - tj * rows;
      float s[4];
      prism::tiles::tile_row(A, ld, u, B, ld, 4 * tj, K, s);
      emit(u, 4 * tj, min(4, n - 4 * tj), s);
    }
    return;
  }
  const int TI = ceil4(rows);
  for (int tile = threadIdx.x; tile < TI * TJ; tile += WARM_THREADS) {
    const int tj = tile / TI;
    const int ti = tile - tj * TI;
    float s[4][4];
    prism::tiles::tile_rows(A, ld, rows, ti, TI, B, ld, 4 * tj, K, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int u = ti + a * TI;
      if (u >= rows) break;
      emit(u, 4 * tj, min(4, n - 4 * tj), s[a]);
    }
  }
}

// The epilogues of the products (functors, so that each inlines into its
// tile loop): what each output's fp32 sum s[b] = P[u][w0 + b] becomes.
// Sign: R = round(I - X X).
template <typename T>
struct SignResidual {
  T* r;
  int ld;
  __device__ __forceinline__ void operator()(int u, int w0, int cnt,
                                             const float (&s)[4]) const {
    T o[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      o[b] = prism::Num<T>::from_f32(
          __fsub_rn(u == w0 + b ? 1.f : 0.f, s[b]));
    store4(r + (size_t)u * ld + w0, o, cnt, true);
  }
};

// Sqrt: the fp32 S = I - Y X, rows padded to ld32 = n + 1 floats.
struct SqrtResidual {
  float* r32;
  int ld32;
  __device__ __forceinline__ void operator()(int u, int w0, int cnt,
                                             const float (&s)[4]) const {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (b < cnt)
        r32[u * ld32 + w0 + b] = __fsub_rn(u == w0 + b ? 1.f : 0.f, s[b]);
  }
};

// A Horner step: dst = round(s + f src), src read at the thread's own
// outputs only.
template <typename T>
struct HornerStep {
  const T* src;
  T* dst;
  int ld;
  float f;
  __device__ __forceinline__ void operator()(int u, int w0, int cnt,
                                             const float (&s)[4]) const {
    float xs[4];
    load4(src + (size_t)u * ld + w0, xs);
    T o[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      o[b] = prism::Num<T>::from_f32(__fadd_rn(s[b], __fmul_rn(f, xs[b])));
    store4(dst + (size_t)u * ld + w0, o, cnt, true);
  }
};

// R = round(I - X^T X) (polar), round(I - X X) (sign) or, coupled,
// round(0.5 (S + S^T)) with S = I - Y X on the fp32 sums; x and y [m, n]
// and r with pitch ld, r32 the coupled family's fp32 S.  Ends after a
// barrier.
template <typename T, int FAMILY, bool NARROW>
__device__ __forceinline__ void residual(const T* x, const T* y, T* r,
                                         float* r32, int m, int n, int ld) {
  using N = prism::Num<T>;
  const int tid = threadIdx.x;
  if (FAMILY == POLAR) {
    // outer products of the rows of X, lanes on consecutive column tiles
    const int T4 = ceil4(n);
    for (int tile = tid; tile < T4 * T4; tile += WARM_THREADS) {
      const int ti = tile / T4;
      const int w0 = 4 * (tile - ti * T4);
      const int cnt = min(4, n - w0);
      float s[4][4];
      prism::tiles::tile_outer(x, ld, 4 * ti, x, ld, w0, m, s);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int u = 4 * ti + a;
        if (u >= n) break;
        T o[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          o[b] = N::from_f32(__fsub_rn(u == w0 + b ? 1.f : 0.f, s[a][b]));
        store4(r + (size_t)u * ld + w0, o, cnt, true);
      }
    }
  } else if (FAMILY == SIGN) {
    // the left operand by rows
    row_products<NARROW>(x, x, n, n, n, ld,
                 SignResidual<T>{r, ld});
  } else {
    // the fp32 S, then 0.5 (S + S^T) rounded once, four columns a thread
    // at a time (lanes on consecutive rows: both reads of S hit 32
    // different banks)
    const int ld32 = n + 1;
    row_products<NARROW>(y, x, n, n, n, ld,
                 SqrtResidual{r32, ld32});
    __syncthreads();
    const int TJ = ceil4(n);
    for (int c = tid; c < n * TJ; c += WARM_THREADS) {
      const int w0 = 4 * (c / n);
      const int u = c - (w0 / 4) * n;
      const int cnt = min(4, n - w0);
      T o[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int w = b < cnt ? w0 + b : w0;
        o[b] = N::from_f32(__fmul_rn(
            0.5f, __fadd_rn(r32[u * ld32 + w], r32[w * ld32 + u])));
      }
      store4(r + (size_t)u * ld + w0, o, cnt, true);
    }
  }
  __syncthreads();
}

// src <- round(Horner of src on R), in place: src g_d(R; a) (LEFT false,
// src [rows, n]) or g_d(R; a) src (LEFT true, src [n, n]); src, lo0, lo1
// and r with pitch ld.  A thread's tiles are the same at every step, so
// each step's fp32 acc goes from its product to its epilogue in registers;
// only round(acc) is stored, into lo0 / lo1 in turn, and the last step's
// into src (each thread reads src only at its own tiles).  Ends after a
// barrier.
template <typename T, bool LEFT, bool NARROW>
__device__ __forceinline__ void horner(T* src, int rows, T* lo0, T* lo1,
                                       const T* r, int n, int ld, float a,
                                       int degree, const Coeffs& coeffs) {
  using N = prism::Num<T>;
  // round(a src), four columns a thread at a time
  const int TJ = ceil4(n);
  for (int c = threadIdx.x; c < rows * TJ; c += WARM_THREADS) {
    const int w0 = 4 * (c / rows);
    const int u = c - (w0 / 4) * rows;
    float xs[4];
    load4(src + (size_t)u * ld + w0, xs);
    T o[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) o[b] = N::from_f32(__fmul_rn(a, xs[b]));
    store4(lo0 + (size_t)u * ld + w0, o, min(4, n - w0), true);
  }
  __syncthreads();
  const T* cur = lo0;
  T* nxt = lo1;
  for (int j = degree - 1; j >= 0; --j) {
    const HornerStep<T> step{src, j > 0 ? nxt : src, ld, coeffs.f[j]};
    if (LEFT)
      row_products<NARROW>(r, cur, rows, n, n, ld, step);
    else
      row_products<NARROW>(cur, r, rows, n, n, ld, step);
    __syncthreads();
    T* done = const_cast<T*>(cur);
    cur = nxt;
    nxt = done;
  }
}

// a [rows, cols] operand with pitch ld from shared memory to device memory
// (row stride cols): four neighbours a store when the rows allow it
template <typename T>
__device__ __forceinline__ void unstage(T* __restrict__ dst, const T* src,
                                        int ld, int rows, int cols) {
  using Q = typename prism::tiles::Quad<T>::type;
  if ((cols & 3) == 0 && reinterpret_cast<uintptr_t>(dst) % sizeof(Q) == 0) {
    const int quads = cols / 4;
    for (int i = threadIdx.x; i < rows * quads; i += WARM_THREADS) {
      const int u = i / quads;
      const int c = 4 * (i - u * quads);
      *reinterpret_cast<Q*>(dst + (size_t)u * cols + c) =
          *reinterpret_cast<const Q*>(src + (size_t)u * ld + c);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += WARM_THREADS) {
    const int u = i / cols;
    dst[i] = src[(size_t)u * ld + (i - u * cols)];
  }
}

// minimum 1 block an SM: a launch has one block a slice (30 on the main
// paths, fewer than the SMs), so nothing is gained by capping registers to
// fit more (the compiler's own choice held the coupled instantiations to
// 80 registers, and they spilled)
template <typename T, int FAMILY, bool NARROW>
__global__ void __launch_bounds__(WARM_THREADS, 1)
    warm_tail_kernel(const T* __restrict__ X_in, const T* __restrict__ Y_in,
                     T* __restrict__ X_out, T* __restrict__ Y_out,
                     Alphas alphas, int n_iters, int m, int n, int degree,
                     Coeffs coeffs) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool coupled = FAMILY == SQRT;
  const int ld = warm_pitch(n);
  const size_t op = align16((size_t)m * ld * sizeof(T));
  const size_t hb = horner_bytes(op, n, FAMILY);
  T* x = reinterpret_cast<T*>(smem);
  T* lo0 = reinterpret_cast<T*>(smem + op);
  T* lo1 = reinterpret_cast<T*>(smem + 2 * op);
  float* r32 = reinterpret_cast<float*>(smem + op);  // coupled: over lo0/lo1
  T* r = reinterpret_cast<T*>(smem + op + hb);
  T* y = reinterpret_cast<T*>(smem + op + hb +
                              align16((size_t)n * ld * sizeof(T)));
  const size_t b = blockIdx.x;
  const size_t mn = (size_t)m * n;
  const size_t nn = (size_t)n * n;

  prism::tiles::stage<T, WARM_THREADS>(x, ld, X_in + b * mn, n, m, n);
  if (coupled)
    prism::tiles::stage<T, WARM_THREADS>(y, ld, Y_in + b * nn, n, n, n);
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    residual<T, FAMILY, NARROW>(x, y, r, r32, m, n, ld);
    const float a = alphas.a[it];
    horner<T, false, NARROW>(x, m, lo0, lo1, r, n, ld, a, degree, coeffs);
    if (coupled)
      horner<T, true, NARROW>(y, n, lo0, lo1, r, n, ld, a, degree, coeffs);
  }

  unstage(X_out + b * mn, x, ld, m, n);
  if (coupled) unstage(Y_out + b * nn, y, ld, n, n);
}

template <typename T, int FAMILY, bool NARROW>
int launch_shape(const void* X, const void* Y, void* X_out, void* Y_out,
                 const Alphas& alphas, int n_iters, int batch, int m, int n,
                 int degree, const Coeffs& coeffs, size_t smem,
                 cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        warm_tail_kernel<T, FAMILY, NARROW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  warm_tail_kernel<T, FAMILY, NARROW><<<batch, WARM_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(X_out), static_cast<T*>(Y_out), alphas, n_iters, m, n,
      degree, coeffs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int FAMILY>
int launch(const void* X, const void* Y, void* X_out, void* Y_out,
           const Alphas& alphas, int n_iters, int batch, int m, int n,
           int degree, const Coeffs& coeffs, size_t smem, cudaStream_t s) {
  if (narrow_tiles(m, n))
    return launch_shape<T, FAMILY, true>(X, Y, X_out, Y_out, alphas,
                                         n_iters, batch, m, n, degree,
                                         coeffs, smem, s);
  return launch_shape<T, FAMILY, false>(X, Y, X_out, Y_out, alphas, n_iters,
                                        batch, m, n, degree, coeffs, smem,
                                        s);
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
