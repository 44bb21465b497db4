// K7: the second launch of a fused-tier fitted PRISM iteration:
// X' = X g_d(R; alpha) with a fitted alpha per batch slice and, for the
// coupled sqrt family, Y' = g_d(R; alpha) Y from the same R, in the same
// launch.
//
// Replaces the TPU kernel repro/kernels/fused_iter.py::apply_g
// (_apply_kernel with _horner32, right side and, coupled, left side):
//   acc = alpha_b * X                                  (fp32)
//   for j = d-1 .. 0:  acc = round(acc) @ R + f_j * X   (fp32, f_j * X
//                                                        never rounds)
//   X'  = round(acc)
// and, coupled, acc = alpha_b * Y; acc = R @ round(acc) + f_j * Y;
// Y' = round(acc).  alpha is a [B] fp32 device tensor (the fit's output)
// that each block reads for its own slice: it is never rounded to the
// operand dtype and never passes through the host (DESIGN.md §9/§10).
//
// What bounds it on the H100: neither memory nor arithmetic.  On the main
// paths (the q/k/v bias view [30, 64, 16], degree 1, Muon PRISM-3; the bias
// preconditioners [30, 16, 16] and [30, 64, 64], degree 2, coupled,
// Shampoo) a slice moves under 70 KB and does under 2 MFLOP; the launch,
// the staging of R and the chain of d dependent products set the time.
//
// Design (redesigned for Hopper): a 2-D grid (batch, splits x sides).  A
// row of X' = X g(R) depends only on the same row of X and on R, and a
// column of Y' = g(R) Y only on the same column of Y and on R, so the block
// (b, s) takes `rows` rows of X from row s rows, and, coupled, the block
// (b, splits + s) as many columns of Y from that column, with no exchange
// between blocks: the two coupled sides run side by side.  Each block
// stages R whole (from L2 after the first).  kernels/fused_iter.py::
// apply_g_rows picks `rows` from the batch so that a side has about one
// block per SM (120 blocks a side on the main-path buckets of 30 slices).
// In a block, R, its rows of X (or columns of Y) and two rounded Horner
// operands live in shared memory with the row pitch of tiles.cuh; each
// Horner product is register-tiled (a thread holds a 4 x 4 tile and reads
// 16-byte chunks, 8-byte in bf16, that adjacent lanes take from adjacent
// rows or share): no load conflicts and 8 FMAs a load.  Every output keeps
// one fp32 sum, k ascending with fmaf, and its epilogue round(sum + f_j *
// X) runs on it with __fmul_rn / __fadd_rn, so X' and Y' are bitwise what
// the one-block-a-slice kernel gave.  The fp32 accumulator never needs
// storing: a step keeps only its rounded operand (two buffers alternate,
// one barrier a step), and the last step's rounded sums are the output.
// Footprint, ld = tile_pitch(n), chunk = max(rows ld, coupled n
// tile_pitch(rows)):
//   align16(n ld item) + 3 align16(chunk item)
// (kernels/fused_iter.py::apply_g_smem_bytes; with rows = m it is the
// model the fused tier is chosen with).
#include "tiles.cuh"

namespace {

using prism::tiles::align16;
using prism::tiles::ceil4;
using prism::tiles::store4;
using prism::tiles::tile_pitch;

constexpr int AG_THREADS = 256;
constexpr int MAX_DEGREE = 4;

__host__ __device__ inline size_t ag_smem_bytes(int m, int n, int rows,
                                                int item, int coupled) {
  const size_t ld = tile_pitch(n);
  size_t chunk = (size_t)rows * ld;
  if (coupled && (size_t)n * tile_pitch(rows) > chunk)
    chunk = (size_t)n * tile_pitch(rows);
  return align16((size_t)n * ld * item) + 3 * align16(chunk * item);
}

struct Coeffs {
  float f[MAX_DEGREE];
};

// out = round(src g_d(R; a)) (LEFT false: src and out [rows, n], the
// Horner operand times R) or round(g_d(R; a) src) (LEFT true: src and out
// [n, cols], R times the operand); src, lo0 and lo1 in shared memory with
// pitch lds, R with pitch ldr, out in device memory with row stride ldo.
// Ends after a barrier.
template <typename T, bool LEFT>
__device__ __forceinline__ void horner(const T* src, int lds, T* lo0,
                                       T* lo1, const T* r, int ldr, int rows,
                                       int cols, int n, float a, int degree,
                                       const Coeffs& coeffs, T* out,
                                       size_t ldo, bool vec_out) {
  using N = prism::Num<T>;
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * cols; i += AG_THREADS) {
    const int u = i / cols;
    const size_t at = (size_t)u * lds + (i - u * cols);
    lo0[at] = N::from_f32(__fmul_rn(a, N::to_f32(src[at])));
  }
  __syncthreads();
  const int TI = ceil4(rows);
  const int TJ = ceil4(cols);
  const T* cur = lo0;
  T* nxt = lo1;
  for (int j = degree - 1; j >= 0; --j) {
    const float f = coeffs.f[j];
    for (int tile = tid; tile < TI * TJ; tile += AG_THREADS) {
      const int tj = tile / TI;
      const int ti = tile - tj * TI;
      const int w0 = 4 * tj;
      const int cnt = min(4, cols - w0);
      float s[4][4];
      if (LEFT)
        prism::tiles::tile_rows(r, ldr, rows, ti, TI, cur, lds, w0, n, s);
      else
        prism::tiles::tile_rows(cur, lds, rows, ti, TI, r, ldr, w0, n, s);
#pragma unroll
      for (int a4 = 0; a4 < 4; ++a4) {
        const int u = ti + a4 * TI;
        if (u >= rows) break;
        float xs[4];
        prism::tiles::load4(src + (size_t)u * lds + w0, xs);
        T o[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          o[b] = N::from_f32(__fadd_rn(s[a4][b], __fmul_rn(f, xs[b])));
        if (j > 0)
          store4(nxt + (size_t)u * lds + w0, o, cnt, true);
        else
          store4(out + (size_t)u * ldo + w0, o, cnt, vec_out);
      }
    }
    __syncthreads();
    T* done = const_cast<T*>(cur);
    cur = nxt;
    nxt = done;
  }
}

template <typename T, bool COUPLED>
__global__ void __launch_bounds__(AG_THREADS)
    apply_g_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                   const T* __restrict__ R, const float* __restrict__ alpha,
                   T* __restrict__ X_out, T* __restrict__ Y_out, int m, int n,
                   int H, int degree, Coeffs coeffs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_pitch(n);
  const int ldw = tile_pitch(H);
  size_t chunk = (size_t)H * ld;
  if (COUPLED && (size_t)n * ldw > chunk) chunk = (size_t)n * ldw;
  const size_t cbytes = align16(chunk * sizeof(T));
  T* r = reinterpret_cast<T*>(smem);
  unsigned char* base = smem + align16((size_t)n * ld * sizeof(T));
  T* src = reinterpret_cast<T*>(base);  // X rows, then Y columns
  T* lo0 = reinterpret_cast<T*>(base + cbytes);
  T* lo1 = reinterpret_cast<T*>(base + 2 * cbytes);
  const size_t b = blockIdx.x;
  const int splits = COUPLED ? gridDim.y / 2 : gridDim.y;
  const int s = blockIdx.y % splits;
  const int r0 = s * H;  // the block's first row of X (or column of Y)
  const float a = alpha[b];
  const bool vec_out = (n & 3) == 0;

  prism::tiles::stage<T, AG_THREADS>(r, ld, R + b * (size_t)n * n, n, n, n);
  if (!COUPLED || (int)blockIdx.y < splits) {
    const int h = min(H, m - r0);
    prism::tiles::stage<T, AG_THREADS>(src, ld, X + (b * m + r0) * (size_t)n,
                                       n, h, n);
    __syncthreads();
    horner<T, false>(src, ld, lo0, lo1, r, ld, h, n, n, a, degree, coeffs,
                     X_out + (b * m + r0) * (size_t)n, n, vec_out);
  } else {
    // columns of Y (m == n: as many as a block's rows of X)
    const int w = min(H, n - r0);
    prism::tiles::stage<T, AG_THREADS>(src, ldw, Y + b * (size_t)n * n + r0,
                                       n, n, w);
    __syncthreads();
    horner<T, true>(src, ldw, lo0, lo1, r, ld, n, w, n, a, degree, coeffs,
                    Y_out + b * (size_t)n * n + r0, n, vec_out);
  }
}

template <typename T, bool COUPLED>
int launch(const void* X, const void* Y, const void* R, const float* alpha,
           void* X_out, void* Y_out, int batch, int m, int n, int rows,
           int degree, const Coeffs& coeffs, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        apply_g_kernel<T, COUPLED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(batch, (m + rows - 1) / rows * (COUPLED ? 2 : 1));
  apply_g_kernel<T, COUPLED><<<grid, AG_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<const T*>(R), alpha, static_cast<T*>(X_out),
      static_cast<T*>(Y_out), m, n, rows, degree, coeffs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_coupled(int coupled, const void* X, const void* Y, const void* R,
                   const float* alpha, void* X_out, void* Y_out, int batch,
                   int m, int n, int rows, int degree, const Coeffs& coeffs,
                   size_t smem, cudaStream_t s) {
  if (coupled)
    return launch<T, true>(X, Y, R, alpha, X_out, Y_out, batch, m, n, rows,
                           degree, coeffs, smem, s);
  return launch<T, false>(X, Y, R, alpha, X_out, Y_out, batch, m, n, rows,
                          degree, coeffs, smem, s);
}

}  // namespace

// Y and Y_out are null for the one-sided application and both set for the
// coupled one (which needs m == n).  rows: a block's rows of X (or
// columns of Y), a multiple of 4 or m itself; the grid is (batch,
// ceil(m / rows)), twice as many coupled.  smem_bytes is the footprint the
// caller's model computed for those rows; a launch whose model disagrees
// with the layout above is refused rather than run out of bounds.
extern "C" int prism_apply_g(const void* X, const void* Y, const void* R,
                             const void* alpha, void* X_out, void* Y_out,
                             int batch, int m, int n, int rows, int degree,
                             const float* coeffs, long long smem_bytes,
                             int bf16, void* stream) {
  const int coupled = Y != nullptr ? 1 : 0;
  if (batch < 1 || m < 1 || n < 1 || degree < 1 || degree > MAX_DEGREE ||
      rows < 1 || rows > m || (rows % 4 != 0 && rows != m) ||
      (Y_out != nullptr) != (coupled == 1) || (coupled && m != n))
    return cudaErrorInvalidValue;
  const size_t need = ag_smem_bytes(m, n, rows, bf16 ? 2 : 4, coupled);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  Coeffs c = {};
  for (int j = 0; j < degree; ++j) c.f[j] = coeffs[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  if (bf16)
    return launch_coupled<__nv_bfloat16>(coupled, X, Y, R, a, X_out, Y_out,
                                         batch, m, n, rows, degree, c, need,
                                         s);
  return launch_coupled<float>(coupled, X, Y, R, a, X_out, Y_out, batch, m,
                               n, rows, degree, c, need, s);
}
