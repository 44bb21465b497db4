// K6: the first launch of a fused-tier fitted PRISM iteration: the family
// residual R AND its whole sketched power-trace chain
// t_i = tr(S R^i S^T), i = 1..max_power, in one launch per bucket, with
//
//   polar  R = I - X^T X      sign  R = I - X X
//   sqrt   R = sym(I - Y X) = 0.5 (I - Y X + (I - Y X)^T)   (coupled)
//
// Replaces the TPU kernel repro/kernels/fused_iter.py::residual_chain
// (_res_chain_kernel).  Per slice: I - <product> is formed on an fp32
// accumulator (and, for sqrt, symmetrized there) and rounded ONCE to the
// operand dtype; that rounded R is written out (the Horner launch K7
// reads it) and the chain runs on it from shared memory, each trace
// reduced from the fp32 accumulator of R @ V before V rounds (DESIGN.md
// §9).
//
// What bounds it on the H100: neither memory nor arithmetic.  On the main
// paths (the q/k/v bias view [30, 64, 16], 6 powers, Muon PRISM-3; the
// bias preconditioners [30, 16, 16] and [30, 64, 64], 10 powers, Shampoo)
// a slice moves under 50 KB and does under 2 MFLOP, so the block's chain of
// dependent small products, its shared-memory traffic and its barriers set
// the time (one block per slice: the powers of a slice are sequential).
//
// Design (redesigned for Hopper): one block per slice; X (and Y), R, St and
// two V buffers live in shared memory in the operand dtype with the row
// pitch of tiles.cuh (a multiple of 4 whose quarter is odd).  Every product
// is register-tiled (tiles.cuh): a thread holds a 4 x 4 tile of the
// residual, or one row by four columns of V' = R V in the chain (R is then
// read once per four columns of V), and reads its operands as 16-byte
// chunks (8-byte in bf16) that adjacent lanes take from adjacent rows or
// share: no load conflicts, and 8 FMAs a load in the residual, 16 FMAs to
// 5 loads in the chain.  Each output keeps one fp32 sum, k ascending with
// fmaf, as the element-by-element kernel did, so R and every V' are
// bitwise what it gave.  The polar residual reads X^T X as outer products
// of rows of X; sign and sqrt read X X and Y X by rows of the left
// operand.  The coupled residual is kept in fp32 in an [n][n + 1] buffer,
// padded so that the transposed read of the symmetrization hits 32
// different banks.  Each trace is reduced from the fp32 sums in a fixed
// order: a thread's columns, a shuffle tree in its warp, then the warps'
// partials in warp order, added after the power's barrier by the last
// warp (idle in the chain at the main-path shapes; two partial buffers
// alternate, so a power needs one barrier).  Footprint, ld = tile_pitch(n),
// ldp = tile_pitch(p):
//   align16(m ld item) + align16(n ld item) + 3 align16(n ldp item)
//   + 8 RC_WARPS + coupled (align16(n ld item) + 4 n (n + 1))
// (kernels/fused_iter.py::residual_chain_smem_bytes), part of the model
// kernels/ops.py::fused_fits picks the fused tier with.
#include "tiles.cuh"

namespace {

using prism::tiles::align16;
using prism::tiles::ceil4;
using prism::tiles::store4;
using prism::tiles::tile_pitch;

constexpr int RC_THREADS = 256;
constexpr int RC_WARPS = RC_THREADS / 32;
constexpr int MAX_SKETCH = 16;
enum Family { POLAR = 0, SIGN = 1, SQRT = 2 };

__host__ __device__ inline size_t rc_smem_bytes(int m, int n, int p,
                                                int item, int family) {
  const size_t ld = tile_pitch(n);
  const size_t ldp = tile_pitch(p);
  size_t b = align16((size_t)m * ld * item) + align16((size_t)n * ld * item) +
             3 * align16((size_t)n * ldp * item) + 2 * RC_WARPS * 4;
  if (family == SQRT)
    b += align16((size_t)n * ld * item) + (size_t)n * (n + 1) * 4;
  return b;
}

template <typename T, int FAMILY>
__global__ void __launch_bounds__(RC_THREADS)
    residual_chain_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                          const T* __restrict__ St, T* __restrict__ R_out,
                          float* __restrict__ t, int m, int n, int p,
                          int max_power) {
  extern __shared__ __align__(16) unsigned char smem[];
  using N = prism::Num<T>;
  const int ld = tile_pitch(n);
  const int ldp = tile_pitch(p);
  const size_t vbytes = align16((size_t)n * ldp * sizeof(T));
  unsigned char* base = smem;
  T* x = reinterpret_cast<T*>(base);
  base += align16((size_t)m * ld * sizeof(T));
  T* r = reinterpret_cast<T*>(base);
  base += align16((size_t)n * ld * sizeof(T));
  T* stt = reinterpret_cast<T*>(base);
  T* v0 = reinterpret_cast<T*>(base + vbytes);
  T* v1 = reinterpret_cast<T*>(base + 2 * vbytes);
  base += 3 * vbytes;
  float* part = reinterpret_cast<float*>(base);  // [2][RC_WARPS]
  base += 2 * RC_WARPS * sizeof(float);
  // coupled only: Y, and the fp32 residual with rows padded to n + 1
  T* y = reinterpret_cast<T*>(base);
  float* r32 =
      reinterpret_cast<float*>(base + align16((size_t)n * ld * sizeof(T)));
  const int ld32 = n + 1;
  const size_t b = blockIdx.x;
  X += b * (size_t)m * n;
  R_out += b * (size_t)n * n;
  t += b * (size_t)max_power;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  prism::tiles::stage<T, RC_THREADS>(x, ld, X, n, m, n);
  if (FAMILY == SQRT)
    prism::tiles::stage<T, RC_THREADS>(y, ld, Y + b * (size_t)n * n, n, n,
                                       n);
  prism::tiles::stage<T, RC_THREADS>(stt, ldp, St, p, n, p);
  __syncthreads();

  // tiles of 4 along a side of R; R_out's rows take vector stores when
  // they are aligned for them
  const int T4 = ceil4(n);
  const bool vec_out = (n & 3) == 0;
  if (FAMILY == POLAR) {
    // R = I - X^T X on the fp32 sums, rounded once: outer products of the
    // rows of X, lanes on consecutive column tiles
    for (int tile = tid; tile < T4 * T4; tile += RC_THREADS) {
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
        for (int b = 0; b < 4; ++b) {
          const int w = w0 + b;
          o[b] = N::from_f32(__fsub_rn(u == w ? 1.f : 0.f, s[a][b]));
        }
        store4(r + (size_t)u * ld + w0, o, cnt, true);
        store4(R_out + (size_t)u * n + w0, o, cnt, vec_out);
      }
    }
  } else {
    // R = I - X X (sign) on the fp32 sums, rounded once, or the fp32
    // residual I - Y X (sqrt): the left operand by rows, lanes on
    // consecutive (interleaved) rows
    const T* A = FAMILY == SQRT ? y : x;
    for (int tile = tid; tile < T4 * T4; tile += RC_THREADS) {
      const int tj = tile / T4;
      const int ti = tile - tj * T4;
      const int w0 = 4 * tj;
      const int cnt = min(4, n - w0);
      float s[4][4];
      prism::tiles::tile_rows(A, ld, n, ti, T4, x, ld, w0, n, s);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int u = ti + a * T4;
        if (u >= n) break;
        T o[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int w = w0 + b;
          const float d = __fsub_rn(u == w ? 1.f : 0.f, s[a][b]);
          if (FAMILY == SQRT) {
            if (b < cnt) r32[(size_t)u * ld32 + w] = d;
          } else {
            o[b] = N::from_f32(d);
          }
        }
        if (FAMILY != SQRT) {
          store4(r + (size_t)u * ld + w0, o, cnt, true);
          store4(R_out + (size_t)u * n + w0, o, cnt, vec_out);
        }
      }
    }
    if (FAMILY == SQRT) {
      __syncthreads();
      // 0.5 (R + R^T) rounded once
      for (int idx = tid; idx < n * n; idx += RC_THREADS) {
        const int i = idx / n;
        const int j = idx - i * n;
        const float sym =
            __fmul_rn(0.5f, __fadd_rn(r32[(size_t)i * ld32 + j],
                                      r32[(size_t)j * ld32 + i]));
        const T o = N::from_f32(sym);
        r[(size_t)i * ld + j] = o;
        R_out[idx] = o;
      }
    }
  }
  __syncthreads();

  for (int pw = 0; pw < max_power; ++pw) {
    const T* vin = pw == 0 ? stt : ((pw & 1) ? v0 : v1);
    T* vout = (pw & 1) ? v1 : v0;
    float* wpart = part + (pw & 1) * RC_WARPS;
    float tpart = 0.f;
    for (int tile = tid; tile < n * ceil4(p); tile += RC_THREADS) {
      const int c0 = 4 * (tile / n);
      const int u = tile - (c0 / 4) * n;
      const int cnt = min(4, p - c0);
      float s[4], st[4];
      prism::tiles::tile_row(r, ld, u, vin, ldp, c0, n, s);
      prism::tiles::load4(stt + (size_t)u * ldp + c0, st);
      T o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // the trace reads the fp32 sum, before V rounds
        if (c < cnt) tpart = fmaf(st[c], s[c], tpart);
        o[c] = N::from_f32(s[c]);
      }
      store4(vout + (size_t)u * ldp + c0, o, cnt, true);
    }
    // the warp's partials by a shuffle tree, then the warps' in warp order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tpart = __fadd_rn(tpart, __shfl_down_sync(0xffffffffu, tpart, off));
    if (lane == 0) wpart[warp] = tpart;
    __syncthreads();  // V' and this power's partials are written
    if (tid == RC_THREADS - 32) {
      float sum = 0.f;
      for (int w = 0; w < RC_WARPS; ++w) sum = __fadd_rn(sum, wpart[w]);
      t[pw] = sum;
    }
  }
}

template <typename T, int FAMILY>
int launch(const void* X, const void* Y, const void* St, void* R, float* t,
           int batch, int m, int n, int p, int max_power, size_t smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        residual_chain_kernel<T, FAMILY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  residual_chain_kernel<T, FAMILY><<<batch, RC_THREADS, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<const T*>(St), static_cast<T*>(R), t, m, n, p, max_power);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_family(int family, const void* X, const void* Y, const void* St,
                  void* R, float* t, int batch, int m, int n, int p,
                  int max_power, size_t smem, cudaStream_t s) {
  if (family == SIGN)
    return launch<T, SIGN>(X, Y, St, R, t, batch, m, n, p, max_power, smem,
                           s);
  if (family == SQRT)
    return launch<T, SQRT>(X, Y, St, R, t, batch, m, n, p, max_power, smem,
                           s);
  return launch<T, POLAR>(X, Y, St, R, t, batch, m, n, p, max_power, smem,
                          s);
}

}  // namespace

// family: 0 polar, 1 sign, 2 sqrt (Y is read only for sqrt; sign and sqrt
// need m == n).  smem_bytes is the footprint the caller's model computed;
// a launch whose model disagrees with the layout above is refused rather
// than run out of bounds.
extern "C" int prism_residual_chain(const void* X, const void* Y,
                                    const void* St, void* R, void* t,
                                    int batch, int m, int n, int p,
                                    int max_power, int family,
                                    long long smem_bytes, int bf16,
                                    void* stream) {
  if (batch < 1 || m < 1 || n < 1 || p < 1 || p > MAX_SKETCH ||
      max_power < 0 || family < POLAR || family > SQRT ||
      (family != POLAR && m != n) || (family == SQRT && Y == nullptr))
    return cudaErrorInvalidValue;
  const size_t need = rc_smem_bytes(m, n, p, bf16 ? 2 : 4, family);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) != need)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tf = static_cast<float*>(t);
  if (bf16)
    return launch_family<__nv_bfloat16>(family, X, Y, St, R, tf, batch, m, n,
                                        p, max_power, need, s);
  return launch_family<float>(family, X, Y, St, R, tf, batch, m, n, p,
                              max_power, need, s);
}
