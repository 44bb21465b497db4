// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel keeps the reference's precision contract (DESIGN.md §9):
// operands are fp32 or bf16, products accumulate in fp32 (a bf16 x bf16
// product is exact in fp32), the epilogues run on the fp32 accumulator,
// and the output rounds once, to nearest even, to the operand dtype.
// The epilogues use __fmul_rn / __fadd_rn so that the compiler cannot
// contract them into FMAs: they round exactly where the plain PyTorch
// versions (kernels/ref.py) round.
//
// Each source is built on its own into a shared library with a plain C
// interface (kernels/_build.py); a launcher returns cudaGetLastError()
// right after the launch and the Python wrapper raises on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace prism {

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
};

}  // namespace prism

extern "C" const char* prism_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
