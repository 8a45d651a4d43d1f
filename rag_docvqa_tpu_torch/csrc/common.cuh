// Shared helpers for the port's kernels: element loads and stores through
// float, and the dtype codes the Python wrappers pass (see kernels.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, kept in step with kernels.DTYPE_CODES
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T and read back: where the JAX code casts a value to the
// compute dtype and keeps computing
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// float32 erf in Eigen's rational form, the polynomial XLA lowers erf to and
// the TPU BERT kernels spell out (rag_docvqa_tpu/ops/fused_encoder.py::_erf32;
// ops/fused_encoder.py::_erf32 is the plain version): x clipped to +-4, then
// x * P(x^2) / Q(x^2). CUDA's erff differs from it in the last bits.
__device__ __forceinline__ float erf32(float x) {
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = x * x;
  float p = -2.72614225801306e-10f;
  p = p * x2 + 2.77068142495902e-08f;
  p = p * x2 + -2.10102402082508e-06f;
  p = p * x2 + -5.69250639462346e-05f;
  p = p * x2 + -7.34990630326855e-04f;
  p = p * x2 + -2.95459980854025e-03f;
  p = p * x2 + -1.60960333262415e-02f;
  p = p * x;
  float q = -1.45660718464996e-05f;
  q = q * x2 + -2.13374055278905e-04f;
  q = q * x2 + -1.68282697438203e-03f;
  q = q * x2 + -7.37332916720468e-03f;
  q = q * x2 + -1.42647390514189e-02f;
  return p / q;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide reduction through `scratch` (>= 32 floats); every thread gets
// the result. blockDim.x must be a multiple of 32.
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : (MAX ? -3.402823466e38f : 0.f);
  v = MAX ? warp_max(v) : warp_sum(v);
  return v;
}
