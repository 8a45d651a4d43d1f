// K1: the parts of one pre-RMS T5 encoder layer that are not attention: a
// row RMSNorm and a tiled GEMM with an epilogue. With K2 (flash_fwd.cu) for
// the attention they make the whole layer (ops/fused_encoder.py):
//
//   h  = rms(x, ln0)                         rms_norm, written in the compute dtype
//   qkv = h @ Wqkv                           gemm, epilogue none
//   a  = attention(q, k, v, bias, mask)      flash_fwd, mask_value -1e9
//   x1 = x + cast(a @ Wo)                    gemm, epilogue residual
//   h2 = rms(x1, ln1)                        rms_norm
//   f  = cast(relu(h2 @ Wi))                 gemm, epilogue relu
//      | cast(gelu_tanh(cast(h2 @ Wi0))) * cast(h2 @ Wi1)   gemm none, gemm gelu_mul
//   out = x1 + cast(f @ Wof)                 gemm, epilogue residual
//
// Replaces the TPU kernel `_t5_layer_kernel` (and `_t5_layer_kernel_nobias`)
// of rag_docvqa_tpu/ops/fused_encoder.py, called from `_t5_layer_call`. That
// kernel keeps a whole layer for a block of rows in 52 MB of VMEM; a Hopper
// block has 227 KB of shared memory, so the layer is split at the products.
// The cast points are the TPU kernel's: every product is cast to the compute
// dtype before the residual add or the gelu.
//
// What bounds it on the H100: the GEMMs. At t5-base, B 32, T 512 a layer is
// ~232 GFLOP of products over ~60 MB of activations and weights, far above
// the ridge point, so the tensor-core rate is the limit. The GEMM template
// is gemm_fwd.cuh's (WMMA bf16, SIMT f32), shared with the BERT layer. The
// RMSNorm is one block per row, bound by memory.
#include "gemm_fwd.cuh"

namespace {

// ---- row RMSNorm -----------------------------------------------------------
template <typename T, typename WT>
__global__ void rms_norm_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                                T* __restrict__ out, int d, float eps) {
  __shared__ float scratch[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  ss = block_reduce<false>(ss, scratch);
  const float inv = rsqrtf(ss / d + eps);
  T* orow = out + row * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_f<T>(to_f(xr[i]) * inv * to_f(w[i]));
}

}  // namespace

// x (rows, d) and out (rows, d) in `dtype`; w (d,) in `w_dtype`.
extern "C" int t5_rms_norm(const void* x, const void* w, void* out, int rows, int d,
                           float eps, int dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
#define RMS(T, WT)                                                                     \
  rms_norm_kernel<T, WT><<<rows, threads, 0, s>>>(static_cast<const T*>(x),           \
                                                  static_cast<const WT*>(w),          \
                                                  static_cast<T*>(out), d, eps)
  if (dtype == DT_F32 && w_dtype == DT_F32) RMS(float, float);
  else if (dtype == DT_F32 && w_dtype == DT_BF16) RMS(float, __nv_bfloat16);
  else if (dtype == DT_BF16 && w_dtype == DT_F32) RMS(__nv_bfloat16, float);
  else if (dtype == DT_BF16 && w_dtype == DT_BF16) RMS(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef RMS
  return (int)cudaGetLastError();
}

// C (M, N) = epilogue(A (M, K) @ W (N, K)^T); all contiguous, one dtype;
// aux (M, N) for the residual and gelu_mul epilogues, else null.
extern "C" int t5_gemm(const void* a, const void* w, void* c, const void* aux, int M, int N,
                       int K, int dtype, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (epi) {
    case EPI_NONE: err = gemm_fwd<EPI_NONE>(dtype, a, w, c, aux, nullptr, M, N, K, s); break;
    case EPI_RELU: err = gemm_fwd<EPI_RELU>(dtype, a, w, c, aux, nullptr, M, N, K, s); break;
    case EPI_RESIDUAL: err = gemm_fwd<EPI_RESIDUAL>(dtype, a, w, c, aux, nullptr, M, N, K, s); break;
    case EPI_GELU_MUL: err = gemm_fwd<EPI_GELU_MUL>(dtype, a, w, c, aux, nullptr, M, N, K, s); break;
    default: break;
  }
  return (int)err;
}
