// K9: the parts of one post-LN BERT encoder layer that are not attention:
// the GEMM with a bias in its epilogue and a row LayerNorm. With K2
// (flash_fwd.cu) for the attention they make the whole layer
// (ops/fused_encoder.py::fused_bert_layer_parts):
//
//   qkv = cast(x @ Wqkv^T + bqkv)                     gemm, epilogue bias
//   a   = attention(q, k, v, mask), scale dh^-0.5     flash_fwd, mask_value -1e30
//   y1  = x + (a @ Wo^T + bo)          in f32         gemm, epilogue bias_residual_f32
//   x1  = cast(LN(y1, ln1))                           layer_norm
//   h   = cast(gelu_erf(x1 @ W1^T + b1))              gemm, epilogue bias_gelu
//   y2  = x1 + (h @ W2^T + b2)         in f32         gemm, epilogue bias_residual_f32
//   out = cast(LN(y2, ln2))                           layer_norm
//
// Replaces the TPU kernel `_layer_kernel` of rag_docvqa_tpu/ops/fused_encoder.py,
// called from `_layer_call`. That kernel keeps a whole layer for a block of
// sequences in VMEM; a Hopper block has 227 KB of shared memory, so the layer
// is split at the products. The cast points are the TPU kernel's: the sums
// that feed a LayerNorm stay in f32 (the GEMM writes them as f32), the GELU
// runs on the f32 pre-activation, and erf is the same rational polynomial
// (common.cuh::erf32). save_x1 costs nothing here: x1 is a tensor of its own.
//
// What bounds it on the H100: at bge-small (d 384, d_ff 1536, B 1024, T 64)
// a layer is ~0.23 TFLOP of products over ~0.9 GB of activations that the
// split moves through device memory, so the products and the traffic are of
// one order; the GEMM is gemm_fwd.cuh's template (bf16: wgmma.mma_async from a
// cp.async ring, two blocks an SM so the erf-GELU epilogue of one runs under
// the products of the other; f32: SIMT, exact). The
// LayerNorm reads an f32 row three times (mean, variance, output; the second
// and third from cache) and is bound by memory.
#include "gemm_fwd.cuh"

namespace {

// ---- row LayerNorm: out = cast((y - mean) * rsqrt(var + eps) * w + b) -------
// one warp per row; mean and variance in two passes, as the TPU kernel's _ln
constexpr int LN_WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32) layer_norm_kernel(
    const float* __restrict__ y, const T* __restrict__ ln, T* __restrict__ out, int rows, int d,
    float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* yr = y + row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += yr[i];
  const float mean = warp_sum(s) / d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = yr[i] - mean;
    v += c * c;
  }
  const float rstd = rsqrtf(warp_sum(v) / d + eps);
  T* orow = out + row * d;
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f<T>((yr[i] - mean) * rstd * to_f(ln[i]) + to_f(ln[d + i]));
}

}  // namespace

// C (M, N) = epilogue(A (M, K) @ W (N, K)^T) with bias (N,): epi 4 (bias),
// 5 (bias_gelu), 6 (bias_residual_f32, aux (M, N), C f32); a, w, aux and bias
// contiguous in `dtype`.
extern "C" int bert_gemm(const void* a, const void* w, void* c, const void* aux, const void* bias,
                         int M, int N, int K, int dtype, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (epi) {
    case EPI_BIAS: err = gemm_fwd<EPI_BIAS>(dtype, a, w, c, aux, bias, M, N, K, s); break;
    case EPI_BIAS_GELU: err = gemm_fwd<EPI_BIAS_GELU>(dtype, a, w, c, aux, bias, M, N, K, s); break;
    case EPI_BIAS_RESIDUAL_F32:
      err = gemm_fwd<EPI_BIAS_RESIDUAL_F32>(dtype, a, w, c, aux, bias, M, N, K, s);
      break;
    default: break;
  }
  return (int)err;
}

// y (rows, d) f32; ln (2, d) = [scale; bias] and out (rows, d) in `dtype`.
extern "C" int bert_layer_norm(const void* y, const void* ln, void* out, int rows, int d, float eps,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  if (dtype == DT_F32)
    layer_norm_kernel<float><<<blocks, LN_WARPS * 32, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(ln), static_cast<float*>(out), rows, d, eps);
  else if (dtype == DT_BF16)
    layer_norm_kernel<__nv_bfloat16><<<blocks, LN_WARPS * 32, 0, s>>>(
        static_cast<const float*>(y), static_cast<const __nv_bfloat16*>(ln),
        static_cast<__nv_bfloat16*>(out), rows, d, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
