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
// is gemm_fwd.cuh's (bf16: wgmma.mma_async from a cp.async ring of swizzled
// tiles; f32: SIMT, exact), shared with the BERT and ViT layers. The RMSNorm
// is bound by memory (x read once, out written once): one warp a row, the row
// in registers through 16-byte loads, the sum by warp shuffles with no block
// barrier, several rows a block over a grid-stride loop.
#include "gemm_fwd.cuh"

namespace {

// ---- row RMSNorm: one warp a row -----------------------------------------
constexpr int RMS_WARPS = 8;  // warps (rows in flight) a block

// d a multiple of VW = 16 / sizeof(T) and at most NCH * 32 * VW: lane l holds
// the 16-byte chunks l, l + 32, ... of its row in registers, read once; the
// weight, widened to f32, is loaded once per warp into registers (up to 32
// values a lane) or once per block into shared memory (wider rows), and serves
// every row the warp takes in its grid-stride loop.
template <typename T, typename WT, int NCH>
__global__ void __launch_bounds__(RMS_WARPS * 32) rms_norm_vec_kernel(const T* __restrict__ x,
                                                                     const WT* __restrict__ w,
                                                                     T* __restrict__ out, int rows, int d,
                                                                     float eps) {
  constexpr int VW = Vec16<T>::N;
  constexpr bool W_REGS = NCH * VW <= 32;
  __shared__ float wsm[W_REGS ? 1 : NCH * 32 * VW];
  const int lane = threadIdx.x & 31;
  float wr[W_REGS ? NCH * VW : 1];
  if constexpr (W_REGS) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        const int e = (c * 32 + lane) * VW + i;
        wr[c * VW + i] = e < d ? to_f(w[e]) : 0.f;
      }
  } else {
    for (int e = threadIdx.x; e < d; e += blockDim.x) wsm[e] = to_f(w[e]);
    __syncthreads();
  }
  for (long long row = (long long)blockIdx.x * RMS_WARPS + (threadIdx.x >> 5); row < rows;
       row += (long long)gridDim.x * RMS_WARPS) {
    const uintptr_t xr = reinterpret_cast<uintptr_t>(x + row * d);
    uint4 v[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if ((c * 32 + lane) * VW < d) v[c] = ldg16(xr + (uintptr_t)(c * 32 + lane) * 16);
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if ((c * 32 + lane) * VW < d) {
        float f[VW];
        unpack16<T>(v[c], f);
#pragma unroll
        for (int i = 0; i < VW; ++i) ss = fmaf(f[i], f[i], ss);
      }
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / d + eps);
    T* orow = out + row * d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e0 = (c * 32 + lane) * VW;
      if (e0 < d) {
        float f[VW];
        unpack16<T>(v[c], f);
#pragma unroll
        for (int i = 0; i < VW; ++i) f[i] = f[i] * inv * (W_REGS ? wr[c * VW + i] : wsm[e0 + i]);
        *reinterpret_cast<uint4*>(orow + e0) = pack16(f, T());
      }
    }
  }
}

// any d: one warp a row, element by element, x read twice
template <typename T, typename WT>
__global__ void __launch_bounds__(RMS_WARPS * 32) rms_norm_any_kernel(const T* __restrict__ x,
                                                                     const WT* __restrict__ w,
                                                                     T* __restrict__ out, int rows, int d,
                                                                     float eps) {
  const int lane = threadIdx.x & 31;
  for (long long row = (long long)blockIdx.x * RMS_WARPS + (threadIdx.x >> 5); row < rows;
       row += (long long)gridDim.x * RMS_WARPS) {
    const T* xr = x + row * d;
    float ss = 0.f;
    for (int e = lane; e < d; e += 32) {
      const float f = to_f(xr[e]);
      ss = fmaf(f, f, ss);
    }
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / d + eps);
    T* orow = out + row * d;
    for (int e = lane; e < d; e += 32) orow[e] = from_f<T>(to_f(xr[e]) * inv * to_f(w[e]));
  }
}

template <typename T, typename WT>
cudaError_t rms_norm(const void* xp, const void* wp, void* op, int rows, int d, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const WT* w = static_cast<const WT*>(wp);
  T* out = static_cast<T*>(op);
  if (rows <= 0) return cudaSuccess;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 2048 threads an SM: blocks past that would only queue; each warp then loops over rows
  const long long need = ((long long)rows + RMS_WARPS - 1) / RMS_WARPS;
  const int blocks = (int)(need < (long long)sms * 8 ? need : (long long)sms * 8);
  constexpr int VW = Vec16<T>::N;
  const int nch = (d + 32 * VW - 1) / (32 * VW);
  const bool vec = d % VW == 0 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
#define RMS_VEC(N)                                                                                   \
  if (nch <= N) {                                                                                    \
    rms_norm_vec_kernel<T, WT, N><<<blocks, RMS_WARPS * 32, 0, s>>>(x, w, out, rows, d, eps);       \
    return cudaGetLastError();                                                                       \
  }
  if (vec) {
    RMS_VEC(1) RMS_VEC(2) RMS_VEC(3) RMS_VEC(4) RMS_VEC(6) RMS_VEC(8) RMS_VEC(12) RMS_VEC(16) RMS_VEC(32)
  }
#undef RMS_VEC
  rms_norm_any_kernel<T, WT><<<blocks, RMS_WARPS * 32, 0, s>>>(x, w, out, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x (rows, d) and out (rows, d) in `dtype`; w (d,) in `w_dtype`.
extern "C" int t5_rms_norm(const void* x, const void* w, void* out, int rows, int d,
                           float eps, int dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32 && w_dtype == DT_F32) return (int)rms_norm<float, float>(x, w, out, rows, d, eps, s);
  if (dtype == DT_F32 && w_dtype == DT_BF16) return (int)rms_norm<float, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  if (dtype == DT_BF16 && w_dtype == DT_F32) return (int)rms_norm<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  if (dtype == DT_BF16 && w_dtype == DT_BF16)
    return (int)rms_norm<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
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
