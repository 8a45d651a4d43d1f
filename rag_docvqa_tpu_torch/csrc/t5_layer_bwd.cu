// K7 and K8, the T5 encoder layer backward, split where the TPU kernels
// split it: at x1 = x + attn(rms(x)). Their products and reductions are
// built here; the attention part of K8 is K6 (flash_bwd.cu) and its
// recompute K1 (t5_layer.cu) and K2 (flash_fwd.cu). ops/fused_encoder.py
// composes them:
//
//   K7, FFN + LN1 backward, from the saved x1 and the cotangent g at out:
//     h2 = rms(x1, ln1)                                   t5_rms_norm
//     df = cast(g . Wof)                                  gemm NN, store
//     relu: pre = h2 . Wi^T -> dpre = cast(pre > 0 ? df : 0), f = cast(relu(pre))
//                                                         gemm NT, relu_bwd
//     gated: u = cast(h2 . Wi1^T) (t5_gemm), gl = h2 . Wi0^T ->
//            f, du, dgl with the cast points of gelu_bwd below
//                                                         gemm NT, gelu_bwd
//     dWi = dpre^T . h2, dWof = g^T . f  (f32)            gemm TN
//     dh2 = dpre . Wi  (f32; gated: dgl . Wi0 + du . Wi1) gemm NN, f32 (+=)
//     dx1 = cast(g + rms_bwd(dh2)), dln1 = sum_rows(dh2 * n)   t5_rms_bwd
//
//   K8, attention + LN0 backward, from the saved x and the cotangent dy at x1:
//     h = rms(x, ln0); qkv = cast(h . Wqkv^T); a, lse = K2   (recompute)
//     dWo = dy^T . a (f32); da = cast(dy . Wo)            gemm TN, NN
//     dq, dk, dv, dbias = K6(q, k, v, a, lse, da)
//     dWqkv = dqkv^T . h (f32); dh = dqkv . Wqkv (f32)    gemm TN, NN
//     dx = cast(dy + rms_bwd(dh)), dln0 = sum_rows(dh * n)     t5_rms_bwd
//
// Replaces the TPU kernels `_ffn_bwd_kernel` (K7) and `_attn_bwd_kernel` /
// `_attn_bwd_kernel_nobias` (K8) of rag_docvqa_tpu/ops/fused_encoder_bwd.py,
// called from `_t5_ffn_bwd_impl` and `_t5_attn_bwd_impl`. Those keep a
// whole half-layer for a block of rows in VMEM and accumulate the weight
// gradients in resident f32 blocks across the sequential grid. Here every
// weight gradient is one GEMM that contracts over all B*T rows inside each
// output tile (A^T.B, no split over rows), and the norm weight's gradient is
// summed over rows in two passes of fixed order: deterministic, no atomics.
// Weights are in the port's (out, in) layout: the forward is x . W^T, so
// dX = dY . W and dW = dY^T . X.
//
// What bounds it on the H100: the GEMMs by operations, as in the forward: at
// t5-base B 8 T 512 a layer's backward is ~2x its forward's products (each
// product's bound ~0.02 ms). The bf16 GEMM is gemm_bwd.cuh's wgmma template
// (SIMT for f32), shared with the BERT layer backward; on the H100 (700 W,
// chip_smoke.py phase 6b, device time) dWi 3072x768 over 4096 rows takes 0.06
// ms and dh2 0.045 ms, 1.7-2x behind torch.matmul's bare product, and the
// relu_bwd product ~0.09 ms, where the epilogue's aux read and two outputs
// are not overlapped with the tensor cores. K7 is then ~0.44 ms and K8 ~2.4,
// of which K6 is 2.0. The norm backward is bound by memory.
#include "gemm_bwd.cuh"

namespace {

// ---- RMSNorm backward -------------------------------------------------------
// dx = rstd * dn - x * rstd^3 * sum(dn * x) / d with dn = dh * w, written as
// cast(resid + dx); each block also sums dh * n (n = x * rstd) over its rows
// into one row of dw_part. (fused_encoder_bwd.py::_rms_bwd)
constexpr int RMS_ROWS = 32;  // rows per block
constexpr int RMS_MAX_COLS = 16;  // per thread: d <= 16 * 256

template <typename T, typename WT>
__global__ void __launch_bounds__(256) rms_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dh, const WT* __restrict__ w,
    const T* __restrict__ resid, T* __restrict__ dx, float* __restrict__ dw_part, int rows, int d,
    float eps) {
  __shared__ float scratch[32];
  float dw[RMS_MAX_COLS];
#pragma unroll
  for (int j = 0; j < RMS_MAX_COLS; ++j) dw[j] = 0.f;
  const int r0 = (int)blockIdx.x * RMS_ROWS, r_end = min(rows, r0 + RMS_ROWS);
  for (int row = r0; row < r_end; ++row) {
    const T* xr = x + (long long)row * d;
    const float* gr = dh + (long long)row * d;
    float ss = 0.f, sdx = 0.f;
    for (int i = threadIdx.x; i < d; i += 256) {
      const float xv = to_f(xr[i]);
      ss += xv * xv;
      sdx += gr[i] * to_f(w[i]) * xv;
    }
    ss = block_reduce<false>(ss, scratch);
    sdx = block_reduce<false>(sdx, scratch);
    const float rstd = rsqrtf(ss / d + eps);
    const float coef = rstd * rstd * rstd * (sdx * (1.f / d));
    const T* rr = resid + (long long)row * d;
    T* out = dx + (long long)row * d;
#pragma unroll
    for (int j = 0; j < RMS_MAX_COLS; ++j) {
      const int i = threadIdx.x + 256 * j;
      if (i < d) {
        const float xv = to_f(xr[i]), g = gr[i];
        dw[j] += g * (xv * rstd);
        out[i] = from_f<T>(to_f(rr[i]) + (rstd * (g * to_f(w[i])) - xv * coef));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RMS_MAX_COLS; ++j) {
    const int i = threadIdx.x + 256 * j;
    if (i < d) dw_part[(long long)blockIdx.x * d + i] = dw[j];
  }
}

}  // namespace

// C (M, N) = epilogue(A . B) in `layout` (see Layout) for the pairs
// (NT, relu_bwd), (NT, gelu_bwd), (NN, store), (NN, store_f32),
// (NN, acc_f32), (TN, store_f32); a and b in `dtype`, contiguous. out0..2
// and aux0..1 are (M, N) row-major in `dtype`, or f32 for the _f32
// epilogues; unused ones are null. With `splits` > 1 the (TN, store_f32)
// product is cut over its rows into that many ranges through `scratch`
// (splits, M, N) f32 (gemm_bwd.cuh says why). Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for any other pair.
extern "C" int t5_gemm_bwd(const void* a, const void* b, void* out0, void* out1, void* out2,
                           const void* aux0, const void* aux1, int M, int N, int K, int layout,
                           int dtype, int epi, void* scratch, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiPtrs e{out0, out1, out2, aux0, aux1};
  cudaError_t err = cudaErrorInvalidValue;
  if (layout == L_NT && epi == E_RELU_BWD) err = gemm_bwd<L_NT, E_RELU_BWD>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NT && epi == E_GELU_BWD) err = gemm_bwd<L_NT, E_GELU_BWD>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_STORE) err = gemm_bwd<L_NN, E_STORE>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_STORE_F32) err = gemm_bwd<L_NN, E_STORE_F32>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_ACC_F32) err = gemm_bwd<L_NN, E_ACC_F32>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_TN && epi == E_STORE_F32)
    err = gemm_bwd_tn_split(dtype, a, b, out0, scratch, M, N, K, splits, s);
  return (int)err;
}

// x, resid, dx (rows, d) in `dtype`; dh (rows, d) f32; w (d,) in `w_dtype`;
// dw (d,) f32; dw_part (ceil(rows / 32), d) f32 scratch. d <= 4096.
extern "C" int t5_rms_bwd(const void* x, const void* dh, const void* w, const void* resid, void* dx,
                          void* dw, void* dw_part, int rows, int d, float eps, int dtype, int w_dtype,
                          void* stream) {
  if (d > RMS_MAX_COLS * 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + RMS_ROWS - 1) / RMS_ROWS;
#define RMS_BWD(T, WT)                                                                      \
  rms_bwd_kernel<T, WT><<<blocks, 256, 0, s>>>(                                            \
      static_cast<const T*>(x), static_cast<const float*>(dh), static_cast<const WT*>(w), \
      static_cast<const T*>(resid), static_cast<T*>(dx), static_cast<float*>(dw_part), rows, d, eps)
  if (dtype == DT_F32 && w_dtype == DT_F32) RMS_BWD(float, float);
  else if (dtype == DT_F32 && w_dtype == DT_BF16) RMS_BWD(float, __nv_bfloat16);
  else if (dtype == DT_BF16 && w_dtype == DT_F32) RMS_BWD(__nv_bfloat16, float);
  else if (dtype == DT_BF16 && w_dtype == DT_BF16) RMS_BWD(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef RMS_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sum_kernel<<<(d + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dw_part),
                                                    static_cast<float*>(dw), blocks, d);
  return (int)cudaGetLastError();
}
