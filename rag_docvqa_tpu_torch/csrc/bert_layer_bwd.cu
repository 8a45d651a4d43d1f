// K10: the BERT encoder layer backward, split where the TPU kernels split
// it: at x1 = LN1(x + attn(x)), the activation the train forward saves. The
// products, the LayerNorm backward and the bias sums are built here; the
// attention part is K6 (flash_bwd.cu) and the recompute K9 (bert_layer.cu)
// and K2 (flash_fwd.cu). ops/fused_encoder.py composes them:
//
//   bert_ffn_bwd, FFN + LN2 backward, from the saved x1 and the cotangent g at out:
//     h1 = x1 . W1^T + b1 (f32) -> ge = cast(gelu(h1)), dge = gelu'(h1) (f32)
//                                                        gemm NT, bias_gelu_grad
//     y2 = x1 + (ge . W2^T + b2) (f32)                   bert_gemm, bias_residual_f32
//     dy2 (f32), cast(dy2), dln2, db2 = sum_rows(dy2)    bert_ln_bwd
//     dW2 = cast(dy2)^T . ge (f32)                       gemm TN
//     dpre32 = (cast(dy2) . W2) * dge (f32), dpre = cast(dpre32)   gemm NN, mul_f32
//     db1 = sum_rows(dpre32)                             bert_col_sum
//     dW1 = dpre^T . x1 (f32)                            gemm TN
//     dx1 = cast(dy2 + dpre . W1)                        gemm NN, add_f32_store
//
//   bert_attn_bwd, attention + LN1 backward, from the saved x and the cotangent dy at x1:
//     qkv = cast(x . Wqkv^T + bqkv); a, lse = K2; y1 = x + (a . Wo^T + bo)   (recompute)
//     dy1 (f32), dao = cast(dy1), dln1, dbo = sum_rows(dy1)   bert_ln_bwd
//     dWo = dao^T . a (f32); da = cast(dao . Wo)         gemm TN, NN
//     dq, dk, dv = K6(q, k, v, a, lse, da)  -> dqkv
//     dWqkv = dqkv^T . x (f32); dbqkv = sum_rows(dqkv)   gemm TN, bert_col_sum
//     dx = cast(dy1 + dqkv . Wqkv)                       gemm NN, add_f32_store
//
// Replaces the TPU kernels `_bert_ffn_bwd_kernel` and `_bert_attn_bwd_kernel`
// of rag_docvqa_tpu/ops/fused_encoder_bwd.py, called from `_bert_ffn_bwd_impl`
// and `_bert_attn_bwd_impl`. Those keep a half-layer for a block of
// sequences in VMEM and accumulate every weight and bias gradient in resident
// f32 blocks across the sequential grid. Here a weight gradient is one GEMM
// over all B*T rows and a bias or LayerNorm gradient is summed over rows in
// two passes of fixed order: deterministic, no float atomics. Weights are in
// the port's (out, in) layout: forward x . W^T, so dX = dY . W, dW = dY^T . X.
//
// What bounds it on the H100: the GEMMs (gemm_bwd.cuh's template), about 2x
// the forward's products; the LayerNorm backward and the column sums are
// bound by memory.
#include "gemm_bwd.cuh"

namespace {

// ---- LayerNorm backward -----------------------------------------------------
// For out = n * w + b with n = (y - mean) * rstd and the cotangent g at out:
//   dn = g * w;  dy = rstd * (dn - mean(dn) - n * mean(dn * n))
// written as f32 and in the compute dtype; each block also sums g * n, g and
// dy over its rows into one row of `part` (3, d). (fused_encoder_bwd.py::_ln_bwd)
constexpr int LNB_ROWS = 32;       // rows per block
constexpr int LNB_MAX_COLS = 16;   // per thread: d <= 16 * 256

template <typename T>
__global__ void __launch_bounds__(256) ln_bwd_kernel(
    const float* __restrict__ y, const T* __restrict__ g, const T* __restrict__ ln,
    float* __restrict__ dy32, T* __restrict__ dyc, float* __restrict__ part, int rows, int d,
    float eps) {
  __shared__ float scratch[32];
  float dw[LNB_MAX_COLS], db[LNB_MAX_COLS], dc[LNB_MAX_COLS];
#pragma unroll
  for (int j = 0; j < LNB_MAX_COLS; ++j) dw[j] = db[j] = dc[j] = 0.f;
  const int r0 = (int)blockIdx.x * LNB_ROWS, r_end = min(rows, r0 + LNB_ROWS);
  for (int row = r0; row < r_end; ++row) {
    const float* yr = y + (long long)row * d;
    const T* gr = g + (long long)row * d;
    float s = 0.f;
    for (int i = threadIdx.x; i < d; i += 256) s += yr[i];
    const float mean = block_reduce<false>(s, scratch) / d;
    float v = 0.f;
    for (int i = threadIdx.x; i < d; i += 256) {
      const float c = yr[i] - mean;
      v += c * c;
    }
    const float rstd = rsqrtf(block_reduce<false>(v, scratch) / d + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < d; i += 256) {
      const float dn = to_f(gr[i]) * to_f(ln[i]);
      s1 += dn;
      s2 += dn * ((yr[i] - mean) * rstd);
    }
    const float m1 = block_reduce<false>(s1, scratch) / d;
    const float m2 = block_reduce<false>(s2, scratch) / d;
    float* o32 = dy32 + (long long)row * d;
    T* oc = dyc + (long long)row * d;
#pragma unroll
    for (int j = 0; j < LNB_MAX_COLS; ++j) {
      const int i = threadIdx.x + 256 * j;
      if (i < d) {
        const float gv = to_f(gr[i]), n = (yr[i] - mean) * rstd;
        const float dyv = rstd * (gv * to_f(ln[i]) - m1 - n * m2);
        dw[j] += gv * n;
        db[j] += gv;
        dc[j] += dyv;
        o32[i] = dyv;
        oc[i] = from_f<T>(dyv);
      }
    }
  }
  float* p = part + (long long)blockIdx.x * 3 * d;
#pragma unroll
  for (int j = 0; j < LNB_MAX_COLS; ++j) {
    const int i = threadIdx.x + 256 * j;
    if (i < d) {
      p[i] = dw[j];
      p[d + i] = db[j];
      p[2 * d + i] = dc[j];
    }
  }
}

// ---- column sums over rows ---------------------------------------------------
// part[c, j] = sum of x[r, j] over the rows of chunk c, in row order
constexpr int CS_ROWS = 64;

template <typename T>
__global__ void col_sum_part_kernel(const T* __restrict__ x, float* __restrict__ part, int rows, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int r0 = (int)blockIdx.y * CS_ROWS, r_end = min(rows, r0 + CS_ROWS);
  float acc = 0.f;
  for (int r = r0; r < r_end; ++r) acc += to_f(x[(long long)r * n + j]);
  part[(long long)blockIdx.y * n + j] = acc;
}

}  // namespace

// C (M, N) = epilogue(A . B) in `layout` for the pairs (NT, bias_gelu_grad:
// aux0 = bias (N,), out0 in `dtype`, out1 f32), (NN, mul_f32: aux0 (M, N) f32,
// out0 f32, out1 in `dtype`), (NN, add_f32_store: aux0 (M, N) f32, out0 in
// `dtype`); a and b in `dtype`, contiguous. Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for any other pair.
extern "C" int bert_gemm_bwd(const void* a, const void* b, void* out0, void* out1, const void* aux0,
                             int M, int N, int K, int layout, int dtype, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiPtrs e{out0, out1, nullptr, aux0, nullptr};
  cudaError_t err = cudaErrorInvalidValue;
  if (layout == L_NT && epi == E_BIAS_GELU_GRAD)
    err = gemm_bwd<L_NT, E_BIAS_GELU_GRAD>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_MUL_F32)
    err = gemm_bwd<L_NN, E_MUL_F32>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_ADD_F32_STORE)
    err = gemm_bwd<L_NN, E_ADD_F32_STORE>(dtype, a, b, e, M, N, K, s);
  return (int)err;
}

// y (rows, d) f32, the sum the LayerNorm read; g (rows, d) and ln (2, d) in
// `dtype`; dy32 (rows, d) f32 and dyc (rows, d) in `dtype`; sums (3, d) f32 =
// [dscale; dbias; sum_rows(dy)]; part (ceil(rows / 32), 3, d) f32 scratch.
// d <= 4096.
extern "C" int bert_ln_bwd(const void* y, const void* g, const void* ln, void* dy32, void* dyc,
                           void* sums, void* part, int rows, int d, float eps, int dtype,
                           void* stream) {
  if (d > LNB_MAX_COLS * 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + LNB_ROWS - 1) / LNB_ROWS;
  if (dtype == DT_F32)
    ln_bwd_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(g), static_cast<const float*>(ln),
        static_cast<float*>(dy32), static_cast<float*>(dyc), static_cast<float*>(part), rows, d, eps);
  else if (dtype == DT_BF16)
    ln_bwd_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(y), static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(ln), static_cast<float*>(dy32),
        static_cast<__nv_bfloat16*>(dyc), static_cast<float*>(part), rows, d, eps);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sum_kernel<<<(3 * d + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                        static_cast<float*>(sums), blocks, 3 * d);
  return (int)cudaGetLastError();
}

// out (n,) f32 = sum over rows of x (rows, n) in `dtype` (DT_F32 or DT_BF16),
// in two passes of fixed order; part (ceil(rows / 64), n) f32 scratch.
extern "C" int bert_col_sum(const void* x, void* out, void* part, int rows, int n, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (rows + CS_ROWS - 1) / CS_ROWS;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  dim3 grid((n + 255) / 256, chunks);
  if (dtype == DT_F32)
    col_sum_part_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                                     static_cast<float*>(part), rows, n);
  else if (dtype == DT_BF16)
    col_sum_part_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                             static_cast<float*>(part), rows, n);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                    static_cast<float*>(out), chunks, n);
  return (int)cudaGetLastError();
}
