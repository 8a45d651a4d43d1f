// K14: one pre-LN ViT / BEiT encoder layer
// (ops/fused_encoder.py::fused_vit_layer_parts):
//
//   h   = cast(LN(x, ln1))                                vit_layer_norm
//   qkv = cast(h @ Wqkv^T + bqkv)                          vit_gemm, epilogue bias
//   a   = softmax(q k^T dh^-0.5 [+ bias_h], keys masked    vit_attention
//         at -1e30), normalised, cast, then @ v, cast
//   x1  = x + cast(cast(a @ Wo^T + bo) [* g1])             vit_gemm, epilogue bias_scale_residual
//   h2  = cast(LN(x1, ln2))                                vit_layer_norm
//   f   = cast(gelu_erf(h2 @ W1^T + b1)), GELU in f32      vit_gemm, epilogue bias_gelu
//   out = x1 + cast(cast(f @ W2^T + b2) [* g2])            vit_gemm, epilogue bias_scale_residual
//
// Replaces the TPU kernel `_vit_layer_kernel` of
// rag_docvqa_tpu/ops/fused_encoder.py, called from `_vit_layer_call`. That
// kernel keeps a whole layer for a block of images in VMEM; a Hopper block
// has 227 KB of shared memory, so the layer is split at the products. The
// cast points are the TPU kernel's: the LayerNorm reads the compute dtype
// and does its statistics in f32; every residual branch is cast, scaled by
// the layer-scale row in the compute dtype and added to x in the compute
// dtype; the probabilities are divided by their sum in f32 and only then
// cast (which is why the attention is not K2: an online softmax rounds the
// probabilities before it knows their sum). A ViT sequence is short (197
// tokens at 224 px), so a block keeps the whole score row of its 32 queries
// in shared memory: one pass for the scores, an exact softmax, one pass for
// p @ v. A row with no valid key gives the uniform softmax, as on the TPU.
//
// What bounds it on the H100: the GEMMs. At ViT-base (d 768, mlp 3072, B 32,
// T 197) a layer is ~90 GFLOP of products and 3.8 GFLOP of attention over
// ~70 MB of activations and weights, far above the ridge point; the GEMM is
// gemm_fwd.cuh's template (bf16: wgmma.mma_async from a cp.async ring; f32:
// SIMT, exact) and the attention is SIMT, bound by shared-memory bandwidth as
// K2's f32 rows are. The LayerNorm is bound by memory.
#include "gemm_fwd.cuh"

namespace {

// ---- row LayerNorm over the compute dtype ----------------------------------
// one warp per row; mean and variance in two passes, as the TPU kernel's _ln
constexpr int LN_WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32) vit_layer_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ ln, T* __restrict__ out, int rows, int d,
    float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f(xr[i]);
  const float mean = warp_sum(s) / d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = to_f(xr[i]) - mean;
    v += c * c;
  }
  const float rstd = rsqrtf(warp_sum(v) / d + eps);
  T* orow = out + row * d;
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f<T>((to_f(xr[i]) - mean) * rstd * to_f(ln[i]) + to_f(ln[d + i]));
}

// ---- attention with the whole score row in shared memory --------------------
constexpr int BQ = 32;   // query rows per block
constexpr int BKT = 64;  // keys per staged tile
constexpr int NT = 128;  // threads per block, four per query row
constexpr float MASKED = -1e30f;

// shared floats: Q tile, one K or V tile, the score rows (stride Tk + 1)
template <int DH>
int attn_smem_floats(int Tk) { return BQ * (DH + 1) + BKT * (DH + 1) + BQ * (Tk + 1); }

template <typename T, int DH>
__global__ void __launch_bounds__(NT) vit_attention_kernel(
    const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ bias, T* __restrict__ out, int H, int Tn, int dh,
    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][DH + 1]
  float* KVs = Qs + BQ * (DH + 1);     // [BKT][DH + 1]
  float* Ss = KVs + BKT * (DH + 1);    // [BQ][Tn + 1]
  const int SLD = Tn + 1;

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int q0 = blockIdx.x * BQ, qrow = q0 + r;
  const int d = H * dh;
  const long long tok = 3LL * d;  // elements per token of qkv (B, Tn, 3, H, dh)
  const T* qb = qkv + (long long)b * Tn * tok + (long long)h * dh;
  const T* kb = qb + d;
  const T* vb = qb + 2 * d;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int rr = i / DH, c = i % DH, gq = q0 + rr;
    Qs[rr * (DH + 1) + c] = (gq < Tn && c < dh) ? to_f(qb[gq * tok + c]) : 0.f;
  }
  const __nv_bfloat16* brow =
      (bias != nullptr && qrow < Tn) ? bias + ((long long)h * Tn + qrow) * Tn : nullptr;
  const uint8_t* mrow = mask + (long long)b * Tn;

  // pass 1: the scores of every key
  constexpr int NC = BKT / 4;
  for (int k0 = 0; k0 < Tn; k0 += BKT) {
    __syncthreads();
    for (int i = tid; i < BKT * DH; i += NT) {
      const int c = i / DH, e = i % DH, gk = k0 + c;
      KVs[c * (DH + 1) + e] = (gk < Tn && e < dh) ? to_f(kb[gk * tok + e]) : 0.f;
    }
    __syncthreads();
    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
    for (int e = 0; e < DH; ++e) {
      const float qd = Qs[r * (DH + 1) + e];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] += qd * KVs[(sub + 4 * j) * (DH + 1) + e];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int gk = k0 + sub + 4 * j;
      if (gk >= Tn) continue;
      float x = s[j] * scale;
      if (brow != nullptr) x += to_f(brow[gk]);
      Ss[r * SLD + gk] = mrow[gk] != 0 ? x : MASKED;
    }
  }
  __syncwarp();  // a row's four threads sit in one warp

  // exact softmax over the row: max, sum, p / sum, then the cast
  float mx = -3.402823466e38f;
  for (int gk = sub; gk < Tn; gk += 4) mx = fmaxf(mx, Ss[r * SLD + gk]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.f;
  for (int gk = sub; gk < Tn; gk += 4) {
    const float p = expf(Ss[r * SLD + gk] - mx);
    Ss[r * SLD + gk] = p;
    sum += p;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  for (int gk = sub; gk < Tn; gk += 4) Ss[r * SLD + gk] = round_to<T>(Ss[r * SLD + gk] / sum);

  // pass 2: p @ v
  constexpr int ND = DH / 4;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < Tn; k0 += BKT) {
    __syncthreads();
    for (int i = tid; i < BKT * DH; i += NT) {
      const int c = i / DH, e = i % DH, gk = k0 + c;
      KVs[c * (DH + 1) + e] = (gk < Tn && e < dh) ? to_f(vb[gk * tok + e]) : 0.f;
    }
    __syncthreads();
    const int kn = min(BKT, Tn - k0);
    for (int c = 0; c < kn; ++c) {
      const float p = Ss[r * SLD + k0 + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] += p * KVs[c * (DH + 1) + sub + 4 * j];
    }
  }
  if (qrow < Tn) {
    T* orow = out + ((long long)b * Tn + qrow) * d + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int e = sub + 4 * j;
      if (e < dh) orow[e] = from_f<T>(acc[j]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_attention(const void* qkv, const void* mask, const void* bias, void* out, int B,
                             int H, int Tn, int dh, float scale, cudaStream_t s) {
  const int smem = attn_smem_floats<DH>(Tn) * (int)sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = vit_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((Tn + BQ - 1) / BQ, H, B), NT, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const __nv_bfloat16*>(bias), static_cast<T*>(out), H, Tn, dh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attention_dh(const void* qkv, const void* mask, const void* bias, void* out,
                                int B, int H, int Tn, int dh, float scale, cudaStream_t s) {
  if (dh <= 32) return launch_attention<T, 32>(qkv, mask, bias, out, B, H, Tn, dh, scale, s);
  if (dh <= 64) return launch_attention<T, 64>(qkv, mask, bias, out, B, H, Tn, dh, scale, s);
  if (dh <= 128) return launch_attention<T, 128>(qkv, mask, bias, out, B, H, Tn, dh, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (rows, d), ln (2, d) = [scale; bias] and out (rows, d), all in `dtype`.
extern "C" int vit_layer_norm(const void* x, const void* ln, void* out, int rows, int d, float eps,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  if (dtype == DT_F32)
    vit_layer_norm_kernel<float><<<blocks, LN_WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln), static_cast<float*>(out), rows, d, eps);
  else if (dtype == DT_BF16)
    vit_layer_norm_kernel<__nv_bfloat16><<<blocks, LN_WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ln),
        static_cast<__nv_bfloat16*>(out), rows, d, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// C (M, N) = epilogue(A (M, K) @ W (N, K)^T) with bias (N,): epi 4 (bias),
// 5 (bias_gelu), 7 (bias_scale_residual: aux (M, N) the residual, scale (N,)
// the layer-scale row or null); everything contiguous in `dtype`.
extern "C" int vit_gemm(const void* a, const void* w, void* c, const void* aux, const void* bias,
                        const void* scale, int M, int N, int K, int dtype, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (epi) {
    case EPI_BIAS: err = gemm_fwd<EPI_BIAS>(dtype, a, w, c, aux, bias, M, N, K, s); break;
    case EPI_BIAS_GELU: err = gemm_fwd<EPI_BIAS_GELU>(dtype, a, w, c, aux, bias, M, N, K, s); break;
    case EPI_BIAS_SCALE_RESIDUAL:
      err = gemm_fwd<EPI_BIAS_SCALE_RESIDUAL>(dtype, a, w, c, aux, bias, M, N, K, s, scale);
      break;
    default: break;
  }
  return (int)err;
}

// qkv (B, T, 3, H, dh) contiguous and out (B, T, H*dh) in `dtype`; mask
// (B, T) uint8, 1 = a real token; bias (H, T, T) bf16 shared by the batch, or
// null. Needs 32 score rows of T floats in shared memory: T up to ~1600.
extern "C" int vit_attention(const void* qkv, const void* mask, const void* bias, void* out, int B,
                             int H, int T, int dh, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)launch_attention_dh<float>(qkv, mask, bias, out, B, H, T, dh, scale, s);
  if (dtype == DT_BF16)
    return (int)launch_attention_dh<__nv_bfloat16>(qkv, mask, bias, out, B, H, T, dh, scale, s);
  return (int)cudaErrorInvalidValue;
}
