// K3: single-query cross-attention over a packed decode cache, for one
// greedy-decode step: scores over the cache, masked softmax (-1e9), p@V.
//
// Replaces the TPU kernel `_kernel` of rag_docvqa_tpu/ops/decode_attention.py
// (called from `fused_cross_attention`). The layouts are `pack_decode_kv`'s:
// K2 (B, H*dk, Te) and V2 (B, Te, H*dk), stored int8, bf16 or f32. The
// channel scales fold outside the kernel, as in JAX: the k-scale into the
// query (the wrapper passes q * k_scale in f32), the v-scale into the output.
// int8 and bf16 values are widened to f32 in registers and all math is f32,
// which is the TPU kernel's `exact=True` mode.
//
// What bounds it on the H100: memory. Each step reads the whole cross cache,
// 2*B*H*dk*Te elements per layer (at t5-base B 32, Te 512: 50 MB in bf16,
// 25 MB in int8), for 4 FLOPs per element. Design: one block of 128 threads
// per (head, batch row). Scores: thread t reads K2 rows h*dk..h*dk+dk-1 at
// columns t, t+128, ... -- neighbouring threads on neighbouring addresses --
// and keeps them in shared memory (Te floats). Then a block max and sum,
// and p@V with 128/dk groups of dk threads, each group over a strided share
// of Te reading contiguous dk-wide rows of V2, reduced through shared memory.
#include "common.cuh"

namespace {

constexpr int NT = 128;
constexpr float MASKED = -1e9f;

template <typename KT>
__global__ void __launch_bounds__(NT) decode_attn_kernel(
    const float* __restrict__ qs, const KT* __restrict__ k2, const KT* __restrict__ v2,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int H, int dk, int Te) {
  extern __shared__ float smem[];
  float* s = smem;           // [Te] scores, then probabilities
  float* qv = s + Te;        // [dk]
  float* part = qv + dk;     // [NT] p@V partial sums
  __shared__ float scratch[32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int hd = H * dk;

  for (int d = tid; d < dk; d += NT) qv[d] = qs[((long long)b * H + h) * dk + d];
  __syncthreads();

  const KT* kb = k2 + (long long)b * hd * Te + (long long)h * dk * Te;
  const uint8_t* mb = mask + (long long)b * Te;
  float lmax = -3.402823466e38f;
  for (int t = tid; t < Te; t += NT) {
    float acc = 0.f;
    for (int d = 0; d < dk; ++d) acc += qv[d] * to_f(kb[(long long)d * Te + t]);
    acc = mb[t] ? acc : MASKED;
    s[t] = acc;
    lmax = fmaxf(lmax, acc);
  }
  const float mx = block_reduce<true>(lmax, scratch);
  float lsum = 0.f;
  for (int t = tid; t < Te; t += NT) {
    const float e = expf(s[t] - mx);
    s[t] = e;
    lsum += e;
  }
  const float sum = block_reduce<false>(lsum, scratch);
  for (int t = tid; t < Te; t += NT) s[t] /= sum;
  __syncthreads();

  const int ngroups = NT / dk;  // dk <= NT, checked by the entry point
  const int d = tid % dk, g = tid / dk;
  float acc = 0.f;
  if (g < ngroups) {
    const KT* vb = v2 + (long long)b * Te * hd + (long long)h * dk + d;
    for (int t = g; t < Te; t += ngroups) acc += s[t] * to_f(vb[(long long)t * hd]);
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < dk) {
    float o = 0.f;
    for (int gg = 0; gg < ngroups; ++gg) o += part[gg * dk + tid];
    out[(long long)b * hd + (long long)h * dk + tid] = o;
  }
}

template <typename KT>
cudaError_t launch(const void* qs, const void* k2, const void* v2, const void* mask, void* out,
                   int B, int H, int dk, int Te, cudaStream_t stream) {
  const int smem = (Te + dk + NT) * (int)sizeof(float);
  auto kern = decode_attn_kernel<KT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const float*>(qs), static_cast<const KT*>(k2), static_cast<const KT*>(v2),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, dk, Te);
  return cudaGetLastError();
}

}  // namespace

// qs (B, H, dk) f32 (query times k-scale); k2 (B, H*dk, Te), v2 (B, Te, H*dk)
// in `kv_dtype`; mask (B, Te) uint8; out (B, H*dk) f32 before the v-scale.
extern "C" int decode_cross_attention(const void* qs, const void* k2, const void* v2,
                                      const void* mask, void* out, int B, int H, int dk,
                                      int Te, int kv_dtype, void* stream) {
  if (dk <= 0 || dk > NT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == DT_F32) return (int)launch<float>(qs, k2, v2, mask, out, B, H, dk, Te, s);
  if (kv_dtype == DT_BF16) return (int)launch<__nv_bfloat16>(qs, k2, v2, mask, out, B, H, dk, Te, s);
  if (kv_dtype == DT_I8) return (int)launch<int8_t>(qs, k2, v2, mask, out, B, H, dk, Te, s);
  return (int)cudaErrorInvalidValue;
}
