// K2: online-softmax attention forward (flash), with key mask, additive bias
// (batch-shared or per batch, f32 or bf16), causal, scale, GQA and the
// per-row log-sum-exp.
//
// Replaces the TPU kernels `_flash_kernel` / `_flash_kernel_single` (and
// their `_nobias` forms) of rag_docvqa_tpu/ops/flash_attention.py, called
// from `_fwd_call_impl` / `_fwd_call_single`. The same kernel, with
// mask_value = -1e9, is the attention part of the T5 layer (K1,
// t5_layer.cu), where the TPU kernel masks with -1e9 and so gives a uniform
// softmax on a row with no valid key; with mask_value = -1e30 such a row
// gives zeros and lse = -1e30, the flash contract.
//
// What bounds it on the H100: at t5-base (T 512, dh 64) attention is
// 4*B*H*T*T*dh FLOPs against B*H*T*dh*8 bytes of q/k/v/o, ~64 FLOP/byte in
// bf16, so it is bound by arithmetic, and this SIMT kernel by shared-memory
// bandwidth (about one shared load per FMA). The (H, T, T) bias is read
// from global memory for every batch row, never expanded per batch: at
// t5-base its 6 MB stay in the 50 MB L2.
//
// Design: one block per (32-query tile, head, batch row); 128 threads, four
// per query row. Key/value tiles of 64 rows are staged in shared memory as
// f32; each thread keeps 16 scores and dh/4 output columns in registers and
// the row's running max and sum are combined across its four threads with
// warp shuffles. Probabilities are rounded to the value dtype before p@v,
// as the TPU kernel does; accumulation is f32 throughout. Tensor cores,
// TMA and a pipelined tile ring are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BKT = 64;  // keys per tile
constexpr int NT = 128;  // threads per block, four per query row
constexpr float NEG_INF = -1e30f;
constexpr float EXCLUDED = -3.402823466e38f;  // key past Tk: never weighted

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BKT * (DH + 1) + BKT * DH + BQ * (BKT + 1);
}

template <typename T, typename BT, int DH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const BT* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ lse,
    int H, int Hkv, int Tq, int Tk, int dh,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, int bias_batched,
    float scale, int causal, float mask_value) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][DH + 1]
  float* Ks = Qs + BQ * (DH + 1);     // [BKT][DH + 1]
  float* Vs = Ks + BKT * (DH + 1);    // [BKT][DH]
  float* Ps = Vs + BKT * DH;          // [BQ][BKT + 1]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2;    // query row within the tile
  const int sub = tid & 3;   // this thread's slot among the row's four
  const int q0 = blockIdx.x * BQ;
  const int qrow = q0 + r;

  const T* qb = q + b * q_sb + (long long)h * dh;
  const T* kb = k + b * k_sb + (long long)hk * dh;
  const T* vb = v + b * v_sb + (long long)hk * dh;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int rr = i / DH, d = i % DH, gq = q0 + rr;
    Qs[rr * (DH + 1) + d] = (gq < Tq && d < dh) ? to_f(qb[gq * q_st + d]) : 0.f;
  }

  constexpr int NC = BKT / 4;  // scores per thread per tile
  constexpr int ND = DH / 4;   // output columns per thread
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;
  float m = EXCLUDED, l = 0.f;

  const BT* bias_row = nullptr;
  if (bias != nullptr && qrow < Tq)
    bias_row = bias + (((long long)(bias_batched ? b : 0) * H + h) * Tq + qrow) * Tk;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Tk : nullptr;

  // causal: tiles wholly above the diagonal of this query tile are skipped
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BKT) {
    __syncthreads();  // the previous tile's shared reads are done
    for (int i = tid; i < BKT * DH; i += NT) {
      const int c = i / DH, d = i % DH, gk = k0 + c;
      const bool in = gk < Tk && d < dh;
      Ks[c * (DH + 1) + d] = in ? to_f(kb[gk * k_st + d]) : 0.f;
      Vs[c * DH + d] = in ? to_f(vb[gk * v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = Qs[r * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] += qd * Ks[(sub + 4 * j) * (DH + 1) + d];
    }

    float tmax = EXCLUDED;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int gk = k0 + sub + 4 * j;
      if (gk >= Tk) {
        s[j] = EXCLUDED;
        continue;
      }
      float x = s[j] * scale;
      if (bias_row != nullptr) x += to_f(bias_row[gk]);
      bool ok = mrow == nullptr || mrow[gk] != 0;
      if (causal) ok = ok && gk <= qrow;
      s[j] = ok ? x : mask_value;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // a row with no valid key so far keeps exp(0) = 1 out of the sums
    const bool alive = m_new > NEG_INF * 0.5f;
    const float alpha = alive ? expf(m - m_new) : 0.f;

    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = (alive && s[j] != EXCLUDED) ? expf(s[j] - m_new) : 0.f;
      psum += p;
      Ps[r * (BKT + 1) + sub + 4 * j] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four threads (one warp) wrote Ps

#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] *= alpha;
    for (int c = 0; c < BKT; ++c) {
      const float p = Ps[r * (BKT + 1) + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] += p * Vs[c * DH + sub + 4 * j];
    }
  }

  if (qrow < Tq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + (((long long)b * Tq + qrow) * H + h) * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = sub + 4 * j;
      if (d < dh) orow[d] = from_f<T>(acc[j] / denom);
    }
    if (lse != nullptr && sub == 0)
      lse[((long long)b * H + h) * Tq + qrow] = m > NEG_INF * 0.5f ? m + logf(denom) : NEG_INF;
  }
}

template <typename T, typename BT, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   const void* bias, void* out, void* lse, int B, int H, int Hkv,
                   int Tq, int Tk, int dh, long long q_sb, long long q_st,
                   long long k_sb, long long k_st, long long v_sb, long long v_st,
                   int bias_batched, float scale, int causal, float mask_value,
                   cudaStream_t stream) {
  const int smem = smem_floats<DH>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, BT, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const BT*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), H, Hkv, Tq, Tk, dh,
      q_sb, q_st, k_sb, k_st, v_sb, v_st, bias_batched, scale, causal, mask_value);
  return cudaGetLastError();
}

template <typename T, typename BT>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      const void* mask, const void* bias, void* out, void* lse,
                      int B, int H, int Hkv, int Tq, int Tk, long long q_sb,
                      long long q_st, long long k_sb, long long k_st, long long v_sb,
                      long long v_st, int bias_batched, float scale, int causal,
                      float mask_value, cudaStream_t s) {
#define FLASH_ARGS q, k, v, mask, bias, out, lse, B, H, Hkv, Tq, Tk, dh, q_sb, q_st, \
                   k_sb, k_st, v_sb, v_st, bias_batched, scale, causal, mask_value, s
  if (dh <= 32) return launch<T, BT, 32>(FLASH_ARGS);
  if (dh <= 64) return launch<T, BT, 64>(FLASH_ARGS);
  if (dh <= 128) return launch<T, BT, 128>(FLASH_ARGS);
#undef FLASH_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Tq, H, dh), k/v (B, Tk, Hkv, dh) given by their batch and token
// strides in elements (heads and dh contiguous); mask (B, Tk) uint8 or null;
// bias (1|B, H, Tq, Tk) contiguous or null; out (B, Tq, H, dh) contiguous;
// lse (B, H, Tq) f32 or null. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* bias, void* out, void* lse, int B, int H, int Hkv,
                         int Tq, int Tk, int dh, long long q_sb, long long q_st,
                         long long k_sb, long long k_st, long long v_sb, long long v_st,
                         int bias_batched, int dtype, int bias_dtype, float scale,
                         int causal, float mask_value, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS dh, q, k, v, mask, bias, out, lse, B, H, Hkv, Tq, Tk, q_sb, q_st, k_sb, k_st, \
             v_sb, v_st, bias_batched, scale, causal, mask_value, s
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DT_F32 && bias_dtype == DT_F32) err = launch_dh<float, float>(ARGS);
  else if (dtype == DT_F32 && bias_dtype == DT_BF16) err = launch_dh<float, __nv_bfloat16>(ARGS);
  else if (dtype == DT_BF16 && bias_dtype == DT_F32) err = launch_dh<__nv_bfloat16, float>(ARGS);
  else if (dtype == DT_BF16 && bias_dtype == DT_BF16)
    err = launch_dh<__nv_bfloat16, __nv_bfloat16>(ARGS);
#undef ARGS
  return (int)err;
}
