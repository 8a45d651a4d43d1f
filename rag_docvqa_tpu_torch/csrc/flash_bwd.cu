// K6: the recompute-based flash-attention backward: dQ, dK, dV and the bias
// gradient, from q, k, v, the forward's output and per-row log-sum-exp, and
// the output cotangent dO. Key mask, additive bias (batch-shared or per
// batch, f32 or bf16), causal, scale, GQA and the masked score `mask_value`
// as in the forward (flash_fwd.cu).
//
// Replaces the TPU kernels `_flash_bwd_dkv_kernel`,
// `_flash_bwd_dkv_kernel_single` (+ `_dkv_single_nobias`, `_dkv_nobias`) and
// `_flash_bwd_dq_kernel` (+ `_dq_nobias`) of
// rag_docvqa_tpu/ops/flash_attention.py, called from `_bwd_call_impl` and
// `_dq_pass`, with the D = rowsum(dO * O) prologue of `_bwd_call_impl`.
// It is also the attention part of the T5 layer backward (K8,
// ops/fused_encoder.py::t5_attn_bwd), with mask_value -1e9.
//
// Numerics, per (query, key) pair, as the TPU kernels and the plain version
// (ops/flash_attention.py::flash_attention_bwd_reference):
//   s  = q.k * scale + bias, or mask_value where the key is masked
//   p  = exp(s - lse) on a row whose lse > NEG_INF/2, else 0       (f32);
//        1/Tk on a row with no valid key under mask_value -1e9
//   dp = dO.v;  gs = p * (dp - D) on a valid pair, else 0           (f32)
//   dV += round(p) dO;  dK += round(gs) q;  dQ += round(gs) k   (f32 sums)
//   dK, dQ scaled by `scale` at the end; dbias = gs in f32.
// round() is the cast to the value dtype the TPU kernel makes before each
// product. With mask_value -1e9 a row with no valid key has the uniform
// softmax, so its dO reaches the masked keys' V; with -1e30 it gives zeros.
// Causal skips the tiles the forward skips, so on a causal row with no
// valid key and mask_value -1e9 (a row no caller makes) dV differs from the
// plain version, which spreads that row over every key.
//
// On the TPU the batch-shared bias gradient accumulates across the
// sequential grid. Hopper blocks run in no order, so here each (batch,
// query tile) block writes its own rows of a (B, H, Tq, Tk) f32 scratch and
// a second pass sums it over the batch in a fixed order: deterministic, no
// atomics, at the cost of B*H*Tq*Tk*4 bytes written and read once.
//
// What bounds it on the H100: like the forward, arithmetic (about 2.5x the
// forward's products), and in this SIMT first version shared-memory
// bandwidth. Design: the dK/dV pass is one block per (64-key tile, kv head,
// batch row), 256 threads, four per key row, looping over the group's query
// heads and 32-query tiles with K/V resident in shared memory; the dQ pass is
// one block per (32-query tile, head, batch row), 128 threads, four per query
// row, looping over 64-key tiles, as the forward. Tensor cores, TMA and a
// pipelined ring are later work.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BQ = 32;   // query rows per tile
constexpr int BKT = 64;  // keys per tile
constexpr float NEG_INF = -1e30f;

struct Strides {  // batch and token strides, in elements, of one (B, T, H, dh) operand
  long long sb, st;
};

// ---- D = rowsum(dO * O), one warp per (b, q, h) row -------------------------
template <typename T>
__global__ void rowsum_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                              float* __restrict__ dd, int B, int Tq, int H, int dh) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= (long long)B * Tq * H) return;
  const int lane = threadIdx.x % 32;
  const T* a = dout + row * dh;
  const T* o = out + row * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc += to_f(a[d]) * to_f(o[d]);
  acc = warp_sum(acc);
  if (lane == 0) {  // row = (b * Tq + q) * H + h  ->  dd[(b * H + h) * Tq + q]
    const long long h = row % H, bq = row / H, q = bq % Tq, b = bq / Tq;
    dd[(b * H + h) * Tq + q] = acc;
  }
}

// p and gs of one (query, key) pair; see the numerics at the top
template <typename BT>
__device__ __forceinline__ void pair_grad(float s, float dp, int gq, int gk, int Tq, int Tk,
                                          const BT* __restrict__ bias_bh,
                                          const uint8_t* __restrict__ mrow, float lse, float dd,
                                          float scale, int causal, float mask_value, float& p,
                                          float& gs) {
  if (gq >= Tq || gk >= Tk) {
    p = 0.f;
    gs = 0.f;
    return;
  }
  float x = s * scale;
  if (bias_bh != nullptr) x += to_f(bias_bh[(long long)gq * Tk + gk]);
  bool ok = mrow == nullptr || mrow[gk] != 0;
  if (causal) ok = ok && gk <= gq;
  x = ok ? x : mask_value;
  // a row whose every key carries mask_value (> NEG_INF/2) is uniform: its
  // lse = mask_value + log(Tk) rounds to mask_value in f32, so 1/Tk is explicit
  p = lse > NEG_INF * 0.5f ? (lse < 0.5f * mask_value ? 1.f / Tk : expf(x - lse)) : 0.f;
  gs = ok ? p * (dp - dd) : 0.f;
}

// ---- pass 1: dK, dV ---------------------------------------------------------
template <int DH>
constexpr int dkv_smem_floats() {
  return 2 * BKT * (DH + 1) + 2 * BQ * (DH + 1) + 2 * BQ * (BKT + 1) + 2 * BQ;
}

template <typename T, typename BT, int DH>
__global__ void __launch_bounds__(256) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
    const uint8_t* __restrict__ mask, const BT* __restrict__ bias, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Hkv, int Tq, int Tk, int dh, Strides qs, Strides ks,
    Strides vs, Strides dks, Strides dvs, int bias_batched, float scale, int causal,
    float mask_value) {
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BKT][DH + 1]
  float* Vs = Ks + BKT * (DH + 1);   // [BKT][DH + 1]
  float* Qs = Vs + BKT * (DH + 1);   // [BQ][DH + 1]
  float* Os = Qs + BQ * (DH + 1);    // [BQ][DH + 1]  dO
  float* Ps = Os + BQ * (DH + 1);    // [BQ][BKT + 1] round(p)
  float* Gs = Ps + BQ * (BKT + 1);   // [BQ][BKT + 1] round(gs)
  float* Ls = Gs + BQ * (BKT + 1);   // [BQ] lse
  float* Ds = Ls + BQ;               // [BQ] D

  const int hk = blockIdx.y, b = blockIdx.z, rep = H / Hkv;
  const int tid = threadIdx.x, kr = tid >> 2, sub = tid & 3;
  const int k0 = blockIdx.x * BKT, gk = k0 + kr;
  const T* kb = k + b * ks.sb + (long long)hk * dh;
  const T* vb = v + b * vs.sb + (long long)hk * dh;
  for (int i = tid; i < BKT * DH; i += 256) {
    const int c = i / DH, d = i % DH, g = k0 + c;
    const bool in = g < Tk && d < dh;
    Ks[c * (DH + 1) + d] = in ? to_f(kb[g * ks.st + d]) : 0.f;
    Vs[c * (DH + 1) + d] = in ? to_f(vb[g * vs.st + d]) : 0.f;
  }
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Tk : nullptr;

  constexpr int NQ = BQ / 4;   // queries per thread per tile
  constexpr int ND = DH / 4;   // output columns per thread
  float dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const T* qb = q + b * qs.sb + (long long)h * dh;
    const T* ob = dout + (((long long)b * Tq) * H + h) * dh;  // dO contiguous (B, Tq, H, dh)
    const float* lrow = lse + ((long long)b * H + h) * Tq;
    const float* drow = dd + ((long long)b * H + h) * Tq;
    const BT* bias_bh = bias != nullptr ? bias + ((long long)(bias_batched ? b : 0) * H + h) * Tq * Tk
                                        : nullptr;
    for (int q0 = 0; q0 < Tq; q0 += BQ) {
      if (causal && min(q0 + BQ, Tq) - 1 < k0) continue;  // every pair above the diagonal
      __syncthreads();  // the previous tile's shared reads are done
      for (int i = tid; i < BQ * DH; i += 256) {
        const int r = i / DH, d = i % DH, g = q0 + r;
        const bool in = g < Tq && d < dh;
        Qs[r * (DH + 1) + d] = in ? to_f(qb[g * qs.st + d]) : 0.f;
        Os[r * (DH + 1) + d] = in ? to_f(ob[(long long)g * H * dh + d]) : 0.f;
      }
      if (tid < BQ) {
        const int g = q0 + tid;
        Ls[tid] = g < Tq ? lrow[g] : NEG_INF;
        Ds[tid] = g < Tq ? drow[g] : 0.f;
      }
      __syncthreads();

      float s[NQ], dp[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) s[j] = dp[j] = 0.f;
      for (int d = 0; d < DH; ++d) {
        const float kd = Ks[kr * (DH + 1) + d], vd = Vs[kr * (DH + 1) + d];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int r = sub + 4 * j;
          s[j] += Qs[r * (DH + 1) + d] * kd;
          dp[j] += Os[r * (DH + 1) + d] * vd;
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int r = sub + 4 * j;
        float p, gs;
        pair_grad(s[j], dp[j], q0 + r, gk, Tq, Tk, bias_bh, mrow, Ls[r], Ds[r], scale, causal,
                  mask_value, p, gs);
        Ps[r * (BKT + 1) + kr] = round_to<T>(p);
        Gs[r * (BKT + 1) + kr] = round_to<T>(gs);
      }
      __syncthreads();
      for (int r = 0; r < BQ; ++r) {
        const float p = Ps[r * (BKT + 1) + kr], gs = Gs[r * (BKT + 1) + kr];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int d = sub + 4 * j;
          dv_acc[j] += p * Os[r * (DH + 1) + d];
          dk_acc[j] += gs * Qs[r * (DH + 1) + d];
        }
      }
    }
  }
  if (gk < Tk) {
    T* dkr = dk + b * dks.sb + gk * dks.st + (long long)hk * dh;
    T* dvr = dv + b * dvs.sb + gk * dvs.st + (long long)hk * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = sub + 4 * j;
      if (d < dh) {
        dkr[d] = from_f<T>(dk_acc[j] * scale);
        dvr[d] = from_f<T>(dv_acc[j]);
      }
    }
  }
}

// ---- pass 2: dQ and the per-batch bias gradient -----------------------------
template <int DH>
constexpr int dq_smem_floats() {
  return 2 * BQ * (DH + 1) + 2 * BKT * (DH + 1) + BQ * (BKT + 1);
}

template <typename T, typename BT, int DH>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
    const uint8_t* __restrict__ mask, const BT* __restrict__ bias, T* __restrict__ dq,
    float* __restrict__ dbias, int H, int Hkv, int Tq, int Tk, int dh, Strides qs, Strides ks,
    Strides vs, Strides dqs, int bias_batched, float scale, int causal, float mask_value) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][DH + 1]
  float* Os = Qs + BQ * (DH + 1);    // [BQ][DH + 1]  dO
  float* Ks = Os + BQ * (DH + 1);    // [BKT][DH + 1]
  float* Vs = Ks + BKT * (DH + 1);   // [BKT][DH + 1]
  float* Gs = Vs + BKT * (DH + 1);   // [BQ][BKT + 1] round(gs)

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int q0 = blockIdx.x * BQ, gq = q0 + r;
  const T* qb = q + b * qs.sb + (long long)h * dh;
  const T* ob = dout + (((long long)b * Tq) * H + h) * dh;
  const T* kb = k + b * ks.sb + (long long)hk * dh;
  const T* vb = v + b * vs.sb + (long long)hk * dh;
  for (int i = tid; i < BQ * DH; i += 128) {
    const int rr = i / DH, d = i % DH, g = q0 + rr;
    const bool in = g < Tq && d < dh;
    Qs[rr * (DH + 1) + d] = in ? to_f(qb[g * qs.st + d]) : 0.f;
    Os[rr * (DH + 1) + d] = in ? to_f(ob[(long long)g * H * dh + d]) : 0.f;
  }
  const float lse_r = gq < Tq ? lse[((long long)b * H + h) * Tq + gq] : NEG_INF;
  const float dd_r = gq < Tq ? dd[((long long)b * H + h) * Tq + gq] : 0.f;
  const BT* bias_bh = bias != nullptr ? bias + ((long long)(bias_batched ? b : 0) * H + h) * Tq * Tk
                                      : nullptr;
  // this block's rows of dbias (B, H, Tq, Tk): the per-batch gradient, or the
  // per-batch part of the shared one that the second pass sums
  float* db_row = (dbias != nullptr && gq < Tq) ? dbias + (((long long)b * H + h) * Tq + gq) * Tk
                                                : nullptr;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Tk : nullptr;

  constexpr int NC = BKT / 4;  // keys per thread per tile
  constexpr int ND = DH / 4;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  int k0 = 0;
  for (; k0 < k_end; k0 += BKT) {
    __syncthreads();
    for (int i = tid; i < BKT * DH; i += 128) {
      const int c = i / DH, d = i % DH, g = k0 + c;
      const bool in = g < Tk && d < dh;
      Ks[c * (DH + 1) + d] = in ? to_f(kb[g * ks.st + d]) : 0.f;
      Vs[c * (DH + 1) + d] = in ? to_f(vb[g * vs.st + d]) : 0.f;
    }
    __syncthreads();

    float s[NC], dp[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = Qs[r * (DH + 1) + d], od = Os[r * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = sub + 4 * j;
        s[j] += qd * Ks[c * (DH + 1) + d];
        dp[j] += od * Vs[c * (DH + 1) + d];
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = sub + 4 * j, gk = k0 + c;
      float p, gs;
      pair_grad(s[j], dp[j], gq, gk, Tq, Tk, bias_bh, mrow, lse_r, dd_r, scale, causal, mask_value,
                p, gs);
      if (db_row != nullptr && gk < Tk) db_row[gk] = gs;
      Gs[r * (BKT + 1) + c] = round_to<T>(gs);
    }
    __syncwarp();  // the row's four threads (one warp) wrote Gs
#pragma unroll 4
    for (int c = 0; c < BKT; ++c) {
      const float gs = Gs[r * (BKT + 1) + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] += gs * Ks[c * (DH + 1) + sub + 4 * j];
    }
  }
  // keys of the tiles causal skipped: no gradient
  if (db_row != nullptr)
    for (int gk = k0 + sub; gk < Tk; gk += 4) db_row[gk] = 0.f;

  if (gq < Tq) {
    T* dqr = dq + b * dqs.sb + gq * dqs.st + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = sub + 4 * j;
      if (d < dh) dqr[d] = from_f<T>(acc[j] * scale);
    }
  }
}

// ---- the batch sum of the shared bias gradient, in batch order --------------
__global__ void batch_sum_kernel(const float* __restrict__ per_batch, float* __restrict__ out,
                                 int B, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += per_batch[b * n + i];
    out[i] = acc;
  }
}

struct Args {
  const void *q, *k, *v, *out, *dout, *mask, *bias;
  const float* lse;
  void *dq, *dk, *dv;
  float *dbias, *dbias_scratch, *dd;
  int B, H, Hkv, Tq, Tk, dh;
  Strides qs, ks, vs, dqs, dks, dvs;
  int bias_batched;
  float scale;
  int causal;
  float mask_value;
};

template <typename T, typename BT, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int rows = a.B * a.Tq * a.H;
  rowsum_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(a.dout), static_cast<const T*>(a.out), a.dd, a.B, a.Tq, a.H, a.dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem1 = dkv_smem_floats<DH>() * (int)sizeof(float);
  auto k1 = flash_bwd_dkv_kernel<T, BT, DH>;
  err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  k1<<<dim3((a.Tk + BKT - 1) / BKT, a.Hkv, a.B), 256, smem1, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dd, static_cast<const uint8_t*>(a.mask),
      static_cast<const BT*>(a.bias), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Hkv,
      a.Tq, a.Tk, a.dh, a.qs, a.ks, a.vs, a.dks, a.dvs, a.bias_batched, a.scale, a.causal,
      a.mask_value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the shared bias's gradient goes through the per-batch scratch first
  float* db = a.bias_batched ? a.dbias : a.dbias_scratch;
  const int smem2 = dq_smem_floats<DH>() * (int)sizeof(float);
  auto k2 = flash_bwd_dq_kernel<T, BT, DH>;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return err;
  k2<<<dim3((a.Tq + BQ - 1) / BQ, a.H, a.B), 128, smem2, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dd, static_cast<const uint8_t*>(a.mask),
      static_cast<const BT*>(a.bias), static_cast<T*>(a.dq), a.bias != nullptr ? db : nullptr,
      a.H, a.Hkv, a.Tq, a.Tk, a.dh, a.qs, a.ks, a.vs, a.dqs, a.bias_batched, a.scale, a.causal,
      a.mask_value);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.bias == nullptr || a.bias_batched) return err;

  const long long n = (long long)a.H * a.Tq * a.Tk;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 4 * 132 * 8);
  batch_sum_kernel<<<blocks, 256, 0, stream>>>(a.dbias_scratch, a.dbias, a.B, n);
  return cudaGetLastError();
}

template <typename T, typename BT>
cudaError_t launch_dh(const Args& a, cudaStream_t s) {
  if (a.dh <= 32) return launch<T, BT, 32>(a, s);
  if (a.dh <= 64) return launch<T, BT, 64>(a, s);
  if (a.dh <= 128) return launch<T, BT, 128>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Tq, H, dh), k/v (B, Tk, Hkv, dh) and the outputs dq (like q), dk/dv
// (like k) given by their batch and token strides in elements (heads and dh
// contiguous); out and dout contiguous (B, Tq, H, dh); lse (B, H, Tq) f32;
// mask (B, Tk) uint8 or null; bias (1|B, H, Tq, Tk) contiguous or null;
// dbias (1|B, H, Tq, Tk) f32 (written when bias is given); dbias_scratch
// (B, H, Tq, Tk) f32 for a batch-shared bias, else null; dd (B, H, Tq) f32
// scratch. Returns the first error of its launches.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* out,
                         const void* dout, const void* lse, const void* mask, const void* bias,
                         void* dq, void* dk, void* dv, void* dbias, void* dbias_scratch, void* dd,
                         int B, int H, int Hkv, int Tq, int Tk, int dh, long long q_sb,
                         long long q_st, long long k_sb, long long k_st, long long v_sb,
                         long long v_st, long long dq_sb, long long dq_st, long long dk_sb,
                         long long dk_st, long long dv_sb, long long dv_st, int bias_batched,
                         int dtype, int bias_dtype, float scale, int causal, float mask_value,
                         void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (bias != nullptr && !bias_batched && dbias_scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, dout, mask, bias, static_cast<const float*>(lse), dq, dk, dv,
         static_cast<float*>(dbias), static_cast<float*>(dbias_scratch), static_cast<float*>(dd),
         B, H, Hkv, Tq, Tk, dh, {q_sb, q_st}, {k_sb, k_st}, {v_sb, v_st}, {dq_sb, dq_st},
         {dk_sb, dk_st}, {dv_sb, dv_st}, bias_batched, scale, causal, mask_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DT_F32 && bias_dtype == DT_F32) err = launch_dh<float, float>(a, s);
  else if (dtype == DT_F32 && bias_dtype == DT_BF16) err = launch_dh<float, __nv_bfloat16>(a, s);
  else if (dtype == DT_BF16 && bias_dtype == DT_F32) err = launch_dh<__nv_bfloat16, float>(a, s);
  else if (dtype == DT_BF16 && bias_dtype == DT_BF16)
    err = launch_dh<__nv_bfloat16, __nv_bfloat16>(a, s);
  return (int)err;
}
