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
// sequential grid. Hopper blocks run in no order: for bf16 rows a third pass
// gives each (query tile, key tile, head) block the batch rows in order and
// sums gs in registers (it recomputes S and dP, two more products, in place
// of a (B, H, Tq, Tk) f32 scratch written and read again, which took longer
// at B 8 T 512 on the H100); the f32 rows' SIMT dQ pass writes each (batch,
// query tile) block's rows of that scratch and a second pass sums it over the
// batch in order. Deterministic either way, no atomics. dQ is not
// accumulated across key blocks either: the two passes below (dK/dV, then dQ)
// are the TPU's, so no float atomics anywhere and the bits repeat.
//
// What bounds it on the H100: arithmetic, the five products of 2*Tq*Tk*dh per
// head the function needs (S, dP, dV, dK, dQ); the bf16 kernels run seven
// (the dQ pass recomputes S and dP) and nine with a shared bias (its pass
// recomputes them again).
//
// bf16 rows (flash_bwd_dkv_wgmma_kernel, flash_bwd_dq_wgmma_kernel): every
// product on the tensor cores through wgmma.mma_async m64n64k16 (hopper.cuh).
//   dK/dV pass: one warpgroup a block owns 64 keys of one (batch row, kv head)
//   with K and V resident in 128-byte-swizzled shared tiles, and walks the
//   group's query heads and their 64-query tiles; Q, dO, the (query, key)
//   bias tile, lse and D stream through a two-stage cp.async ring. S^T = K Q^T
//   and dP^T = V dO^T land in register accumulators (keys down, queries
//   across); p and gs are formed there, the bias read transposed from its
//   shared tile (rows padded by 16 bytes so the four query rows a read
//   touches fall on different banks); rounded to bf16 they are the A operand
//   of dV += P^T dO and dK += dS^T Q straight from registers, with dO and Q
//   read MN-major through the transpose immediate.
//   dQ pass: one warpgroup a block owns 64 queries of one (batch row, head)
//   with Q and dO resident, and walks the key tiles through a three-stage
//   ring as the forward does: S = Q K^T, dP = dO V^T, gs (a per-batch bias's
//   gradient, in f32), dQ += dS K with K read MN-major.
//   dbias pass (a batch-shared bias): one warpgroup a block owns a 64 x 64
//   (query, key) tile of one head and sums gs over the batch rows in order.
//   Short rows (Tq, Tk <= 64, no bias, no GQA) take one pass instead, a block
//   walking (batch row, head) items (flash_bwd_short_wgmma_kernel).
// dh below 64 (or between 64 and 128) is padded with zeros in shared memory;
// steps of the reduction past dh are skipped. exp(x - lse) is ex2.approx of
// (x - lse) * log2 e, the instruction __expf lowers to. Rows not 16-byte
// aligned fill the same tiles with plain loads.
//
// f32 rows keep the SIMT kernels (the tensor cores have no exact f32
// product): the dK/dV pass one block per (64-key tile, kv head, batch row),
// 256 threads, four per key row, looping over the group's query heads and
// 32-query tiles with K/V resident in shared memory; the dQ pass one block
// per (32-query tile, head, batch row), 128 threads, four per query row,
// looping over 64-key tiles.
#include <algorithm>

#include "hopper.cuh"

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

// ---- bf16 rows: wgmma ---------------------------------------------------------
constexpr int WT = 64;         // keys (dK/dV pass) or queries (dQ pass) of a block: one warpgroup
constexpr int SUB = 64 * 128;  // bytes of one swizzled 64-row x 64-column bf16 tile
constexpr int KV_ST = 2;       // dK/dV pass: stages of the Q, dO, bias, lse and D ring
constexpr int DQ_ST = 3;       // dQ pass: stages of the K and V ring
constexpr float LOG2E = 1.4426950408889634f;

// 4 bytes global -> shared, asynchronously; `in` false writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  const int n = in ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
}

// 64 rows of `src` (row stride `st` elements) from row r0 into the DH / 64
// swizzled tiles at shared address `dst` (`dst_gen` as a generic pointer);
// rows at or past `rows` and columns past dh are zeros. VEC: 16-byte cp.async,
// DH / 8 neighbouring threads on one row (a thread's chunk and its row modulo
// 8 are the same in every pass); else plain loads and shared stores.
template <int DH, bool VEC>
__device__ __forceinline__ void load_tile(uint32_t dst, uint8_t* dst_gen, const __nv_bfloat16* src, long long st,
                                          int r0, int rows, int dh) {
  constexpr int CPR = DH / 8, RPP = 128 / CPR;  // chunks a row, rows a pass
  const int tid = threadIdx.x;
  if (VEC) {
    const int c = tid % CPR, r = tid / CPR;
    const uint32_t off = (c >> 3) * SUB + swz_off(r, c & 7);
    const bool col = c * 8 < dh;
    const __nv_bfloat16* p = src + (long long)(r0 + r) * st + c * 8;
#pragma unroll
    for (int pass = 0; pass < 64 / RPP; ++pass) {
      const bool in = col && r0 + r + pass * RPP < rows;
      cp_async16(dst + off + pass * RPP * 128, in ? p + (long long)pass * RPP * st : src, in);
    }
  } else {
    for (int i = tid; i < 64 * DH; i += 128) {
      const int row = i / DH, d = i % DH;
      const bool in = r0 + row < rows && d < dh;
      const __nv_bfloat16 val = in ? src[(long long)(r0 + row) * st + d] : __float2bfloat16(0.f);
      *reinterpret_cast<__nv_bfloat16*>(dst_gen + (d >> 6) * SUB + swz_off(row, (d & 63) >> 3) + (d & 7) * 2) = val;
    }
  }
}

// the value of p and of gs = p (dp - D) for one pair, from its raw score s and
// dp; `ok` the pair is attended (key valid, causal), `l` and `dd` its row's
// lse and D (l = NEG_INF for a query row past Tq)
__device__ __forceinline__ void pair_grad_fast(float& s, float& dp, bool ok, float b, float l, float dd,
                                               float scale, float mask_value, float inv_tk) {
  const float x = ok ? fmaf(s, scale, b) : mask_value;
  // a row whose every key carries mask_value (> NEG_INF/2) is uniform: its
  // lse = mask_value + log(Tk) rounds to mask_value in f32, so 1/Tk is explicit
  const float p = l > NEG_INF * 0.5f ? (l < 0.5f * mask_value ? inv_tk : exp2f_approx((x - l) * LOG2E)) : 0.f;
  dp = ok ? p * (dp - dd) : 0.f;
  s = p;
}

// the rounded values of 32 accumulator entries as the A fragments of four
// 16-deep steps of the next product (hopper.cuh: accumulator layout)
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[kk * 8 + 2 * i], x[kk * 8 + 2 * i + 1]);
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// one accumulator row of this thread (`half`) as bf16 at `row`: columns past
// dh dropped, times `scale`; two neighbouring columns as one 4-byte store
// where `pairs`
template <int NS>
__device__ __forceinline__ void store_row(__nv_bfloat16* row, const float (&acc)[NS][32], int half, int cq, int dh,
                                          float scale, int pairs) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = n * 64 + j * 8 + cq, i = j * 4 + half * 2;
      const float v0 = acc[n][i] * scale, v1 = acc[n][i + 1] * scale;
      if (pairs && d + 1 < dh) {
        *reinterpret_cast<uint32_t*>(row + d) = pack_bf16(v0, v1);
      } else {
        if (d < dh) row[d] = __float2bfloat16(v0);
        if (d + 1 < dh) row[d + 1] = __float2bfloat16(v1);
      }
    }
}

// s = A1 B1^T and dp = A2 B2^T over dh, each operand a 64-row K-major tile
// (steps of the reduction past dh hold zeros and are skipped); waited for
template <int DH>
__device__ __forceinline__ void two_products(uint32_t a1, uint32_t b1, uint32_t a2, uint32_t b2, int dh, float (&s)[32],
                                             float (&dp)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    if (kk * 16 < dh) {
      const uint32_t step = (kk >> 2) * SUB + (kk & 3) * 32;
      wgmma_m64n64k16_ss<0, 0>(s, wgmma_desc(a1 + step), wgmma_desc(b1 + step), kk > 0);
      wgmma_m64n64k16_ss<0, 0>(dp, wgmma_desc(a2 + step), wgmma_desc(b2 + step), kk > 0);
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// S^T = K Q^T and dP^T = V dO^T of one 64-key x 64-query tile, keys down and
// queries across, turned in place into p and gs (the dK/dV pass and the
// one-pass kernel); `bias_at(c, half)` the bias of query column c and this
// thread's key row `half`
template <int DH, typename BiasAt>
__device__ __forceinline__ void transposed_grads(uint32_t k_s, uint32_t v_s, uint32_t q_s, uint32_t do_s, int dh,
                                                 const float* lse_t, int q0, int Tq, int k0, const int (&kl)[2],
                                                 const bool (&key_ok)[2], int causal, int cq, float scale,
                                                 float mask_value, float inv_tk, BiasAt bias_at, float (&s)[32],
                                                 float (&dp)[32]) {
  two_products<DH>(k_s, q_s, v_s, do_s, dh, s, dp);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 8 + cq + e, gq = q0 + c;
      const float l = gq < Tq ? lse_t[c] : NEG_INF, ddc = lse_t[WT + c];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = j * 4 + half * 2 + e;
        const bool ok = key_ok[half] && (!causal || k0 + kl[half] <= gq);
        pair_grad_fast(s[i], dp[i], ok, bias_at(c, half), l, ddc, scale, mask_value, inv_tk);
      }
    }
}

template <typename BT, int DH> struct DkvSmem {
  static constexpr int NS = DH / 64;
  static constexpr int TILE = NS * SUB;              // K, V, Q or dO
  // bytes of a bias row in shared memory: 16 of padding put the four query
  // rows a transposed read touches on different banks
  static constexpr int LD = 64 * (int)sizeof(BT) + 16;
  static constexpr int BIAS = 64 * LD;               // 9216 or 17408 bytes: the stages stay 1024-aligned
  static constexpr int STAGE = 2 * TILE + BIAS;      // Q, dO, the bias tile
  static constexpr int ROWS = 2 * TILE + KV_ST * STAGE;  // then lse and D of each stage
  static constexpr int BYTES = ROWS + KV_ST * 2 * WT * 4 + 1024;
};

// pass 1, bf16: a block owns 64 keys of one (batch row, kv head), K and V
// resident, and walks the group's query heads and their 64-query tiles
template <typename BT, int DH, bool VEC>
__global__ void __launch_bounds__(128, DH == 64 ? 3 : 2) flash_bwd_dkv_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, const uint8_t* __restrict__ mask,
    const BT* __restrict__ bias, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int Hkv, int Tq, int Tk, int dh, Strides qs, Strides ks, Strides vs, Strides dks, Strides dvs,
    int bias_batched, float scale, int causal, float mask_value, int bias_vec, int out_pairs) {
  using bf16 = __nv_bfloat16;
  using L = DkvSmem<BT, DH>;
  constexpr int NS = L::NS, LD = L::LD;
  extern __shared__ uint8_t dkv_smem[];
  const uint32_t raw = smem_u32(dkv_smem), base = (raw + 1023u) & ~1023u;
  uint8_t* gen = dkv_smem + (base - raw);  // the aligned base as a generic pointer
  const uint32_t k_s = base, v_s = base + L::TILE, ring_s = base + 2 * L::TILE;
  float* rows_sm = reinterpret_cast<float*>(gen + L::ROWS);  // [KV_ST][lse, D][WT]

  const int hk = blockIdx.y, b = blockIdx.z, rep = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * WT;
  const int kl[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};  // this thread's two key rows in the tile
  const int cq = (lane & 3) * 2;  // its first query column within a block of 8
  bool key_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gk = k0 + kl[half];
    key_ok[half] = gk < Tk && (mask == nullptr || mask[(long long)b * Tk + gk] != 0);
  }

  // the query tiles of every head of the group; causal skips the tiles whose
  // every query lies before this block's first key, as the forward does
  const int nqt = (Tq + WT - 1) / WT, qt0 = causal ? k0 / WT : 0;
  const int per = max(0, nqt - qt0), nt = rep * per;
  auto load = [&](int t) {
    const int h = hk * rep + t / per, q0 = (qt0 + t % per) * WT, st = t % KV_ST;
    const uint32_t q_s = ring_s + st * L::STAGE;
    load_tile<DH, VEC>(q_s, gen + (q_s - base), q + b * qs.sb + (long long)h * dh, qs.st, q0, Tq, dh);
    load_tile<DH, VEC>(q_s + L::TILE, gen + (q_s - base) + L::TILE, dout + ((long long)b * Tq * H + h) * dh,
                       (long long)H * dh, q0, Tq, dh);
    if (bias != nullptr) {  // rows q0.., keys k0.. as [query][key], rows LD bytes apart
      const BT* bb = bias + ((long long)(bias_batched ? b : 0) * H + h) * Tq * Tk;
      const uint32_t b_s = q_s + 2 * L::TILE;
      if (bias_vec) {  // Tk a multiple of a chunk: a chunk lies wholly inside Tk or past it
        constexpr int CPR = 64 * (int)sizeof(BT) / 16, EPC = 16 / (int)sizeof(BT);
        for (int i = tid; i < 64 * CPR; i += 128) {
          const int r = i / CPR, c = i % CPR, gk = k0 + c * EPC;
          const bool in = q0 + r < Tq && gk < Tk;
          cp_async16(b_s + r * LD + c * 16, in ? bb + (long long)(q0 + r) * Tk + gk : bias, in);
        }
      } else {
        uint8_t* b_g = gen + (b_s - base);
        for (int i = tid; i < 64 * 64; i += 128) {
          const int r = i / 64, c = i % 64;
          const bool in = q0 + r < Tq && k0 + c < Tk;
          *reinterpret_cast<BT*>(b_g + r * LD + c * sizeof(BT)) = in ? bb[(long long)(q0 + r) * Tk + k0 + c] : from_f<BT>(0.f);
        }
      }
    }
    const float* src = tid < WT ? lse : dd;
    const int r = tid % WT;
    const bool in = q0 + r < Tq;
    cp_async4(smem_u32(rows_sm + st * 2 * WT + tid), in ? src + ((long long)b * H + h) * Tq + q0 + r : src, in);
  };
  const bf16* kb = k + b * ks.sb + (long long)hk * dh;
  const bf16* vb = v + b * vs.sb + (long long)hk * dh;
  load_tile<DH, VEC>(k_s, gen, kb, ks.st, k0, Tk, dh);
  load_tile<DH, VEC>(v_s, gen + L::TILE, vb, vs.st, k0, Tk, dh);
#pragma unroll
  for (int s = 0; s < KV_ST - 1; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }

  float dka[NS][32], dva[NS][32];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[n][i] = dva[n][i] = 0.f;
  const float inv_tk = 1.f / Tk;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<KV_ST - 2>();  // this thread's copies of tile t (and of K, V) have landed
    fence_async_shared();
    __syncthreads();  // everyone's have; and every warp is done with tile t - 1
    if (t + KV_ST - 1 < nt) load(t + KV_ST - 1);  // into tile t - 1's stage
    cp_async_commit();
    const int q0 = (qt0 + t % per) * WT, st = t % KV_ST;
    const uint32_t q_s = ring_s + st * L::STAGE, do_s = q_s + L::TILE;
    const uint8_t* bias_t = gen + (q_s - base) + 2 * L::TILE;
    const float* lse_t = rows_sm + st * 2 * WT;

    float s[32], dp[32];
    transposed_grads<DH>(k_s, v_s, q_s, do_s, dh, lse_t, q0, Tq, k0, kl, key_ok, causal, cq, scale, mask_value, inv_tk,
                         [&](int c, int half) {
                           return bias != nullptr ? to_f(*reinterpret_cast<const BT*>(bias_t + c * LD + kl[half] * sizeof(BT)))
                                                  : 0.f;
                         }, s, dp);
    // dV += P^T dO and dK += dS^T Q: P^T and dS^T, rounded, as A from registers;
    // dO and Q read MN-major (the reduction runs over their rows, the queries)
    uint32_t pa[4][4], ga[4][4];
    pack_a(s, pa);
    pack_a(dp, ga);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      fence_regs(dva[n]);
      fence_regs(dka[n]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        wgmma_m64n64k16_rs<1>(dva[n], pa[kk], wgmma_desc(do_s + n * SUB + kk * 16 * 128), 1);
        wgmma_m64n64k16_rs<1>(dka[n], ga[kk], wgmma_desc(q_s + n * SUB + kk * 16 * 128), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      fence_regs(dva[n]);
      fence_regs(dka[n]);
    }
    fence_frags(pa);
    fence_frags(ga);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gk = k0 + kl[half];
    if (gk >= Tk) continue;
    store_row(dk + b * dks.sb + gk * dks.st + (long long)hk * dh, dka, half, cq, dh, scale, out_pairs);
    store_row(dv + b * dvs.sb + gk * dvs.st + (long long)hk * dh, dva, half, cq, dh, 1.f, out_pairs);
  }
}

template <int DH> struct DqSmem {
  static constexpr int TILE = (DH / 64) * SUB;
  static constexpr int CODES = 2 * TILE + DQ_ST * 2 * TILE;  // after Q, dO and the K/V ring
  static constexpr int BYTES = CODES + DQ_ST * WT + 1024;
};

// pass 2, bf16: a block owns 64 queries of one (batch row, head), Q and dO
// resident, and walks the key tiles through a ring (as the forward); it writes
// this block's rows of dbias, the per-batch gradient or the per-batch part of
// the shared one
template <typename BT, int DH, bool VEC>
__global__ void __launch_bounds__(128, DH == 64 ? 3 : 2) flash_bwd_dq_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, const uint8_t* __restrict__ mask,
    const BT* __restrict__ bias, __nv_bfloat16* __restrict__ dq, float* __restrict__ dbias, int H, int Hkv,
    int Tq, int Tk, int dh, Strides qs, Strides ks, Strides vs, Strides dqs, int bias_batched, float scale,
    int causal, float mask_value, int bias_pairs, int out_pairs) {
  using bf16 = __nv_bfloat16;
  using L = DqSmem<DH>;
  constexpr int NS = DH / 64, STAGE = 2 * L::TILE;
  extern __shared__ uint8_t dq_smem[];
  const uint32_t raw = smem_u32(dq_smem), base = (raw + 1023u) & ~1023u;
  uint8_t* gen = dq_smem + (base - raw);
  const uint32_t q_s = base, do_s = base + L::TILE, ring_s = base + 2 * L::TILE;
  uint8_t* codes = gen + L::CODES;  // [DQ_ST][WT]: 1 where the key is valid

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * WT;
  const int qr[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  const int cq = (lane & 3) * 2;
  const bf16* kb = k + b * ks.sb + (long long)hk * dh;
  const bf16* vb = v + b * vs.sb + (long long)hk * dh;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Tk : nullptr;

  float l_r[2], dd_r[2];
  const BT* brow[2] = {nullptr, nullptr};
  float* db_row[2] = {nullptr, nullptr};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool in = qr[half] < Tq;
    const long long row = ((long long)b * H + h) * Tq + qr[half];
    l_r[half] = in ? lse[row] : NEG_INF;
    dd_r[half] = in ? dd[row] : 0.f;
    // a row past Tq reads row Tq - 1 of the bias; its values are never used
    if (bias != nullptr)
      brow[half] = bias + (((long long)(bias_batched ? b : 0) * H + h) * Tq + min(qr[half], Tq - 1)) * Tk + cq;
    if (dbias != nullptr && in) db_row[half] = dbias + row * Tk;
  }

  auto load_kv = [&](int t) {
    const int stage = t % DQ_ST, k0 = t * WT;
    const uint32_t off = 2 * L::TILE + stage * STAGE;
    load_tile<DH, VEC>(base + off, gen + off, kb, ks.st, k0, Tk, dh);
    load_tile<DH, VEC>(base + off + L::TILE, gen + off + L::TILE, vb, vs.st, k0, Tk, dh);
  };
  auto read_code = [&](int t) -> uint8_t {  // threads 0..WT-1, one key each
    const int gk = t * WT + tid;
    return tid < WT && gk < Tk && (mrow == nullptr || mrow[gk] != 0) ? 1 : 0;
  };
  auto write_code = [&](int t, uint8_t code) {
    if (tid < WT) codes[(t % DQ_ST) * WT + tid] = code;
  };

  // causal: key tiles wholly past this query tile's last row are skipped
  const int k_end = causal ? min(Tk, q0 + WT) : Tk;
  const int nt = (k_end + WT - 1) / WT;
  load_tile<DH, VEC>(q_s, gen, q + b * qs.sb + (long long)h * dh, qs.st, q0, Tq, dh);
  load_tile<DH, VEC>(do_s, gen + L::TILE, dout + ((long long)b * Tq * H + h) * dh, (long long)H * dh, q0, Tq, dh);
#pragma unroll
  for (int s = 0; s < DQ_ST - 1; ++s) {
    if (s < nt) {
      load_kv(s);
      write_code(s, read_code(s));
    }
    cp_async_commit();
  }

  float dqa[NS][32];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[n][i] = 0.f;
  const float inv_tk = 1.f / Tk;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<DQ_ST - 2>();
    fence_async_shared();
    __syncthreads();
    const int stage = t % DQ_ST, k0 = t * WT;
    // the bias of this thread's 32 scores, asked for before the products
    BiasPair<BT> bz[2][8];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 8; ++j) bz[half][j].zero();
    const bool paired = bias_pairs && k0 + WT <= Tk;
    if (bias != nullptr) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (paired) {
            bz[half][j].pair(brow[half] + k0 + j * 8);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (k0 + j * 8 + cq + e < Tk) bz[half][j].one(brow[half] + k0 + j * 8 + e, e);
          }
        }
    }
    const bool more = t + DQ_ST - 1 < nt;
    if (more) load_kv(t + DQ_ST - 1);
    cp_async_commit();
    const uint8_t next_code = more ? read_code(t + DQ_ST - 1) : 0;

    const uint32_t k_s = ring_s + stage * STAGE, v_s = k_s + L::TILE;
    float s[32], dp[32];
    two_products<DH>(q_s, k_s, do_s, v_s, dh, s, dp);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t cm = *reinterpret_cast<const uint16_t*>(codes + stage * WT + j * 8 + cq);
      const float2 bj[2] = {bz[0][j].get(paired), bz[1][j].get(paired)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gk = k0 + j * 8 + cq + e;
        const bool valid = ((cm >> (8 * e)) & 1u) != 0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = j * 4 + half * 2 + e;
          const bool ok = valid && (!causal || gk <= qr[half]);
          pair_grad_fast(s[i], dp[i], ok, e ? bj[half].y : bj[half].x, l_r[half], dd_r[half], scale, mask_value,
                         inv_tk);
        }
      }
    }
    // this tile's dbias: gs in f32, two neighbouring keys at a time
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (db_row[half] != nullptr)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gk = k0 + j * 8 + cq, i = j * 4 + half * 2;
          if ((Tk & 1) == 0 && gk + 1 < Tk) {
            *reinterpret_cast<float2*>(db_row[half] + gk) = make_float2(dp[i], dp[i + 1]);
          } else {
            if (gk < Tk) db_row[half][gk] = dp[i];
            if (gk + 1 < Tk) db_row[half][gk + 1] = dp[i + 1];
          }
        }
    // dQ += dS K: dS, rounded, as A from registers; K read MN-major
    uint32_t ga[4][4];
    pack_a(dp, ga);
#pragma unroll
    for (int n = 0; n < NS; ++n) fence_regs(dqa[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        wgmma_m64n64k16_rs<1>(dqa[n], ga[kk], wgmma_desc(k_s + n * SUB + kk * 16 * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NS; ++n) fence_regs(dqa[n]);
    fence_frags(ga);
    if (more) write_code(t + DQ_ST - 1, next_code);  // read after a later step's barrier
  }
  cp_async_wait<0>();

  // keys of the tiles causal skipped: no gradient
  const int k_done = min(Tk, nt * WT);
  if (dbias != nullptr && k_done < Tk)
    for (int i = tid; i < WT * (Tk - k_done); i += 128) {
      const int r = i / (Tk - k_done), gq = q0 + r;
      if (gq < Tq) dbias[(((long long)b * H + h) * Tq + gq) * Tk + k_done + i % (Tk - k_done)] = 0.f;
    }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (qr[half] >= Tq) continue;
    store_row(dq + b * dqs.sb + qr[half] * dqs.st + (long long)h * dh, dqa, half, cq, dh, scale, out_pairs);
  }
}

// pass 3, bf16, a batch-shared bias: a block owns one 64-query x 64-key tile
// of one head and walks the batch rows in order, their Q, dO, K, V, lse, D
// and key codes through a two-stage cp.async ring; S and dP as in the dQ pass
// (the bias tile, the same for every row, read once), gs summed over the
// batch in registers and written once. This is the TPU's accumulation across
// its sequential grid: no (B, H, Tq, Tk) scratch and no second sum.
template <int DH> struct DbSmem {
  static constexpr int TILE = (DH / 64) * SUB;
  static constexpr int STAGE = 4 * TILE;            // Q, dO, K, V
  static constexpr int ROWS = 2 * STAGE;            // lse and D of each stage
  static constexpr int CODES = ROWS + 2 * 2 * WT * 4;
  static constexpr int BYTES = CODES + 2 * WT + 1024;
};

template <typename BT, int DH, bool VEC>
__global__ void __launch_bounds__(128, DH == 64 ? 3 : 2) flash_bwd_dbias_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, const uint8_t* __restrict__ mask,
    const BT* __restrict__ bias, float* __restrict__ dbias, int B, int H, int Hkv, int Tq, int Tk, int dh,
    Strides qs, Strides ks, Strides vs, float scale, int causal, float mask_value, int bias_pairs) {
  using L = DbSmem<DH>;
  extern __shared__ uint8_t db_smem[];
  const uint32_t raw = smem_u32(db_smem), base = (raw + 1023u) & ~1023u;
  uint8_t* gen = db_smem + (base - raw);
  float* rows_sm = reinterpret_cast<float*>(gen + L::ROWS);  // [2][lse, D][WT]
  uint8_t* codes = gen + L::CODES;                           // [2][WT]: 1 where the key is valid

  const int h = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, cq = (lane & 3) * 2;
  const int q0 = blockIdx.x * WT, k0 = blockIdx.y * WT;
  const int ql[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};  // this thread's query rows in the tile
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  if (!causal || k0 <= q0 + WT - 1) {  // else every pair lies above the diagonal: no gradient
    // the tile's bias, read once: pairs where the tile lies inside Tk and the rows are 4-byte aligned
    float bv[32];
    {
      BiasPair<BT> bz[2][8];
      const bool paired = bias_pairs && k0 + WT <= Tk;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const BT* brow = bias + ((long long)h * Tq + min(q0 + ql[half], Tq - 1)) * Tk + k0 + cq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bz[half][j].zero();
          if (paired) {
            bz[half][j].pair(brow + j * 8);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (k0 + j * 8 + cq + e < Tk) bz[half][j].one(brow + j * 8 + e, e);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 b2 = bz[half][j].get(paired);
          bv[j * 4 + half * 2] = b2.x;
          bv[j * 4 + half * 2 + 1] = b2.y;
        }
    }
    auto load = [&](int b) {
      const int st = b & 1;
      const uint32_t s0 = base + st * L::STAGE;
      uint8_t* g0 = gen + st * L::STAGE;
      load_tile<DH, VEC>(s0, g0, q + b * qs.sb + (long long)h * dh, qs.st, q0, Tq, dh);
      load_tile<DH, VEC>(s0 + L::TILE, g0 + L::TILE, dout + ((long long)b * Tq * H + h) * dh, (long long)H * dh, q0,
                         Tq, dh);
      load_tile<DH, VEC>(s0 + 2 * L::TILE, g0 + 2 * L::TILE, k + b * ks.sb + (long long)hk * dh, ks.st, k0, Tk, dh);
      load_tile<DH, VEC>(s0 + 3 * L::TILE, g0 + 3 * L::TILE, v + b * vs.sb + (long long)hk * dh, vs.st, k0, Tk, dh);
      const float* src = tid < WT ? lse : dd;
      const int r = tid % WT;
      const bool in = q0 + r < Tq;
      cp_async4(smem_u32(rows_sm + st * 2 * WT + tid), in ? src + ((long long)b * H + h) * Tq + q0 + r : src, in);
      if (tid < WT) {
        const int gk = k0 + tid;
        codes[st * WT + tid] = gk < Tk && (mask == nullptr || mask[(long long)b * Tk + gk] != 0);
      }
    };
    load(0);
    cp_async_commit();
    const float inv_tk = 1.f / Tk;
    for (int b = 0; b < B; ++b) {
      cp_async_wait<0>();
      fence_async_shared();
      __syncthreads();  // row b has landed everywhere; every warp is done with row b - 1
      if (b + 1 < B) load(b + 1);
      cp_async_commit();
      const int st = b & 1;
      const uint32_t q_s = base + st * L::STAGE, do_s = q_s + L::TILE, k_s = do_s + L::TILE, v_s = k_s + L::TILE;
      float s[32], dp[32];
      two_products<DH>(q_s, k_s, do_s, v_s, dh, s, dp);
      const float* lse_t = rows_sm + st * 2 * WT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gq = q0 + ql[half];
        const float l = gq < Tq ? lse_t[ql[half]] : NEG_INF, ddr = lse_t[WT + ql[half]];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * 8 + cq + e, i = j * 4 + half * 2 + e;
            const bool ok = codes[st * WT + c] != 0 && (!causal || k0 + c <= gq);
            pair_grad_fast(s[i], dp[i], ok, bv[i], l, ddr, scale, mask_value, inv_tk);
            acc[i] += dp[i];
          }
      }
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gq = q0 + ql[half];
    if (gq >= Tq) continue;
    float* row = dbias + ((long long)h * Tq + gq) * Tk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gk = k0 + j * 8 + cq, i = j * 4 + half * 2;
      if ((Tk & 1) == 0 && gk + 1 < Tk) {
        *reinterpret_cast<float2*>(row + gk) = make_float2(acc[i], acc[i + 1]);
      } else {
        if (gk < Tk) row[gk] = acc[i];
        if (gk + 1 < Tk) row[gk + 1] = acc[i + 1];
      }
    }
  }
}

// ---- bf16, short rows (Tq, Tk <= 64, H == Hkv, no bias): one pass -----------
// A block walks (batch row, head) items with the grid's stride, two blocks an
// SM; an item's K, V, Q, dO, lse and D come through a two-stage cp.async
// ring, so the next item's loads run under this one's products (a contrastive
// step's B 256 x 12 heads of T 64 are 3,072 small items, which one block each
// would leave waiting on their loads). Per item: p and gs as in the dK/dV
// pass, dV += P^T dO and dK += dS^T Q from registers, and dQ = dS K with dS^T
// staged through a swizzled shared tile that wgmma reads as an MN-major A.
template <int DH> struct ShortSmem {
  static constexpr int TILE = (DH / 64) * SUB;
  static constexpr int STAGE = 4 * TILE;       // K, V, Q, dO
  static constexpr int DS = 2 * STAGE;         // dS^T, 64 keys x 64 queries
  static constexpr int ROWS = DS + SUB;        // lse and D of each stage
  static constexpr int BYTES = ROWS + 2 * 2 * WT * 4 + 1024;
};

template <int DH, bool VEC>
__global__ void __launch_bounds__(128, DH == 64 ? 3 : 1) flash_bwd_short_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, const uint8_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int H,
    int Tq, int Tk, int dh, Strides qs, Strides ks, Strides vs, Strides dqs, Strides dks, Strides dvs, float scale,
    int causal, float mask_value, int q_pairs, int kv_pairs) {
  using L = ShortSmem<DH>;
  constexpr int NS = DH / 64;
  extern __shared__ uint8_t short_smem[];
  const uint32_t raw = smem_u32(short_smem), base = (raw + 1023u) & ~1023u;
  uint8_t* gen = short_smem + (base - raw);
  const uint32_t ds_s = base + L::DS;
  float* rows_sm = reinterpret_cast<float*>(gen + L::ROWS);  // [2][lse, D][WT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, cq = (lane & 3) * 2;
  const int kl[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};  // key rows, then query rows of dQ
  const int items = B * H;
  const int nt = (int)blockIdx.x < items ? (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  auto load = [&](int t) {
    const int it = blockIdx.x + t * gridDim.x, b = it / H, h = it % H, st = t & 1;
    const uint32_t s0 = base + st * L::STAGE;
    uint8_t* g0 = gen + st * L::STAGE;
    load_tile<DH, VEC>(s0, g0, k + b * ks.sb + (long long)h * dh, ks.st, 0, Tk, dh);
    load_tile<DH, VEC>(s0 + L::TILE, g0 + L::TILE, v + b * vs.sb + (long long)h * dh, vs.st, 0, Tk, dh);
    load_tile<DH, VEC>(s0 + 2 * L::TILE, g0 + 2 * L::TILE, q + b * qs.sb + (long long)h * dh, qs.st, 0, Tq, dh);
    load_tile<DH, VEC>(s0 + 3 * L::TILE, g0 + 3 * L::TILE, dout + ((long long)b * Tq * H + h) * dh, (long long)H * dh,
                       0, Tq, dh);
    const float* src = tid < WT ? lse : dd;
    const int r = tid % WT;
    const bool in = r < Tq;
    cp_async4(smem_u32(rows_sm + st * 2 * WT + tid), in ? src + ((long long)b * H + h) * Tq + r : src, in);
  };
  if (nt > 0) load(0);
  cp_async_commit();
  const float inv_tk = 1.f / Tk;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // item t has landed everywhere; every warp is done with item t - 1
    if (t + 1 < nt) load(t + 1);
    cp_async_commit();
    const int it = blockIdx.x + t * gridDim.x, b = it / H, h = it % H;
    const uint32_t k_s = base + (t & 1) * L::STAGE, v_s = k_s + L::TILE, q_s = v_s + L::TILE, do_s = q_s + L::TILE;
    bool key_ok[2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
      key_ok[half] = kl[half] < Tk && (mask == nullptr || mask[(long long)b * Tk + kl[half]] != 0);

    float s[32], dp[32];
    transposed_grads<DH>(k_s, v_s, q_s, do_s, dh, rows_sm + (t & 1) * 2 * WT, 0, Tq, 0, kl, key_ok, causal, cq,
                         scale, mask_value, inv_tk, [](int, int) { return 0.f; }, s, dp);
    uint32_t pa[4][4], ga[4][4];
    pack_a(s, pa);
    pack_a(dp, ga);
    // dS^T, rounded, into the shared tile: row = key, two neighbouring queries a word
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(gen + L::DS + swz_off(kl[half], j) + cq * 2) = ga[j >> 1][(j & 1) * 2 + half];
    float dka[NS][32], dva[NS][32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        wgmma_m64n64k16_rs<1>(dva[n], pa[kk], wgmma_desc(do_s + n * SUB + kk * 16 * 128), kk > 0);
        wgmma_m64n64k16_rs<1>(dka[n], ga[kk], wgmma_desc(q_s + n * SUB + kk * 16 * 128), kk > 0);
      }
    wgmma_commit();
    fence_async_shared();
    __syncthreads();  // the dS^T tile is written
    float dqa[NS][32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        wgmma_m64n64k16_ss<1, 1>(dqa[n], wgmma_desc(ds_s + kk * 16 * 128), wgmma_desc(k_s + n * SUB + kk * 16 * 128),
                                 kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      fence_regs(dva[n]);
      fence_regs(dka[n]);
      fence_regs(dqa[n]);
    }
    fence_frags(pa);
    fence_frags(ga);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = kl[half];
      if (r < Tk) {
        store_row(dk + b * dks.sb + r * dks.st + (long long)h * dh, dka, half, cq, dh, scale, kv_pairs);
        store_row(dv + b * dvs.sb + r * dvs.st + (long long)h * dh, dva, half, cq, dh, 1.f, kv_pairs);
      }
      if (r < Tq) store_row(dq + b * dqs.sb + r * dqs.st + (long long)h * dh, dqa, half, cq, dh, scale, q_pairs);
    }
  }
  cp_async_wait<0>();
}

// ---- D = rowsum(dO * O) for bf16 rows of 8 x 2^i elements: CH lanes a row,
// one 16-byte chunk of each operand a lane, the row's sum by shuffles
template <int CH>
__global__ void __launch_bounds__(256) rowsum_vec_kernel(const __nv_bfloat16* __restrict__ dout,
                                                         const __nv_bfloat16* __restrict__ out,
                                                         float* __restrict__ dd, int B, int Tq, int H) {
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / CH;
  const int c = threadIdx.x % CH;
  const bool in = row < (long long)B * Tq * H;
  float acc = 0.f;
  if (in) {
    float a[8], o[8];
    unpack16<__nv_bfloat16>(ldg16(reinterpret_cast<uintptr_t>(dout + (row * CH + c) * 8)), a);
    unpack16<__nv_bfloat16>(ldg16(reinterpret_cast<uintptr_t>(out + (row * CH + c) * 8)), o);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(a[i], o[i], acc);
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && c == 0) {  // row = (b * Tq + q) * H + h  ->  dd[(b * H + h) * Tq + q]
    const long long h = row % H, bq = row / H, qq = bq % Tq, b = bq / Tq;
    dd[(b * H + h) * Tq + qq] = acc;
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

// the shared bias's gradient: the per-batch rows in the scratch, summed in batch order
cudaError_t batch_sum(const Args& a, cudaStream_t stream) {
  const long long n = (long long)a.H * a.Tq * a.Tk;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 4 * 132 * 8);
  batch_sum_kernel<<<blocks, 256, 0, stream>>>(a.dbias_scratch, a.dbias, a.B, n);
  return cudaGetLastError();
}

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
  return batch_sum(a, stream);
}

// f32 rows: the SIMT kernels, dh padded to 32, 64 or 128
template <typename BT>
cudaError_t launch_f32(const Args& a, cudaStream_t s) {
  if (a.dh <= 32) return launch<float, BT, 32>(a, s);
  if (a.dh <= 64) return launch<float, BT, 64>(a, s);
  if (a.dh <= 128) return launch<float, BT, 128>(a, s);
  return cudaErrorInvalidValue;
}

template <typename K>
cudaError_t big_smem(K kern, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that as many blocks as the rings allow are resident
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// D for bf16 rows: 16-byte chunks where dh is 8, 16, 32, 64 or 128 and the rows are aligned
cudaError_t rowsum_bf16(const Args& a, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const bf16* out = static_cast<const bf16*>(a.out);
  const long long rows = (long long)a.B * a.Tq * a.H;
  const bool vec = ((reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  auto grid = [&](int ch) { return (unsigned)((rows * ch + 255) / 256); };
  switch (vec ? a.dh : 0) {
    case 8: rowsum_vec_kernel<1><<<grid(1), 256, 0, s>>>(dout, out, a.dd, a.B, a.Tq, a.H); break;
    case 16: rowsum_vec_kernel<2><<<grid(2), 256, 0, s>>>(dout, out, a.dd, a.B, a.Tq, a.H); break;
    case 32: rowsum_vec_kernel<4><<<grid(4), 256, 0, s>>>(dout, out, a.dd, a.B, a.Tq, a.H); break;
    case 64: rowsum_vec_kernel<8><<<grid(8), 256, 0, s>>>(dout, out, a.dd, a.B, a.Tq, a.H); break;
    case 128: rowsum_vec_kernel<16><<<grid(16), 256, 0, s>>>(dout, out, a.dd, a.B, a.Tq, a.H); break;
    default: rowsum_kernel<bf16><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(dout, out, a.dd, a.B, a.Tq, a.H, a.dh);
  }
  return cudaGetLastError();
}

// two neighbouring columns of each row of an output stored as one 4-byte word
inline int pairs(const Strides& s, const void* p, int dh) {
  return dh % 2 == 0 && s.sb % 2 == 0 && s.st % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

// one key tile and one query tile per head, no bias, no GQA: the one-pass kernel
inline bool short_rows(const Args& a) {
  return a.Tq <= WT && a.Tk <= WT && a.H == a.Hkv && a.bias == nullptr;
}

// bf16 rows: the one-pass kernel for short rows, else the two wgmma passes;
// dh padded to 64 or 128
template <typename BT, int DH, bool VEC>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t err = rowsum_bf16(a, stream);
  if (err != cudaSuccess) return err;

  auto aligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; };
  const int bias_vec = a.bias != nullptr && a.Tk % (16 / (int)sizeof(BT)) == 0 && aligned(a.bias, 16);
  const int bias_pairs = a.Tk % 2 == 0 && aligned(a.bias, 2 * sizeof(BT));
  const int kv_pairs = pairs(a.dks, a.dk, a.dh) && pairs(a.dvs, a.dv, a.dh), q_pairs = pairs(a.dqs, a.dq, a.dh);
  if (short_rows(a)) {
    auto k0 = flash_bwd_short_wgmma_kernel<DH, VEC>;
    constexpr int smem0 = ShortSmem<DH>::BYTES;
    err = big_smem(k0, smem0);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int blocks = std::min(a.B * a.H, 3 * sms);  // the blocks resident at once; each walks its items
    k0<<<blocks, 128, smem0, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const bf16*>(a.dout), a.lse, a.dd, static_cast<const uint8_t*>(a.mask), static_cast<bf16*>(a.dq),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.B, a.H, a.Tq, a.Tk, a.dh, a.qs, a.ks, a.vs, a.dqs,
        a.dks, a.dvs, a.scale, a.causal, a.mask_value, q_pairs, kv_pairs);
    return cudaGetLastError();
  }

  auto k1 = flash_bwd_dkv_wgmma_kernel<BT, DH, VEC>;
  constexpr int smem1 = DkvSmem<BT, DH>::BYTES;
  err = big_smem(k1, smem1);
  if (err != cudaSuccess) return err;
  k1<<<dim3((a.Tk + WT - 1) / WT, a.Hkv, a.B), 128, smem1, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.dd, static_cast<const uint8_t*>(a.mask),
      static_cast<const BT*>(a.bias), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.Hkv, a.Tq,
      a.Tk, a.dh, a.qs, a.ks, a.vs, a.dks, a.dvs, a.bias_batched, a.scale, a.causal, a.mask_value, bias_vec,
      kv_pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto k2 = flash_bwd_dq_wgmma_kernel<BT, DH, VEC>;
  constexpr int smem2 = DqSmem<DH>::BYTES;
  err = big_smem(k2, smem2);
  if (err != cudaSuccess) return err;
  k2<<<dim3((a.Tq + WT - 1) / WT, a.H, a.B), 128, smem2, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.dd, static_cast<const uint8_t*>(a.mask),
      static_cast<const BT*>(a.bias), static_cast<bf16*>(a.dq), a.bias_batched ? a.dbias : nullptr, a.H, a.Hkv,
      a.Tq, a.Tk, a.dh, a.qs, a.ks, a.vs, a.dqs, a.bias_batched, a.scale, a.causal, a.mask_value, bias_pairs,
      q_pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.bias == nullptr || a.bias_batched) return err;

  auto k3 = flash_bwd_dbias_wgmma_kernel<BT, DH, VEC>;
  constexpr int smem3 = DbSmem<DH>::BYTES;
  err = big_smem(k3, smem3);
  if (err != cudaSuccess) return err;
  k3<<<dim3((a.Tq + WT - 1) / WT, (a.Tk + WT - 1) / WT, a.H), 128, smem3, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.dd, static_cast<const uint8_t*>(a.mask),
      static_cast<const BT*>(a.bias), a.dbias, a.B, a.H, a.Hkv, a.Tq, a.Tk, a.dh, a.qs, a.ks, a.vs, a.scale,
      a.causal, a.mask_value, bias_pairs);
  return cudaGetLastError();
}

// 16-byte copies where every row of q, k, v and dO starts on a 16-byte
// boundary, plain loads elsewhere
template <typename BT>
cudaError_t launch_bf16(const Args& a, cudaStream_t s) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto rows16 = [](const Strides& t) { return t.sb % 8 == 0 && t.st % 8 == 0; };
  const bool vec = a.dh % 8 == 0 && rows16(a.qs) && rows16(a.ks) && rows16(a.vs) && aligned(a.q) &&
                   aligned(a.k) && aligned(a.v) && aligned(a.dout);
  if (a.dh <= 64) return vec ? launch_wgmma<BT, 64, true>(a, s) : launch_wgmma<BT, 64, false>(a, s);
  if (a.dh <= 128) return vec ? launch_wgmma<BT, 128, true>(a, s) : launch_wgmma<BT, 128, false>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Tq, H, dh), k/v (B, Tk, Hkv, dh) and the outputs dq (like q), dk/dv
// (like k) given by their batch and token strides in elements (heads and dh
// contiguous); out and dout contiguous (B, Tq, H, dh); lse (B, H, Tq) f32;
// mask (B, Tk) uint8 or null; bias (1|B, H, Tq, Tk) contiguous or null;
// dbias (1|B, H, Tq, Tk) f32 (written when bias is given); dbias_scratch
// (B, H, Tq, Tk) f32 for a batch-shared bias in f32, else null; dd (B, H, Tq)
// f32 scratch. Returns the first error of its launches.
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
  if (bias != nullptr && !bias_batched && dtype == DT_F32 && dbias_scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, dout, mask, bias, static_cast<const float*>(lse), dq, dk, dv,
         static_cast<float*>(dbias), static_cast<float*>(dbias_scratch), static_cast<float*>(dd),
         B, H, Hkv, Tq, Tk, dh, {q_sb, q_st}, {k_sb, k_st}, {v_sb, v_st}, {dq_sb, dq_st},
         {dk_sb, dk_st}, {dv_sb, dv_st}, bias_batched, scale, causal, mask_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DT_F32 && bias_dtype == DT_F32) err = launch_f32<float>(a, s);
  else if (dtype == DT_F32 && bias_dtype == DT_BF16) err = launch_f32<__nv_bfloat16>(a, s);
  else if (dtype == DT_BF16 && bias_dtype == DT_F32) err = launch_bf16<float>(a, s);
  else if (dtype == DT_BF16 && bias_dtype == DT_BF16) err = launch_bf16<__nv_bfloat16>(a, s);
  return (int)err;
}
