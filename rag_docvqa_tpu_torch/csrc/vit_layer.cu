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
// probabilities before it knows their sum). A row with no valid key gives the
// uniform softmax over the T real keys, as on the TPU.
//
// What bounds it on the H100: the GEMMs. At ViT-base (d 768, mlp 3072, B 32,
// T 197) a layer is ~90 GFLOP of products and 3.8 GFLOP of attention over
// ~70 MB of activations and weights, far above the ridge point; the GEMM is
// gemm_fwd.cuh's template (bf16: wgmma.mma_async from a cp.async ring; f32:
// SIMT, exact). The attention reads 3 B T d and writes B T d elements for
// 4 B T^2 d operations, ~50 FLOP per byte at T 197: by the card's table bound
// by bytes, in practice by the instruction rate of its softmax. Its bf16 rows
// (vit_attention_wgmma_kernel) are K2's design with the exact softmax:
//   - one warpgroup per (batch row, head, 64-query tile); Q and a chunk of up
//     to 256 keys (128 at dh 128) of K and V come through 16-byte cp.async into
//     128-byte-swizzled tiles (hopper.cuh), K then V in two groups, so S = Q K^T
//     runs while V lands; rows past T and columns past dh are zero-filled;
//   - S on the tensor cores, wgmma m64n256k16 (or n128) from Q and K K-major:
//     the whole score row of a thread's two query rows stays in its 128
//     accumulator registers. Scale, bias, mask, the row maximum and sum (two
//     quad shuffles), exp(s - max), the f32 division by the sum (correctly
//     rounded, div_by_sum) and the cast to bf16 happen where the scores lie;
//     the packed P is the A fragment of O = P V (wgmma m64n64k16 from
//     registers, V MN-major), as in K2;
//   - a key past T is excluded from the row (never weighted), a masked key
//     scores -1e30: a row with no valid key is then the uniform average over
//     the T real keys, not over the padding;
//   - the rel-pos bias (H, T, Tb) bf16, its rows padded to Tb % 8 == 0 by
//     fuse_vit_blocks, comes with K through the same 16-byte copies into a
//     shared tile, read as bf16 pairs in the accumulator's layout;
//   - longer rows (T > 256, or T > 128 at dh 128) take two passes over the
//     key chunks: the first finds each row's maximum and sum (QK^T only, online),
//     the second recomputes each chunk's scores, divides, casts and multiplies
//     by V. Nothing of a row is kept in shared memory, so T has no limit.
// The f32 rows keep the exact SIMT kernel (vit_attention_kernel), whose whole
// score row of 32 queries lies in shared memory (T up to ~1,600). The
// LayerNorm is bound by memory.
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

// ---- f32: attention with the whole score row in shared memory -----------------
constexpr int BQ = 32;   // query rows per block
constexpr int BKT = 64;  // keys per staged tile
constexpr int NT = 128;  // threads per block, four per query row
constexpr float VIT_MASKED = -1e30f;

// shared floats: Q tile, one K or V tile, the score rows (stride Tk + 1)
template <int DH>
int attn_smem_floats(int Tk) { return BQ * (DH + 1) + BKT * (DH + 1) + BQ * (Tk + 1); }

template <typename T, int DH>
__global__ void __launch_bounds__(NT) vit_attention_kernel(
    const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ bias, T* __restrict__ out, int H, int Tn, int dh,
    int bias_ld, float scale) {
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
      (bias != nullptr && qrow < Tn) ? bias + ((long long)h * Tn + qrow) * bias_ld : nullptr;
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
      Ss[r * SLD + gk] = mrow[gk] != 0 ? x : VIT_MASKED;
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

template <int DH>
cudaError_t launch_attention_f32(const void* qkv, const void* mask, const void* bias, void* out, int B, int H,
                                 int Tn, int dh, int bias_ld, float scale, cudaStream_t s) {
  const int smem = attn_smem_floats<DH>(Tn) * (int)sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = vit_attention_kernel<float, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((Tn + BQ - 1) / BQ, H, B), NT, smem, s>>>(
      static_cast<const float*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const __nv_bfloat16*>(bias), static_cast<float*>(out), H, Tn, dh, bias_ld, scale);
  return cudaGetLastError();
}

// ---- bf16: wgmma, the exact softmax in registers ------------------------------
constexpr int VQ = 64;          // query rows per block: one warpgroup
constexpr int VSUB = 64 * 128;  // bytes of one swizzled 64-row x 64-column bf16 tile
constexpr float EXCLUDED = -3.402823466e38f;  // key past T: never weighted

// Shared memory of one block: Q [NS][64 rows], K and V [NS][CH rows] of 128
// bytes, the bias tile [64][CH] bf16 with 16 bytes of skew a row (so the eight
// rows a warp reads at once fall in different banks), one code per key.
template <int DH> struct VitTile {
  static constexpr int NS = DH / 64;               // 64-column tiles across dh
  static constexpr int CH = DH == 64 ? 256 : 128;  // keys a chunk: CH / 2 score registers a thread
  static constexpr int KV_BYTES = NS * CH * 128;   // one chunk of K or of V
  static constexpr int BIAS_LD = CH * 2 + 16;      // bytes a bias row
  static constexpr int BIAS_OFF = NS * VSUB + 2 * KV_BYTES;
  static constexpr int SMEM_NO_BIAS = BIAS_OFF + CH + 1024;  // + room to align Q to 1024 bytes
  static constexpr int SMEM_BIAS = SMEM_NO_BIAS + VQ * BIAS_LD;
};

// a / b correctly rounded, for 0 <= a <= 1 <= b (a probability over its row's
// sum): with y = RN(1 / b) (rcp.rn), q = RN(a y), the residual a - b q exact
// through an FMA, RN(q + (a - b q) y) is RN(a / b) wherever a / b is a normal
// number (Markstein's theorem), and a = 0 gives 0. It takes the place of
// div.rn.f32, which sends every zero numerator (the padded keys of a row) to
// its slow path; a subnormal quotient may differ from div.rn's in its last bit.
__device__ __forceinline__ float div_by_sum(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return fmaf(fmaf(-q, b, a), y, q);
}

template <int DH, bool VEC, bool TWO_PASS>
__global__ void __launch_bounds__(128, 2) vit_attention_wgmma_kernel(
    const __nv_bfloat16* __restrict__ qkv, const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int H, int T, int dh, int bias_ld, float scale, int out_pairs) {
  using bf16 = __nv_bfloat16;
  using Tile = VitTile<DH>;
  constexpr int NS = Tile::NS, CH = Tile::CH, NSC = CH / 2;  // NSC: score registers a thread
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t vit_smem[];
  const uint32_t raw = smem_u32(vit_smem), base = (raw + 1023u) & ~1023u;
  uint8_t* gen = vit_smem + (base - raw);  // the aligned base as a generic pointer
  const uint32_t q_s = base, k_s = base + NS * VSUB, v_s = k_s + Tile::KV_BYTES, bias_s = base + Tile::BIAS_OFF;
  uint8_t* codes = gen + Tile::BIAS_OFF + (bias != nullptr ? VQ * Tile::BIAS_LD : 0);  // [CH]: 0 masked, 1 valid, 2 past T

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * VQ;
  const int rt = warp * 16 + (lane >> 2);  // this thread's first row in the tile; the second is rt + 8
  const int cq = (lane & 3) * 2;           // its first column within a block of 8
  const int d = H * dh;
  const long long tok = 3LL * d;  // elements per token of qkv (B, T, 3, H, dh)
  const bf16* qb = qkv + (long long)b * T * tok + (long long)h * dh;
  const bf16* kb = qb + d;
  const bf16* vb = qb + 2 * d;
  const uint8_t* mrow = mask + (long long)b * T;

  // `rows` rows of `src` (token stride tok) from token r0 into NS swizzled tiles
  // of `trows` rows at `off`; tokens past T and columns past dh are zeros. VEC:
  // 16-byte cp.async, DH / 8 neighbouring threads on one row, whose chunk and
  // row modulo 8 are the same in every pass; else plain element loads.
  constexpr int CPR = DH / 8, RPP = 128 / CPR;  // chunks a row, rows a pass
  const int ld_c = tid % CPR, ld_r = tid / CPR;
  const bool ld_col = ld_c * 8 < dh;
  auto load_rows = [&](uint32_t off, int trows, const bf16* src, int r0, int rows) {
    if (VEC) {
      const uint32_t o = off + (ld_c >> 3) * trows * 128 + swz_off(ld_r, ld_c & 7);
      const bf16* p = src + (long long)(r0 + ld_r) * tok + ld_c * 8;
      for (int pass = 0; pass < rows / RPP; ++pass) {
        const bool in = ld_col && r0 + ld_r + pass * RPP < T;
        cp_async16(o + pass * RPP * 128, in ? p + (long long)pass * RPP * tok : src, in);
      }
    } else {
      for (int i = tid; i < rows * DH; i += 128) {
        const int row = i / DH, c = i % DH;
        const bool in = r0 + row < T && c < dh;
        const bf16 val = in ? src[(long long)(r0 + row) * tok + c] : __float2bfloat16(0.f);
        *reinterpret_cast<bf16*>(gen + (off - base) + (c >> 6) * trows * 128 + swz_off(row, (c & 63) >> 3) +
                                 (c & 7) * 2) = val;
      }
    }
  };
  // chunk c: K (with the bias tile and the key codes) as one cp.async group, V
  // (when asked for) as the next; the caller has made sure the chunk's buffers
  // are no longer read
  auto load_chunk = [&](int c, bool with_v) {
    const int k0 = c * CH;
    load_rows(k_s, CH, kb, k0, CH);
    if (bias != nullptr) {
      // 64 query rows x CH keys, 16-byte copies (bias_ld % 8 == 0); past T zeros
      constexpr int BC = CH / 8, BR = 128 / BC;  // chunks a row, rows a pass
      const int bc = tid % BC, br = tid / BC;
      const bool col_in = k0 + bc * 8 < T;
      const bf16* p = bias + ((long long)h * T + q0 + br) * bias_ld + k0 + bc * 8;
#pragma unroll
      for (int pass = 0; pass < VQ / BR; ++pass) {
        const bool in = col_in && q0 + br + pass * BR < T;
        cp_async16(bias_s + (br + pass * BR) * Tile::BIAS_LD + bc * 16, in ? p + (long long)pass * BR * bias_ld : bias,
                   in);
      }
    }
    for (int i = tid; i < CH; i += 128) {
      const int gk = k0 + i;
      codes[i] = gk >= T ? 2 : (mrow[gk] != 0 ? 1 : 0);
    }
    cp_async_commit();
    if (with_v) load_rows(v_s, CH, vb, k0, CH);
    cp_async_commit();
  };
  // the loaded chunk's scores into s once its K group has landed: scale, bias, then the
  // key's code decides (valid: the score; masked: -1e30; past T: EXCLUDED)
  auto scores = [&](float (&s)[NSC]) {
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NSC; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      if (kk * 16 < dh) {
        const uint32_t qs = q_s + (kk >> 2) * VSUB + (kk & 3) * 32, ks = k_s + (kk >> 2) * CH * 128 + (kk & 3) * 32;
        if constexpr (CH == 256) wgmma_m64n256k16_ss<0, 0>(s, wgmma_desc(qs), wgmma_desc(ks), kk > 0);
        else wgmma_m64n128k16_ss<0, 0>(s, wgmma_desc(qs), wgmma_desc(ks), kk > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      const uint32_t cm = *reinterpret_cast<const uint16_t*>(codes + j * 8 + cq);
      float2 bj[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if (bias != nullptr) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
          bj[half] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              gen + Tile::BIAS_OFF + (rt + half * 8) * Tile::BIAS_LD + (j * 8 + cq) * 2));
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t code = (cm >> (8 * e)) & 0xffu;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = j * 4 + half * 2 + e;
          s[i] = code == 1u ? fmaf(s[i], scale, e ? bj[half].y : bj[half].x) : (code == 2u ? EXCLUDED : VIT_MASKED);
        }
      }
    }
  };

  // TWO_PASS (T > CH): pass 1 finds each row's maximum and sum, online over the
  // chunks; pass 2 recomputes each chunk's scores with V. Else one chunk holds
  // the whole row and its scores are computed once.
  const int nch = TWO_PASS ? (T + CH - 1) / CH : 1;
  load_rows(q_s, 64, qb, q0, 64);  // joins chunk 0's K group
  float s[NSC];
  float m[2] = {EXCLUDED, EXCLUDED}, l[2] = {0.f, 0.f};
  if constexpr (TWO_PASS) {
    for (int c = 0; c < nch; ++c) {
      if (c > 0) __syncthreads();  // every warp is done with chunk c - 1's K and codes
      load_chunk(c, false);
      scores(s);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float tmax = EXCLUDED;
#pragma unroll
        for (int j = 0; j < CH / 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j * 4 + half * 2], s[j * 4 + half * 2 + 1]));
        const float m_new = fmaxf(m[half], quad_max(tmax));
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < CH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) psum += exp2f_approx((s[j * 4 + half * 2 + e] - m_new) * LOG2E);
        l[half] = l[half] * exp2f_approx((m[half] - m_new) * LOG2E) + quad_sum(psum);
        m[half] = m_new;
      }
    }
  }

  float o[NS][32];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (TWO_PASS) __syncthreads();  // every warp is done with the buffers of the chunk before
    load_chunk(c, true);
    scores(s);
    // p = exp(s - max) / sum in f32, correctly rounded (div_by_sum), then the cast to bf16.
    // exp(x - m) is ex2 of (x - m) * log2 e, the difference taken first: exact 1
    // where x == m (every key of a row with no valid key: -1e30), exactly 0 for
    // a key past T (EXCLUDED) under any maximum
    if constexpr (!TWO_PASS) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float tmax = EXCLUDED;
#pragma unroll
        for (int j = 0; j < CH / 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j * 4 + half * 2], s[j * 4 + half * 2 + 1]));
        m[half] = quad_max(tmax);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < CH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = j * 4 + half * 2 + e;
            s[i] = exp2f_approx((s[i] - m[half]) * LOG2E);
            psum += s[i];
          }
        l[half] = quad_sum(psum);
      }
    }
    // P as the A operand: column blocks 2kk and 2kk + 1 are the 16 keys of step kk
    const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    uint32_t pa[CH / 16][4];
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = kk * 8 + 2 * r, half = r & 1;
        float p0 = s[i], p1 = s[i + 1];
        if (TWO_PASS) {
          p0 = exp2f_approx((p0 - m[half]) * LOG2E);
          p1 = exp2f_approx((p1 - m[half]) * LOG2E);
        }
        pa[kk][r] = pack_bf16(div_by_sum(p0, l[half], inv[half]), div_by_sum(p1, l[half], inv[half]));
      }
    cp_async_wait<0>();  // V
    fence_async_shared();
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NS; ++n) fence_regs(o[n]);
    wgmma_fence();
    const int k0 = c * CH;
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk)
      if (k0 + kk * 16 < T)  // steps wholly past T hold p = 0 against zero rows of V
#pragma unroll
        for (int n = 0; n < NS; ++n)
          wgmma_m64n64k16_rs<1>(o[n], pa[kk], wgmma_desc(v_s + n * CH * 128 + kk * 16 * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NS; ++n) fence_regs(o[n]);
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qrow = q0 + rt + half * 8;
    if (qrow >= T) continue;
    bf16* orow = out + ((long long)b * T + qrow) * d + (long long)h * dh;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n * 64 + j * 8 + cq;
        const float v0 = o[n][j * 4 + half * 2], v1 = o[n][j * 4 + half * 2 + 1];
        if (out_pairs && c + 1 < dh) {
          *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(v0, v1);
        } else {
          if (c < dh) orow[c] = __float2bfloat16(v0);
          if (c + 1 < dh) orow[c + 1] = __float2bfloat16(v1);
        }
      }
  }
}

template <int DH, bool VEC>
cudaError_t launch_attention_bf16(const void* qkv, const void* mask, const void* bias, void* out, int B, int H,
                                  int Tn, int dh, int bias_ld, float scale, cudaStream_t s) {
  using Tile = VitTile<DH>;
  auto kern = Tn > Tile::CH ? vit_attention_wgmma_kernel<DH, VEC, true> : vit_attention_wgmma_kernel<DH, VEC, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BIAS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int smem = bias != nullptr ? Tile::SMEM_BIAS : Tile::SMEM_NO_BIAS;
  const int out_pairs = dh % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  kern<<<dim3((Tn + VQ - 1) / VQ, H, B), 128, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), H, Tn, dh, bias_ld, scale,
      out_pairs);
  return cudaGetLastError();
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
// (B, T) uint8, 1 = a real token; bias (H, T, bias_ld) bf16 shared by the
// batch (the first T columns of each row are read), or null. bf16: dh <= 128;
// with a bias, bias_ld % 8 == 0 and a 16-byte-aligned bias; any T. f32: 32
// score rows of T floats in shared memory, T up to ~1600.
extern "C" int vit_attention(const void* qkv, const void* mask, const void* bias, void* out, int B,
                             int H, int T, int dh, int bias_ld, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > 128 || (bias != nullptr && bias_ld < T)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    if (dh <= 32) return (int)launch_attention_f32<32>(qkv, mask, bias, out, B, H, T, dh, bias_ld, scale, s);
    if (dh <= 64) return (int)launch_attention_f32<64>(qkv, mask, bias, out, B, H, T, dh, bias_ld, scale, s);
    return (int)launch_attention_f32<128>(qkv, mask, bias, out, B, H, T, dh, bias_ld, scale, s);
  }
  if (dtype == DT_BF16) {
    if (bias != nullptr && (bias_ld % 8 != 0 || reinterpret_cast<uintptr_t>(bias) % 16 != 0))
      return (int)cudaErrorInvalidValue;
    // 16-byte copies where every row of q, k and v starts on a 16-byte boundary
    const bool vec = dh % 8 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
    if (dh <= 64)
      return (int)(vec ? launch_attention_bf16<64, true>(qkv, mask, bias, out, B, H, T, dh, bias_ld, scale, s)
                       : launch_attention_bf16<64, false>(qkv, mask, bias, out, B, H, T, dh, bias_ld, scale, s));
    return (int)(vec ? launch_attention_bf16<128, true>(qkv, mask, bias, out, B, H, T, dh, bias_ld, scale, s)
                     : launch_attention_bf16<128, false>(qkv, mask, bias, out, B, H, T, dh, bias_ld, scale, s));
  }
  return (int)cudaErrorInvalidValue;
}
