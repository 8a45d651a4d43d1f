// K2: online-softmax attention forward (flash), with key mask, additive bias
// (batch-shared or per batch, f32 or bf16), causal, scale, GQA and the
// per-row log-sum-exp.
//
// Replaces the TPU kernels `_flash_kernel` / `_flash_kernel_single` (and
// their `_nobias` forms) of rag_docvqa_tpu/ops/flash_attention.py, called
// from `_fwd_call_impl` / `_fwd_call_single`. The same kernel, with
// mask_value = -1e9, is the attention part of the T5 layer (K1,
// t5_layer.cu; without a bias also K13, `_t5_layer_kernel_qtiled`), where
// the TPU kernel masks with -1e9 and so gives a uniform softmax on a row
// with no valid key; with mask_value = -1e30 such a row
// gives zeros and lse = -1e30, the flash contract.
//
// What bounds it on the H100: at t5-base (T 512, dh 64) attention is
// 4*B*H*T*T*dh FLOPs against B*H*T*dh*8 bytes of q/k/v/o, ~64 FLOP/byte in
// bf16, so by the card's table it is bound by bytes only barely and in
// practice by the instruction rate of the two products and the softmax between.
// The (H, T, T) bias is read from global memory for every batch row, never
// expanded per batch: at t5-base its 6 MB stay in the 50 MB L2.
//
// bf16 rows (flash_fwd_wgmma_kernel): one warpgroup per block owns 64 query
// rows of one head. Both products run on the tensor cores through
// wgmma.mma_async m64n64k16: S = Q K^T with Q and the K tile read K-major from
// 128-byte-swizzled shared tiles (hopper.cuh); O += P V with V as the B operand
// in its natural [keys][dh] layout (MN-major, the transposed-B form) and P as
// the A operand straight from registers: the accumulator layout of S, packed
// to bf16 pairs, is the A fragment of the next product, so P never touches
// shared memory. The softmax lives on the f32 accumulators where they lie:
// scale, bias (read from global/L2 in the accumulator's layout, asked for while
// the first product runs), mask, row maximum and sum by two quad shuffles, the
// rescale of O by alpha. K/V tiles of 64 keys come through a ring of FST
// stages filled by 16-byte cp.async, two tiles in flight while one is
// worked on; rows past Tk and columns past dh are zero-filled, so any dh <=
// 256 runs in the 64-, 128- or 256-wide instantiation. Inputs whose rows are not
// 16-byte aligned (dh % 8 != 0, odd strides) fill the same tiles with plain
// loads. A tile's key-mask bytes are folded with the Tk bound into one code
// per key in shared memory. Three blocks fit an SM (57 KB each at dh 64), so
// one block's softmax overlaps another's products.
// dh 256 (the Gemma rerankers, TPU block sizing at flash_attention.py:976-1016
// of the JAX package): the same kernel with four 64-column tiles across dh.
// Its ring takes 230,592 bytes of shared memory, just under the 232,448 one
// block may opt into, so one block an SM; launch bounds (128, 1) let its O
// accumulator (64 x 256 f32: 128 registers a thread) sit in registers beside S
// and P.
// Cast points, as the TPU kernel's: f32 scores, p rounded to bf16 before p @ v,
// the row sum l over the unrounded p, f32 accumulation, the division by
// max(l, 1e-30) last. exp(x - m) is ex2.approx.ftz of (x - m) * log2 e, the
// instruction __expf lowers to (2 ulp), inside the 2e-2 the bf16 output is held to.
//
// f32 rows (flash_fwd_kernel) keep the exact SIMT design, since the tensor
// cores have no exact f32 product: one block per (32-query tile, head, batch
// row); 128 threads, four per query row. Key/value tiles of 64 rows (32 at
// dh 256) are staged in shared memory as f32; each thread keeps 16 (8) scores
// and dh/4 output columns, as groups of four neighbours, in registers, and
// reads Q, K and V from shared memory four floats at a time; the row's running
// max and sum are combined across its four threads with warp shuffles; expf.
// Every sum runs in the order of a one-float-at-a-time loop. At dh 256 (dh
// 129-256 padded to it) a block takes 103,552 bytes of shared memory, so two
// blocks fit an SM, and each thread 64 accumulators.
//
// Neither uses atomics: the same input gives the same bits on every run.
#include "hopper.cuh"

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int NT = 128;  // threads per block, four per query row
constexpr float NEG_INF = -1e30f;
constexpr float EXCLUDED = -3.402823466e38f;  // key past Tk: never weighted

// keys per tile: 64, and 32 at dh 256, so that two blocks fit an SM there
template <int DH>
__host__ __device__ constexpr int bkt() { return DH > 128 ? 32 : 64; }
// row stride of the Q and K tiles: 16-byte aligned for float4 reads, and
// 4 banks apart, so the four keys (and the eight query rows) a warp reads at
// one d lie in distinct banks
template <int DH>
__host__ __device__ constexpr int kstride() { return DH + 4; }

template <int DH>
constexpr int smem_floats() {
  return BQ * kstride<DH>() + bkt<DH>() * kstride<DH>() + bkt<DH>() * DH + BQ * (bkt<DH>() + 1);
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
  constexpr int BKT = bkt<DH>(), KS = kstride<DH>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][KS]
  float* Ks = Qs + BQ * KS;      // [BKT][KS]
  float* Vs = Ks + BKT * KS;     // [BKT][DH]
  float* Ps = Vs + BKT * DH;     // [BQ][BKT + 1]

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
    Qs[rr * KS + d] = (gq < Tq && d < dh) ? to_f(qb[gq * q_st + d]) : 0.f;
  }

  constexpr int NC = BKT / 4;   // scores per thread per tile: keys sub + 4j
  constexpr int NG = DH / 16;   // output column groups per thread: columns 16g + 4 sub .. + 3
  float4 acc[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
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
      Ks[c * KS + d] = in ? to_f(kb[gk * k_st + d]) : 0.f;
      Vs[c * DH + d] = in ? to_f(vb[gk * v_st + d]) : 0.f;
    }
    __syncthreads();

    // q . k over d in order, four columns a float4 read
    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
    const float4* qr = reinterpret_cast<const float4*>(Qs + r * KS);
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 qd = qr[d4];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 kd = reinterpret_cast<const float4*>(Ks + (sub + 4 * j) * KS)[d4];
        s[j] += qd.x * kd.x;
        s[j] += qd.y * kd.y;
        s[j] += qd.z * kd.z;
        s[j] += qd.w * kd.w;
      }
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
    for (int j = 0; j < NG; ++j) {
      acc[j].x *= alpha;
      acc[j].y *= alpha;
      acc[j].z *= alpha;
      acc[j].w *= alpha;
    }
    for (int c = 0; c < BKT; ++c) {
      const float p = Ps[r * (BKT + 1) + c];
      const float4* vr = reinterpret_cast<const float4*>(Vs + c * DH) + sub;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const float4 vd = vr[4 * j];
        acc[j].x += p * vd.x;
        acc[j].y += p * vd.y;
        acc[j].z += p * vd.z;
        acc[j].w += p * vd.w;
      }
    }
  }

  if (qrow < Tq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + (((long long)b * Tq + qrow) * H + h) * dh;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int d = 16 * j + 4 * sub;
      const float o[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < dh) orow[d + e] = from_f<T>(o[e] / denom);
    }
    if (lse != nullptr && sub == 0)
      lse[((long long)b * H + h) * Tq + qrow] = m > NEG_INF * 0.5f ? m + logf(denom) : NEG_INF;
  }
}

// ---- bf16: wgmma, softmax in registers, cp.async ring ----------------------
constexpr int WQ = 64;         // query rows per block: one warpgroup
constexpr int WK = 64;         // keys per tile
constexpr int FST = 3;         // K/V ring stages
constexpr int SUB = 64 * 128;  // bytes of one swizzled 64-row x 64-column bf16 tile

// Q, the ring of K and V tiles, one mask code per key of each stage, and room
// to align the tiles to 1024 bytes
template <int DH>
constexpr int wgmma_smem_bytes() {
  return (DH / 64) * SUB * (1 + 2 * FST) + FST * WK + 1024;
}

template <typename BT, int DH, bool VEC>
__global__ void __launch_bounds__(128, DH == 64 ? 3 : (DH == 128 ? 2 : 1)) flash_fwd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    const BT* __restrict__ bias, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int H, int Hkv, int Tq, int Tk, int dh,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, int bias_batched,
    float scale, int causal, float mask_value, int bias_pairs, int out_pairs) {
  using bf16 = __nv_bfloat16;
  constexpr int NS = DH / 64;            // 64-column tiles across dh
  constexpr int STAGE = 2 * NS * SUB;    // K then V
  extern __shared__ uint8_t flash_smem[];
  const uint32_t raw = smem_u32(flash_smem), base = (raw + 1023u) & ~1023u;
  uint8_t* gen = flash_smem + (base - raw);  // the aligned base as a generic pointer
  const uint32_t q_s = base, ring_s = base + NS * SUB;
  uint8_t* codes = gen + NS * SUB + FST * STAGE;  // [FST][WK]: 0 masked, 1 valid, 2 past Tk

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * WQ;
  const int qr[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};  // this thread's two rows
  const int cq = (lane & 3) * 2;  // its first column within a block of 8

  const bf16* qb = q + b * q_sb + (long long)h * dh;
  const bf16* kb = k + b * k_sb + (long long)hk * dh;
  const bf16* vb = v + b * v_sb + (long long)hk * dh;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Tk : nullptr;

  // 64 rows of `src` from row r0 into NS swizzled tiles at `off` past the
  // base; rows past `rows` and columns past dh are zeros. VEC: 16-byte
  // cp.async, DH / 8 neighbouring threads on one row. Up to dh 128 a pass
  // covers a multiple of 8 rows, so a thread's chunk and its row modulo 8 are
  // the same in every pass, and so is its swizzled offset; at dh 256 a pass
  // covers 4 rows, and the swizzle alternates between two offsets.
  constexpr int CPR = DH / 8, RPP = 128 / CPR;  // chunks a row, rows a pass
  const int ld_c = tid % CPR, ld_r = tid / CPR;
  const uint32_t ld_off = (ld_c >> 3) * SUB + swz_off(ld_r, ld_c & 7);
  const uint32_t ld_off_odd = (ld_c >> 3) * SUB + swz_off(ld_r + RPP, ld_c & 7) - RPP * 128;
  const bool ld_col = ld_c * 8 < dh;
  auto load_rows = [&](uint32_t off, const bf16* src, long long st, int r0, int rows) {
    if (VEC) {
      const bf16* p = src + (long long)(r0 + ld_r) * st + ld_c * 8;
#pragma unroll
      for (int pass = 0; pass < 64 / RPP; ++pass) {
        const bool in = ld_col && r0 + ld_r + pass * RPP < rows;
        const uint32_t o = (RPP % 8 == 0 || pass % 2 == 0) ? ld_off : ld_off_odd;
        cp_async16(base + off + o + pass * RPP * 128, in ? p + (long long)pass * RPP * st : src, in);
      }
    } else {
      for (int i = tid; i < 64 * DH; i += 128) {
        const int row = i / DH, d = i % DH;
        const bool in = r0 + row < rows && d < dh;
        const bf16 val = in ? src[(long long)(r0 + row) * st + d] : __float2bfloat16(0.f);
        *reinterpret_cast<bf16*>(gen + off + (d >> 6) * SUB + swz_off(row, (d & 63) >> 3) + (d & 7) * 2) = val;
      }
    }
  };
  // a tile's K and V rows (asynchronous); its key codes go in two steps, so that
  // the global read of the mask byte is not waited for where it starts
  auto load_kv = [&](int t) {
    const int stage = t % FST, k0 = t * WK;
    load_rows(NS * SUB + stage * STAGE, kb, k_st, k0, Tk);
    load_rows(NS * SUB + stage * STAGE + NS * SUB, vb, v_st, k0, Tk);
  };
  auto read_code = [&](int t) -> uint8_t {  // threads 0..WK-1, one key each
    const int gk = t * WK + tid;
    if (tid >= WK || gk >= Tk) return 2;
    return (mrow == nullptr || mrow[gk] != 0) ? 1 : 0;
  };
  auto write_code = [&](int t, uint8_t code) {
    if (tid < WK) codes[(t % FST) * WK + tid] = code;
  };

  // causal: tiles wholly above the diagonal of this query tile are skipped
  const int k_end = causal ? min(Tk, q0 + WQ) : Tk;
  const int nt = (k_end + WK - 1) / WK;

  load_rows(0, qb, q_st, q0, Tq);
#pragma unroll
  for (int s = 0; s < FST - 1; ++s) {
    if (s < nt) {
      load_kv(s);
      write_code(s, read_code(s));
    }
    cp_async_commit();
  }

  float o[NS][32];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m[2] = {EXCLUDED, EXCLUDED}, l[2] = {0.f, 0.f};

  // this thread's two bias rows (a row past Tq reads row Tq - 1; its scores are never stored)
  const BT* brow[2] = {nullptr, nullptr};
  if (bias != nullptr) {
    const long long bh = ((long long)(bias_batched ? b : 0) * H + h) * Tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) brow[half] = bias + (bh + min(qr[half], Tq - 1)) * Tk + cq;
  }

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<FST - 2>();  // this thread's copies of tile t (and of Q) have landed
    fence_async_shared();
    __syncthreads();  // everyone's have; and every warp is done with tile t - 1
    const int stage = t % FST, k0 = t * WK;
    // the bias of this thread's 32 scores, asked for first so that it arrives under
    // the copies' start and the first product: pairs where the tile lies inside Tk
    // and the rows are 4-byte aligned, else guarded singles
    BiasPair<BT> bz[2][8];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 8; ++j) bz[half][j].zero();
    const bool paired = bias_pairs && k0 + WK <= Tk;
    if (bias != nullptr) {
      if (paired) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < 8; ++j) bz[half][j].pair(brow[half] + k0 + j * 8);
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (k0 + j * 8 + cq + e < Tk) bz[half][j].one(brow[half] + k0 + j * 8 + e, e);
      }
    }
    const bool more = t + FST - 1 < nt;
    if (more) load_kv(t + FST - 1);  // into tile t - 1's stage
    cp_async_commit();
    const uint8_t next_code = more ? read_code(t + FST - 1) : 0;  // stored at the end of this step

    const uint32_t k_s = ring_s + stage * STAGE, v_s = k_s + NS * SUB;

    // S = Q K^T over dh in steps of 16 (steps past dh hold zeros and are skipped)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      if (kk * 16 < dh) {
        const uint32_t step = (kk >> 2) * SUB + (kk & 3) * 32;
        wgmma_m64n64k16_ss<0, 0>(s, wgmma_desc(q_s + step), wgmma_desc(k_s + step), kk > 0);
      }
    wgmma_commit();

    wgmma_wait<0>();
    fence_regs(s);

    // scores: scale and bias, then the key's code decides with one select
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t cm = *reinterpret_cast<const uint16_t*>(codes + stage * WK + j * 8 + cq);
      const float2 bj[2] = {bz[0][j].get(paired), bz[1][j].get(paired)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t code = cm >> (8 * e);
        const bool valid = (code & 1u) != 0;
        const float off = (code & 2u) != 0 ? EXCLUDED : mask_value;  // what a key that is not attended scores
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = j * 4 + half * 2 + e;
          s[i] = valid ? fmaf(s[i], scale, e ? bj[half].y : bj[half].x) : off;
        }
      }
    }
    // causal: only a tile that reaches the diagonal compares key and query rows
    if (causal && k0 + WK - 1 > q0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int gk = k0 + (i >> 2) * 8 + cq + (i & 1);
        if (gk > qr[(i >> 1) & 1] && s[i] != EXCLUDED) s[i] = mask_value;
      }
    }
    float tmax[2] = {EXCLUDED, EXCLUDED};
#pragma unroll
    for (int i = 0; i < 32; ++i) tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
    // exp(x - m) as ex2((x - m) * log2 e): the instruction __expf lowers to. The
    // difference is taken first, so it is exact where x == m whatever their size
    // (a row of mask_value -1e9). A key past Tk (EXCLUDED) and every key of a row
    // with no valid key yet (m_use = +max) underflow to exactly 0, so no score
    // needs a select here.
    constexpr float LOG2E = 1.4426950408889634f;
    float alpha[2], m_use[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m[half], quad_max(tmax[half]));
      // a row with no valid key so far keeps exp(0) = 1 out of the sums
      const bool alive = m_new > NEG_INF * 0.5f;
      alpha[half] = alive ? exp2f_approx((m[half] - m_new) * LOG2E) : 0.f;
      m_use[half] = alive ? m_new : 3.402823466e38f;
      m[half] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      const float p = exp2f_approx((s[i] - m_use[half]) * LOG2E);
      psum[half] += p;  // the sum takes p before it is rounded
      s[i] = p;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * alpha[half] + quad_sum(psum[half]);

    // P as the A operand: column blocks 2kk and 2kk + 1 are the 16 keys of step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[kk * 8 + 0], s[kk * 8 + 1]);
      pa[kk][1] = pack_bf16(s[kk * 8 + 2], s[kk * 8 + 3]);
      pa[kk][2] = pack_bf16(s[kk * 8 + 4], s[kk * 8 + 5]);
      pa[kk][3] = pack_bf16(s[kk * 8 + 6], s[kk * 8 + 7]);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] *= alpha[(i >> 1) & 1];
      fence_regs(o[n]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        wgmma_m64n64k16_rs<1>(o[n], pa[kk], wgmma_desc(v_s + n * SUB + kk * 16 * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NS; ++n) fence_regs(o[n]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i])::"memory");
    if (more) write_code(t + FST - 1, next_code);  // read after a later step's barrier
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qrow = qr[half];
    if (qrow >= Tq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    bf16* orow = out + (((long long)b * Tq + qrow) * H + h) * dh;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = n * 64 + j * 8 + cq;
        const float v0 = o[n][j * 4 + half * 2] / denom, v1 = o[n][j * 4 + half * 2 + 1] / denom;
        if (out_pairs && d + 1 < dh) {
          *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16(v0, v1);
        } else {
          if (d < dh) orow[d] = __float2bfloat16(v0);
          if (d + 1 < dh) orow[d + 1] = __float2bfloat16(v1);
        }
      }
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * H + h) * Tq + qrow] = m[half] > NEG_INF * 0.5f ? m[half] + logf(denom) : NEG_INF;
  }
}

template <typename BT, int DH, bool VEC>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* mask,
                         const void* bias, void* out, void* lse, int B, int H, int Hkv,
                         int Tq, int Tk, int dh, long long q_sb, long long q_st,
                         long long k_sb, long long k_st, long long v_sb, long long v_st,
                         int bias_batched, float scale, int causal, float mask_value,
                         cudaStream_t stream) {
  constexpr int smem = wgmma_smem_bytes<DH>();
  auto kern = flash_fwd_wgmma_kernel<BT, DH, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that as many blocks as the ring allows are resident
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  auto aligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; };
  // pair loads and stores need even offsets
  const int bias_pairs = Tk % 2 == 0 && aligned(bias, 2 * sizeof(BT));
  const int out_pairs = dh % 2 == 0 && aligned(out, 4);
  dim3 grid((Tq + WQ - 1) / WQ, H, B);
  kern<<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const BT*>(bias), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      H, Hkv, Tq, Tk, dh, q_sb, q_st, k_sb, k_st, v_sb, v_st, bias_batched, scale, causal,
      mask_value, bias_pairs, out_pairs);
  return cudaGetLastError();
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
  // all of the SM's shared memory, so that two dh-256 blocks (103,552 bytes each) are resident
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const BT*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), H, Hkv, Tq, Tk, dh,
      q_sb, q_st, k_sb, k_st, v_sb, v_st, bias_batched, scale, causal, mask_value);
  return cudaGetLastError();
}

#define FLASH_PARAMS                                                                          \
  const void *q, const void *k, const void *v, const void *mask, const void *bias, void *out, \
      void *lse, int B, int H, int Hkv, int Tq, int Tk, int dh, long long q_sb, long long q_st, \
      long long k_sb, long long k_st, long long v_sb, long long v_st, int bias_batched,      \
      float scale, int causal, float mask_value, cudaStream_t s
#define FLASH_ARGS q, k, v, mask, bias, out, lse, B, H, Hkv, Tq, Tk, dh, q_sb, q_st, \
                   k_sb, k_st, v_sb, v_st, bias_batched, scale, causal, mask_value, s

// f32 rows: the SIMT kernel, dh padded to 32, 64, 128 or 256
template <typename BT>
cudaError_t launch_f32(FLASH_PARAMS) {
  if (dh <= 32) return launch<float, BT, 32>(FLASH_ARGS);
  if (dh <= 64) return launch<float, BT, 64>(FLASH_ARGS);
  if (dh <= 128) return launch<float, BT, 128>(FLASH_ARGS);
  if (dh <= 256) return launch<float, BT, 256>(FLASH_ARGS);
  return cudaErrorInvalidValue;
}

// bf16 rows: the wgmma kernel, dh padded to 64, 128 or 256; 16-byte copies where
// every row of q, k and v starts on a 16-byte boundary, plain loads elsewhere
template <typename BT>
cudaError_t launch_bf16(FLASH_PARAMS) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = dh % 8 == 0 && q_sb % 8 == 0 && q_st % 8 == 0 && k_sb % 8 == 0 && k_st % 8 == 0 &&
                   v_sb % 8 == 0 && v_st % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  if (dh <= 64) return vec ? launch_wgmma<BT, 64, true>(FLASH_ARGS) : launch_wgmma<BT, 64, false>(FLASH_ARGS);
  if (dh <= 128) return vec ? launch_wgmma<BT, 128, true>(FLASH_ARGS) : launch_wgmma<BT, 128, false>(FLASH_ARGS);
  if (dh <= 256) return vec ? launch_wgmma<BT, 256, true>(FLASH_ARGS) : launch_wgmma<BT, 256, false>(FLASH_ARGS);
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
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DT_F32 && bias_dtype == DT_F32) err = launch_f32<float>(FLASH_ARGS);
  else if (dtype == DT_F32 && bias_dtype == DT_BF16) err = launch_f32<__nv_bfloat16>(FLASH_ARGS);
  else if (dtype == DT_BF16 && bias_dtype == DT_F32) err = launch_bf16<float>(FLASH_ARGS);
  else if (dtype == DT_BF16 && bias_dtype == DT_BF16) err = launch_bf16<__nv_bfloat16>(FLASH_ARGS);
  return (int)err;
}
