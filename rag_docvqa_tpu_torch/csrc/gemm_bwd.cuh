// The backward GEMM of the whole-layer kernels, one template for the T5
// layer backward (t5_layer_bwd.cu, K7/K8) and the BERT layer backward
// (bert_layer_bwd.cu, K10), and the fixed-order sums of partial rows both
// use for the gradients that sum over rows.
//
// What bounds it on the H100: operations. At the train step's shapes (4096 x
// 3072 x 768 and the like) a product is hundreds of FLOP per byte, so only
// wgmma reaches the bound. The bf16 kernel is gemm_fwd.cuh's design (GemmTile
// and the cp.async ring in hopper.cuh) for all three layouts:
//   - a 128 x BN output tile per block of two warpgroups, each owning 64 rows and
//     running wgmma.mma_async m64nBNk16 from shared memory with each operand in
//     its own major order: the (M, K) and (N, K) matrices K-major, the (K, M)
//     and (K, N) ones MN-major through wgmma's transpose immediates, a B wider
//     than 64 described atom by atom (wgmma_desc_mn), so no operand is ever
//     transposed in memory;
//   - K steps of 64 in a ring of 128-byte-swizzled stages filled by 16-byte
//     cp.async two steps ahead; copies past M, N or the block's K range are
//     zero-filled, so ragged shapes and split ranges need no second path;
//   - 128 x 128 tiles with two blocks resident on an SM (one block's epilogue
//     and barriers under the other's products; the erf and tanh epilogues are
//     long), 128 x 256 tiles with one block for long K, by gemm_wide_tile's rule;
//   - the epilogue straight from the accumulator registers, two neighbouring
//     columns a thread: each (M, N) operand read and each output written as a
//     bf16 pair or a float2, every cast where the TPU kernel casts.
// The f32 GEMM is a SIMT 64x64 tile, exact f32 (the tensor cores have no
// exact f32 product).
//
// A weight gradient is one GEMM that contracts over all rows (A^T.B). Where
// its output has too few tiles to fill the card (a (384, 384) gradient is 9
// tiles for 132 SMs) the rows are cut into `splits` ranges, one per
// blockIdx.z; each writes its partial product to a scratch (splits, M, N)
// and `column_sum_kernel` adds the partials in range order: deterministic,
// no atomics, whatever the split.
#pragma once

#include "hopper.cuh"

namespace {

// C (M, N) from A and B, f32 accumulation, by layout:
//   NT: A (M, K) . B (N, K)^T   (the forward's)   NN: A (M, K) . B (K, N)
//   TN: A (K, M)^T . B (K, N)   (a weight gradient, contracting over rows)
enum Layout : int { L_NT = 0, L_NN = 1, L_TN = 2 };
enum Epilogue : int {
  E_STORE = 0, E_STORE_F32 = 1, E_ACC_F32 = 2, E_RELU_BWD = 3, E_GELU_BWD = 4,
  E_BIAS_GELU_GRAD = 5, E_MUL_F32 = 6, E_ADD_F32_STORE = 7
};

struct EpiPtrs {
  void* out0;
  void* out1;
  void* out2;
  const void* aux0;
  const void* aux1;
};

// the epilogue on one f32 accumulator at (M, N) offset idx; every output and
// aux is (M, N) row-major
//   store: out0 = cast(acc)       store_f32: out0 = acc      acc_f32: out0 += acc
//   relu_bwd (acc = pre, aux0 = df): out0 = dpre = cast(acc > 0 ? df : 0),
//                                    out1 = f = cast(relu(acc))
//   gelu_bwd (acc = gl, aux0 = u, aux1 = df), with g = cast(acc):
//     out0 = f = cast(cast(gelu(g)) * u), out1 = du = cast(df * gelu(g)),
//     out2 = dgl = cast(df * u * gelu'(g))       (fused_encoder_bwd.py:131-142)
//   bias_gelu_grad (aux0 = bias (N,) in T), with h = acc + bias[col] in f32:
//     out0 = cast(h * cdf), out1 = cdf + h * pdf as f32, cdf from erf32 and
//     pdf from exp                       (fused_encoder_bwd.py::_gelu_erf_and_grad)
//   mul_f32 (aux0 f32): out0 = acc * aux0 as f32, out1 = cast(acc * aux0)
//   add_f32_store (aux0 f32): out0 = cast(aux0 + acc)
// Every element's arithmetic is `epilogue_values`; `epilogue` and the pair
// form (`epilogue_pair_load`, `epilogue_pair_store`) only load its operands and store its results, one element
// or two neighbouring columns at a time, so both give the same bits.
enum AuxKind : int { AUX_NONE = 0, AUX_T = 1, AUX_F32 = 2, AUX_BIAS = 3, AUX_OUT0 = 4 };
__host__ __device__ constexpr int aux0_kind(int epi) {
  return (epi == E_RELU_BWD || epi == E_GELU_BWD) ? AUX_T
         : epi == E_BIAS_GELU_GRAD                 ? AUX_BIAS
         : (epi == E_MUL_F32 || epi == E_ADD_F32_STORE) ? AUX_F32
         : epi == E_ACC_F32                         ? AUX_OUT0
                                                    : AUX_NONE;
}
__host__ __device__ constexpr int aux1_kind(int epi) { return epi == E_GELU_BWD ? AUX_T : AUX_NONE; }
__host__ __device__ constexpr int n_outs(int epi) {
  return epi == E_GELU_BWD ? 3 : (epi == E_RELU_BWD || epi == E_BIAS_GELU_GRAD || epi == E_MUL_F32) ? 2 : 1;
}
__host__ __device__ constexpr bool out_f32(int epi, int i) {
  return i == 0 ? (epi == E_STORE_F32 || epi == E_ACC_F32 || epi == E_MUL_F32) : (i == 1 && epi == E_BIAS_GELU_GRAD);
}

// the values the epilogue stores (before their cast to T where the output is
// in T) from the accumulator and its aux values x0, x1
template <typename T, int EPI>
__device__ __forceinline__ void epilogue_values(float acc, float x0, float x1, float (&v)[3]) {
  if (EPI == E_STORE || EPI == E_STORE_F32) {
    v[0] = acc;
  } else if (EPI == E_ACC_F32 || EPI == E_ADD_F32_STORE) {
    v[0] = x0 + acc;
  } else if (EPI == E_RELU_BWD) {
    v[0] = acc > 0.f ? x0 : 0.f;
    v[1] = fmaxf(acc, 0.f);
  } else if (EPI == E_BIAS_GELU_GRAD) {
    const float h = acc + x0;
    const float cdf = 0.5f * (1.f + erf32(h * 0.70710678118654752f));
    const float pdf = expf(-0.5f * h * h) * 0.3989422804014327f;
    v[0] = h * cdf;
    v[1] = cdf + h * pdf;
  } else if (EPI == E_MUL_F32) {
    v[0] = v[1] = acc * x0;
  } else {  // E_GELU_BWD: gelu_new (tanh form) and its derivative; x0 = u, x1 = df
    const float c = 0.7978845608028654f, a = 0.044715f;
    const float g = round_to<T>(acc);
    const float t = tanhf(c * (g + a * g * g * g));
    const float ge = 0.5f * g * (1.f + t);
    const float dge = 0.5f * (1.f + t) + 0.5f * g * (1.f - t * t) * c * (1.f + 3.f * a * g * g);
    v[0] = round_to<T>(ge) * x0;
    v[1] = x1 * ge;
    v[2] = x1 * x0 * dge;
  }
}

template <typename T>
__device__ __forceinline__ float load_aux(int kind, const void* aux, const void* out0, long long idx, int col) {
  if (kind == AUX_T) return to_f(static_cast<const T*>(aux)[idx]);
  if (kind == AUX_F32) return static_cast<const float*>(aux)[idx];
  if (kind == AUX_BIAS) return to_f(static_cast<const T*>(aux)[col]);
  if (kind == AUX_OUT0) return static_cast<const float*>(out0)[idx];
  return 0.f;
}
template <typename T>
__device__ __forceinline__ void store_out(bool f32, void* out, long long idx, float v) {
  if (f32) static_cast<float*>(out)[idx] = v;
  else static_cast<T*>(out)[idx] = from_f<T>(v);
}

template <typename T, int EPI>
__device__ __forceinline__ void epilogue(float acc, const EpiPtrs& e, long long idx, int col) {
  float v[3];
  epilogue_values<T, EPI>(acc, load_aux<T>(aux0_kind(EPI), e.aux0, e.out0, idx, col),
                          load_aux<T>(aux1_kind(EPI), e.aux1, nullptr, idx, col), v);
  store_out<T>(out_f32(EPI, 0), e.out0, idx, v[0]);
  if (n_outs(EPI) > 1) store_out<T>(out_f32(EPI, 1), e.out1, idx, v[1]);
  if (n_outs(EPI) > 2) store_out<T>(out_f32(EPI, 2), e.out2, idx, v[2]);
}

// two neighbouring columns (idx and col even) of the bf16 kernel: every (M, N)
// operand read as one bf16 pair or float2, every output written as one
__device__ __forceinline__ float2 load_aux_pair(int kind, const void* aux, const void* out0, long long idx, int col) {
  using bf2 = __nv_bfloat162;
  if (kind == AUX_T) return __bfloat1622float2(*reinterpret_cast<const bf2*>(static_cast<const __nv_bfloat16*>(aux) + idx));
  if (kind == AUX_F32) return *reinterpret_cast<const float2*>(static_cast<const float*>(aux) + idx);
  if (kind == AUX_BIAS) return __bfloat1622float2(*reinterpret_cast<const bf2*>(static_cast<const __nv_bfloat16*>(aux) + col));
  if (kind == AUX_OUT0) return *reinterpret_cast<const float2*>(static_cast<const float*>(out0) + idx);
  return make_float2(0.f, 0.f);
}
__device__ __forceinline__ void store_out_pair(bool f32, void* out, long long idx, float v0, float v1) {
  if (f32) *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(v0, v1);
  else *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) = __floats2bfloat162_rn(v0, v1);
}

// the aux values of two neighbouring columns, loaded ahead of the stores that
// follow them (the compiler may not move a load past a store to another pointer)
struct AuxPair {
  float2 x0, x1;
};
template <int EPI>
__device__ __forceinline__ AuxPair epilogue_pair_load(const EpiPtrs& e, long long idx, int col) {
  return {load_aux_pair(aux0_kind(EPI), e.aux0, e.out0, idx, col), load_aux_pair(aux1_kind(EPI), e.aux1, nullptr, idx, col)};
}
template <int EPI>
__device__ __forceinline__ void epilogue_pair_store(float acc0, float acc1, const AuxPair& x, const EpiPtrs& e,
                                                    long long idx) {
  using bf16 = __nv_bfloat16;
  float v[3], w[3];
  epilogue_values<bf16, EPI>(acc0, x.x0.x, x.x1.x, v);
  epilogue_values<bf16, EPI>(acc1, x.x0.y, x.x1.y, w);
  store_out_pair(out_f32(EPI, 0), e.out0, idx, v[0], w[0]);
  if (n_outs(EPI) > 1) store_out_pair(out_f32(EPI, 1), e.out1, idx, v[1], w[1]);
  if (n_outs(EPI) > 2) store_out_pair(out_f32(EPI, 2), e.out2, idx, v[2], w[2]);
}

// element (m, k) of A and (k, n) of B in each layout
template <int L>
__device__ __forceinline__ long long a_off(int m, int k, int M, int K) {
  return L == L_TN ? (long long)k * M + m : (long long)m * K + k;
}
template <int L>
__device__ __forceinline__ long long b_off(int k, int n, int N, int K) {
  return L == L_NT ? (long long)n * K + k : (long long)k * N + n;
}

// ---- SIMT GEMM (f32): 64x64 tile, 4x4 per thread -----------------------------
constexpr int SBM = 64, SBN = 64, SBK = 16;

template <typename T, int L, int EPI>
__global__ void __launch_bounds__(256) gemm_simt_kernel(const T* __restrict__ A,
                                                        const T* __restrict__ B, EpiPtrs e,
                                                        int M, int N, int K, int k_chunk) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  // this block's range of the contraction, and its slot of a split output
  const int k_lo = blockIdx.z * k_chunk, k_hi = min(K, k_lo + k_chunk);
  const long long zoff = (long long)blockIdx.z * M * N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += SBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e_ = tid + i * 256;
      // neighbouring threads on neighbouring addresses of each operand
      const int am = L == L_TN ? e_ % SBM : e_ / SBK, ak = L == L_TN ? e_ / SBM : e_ % SBK;
      const int bn = L == L_NT ? e_ / SBK : e_ % SBN, bk = L == L_NT ? e_ % SBK : e_ / SBN;
      const int gm = m0 + am, gka = k0 + ak, gn = n0 + bn, gkb = k0 + bk;
      As[ak][am] = (gm < M && gka < k_hi) ? to_f(A[a_off<L>(gm, gka, M, K)]) : 0.f;
      Bs[bk][bn] = (gn < N && gkb < k_hi) ? to_f(B[b_off<L>(gkb, gn, N, K)]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) epilogue<T, EPI>(acc[i][j], e, zoff + (long long)gm * N + gn, gn);
    }
  }
}

// ---- bf16 tensor-core GEMM (wgmma, cp.async ring) -----------------------------
// One operand's tile of a ring stage, ROWS (its M or N extent) x GBK, copied from
// a row-major matrix with leading dimension ld. K-major (MN false: the matrix is
// (M or N, K), A of NT and NN, B of NT): ROWS swizzled rows of GBK elements, eight
// neighbouring threads on one 128-byte row, a thread's rows 32 apart. MN-major
// (the matrix is (K, M or N): A of TN, B of NN and TN): ROWS / 64 atoms of GBK
// rows of 64 elements, 8192 bytes apart, ROWS / 8 neighbouring threads on one K
// row, a thread's rows 2048 / ROWS apart. Either way ROWS / 32 copies a thread,
// whose swizzled place is the same in each; copies past the matrix or past k_hi
// are zero-filled.
constexpr uint32_t ATOM_BYTES = GBK * 128;  // one 64-wide MN-major atom of a stage

template <bool MN, int ROWS>
struct OperandLoader {
  static constexpr int COPIES = ROWS / 32;
  static constexpr int RPP = MN ? 2048 / ROWS : 32;  // stage rows between a thread's copies
  const __nv_bfloat16* base;  // the matrix: the (unread) source of a zero-filled copy
  const __nv_bfloat16* src;   // this thread's first element at k = 0
  long long step;             // elements between its copies
  uint32_t off;               // byte offset of its first chunk in the operand's tile
  int kc;                     // MN: its K row in a step; K-major: its first K element in a step
  int lim;                    // MN: 1 when its 8 columns lie inside the matrix; K-major: rows left from its first

  __device__ __forceinline__ OperandLoader(const __nv_bfloat16* X, int ld, int r0, int R, int tid) : base(X) {
    if (MN) {
      const int c = tid % (ROWS / 8);
      kc = tid / (ROWS / 8);
      off = (c >> 3) * ATOM_BYTES + swz_off(kc, c & 7);
      src = X + (long long)kc * ld + r0 + c * 8;
      step = (long long)RPP * ld;
      lim = r0 + c * 8 < R;
    } else {
      const int row = tid >> 3, c = tid & 7;
      kc = c * 8;
      off = swz_off(row, c);
      src = X + (long long)(r0 + row) * ld + kc;
      step = 32LL * ld;
      lim = R - r0 - row;
    }
  }
  // the tile of K step [k0, k0 + GBK) into the stage's operand tile at `tile`
  __device__ __forceinline__ void load(uint32_t tile, int k0, int k_hi, int ld) const {
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const bool in = MN ? lim && k0 + kc + i * RPP < k_hi : i * 32 < lim && k0 + kc < k_hi;
      const __nv_bfloat16* p = src + (MN ? (long long)k0 * ld : (long long)k0) + i * step;
      cp_async16(tile + off + i * RPP * 128, in ? p : base, in);
    }
  }
};

// C = epi(A . B) in layout L, 128 x BN output tiles (GemmTile, hopper.cuh), the
// contraction over [blockIdx.z * k_chunk, + k_chunk) of K
template <int L, int EPI, int BN>
__global__ void __launch_bounds__(256, GemmTile<BN>::BLOCKS_PER_SM) gemm_bwd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B, EpiPtrs e, int M, int N, int K,
    int k_chunk, int pairs) {
  constexpr bool A_MN = L == L_TN, B_MN = L != L_NT;
  constexpr int GST = GemmTile<BN>::GST, STAGE_BYTES = GemmTile<BN>::STAGE_BYTES;
  constexpr int AHEAD = GemmTile<BN>::AHEAD, PENDING = GemmTile<BN>::PENDING;
  extern __shared__ uint8_t gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * BN;
  // this block's range of the contraction (only TN is ever split), and its slot of a split output
  const int k_lo = blockIdx.z * k_chunk, k_hi = min(K, k_lo + k_chunk);
  const int KT = k_hi > k_lo ? (k_hi - k_lo + GBK - 1) / GBK : 0;
  const long long zoff = (long long)blockIdx.z * M * N;
  const int lda = A_MN ? M : K, ldb = B_MN ? N : K;

  const OperandLoader<A_MN, GBM> la(A, lda, m0, M, tid);
  const OperandLoader<B_MN, BN> lb(B, ldb, n0, N, tid);
  auto load = [&](int kt) {
    const uint32_t stage = ring + (kt % GST) * STAGE_BYTES;
    la.load(stage, k_lo + kt * GBK, k_hi, lda);
    lb.load(stage + G_A_BYTES, k_lo + kt * GBK, k_hi, ldb);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of tile kt have landed
    fence_async_shared();
    __syncthreads();  // everyone's have; and everyone has waited for product kt - 1 - PENDING
    if (kt + AHEAD < KT) load(kt + AHEAD);  // into the stage that product read
    cp_async_commit();
    const uint32_t stage = ring + (kt % GST) * STAGE_BYTES;
    // this warpgroup's 64 rows of A (64 K-major rows, or the one 64-wide MN-major atom); all of B
    const uint32_t sa = stage + wg * ATOM_BYTES, sb = stage + G_A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      const uint64_t da = wgmma_desc(sa + kk * (A_MN ? 2048 : 32));
      const uint64_t db = B_MN ? wgmma_desc_mn(sb + kk * 2048, ATOM_BYTES) : wgmma_desc(sb + kk * 32);
      if constexpr (BN == 256) wgmma_m64n256k16_ss<A_MN, B_MN>(acc, da, db, 1);
      else wgmma_m64n128k16_ss<A_MN, B_MN>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<PENDING>();  // BN 256: product kt - 1 is done, kt runs on under the next step's wait
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the epilogue from the accumulator registers: two neighbouring columns a
  // thread; with pairs, the aux values of 8 EG columns are loaded before any
  // of their results is stored, so the loads are in flight together
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + (lane & 3) * 2;
  constexpr int EG = aux1_kind(EPI) != AUX_NONE ? 4 : 8;  // column blocks of 8 a group (gelu_bwd: two aux, 4)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gm = row0 + half * 8;
    if (gm >= M) continue;
    const long long row_idx = zoff + (long long)gm * N;
    if (pairs) {  // N even: a pair is wholly inside N or wholly past it
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += EG) {
        AuxPair x[EG];
#pragma unroll
        for (int jj = 0; jj < EG; ++jj) {
          const int gn = col0 + (j0 + jj) * 8;
          if (gn < N) x[jj] = epilogue_pair_load<EPI>(e, row_idx + gn, gn);
        }
#pragma unroll
        for (int jj = 0; jj < EG; ++jj) {
          const int j = j0 + jj, gn = col0 + j * 8;
          if (gn < N) epilogue_pair_store<EPI>(acc[j * 4 + half * 2], acc[j * 4 + half * 2 + 1], x[jj], e, row_idx + gn);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int gn = col0 + j * 8;
        if (gn < N) epilogue<__nv_bfloat16, EPI>(acc[j * 4 + half * 2], e, row_idx + gn, gn);
        if (gn + 1 < N) epilogue<__nv_bfloat16, EPI>(acc[j * 4 + half * 2 + 1], e, row_idx + gn + 1, gn + 1);
      }
    }
  }
}

// `splits` > 1 (TN with store_f32 only; see gemm_bwd_tn_split) cuts the
// contraction into ranges of k_chunk, a multiple of the bf16 kernel's K step
// (the last ranges may be short or empty and then write zeros), one per blockIdx.z
template <int L, int EPI>
cudaError_t gemm_bwd(int dtype, const void* a, const void* b, const EpiPtrs& e, int M, int N, int K,
                     cudaStream_t s, int splits = 1) {
  const int k_chunk = splits > 1 ? ((K + splits - 1) / splits + GBK - 1) / GBK * GBK : K;
  if (dtype == DT_F32) {
    dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM, splits);
    gemm_simt_kernel<float, L, EPI><<<grid, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), e, M, N, K, k_chunk);
    return cudaGetLastError();
  }
  if (dtype == DT_BF16) {
    // 16-byte copies along each operand's contiguous dim
    const bool ok = L == L_NT ? K % 8 == 0 : (L == L_NN ? K % 8 == 0 && N % 8 == 0 : M % 8 == 0 && N % 8 == 0);
    if (!ok) return cudaErrorInvalidValue;
    const bool wide = splits == 1 && gemm_wide_tile(M, N, K);
    auto kern = wide ? gemm_bwd_wgmma_kernel<L, EPI, 256> : gemm_bwd_wgmma_kernel<L, EPI, 128>;
    const int BN = wide ? 256 : 128, smem = wide ? GemmTile<256>::SMEM : GemmTile<128>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    // the pair epilogue needs even N and every (M, N) operand aligned for two elements
    auto aligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; };
    const int pairs = N % 2 == 0 && aligned(e.out0, 8) && aligned(e.out1, 8) && aligned(e.out2, 8) &&
                      aligned(e.aux0, 8) && aligned(e.aux1, 8);
    dim3 grid((N + BN - 1) / BN, (M + GBM - 1) / GBM, splits);
    kern<<<grid, 256, smem, s>>>(static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), e, M,
                                 N, K, k_chunk, pairs);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// dw[i] = sum over blocks of dw_part[:, i], in block order
__global__ void column_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int nparts, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  float acc = 0.f;
  for (int p = 0; p < nparts; ++p) acc += part[(long long)p * d + i];
  out[i] = acc;
}

// out[j] = sum over p of part[p, j], in a fixed order: a block takes 32
// columns, warp k the rows k, k + 8, ..., and the eight warps' sums are added
// in warp order. The second pass of every row sum whose first pass leaves one
// partial row a block (t5_rms_bwd, bert_ln_bwd, bert_col_sum): over a hundred
// partial rows, eight warps share each column's adds, where column_sum_kernel
// gives each column one thread that adds every partial in series.
__global__ void __launch_bounds__(256) part_sum_kernel(const float* __restrict__ part,
                                                       float* __restrict__ out, int nparts, int n) {
  __shared__ float acc[8][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < n)
    for (int p = warp; p < nparts; p += 8) s += part[(long long)p * n + j];
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += acc[k][lane];
    out[j] = t;
  }
}

inline cudaError_t part_sum(const void* part, void* out, int nparts, int n, cudaStream_t s) {
  part_sum_kernel<<<(n + 31) / 32, 256, 0, s>>>(static_cast<const float*>(part), static_cast<float*>(out), nparts, n);
  return cudaGetLastError();
}

// A^T . B as f32 with the rows cut into `splits` ranges: the partial
// products go to scratch (splits, M, N), their sum in range order to out.
inline cudaError_t gemm_bwd_tn_split(int dtype, const void* a, const void* b, void* out, void* scratch,
                                     int M, int N, int K, int splits, cudaStream_t s) {
  if (splits <= 1 || scratch == nullptr)
    return gemm_bwd<L_TN, E_STORE_F32>(dtype, a, b, EpiPtrs{out, nullptr, nullptr, nullptr, nullptr}, M, N, K, s);
  cudaError_t err = gemm_bwd<L_TN, E_STORE_F32>(
      dtype, a, b, EpiPtrs{scratch, nullptr, nullptr, nullptr, nullptr}, M, N, K, s, splits);
  if (err != cudaSuccess) return err;
  column_sum_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(scratch),
                                                        static_cast<float*>(out), splits, M * N);
  return cudaGetLastError();
}

}  // namespace
