// The forward GEMM of the whole-layer kernels, one template for the T5
// layer (t5_layer.cu, K1/K13), the BERT layer (bert_layer.cu, K9) and the ViT
// layer (vit_layer.cu, K14):
//
//   C (M, N) = epilogue(A (M, K) @ W (N, K)^T), f32 accumulation
//
// It replaces the products inside the TPU whole-layer kernels of
// rag_docvqa_tpu/ops/fused_encoder.py (`_t5_layer_kernel`, `_layer_kernel`,
// `_vit_layer_kernel`; `_t5_layer_kernel_qtiled`, K13, whose products are the
// T5 layer's GEMMs here), which the 227 KB of a Hopper block's shared memory
// split at the products.
//
// What bounds it on the H100: operations. At the served shapes (16384 x 768 x
// 3072 and the like) a product is hundreds of FLOP per byte, so the tensor-core
// rate is the limit, and only wgmma reaches it. The bf16 kernel therefore is:
//   - a 128 x BN output tile per block of two warpgroups, each owning 64 rows
//     and running wgmma.mma_async m64nBNk16 with both operands read from
//     shared memory (A and W are K-major, wgmma's native form), the 64 x BN
//     f32 accumulator in BN / 2 registers a thread;
//   - K steps of 64 in a ring of stages filled by 16-byte cp.async into
//     128-byte-swizzled tiles (hopper.cuh); rows past M or N and chunks past K
//     are zero-filled, so ragged shapes need no second path. Two tiles are in
//     flight ahead of the one the tensor cores work on;
//   - two forms (GemmTile, hopper.cuh), chosen by a fixed rule of the shape
//     (gemm_wide_tile): BN 128 with two blocks resident on an SM, so that one
//     block's epilogue and barriers run under the other's products, and BN 256
//     with one block on an SM for long K, which reads a third fewer
//     shared-memory bytes per operation;
//   - the epilogue straight from the accumulator registers, whose rows and
//     columns the documented layout gives: two neighbouring columns a thread,
//     written as one bf16 pair (one float2 for the f32 output).
// What it still leaves on the table: no TMA, no producer warp and no persistent
// scheduler, so a block's first loads and its epilogue overlap only with its
// neighbour block; the erf-GELU epilogue costs as much as a K 384 mainloop.
// The f32 GEMM is a SIMT 64x64 tile with 4x4 per thread, exact f32 as the plain
// version's (the tensor cores have no exact f32 product).
//
// Epilogues on one f32 accumulator `acc` at row-major offset idx, column col
// (aux is (M, N) and bias (N,), both in the compute dtype T):
//   none               C = cast(acc)
//   relu               C = cast(max(acc, 0))
//   residual           C = cast(cast(acc) + aux)
//   gelu_mul           C = cast(cast(gelu_tanh(cast(acc))) * aux)
//   bias               C = cast(acc + bias)
//   bias_gelu          C = cast(gelu_erf(acc + bias)), the GELU in f32
//   bias_residual_f32  C = aux + (acc + bias), written as f32: the sum a
//                      LayerNorm reads
//   bias_scale_residual  C = cast(cast(cast(acc + bias) * scale) + aux), every
//                      step in T: the pre-LN ViT layer's residual branches
//                      (vit_layer.cu); scale (N,) is the layer-scale row, null
//                      for none
#pragma once

#include "hopper.cuh"

namespace {

enum Epilogue : int {
  EPI_NONE = 0, EPI_RELU = 1, EPI_RESIDUAL = 2, EPI_GELU_MUL = 3,
  EPI_BIAS = 4, EPI_BIAS_GELU = 5, EPI_BIAS_RESIDUAL_F32 = 6, EPI_BIAS_SCALE_RESIDUAL = 7
};

// the value an epilogue stores (before its last cast to T; EPI_BIAS_RESIDUAL_F32
// stores it as it is) from the accumulator and the aux, bias and scale elements
template <typename T, int EPI>
__device__ __forceinline__ float epilogue_value(float acc, float aux, float bias, bool scaled, float scale) {
  if (EPI == EPI_NONE) return acc;
  if (EPI == EPI_RELU) return fmaxf(acc, 0.f);
  if (EPI == EPI_RESIDUAL) return round_to<T>(acc) + aux;
  if (EPI == EPI_GELU_MUL) {
    // gelu_new (tanh form) of the rounded gate, rounded, times u
    const float g = round_to<T>(acc);
    const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
    const float f = round_to<T>(0.5f * g * (1.f + tanhf(inner)));
    return f * aux;
  }
  if (EPI == EPI_BIAS) return acc + bias;
  if (EPI == EPI_BIAS_GELU) {
    const float h = acc + bias;
    return 0.5f * h * (1.f + erf32(h * 0.70710678118654752f));
  }
  if (EPI == EPI_BIAS_RESIDUAL_F32) return aux + (acc + bias);
  float y = round_to<T>(acc + bias);  // EPI_BIAS_SCALE_RESIDUAL
  if (scaled) y = round_to<T>(y * scale);
  return y + aux;
}

__host__ __device__ constexpr bool epi_reads_aux(int epi) {
  return epi == EPI_RESIDUAL || epi == EPI_GELU_MUL || epi == EPI_BIAS_RESIDUAL_F32 || epi == EPI_BIAS_SCALE_RESIDUAL;
}
__host__ __device__ constexpr bool epi_reads_bias(int epi) { return epi >= EPI_BIAS; }

template <typename T, int EPI>
__device__ __forceinline__ void epilogue(float acc, void* __restrict__ C, const T* __restrict__ aux,
                                         const T* __restrict__ bias, const T* __restrict__ scale,
                                         long long idx, int col) {
  const float x = epi_reads_aux(EPI) ? to_f(aux[idx]) : 0.f;
  const float b = epi_reads_bias(EPI) ? to_f(bias[col]) : 0.f;
  const bool scaled = EPI == EPI_BIAS_SCALE_RESIDUAL && scale != nullptr;
  const float v = epilogue_value<T, EPI>(acc, x, b, scaled, scaled ? to_f(scale[col]) : 0.f);
  if (EPI == EPI_BIAS_RESIDUAL_F32) static_cast<float*>(C)[idx] = v;
  else static_cast<T*>(C)[idx] = from_f<T>(v);
}

// two neighbouring columns (col even) of one row at once, bf16 operands: every
// pointer 4-byte aligned (8 for the f32 output) and N even, so idx is even
template <int EPI>
__device__ __forceinline__ void epilogue_pair(float acc0, float acc1, void* __restrict__ C,
                                              const __nv_bfloat16* __restrict__ aux,
                                              const __nv_bfloat16* __restrict__ bias,
                                              const __nv_bfloat16* __restrict__ scale, long long idx, int col) {
  using bf2 = __nv_bfloat162;
  float2 x = make_float2(0.f, 0.f), b = x, sc = x;
  if (epi_reads_aux(EPI)) x = __bfloat1622float2(*reinterpret_cast<const bf2*>(aux + idx));
  if (epi_reads_bias(EPI)) b = __bfloat1622float2(*reinterpret_cast<const bf2*>(bias + col));
  const bool scaled = EPI == EPI_BIAS_SCALE_RESIDUAL && scale != nullptr;
  if (scaled) sc = __bfloat1622float2(*reinterpret_cast<const bf2*>(scale + col));
  const float v0 = epilogue_value<__nv_bfloat16, EPI>(acc0, x.x, b.x, scaled, sc.x);
  const float v1 = epilogue_value<__nv_bfloat16, EPI>(acc1, x.y, b.y, scaled, sc.y);
  if (EPI == EPI_BIAS_RESIDUAL_F32) *reinterpret_cast<float2*>(static_cast<float*>(C) + idx) = make_float2(v0, v1);
  else *reinterpret_cast<bf2*>(static_cast<__nv_bfloat16*>(C) + idx) = __floats2bfloat162_rn(v0, v1);
}

// ---- SIMT GEMM: C (M, N) = epi(A (M, K) @ W (N, K)^T), f32 accumulate -------
constexpr int SBM = 64, SBN = 64, SBK = 16;

template <typename T, int EPI>
__global__ void __launch_bounds__(256) gemm_simt_kernel(
    const T* __restrict__ A, const T* __restrict__ W, void* __restrict__ C,
    const T* __restrict__ aux, const T* __restrict__ bias, const T* __restrict__ scale,
    int M, int N, int K) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Ws[SBK][SBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, row = e / SBK, c = e % SBK, gk = k0 + c;
      const int gm = m0 + row, gn = n0 + row;
      As[c][row] = (gm < M && gk < K) ? to_f(A[(long long)gm * K + gk]) : 0.f;
      Ws[c][row] = (gn < N && gk < K) ? to_f(W[(long long)gn * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx * 4 + j];
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
      if (gn >= N) continue;
      epilogue<T, EPI>(acc[i][j], C, aux, bias, scale, (long long)gm * N + gn, gn);
    }
  }
}

// ---- bf16 tensor-core GEMM (wgmma m64n128k16 / m64n256k16, cp.async ring) ----
// the block tile, its two forms and the ring: GemmTile in hopper.cuh
template <int EPI, int BN>
__global__ void __launch_bounds__(256, GemmTile<BN>::BLOCKS_PER_SM) gemm_wgmma_bf16_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
    void* __restrict__ C, const __nv_bfloat16* __restrict__ aux,
    const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ scale,
    int M, int N, int K, int pairs) {
  extern __shared__ uint8_t gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  constexpr int GST = GemmTile<BN>::GST, G_STAGE_BYTES = GemmTile<BN>::STAGE_BYTES;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * BN;
  const int KT = (K + GBK - 1) / GBK;

  // tile kt of both operands into its stage: (128 + BN) rows x 8 chunks of 16
  // bytes, 4 + BN / 32 copies a thread, eight neighbouring threads on one 128-byte
  // row. A thread's rows are 32 apart, so its chunk's swizzled place is the same
  // in each and only the K offset moves from tile to tile.
  const int ld_row = tid >> 3, ld_ch = tid & 7;
  const uint32_t ld_off = swz_off(ld_row, ld_ch);
  const __nv_bfloat16* a_src = A + (long long)(m0 + ld_row) * K + ld_ch * 8;
  const __nv_bfloat16* w_src = W + (long long)(n0 + ld_row) * K + ld_ch * 8;
  auto load = [&](int kt) {
    const uint32_t sa = ring + (kt % GST) * G_STAGE_BYTES + ld_off, sw = sa + G_A_BYTES;
    const int k0 = kt * GBK;
    const bool kin = k0 + ld_ch * 8 < K;
#pragma unroll
    for (int i = 0; i < GBM / 32; ++i) {
      const bool ina = kin && m0 + ld_row + i * 32 < M;
      cp_async16(sa + i * 32 * 128, ina ? a_src + (long long)i * 32 * K + k0 : A, ina);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const bool inw = kin && n0 + ld_row + i * 32 < N;
      cp_async16(sw + i * 32 * 128, inw ? w_src + (long long)i * 32 * K + k0 : W, inw);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  constexpr int AHEAD = GemmTile<BN>::AHEAD, PENDING = GemmTile<BN>::PENDING;
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
    const uint32_t stage = ring + (kt % GST) * G_STAGE_BYTES;
    const uint32_t sa = stage + wg * (64 * 128), sw = stage + G_A_BYTES;  // this warpgroup's 64 rows of A; all of W
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      if constexpr (BN == 256) wgmma_m64n256k16_ss<0, 0>(acc, wgmma_desc(sa + kk * 32), wgmma_desc(sw + kk * 32), 1);
      else wgmma_m64n128k16_ss<0, 0>(acc, wgmma_desc(sa + kk * 32), wgmma_desc(sw + kk * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<PENDING>();  // BN 256: product kt - 1 is done, kt runs on under the next step's wait
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gm = row0 + half * 8;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gn = col0 + j * 8;
      const float a0 = acc[j * 4 + half * 2], a1 = acc[j * 4 + half * 2 + 1];
      const long long idx = (long long)gm * N + gn;
      if (pairs && gn + 1 < N) {
        epilogue_pair<EPI>(a0, a1, C, aux, bias, scale, idx, gn);
      } else {
        if (gn < N) epilogue<__nv_bfloat16, EPI>(a0, C, aux, bias, scale, idx, gn);
        if (gn + 1 < N) epilogue<__nv_bfloat16, EPI>(a1, C, aux, bias, scale, idx + 1, gn + 1);
      }
    }
  }
}

// a, w, aux, bias and scale in `dtype` (DT_F32 or DT_BF16); c in `dtype`, or
// f32 for the _f32 epilogue. Returns cudaGetLastError() after the launch.
template <int EPI>
cudaError_t gemm_fwd(int dtype, const void* a, const void* w, void* c, const void* aux,
                     const void* bias, int M, int N, int K, cudaStream_t s,
                     const void* scale = nullptr) {
  if (dtype == DT_F32) {
    dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM);
    gemm_simt_kernel<float, EPI><<<grid, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), c,
        static_cast<const float*>(aux), static_cast<const float*>(bias),
        static_cast<const float*>(scale), M, N, K);
    return cudaGetLastError();
  }
  if (dtype == DT_BF16) {
    if (K % 8 != 0) return cudaErrorInvalidValue;
    const bool wide = gemm_wide_tile(M, N, K);
    auto kern = wide ? gemm_wgmma_bf16_kernel<EPI, 256> : gemm_wgmma_bf16_kernel<EPI, 128>;
    const int BN = wide ? 256 : 128, smem = wide ? GemmTile<256>::SMEM : GemmTile<128>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    // the pair epilogue needs even N and 4-byte-aligned rows (8 for the f32 output)
    auto aligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; };
    const int pairs = N % 2 == 0 && aligned(c, EPI == EPI_BIAS_RESIDUAL_F32 ? 8 : 4) && aligned(aux, 4) &&
                      aligned(bias, 4) && aligned(scale, 4);
    dim3 grid((N + BN - 1) / BN, (M + GBM - 1) / GBM);
    kern<<<grid, 256, smem, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w), c,
        static_cast<const __nv_bfloat16*>(aux), static_cast<const __nv_bfloat16*>(bias),
        static_cast<const __nv_bfloat16*>(scale), M, N, K, pairs);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace
