// The forward GEMM of the whole-layer kernels, one template for the T5
// layer (t5_layer.cu, K1) and the BERT layer (bert_layer.cu, K9):
//
//   C (M, N) = epilogue(A (M, K) @ W (N, K)^T), f32 accumulation
//
// The bf16 GEMM runs on the tensor cores through WMMA (mma.sync), 128x128
// output tiles, 8 warps of 64x32; the f32 GEMM is a SIMT 64x64 tile with 4x4
// per thread, exact f32 as the plain version's. Neither pipelines its loads
// yet: cp.async/TMA rings and wgmma are later work.
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

#include <mma.h>

#include "common.cuh"

namespace {

enum Epilogue : int {
  EPI_NONE = 0, EPI_RELU = 1, EPI_RESIDUAL = 2, EPI_GELU_MUL = 3,
  EPI_BIAS = 4, EPI_BIAS_GELU = 5, EPI_BIAS_RESIDUAL_F32 = 6, EPI_BIAS_SCALE_RESIDUAL = 7
};

template <typename T, int EPI>
__device__ __forceinline__ void epilogue(float acc, void* __restrict__ C, const T* __restrict__ aux,
                                         const T* __restrict__ bias, const T* __restrict__ scale,
                                         long long idx, int col) {
  T* out = static_cast<T*>(C);
  if (EPI == EPI_NONE) {
    out[idx] = from_f<T>(acc);
  } else if (EPI == EPI_RELU) {
    out[idx] = from_f<T>(fmaxf(acc, 0.f));
  } else if (EPI == EPI_RESIDUAL) {
    out[idx] = from_f<T>(round_to<T>(acc) + to_f(aux[idx]));
  } else if (EPI == EPI_GELU_MUL) {
    // gelu_new (tanh form) of the rounded gate, rounded, times u
    const float g = round_to<T>(acc);
    const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
    const float f = round_to<T>(0.5f * g * (1.f + tanhf(inner)));
    out[idx] = from_f<T>(f * to_f(aux[idx]));
  } else if (EPI == EPI_BIAS) {
    out[idx] = from_f<T>(acc + to_f(bias[col]));
  } else if (EPI == EPI_BIAS_GELU) {
    const float h = acc + to_f(bias[col]);
    out[idx] = from_f<T>(0.5f * h * (1.f + erf32(h * 0.70710678118654752f)));
  } else if (EPI == EPI_BIAS_RESIDUAL_F32) {
    static_cast<float*>(C)[idx] = to_f(aux[idx]) + (acc + to_f(bias[col]));
  } else {  // EPI_BIAS_SCALE_RESIDUAL
    float y = round_to<T>(acc + to_f(bias[col]));
    if (scale != nullptr) y = round_to<T>(y * to_f(scale[col]));
    out[idx] = from_f<T>(y + to_f(aux[idx]));
  }
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

// ---- bf16 tensor-core GEMM (WMMA 16x16x16, f32 accumulate) ----------------
constexpr int WBM = 128, WBN = 128, WBK = 32, WLD = WBK + 8;  // +8: bank skew, 16 B rows

template <int EPI>
__global__ void __launch_bounds__(256) gemm_wmma_bf16_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
    void* __restrict__ C, const __nv_bfloat16* __restrict__ aux,
    const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ scale,
    int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[WBM * WLD];
  __shared__ __align__(128) __nv_bfloat16 Ws[WBN * WLD];
  __shared__ __align__(128) float stage[8][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows wm*64, cols wn*32
  const int m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += WBK) {
    // 128 rows x 4 chunks of 8 bf16 (16 bytes) per operand; K % 8 == 0
    for (int i = threadIdx.x; i < WBM * (WBK / 8); i += 256) {
      const int row = i / (WBK / 8), ch = i % (WBK / 8), gk = k0 + ch * 8;
      uint4 va = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (m0 + row < M && gk < K)
        va = *reinterpret_cast<const uint4*>(A + (long long)(m0 + row) * K + gk);
      if (n0 + row < N && gk < K)
        vw = *reinterpret_cast<const uint4*>(W + (long long)(n0 + row) * K + gk);
      *reinterpret_cast<uint4*>(&As[row * WLD + ch * 8]) = va;
      *reinterpret_cast<uint4*>(&Ws[row * WLD + ch * 8]) = vw;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * 64 + i * 16) * WLD + kk], WLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // W rows are output columns: B = W^T, col-major
        wmma::load_matrix_sync(fb[j], &Ws[(wn * 32 + j * 16) * WLD + kk], WLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * 64 + i * 16 + e / 16;
        const int gn = n0 + wn * 32 + j * 16 + e % 16;
        if (gm < M && gn < N)
          epilogue<__nv_bfloat16, EPI>(st[e], C, aux, bias, scale, (long long)gm * N + gn, gn);
      }
      __syncwarp();
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
    dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM);
    gemm_wmma_bf16_kernel<EPI><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w), c,
        static_cast<const __nv_bfloat16*>(aux), static_cast<const __nv_bfloat16*>(bias),
        static_cast<const __nv_bfloat16*>(scale), M, N, K);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace
