// The backward GEMM of the whole-layer kernels, one template for the T5
// layer backward (t5_layer_bwd.cu, K7/K8) and the BERT layer backward
// (bert_layer_bwd.cu, K10), and the fixed-order column sum both use for
// the gradients that sum over rows.
//
// The bf16 GEMM runs on the tensor cores through WMMA (mma.sync) with f32
// accumulation, 128x128 output tiles, 8 warps of 64x32, as gemm_fwd.cuh's;
// the f32 GEMM is a SIMT 64x64 tile, exact f32. Neither pipelines its loads
// yet. A weight gradient is one GEMM that contracts over all rows (A^T.B).
// Where its output has too few tiles to fill the card (a (384, 384) gradient
// is 9 tiles for 132 SMs) the rows are cut into `splits` ranges, one per
// blockIdx.z; each writes its partial product to a scratch (splits, M, N)
// and `column_sum_kernel` adds the partials in range order: deterministic,
// no atomics, whatever the split.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

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
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(float acc, const EpiPtrs& e, long long idx, int col) {
  if (EPI == E_STORE) {
    static_cast<T*>(e.out0)[idx] = from_f<T>(acc);
  } else if (EPI == E_STORE_F32) {
    static_cast<float*>(e.out0)[idx] = acc;
  } else if (EPI == E_ACC_F32) {
    static_cast<float*>(e.out0)[idx] += acc;
  } else if (EPI == E_RELU_BWD) {
    const float df = to_f(static_cast<const T*>(e.aux0)[idx]);
    static_cast<T*>(e.out0)[idx] = from_f<T>(acc > 0.f ? df : 0.f);
    static_cast<T*>(e.out1)[idx] = from_f<T>(fmaxf(acc, 0.f));
  } else if (EPI == E_BIAS_GELU_GRAD) {
    const float h = acc + to_f(static_cast<const T*>(e.aux0)[col]);
    const float cdf = 0.5f * (1.f + erf32(h * 0.70710678118654752f));
    const float pdf = expf(-0.5f * h * h) * 0.3989422804014327f;
    static_cast<T*>(e.out0)[idx] = from_f<T>(h * cdf);
    static_cast<float*>(e.out1)[idx] = cdf + h * pdf;
  } else if (EPI == E_MUL_F32) {
    const float v = acc * static_cast<const float*>(e.aux0)[idx];
    static_cast<float*>(e.out0)[idx] = v;
    static_cast<T*>(e.out1)[idx] = from_f<T>(v);
  } else if (EPI == E_ADD_F32_STORE) {
    static_cast<T*>(e.out0)[idx] = from_f<T>(static_cast<const float*>(e.aux0)[idx] + acc);
  } else {  // E_GELU_BWD: gelu_new (tanh form) and its derivative
    const float c = 0.7978845608028654f, a = 0.044715f;
    const float g = round_to<T>(acc);
    const float t = tanhf(c * (g + a * g * g * g));
    const float ge = 0.5f * g * (1.f + t);
    const float dge = 0.5f * (1.f + t) + 0.5f * g * (1.f - t * t) * c * (1.f + 3.f * a * g * g);
    const float u = to_f(static_cast<const T*>(e.aux0)[idx]);
    const float df = to_f(static_cast<const T*>(e.aux1)[idx]);
    static_cast<T*>(e.out0)[idx] = from_f<T>(round_to<T>(ge) * u);
    static_cast<T*>(e.out1)[idx] = from_f<T>(df * ge);
    static_cast<T*>(e.out2)[idx] = from_f<T>(df * u * dge);
  }
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

// ---- bf16 tensor-core GEMM (WMMA 16x16x16, f32 accumulate) ------------------
constexpr int WBM = 128, WBN = 128, WBK = 32;
// shared tiles, +8 bf16 of skew per row (16 bytes); A as [m][k] (NT, NN) or
// [k][m] (TN), B as [n][k] (NT) or [k][n] (NN, TN)
constexpr int A_LD = (WBK + 8), AT_LD = (WBM + 8), B_LD = (WBK + 8), BK_LD = (WBN + 8);
constexpr int A_TILE = WBM * A_LD > WBK * AT_LD ? WBM * A_LD : WBK * AT_LD;
constexpr int B_TILE = WBN * B_LD > WBK * BK_LD ? WBN * B_LD : WBK * BK_LD;

// one 16-byte vector (8 bf16) of a row-major (rows, cols) operand, zero
// past its edge; cols % 8 == 0
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int r, int c, int rows, int cols) {
  if (r < rows && c < cols) return *reinterpret_cast<const uint4*>(p + (long long)r * cols + c);
  return make_uint4(0, 0, 0, 0);
}

template <int L, int EPI>
__global__ void __launch_bounds__(256) gemm_wmma_kernel(const __nv_bfloat16* __restrict__ A,
                                                        const __nv_bfloat16* __restrict__ B,
                                                        EpiPtrs e, int M, int N, int K, int k_chunk) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[A_TILE];
  __shared__ __align__(128) __nv_bfloat16 Bs[B_TILE];
  __shared__ __align__(128) float stage[8][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows wm*64, cols wn*32
  const int m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;
  // this block's range of the contraction (only TN is ever split: there k runs
  // over rows, so k_hi bounds the loads), and its slot of a split output
  const int k_lo = blockIdx.z * k_chunk, k_hi = min(K, k_lo + k_chunk);
  const long long zoff = (long long)blockIdx.z * M * N;

  using ALayout = typename std::conditional<L == L_TN, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<L == L_NT, wmma::col_major, wmma::row_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_lo; k0 < k_hi; k0 += WBK) {
    // 512 vectors of 8 bf16 per operand tile, two per thread
    for (int i = threadIdx.x; i < 512; i += 256) {
      if (L == L_TN) {  // A (K, M): tile rows k, vectors along m
        const int kr = i / (WBM / 8), ch = i % (WBM / 8);
        *reinterpret_cast<uint4*>(&As[kr * AT_LD + ch * 8]) = load8(A, k0 + kr, m0 + ch * 8, k_hi, M);
      } else {  // A (M, K): tile rows m, vectors along k
        const int r = i / (WBK / 8), ch = i % (WBK / 8);
        *reinterpret_cast<uint4*>(&As[r * A_LD + ch * 8]) = load8(A, m0 + r, k0 + ch * 8, M, K);
      }
      if (L == L_NT) {  // B (N, K): tile rows n, vectors along k
        const int r = i / (WBK / 8), ch = i % (WBK / 8);
        *reinterpret_cast<uint4*>(&Bs[r * B_LD + ch * 8]) = load8(B, n0 + r, k0 + ch * 8, N, K);
      } else {  // B (K, N): tile rows k, vectors along n
        const int kr = i / (WBN / 8), ch = i % (WBN / 8);
        *reinterpret_cast<uint4*>(&Bs[kr * BK_LD + ch * 8]) = load8(B, k0 + kr, n0 + ch * 8, k_hi, N);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16;
        if (L == L_TN) wmma::load_matrix_sync(fa[i], &As[kk * AT_LD + r], AT_LD);
        else wmma::load_matrix_sync(fa[i], &As[r * A_LD + kk], A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        if (L == L_NT) wmma::load_matrix_sync(fb[j], &Bs[c * B_LD + kk], B_LD);
        else wmma::load_matrix_sync(fb[j], &Bs[kk * BK_LD + c], BK_LD);
      }
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
      for (int x = lane; x < 256; x += 32) {
        const int gm = m0 + wm * 64 + i * 16 + x / 16;
        const int gn = n0 + wn * 32 + j * 16 + x % 16;
        if (gm < M && gn < N) epilogue<__nv_bfloat16, EPI>(st[x], e, zoff + (long long)gm * N + gn, gn);
      }
      __syncwarp();
    }
}

// `splits` > 1 (TN with store_f32 only; see gemm_bwd_tn_split) cuts the
// contraction into ranges of k_chunk, a multiple of 32, one per blockIdx.z
template <int L, int EPI>
cudaError_t gemm_bwd(int dtype, const void* a, const void* b, const EpiPtrs& e, int M, int N, int K,
                     cudaStream_t s, int splits = 1) {
  const int k_chunk = splits > 1 ? ((K + splits - 1) / splits + 31) / 32 * 32 : K;
  if (dtype == DT_F32) {
    dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM, splits);
    gemm_simt_kernel<float, L, EPI><<<grid, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), e, M, N, K, k_chunk);
    return cudaGetLastError();
  }
  if (dtype == DT_BF16) {
    // 16-byte vectors along each operand's contiguous dim
    const bool ok = L == L_NT ? K % 8 == 0 : (L == L_NN ? K % 8 == 0 && N % 8 == 0 : M % 8 == 0 && N % 8 == 0);
    if (!ok) return cudaErrorInvalidValue;
    dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM, splits);
    gemm_wmma_kernel<L, EPI><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), e, M, N, K, k_chunk);
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
