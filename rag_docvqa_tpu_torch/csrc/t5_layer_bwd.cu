// K7 and K8, the T5 encoder layer backward, split where the TPU kernels
// split it: at x1 = x + attn(rms(x)). Their products and reductions are
// built here; the attention part of K8 is K6 (flash_bwd.cu) and its
// recompute K1 (t5_layer.cu) and K2 (flash_fwd.cu). ops/fused_encoder.py
// composes them:
//
//   K7, FFN + LN1 backward, from the saved x1 and the cotangent g at out:
//     h2 = rms(x1, ln1)                                   t5_rms_norm
//     df = cast(g . Wof)                                  gemm NN, store
//     relu: pre = h2 . Wi^T -> dpre = cast(pre > 0 ? df : 0), f = cast(relu(pre))
//                                                         gemm NT, relu_bwd
//     gated: u = cast(h2 . Wi1^T) (t5_gemm), gl = h2 . Wi0^T ->
//            f, du, dgl with the cast points of gelu_bwd below
//                                                         gemm NT, gelu_bwd
//     dWi = dpre^T . h2, dWof = g^T . f  (f32)            gemm TN
//     dh2 = dpre . Wi  (f32; gated: dgl . Wi0 + du . Wi1) gemm NN, f32 (+=)
//     dx1 = cast(g + rms_bwd(dh2)), dln1 = sum_rows(dh2 * n)   t5_rms_bwd
//
//   K8, attention + LN0 backward, from the saved x and the cotangent dy at x1:
//     h = rms(x, ln0); qkv = cast(h . Wqkv^T); a, lse = K2   (recompute)
//     dWo = dy^T . a (f32); da = cast(dy . Wo)            gemm TN, NN
//     dq, dk, dv, dbias = K6(q, k, v, a, lse, da)
//     dWqkv = dqkv^T . h (f32); dh = dqkv . Wqkv (f32)    gemm TN, NN
//     dx = cast(dy + rms_bwd(dh)), dln0 = sum_rows(dh * n)     t5_rms_bwd
//
// Replaces the TPU kernels `_ffn_bwd_kernel` (K7) and `_attn_bwd_kernel` /
// `_attn_bwd_kernel_nobias` (K8) of rag_docvqa_tpu/ops/fused_encoder_bwd.py,
// called from `_t5_ffn_bwd_impl` and `_t5_attn_bwd_impl`. Those keep a
// whole half-layer for a block of rows in VMEM and accumulate the weight
// gradients in resident f32 blocks across the sequential grid. Here every
// weight gradient is one GEMM that contracts over all B*T rows inside each
// output tile (A^T.B, no split over rows), and the norm weight's gradient is
// summed over rows in two passes of fixed order: deterministic, no atomics.
// Weights are in the port's (out, in) layout: the forward is x . W^T, so
// dX = dY . W and dW = dY^T . X.
//
// What bounds it on the H100: the GEMMs, as in the forward: at t5-base B 8
// T 512 a layer's backward is ~2x its forward's products. The bf16 GEMM runs
// on the tensor cores through WMMA (mma.sync) with f32 accumulation, 128x128
// output tiles, 8 warps of 64x32, as t5_layer.cu's; the f32 GEMM is a SIMT
// 64x64 tile, exact f32. Neither pipelines its loads yet. The norm backward
// is bound by memory.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

// C (M, N) from A and B, f32 accumulation, by layout:
//   NT: A (M, K) . B (N, K)^T   (the forward's)   NN: A (M, K) . B (K, N)
//   TN: A (K, M)^T . B (K, N)   (a weight gradient, contracting over rows)
enum Layout : int { L_NT = 0, L_NN = 1, L_TN = 2 };
enum Epilogue : int { E_STORE = 0, E_STORE_F32 = 1, E_ACC_F32 = 2, E_RELU_BWD = 3, E_GELU_BWD = 4 };

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
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(float acc, const EpiPtrs& e, long long idx) {
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
                                                        int M, int N, int K) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];
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
      const int e_ = tid + i * 256;
      // neighbouring threads on neighbouring addresses of each operand
      const int am = L == L_TN ? e_ % SBM : e_ / SBK, ak = L == L_TN ? e_ / SBM : e_ % SBK;
      const int bn = L == L_NT ? e_ / SBK : e_ % SBN, bk = L == L_NT ? e_ % SBK : e_ / SBN;
      const int gm = m0 + am, gka = k0 + ak, gn = n0 + bn, gkb = k0 + bk;
      As[ak][am] = (gm < M && gka < K) ? to_f(A[a_off<L>(gm, gka, M, K)]) : 0.f;
      Bs[bk][bn] = (gn < N && gkb < K) ? to_f(B[b_off<L>(gkb, gn, N, K)]) : 0.f;
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
      if (gn < N) epilogue<T, EPI>(acc[i][j], e, (long long)gm * N + gn);
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
                                                        EpiPtrs e, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[A_TILE];
  __shared__ __align__(128) __nv_bfloat16 Bs[B_TILE];
  __shared__ __align__(128) float stage[8][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows wm*64, cols wn*32
  const int m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;

  using ALayout = typename std::conditional<L == L_TN, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<L == L_NT, wmma::col_major, wmma::row_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += WBK) {
    // 512 vectors of 8 bf16 per operand tile, two per thread
    for (int i = threadIdx.x; i < 512; i += 256) {
      if (L == L_TN) {  // A (K, M): tile rows k, vectors along m
        const int kr = i / (WBM / 8), ch = i % (WBM / 8);
        *reinterpret_cast<uint4*>(&As[kr * AT_LD + ch * 8]) = load8(A, k0 + kr, m0 + ch * 8, K, M);
      } else {  // A (M, K): tile rows m, vectors along k
        const int r = i / (WBK / 8), ch = i % (WBK / 8);
        *reinterpret_cast<uint4*>(&As[r * A_LD + ch * 8]) = load8(A, m0 + r, k0 + ch * 8, M, K);
      }
      if (L == L_NT) {  // B (N, K): tile rows n, vectors along k
        const int r = i / (WBK / 8), ch = i % (WBK / 8);
        *reinterpret_cast<uint4*>(&Bs[r * B_LD + ch * 8]) = load8(B, n0 + r, k0 + ch * 8, N, K);
      } else {  // B (K, N): tile rows k, vectors along n
        const int kr = i / (WBN / 8), ch = i % (WBN / 8);
        *reinterpret_cast<uint4*>(&Bs[kr * BK_LD + ch * 8]) = load8(B, k0 + kr, n0 + ch * 8, K, N);
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
        if (gm < M && gn < N) epilogue<__nv_bfloat16, EPI>(st[x], e, (long long)gm * N + gn);
      }
      __syncwarp();
    }
}

template <int L, int EPI>
cudaError_t gemm(int dtype, const void* a, const void* b, const EpiPtrs& e, int M, int N, int K,
                 cudaStream_t s) {
  if (dtype == DT_F32) {
    dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM);
    gemm_simt_kernel<float, L, EPI><<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                                         static_cast<const float*>(b), e, M, N, K);
    return cudaGetLastError();
  }
  if (dtype == DT_BF16) {
    // 16-byte vectors along each operand's contiguous dim
    const bool ok = L == L_NT ? K % 8 == 0 : (L == L_NN ? K % 8 == 0 && N % 8 == 0 : M % 8 == 0 && N % 8 == 0);
    if (!ok) return cudaErrorInvalidValue;
    dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM);
    gemm_wmma_kernel<L, EPI><<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(a),
                                                  static_cast<const __nv_bfloat16*>(b), e, M, N, K);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// ---- RMSNorm backward -------------------------------------------------------
// dx = rstd * dn - x * rstd^3 * sum(dn * x) / d with dn = dh * w, written as
// cast(resid + dx); each block also sums dh * n (n = x * rstd) over its rows
// into one row of dw_part. (fused_encoder_bwd.py::_rms_bwd)
constexpr int RMS_ROWS = 32;  // rows per block
constexpr int RMS_MAX_COLS = 16;  // per thread: d <= 16 * 256

template <typename T, typename WT>
__global__ void __launch_bounds__(256) rms_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dh, const WT* __restrict__ w,
    const T* __restrict__ resid, T* __restrict__ dx, float* __restrict__ dw_part, int rows, int d,
    float eps) {
  __shared__ float scratch[32];
  float dw[RMS_MAX_COLS];
#pragma unroll
  for (int j = 0; j < RMS_MAX_COLS; ++j) dw[j] = 0.f;
  const int r0 = (int)blockIdx.x * RMS_ROWS, r_end = min(rows, r0 + RMS_ROWS);
  for (int row = r0; row < r_end; ++row) {
    const T* xr = x + (long long)row * d;
    const float* gr = dh + (long long)row * d;
    float ss = 0.f, sdx = 0.f;
    for (int i = threadIdx.x; i < d; i += 256) {
      const float xv = to_f(xr[i]);
      ss += xv * xv;
      sdx += gr[i] * to_f(w[i]) * xv;
    }
    ss = block_reduce<false>(ss, scratch);
    sdx = block_reduce<false>(sdx, scratch);
    const float rstd = rsqrtf(ss / d + eps);
    const float coef = rstd * rstd * rstd * (sdx * (1.f / d));
    const T* rr = resid + (long long)row * d;
    T* out = dx + (long long)row * d;
#pragma unroll
    for (int j = 0; j < RMS_MAX_COLS; ++j) {
      const int i = threadIdx.x + 256 * j;
      if (i < d) {
        const float xv = to_f(xr[i]), g = gr[i];
        dw[j] += g * (xv * rstd);
        out[i] = from_f<T>(to_f(rr[i]) + (rstd * (g * to_f(w[i])) - xv * coef));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RMS_MAX_COLS; ++j) {
    const int i = threadIdx.x + 256 * j;
    if (i < d) dw_part[(long long)blockIdx.x * d + i] = dw[j];
  }
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

}  // namespace

// C (M, N) = epilogue(A . B) in `layout` (see Layout) for the pairs
// (NT, relu_bwd), (NT, gelu_bwd), (NN, store), (NN, store_f32),
// (NN, acc_f32), (TN, store_f32); a and b in `dtype`, contiguous. out0..2
// and aux0..1 are (M, N) row-major in `dtype`, or f32 for the _f32
// epilogues; unused ones are null. Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for any other pair.
extern "C" int t5_gemm_bwd(const void* a, const void* b, void* out0, void* out1, void* out2,
                           const void* aux0, const void* aux1, int M, int N, int K, int layout,
                           int dtype, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiPtrs e{out0, out1, out2, aux0, aux1};
  cudaError_t err = cudaErrorInvalidValue;
  if (layout == L_NT && epi == E_RELU_BWD) err = gemm<L_NT, E_RELU_BWD>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NT && epi == E_GELU_BWD) err = gemm<L_NT, E_GELU_BWD>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_STORE) err = gemm<L_NN, E_STORE>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_STORE_F32) err = gemm<L_NN, E_STORE_F32>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_ACC_F32) err = gemm<L_NN, E_ACC_F32>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_TN && epi == E_STORE_F32) err = gemm<L_TN, E_STORE_F32>(dtype, a, b, e, M, N, K, s);
  return (int)err;
}

// x, resid, dx (rows, d) in `dtype`; dh (rows, d) f32; w (d,) in `w_dtype`;
// dw (d,) f32; dw_part (ceil(rows / 32), d) f32 scratch. d <= 4096.
extern "C" int t5_rms_bwd(const void* x, const void* dh, const void* w, const void* resid, void* dx,
                          void* dw, void* dw_part, int rows, int d, float eps, int dtype, int w_dtype,
                          void* stream) {
  if (d > RMS_MAX_COLS * 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + RMS_ROWS - 1) / RMS_ROWS;
#define RMS_BWD(T, WT)                                                                      \
  rms_bwd_kernel<T, WT><<<blocks, 256, 0, s>>>(                                            \
      static_cast<const T*>(x), static_cast<const float*>(dh), static_cast<const WT*>(w), \
      static_cast<const T*>(resid), static_cast<T*>(dx), static_cast<float*>(dw_part), rows, d, eps)
  if (dtype == DT_F32 && w_dtype == DT_F32) RMS_BWD(float, float);
  else if (dtype == DT_F32 && w_dtype == DT_BF16) RMS_BWD(float, __nv_bfloat16);
  else if (dtype == DT_BF16 && w_dtype == DT_F32) RMS_BWD(__nv_bfloat16, float);
  else if (dtype == DT_BF16 && w_dtype == DT_BF16) RMS_BWD(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef RMS_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sum_kernel<<<(d + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dw_part),
                                                    static_cast<float*>(dw), blocks, d);
  return (int)cudaGetLastError();
}
