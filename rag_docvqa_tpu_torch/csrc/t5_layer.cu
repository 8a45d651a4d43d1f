// K1: the parts of one pre-RMS T5 encoder layer that are not attention: a
// row RMSNorm and a tiled GEMM with an epilogue. With K2 (flash_fwd.cu) for
// the attention they make the whole layer (ops/fused_encoder.py):
//
//   h  = rms(x, ln0)                         rms_norm, written in the compute dtype
//   qkv = h @ Wqkv                           gemm, epilogue none
//   a  = attention(q, k, v, bias, mask)      flash_fwd, mask_value -1e9
//   x1 = x + cast(a @ Wo)                    gemm, epilogue residual
//   h2 = rms(x1, ln1)                        rms_norm
//   f  = cast(relu(h2 @ Wi))                 gemm, epilogue relu
//      | cast(gelu_tanh(cast(h2 @ Wi0))) * cast(h2 @ Wi1)   gemm none, gemm gelu_mul
//   out = x1 + cast(f @ Wof)                 gemm, epilogue residual
//
// Replaces the TPU kernel `_t5_layer_kernel` (and `_t5_layer_kernel_nobias`)
// of rag_docvqa_tpu/ops/fused_encoder.py, called from `_t5_layer_call`. That
// kernel keeps a whole layer for a block of rows in 52 MB of VMEM; a Hopper
// block has 227 KB of shared memory, so the layer is split at the products.
// The cast points are the TPU kernel's: every product is cast to the compute
// dtype before the residual add or the gelu.
//
// What bounds it on the H100: the GEMMs. At t5-base, B 32, T 512 a layer is
// ~232 GFLOP of products over ~60 MB of activations and weights, far above
// the ridge point, so the tensor-core rate is the limit. The bf16 GEMM runs
// on the tensor cores through WMMA (mma.sync) with f32 accumulation, 128x128
// output tiles, 8 warps of 64x32; the f32 GEMM is a SIMT 64x64 tile with 4x4
// per thread, exact f32 as the plain version's. Neither pipelines its loads
// yet: cp.async/TMA rings and wgmma are later work. The RMSNorm is one block
// per row, bound by memory.
#include <mma.h>

#include "common.cuh"

namespace {

enum Epilogue : int { EPI_NONE = 0, EPI_RELU = 1, EPI_RESIDUAL = 2, EPI_GELU_MUL = 3 };

// the epilogue on one f32 accumulator; `aux` is the residual (EPI_RESIDUAL)
// or the up-projection u (EPI_GELU_MUL), same (M, N) layout as the output
template <typename T, int EPI>
__device__ __forceinline__ T epilogue(float acc, const T* __restrict__ aux, long long idx) {
  if (EPI == EPI_NONE) return from_f<T>(acc);
  if (EPI == EPI_RELU) return from_f<T>(fmaxf(acc, 0.f));
  if (EPI == EPI_RESIDUAL) return from_f<T>(round_to<T>(acc) + to_f(aux[idx]));
  // gelu_new (tanh form) of the rounded gate, rounded, times u
  const float g = round_to<T>(acc);
  const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
  const float f = round_to<T>(0.5f * g * (1.f + tanhf(inner)));
  return from_f<T>(f * to_f(aux[idx]));
}

// ---- row RMSNorm -----------------------------------------------------------
template <typename T, typename WT>
__global__ void rms_norm_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                                T* __restrict__ out, int d, float eps) {
  __shared__ float scratch[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  ss = block_reduce<false>(ss, scratch);
  const float inv = rsqrtf(ss / d + eps);
  T* orow = out + row * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_f<T>(to_f(xr[i]) * inv * to_f(w[i]));
}

// ---- SIMT GEMM: C (M, N) = epi(A (M, K) @ W (N, K)^T), f32 accumulate -------
constexpr int SBM = 64, SBN = 64, SBK = 16;

template <typename T, int EPI>
__global__ void __launch_bounds__(256) gemm_simt_kernel(
    const T* __restrict__ A, const T* __restrict__ W, T* __restrict__ C,
    const T* __restrict__ aux, int M, int N, int K) {
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
      const long long idx = (long long)gm * N + gn;
      C[idx] = epilogue<T, EPI>(acc[i][j], aux, idx);
    }
  }
}

// ---- bf16 tensor-core GEMM (WMMA 16x16x16, f32 accumulate) ----------------
constexpr int WBM = 128, WBN = 128, WBK = 32, WLD = WBK + 8;  // +8: bank skew, 16 B rows

template <int EPI>
__global__ void __launch_bounds__(256) gemm_wmma_bf16_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
    __nv_bfloat16* __restrict__ C, const __nv_bfloat16* __restrict__ aux,
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
        if (gm < M && gn < N) {
          const long long idx = (long long)gm * N + gn;
          C[idx] = epilogue<__nv_bfloat16, EPI>(st[e], aux, idx);
        }
      }
      __syncwarp();
    }
}

template <typename T, int EPI>
cudaError_t gemm_simt(const void* a, const void* w, void* c, const void* aux, int M, int N,
                      int K, cudaStream_t s) {
  dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM);
  gemm_simt_kernel<T, EPI><<<grid, 256, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<T*>(c),
      static_cast<const T*>(aux), M, N, K);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t gemm_wmma(const void* a, const void* w, void* c, const void* aux, int M, int N,
                      int K, cudaStream_t s) {
  if (K % 8 != 0) return cudaErrorInvalidValue;
  dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM);
  gemm_wmma_bf16_kernel<EPI><<<grid, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(aux), M, N, K);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t gemm_dtype(int dtype, const void* a, const void* w, void* c, const void* aux,
                       int M, int N, int K, cudaStream_t s) {
  if (dtype == DT_F32) return gemm_simt<float, EPI>(a, w, c, aux, M, N, K, s);
  if (dtype == DT_BF16) return gemm_wmma<EPI>(a, w, c, aux, M, N, K, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (rows, d) and out (rows, d) in `dtype`; w (d,) in `w_dtype`.
extern "C" int t5_rms_norm(const void* x, const void* w, void* out, int rows, int d,
                           float eps, int dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
#define RMS(T, WT)                                                                     \
  rms_norm_kernel<T, WT><<<rows, threads, 0, s>>>(static_cast<const T*>(x),           \
                                                  static_cast<const WT*>(w),          \
                                                  static_cast<T*>(out), d, eps)
  if (dtype == DT_F32 && w_dtype == DT_F32) RMS(float, float);
  else if (dtype == DT_F32 && w_dtype == DT_BF16) RMS(float, __nv_bfloat16);
  else if (dtype == DT_BF16 && w_dtype == DT_F32) RMS(__nv_bfloat16, float);
  else if (dtype == DT_BF16 && w_dtype == DT_BF16) RMS(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef RMS
  return (int)cudaGetLastError();
}

// C (M, N) = epilogue(A (M, K) @ W (N, K)^T); all contiguous, one dtype;
// aux (M, N) for the residual and gelu_mul epilogues, else null.
extern "C" int t5_gemm(const void* a, const void* w, void* c, const void* aux, int M, int N,
                       int K, int dtype, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (epi) {
    case EPI_NONE: err = gemm_dtype<EPI_NONE>(dtype, a, w, c, aux, M, N, K, s); break;
    case EPI_RELU: err = gemm_dtype<EPI_RELU>(dtype, a, w, c, aux, M, N, K, s); break;
    case EPI_RESIDUAL: err = gemm_dtype<EPI_RESIDUAL>(dtype, a, w, c, aux, M, N, K, s); break;
    case EPI_GELU_MUL: err = gemm_dtype<EPI_GELU_MUL>(dtype, a, w, c, aux, M, N, K, s); break;
    default: break;
  }
  return (int)err;
}
