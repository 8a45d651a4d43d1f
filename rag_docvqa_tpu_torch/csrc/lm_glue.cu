// The elementwise glue between the GEMMs of a causal-LM layer (Qwen2, the
// LM of Qwen2.5-VL, Gemma; models/causal_lm.py through ops/lm_glue.py):
//
//   lm_add_rms_norm  x' = x + d, h = rms(x') * w         (d may be absent: h = rms(x) * w)
//   lm_bias_rope     q, k, v += their biases; q, k rotated by per-row cos/sin tables, in place
//   lm_glu           out = act(g) * u, act SiLU (SwiGLU) or tanh-GELU (Gemma's gated MLP)
//
// Replaces no TPU kernel: the JAX package leaves this glue to XLA, which
// fuses it into its neighbours. Run as plain PyTorch on the card, each op is
// a kernel of its own, and the norm and the rotary pass an f32 copy of the
// tensor between several of them: at the Qwen2.5-VL-7B prefill (73,728 rows of
// 3,584) that is about 16 ms of a layer's memory traffic.
//
// What bounds them on the H100: memory, at a few operations a byte. So each
// reads its bf16 (or f32) inputs once and writes its outputs once, and keeps
// every f32 intermediate in registers. The rounding is the plain path's, op
// for op: the residual sum rounded to the working dtype before it is normed,
// the bias sum rounded before the rotation, every rotary product and sum a
// separate correctly rounded f32 operation (__fmul_rn and friends, so no FMA
// contraction), the activation rounded before the product. The rotary and
// the gated product are then bit-equal to the plain path; the norm's sum of
// squares is taken in another order than PyTorch's reduction, so h may lie
// one ulp of the working dtype from it.
#include "common.cuh"

namespace {

// ---- 16-byte and scalar element access -----------------------------------
// N elements of T from p (16-byte aligned when N * sizeof(T) is a multiple
// of 16) widened to f32; `NC` reads through the read-only path (inputs the
// kernel does not write), else through plain loads (the tensors it rotates
// in place).
template <typename T, int N, bool NC>
__device__ __forceinline__ void load_n(const T* p, float (&f)[N]) {
  if constexpr (N * sizeof(T) % 16 == 0) {
    constexpr int VW = Vec16<T>::N;
#pragma unroll
    for (int j = 0; j < N / VW; ++j) {
      const uint4 v = NC ? ldg16(reinterpret_cast<uintptr_t>(p + j * VW))
                         : *reinterpret_cast<const uint4*>(p + j * VW);
      unpack16<T>(v, f + j * VW);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(p[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&f)[N]) {
  if constexpr (N * sizeof(T) % 16 == 0) {
    constexpr int VW = Vec16<T>::N;
#pragma unroll
    for (int j = 0; j < N / VW; ++j) *reinterpret_cast<uint4*>(p + j * VW) = pack16(f + j * VW, T());
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = from_f<T>(f[j]);
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// blocks of `kernel` an SM holds at once with `threads` threads, asked once
// per kernel: the grids below hold exactly what is resident, each block then
// walks its share of the rows, so no wave of blocks runs part-empty
template <typename K>
int resident_blocks(K kernel, int threads) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0);
  return n > 0 ? n : 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- residual add + RMSNorm: one warp a row ------------------------------
constexpr int NORM_WARPS = 8;  // warps (rows in flight) a block

// d a multiple of VW = 16 / sizeof(T) and at most NCH * 32 * VW: lane l holds
// the 16-byte chunks l, l + 32, ... of its row (x + d, rounded) in registers;
// the weight, widened to f32, is held in registers (up to 32 values a lane) or
// in shared memory (wider rows), loaded once a block.
template <typename T, typename WT, int NCH, bool RESID>
__global__ void __launch_bounds__(NORM_WARPS * 32) add_rms_norm_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ dx, const WT* __restrict__ w, T* __restrict__ xo,
    T* __restrict__ h, int rows, int d, float eps) {
  constexpr int VW = Vec16<T>::N;
  constexpr bool W_REGS = NCH * VW <= 32;
  __shared__ float wsm[W_REGS ? 1 : NCH * 32 * VW];
  const int lane = threadIdx.x & 31;
  float wr[W_REGS ? NCH * VW : 1];
  if constexpr (W_REGS) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        const int e = (c * 32 + lane) * VW + i;
        wr[c * VW + i] = e < d ? to_f(w[e]) : 0.f;
      }
  } else {
    for (int e = threadIdx.x; e < d; e += blockDim.x) wsm[e] = to_f(w[e]);
    __syncthreads();
  }
  const float inv_d = 1.f / d;  // PyTorch's mean: the sum times this factor
  for (long long row = (long long)blockIdx.x * NORM_WARPS + (threadIdx.x >> 5); row < rows;
       row += (long long)gridDim.x * NORM_WARPS) {
    const uintptr_t xr = reinterpret_cast<uintptr_t>(x + row * d);
    uint4 v[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if ((c * 32 + lane) * VW < d) v[c] = ldg16(xr + (uintptr_t)(c * 32 + lane) * 16);
    if constexpr (RESID) {
      const uintptr_t dr = reinterpret_cast<uintptr_t>(dx + row * d);
      uint4 r[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        if ((c * 32 + lane) * VW < d) r[c] = ldg16(dr + (uintptr_t)(c * 32 + lane) * 16);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int e0 = (c * 32 + lane) * VW;
        if (e0 < d) {
          float a[VW], b[VW];
          unpack16<T>(v[c], a);
          unpack16<T>(r[c], b);
#pragma unroll
          for (int i = 0; i < VW; ++i) a[i] = __fadd_rn(a[i], b[i]);
          v[c] = pack16(a, T());
          *reinterpret_cast<uint4*>(xo + row * d + e0) = v[c];
        }
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if ((c * 32 + lane) * VW < d) {
        float f[VW];
        unpack16<T>(v[c], f);
#pragma unroll
        for (int i = 0; i < VW; ++i) ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));  // PyTorch squares, then sums
      }
    ss = warp_sum(ss);
    const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
    T* hrow = h + row * d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e0 = (c * 32 + lane) * VW;
      if (e0 < d) {
        float f[VW];
        unpack16<T>(v[c], f);
#pragma unroll
        for (int i = 0; i < VW; ++i) f[i] = __fmul_rn(__fmul_rn(f[i], inv), W_REGS ? wr[c * VW + i] : wsm[e0 + i]);
        *reinterpret_cast<uint4*>(hrow + e0) = pack16(f, T());
      }
    }
  }
}

// any d: one warp a row, element by element; the rounded sum is written to
// xo first and read back by the lane that wrote it
template <typename T, typename WT, bool RESID>
__global__ void __launch_bounds__(NORM_WARPS * 32) add_rms_norm_any_kernel(
    const T* __restrict__ x, const T* __restrict__ dx, const WT* __restrict__ w, T* xo, T* __restrict__ h,
    int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.f / d;
  for (long long row = (long long)blockIdx.x * NORM_WARPS + (threadIdx.x >> 5); row < rows;
       row += (long long)gridDim.x * NORM_WARPS) {
    const T* src = RESID ? xo + row * d : x + row * d;
    float ss = 0.f;
    for (int e = lane; e < d; e += 32) {
      float f = to_f(x[row * d + e]);
      if constexpr (RESID) {
        const T s = from_f<T>(__fadd_rn(f, to_f(dx[row * d + e])));
        xo[row * d + e] = s;
        f = to_f(s);
      }
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
    ss = warp_sum(ss);
    const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
    for (int e = lane; e < d; e += 32) h[row * d + e] = from_f<T>(__fmul_rn(__fmul_rn(to_f(src[e]), inv), to_f(w[e])));
  }
}

template <typename T, typename WT, bool RESID>
cudaError_t add_rms_norm(const void* xp, const void* dp, const void* wp, void* xop, void* hp, int rows, int d,
                         float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* dx = static_cast<const T*>(dp);
  const WT* w = static_cast<const WT*>(wp);
  T* xo = static_cast<T*>(xop);
  T* h = static_cast<T*>(hp);
  if (rows <= 0) return cudaSuccess;
  const int sms = sm_count();
  const long long need = ((long long)rows + NORM_WARPS - 1) / NORM_WARPS;
  constexpr int VW = Vec16<T>::N;
  const int nch = (d + 32 * VW - 1) / (32 * VW);
  const bool vec = d % VW == 0 && aligned16(x) && aligned16(h) && (!RESID || (aligned16(dx) && aligned16(xo)));
#define NORM_VEC(N)                                                                                \
  if (nch <= N) {                                                                                  \
    static const int per_sm = resident_blocks(add_rms_norm_vec_kernel<T, WT, N, RESID>, NORM_WARPS * 32); \
    const int blocks = (int)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);     \
    add_rms_norm_vec_kernel<T, WT, N, RESID><<<blocks, NORM_WARPS * 32, 0, s>>>(x, dx, w, xo, h, rows, d, eps); \
    return cudaGetLastError();                                                                     \
  }
  if (vec) {
    NORM_VEC(1) NORM_VEC(2) NORM_VEC(4) NORM_VEC(6) NORM_VEC(8) NORM_VEC(12) NORM_VEC(14) NORM_VEC(16)
  }
#undef NORM_VEC
  const int blocks = (int)(need < (long long)sms * 8 ? need : (long long)sms * 8);
  add_rms_norm_any_kernel<T, WT, RESID><<<blocks, NORM_WARPS * 32, 0, s>>>(x, dx, w, xo, h, rows, d, eps);
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t add_rms_norm_resid(const void* x, const void* dx, const void* w, void* xo, void* h, int rows, int d,
                               float eps, cudaStream_t s) {
  return dx ? add_rms_norm<T, WT, true>(x, dx, w, xo, h, rows, d, eps, s)
            : add_rms_norm<T, WT, false>(x, dx, w, xo, h, rows, d, eps, s);
}

// ---- bias + rotary, in place ---------------------------------------------
// A block walks rows (b, t) of the (B, T) grid; inside a row its threads take
// the items (head, chunk) of q's H and k's Hkv heads, a chunk being N columns
// of each half of the head (rotate_half: the pair (i, i + hd/2)), then the
// N-column chunks of v where v has a bias. The row's cos/sin (hd/2 f32 each)
// serve all its heads from L1. Each bias is added and rounded to T first, as
// the plain projection's `y + b` is; the rotation then is x1*c - x2*s and
// x2*c + x1*s, each product and sum rounded in f32, the result rounded to T.
template <typename T, int N>
__global__ void __launch_bounds__(512) bias_rope_kernel(T* q, T* k, T* v, const T* __restrict__ bq,
                                                       const T* __restrict__ bk, const T* __restrict__ bv,
                                                       const float* __restrict__ cosp,
                                                       const float* __restrict__ sinp, int rows, int tn, int H,
                                                       int Hkv, int hd, long long cs_b, long long cs_t) {
  const int half = hd / 2, nch = half / N;
  const int n_rot = (H + Hkv) * nch;
  const int per_row = n_rot + (bv ? Hkv * hd / N : 0);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long b = row / tn, t = row - b * tn;
    const float* cr = cosp + b * cs_b + t * cs_t;
    const float* sr = sinp + b * cs_b + t * cs_t;
    for (int i = threadIdx.x; i < per_row; i += blockDim.x) {
      if (i < n_rot) {
        const int head = i / nch, c = (i - head * nch) * N;
        T* base;
        const T* bias;
        if (head < H) {
          base = q + (row * H + head) * hd;
          bias = bq ? bq + head * hd : nullptr;
        } else {
          base = k + (row * Hkv + head - H) * hd;
          bias = bk ? bk + (head - H) * hd : nullptr;
        }
        float x1[N], x2[N], cs[N], sn[N];
        load_n<T, N, false>(base + c, x1);
        load_n<T, N, false>(base + half + c, x2);
        if (bias) {
          float b1[N], b2[N];
          load_n<T, N, true>(bias + c, b1);
          load_n<T, N, true>(bias + half + c, b2);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            x1[j] = round_to<T>(__fadd_rn(x1[j], b1[j]));
            x2[j] = round_to<T>(__fadd_rn(x2[j], b2[j]));
          }
        }
        load_n<float, N, true>(cr + c, cs);
        load_n<float, N, true>(sr + c, sn);
        float o1[N], o2[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          o1[j] = __fsub_rn(__fmul_rn(x1[j], cs[j]), __fmul_rn(x2[j], sn[j]));
          o2[j] = __fadd_rn(__fmul_rn(x2[j], cs[j]), __fmul_rn(x1[j], sn[j]));
        }
        store_n<T, N>(base + c, o1);
        store_n<T, N>(base + half + c, o2);
      } else {
        const int c = (i - n_rot) * N;  // column of the row's Hkv * hd
        T* p = v + row * Hkv * hd + c;
        float f[N], bb[N];
        load_n<T, N, false>(p, f);
        load_n<T, N, true>(bv + c, bb);
#pragma unroll
        for (int j = 0; j < N; ++j) f[j] = __fadd_rn(f[j], bb[j]);
        store_n<T, N>(p, f);
      }
    }
  }
}

template <typename T, int N>
cudaError_t bias_rope_launch(void* q, void* k, void* v, const void* bq, const void* bk, const void* bv,
                             const void* cosp, const void* sinp, int rows, int tn, int H, int Hkv, int hd,
                             long long cs_b, long long cs_t, cudaStream_t s) {
  const int per_row = (H + Hkv) * (hd / 2 / N) + (bv ? Hkv * hd / N : 0);
  int threads = (per_row + 31) / 32 * 32;
  threads = threads < 64 ? 64 : threads > 512 ? 512 : threads;
  const long long cap = (long long)sm_count() * (2048 / threads);
  const int blocks = (int)(rows < cap ? rows : cap);
  bias_rope_kernel<T, N><<<blocks, threads, 0, s>>>(static_cast<T*>(q), static_cast<T*>(k), static_cast<T*>(v),
                                    static_cast<const T*>(bq), static_cast<const T*>(bk),
                                    static_cast<const T*>(bv), static_cast<const float*>(cosp),
                                    static_cast<const float*>(sinp), rows, tn, H, Hkv, hd, cs_b, cs_t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bias_rope(void* q, void* k, void* v, const void* bq, const void* bk, const void* bv, const void* cosp,
                      const void* sinp, int rows, int tn, int H, int Hkv, int hd, long long cs_b, long long cs_t,
                      cudaStream_t s) {
  if (rows <= 0) return cudaSuccess;
  constexpr int VW = Vec16<T>::N;
  const void* ptrs[8] = {q, k, v, bq, bk, bv, cosp, sinp};
  bool vec = (hd / 2) % VW == 0 && cs_b % 4 == 0 && cs_t % 4 == 0;
  for (const void* p : ptrs) vec = vec && (p == nullptr || aligned16(p));
  return vec ? bias_rope_launch<T, VW>(q, k, v, bq, bk, bv, cosp, sinp, rows, tn, H, Hkv, hd, cs_b, cs_t, s)
             : bias_rope_launch<T, 1>(q, k, v, bq, bk, bv, cosp, sinp, rows, tn, H, Hkv, hd, cs_b, cs_t, s);
}

// ---- gated product --------------------------------------------------------
enum GluAct : int { ACT_SILU = 0, ACT_GELU_TANH = 1 };

// PyTorch's own forms on the card (ActivationSiluKernel.cu,
// ActivationGeluKernel.cu), written as they are there so that they compile
// to the same operations
template <int ACT>
__device__ __forceinline__ float act(float x) {
  if constexpr (ACT == ACT_SILU) {
    return x / (1.f + expf(-x));
  } else {
    constexpr float kBeta = (float)(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
    constexpr float kKappa = 0.044715f;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.f + tanhf(inner));
  }
}

// N elements a thread a step over the flat (rows * width) tensors, GLU_UNROLL
// steps a grid stride apart loaded before any is computed, so that each
// thread keeps that many 16-byte loads of g and of u in flight
constexpr int GLU_UNROLL = 2;  // device ms at the Qwen2.5-VL-7B prefill on an H100: 1: 2.98, 2: 2.88, 4: 3.60

template <typename T, int ACT, int N>
__global__ void __launch_bounds__(256) glu_kernel(const T* __restrict__ g, const T* __restrict__ u,
                                                  T* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x * N;
  for (long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * N; base < n;
       base += stride * GLU_UNROLL) {
    float a[GLU_UNROLL][N], b[GLU_UNROLL][N];
#pragma unroll
    for (int r = 0; r < GLU_UNROLL; ++r)
      if (base + r * stride < n) {
        load_n<T, N, true>(g + base + r * stride, a[r]);
        load_n<T, N, true>(u + base + r * stride, b[r]);
      }
#pragma unroll
    for (int r = 0; r < GLU_UNROLL; ++r)
      if (base + r * stride < n) {
#pragma unroll
        for (int j = 0; j < N; ++j) a[r][j] = __fmul_rn(round_to<T>(act<ACT>(a[r][j])), b[r][j]);
        store_n<T, N>(out + base + r * stride, a[r]);
      }
  }
}

template <typename T, int ACT>
cudaError_t glu(const void* g, const void* u, void* out, long long n, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  constexpr int VW = Vec16<T>::N;
  const bool vec = n % VW == 0 && aligned16(g) && aligned16(u) && aligned16(out);
  const long long items = vec ? n / VW : n;
  const long long need = (items + 256 * GLU_UNROLL - 1) / (256 * GLU_UNROLL);
  const T* gp = static_cast<const T*>(g);
  const T* up = static_cast<const T*>(u);
  T* op = static_cast<T*>(out);
  const int sms = sm_count();
  if (vec) {
    static const int per_sm = resident_blocks(glu_kernel<T, ACT, VW>, 256);
    glu_kernel<T, ACT, VW><<<(int)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm), 256, 0, s>>>(
        gp, up, op, n);
  } else {
    static const int per_sm = resident_blocks(glu_kernel<T, ACT, 1>, 256);
    glu_kernel<T, ACT, 1><<<(int)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm), 256, 0, s>>>(
        gp, up, op, n);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t glu_act(const void* g, const void* u, void* out, long long n, int act_code, cudaStream_t s) {
  if (act_code == ACT_SILU) return glu<T, ACT_SILU>(g, u, out, n, s);
  if (act_code == ACT_GELU_TANH) return glu<T, ACT_GELU_TANH>(g, u, out, n, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, d, xo, h (rows, dim) in `dtype`, d and xo null for no residual; w (dim,)
// in `w_dtype`. Writes xo = x + d and h = rms(xo) * w (h = rms(x) * w).
extern "C" int lm_add_rms_norm(const void* x, const void* d, const void* w, void* xo, void* h, int rows, int dim,
                               float eps, int dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16 && w_dtype == DT_BF16)
    return (int)add_rms_norm_resid<__nv_bfloat16, __nv_bfloat16>(x, d, w, xo, h, rows, dim, eps, s);
  if (dtype == DT_BF16 && w_dtype == DT_F32)
    return (int)add_rms_norm_resid<__nv_bfloat16, float>(x, d, w, xo, h, rows, dim, eps, s);
  if (dtype == DT_F32 && w_dtype == DT_F32) return (int)add_rms_norm_resid<float, float>(x, d, w, xo, h, rows, dim, eps, s);
  if (dtype == DT_F32 && w_dtype == DT_BF16)
    return (int)add_rms_norm_resid<float, __nv_bfloat16>(x, d, w, xo, h, rows, dim, eps, s);
  return (int)cudaErrorInvalidValue;
}

// q (rows, H, hd), k and v (rows, Hkv, hd) in `dtype`, rows = B * T in (b, t)
// order; biases (H * hd,), (Hkv * hd,) in `dtype` or null; cos, sin f32 with
// row (b, t) at b * cs_b + t * cs_t, hd / 2 contiguous values each.
extern "C" int lm_bias_rope(void* q, void* k, void* v, const void* bq, const void* bk, const void* bv,
                            const void* cosp, const void* sinp, int rows, int tn, int H, int Hkv, int hd,
                            long long cs_b, long long cs_t, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 2 != 0 || tn <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)bias_rope<__nv_bfloat16>(q, k, v, bq, bk, bv, cosp, sinp, rows, tn, H, Hkv, hd, cs_b, cs_t, s);
  if (dtype == DT_F32) return (int)bias_rope<float>(q, k, v, bq, bk, bv, cosp, sinp, rows, tn, H, Hkv, hd, cs_b, cs_t, s);
  return (int)cudaErrorInvalidValue;
}

// g, u, out: n elements each in `dtype`; out = act(g) * u, act 0 SiLU, 1 tanh-GELU.
extern "C" int lm_glu(const void* g, const void* u, void* out, long long n, int act_code, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return (int)glu_act<__nv_bfloat16>(g, u, out, n, act_code, s);
  if (dtype == DT_F32) return (int)glu_act<float>(g, u, out, n, act_code, s);
  return (int)cudaErrorInvalidValue;
}
