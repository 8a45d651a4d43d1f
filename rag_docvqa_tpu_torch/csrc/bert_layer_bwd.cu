// K10: the BERT encoder layer backward, split where the TPU kernels split
// it: at x1 = LN1(x + attn(x)), the activation the train forward saves. The
// products, the LayerNorm backward and the bias sums are built here; the
// attention part is K6 (flash_bwd.cu) and the recompute K9 (bert_layer.cu)
// and K2 (flash_fwd.cu). ops/fused_encoder.py composes them:
//
//   bert_ffn_bwd, FFN + LN2 backward, from the saved x1 and the cotangent g at out:
//     h1 = x1 . W1^T + b1 (f32) -> ge = cast(gelu(h1)), dge = gelu'(h1) (f32)
//                                                        gemm NT, bias_gelu_grad
//     y2 = x1 + (ge . W2^T + b2) (f32)                   bert_gemm, bias_residual_f32
//     dy2 (f32), cast(dy2), dln2, db2 = sum_rows(dy2)    bert_ln_bwd
//     dW2 = cast(dy2)^T . ge (f32)                       gemm TN
//     dpre32 = (cast(dy2) . W2) * dge (f32), dpre = cast(dpre32)   gemm NN, mul_f32
//     db1 = sum_rows(dpre32)                             bert_col_sum
//     dW1 = dpre^T . x1 (f32)                            gemm TN
//     dx1 = cast(dy2 + dpre . W1)                        gemm NN, add_f32_store
//
//   bert_attn_bwd, attention + LN1 backward, from the saved x and the cotangent dy at x1:
//     qkv = cast(x . Wqkv^T + bqkv); a, lse = K2; y1 = x + (a . Wo^T + bo)   (recompute)
//     dy1 (f32), dao = cast(dy1), dln1, dbo = sum_rows(dy1)   bert_ln_bwd
//     dWo = dao^T . a (f32); da = cast(dao . Wo)         gemm TN, NN
//     dq, dk, dv = K6(q, k, v, a, lse, da)  -> dqkv
//     dWqkv = dqkv^T . x (f32); dbqkv = sum_rows(dqkv)   gemm TN, bert_col_sum
//     dx = cast(dy1 + dqkv . Wqkv)                       gemm NN, add_f32_store
//
// Replaces the TPU kernels `_bert_ffn_bwd_kernel` and `_bert_attn_bwd_kernel`
// of rag_docvqa_tpu/ops/fused_encoder_bwd.py, called from `_bert_ffn_bwd_impl`
// and `_bert_attn_bwd_impl`. Those keep a half-layer for a block of
// sequences in VMEM and accumulate every weight and bias gradient in resident
// f32 blocks across the sequential grid. Here a weight gradient is one GEMM
// over all B*T rows and a bias or LayerNorm gradient is summed over rows in
// two passes of fixed order: deterministic, no float atomics. Weights are in
// the port's (out, in) layout: forward x . W^T, so dX = dY . W, dW = dY^T . X.
//
// What bounds it on the H100: the GEMMs (gemm_bwd.cuh's wgmma template),
// about 2x the forward's products; at bge-small B 256 T 64 its epilogues make
// them bound by bytes (mul_f32 reads and writes f32 (M, N) rows: bound 0.08
// ms, ~0.14 on the card at 700 W, chip_smoke.py phase 8e). The LayerNorm
// backward and the column sums are bound by memory.
#include <algorithm>

#include "gemm_bwd.cuh"

namespace {

// ---- LayerNorm backward: one warp a row -------------------------------------
// For out = n * w + b with n = (y - mean) * rstd and the cotangent g at out:
//   dn = g * w;  dy = rstd * (dn - mean(dn) - n * mean(dn * n))
// written as f32 and in the compute dtype (fused_encoder_bwd.py::_ln_bwd). The
// per-column sums g * n, g and dy accumulate in each lane's registers across
// the rows its warp takes (a grid-stride loop over a grid fixed by the row
// count, ops/fused_encoder.py::ln_bwd_blocks); the block adds its warps in warp
// order into one row of `part` (nblocks, 3, d), and `part_sum_kernel` adds the
// blocks' rows in a fixed order. Bound by memory: y (f32) and g read once, dy
// in f32 and in the compute dtype written once; no block barrier inside a row.
constexpr int LNB_WARPS = 8;     // warps (rows in flight) a block
constexpr int LNB_MAX_D = 4096;

// 4 consecutive elements of T, packed as loaded (16 bytes of f32, 8 of bf16)
template <typename T> struct Quad;
template <> struct Quad<float> {
  uint4 w;
  __device__ __forceinline__ void load(const float* p) { w = ldg16(reinterpret_cast<uintptr_t>(p)); }
  __device__ __forceinline__ void get(float* v) const { unpack16<float>(w, v); }
  __device__ static void store(float* p, const float* v) { *reinterpret_cast<uint4*>(p) = pack16(v, float()); }
};
template <> struct Quad<__nv_bfloat16> {
  uint2 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { w = __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ __forceinline__ void get(float* v) const {
    v[0] = __uint_as_float(w.x << 16), v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16), v[3] = __uint_as_float(w.y & 0xffff0000u);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
};

// d a multiple of 4 and at most NCH * 128 (768 in the largest form): lane l holds columns 4 (l + 32 c)
// .. + 3, c < NCH, of its row in registers, so every load and store of a warp
// is one contiguous run of 512 (f32) or 256 (bf16) bytes; the loads of the
// warp's next row are in flight while it works on this one. The weight,
// widened to f32, is in shared memory.
template <typename T, int NCH>
__global__ void __launch_bounds__(LNB_WARPS * 32, NCH <= 4 ? 2 : 1) ln_bwd_vec_kernel(
    const float* __restrict__ y, const T* __restrict__ g, const T* __restrict__ ln,
    float* __restrict__ dy32, T* __restrict__ dyc, float* __restrict__ part, int rows, int d,
    float eps) {
  constexpr int NV = NCH * 4;
  __shared__ float wsm[NCH * 128];
  __shared__ float comb[3 * NCH * 128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < d; e += blockDim.x) wsm[e] = to_f(ln[e]);
  float pw[NV], pb[NV], pd[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) pw[i] = pb[i] = pd[i] = 0.f;
  __syncthreads();
  const float inv_d = 1.f / d;
  const long long stride = (long long)gridDim.x * LNB_WARPS;
  long long row = (long long)blockIdx.x * LNB_WARPS + warp;
  Quad<float> cy[NCH], ny[NCH];
  Quad<T> cg[NCH], ng[NCH];
  auto load = [&](long long r, Quad<float>(&qy)[NCH], Quad<T>(&qg)[NCH]) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e0 = (c * 32 + lane) * 4;
      if (e0 < d) {
        qy[c].load(y + r * d + e0);
        qg[c].load(g + r * d + e0);
      }
    }
  };
  if (row < rows) load(row, cy, cg);
  for (; row < rows; row += stride) {
    if (row + stride < rows) load(row + stride, ny, ng);
    float yv[NV], gv[NV];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if ((c * 32 + lane) * 4 < d) {
        cy[c].get(yv + 4 * c);
        cg[c].get(gv + 4 * c);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[4 * c + i] = gv[4 * c + i] = 0.f;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) s += yv[i];
    const float mean = warp_sum(s) * inv_d;
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if ((c * 32 + lane) * 4 < d)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = yv[4 * c + i] - mean;
          v = fmaf(x, x, v);
        }
    const float rstd = rsqrtf(warp_sum(v) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e0 = (c * 32 + lane) * 4;
      if (e0 < d)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * c + i;
          yv[j] = (yv[j] - mean) * rstd;  // n
          const float dn = gv[j] * wsm[e0 + i];
          s1 += dn;
          s2 = fmaf(dn, yv[j], s2);
        }
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e0 = (c * 32 + lane) * 4;
      if (e0 < d) {
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * c + i;
          o[i] = rstd * (gv[j] * wsm[e0 + i] - m1 - yv[j] * m2);
          pw[j] = fmaf(gv[j], yv[j], pw[j]);
          pb[j] += gv[j];
          pd[j] += o[i];
        }
        Quad<float>::store(dy32 + row * d + e0, o);
        Quad<T>::store(dyc + row * d + e0, o);
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      cy[c] = ny[c];
      cg[c] = ng[c];
    }
  }
  // the block's warps, added in warp order
  for (int k = 0; k < LNB_WARPS; ++k) {
    if (warp == k) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int e0 = (c * 32 + lane) * 4;
        if (e0 < d)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * c + i;
            comb[e0 + i] = k ? comb[e0 + i] + pw[j] : pw[j];
            comb[d + e0 + i] = k ? comb[d + e0 + i] + pb[j] : pb[j];
            comb[2 * d + e0 + i] = k ? comb[2 * d + e0 + i] + pd[j] : pd[j];
          }
      }
    }
    __syncthreads();
  }
  float* p = part + (long long)blockIdx.x * 3 * d;
  for (int e = threadIdx.x; e < 3 * d; e += blockDim.x) p[e] = comb[e];
}

// any d <= LNB_MAX_D: one warp a row, element by element (y and g read again
// from L1/L2 in each pass), each warp's column sums in its own rows of
// dynamic shared memory [warps][3][d]
template <typename T>
__global__ void __launch_bounds__(LNB_WARPS * 32) ln_bwd_any_kernel(
    const float* __restrict__ y, const T* __restrict__ g, const T* __restrict__ ln,
    float* __restrict__ dy32, T* __restrict__ dyc, float* __restrict__ part, int rows, int d,
    float eps) {
  extern __shared__ float sums_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float* mine = sums_smem + warp * 3 * d;
  for (int e = lane; e < 3 * d; e += 32) mine[e] = 0.f;
  __syncwarp();  // a lane adds into columns another lane zeroed
  const float inv_d = 1.f / d;
  for (long long row = (long long)blockIdx.x * warps + warp; row < rows; row += (long long)gridDim.x * warps) {
    const float* yr = y + row * d;
    const T* gr = g + row * d;
    float s = 0.f;
    for (int e = lane; e < d; e += 32) s += yr[e];
    const float mean = warp_sum(s) * inv_d;
    float v = 0.f;
    for (int e = lane; e < d; e += 32) {
      const float x = yr[e] - mean;
      v = fmaf(x, x, v);
    }
    const float rstd = rsqrtf(warp_sum(v) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int e = lane; e < d; e += 32) {
      const float dn = to_f(gr[e]) * to_f(ln[e]);
      s1 += dn;
      s2 = fmaf(dn, (yr[e] - mean) * rstd, s2);
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    for (int e = lane; e < d; e += 32) {
      const float gv = to_f(gr[e]), n = (yr[e] - mean) * rstd;
      const float o = rstd * (gv * to_f(ln[e]) - m1 - n * m2);
      mine[e] = fmaf(gv, n, mine[e]);
      mine[d + e] += gv;
      mine[2 * d + e] += o;
      dy32[row * d + e] = o;
      dyc[row * d + e] = from_f<T>(o);
    }
  }
  __syncthreads();
  float* p = part + (long long)blockIdx.x * 3 * d;
  for (int e = threadIdx.x; e < 3 * d; e += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < warps; ++k) acc += sums_smem[k * 3 * d + e];
    p[e] = acc;
  }
}

template <typename T>
cudaError_t ln_bwd(const void* yp, const void* gp, const void* lnp, void* dy32p, void* dycp,
                   void* sumsp, void* partp, int rows, int d, int nblocks, float eps, cudaStream_t s) {
  const float* y = static_cast<const float*>(yp);
  const T* g = static_cast<const T*>(gp);
  const T* ln = static_cast<const T*>(lnp);
  float* dy32 = static_cast<float*>(dy32p);
  T* dyc = static_cast<T*>(dycp);
  float* part = static_cast<float*>(partp);
  // every row's y and dy32 on 16 bytes, its g and dyc on 4 elements
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(dy32);
  const uintptr_t aq = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dyc);
  const bool vec = d % 4 == 0 && (a16 & 15) == 0 && (aq & (4 * sizeof(T) - 1)) == 0;
  const int nch = (d + 127) / 128;
#define LNB_VEC(N)                                                                                    \
  if (nch <= N) {                                                                                     \
    ln_bwd_vec_kernel<T, N><<<nblocks, LNB_WARPS * 32, 0, s>>>(y, g, ln, dy32, dyc, part, rows, d, eps); \
    break;                                                                                            \
  }
  do {
    if (vec) {
      LNB_VEC(1) LNB_VEC(2) LNB_VEC(3) LNB_VEC(4) LNB_VEC(6)
    }
    // as many warps as their sums fit 200 KB of shared memory (4 at d 4096)
    const int warps = std::min(LNB_WARPS, (200 * 1024) / (12 * d));
    const int smem = warps * 3 * d * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(ln_bwd_any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ln_bwd_any_kernel<T><<<nblocks, warps * 32, smem, s>>>(y, g, ln, dy32, dyc, part, rows, d, eps);
  } while (false);
#undef LNB_VEC
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return part_sum(part, sumsp, nblocks, 3 * d, s);
}

// ---- column sums over rows ---------------------------------------------------
// out[j] = sum over rows of x[r, j] in f32: a bias gradient. Bound by memory:
// x read once. The rows are cut into `nranges` ranges (ops/fused_encoder.py::
// col_sum_ranges, a function of (rows, n) alone, sized so that the (strip,
// range) blocks of one wave fill the card) and the columns into strips; a
// block sums its strip over its range into one row of part (nranges, n), and
// part_sum_kernel (gemm_bwd.cuh) adds the ranges in range order. Within a
// range, warp k takes the k-th eighth of the rows, in row order, with CS_DEPTH
// rows' loads in flight, and the warps are added in warp order: the same bits
// on every launch, no atomics.
constexpr int CS_WARPS = 8;
constexpr int CS_DEPTH = 8;  // rows whose loads a warp has in flight before it adds them

// the rows [x, y) that warp `warp` of this block sums: the warp-th eighth of
// the block's row range blockIdx.y
__device__ __forceinline__ int2 cs_warp_rows(int rows, int range_rows, int warp) {
  const int r_end = min(rows, (int)blockIdx.y * range_rows + range_rows);
  const int per_warp = (range_rows + CS_WARPS - 1) / CS_WARPS;
  const int begin = min(r_end, (int)blockIdx.y * range_rows + warp * per_warp);
  return make_int2(begin, min(r_end, begin + per_warp));
}

// n a multiple of VW = 16 / sizeof(T) and every row 16-byte aligned: a strip
// is 32 * VW columns (256 bf16, 128 f32), lane l holding the VW columns of
// the l-th 16-byte chunk, so each load of a warp is one contiguous 512 bytes
template <typename T>
__global__ void __launch_bounds__(CS_WARPS * 32) col_sum_vec_kernel(const T* __restrict__ x,
                                                                    float* __restrict__ part, int rows, int n,
                                                                    int range_rows) {
  constexpr int VW = Vec16<T>::N;
  __shared__ float comb[CS_WARPS][32 * VW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = (blockIdx.x * 32 + lane) * VW;
  const int2 wr = cs_warp_rows(rows, range_rows, warp);
  const int w_begin = wr.x, w_end = wr.y;
  float acc[VW];
#pragma unroll
  for (int i = 0; i < VW; ++i) acc[i] = 0.f;
  if (e0 < n) {
    const T* col = x + e0;
    int r = w_begin;
    for (; r + CS_DEPTH <= w_end; r += CS_DEPTH) {
      uint4 v[CS_DEPTH];
#pragma unroll
      for (int u = 0; u < CS_DEPTH; ++u) v[u] = ldg16(reinterpret_cast<uintptr_t>(col + (long long)(r + u) * n));
#pragma unroll
      for (int u = 0; u < CS_DEPTH; ++u) {
        float f[VW];
        unpack16<T>(v[u], f);
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] += f[i];
      }
    }
    for (; r < w_end; ++r) {
      float f[VW];
      unpack16<T>(ldg16(reinterpret_cast<uintptr_t>(col + (long long)r * n)), f);
#pragma unroll
      for (int i = 0; i < VW; ++i) acc[i] += f[i];
    }
  }
#pragma unroll
  for (int i = 0; i < VW; ++i) comb[warp][lane * VW + i] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < 32 * VW; c += blockDim.x) {
    const int j = blockIdx.x * 32 * VW + c;
    if (j < n) {
      float t = comb[0][c];
#pragma unroll
      for (int k = 1; k < CS_WARPS; ++k) t += comb[k][c];
      part[(long long)blockIdx.y * n + j] = t;
    }
  }
}

// any n and alignment: a strip is 32 columns, lane l the l-th, element by element
template <typename T>
__global__ void __launch_bounds__(CS_WARPS * 32) col_sum_any_kernel(const T* __restrict__ x,
                                                                    float* __restrict__ part, int rows, int n,
                                                                    int range_rows) {
  __shared__ float comb[CS_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, j = blockIdx.x * 32 + lane;
  const int2 wr = cs_warp_rows(rows, range_rows, warp);
  const int w_begin = wr.x, w_end = wr.y;
  float acc = 0.f;
  if (j < n) {
    int r = w_begin;
    for (; r + CS_DEPTH <= w_end; r += CS_DEPTH) {
      float v[CS_DEPTH];
#pragma unroll
      for (int u = 0; u < CS_DEPTH; ++u) v[u] = to_f(x[(long long)(r + u) * n + j]);
#pragma unroll
      for (int u = 0; u < CS_DEPTH; ++u) acc += v[u];
    }
    for (; r < w_end; ++r) acc += to_f(x[(long long)r * n + j]);
  }
  comb[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && j < n) {
    float t = comb[0][lane];
#pragma unroll
    for (int k = 1; k < CS_WARPS; ++k) t += comb[k][lane];
    part[(long long)blockIdx.y * n + j] = t;
  }
}

template <typename T>
cudaError_t col_sum(const void* xp, void* out, void* partp, int rows, int n, int nranges, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  float* part = static_cast<float*>(partp);
  constexpr int VW = Vec16<T>::N;
  const int range_rows = std::max(1, (rows + nranges - 1) / nranges);
  if (n % VW == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0)
    col_sum_vec_kernel<T><<<dim3((n + 32 * VW - 1) / (32 * VW), nranges), CS_WARPS * 32, 0, s>>>(x, part, rows, n,
                                                                                                range_rows);
  else
    col_sum_any_kernel<T><<<dim3((n + 31) / 32, nranges), CS_WARPS * 32, 0, s>>>(x, part, rows, n, range_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return part_sum(part, out, nranges, n, s);
}

}  // namespace

// C (M, N) = epilogue(A . B) in `layout` for the pairs (NT, bias_gelu_grad:
// aux0 = bias (N,), out0 in `dtype`, out1 f32), (NN, mul_f32: aux0 (M, N) f32,
// out0 f32, out1 in `dtype`), (NN, add_f32_store: aux0 (M, N) f32, out0 in
// `dtype`); a and b in `dtype`, contiguous. Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for any other pair.
extern "C" int bert_gemm_bwd(const void* a, const void* b, void* out0, void* out1, const void* aux0,
                             int M, int N, int K, int layout, int dtype, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiPtrs e{out0, out1, nullptr, aux0, nullptr};
  cudaError_t err = cudaErrorInvalidValue;
  if (layout == L_NT && epi == E_BIAS_GELU_GRAD)
    err = gemm_bwd<L_NT, E_BIAS_GELU_GRAD>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_MUL_F32)
    err = gemm_bwd<L_NN, E_MUL_F32>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_ADD_F32_STORE)
    err = gemm_bwd<L_NN, E_ADD_F32_STORE>(dtype, a, b, e, M, N, K, s);
  return (int)err;
}

// y (rows, d) f32, the sum the LayerNorm read; g (rows, d) and ln (2, d) in
// `dtype`; dy32 (rows, d) f32 and dyc (rows, d) in `dtype`; sums (3, d) f32 =
// [dscale; dbias; sum_rows(dy)]; part (nblocks, 3, d) f32 scratch, nblocks the
// grid (ops/fused_encoder.py::ln_bwd_blocks). d <= 4096.
extern "C" int bert_ln_bwd(const void* y, const void* g, const void* ln, void* dy32, void* dyc,
                           void* sums, void* part, int rows, int d, int nblocks, float eps, int dtype,
                           void* stream) {
  if (d <= 0 || d > LNB_MAX_D || nblocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return (int)ln_bwd<float>(y, g, ln, dy32, dyc, sums, part, rows, d, nblocks, eps, s);
  if (dtype == DT_BF16) return (int)ln_bwd<__nv_bfloat16>(y, g, ln, dy32, dyc, sums, part, rows, d, nblocks, eps, s);
  return (int)cudaErrorInvalidValue;
}

// out (n,) f32 = sum over rows of x (rows, n) in `dtype` (DT_F32 or DT_BF16),
// in two passes of fixed order; part (nranges, n) f32 scratch, nranges the
// row ranges (ops/fused_encoder.py::col_sum_ranges), 1 <= nranges <= 65535.
extern "C" int bert_col_sum(const void* x, void* out, void* part, int rows, int n, int nranges, int dtype,
                            void* stream) {
  if (n <= 0 || nranges <= 0 || nranges > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return (int)col_sum<float>(x, out, part, rows, n, nranges, s);
  if (dtype == DT_BF16) return (int)col_sum<__nv_bfloat16>(x, out, part, rows, n, nranges, s);
  return (int)cudaErrorInvalidValue;
}
