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
// What bounds it on the H100: the GEMMs by operations, as in the forward: at
// t5-base B 8 T 512 a layer's backward is ~2x its forward's products (each
// product's bound ~0.02 ms). The bf16 GEMM is gemm_bwd.cuh's wgmma template
// (SIMT for f32), shared with the BERT layer backward; on the H100 (700 W,
// chip_smoke.py phase 6b, device time) dWi 3072x768 over 4096 rows takes 0.06
// ms and dh2 0.045 ms, 1.7-2x behind torch.matmul's bare product, and the
// relu_bwd product ~0.09 ms, where the epilogue's aux read and two outputs
// are not overlapped with the tensor cores. K7 is then ~0.44 ms and K8 ~2.4,
// of which K6 is 2.0. The norm backward is bound by memory.
#include "gemm_bwd.cuh"

namespace {

// ---- RMSNorm backward: one warp a row --------------------------------------
// dx = rstd * dn - x * rstd^3 * sum(dn * x) / d with dn = dh * w, written as
// cast(resid + dx), and dw = sum_rows(dh * n), n = x * rstd
// (fused_encoder_bwd.py::_rms_bwd). Bound by memory: x, dh (f32) and resid
// read once, dx written once. A warp takes a row and loops over rows with
// the grid's stride (ops/fused_encoder.py::rms_bwd_blocks, a function of the
// row count alone); both row sums are warp shuffles, with no block barrier.
// The per-column sums dh * n accumulate in each lane's registers across the
// warp's rows; the block adds its warps in warp order into one row of
// `part` (nblocks, d), and part_sum_kernel (gemm_bwd.cuh) adds the blocks'
// rows in a fixed order: no atomics, the same bits on every launch.
constexpr int RMSB_WARPS = 8;      // warps (rows in flight) a block
constexpr int RMSB_MAX_D = 4096;

// d a multiple of VW = 16 / sizeof(T) and at most NCH * 32 * VW: lane l holds
// the VW-column chunks l, l + 32, ... of its row as loaded, 16 bytes of x and
// of resid and 16 (f32 x) or 32 (bf16 x) bytes of dh a chunk, so every load
// of a warp is one contiguous run; the next row's loads are in flight while
// the warp works on this one. The weight, widened to f32, is in shared memory.
// The two rows' buffers take up to ~190 registers (bf16 d 1024), so one block
// an SM (RMSB_WARPS rows and their successors in flight).
template <typename T, typename WT, int NCH>
__global__ void __launch_bounds__(RMSB_WARPS * 32, 1) rms_bwd_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ dh, const WT* __restrict__ w,
    const T* __restrict__ resid, T* __restrict__ dx, float* __restrict__ part, int rows, int d, float eps) {
  constexpr int VW = Vec16<T>::N, DHV = VW / 4, NV = NCH * VW;
  __shared__ float wsm[NV * 32];
  __shared__ float comb[NV * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < d; e += blockDim.x) wsm[e] = to_f(w[e]);
  float pw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) pw[i] = 0.f;
  __syncthreads();
  const float inv_d = 1.f / d;
  const long long stride = (long long)gridDim.x * RMSB_WARPS;
  long long row = (long long)blockIdx.x * RMSB_WARPS + warp;
  uint4 cx[NCH], cg[NCH][DHV], cr[NCH], nx[NCH], ng[NCH][DHV], nr[NCH];
  auto load = [&](long long r, uint4(&qx)[NCH], uint4(&qg)[NCH][DHV], uint4(&qr)[NCH]) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e0 = (c * 32 + lane) * VW;
      if (e0 < d) {
        qx[c] = ldg16(reinterpret_cast<uintptr_t>(x + r * d + e0));
#pragma unroll
        for (int k = 0; k < DHV; ++k) qg[c][k] = ldg16(reinterpret_cast<uintptr_t>(dh + r * d + e0 + 4 * k));
        qr[c] = ldg16(reinterpret_cast<uintptr_t>(resid + r * d + e0));
      }
    }
  };
  if (row < rows) load(row, cx, cg, cr);
  for (; row < rows; row += stride) {
    if (row + stride < rows) load(row + stride, nx, ng, nr);
    float ss = 0.f, sdx = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e0 = (c * 32 + lane) * VW;
      if (e0 < d) {
        float xv[VW], gv[VW];
        unpack16<T>(cx[c], xv);
#pragma unroll
        for (int k = 0; k < DHV; ++k) unpack16<float>(cg[c][k], gv + 4 * k);
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          ss = fmaf(xv[i], xv[i], ss);
          sdx = fmaf(gv[i] * wsm[e0 + i], xv[i], sdx);
        }
      }
    }
    ss = warp_sum(ss);
    sdx = warp_sum(sdx);
    const float rstd = rsqrtf(ss / d + eps);
    const float coef = rstd * rstd * rstd * (sdx * inv_d);
    T* orow = dx + row * d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e0 = (c * 32 + lane) * VW;
      if (e0 < d) {
        float xv[VW], gv[VW], o[VW];
        unpack16<T>(cx[c], xv);
#pragma unroll
        for (int k = 0; k < DHV; ++k) unpack16<float>(cg[c][k], gv + 4 * k);
        unpack16<T>(cr[c], o);
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          pw[c * VW + i] = fmaf(gv[i], xv[i] * rstd, pw[c * VW + i]);
          o[i] = o[i] + (rstd * (gv[i] * wsm[e0 + i]) - xv[i] * coef);
        }
        *reinterpret_cast<uint4*>(orow + e0) = pack16(o, T());
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      cx[c] = nx[c];
      cr[c] = nr[c];
#pragma unroll
      for (int k = 0; k < DHV; ++k) cg[c][k] = ng[c][k];
    }
  }
  // the block's warps, added in warp order
  for (int k = 0; k < RMSB_WARPS; ++k) {
    if (warp == k) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int e0 = (c * 32 + lane) * VW;
        if (e0 < d)
#pragma unroll
          for (int i = 0; i < VW; ++i) comb[e0 + i] = k ? comb[e0 + i] + pw[c * VW + i] : pw[c * VW + i];
      }
    }
    __syncthreads();
  }
  float* p = part + (long long)blockIdx.x * d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) p[e] = comb[e];
}

// any d <= RMSB_MAX_D, any alignment: one warp a row, element by element (x
// and dh read again from L1/L2 in the second pass), each warp's column sums
// in its own row of dynamic shared memory [RMSB_WARPS][d]
template <typename T, typename WT>
__global__ void __launch_bounds__(RMSB_WARPS * 32) rms_bwd_any_kernel(
    const T* __restrict__ x, const float* __restrict__ dh, const WT* __restrict__ w,
    const T* __restrict__ resid, T* __restrict__ dx, float* __restrict__ part, int rows, int d, float eps) {
  extern __shared__ float rms_sums_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mine = rms_sums_smem + warp * d;
  for (int e = lane; e < d; e += 32) mine[e] = 0.f;
  const float inv_d = 1.f / d;
  for (long long row = (long long)blockIdx.x * RMSB_WARPS + warp; row < rows;
       row += (long long)gridDim.x * RMSB_WARPS) {
    const T* xr = x + row * d;
    const float* gr = dh + row * d;
    float ss = 0.f, sdx = 0.f;
    for (int e = lane; e < d; e += 32) {
      const float xv = to_f(xr[e]);
      ss = fmaf(xv, xv, ss);
      sdx = fmaf(gr[e] * to_f(w[e]), xv, sdx);
    }
    ss = warp_sum(ss);
    sdx = warp_sum(sdx);
    const float rstd = rsqrtf(ss / d + eps);
    const float coef = rstd * rstd * rstd * (sdx * inv_d);
    const T* rr = resid + row * d;
    T* out = dx + row * d;
    for (int e = lane; e < d; e += 32) {
      const float xv = to_f(xr[e]), g = gr[e];
      mine[e] = fmaf(g, xv * rstd, mine[e]);
      out[e] = from_f<T>(to_f(rr[e]) + (rstd * (g * to_f(w[e])) - xv * coef));
    }
  }
  __syncthreads();
  float* p = part + (long long)blockIdx.x * d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < RMSB_WARPS; ++k) acc += rms_sums_smem[k * d + e];
    p[e] = acc;
  }
}

template <typename T, typename WT>
cudaError_t rms_bwd(const void* xp, const void* dhp, const void* wp, const void* residp, void* dxp, void* dwp,
                    void* partp, int rows, int d, int nblocks, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const float* dh = static_cast<const float*>(dhp);
  const WT* w = static_cast<const WT*>(wp);
  const T* resid = static_cast<const T*>(residp);
  T* dx = static_cast<T*>(dxp);
  float* part = static_cast<float*>(partp);
  constexpr int VW = Vec16<T>::N;
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dh) |
                        reinterpret_cast<uintptr_t>(resid) | reinterpret_cast<uintptr_t>(dx);
  const bool vec = d % VW == 0 && (a16 & 15) == 0;
  const int nch = (d + 32 * VW - 1) / (32 * VW);
#define RMSB_VEC(N)                                                                                        \
  if (nch <= N) {                                                                                          \
    rms_bwd_vec_kernel<T, WT, N><<<nblocks, RMSB_WARPS * 32, 0, s>>>(x, dh, w, resid, dx, part, rows, d, eps); \
    break;                                                                                                 \
  }
  do {
    // the register buckets: d <= 1024 in bf16, <= 768 in f32 (two rows of x, dh and resid a lane)
    if (vec) {
      if constexpr (sizeof(T) == 2) {
        RMSB_VEC(1) RMSB_VEC(2) RMSB_VEC(3) RMSB_VEC(4)
      } else {
        RMSB_VEC(1) RMSB_VEC(2) RMSB_VEC(3) RMSB_VEC(4) RMSB_VEC(6)
      }
    }
    const int smem = RMSB_WARPS * d * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(rms_bwd_any_kernel<T, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    rms_bwd_any_kernel<T, WT><<<nblocks, RMSB_WARPS * 32, smem, s>>>(x, dh, w, resid, dx, part, rows, d, eps);
  } while (false);
#undef RMSB_VEC
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return part_sum(part, dwp, nblocks, d, s);
}

}  // namespace

// C (M, N) = epilogue(A . B) in `layout` (see Layout) for the pairs
// (NT, relu_bwd), (NT, gelu_bwd), (NN, store), (NN, store_f32),
// (NN, acc_f32), (TN, store_f32); a and b in `dtype`, contiguous. out0..2
// and aux0..1 are (M, N) row-major in `dtype`, or f32 for the _f32
// epilogues; unused ones are null. With `splits` > 1 the (TN, store_f32)
// product is cut over its rows into that many ranges through `scratch`
// (splits, M, N) f32 (gemm_bwd.cuh says why). Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for any other pair.
extern "C" int t5_gemm_bwd(const void* a, const void* b, void* out0, void* out1, void* out2,
                           const void* aux0, const void* aux1, int M, int N, int K, int layout,
                           int dtype, int epi, void* scratch, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiPtrs e{out0, out1, out2, aux0, aux1};
  cudaError_t err = cudaErrorInvalidValue;
  if (layout == L_NT && epi == E_RELU_BWD) err = gemm_bwd<L_NT, E_RELU_BWD>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NT && epi == E_GELU_BWD) err = gemm_bwd<L_NT, E_GELU_BWD>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_STORE) err = gemm_bwd<L_NN, E_STORE>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_STORE_F32) err = gemm_bwd<L_NN, E_STORE_F32>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_NN && epi == E_ACC_F32) err = gemm_bwd<L_NN, E_ACC_F32>(dtype, a, b, e, M, N, K, s);
  else if (layout == L_TN && epi == E_STORE_F32)
    err = gemm_bwd_tn_split(dtype, a, b, out0, scratch, M, N, K, splits, s);
  return (int)err;
}

// x, resid, dx (rows, d) in `dtype`; dh (rows, d) f32; w (d,) in `w_dtype`;
// dw (d,) f32; dw_part (nblocks, d) f32 scratch, nblocks the grid
// (ops/fused_encoder.py::rms_bwd_blocks). 0 < d <= 4096.
extern "C" int t5_rms_bwd(const void* x, const void* dh, const void* w, const void* resid, void* dx,
                          void* dw, void* dw_part, int rows, int d, int nblocks, float eps, int dtype, int w_dtype,
                          void* stream) {
  if (d <= 0 || d > RMSB_MAX_D || nblocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RMS_BWD(T, WT) (int)rms_bwd<T, WT>(x, dh, w, resid, dx, dw, dw_part, rows, d, nblocks, eps, s)
  if (dtype == DT_F32 && w_dtype == DT_F32) return RMS_BWD(float, float);
  if (dtype == DT_F32 && w_dtype == DT_BF16) return RMS_BWD(float, __nv_bfloat16);
  if (dtype == DT_BF16 && w_dtype == DT_F32) return RMS_BWD(__nv_bfloat16, float);
  if (dtype == DT_BF16 && w_dtype == DT_BF16) return RMS_BWD(__nv_bfloat16, __nv_bfloat16);
#undef RMS_BWD
  return (int)cudaErrorInvalidValue;
}
