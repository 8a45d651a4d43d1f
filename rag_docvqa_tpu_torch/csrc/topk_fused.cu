// K4: fused cosine scoring + running top-k over a resident index. The
// (B, N) score matrix never reaches device memory.
//
// Replaces the TPU kernel `_fused_kernel` (with `_topk_merge`) of
// rag_docvqa_tpu/ops/topk.py, called from `cosine_topk_pallas`. There the
// grid walks the index tiles in order on one core and carries the running
// top-k from step to step. Hopper's blocks run in no order, so here each
// block owns a contiguous range of index rows and a block of queries, keeps
// its own top-k for that range in shared memory, and writes it out as
// (row blocks, B, k) candidates; a second small kernel merges them. Both
// order by (score descending, global index ascending), which is the whole
// tie rule of `_topk_merge` and of lax.top_k. No float atomics. The TPU
// kernel's threshold gate survives as the test that lets a warp skip a tile
// in which no score beats its query's k-th best.
//
// What bounds it on the H100: at B <= 16, where the dispatch uses it, the
// one read of the index (bytes); at large B the f32 FMA rate (operations),
// since the queries stay f32 (see topk_common.cuh). Rows at or beyond
// `n_valid` score NEG_INF and tiles wholly beyond it are never read.
#include "topk_common.cuh"

#include <climits>
#include <cmath>

namespace {

using namespace topk;

// one warp inserts (cv, ci) into its query's sorted list of k entries
__device__ __forceinline__ void warp_insert(float* tv, int* ti, int k, float cv, int ci, int lane) {
  int cnt = 0;
  for (int e = lane; e < k; e += 32) cnt += better(tv[e], ti[e], cv, ci) ? 1 : 0;
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  const int pos = cnt;  // entries that stay ahead of the new one
  // shift [pos, k-2] down by one: every lane reads its entries, then writes
  float mv[2];
  int mi[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = lane + 32 * j;
    if (e >= pos && e < k - 1) { mv[j] = tv[e]; mi[j] = ti[e]; }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = lane + 32 * j;
    if (e >= pos && e < k - 1) { tv[e + 1] = mv[j]; ti[e + 1] = mi[j]; }
  }
  if (lane == 0) { tv[pos] = cv; ti[pos] = ci; }
  __syncwarp();
}

template <typename Op, int QT>
__global__ void __launch_bounds__(NT) fused_topk_kernel(
    const typename Op::idx_t* __restrict__ index, int N, const uint32_t* __restrict__ qu, int B, int n_units,
    int n_valid, int k, int tiles_per_block, int nqb, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  using S = TileShape<QT>;
  constexpr int TQ = S::TQ;
  extern __shared__ __align__(16) uint32_t smem[];
  float* sc = reinterpret_cast<float*>(smem);
  float* tv = reinterpret_cast<float*>(smem + S::SMEM_UNITS);  // [TQ][k]
  int* ti = reinterpret_cast<int*>(tv + TQ * k);               // [TQ][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qb = blockIdx.x % nqb, rb = blockIdx.x / nqb;
  const int q0 = qb * TQ;

  for (int t = tid; t < TQ * k; t += NT) { tv[t] = NEG_INF; ti[t] = 0; }
  // (score_tile opens with a __syncthreads())

  const int ntiles = (N + TN - 1) / TN;
  const int t_end = min((rb + 1) * tiles_per_block, ntiles);
  for (int tile = rb * tiles_per_block; tile < t_end; ++tile) {
    const int row0 = tile * TN;
    if (row0 >= n_valid) break;  // nothing but padding from here on
    score_tile<Op, QT>(index, n_units, N, qu, B, n_units, nullptr, n_valid, row0, q0, smem);
    for (int qq = warp; qq < TQ && q0 + qq < B; qq += NT / 32) {
      float* qv = tv + qq * k;
      int* qi = ti + qq * k;
      float thr_v = qv[k - 1];
      int thr_i = qi[k - 1];
#pragma unroll
      for (int j = 0; j < TN / 32; ++j) {
        const int r = lane + 32 * j;
        const float v = sc[r * S::SC_STRIDE + qq];
        const int gi = row0 + r;
        unsigned m = __ballot_sync(0xffffffffu, better(v, gi, thr_v, thr_i));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cv = __shfl_sync(0xffffffffu, v, src);
          const int ci = __shfl_sync(0xffffffffu, gi, src);
          if (better(cv, ci, thr_v, thr_i)) {  // the same for the whole warp
            warp_insert(qv, qi, k, cv, ci, lane);
            thr_v = qv[k - 1];
            thr_i = qi[k - 1];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < TQ * k; t += NT) {
    const int b = q0 + t / k;
    if (b < B) {
      const long long o = ((long long)rb * B + b) * k + t % k;
      cand_v[o] = tv[t];
      cand_i[o] = ti[t];
    }
  }
}

// one block per query: k rounds, each taking the best candidate that is
// strictly behind the last one taken. Valid candidates have distinct
// indices, so that walks them in order; the (NEG_INF, 0) fillers of short
// lists are all equal and are taken once, after which the fill is written.
constexpr int MT = 128;

__global__ void __launch_bounds__(MT) topk_merge_kernel(const float* __restrict__ cand_v,
                                                        const int* __restrict__ cand_i, int nrb, int B, int k,
                                                        float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float sv[MT / 32];
  __shared__ int si[MT / 32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = nrb * k;
  float last_v = INFINITY;
  int last_i = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = tid; c < total; c += MT) {
      const long long o = ((long long)(c / k) * B + b) * k + c % k;
      const float v = cand_v[o];
      const int i = cand_i[o];
      if (better(last_v, last_i, v, i) && better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    __syncthreads();  // the last round's sv/si have been read
    if (lane == 0) { sv[warp] = bv; si[warp] = bi; }
    __syncthreads();
    bv = sv[0];
    bi = si[0];
#pragma unroll
    for (int w = 1; w < MT / 32; ++w)
      if (better(sv[w], si[w], bv, bi)) { bv = sv[w]; bi = si[w]; }
    if (bi == INT_MAX) { bv = NEG_INF; bi = 0; }  // nothing left
    else { last_v = bv; last_i = bi; }
    if (tid == 0) { out_v[(long long)b * k + j] = bv; out_i[(long long)b * k + j] = bi; }
  }
}

template <typename Op, int QT>
cudaError_t launch(const void* index, const void* q, void* cand_v, void* cand_i, void* out_v, void* out_i, int N,
                   int D, int B, int n_valid, int k, int tiles_per_block, cudaStream_t stream) {
  using S = TileShape<QT>;
  const int nqb = (B + S::TQ - 1) / S::TQ;
  const int ntiles = (N + TN - 1) / TN;
  const int nrb = (ntiles + tiles_per_block - 1) / tiles_per_block;
  const int smem = (S::SMEM_UNITS + 2 * S::TQ * k) * (int)sizeof(uint32_t);
  auto kern = fused_topk_kernel<Op, QT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<nqb * nrb, NT, smem, stream>>>(static_cast<const typename Op::idx_t*>(index), N,
                                        static_cast<const uint32_t*>(q), B, D, n_valid, k, tiles_per_block, nqb,
                                        static_cast<float*>(cand_v), static_cast<int*>(cand_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<B, MT, 0, stream>>>(static_cast<const float*>(cand_v), static_cast<const int*>(cand_i), nrb,
                                          B, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace

// index (N, D) f32 or bf16 (`idx_dtype`), q (B, D) f32 unit rows; cand_v /
// cand_i (ceil(ceil(N/128) / tiles_per_block), B, k) scratch; out_v (B, k)
// f32, out_i (B, k) i32. D % 16 == 0, 1 <= k <= 64, 0 <= n_valid <= N.
extern "C" int topk_fused(const void* index, const void* q, void* cand_v, void* cand_i, void* out_v, void* out_i,
                          int N, int D, int B, int n_valid, int k, int tiles_per_block, int idx_dtype,
                          void* stream) {
  if (N <= 0 || B <= 0 || D <= 0 || D % 16 != 0 || k < 1 || k > 64 || n_valid < 0 || n_valid > N ||
      tiles_per_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS index, q, cand_v, cand_i, out_v, out_i, N, D, B, n_valid, k, tiles_per_block, s
  if (idx_dtype == DT_F32) return (int)(B <= 16 ? launch<OpF32, 1>(ARGS) : launch<OpF32, 4>(ARGS));
  if (idx_dtype == DT_BF16) return (int)(B <= 16 ? launch<OpBF16, 1>(ARGS) : launch<OpBF16, 4>(ARGS));
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
