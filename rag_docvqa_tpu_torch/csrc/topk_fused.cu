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
// one read of the index (bytes); at large B the rate of the score products on
// the tensor cores (topk_common.cuh): three bf16 products for a bf16 index,
// whose queries come as three exact bf16 terms (Bf16Tile), six for an f32
// index, whose rows are split into three exact bf16 terms as they are loaded
// (F32Tile). Rows at or beyond `n_valid` score NEG_INF and tiles wholly
// beyond it are never read.
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

// every warp takes queries warp, warp + 8, ...: the tile's rows that beat its
// query's k-th best go into the query's list, in row order
template <int TQ, int SC_STRIDE>
__device__ __forceinline__ void insert_tile(const float* sc, float* tv, int* ti, int k, int row0, int q0, int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int qq = warp; qq < TQ && q0 + qq < B; qq += NT / 32) {
    float* qv = tv + qq * k;
    int* qi = ti + qq * k;
    float thr_v = qv[k - 1];
    int thr_i = qi[k - 1];
#pragma unroll
    for (int j = 0; j < TN / 32; ++j) {
      const int r = lane + 32 * j;
      const float v = sc[r * SC_STRIDE + qq];
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

// the block's lists [TQ][k] out as its row block's candidates
__device__ __forceinline__ void write_candidates(const float* tv, const int* ti, int TQ, int k, int q0, int B, int rb,
                                                 float* __restrict__ cand_v, int* __restrict__ cand_i) {
  for (int t = threadIdx.x; t < TQ * k; t += NT) {
    const int b = q0 + t / k;
    if (b < B) {
      const long long o = ((long long)rb * B + b) * k + t % k;
      cand_v[o] = tv[t];
      cand_i[o] = ti[t];
    }
  }
}

// The blocks of either wgmma tile: block (rb, qb) walks row block rb's tiles
// against query block qb; the ring (the scores in one of its stages), then
// the lists in shared memory
template <typename T, int TQ>
__device__ __forceinline__ void fused_topk_walk(const typename T::idx_t* __restrict__ index, int N,
                                                const __nv_bfloat16* __restrict__ qt, int B, int D, int n_valid,
                                                int k, int n_rb, int nqb, float* __restrict__ cand_v,
                                                int* __restrict__ cand_i) {
  extern __shared__ __align__(16) uint8_t topk_smem[];
  const int qb = blockIdx.x % nqb, rb = blockIdx.x / nqb;
  const int q0 = qb * TQ;
  int t_first, t_end;
  row_block_tiles(rb, n_rb, (N + TN - 1) / TN, t_first, t_end);
  t_end = min(t_end, (n_valid + TN - 1) / TN);  // padding is never read
  T tile(topk_smem, index, N, D, qt, B, q0, t_first, t_end);
  float* tv = reinterpret_cast<float*>(tile.tail());  // [TQ][k]
  int* ti = reinterpret_cast<int*>(tv + TQ * k);
  for (int t = threadIdx.x; t < TQ * k; t += NT) { tv[t] = NEG_INF; ti[t] = 0; }
  // (score opens with a __syncthreads())
  for (int t = t_first; t < t_end; ++t) {
    tile.score(t * TN, n_valid);
    insert_tile<TQ, T::SC_STRIDE>(tile.sc, tv, ti, k, t * TN, q0, B);
  }
  cp_async_wait<0>();
  __syncthreads();
  write_candidates(tv, ti, TQ, k, q0, B, rb, cand_v, cand_i);
}

// bf16 index: the shared-A tile with the three query terms
template <int TQ>
__global__ void __launch_bounds__(NT, Bf16Tile<TQ>::BLOCKS_PER_SM) fused_topk_bf16_kernel(
    const __nv_bfloat16* __restrict__ index, int N, const __nv_bfloat16* __restrict__ qt, int B, int D, int n_valid,
    int k, int n_rb, int nqb, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  fused_topk_walk<Bf16Tile<TQ>, TQ>(index, N, qt, B, D, n_valid, k, n_rb, nqb, cand_v, cand_i);
}

// f32 index: the rows split in registers, six products
template <int TQ>
__global__ void __launch_bounds__(NT, F32Tile<TQ>::BLOCKS_PER_SM) fused_topk_f32_kernel(
    const float* __restrict__ index, int N, const __nv_bfloat16* __restrict__ qt, int B, int D, int n_valid, int k,
    int n_rb, int nqb, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  fused_topk_walk<F32Tile<TQ>, TQ>(index, N, qt, B, D, n_valid, k, n_rb, nqb, cand_v, cand_i);
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

cudaError_t merge(const void* cand_v, const void* cand_i, void* out_v, void* out_i, int nrb, int B, int k,
                  cudaStream_t stream) {
  topk_merge_kernel<<<B, MT, 0, stream>>>(static_cast<const float*>(cand_v), static_cast<const int*>(cand_i), nrb,
                                          B, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// the tile's shared memory, then each query's running top-k (values, indices)
template <typename Tile>
int fused_smem(int tq, int k) {
  return Tile::SMEM + 2 * tq * k * (int)sizeof(uint32_t);
}

template <typename Tile, typename Kernel>
cudaError_t launch(Kernel kern, const void* index, const void* qt, void* cand_v, void* cand_i, void* out_v,
                   void* out_i, int N, int D, int B, int n_valid, int k, int nrb, int tq, cudaStream_t stream) {
  const int nqb = (B + tq - 1) / tq;
  const int smem = fused_smem<Tile>(tq, k);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<nqb * nrb, NT, smem, stream>>>(static_cast<const typename Tile::idx_t*>(index), N,
                                        static_cast<const __nv_bfloat16*>(qt), B, D, n_valid, k, nrb, nqb,
                                        static_cast<float*>(cand_v), static_cast<int*>(cand_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(cand_v, cand_i, out_v, out_i, nrb, B, k, stream);
}

}  // namespace

// index (N, D) f32 or bf16 (`idx_dtype`); qt (3, B, D) bf16, the three exact
// terms of the f32 unit query rows (ops/topk.py::split_bf16x3); cand_v /
// cand_i (n_row_blocks, B, k) scratch, one row of candidates for each of the
// contiguous runs the ceil(N/128) tiles are cut into; out_v (B, k) f32, out_i
// (B, k) i32; `query_tile` the queries a block takes (8, 16, 32, 64; 128 for an
// f32 index). D % 16 == 0, 1 <= k <= 64, 0 <= n_valid <= N,
// 1 <= n_row_blocks <= ceil(N/128).
extern "C" int topk_fused(const void* index, const void* qt, void* cand_v, void* cand_i, void* out_v, void* out_i,
                          int N, int D, int B, int n_valid, int k, int n_row_blocks, int idx_dtype, int query_tile,
                          void* stream) {
  if (N <= 0 || B <= 0 || D <= 0 || D % 16 != 0 || k < 1 || k > 64 || n_valid < 0 || n_valid > N ||
      n_row_blocks < 1 || n_row_blocks > (N + TN - 1) / TN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS index, qt, cand_v, cand_i, out_v, out_i, N, D, B, n_valid, k, n_row_blocks, query_tile, s
  if (idx_dtype == DT_F32)
    return (int)with_query_tile<128>(query_tile, [&](auto tq) {
      constexpr int TQ = decltype(tq)::value;
      return launch<F32Tile<TQ>>(fused_topk_f32_kernel<TQ>, ARGS);
    });
  if (idx_dtype == DT_BF16)
    return (int)with_query_tile<64>(query_tile, [&](auto tq) {
      constexpr int TQ = decltype(tq)::value;
      return launch<Bf16Tile<TQ>>(fused_topk_bf16_kernel<TQ>, ARGS);
    });
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

// Into *blocks, the blocks of K4's kernel for `idx_dtype` and `query_tile` an
// SM holds at once with the shared memory a launch with this k takes; 0 where
// the tile has no such form (ops/topk.py::_tile_plan sizes the grid by it).
extern "C" int topk_fused_resident(int query_tile, int idx_dtype, int k, int* blocks) {
  *blocks = 0;
  if (k < 1 || k > 64) return (int)cudaErrorInvalidValue;
  if (idx_dtype == DT_F32)
    return (int)with_query_tile<128>(query_tile, [&](auto tq) {
      constexpr int TQ = decltype(tq)::value;
      return resident_blocks(fused_topk_f32_kernel<TQ>, fused_smem<F32Tile<TQ>>(TQ, k), blocks);
    }, cudaSuccess);
  if (idx_dtype == DT_BF16)
    return (int)with_query_tile<64>(query_tile, [&](auto tq) {
      constexpr int TQ = decltype(tq)::value;
      return resident_blocks(fused_topk_bf16_kernel<TQ>, fused_smem<Bf16Tile<TQ>>(TQ, k), blocks);
    }, cudaSuccess);
  return (int)cudaErrorInvalidValue;
}
