// K15: late-interaction (MaxSim) scoring. For query tokens q (B, Tq, D) and
// patch sets p (B, N, Tp, D), both L2-normalised f32 rows,
//
//   score[b, n] = sum_i  qw[b, i] * max_j ( q[b, i] . p[b, n, j] ),  j over valid tokens
//
// with masked patch tokens at -1e30 and a query token whose patch set has no
// valid token contributing 0 (an all-masked set scores 0).
//
// Replaces the TPU kernel `_maxsim_kernel` of
// rag_docvqa_tpu/ops/late_interaction.py, called from
// `late_interaction_pallas`, in the batched form the engine uses
// (`late_interaction`). Like it, the (B, N, Tq, Tp) similarity tensor never
// reaches device memory.
//
// The products must stay f32: the engine ranks chunks by differences of 1e-3
// in these sums, and one bf16 product of an f32 row is off by ~2^-9 of it. So
// the products are those of the f32 corpus-index tile (topk_common.cuh,
// `F32Tile`) on the tensor cores: a patch set's rows are A, 128 a tile (64 a
// warpgroup), split in registers into three exact bf16 terms; the query tokens
// are B, as their three exact bf16 terms (ops/topk.py::split_bf16x3, made once
// a call); the six products x_i q_j with i + j <= 2 of each 64-deep step go
// into a fresh f32 accumulator that is added into the score in registers.
// Block (n, b, z) takes set n of batch row b against query tokens [z TQ,
// z TQ + TQ) of that row and walks the set's rows in tiles of 128, the ring
// running on across them; rows past Tp are zero-filled and masked, never read
// from the next set. Each tile's masked maxima per query token are taken in
// registers (a thread's two rows), by shuffles across a warp's 16 rows, and
// kept per warp in shared memory; at the end the eight warps' maxima of each
// token are combined and the weighted terms summed in a fixed order, and above
// TQ tokens a second kernel adds the strips' sums in order, so a score does
// not depend on timing.
//
// What bounds it on the H100: the six bf16 products (2 * 6 * Tq * Tp * D a
// set; at Tq = Tp = 128, D 768, B 8 x 16 sets 0.0195 ms at 989 TFLOP/s), and
// beside them the L2 reads of the query terms, which every set of a batch row
// reads again (1.5x the bytes of its own f32 rows at Tq = Tp).
#include "topk_common.cuh"

namespace {

using topk::F32Tile;
using topk::NT;
using topk::TN;

constexpr float MASKED = -1e30f;
constexpr int WARPS = NT / 32;

template <int TQ>
__global__ void __launch_bounds__(NT, F32Tile<TQ>::BLOCKS_PER_SM) maxsim_wgmma_kernel(
    const float* __restrict__ p, const __nv_bfloat16* __restrict__ qt, const float* __restrict__ qw,
    const uint8_t* __restrict__ pmask, float* __restrict__ out, int B, int N, int Tq, int Tp, int D) {
  extern __shared__ __align__(16) uint8_t maxsim_smem[];
  const int n = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const long long set = (long long)b * N + n;
  const int n_tiles = (Tp + TN - 1) / TN;
  // the query terms as (3, B * Tq, D): the block's columns are rows b Tq + z TQ ...; those past
  // the batch row's Tq tokens (the next row's, or zeros past B * Tq) are scored and not used
  F32Tile<TQ> tile(maxsim_smem, p + set * Tp * D, Tp, D, qt, B * Tq, b * Tq + z * TQ, 0, n_tiles);
  float* best = reinterpret_cast<float*>(tile.tail());  // [WARPS][TQ]: each warp's running maxima
  float* terms = best + WARPS * TQ;                     // [TQ]
  const uint8_t* mb = pmask != nullptr ? pmask + set * Tp : nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3;
  const int r0 = (tid >> 7) * 64 + (warp & 3) * 16 + (lane >> 2);
  for (int i = tid; i < WARPS * TQ; i += NT) best[i] = MASKED;  // (before any update: products open with a barrier)
  for (int tt = 0; tt < n_tiles; ++tt) {
    float sum[TQ / 2];
    tile.products(sum);
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tt * TN + r0 + 8 * h;
      valid[h] = row < Tp && (mb == nullptr || mb[row] != 0);
    }
    // the accumulator layout of hopper.cuh: this thread holds rows r0, r0 + 8 of
    // columns 8 j + 2 t + {0, 1}; a warp's 16 rows are lanes 4, 8, 16 apart
    float v[TQ / 4];
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[2 * j + e] = fmaxf(valid[0] ? sum[4 * j + e] : MASKED, valid[1] ? sum[4 * j + 2 + e] : MASKED);
#pragma unroll
    for (int i = 0; i < TQ / 4; ++i) {
      v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 4));
      v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 8));
      v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 16));
    }
    if (lane < 4) {  // one lane of each column quad owns the warp's maxima of its columns
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* m = best + warp * TQ + 8 * j + 2 * t + e;
          *m = fmaxf(*m, v[2 * j + e]);
        }
    }
  }
  __syncthreads();
  if (tid < TQ) {
    float m = best[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, best[w * TQ + tid]);
    const int gq = z * TQ + tid;
    const bool live = gq < Tq && m > -1e29f;
    terms[tid] = live ? m * (qw != nullptr ? qw[(long long)b * Tq + gq] : 1.f) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < TQ; ++i) total += terms[i];
    out[set * gridDim.z + z] = total;
  }
  cp_async_wait<0>();
}

// out[i] = part[i][0] + part[i][1] + ... in that order
__global__ void strip_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, int Z) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float total = 0.f;
  for (int z = 0; z < Z; ++z) total += part[(long long)i * Z + z];
  out[i] = total;
}

}  // namespace

// qt (3, B * Tq, D) bf16, the three exact terms of the normalised f32 query
// tokens (B, Tq, D); p (B, N, Tp, D) f32 contiguous, rows already normalised;
// qw (B, Tq) f32 weights of the query tokens (its mask) or null for ones;
// pmask (B, N, Tp) uint8 or null for all valid; out (B, N) f32; `query_tile`
// the query tokens a block takes (8 ... 128); part (B, N, ceil(Tq /
// query_tile)) f32 scratch, unused (may be null) when Tq <= query_tile.
// D % 16 == 0.
extern "C" int maxsim(const void* qt, const void* p, const void* qw, const void* pmask, void* out, void* part, int B,
                      int N, int Tq, int Tp, int D, int query_tile, void* stream) {
  if (B <= 0 || N <= 0 || Tq <= 0 || Tp < 0 || D <= 0 || D % 16 != 0 || B > 65535 || query_tile <= 0)
    return (int)cudaErrorInvalidValue;
  const int Z = (Tq + query_tile - 1) / query_tile;
  if (Z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = topk::with_query_tile<128>(query_tile, [&](auto tq) {
    constexpr int TQ = decltype(tq)::value;
    const int smem = F32Tile<TQ>::SMEM + (WARPS + 1) * TQ * (int)sizeof(float);
    auto kern = maxsim_wgmma_kernel<TQ>;
    cudaError_t e = topk::set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(N, B, Z), NT, smem, s>>>(static_cast<const float*>(p), static_cast<const __nv_bfloat16*>(qt),
                                         static_cast<const float*>(qw), static_cast<const uint8_t*>(pmask),
                                         static_cast<float*>(Z == 1 ? out : part), B, N, Tq, Tp, D);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || Z == 1) return (int)err;
  strip_sum_kernel<<<(B * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), static_cast<float*>(out),
                                                      B * N, Z);
  return (int)cudaGetLastError();
}
