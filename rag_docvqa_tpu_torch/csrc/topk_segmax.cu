// K5, K11, K12: the scores of a resident index against a batch of queries,
// reduced on the way out to per-`group` segment maxima (and, for K5, to
// per-supergroup maxima of `sgroups` segments). Phase 1 of the exact
// two-phase top-k: the (B, N) score matrix never reaches device memory,
// only (B, N/group) maxima do.
//
// Replace the TPU kernels
//   K5  `_segmax_kernel`      of rag_docvqa_tpu/ops/topk.py  (from `cosine_topk_twophase`),
//   K11 `_segmax_int8_kernel` of rag_docvqa_tpu/ops/quant.py (from `cosine_topk_int8_twophase`),
//   K12 `_segmax_int4_kernel` of rag_docvqa_tpu/ops/quant.py (from `cosine_topk_int4_twophase`).
// Those write (N/group, B) and transpose outside; these write (B, N/group)
// directly. A block scores a tile of 128 index rows against 16 or 64 queries
// (8, 16, 32 or 64 for a bf16 index; topk_common.cuh), then one thread per
// (query, segment) takes the
// maximum of `group` rows from the tile in shared memory; consecutive
// threads take consecutive segments, so the stores run along S.
//
// K5 scores an f32 index by f32 FMA (the SIMT tile) and a bf16 index on the
// tensor cores with the query in three exact bf16 terms (Bf16Tile); a bf16
// block walks a contiguous run of tiles, so that the ring's loads of the next
// tile overlap this one's maxima. K11 takes four int8 products per __dp4a
// into an int32, converts once and multiplies by the row's scale: no rounding
// before that product, so the maxima equal the plain version's bit for bit.
// K12 is K11 with the nibbles unpacked as they are staged (sign-extending
// arithmetic shifts of a signed int).
//
// What bounds them on the H100 at B 256: operations (the tensor-core rate of
// the three bf16 products; the SIMT FMA and dp4a rates), not the one read of
// the index; at B <= 16 the bytes.
#include "topk_common.cuh"

namespace {

using namespace topk;

// segmax[b][row0/group + seg] = the maximum of the tile's `group` scores of
// segment seg for query b (NEG_INF everywhere for sc == nullptr: a tile past
// n_valid); consecutive threads take consecutive segments, so the stores run
// along S
template <int TQ, int SC_STRIDE>
__device__ __forceinline__ void tile_segmax(const float* sc, int row0, int q0, int B, int N, int group,
                                            float* __restrict__ segmax) {
  const int nseg = TN / group;  // group divides TN
  const long long n_seg_total = N / group;
  for (int t = threadIdx.x; t < TQ * nseg; t += NT) {
    const int seg = t % nseg, qq = t / nseg;
    const int b = q0 + qq;
    const long long gs = (long long)row0 / group + seg;
    if (b >= B || gs >= n_seg_total) continue;
    float m = NEG_INF;
    if (sc != nullptr)
      for (int j = 0; j < group; ++j) m = fmaxf(m, sc[(seg * group + j) * SC_STRIDE + qq]);
    segmax[(long long)b * n_seg_total + gs] = m;
  }
}

// f32, int8 and int4 indexes: one SIMT tile a block
template <typename Op, int QT>
__global__ void __launch_bounds__(NT) segmax_kernel(
    const typename Op::idx_t* __restrict__ index, long long ld, int N, const uint32_t* __restrict__ qu, int B,
    int n_units, const float* __restrict__ scale, int n_valid, int group, int nqb, float* __restrict__ segmax) {
  using S = TileShape<QT>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int qb = blockIdx.x % nqb, tile = blockIdx.x / nqb;
  const int row0 = tile * TN, q0 = qb * S::TQ;
  score_tile<Op, QT>(index, ld, N, qu, B, n_units, scale, n_valid, row0, q0, smem);
  tile_segmax<S::TQ, S::SC_STRIDE>(reinterpret_cast<const float*>(smem), row0, q0, B, N, group, segmax);
}

// bf16 index: the wgmma tile over a contiguous run of tiles
template <int TQ>
__global__ void __launch_bounds__(NT, Bf16Tile<TQ>::BLOCKS_PER_SM) segmax_bf16_kernel(
    const __nv_bfloat16* __restrict__ index, int N, const __nv_bfloat16* __restrict__ qt, int B, int D,
    int n_valid, int group, int n_rb, int nqb, float* __restrict__ segmax) {
  using T = Bf16Tile<TQ>;
  extern __shared__ __align__(16) uint8_t topk_smem[];
  const int qb = blockIdx.x % nqb, rb = blockIdx.x / nqb;
  const int q0 = qb * TQ;
  int t_first, t_end;
  row_block_tiles(rb, n_rb, (N + TN - 1) / TN, t_first, t_end);
  const int t_scored = min(t_end, (n_valid + TN - 1) / TN);  // tiles past it hold no valid row
  T tile(topk_smem, index, N, D, qt, B, q0, t_first, t_scored);
  for (int t = t_first; t < t_end; ++t) {
    if (t < t_scored) tile.score(t * TN, n_valid);
    tile_segmax<TQ, T::SC_STRIDE>(t < t_scored ? tile.sc : nullptr, t * TN, q0, B, N, group, segmax);
  }
  cp_async_wait<0>();
}

// supermax[b][s2] = max of segmax[b][s2*sgroups .. +sgroups)
__global__ void supermax_kernel(const float* __restrict__ segmax, long long S, int sgroups, long long total,
                                float* __restrict__ supermax) {
  const long long S2 = S / sgroups;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / S2, s2 = t % S2;
    const float* p = segmax + b * S + s2 * sgroups;
    float m = p[0];
    for (int j = 1; j < sgroups; ++j) m = fmaxf(m, p[j]);
    supermax[t] = m;
  }
}

template <typename Op, int QT>
cudaError_t launch(const void* index, long long ld, const void* q, int n_units, const void* scale, void* segmax,
                   int N, int B, int n_valid, int group, cudaStream_t stream) {
  using S = TileShape<QT>;
  const int nqb = (B + S::TQ - 1) / S::TQ;
  const int ntiles = (N + TN - 1) / TN;
  const int smem = S::SMEM_UNITS * (int)sizeof(uint32_t);
  auto kern = segmax_kernel<Op, QT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((long long)nqb * ntiles), NT, smem, stream>>>(
      static_cast<const typename Op::idx_t*>(index), ld, N, static_cast<const uint32_t*>(q), B, n_units,
      static_cast<const float*>(scale), n_valid, group, nqb, static_cast<float*>(segmax));
  return cudaGetLastError();
}

template <int TQ>
cudaError_t launch_bf16(const void* index, const void* qt, void* segmax, int N, int D, int B, int n_valid, int group,
                        int nrb, cudaStream_t stream) {
  const int nqb = (B + TQ - 1) / TQ;
  const int smem = Bf16Tile<TQ>::SMEM;
  auto kern = segmax_bf16_kernel<TQ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<nqb * nrb, NT, smem, stream>>>(static_cast<const __nv_bfloat16*>(index), N,
                                        static_cast<const __nv_bfloat16*>(qt), B, D, n_valid, group, nrb, nqb,
                                        static_cast<float*>(segmax));
  return cudaGetLastError();
}

bool bad_shape(int N, int B, int D, int d_mult, int n_valid, int group) {
  return N <= 0 || B <= 0 || D <= 0 || D % d_mult != 0 || n_valid < 0 || n_valid > N || group < 1 ||
         TN % group != 0 || N % group != 0;
}

}  // namespace

// K5. index (N, D) f32 or bf16 (`idx_dtype`); q (B, D) f32 unit rows for an
// f32 index, their three exact bf16 terms (3, B, D) for a bf16 one; segmax
// (B, N/group) f32; supermax (B, N/(group*sgroups)) f32 or null. D % 16 == 0;
// group divides 128 and N; sgroups divides N/group. A bf16 index's blocks walk
// the ceil(N/128) tiles in n_row_blocks contiguous runs (1 <= n_row_blocks <=
// ceil(N/128)); the f32 kernel takes one tile a block and ignores it.
extern "C" int topk_segmax(const void* index, const void* q, void* segmax, void* supermax, int N, int D, int B,
                           int n_valid, int group, int sgroups, int n_row_blocks, int idx_dtype, void* stream) {
  if (bad_shape(N, B, D, 16, n_valid, group) || n_row_blocks < 1 || n_row_blocks > (N + TN - 1) / TN)
    return (int)cudaErrorInvalidValue;
  const long long S = N / group;
  if (supermax != nullptr && (sgroups < 1 || S % sgroups != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define ARGS index, D, q, D, nullptr, segmax, N, B, n_valid, group, s
#define ARGS_BF16 index, q, segmax, N, D, B, n_valid, group, n_row_blocks, s
  if (idx_dtype == DT_F32) err = B <= 16 ? launch<OpF32, 1>(ARGS) : launch<OpF32, 4>(ARGS);
  else if (idx_dtype == DT_BF16)
    err = by_query_tile(B, [&](auto tq) { return launch_bf16<decltype(tq)::value>(ARGS_BF16); });
  else return (int)cudaErrorInvalidValue;
#undef ARGS
#undef ARGS_BF16
  if (err != cudaSuccess || supermax == nullptr) return (int)err;
  const long long total = (long long)B * (S / sgroups);
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  supermax_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(segmax), S, sgroups, total,
                                         static_cast<float*>(supermax));
  return (int)cudaGetLastError();
}

// K11. index (N, D) int8, q8 (B, D) int8, scale (N) f32; segmax (B, N/group)
// f32 = max over the group of float(int32 dot) * scale[row]. D % 16 == 0.
extern "C" int topk_segmax_int8(const void* index, const void* q8, const void* scale, void* segmax, int N, int D,
                                int B, int n_valid, int group, void* stream) {
  if (bad_shape(N, B, D, 16, n_valid, group)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS index, D, q8, D / 4, scale, segmax, N, B, n_valid, group, s
  return (int)(B <= 16 ? launch<OpI8, 1>(ARGS) : launch<OpI8, 4>(ARGS));
#undef ARGS
}

// K12. packed (N, D/2) int8 nibble pairs (element d with element d + D/2),
// q8 (B, D) int8, scale (N) f32; segmax as K11. D % 32 == 0.
extern "C" int topk_segmax_int4(const void* packed, const void* q8, const void* scale, void* segmax, int N, int D,
                                int B, int n_valid, int group, void* stream) {
  if (bad_shape(N, B, D, 32, n_valid, group)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS packed, D / 2, q8, D / 4, scale, segmax, N, B, n_valid, group, s
  return (int)(B <= 16 ? launch<OpI4, 1>(ARGS) : launch<OpI4, 4>(ARGS));
#undef ARGS
}
