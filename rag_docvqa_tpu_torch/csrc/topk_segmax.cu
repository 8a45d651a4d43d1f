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
// directly. One block scores a tile of 128 index rows against 16 or 64
// queries (topk_common.cuh), then one thread per (query, segment) takes the
// maximum of `group` rows from the tile in shared memory; consecutive
// threads take consecutive segments, so the stores run along S.
//
// K5 multiplies f32 queries with an f32 or bf16 index by f32 FMA. K11 takes
// four int8 products per __dp4a into an int32, converts once and multiplies
// by the row's scale: no rounding before that product, so the maxima equal
// the plain version's bit for bit. K12 is K11 with the nibbles unpacked as
// they are staged (sign-extending arithmetic shifts of a signed int).
//
// What bounds them on the H100 at B 256: operations (the SIMT FMA and dp4a
// rates), not the one read of the index; at B <= 16 the bytes.
#include "topk_common.cuh"

namespace {

using namespace topk;

template <typename Op, int QT>
__global__ void __launch_bounds__(NT) segmax_kernel(
    const typename Op::idx_t* __restrict__ index, long long ld, int N, const uint32_t* __restrict__ qu, int B,
    int n_units, const float* __restrict__ scale, int n_valid, int group, int nqb, float* __restrict__ segmax) {
  using S = TileShape<QT>;
  constexpr int TQ = S::TQ;
  extern __shared__ __align__(16) uint32_t smem[];
  const float* sc = reinterpret_cast<const float*>(smem);
  const int qb = blockIdx.x % nqb, tile = blockIdx.x / nqb;
  const int row0 = tile * TN, q0 = qb * TQ;
  score_tile<Op, QT>(index, ld, N, qu, B, n_units, scale, n_valid, row0, q0, smem);

  const int nseg = TN / group;  // group divides TN
  const long long n_seg_total = N / group;
  for (int t = threadIdx.x; t < TQ * nseg; t += NT) {
    const int seg = t % nseg, qq = t / nseg;
    const int b = q0 + qq;
    const long long gs = (long long)row0 / group + seg;
    if (b >= B || gs >= n_seg_total) continue;
    float m = sc[(seg * group) * S::SC_STRIDE + qq];
    for (int j = 1; j < group; ++j) m = fmaxf(m, sc[(seg * group + j) * S::SC_STRIDE + qq]);
    segmax[(long long)b * n_seg_total + gs] = m;
  }
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

bool bad_shape(int N, int B, int D, int d_mult, int n_valid, int group) {
  return N <= 0 || B <= 0 || D <= 0 || D % d_mult != 0 || n_valid < 0 || n_valid > N || group < 1 ||
         TN % group != 0 || N % group != 0;
}

}  // namespace

// K5. index (N, D) f32 or bf16 (`idx_dtype`), q (B, D) f32 unit rows;
// segmax (B, N/group) f32; supermax (B, N/(group*sgroups)) f32 or null.
// D % 16 == 0; group divides 128 and N; sgroups divides N/group.
extern "C" int topk_segmax(const void* index, const void* q, void* segmax, void* supermax, int N, int D, int B,
                           int n_valid, int group, int sgroups, int idx_dtype, void* stream) {
  if (bad_shape(N, B, D, 16, n_valid, group)) return (int)cudaErrorInvalidValue;
  const long long S = N / group;
  if (supermax != nullptr && (sgroups < 1 || S % sgroups != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define ARGS index, D, q, D, nullptr, segmax, N, B, n_valid, group, s
  if (idx_dtype == DT_F32) err = B <= 16 ? launch<OpF32, 1>(ARGS) : launch<OpF32, 4>(ARGS);
  else if (idx_dtype == DT_BF16) err = B <= 16 ? launch<OpBF16, 1>(ARGS) : launch<OpBF16, 4>(ARGS);
  else return (int)cudaErrorInvalidValue;
#undef ARGS
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
