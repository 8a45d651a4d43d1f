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
// directly.
//
// K5 and K12 are wgmma tiles (topk_common.cuh): a block walks a contiguous run
// of 128-row tiles against 8 to 128 queries, so that the ring's loads of the
// next tile overlap this one's maxima. K5 scores a bf16 index with the query
// in three exact bf16 terms (Bf16Tile) and an f32 index with its rows split
// into three exact bf16 terms in registers, six products (F32Tile); one thread
// per (query, segment) then takes the maximum of `group` rows from the tile
// in shared memory, consecutive threads on consecutive segments, so the
// stores run along S. K11 and K12 are one walk over an integer tile: K11
// (I8Tile) reads int8 rows and the query by descriptor, one s8 product a
// 32-byte sub-step; K12 (I4Tile) unpacks the nibbles in registers and makes
// two s8 products a 32-byte step; both into an exact int32. Their epilogue
// converts once and multiplies by the row's scale (no rounding before that
// product, so the maxima equal the plain version's bit for bit), takes the
// maxima of up to 16 rows with lane shuffles, and stores 16 bytes a thread
// where a tile's segments allow.
//
// What bounds them on the H100 at B 256: operations (the tensor-core rates of
// the three or six bf16 products and of the int8 products), not the one read
// of the index; at B <= 16 the bytes.
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

// the float wgmma tiles (K5) over a contiguous run of tiles
template <typename T, int TQ>
__device__ __forceinline__ void segmax_walk(const typename T::idx_t* __restrict__ index, int N,
                                            const __nv_bfloat16* __restrict__ qt, int B, int D, int n_valid,
                                            int group, int n_rb, int nqb, float* __restrict__ segmax) {
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

template <int TQ>
__global__ void __launch_bounds__(NT, Bf16Tile<TQ>::BLOCKS_PER_SM) segmax_bf16_kernel(
    const __nv_bfloat16* __restrict__ index, int N, const __nv_bfloat16* __restrict__ qt, int B, int D,
    int n_valid, int group, int n_rb, int nqb, float* __restrict__ segmax) {
  segmax_walk<Bf16Tile<TQ>, TQ>(index, N, qt, B, D, n_valid, group, n_rb, nqb, segmax);
}

template <int TQ>
__global__ void __launch_bounds__(NT, F32Tile<TQ>::BLOCKS_PER_SM) segmax_f32_kernel(
    const float* __restrict__ index, int N, const __nv_bfloat16* __restrict__ qt, int B, int D, int n_valid,
    int group, int n_rb, int nqb, float* __restrict__ segmax) {
  segmax_walk<F32Tile<TQ>, TQ>(index, N, qt, B, D, n_valid, group, n_rb, nqb, segmax);
}

// butterfly step S over lanes 4 << S apart on the NV >> S columns a lane still
// holds: keep the half this lane's bit names, take the partner's copy of it
// (`base`: the column of v[0]); a lone column is combined whole
template <int NV, int S>
__device__ __forceinline__ void halve(float (&v)[NV], int g, int& base) {
  constexpr int n = NV >> S;
  const int bit = (g >> S) & 1;
  if constexpr (n >= 2) {
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = bit ? v[i] : v[i + n / 2], keep = bit ? v[i + n / 2] : v[i];
      v[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 4 << S));
    }
    base += bit * (n / 2);
  } else {
    v[0] = fmaxf(v[0], __shfl_xor_sync(0xffffffffu, v[0], 4 << S));
  }
}

// the maxima of each warp's 16 rows, per query, into part[query][TN / 16]:
// the row pair's maximum, then three butterfly steps
template <int TQ>
__device__ __forceinline__ void warp_max16(const int (&acc)[TQ / 2], const float (&sc)[2], const bool (&valid)[2],
                                           float* part) {
  constexpr int NV = TQ / 4;  // the columns a lane holds
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float v[NV];
#pragma unroll
  for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[2 * j + e] = fmaxf(valid[0] ? static_cast<float>(acc[4 * j + e]) * sc[0] : NEG_INF,
                           valid[1] ? static_cast<float>(acc[4 * j + 2 + e]) * sc[1] : NEG_INF);
  int base = 0;
  halve<NV, 0>(v, g, base);
  halve<NV, 1>(v, g, base);
  halve<NV, 2>(v, g, base);
  constexpr int LEFT = NV >= 8 ? NV / 8 : 1;              // columns a lane holds at the end
  constexpr int HALVED = NV >= 8 ? 3 : (NV == 4 ? 2 : 1);  // steps that halved them
  const int seg = (threadIdx.x >> 5) & 7;                  // the warp's 16 rows: part (64 wg + 16 w) / 16
  if ((g >> HALVED) == 0) {  // the lanes that differ only in the other steps' bits hold the same maxima
#pragma unroll
    for (int i = 0; i < LEFT; ++i) {
      const int c = base + i;
      part[(8 * (c >> 1) + 2 * t + (c & 1)) * (TN / 16) + seg] = v[i];
    }
  }
}

// K11 and K12: an integer wgmma tile (I8Tile, I4Tile) over a contiguous run of
// tiles, `rows` the int8 or the packed int4 index. The epilogue works
// on the accumulators where they are: thread (warp w, lane l) of warpgroup wg
// holds rows r0 = 64 wg + 16 w + l / 4 and r0 + 8 of columns 8 j + 2 (l % 4) +
// {0, 1}, so a warp's 16 rows are lanes l ^ 4, l ^ 8, l ^ 16 apart. For a group
// of 16 rows or more: the row pair's maximum, then three butterfly steps that
// each halve the columns a lane holds while they combine the lanes (28 shuffles
// at 128 queries, not 96, and no branch between them, so the compiler keeps the
// warp converged), into part[query][TN / 16]; a segment is group / 16 parts,
// stored 16 bytes a thread where a tile's segments of a query allow. Smaller
// groups take the scores through shared memory and `tile_segmax`.
template <typename Tile, int TQ>
__device__ __forceinline__ void segmax_int_walk(const int8_t* __restrict__ rows, int N,
                                                const int8_t* __restrict__ q8, int B, int D,
                                                const float* __restrict__ scale, int n_valid, int group, int n_rb,
                                                int nqb, float* __restrict__ segmax) {
  extern __shared__ __align__(16) uint8_t topk_smem[];
  const int qb = blockIdx.x % nqb, rb = blockIdx.x / nqb;
  const int q0 = qb * TQ;
  int t_first, t_end;
  row_block_tiles(rb, n_rb, (N + TN - 1) / TN, t_first, t_end);
  const int t_scored = min(t_end, (n_valid + TN - 1) / TN);
  Tile tile(topk_smem, rows, N, D, q8, B, q0, t_first, t_scored);
  float* part = reinterpret_cast<float*>(tile.tail());  // [TQ][TN / 16], or the scores [TN][TQ + 1] below group 16
  const int tid = threadIdx.x;
  const int r0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  const int per = group / 16, nseg = TN / group;
  const long long S = N / group;
  for (int t = t_first; t < t_end; ++t) {
    const int row0 = t * TN;
    if (t >= t_scored) {
      tile_segmax<TQ, 1>(nullptr, row0, q0, B, N, group, segmax);
      continue;
    }
    int acc[TQ / 2];
    tile.products(acc);
    if (group < 16) {
      store_scores<TQ, TQ + 1>(acc, part, row0, n_valid, scale);
      __syncthreads();
      tile_segmax<TQ, TQ + 1>(part, row0, q0, B, N, group, segmax);
      continue;  // (the next tile's products open with a barrier before the scores are rewritten)
    }
    bool valid[2];
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r0 + 8 * h;
      valid[h] = row < n_valid;
      sc[h] = valid[h] ? scale[row] : 0.f;
    }
    warp_max16<TQ>(acc, sc, valid, part);
    __syncthreads();
    // segment s of query qq: the maximum of its `per` parts
    auto seg = [&](int qq, int s) {
      const float* p = part + qq * (TN / 16) + s * per;
      float m = p[0];
      for (int i = 1; i < per; ++i) m = fmaxf(m, p[i]);
      return m;
    };
    const long long s0 = row0 / group;
    if (nseg % 4 == 0 && S % 4 == 0 && s0 + nseg <= S) {
      const int n4 = nseg / 4;
      for (int i = tid; i < TQ * n4; i += NT) {
        const int qq = i / n4, s = (i % n4) * 4;
        if (q0 + qq < B)
          *reinterpret_cast<float4*>(segmax + (q0 + qq) * S + s0 + s) =
              make_float4(seg(qq, s), seg(qq, s + 1), seg(qq, s + 2), seg(qq, s + 3));
      }
    } else {
      for (int i = tid; i < TQ * nseg; i += NT) {
        const int qq = i / nseg, s = i % nseg;
        if (q0 + qq < B && s0 + s < S) segmax[(q0 + qq) * S + s0 + s] = seg(qq, s);
      }
    }
    // (the next tile's products open with a barrier before its parts are written)
  }
  cp_async_wait<0>();
}

template <int TQ>
__global__ void __launch_bounds__(NT, I8Tile<TQ>::BLOCKS_PER_SM) segmax_int8_kernel(
    const int8_t* __restrict__ index, int N, const int8_t* __restrict__ q8, int B, int D,
    const float* __restrict__ scale, int n_valid, int group, int n_rb, int nqb, float* __restrict__ segmax) {
  segmax_int_walk<I8Tile<TQ>, TQ>(index, N, q8, B, D, scale, n_valid, group, n_rb, nqb, segmax);
}

template <int TQ>
__global__ void __launch_bounds__(NT, I4Tile<TQ>::BLOCKS_PER_SM) segmax_int4_kernel(
    const int8_t* __restrict__ packed, int N, const int8_t* __restrict__ q8, int B, int D,
    const float* __restrict__ scale, int n_valid, int group, int n_rb, int nqb, float* __restrict__ segmax) {
  segmax_int_walk<I4Tile<TQ>, TQ>(packed, N, q8, B, D, scale, n_valid, group, n_rb, nqb, segmax);
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

template <typename Tile, typename Kernel>
cudaError_t launch_float(Kernel kern, const void* index, const void* qt, void* segmax, int N, int D, int B,
                         int n_valid, int group, int nrb, int tq, cudaStream_t stream) {
  const int nqb = (B + tq - 1) / tq;
  cudaError_t err = set_smem(kern, Tile::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<nqb * nrb, NT, Tile::SMEM, stream>>>(static_cast<const typename Tile::idx_t*>(index), N,
                                              static_cast<const __nv_bfloat16*>(qt), B, D, n_valid, group, nrb, nqb,
                                              static_cast<float*>(segmax));
  return cudaGetLastError();
}

// K11's and K12's shared memory: the tile's, then the scores (group < 16) or the parts
template <typename Tile, int TQ>
int int_smem(int group) {
  return Tile::SMEM + (group < 16 ? TN * (TQ + 1) : TQ * (TN / 16)) * (int)sizeof(float);
}

template <typename Tile, int TQ, typename Kernel>
cudaError_t launch_int(Kernel kern, const void* rows, const void* q8, const void* scale, void* segmax, int N, int D,
                       int B, int n_valid, int group, int nrb, cudaStream_t stream) {
  const int nqb = (B + TQ - 1) / TQ;
  const int smem = int_smem<Tile, TQ>(group);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<nqb * nrb, NT, smem, stream>>>(static_cast<const int8_t*>(rows), N, static_cast<const int8_t*>(q8), B, D,
                                        static_cast<const float*>(scale), n_valid, group, nrb, nqb,
                                        static_cast<float*>(segmax));
  return cudaGetLastError();
}

bool bad_shape(int N, int B, int D, int d_mult, int n_valid, int group) {
  return N <= 0 || B <= 0 || D <= 0 || D % d_mult != 0 || n_valid < 0 || n_valid > N || group < 1 ||
         TN % group != 0 || N % group != 0;
}

}  // namespace

// K5. index (N, D) f32 or bf16 (`idx_dtype`); qt (3, B, D) bf16, the three
// exact terms of the f32 unit query rows; segmax (B, N/group) f32; supermax
// (B, N/(group*sgroups)) f32 or null; `query_tile` the queries a block takes
// (8, 16, 32, 64; 128 for an f32 index). D % 16 == 0; group divides 128 and N;
// sgroups divides N/group. The blocks walk the ceil(N/128) tiles in
// n_row_blocks contiguous runs (1 <= n_row_blocks <= ceil(N/128)).
extern "C" int topk_segmax(const void* index, const void* qt, void* segmax, void* supermax, int N, int D, int B,
                           int n_valid, int group, int sgroups, int n_row_blocks, int idx_dtype, int query_tile,
                           void* stream) {
  if (bad_shape(N, B, D, 16, n_valid, group) || n_row_blocks < 1 || n_row_blocks > (N + TN - 1) / TN)
    return (int)cudaErrorInvalidValue;
  const long long S = N / group;
  if (supermax != nullptr && (sgroups < 1 || S % sgroups != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define ARGS index, qt, segmax, N, D, B, n_valid, group, n_row_blocks, query_tile, s
  if (idx_dtype == DT_F32)
    err = with_query_tile<128>(query_tile, [&](auto tq) {
      constexpr int TQ = decltype(tq)::value;
      return launch_float<F32Tile<TQ>>(segmax_f32_kernel<TQ>, ARGS);
    });
  else if (idx_dtype == DT_BF16)
    err = with_query_tile<64>(query_tile, [&](auto tq) {
      constexpr int TQ = decltype(tq)::value;
      return launch_float<Bf16Tile<TQ>>(segmax_bf16_kernel<TQ>, ARGS);
    });
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
// f32 = max over the group of float(int32 dot) * scale[row]. D % 16 == 0; the
// blocks walk n_row_blocks runs of tiles against `query_tile` (8 ... 128)
// queries each.
extern "C" int topk_segmax_int8(const void* index, const void* q8, const void* scale, void* segmax, int N, int D,
                                int B, int n_valid, int group, int n_row_blocks, int query_tile, void* stream) {
  if (bad_shape(N, B, D, 16, n_valid, group) || n_row_blocks < 1 || n_row_blocks > (N + TN - 1) / TN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_query_tile<128>(query_tile, [&](auto tq) {
    constexpr int TQ = decltype(tq)::value;
    return launch_int<I8Tile<TQ>, TQ>(segmax_int8_kernel<TQ>, index, q8, scale, segmax, N, D, B, n_valid, group,
                                      n_row_blocks, s);
  });
}

// K12. packed (N, D/2) int8 nibble pairs (element d with element d + D/2),
// q8 (B, D) int8, scale (N) f32; segmax as K11. D % 32 == 0; the blocks walk
// n_row_blocks runs of tiles against `query_tile` (8 ... 128) queries each.
extern "C" int topk_segmax_int4(const void* packed, const void* q8, const void* scale, void* segmax, int N, int D,
                                int B, int n_valid, int group, int n_row_blocks, int query_tile, void* stream) {
  if (bad_shape(N, B, D, 32, n_valid, group) || n_row_blocks < 1 || n_row_blocks > (N + TN - 1) / TN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_query_tile<128>(query_tile, [&](auto tq) {
    constexpr int TQ = decltype(tq)::value;
    return launch_int<I4Tile<TQ>, TQ>(segmax_int4_kernel<TQ>, packed, q8, scale, segmax, N, D, B, n_valid, group,
                                      n_row_blocks, s);
  });
}

// Into *blocks, the blocks of K5's kernel for `idx_dtype` (f32, bf16) and
// `query_tile` an SM holds at once; 0 where the tile has no such form
// (ops/topk.py::_tile_plan sizes the grid by it).
extern "C" int topk_segmax_resident(int query_tile, int idx_dtype, int* blocks) {
  *blocks = 0;
  if (idx_dtype == DT_F32)
    return (int)with_query_tile<128>(query_tile, [&](auto tq) {
      constexpr int TQ = decltype(tq)::value;
      return resident_blocks(segmax_f32_kernel<TQ>, F32Tile<TQ>::SMEM, blocks);
    }, cudaSuccess);
  if (idx_dtype == DT_BF16)
    return (int)with_query_tile<64>(query_tile, [&](auto tq) {
      constexpr int TQ = decltype(tq)::value;
      return resident_blocks(segmax_bf16_kernel<TQ>, Bf16Tile<TQ>::SMEM, blocks);
    }, cudaSuccess);
  return (int)cudaErrorInvalidValue;
}

// Into *blocks, the blocks of K11's (K12's) kernel for `query_tile` an SM holds
// at once with the shared memory a launch with `group` takes; 0 where it has no
// such form.
extern "C" int topk_segmax_int8_resident(int query_tile, int group, int* blocks) {
  *blocks = 0;
  if (group < 1 || TN % group != 0) return (int)cudaErrorInvalidValue;
  return (int)with_query_tile<128>(query_tile, [&](auto tq) {
    constexpr int TQ = decltype(tq)::value;
    return resident_blocks(segmax_int8_kernel<TQ>, int_smem<I8Tile<TQ>, TQ>(group), blocks);
  }, cudaSuccess);
}

extern "C" int topk_segmax_int4_resident(int query_tile, int group, int* blocks) {
  *blocks = 0;
  if (group < 1 || TN % group != 0) return (int)cudaErrorInvalidValue;
  return (int)with_query_tile<128>(query_tile, [&](auto tq) {
    constexpr int TQ = decltype(tq)::value;
    return resident_blocks(segmax_int4_kernel<TQ>, int_smem<I4Tile<TQ>, TQ>(group), blocks);
  }, cudaSuccess);
}
