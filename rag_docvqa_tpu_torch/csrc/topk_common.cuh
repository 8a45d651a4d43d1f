// The score tile shared by the corpus-index kernels (K4, K5, K11, K12):
// scores[r][b] = <index row r, query b> for a tile of TN index rows and
// TQ = 16*QT queries, left in shared memory as f32 with the rows at or
// beyond `n_valid` set to NEG_INF.
//
// The contraction runs over 32-bit "units": one f32 element (f32 and bf16
// indexes, the bf16 widened to f32 when it is staged: the queries stay f32,
// as in rag_docvqa_tpu/ops/topk.py, so the product is f32 x f32 FMA with f32
// accumulation) or four int8 elements taken by one __dp4a into an int32
// (int8 and int4 indexes, order-free and exact). An int4 index is read as
// the int8 row [lo nibbles | hi nibbles], which is exactly the pairing of
// `quantize_rows_int4` (element d shares a byte with element d + D/2), so
// its kernel is the int8 kernel with another loader.
//
// Design: 256 threads, each 8 rows x QT queries of accumulators; index and
// query tiles are staged k-major in shared memory, BK units a step, double
// buffered through registers (the next step's global loads are in flight
// while this step is multiplied). This is a plain SIMT tile, not a tensor
// core one: a bf16 or TF32 product of the f32 queries would move the scores
// by ~1e-3 and reorder the top-k.
#pragma once

#include "common.cuh"

namespace topk {

constexpr int NT = 256;  // threads per block
constexpr int TN = 128;  // index rows per tile
constexpr int BK = 16;   // units of the contraction per step
constexpr float NEG_INF = -1e30f;

// (score, index) order of every selection here: score descending, then
// index ascending -- the tie rule of lax.top_k and of `_topk_merge`.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// ---- operand traits: how 4 units of an index row are loaded, how two
// units multiply into the accumulator, how the accumulator becomes a score
struct OpF32 {
  using idx_t = float;
  using acc_t = float;
  static __device__ __forceinline__ void load_idx(const float* row, int u0, int, uint32_t (&u)[4]) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + u0);
    u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
  }
  static __device__ __forceinline__ void mad(float& c, uint32_t a, uint32_t b) {
    c = fmaf(__uint_as_float(a), __uint_as_float(b), c);
  }
  static __device__ __forceinline__ float score(float c, const float*, int) { return c; }
};

struct OpBF16 : OpF32 {
  using idx_t = __nv_bfloat16;
  static __device__ __forceinline__ void load_idx(const __nv_bfloat16* row, int u0, int, uint32_t (&u)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + u0);  // 4 bf16; bf16 -> f32 is a 16-bit shift
    u[0] = v.x << 16; u[1] = v.x & 0xffff0000u; u[2] = v.y << 16; u[3] = v.y & 0xffff0000u;
  }
};

struct OpI8 {
  using idx_t = int8_t;
  using acc_t = int;
  static __device__ __forceinline__ void load_idx(const int8_t* row, int u0, int, uint32_t (&u)[4]) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 4 * u0);
    u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
  }
  static __device__ __forceinline__ void mad(int& c, uint32_t a, uint32_t b) {
    c = __dp4a(static_cast<int>(a), static_cast<int>(b), c);
  }
  // int32 dot times the row's scale; the query's scale is applied outside
  static __device__ __forceinline__ float score(int c, const float* scale, int row) {
    return static_cast<float>(c) * scale[row];
  }
};

struct OpI4 : OpI8 {
  // four packed bytes -> four sign-extended int8 nibbles (low or high): the
  // arithmetic shifts of `unpack_int4`, on a signed int
  static __device__ __forceinline__ uint32_t unpack(uint32_t w, bool hi) {
    uint32_t out = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = (w >> (8 * i)) & 0xffu;
      const int s = static_cast<int>((hi ? (b >> 4) : (b & 0xfu)) << 28) >> 28;
      out |= (static_cast<uint32_t>(s) & 0xffu) << (8 * i);
    }
    return out;
  }
  // `row` holds n_units*2 packed bytes; units [0, n_units/2) are the low
  // nibbles of bytes [0, 2*n_units), the rest the high nibbles of the same
  static __device__ __forceinline__ void load_idx(const int8_t* row, int u0, int n_units, uint32_t (&u)[4]) {
    const int half = n_units >> 1;
    const bool hi = u0 >= half;
    const uint4 v = *reinterpret_cast<const uint4*>(row + 4 * (hi ? u0 - half : u0));
    u[0] = unpack(v.x, hi); u[1] = unpack(v.y, hi); u[2] = unpack(v.z, hi); u[3] = unpack(v.w, hi);
  }
};

template <int QT>
struct TileShape {
  static constexpr int TQ = 16 * QT;
  static constexpr int STAGE_UNITS = 2 * BK * (TN + TQ);
  static constexpr int SC_STRIDE = TQ + 1;
  static constexpr int SC_UNITS = TN * SC_STRIDE;
  static constexpr int SMEM_UNITS = STAGE_UNITS > SC_UNITS ? STAGE_UNITS : SC_UNITS;
};

// Scores of index rows [row0, row0+TN) against queries [q0, q0+TQ) into
// smem as float sc[r * SC_STRIDE + q]. `index` rows are `ld` elements of
// idx_t apart; `qu` is the query matrix as (B, n_units) 32-bit units. Every
// thread of the block calls it; it begins and ends with a __syncthreads().
template <typename Op, int QT>
__device__ __forceinline__ void score_tile(const typename Op::idx_t* __restrict__ index, long long ld, int N,
                                           const uint32_t* __restrict__ qu, int B, int n_units,
                                           const float* __restrict__ scale, int n_valid, int row0, int q0,
                                           uint32_t* smem) {
  using S = TileShape<QT>;
  constexpr int TQ = S::TQ;
  uint32_t* As = smem;                 // [2][BK][TN]
  uint32_t* Bs = smem + 2 * BK * TN;   // [2][BK][TQ]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  typename Op::acc_t acc[8][QT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[i][j] = 0;

  uint32_t ra[2][4], rb[4];
  auto load_g = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * NT;
      const int gr = row0 + (v >> 2), u0 = kt * BK + (v & 3) * 4;
      if (gr < N && u0 < n_units) {
        Op::load_idx(index + gr * ld, u0, n_units, ra[i]);
      } else {
        ra[i][0] = ra[i][1] = ra[i][2] = ra[i][3] = 0u;
      }
    }
    if (tid < TQ * 4) {
      const int gb = q0 + (tid >> 2), u0 = kt * BK + (tid & 3) * 4;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gb < B && u0 < n_units) v = *reinterpret_cast<const uint4*>(qu + (long long)gb * n_units + u0);
      rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
    }
  };
  auto store_s = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * NT;
      const int r = v >> 2, kk = (v & 3) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) As[(buf * BK + kk + j) * TN + r] = ra[i][j];
    }
    if (tid < TQ * 4) {
      const int qq = tid >> 2, kk = (tid & 3) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[(buf * BK + kk + j) * TQ + qq] = rb[j];
    }
  };

  __syncthreads();  // the caller may still be reading the last tile's scores
  const int nk = (n_units + BK - 1) / BK;
  load_g(0);
  store_s(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_g(kt + 1);
    const uint32_t* a = As + (kt & 1) * BK * TN;
    const uint32_t* b = Bs + (kt & 1) * BK * TQ;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      uint32_t af[8], bf[QT];
      const uint4 a0 = *reinterpret_cast<const uint4*>(a + k * TN + ty * 4);
      const uint4 a1 = *reinterpret_cast<const uint4*>(a + k * TN + 64 + ty * 4);
      af[0] = a0.x; af[1] = a0.y; af[2] = a0.z; af[3] = a0.w;
      af[4] = a1.x; af[5] = a1.y; af[6] = a1.z; af[7] = a1.w;
      if constexpr (QT == 4) {
        const uint4 b0 = *reinterpret_cast<const uint4*>(b + k * TQ + tx * 4);
        bf[0] = b0.x; bf[1] = b0.y; bf[2] = b0.z; bf[3] = b0.w;
      } else {
#pragma unroll
        for (int j = 0; j < QT; ++j) bf[j] = b[k * TQ + tx * QT + j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < QT; ++j) Op::mad(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < nk) store_s((kt + 1) & 1);
    __syncthreads();
  }

  // the staging buffers are free now: the scores take their place
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const int gr = row0 + r;
#pragma unroll
    for (int j = 0; j < QT; ++j)
      sc[r * S::SC_STRIDE + tx * QT + j] = gr < n_valid ? Op::score(acc[i][j], scale, gr) : NEG_INF;
  }
  __syncthreads();
}

}  // namespace topk
