// The score tiles shared by the corpus-index kernels (K4, K5, K11, K12):
// scores[r][b] = <index row r, query b> for a tile of TN index rows and TQ
// queries, left in shared memory as f32 sc[r * SC_STRIDE + b] with the rows
// at or beyond `n_valid` set to NEG_INF. They replace the scoring of the TPU
// kernels `_fused_kernel` and `_segmax_kernel` (rag_docvqa_tpu/ops/topk.py)
// and `_segmax_int8_kernel`, `_segmax_int4_kernel` (rag_docvqa_tpu/ops/quant.py).
// Two forms:
//
// `score_tile` (f32, int8 and int4 indexes): SIMT. The contraction runs over
// 32-bit "units": one f32 element, f32 x f32 FMA with f32 accumulation (the
// tensor cores have no exact f32 product), or four int8 elements taken by one
// __dp4a into an int32 (order-free and exact). An int4 index is read as the
// int8 row [lo nibbles | hi nibbles], which is exactly the pairing of
// `quantize_rows_int4` (element d shares a byte with element d + D/2), so its
// kernel is the int8 kernel with another loader. 256 threads, each 8 rows x QT
// queries of accumulators; index and query tiles are staged k-major in shared
// memory, BK units a step, double buffered through registers. What bounds it
// is the SIMT rate at large B (f32 FMA, dp4a) and, at small B, the latency of
// a loop that crosses two barriers every 16 units.
//
// `Bf16Tile` (bf16 index): the tensor cores, with exact scores. The f32 unit
// query is split exactly into three bf16 terms, q = q0 + q1 + q2
// (ops/topk.py::split_bf16x3: the two residues are exact in f32 and the last
// has at most 8 significant bits). A bf16 x bf16 product is exact in an f32
// accumulator, so three wgmma products into one accumulator give the score of
// the plain f32 product <bf16 row, f32 query>, the order of the f32 sums
// aside; one bf16 product of the query would move the scores by ~1e-3 and
// reorder the top-k. The index rows are wgmma's M side (A, K-major: a row is
// D-contiguous), the queries its N side (B, K-major, TQ = 8, 16, 32 or 64 of
// them: m64n8k16 ... m64n64k16), each of the two warpgroups owns 64 rows of
// the 128-row tile. Steps of 64 along D come through a ring of stages filled
// by 16-byte cp.async into 128-byte-swizzled tiles (hopper.cuh), the stage
// holding the 128 index rows and the TQ rows of each query term; a D that is
// no multiple of 64 is zero-filled. The ring runs on across the tiles a block
// walks, so the next tile's first steps load while this one's scores are
// consumed, and the scores take the stage the last step read, so that two
// (TQ 64) or three blocks fit an SM and one block's barriers, epilogue and
// top-k insertion run under another's products. What bounds it: at B <= 16
// the one read of the index (bytes); at B 256 the operations of the three
// products, short of which stand the L2 reads of the query terms, 1.5 times
// the index rows' bytes at TQ 64 (8 GB a call at N 524,288, D 768).
#pragma once

#include <type_traits>

#include "hopper.cuh"

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

// ---- the bf16 index on the tensor cores ------------------------------------
// one 16-deep step of a warpgroup's 64 rows against TQ queries
template <int TQ>
__device__ __forceinline__ void wgmma_rows_queries(float (&d)[TQ / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (TQ == 8) wgmma_m64n8k16_ss<0, 0>(d, desc_a, desc_b, 1);
  else if constexpr (TQ == 16) wgmma_m64n16k16_ss<0, 0>(d, desc_a, desc_b, 1);
  else if constexpr (TQ == 32) wgmma_m64n32k16_ss<0, 0>(d, desc_a, desc_b, 1);
  else wgmma_m64n64k16_ss<0, 0>(d, desc_a, desc_b, 1);
}

// the tiles [t_first, t_end) of row block rb of n_rb over ntiles: contiguous
// runs of ceil(ntiles / n_rb) tiles, the last one shorter
__device__ __forceinline__ void row_block_tiles(int rb, int n_rb, int ntiles, int& t_first, int& t_end) {
  const int len = (ntiles + n_rb - 1) / n_rb;
  t_first = min(rb * len, ntiles);
  t_end = min(t_first + len, ntiles);
}

// the query tile of the bf16 kernels for a batch of B, the narrowest wgmma form
// that holds it and 64 above 32: `launch` gets it as std::integral_constant
template <typename Launch>
cudaError_t by_query_tile(int B, Launch&& launch) {
  if (B <= 8) return launch(std::integral_constant<int, 8>());
  if (B <= 16) return launch(std::integral_constant<int, 16>());
  if (B <= 32) return launch(std::integral_constant<int, 32>());
  return launch(std::integral_constant<int, 64>());
}

// The tiles [t_first, t_end) of one block against queries [q0, q0 + TQ), one
// after the other. `index` is (N, D) bf16, `qt` the (3, B, D) bf16 query terms.
// The loads run AHEAD steps ahead of the products in one flat order over the
// tiles, so `score` of tile t issues the copies of tile t + 1's first steps.
// Every thread of the block constructs it and calls `score` for t_first,
// t_first + 1, ... in turn; `score` begins with a barrier before it writes the
// scores and ends with one after. The scores go to the stage the tile's last
// step read, which no copy refills before the next `score` has passed its
// first barrier.
template <int TQ>
struct Bf16Tile {
  static_assert(TQ == 8 || TQ == 16 || TQ == 32 || TQ == 64, "the wgmma forms of hopper.cuh");
  // stages of the ring and blocks resident on an SM, chosen by timing both on the
  // H100: two or three blocks an SM beat one block with a deeper ring
  static constexpr int GST = TQ >= 32 ? 2 : 3;
  static constexpr int BLOCKS_PER_SM = TQ == 64 ? 2 : 3;
  static constexpr int AHEAD = GST - 1;  // steps in flight ahead of the one multiplied
  static constexpr int A_BYTES = TN * 128;         // 128 index rows x 64 bf16
  static constexpr int STAGE = A_BYTES + 3 * TQ * 128;  // + TQ rows of each query term; 1024-byte multiples
  static constexpr int SC_STRIDE = TQ + 1;
  static_assert(TN * SC_STRIDE * 4 <= STAGE, "the scores fit in a stage");
  static constexpr int SMEM = 1024 + GST * STAGE;  // + room to align the ring to 1024 bytes

  const __nv_bfloat16* index;
  const __nv_bfloat16* qt;
  int N, D, B, q0, KT;
  uint32_t ring;
  uint8_t* ring_ptr;         // the ring as a generic pointer
  float* sc;                 // [TN][SC_STRIDE], valid after `score`
  int ld_tile, ld_kt, ld_end, ld_stage, stage;

  __device__ __forceinline__ Bf16Tile(uint8_t* smem, const __nv_bfloat16* index_, int N_, int D_,
                                      const __nv_bfloat16* qt_, int B_, int q0_, int t_first, int t_end)
      : index(index_), qt(qt_), N(N_), D(D_), B(B_), q0(q0_), KT((D_ + 63) / 64),
        ld_tile(t_first), ld_kt(0), ld_end(t_end), ld_stage(0), stage(0) {
    const uint32_t raw = smem_u32(smem);
    ring = (raw + 1023u) & ~1023u;
    ring_ptr = smem + (ring - raw);
    sc = reinterpret_cast<float*>(ring_ptr);
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) issue();
  }

  // shared memory past the ring, for the caller
  __device__ __forceinline__ uint8_t* tail() const { return ring_ptr + GST * STAGE; }

  // step kt (64 elements of D) of the tile at row0 into stage `st`: 128 index
  // rows and 3 * TQ query-term rows, 8 threads on a 128-byte row, rows 32
  // apart for each thread (so its chunk's swizzled place is the same in each).
  // Rows past N or B and elements past D are zero-filled.
  __device__ __forceinline__ void load(int row0, int kt, int st) {
    const int tid = threadIdx.x, r = tid >> 3, ch = tid & 7;
    const int k = kt * 64 + ch * 8;
    const bool kin = k < D;
    const uint32_t dst = ring + st * STAGE + swz_off(r, ch);
#pragma unroll
    for (int i = 0; i < TN / 32; ++i) {
      const int row = row0 + r + 32 * i;
      const bool in = kin && row < N;
      cp_async16(dst + i * 32 * 128, in ? index + (long long)row * D + k : index, in);
    }
    // query-term row R: term R / TQ, query q0 + R % TQ (TQ is a multiple of 8, so
    // the three terms' tiles are one 3*TQ-row swizzled tile)
#pragma unroll
    for (int i = 0; i < (3 * TQ + 31) / 32; ++i) {
      const int R = r + 32 * i;
      if (R < 3 * TQ) {
        const int b = q0 + R % TQ;
        const bool in = kin && b < B;
        cp_async16(dst + A_BYTES + i * 32 * 128, in ? qt + ((long long)(R / TQ) * B + b) * D + k : qt, in);
      }
    }
  }

  // the next step's copies in flight, if there is one; always one commit group
  __device__ __forceinline__ void issue() {
    if (ld_tile < ld_end) {
      load(ld_tile * TN, ld_kt, ld_stage);
      if (++ld_kt == KT) { ld_kt = 0; ++ld_tile; }
      ld_stage = ld_stage + 1 == GST ? 0 : ld_stage + 1;
    }
    cp_async_commit();
  }

  // the tile at row0 (the next one in the walk) into sc
  __device__ __forceinline__ void score(int row0, int n_valid) {
    const int tid = threadIdx.x, wg = tid >> 7;
    float acc[TQ / 2];
#pragma unroll
    for (int i = 0; i < TQ / 2; ++i) acc[i] = 0.f;
    int last = stage;
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<AHEAD - 1>();  // this thread's copies of this step have landed
      fence_async_shared();
      // everyone's have; every warp is done with the last step's products and
      // (kt == 0) with the last tile's scores
      __syncthreads();
      issue();  // into the stage those products read
      const uint32_t st = ring + stage * STAGE;
      const uint32_t sa = st + wg * (64 * 128), sb = st + A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kt * 64 + kk * 16 < D) {  // steps past D hold zeros
#pragma unroll
          for (int term = 0; term < 3; ++term)
            wgmma_rows_queries<TQ>(acc, wgmma_desc(sa + kk * 32), wgmma_desc(sb + term * (TQ * 128) + kk * 32));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      last = stage;
      stage = stage + 1 == GST ? 0 : stage + 1;
    }
    sc = reinterpret_cast<float*>(ring_ptr + last * STAGE);
    __syncthreads();  // both warpgroups' products have read that stage
    // the accumulator layout of hopper.cuh: row 16 w + l / 4 (+ 8), columns 8 j + 2 (l % 4) + {0, 1}
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      const bool valid = row0 + r < n_valid;
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sc[r * SC_STRIDE + j * 8 + c0 + e] = valid ? acc[j * 4 + half * 2 + e] : NEG_INF;
    }
    __syncthreads();
  }
};

}  // namespace topk
