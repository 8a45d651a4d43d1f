// The score tiles shared by the corpus-index kernels (K4, K5, K11, K12) and
// MaxSim (K15): scores[r][b] = <index row r, query b> for a tile of TN index
// rows and TQ queries, with the rows at or beyond `n_valid` set to NEG_INF.
// They replace the scoring of the TPU kernels `_fused_kernel` and
// `_segmax_kernel` (rag_docvqa_tpu/ops/topk.py) and `_segmax_int8_kernel`,
// `_segmax_int4_kernel` (rag_docvqa_tpu/ops/quant.py); maxsim.cu takes
// `F32Tile` for its patch rows against the query tokens.
//
// All four run on the tensor cores (wgmma), each warpgroup owning 64 of the
// tile's 128 index rows (wgmma's M side, A), the queries its N side (B,
// K-major from 128-byte-swizzled shared tiles, hopper.cuh). Steps along D come
// through a ring of stages filled by 16-byte cp.async; the ring runs on across
// the tiles a block walks (`RingWalk`), so the next tile's first steps load
// while this one's scores are consumed. Elements past D are zero-filled and
// steps wholly past it skipped. The float tiles' scores take the stage the
// last step read.
//
// `Bf16Tile` (bf16 index): the f32 unit query is split exactly into three bf16
// terms, q = q0 + q1 + q2 (ops/topk.py::split_bf16x3: the two residues are
// exact in f32 and the last has at most 8 significant bits). A bf16 x bf16
// product is exact in an f32 accumulator, so three products of a step's
// shared A tile into one accumulator give the score of the plain f32 product
// <bf16 row, f32 query>, the order of the f32 sums aside; one bf16 product of
// the query would move the scores by ~1e-3 and reorder the top-k. TQ = 8,
// 16, 32 or 64 (m64n8k16 ... m64n64k16). What bounds it: at B <= 16 the one
// read of the index (bytes); at B 256 the operations of the three products,
// short of which stand the L2 reads of the query terms.
//
// `F32Tile` (f32 index): one bf16 product cannot hold an f32 row either, but
// three terms can: each thread loads its A fragment of f32 rows from the
// stage (the m16k16 layout, two f32 a register pair) and splits it in
// registers, x = x0 + x1 + x2 exactly, by the arithmetic of `split_bf16x3`.
// The six products x_i q_j with i + j <= 2 (x0q0, x0q1, x1q0, x0q2, x1q1,
// x2q0) go from registers (wgmma's A-from-registers form) into a fresh f32
// accumulator each 64-deep step, which is added into the score in registers
// (the tensor cores truncate as they accumulate: `products` says why); the three
// left out are below 2^-24 of |x_d q_d| each, f32's own rounding. Six bf16
// products at 989 TFLOP/s are ~2.5x the 67 TFLOP/s of f32 FMA. TQ up to 128
// (m64n128k16), so that at B 256 the f32 index (twice the bf16 bytes) is read
// by two query blocks, not four. What bounds it: at B <= 16 the one read of
// the index (bytes), at B 256 the six products.
//
// `I4Tile` (int4 index, K12): packed rows (element d with element d + D/2 in
// one byte, `quantize_rows_int4`) come into the ring as they are stored, 64
// bytes a row a step; each thread loads its A fragment words (the m16k32 s8
// layout, four bytes a register) and unpacks each 32-bit word into the low
// and the high nibbles, sign-extended to int8, with two byte permutes and two
// bit selects (`unpack_lo`, `unpack_hi`). The query q8 (B, D) int8 is B: a
// stage row holds q8[b, j..j+64) beside q8[b, D/2+j..D/2+j+64), so each
// 32-byte step is two s8 wgmma products, lo x the first half and hi x the
// second, into one exact int32 accumulator. The epilogue scales, masks and
// takes the maxima of `group` rows in registers and shuffles (a warp's 16 rows
// are one group at group 16), staged for 16-byte stores. What bounds it: the
// one read of the packed index at B <= 16 (bytes), the int8 products at B 256.
//
// `I8Tile` (int8 index, K11): the rows come into the ring as they are stored,
// 128 bytes of D a row a step, as the bf16 tiles' 64 elements, so that A and
// the query q8 (B) are the 128-byte-swizzled K-major tiles of hopper.cuh; each
// 32-byte sub-step is one s8 wgmma with both operands read by descriptor from
// shared memory (no unpack, so no A fragment in registers), into an exact
// int32 accumulator. Its epilogue is K12's. What bounds it: the one read of the
// index at B <= 16 (bytes, twice K12's), the int8 products at B 256.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace topk {

constexpr int NT = 256;  // threads per block
constexpr int TN = 128;  // index rows per tile
constexpr float NEG_INF = -1e30f;

// (score, index) order of every selection here: score descending, then
// index ascending -- the tie rule of lax.top_k and of `_topk_merge`.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// ---- the wgmma tiles -------------------------------------------------------
// one 16-deep step of a warpgroup's 64 rows against TQ queries, A shared
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

// The query tile a wrapper asks for (ops/topk.py::_tile_plan): `launch` gets it
// as std::integral_constant; 128 only for the tiles that have that form.
// `no_form` is returned for a query tile the tile has no form for.
template <int MAX_TQ, typename Launch>
cudaError_t with_query_tile(int tq, Launch&& launch, cudaError_t no_form = cudaErrorInvalidValue) {
  switch (tq) {
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    case 64: return launch(std::integral_constant<int, 64>());
    case 128:
      if constexpr (MAX_TQ >= 128) return launch(std::integral_constant<int, 128>());
      break;
  }
  return no_form;
}

// the dynamic shared memory a wgmma kernel takes, and all of the SM's for it
template <typename Kernel>
cudaError_t set_smem(Kernel kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// into *blocks, the blocks of `kern` an SM holds at once with `smem` bytes of
// dynamic shared memory: what the wrappers size a one-wave grid by (the
// `*_resident` entry points)
template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, int smem, int* blocks) {
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, NT, smem);
}

// The counters of a block's walk over the steps of its tiles [t_first,
// t_end), KT steps a tile, through a ring of GST stages (F32Tile, I4Tile,
// I8Tile; Bf16Tile keeps its own): the copies run GST - 1 steps ahead of the products
// in one flat order over the tiles, so the products of tile t issue the copies
// of tile t + 1's first steps.
template <int GST>
struct RingWalk {
  int KT, ld_tile, ld_kt, ld_end, ld_stage, stage;

  __device__ __forceinline__ RingWalk(int KT_, int t_first, int t_end)
      : KT(KT_), ld_tile(t_first), ld_kt(0), ld_end(t_end), ld_stage(0), stage(0) {}

  // the next copies' tile row, step and stage, and on to the ones after;
  // false once every step of the walk has been copied
  __device__ __forceinline__ bool next_load(int& row0, int& kt, int& st) {
    if (ld_tile >= ld_end) return false;
    row0 = ld_tile * TN;
    kt = ld_kt;
    st = ld_stage;
    if (++ld_kt == KT) { ld_kt = 0; ++ld_tile; }
    ld_stage = ld_stage + 1 == GST ? 0 : ld_stage + 1;
    return true;
  }
  // the stage of the step whose products come next, and on to the one after
  __device__ __forceinline__ int next_stage() {
    const int s = stage;
    stage = stage + 1 == GST ? 0 : stage + 1;
    return s;
  }
};

// the accumulator layout of hopper.cuh, into the scores in shared memory: row
// 16 w + l / 4 (+ 8), columns 8 j + 2 (l % 4) + {0, 1}; rows at or past
// n_valid at NEG_INF
template <int TQ, int SC_STRIDE, typename Acc>
__device__ __forceinline__ void store_scores(const Acc (&acc)[TQ / 2], float* sc, int row0, int n_valid,
                                             const float* scale = nullptr) {
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    const bool valid = row0 + r < n_valid;
    const float s = valid && scale != nullptr ? scale[row0 + r] : 1.f;
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sc[r * SC_STRIDE + j * 8 + c0 + e] = valid ? static_cast<float>(acc[j * 4 + half * 2 + e]) * s : NEG_INF;
  }
}

// The query-term rows of a step into the 3*TQ-row swizzled tile at `dst` (this
// thread's chunk place of its first row): row R is term R / TQ, query
// q0 + R % TQ (TQ is a multiple of 8, so the three terms' tiles are one
// tile), elements [k, k + 8) of D; 8 threads on a row, rows 32 apart for each
// thread (so its chunk's swizzled place is the same in each). Rows past B and
// elements past D are zero-filled.
template <int TQ>
__device__ __forceinline__ void load_query_terms(const __nv_bfloat16* qt, int B, int D, int q0, int k, uint32_t dst) {
#pragma unroll
  for (int i = 0; i < (3 * TQ + 31) / 32; ++i) {
    const int R = (threadIdx.x >> 3) + 32 * i;
    if (R < 3 * TQ) {
      const int b = q0 + R % TQ;
      const bool in = k < D && b < B;
      cp_async16(dst + i * 32 * 128, in ? qt + ((long long)(R / TQ) * B + b) * D + k : qt, in);
    }
  }
}

// The wgmma tiles share one use: every thread of the block constructs one for
// its tiles [t_first, t_end) against queries [q0, q0 + TQ) and calls `score`
// (or `products`: K11, K12, K15) for t_first, t_first + 1, ... in turn. `score` begins
// with a barrier before it writes the scores and ends with one after. The
// scores go to the stage the tile's last step read, which no copy refills
// before the next `score` has passed its first barrier.

// bf16 index (N, D), `qt` the (3, B, D) bf16 query terms.
// The loads run AHEAD steps ahead of the products in one flat order over the
// tiles, so `score` of tile t issues the copies of tile t + 1's first steps.
template <int TQ>
struct Bf16Tile {
  static_assert(TQ == 8 || TQ == 16 || TQ == 32 || TQ == 64, "the wgmma forms of hopper.cuh");
  using idx_t = __nv_bfloat16;
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

// f32 index (N, D), `qt` the (3, B, D) bf16 query terms. A stage holds 64
// elements of D of the 128 rows as two 128-row x 32-f32 halves (16 KB each),
// the 16-byte chunk c of row r at chunk place c ^ 2 (r % 4): each quarter-warp
// reads 8 bytes of four rows whose places differ, without bank conflicts;
// then the query terms' rows as in Bf16Tile.
template <int TQ>
struct F32Tile {
  static_assert(TQ == 8 || TQ == 16 || TQ == 32 || TQ == 64 || TQ == 128, "the wgmma forms of hopper.cuh");
  using idx_t = float;
  // two blocks an SM up to 32 queries; a stage of 64 or 128 queries (56, 80 KB)
  // and their accumulators leave room for one
  static constexpr int GST = TQ == 8 ? 3 : 2;
  static constexpr int BLOCKS_PER_SM = TQ <= 32 ? 2 : 1;
  static constexpr int AHEAD = GST - 1;
  static constexpr int HALF = TN * 128;            // 128 rows x 32 f32
  static constexpr int A_BYTES = 2 * HALF;
  static constexpr int STAGE = A_BYTES + 3 * TQ * 128;
  static constexpr int SC_STRIDE = TQ + 1;
  static_assert(TN * SC_STRIDE * 4 <= STAGE, "the scores fit in a stage");
  static constexpr int SMEM = 1024 + GST * STAGE;

  const float* index;
  const __nv_bfloat16* qt;
  int N, D, B, q0;
  uint32_t ring;
  uint8_t* ring_ptr;
  float* sc;
  RingWalk<GST> walk;

  __device__ __forceinline__ F32Tile(uint8_t* smem, const float* index_, int N_, int D_, const __nv_bfloat16* qt_,
                                     int B_, int q0_, int t_first, int t_end)
      : index(index_), qt(qt_), N(N_), D(D_), B(B_), q0(q0_), walk((D_ + 63) / 64, t_first, t_end) {
    const uint32_t raw = smem_u32(smem);
    ring = (raw + 1023u) & ~1023u;
    ring_ptr = smem + (ring - raw);
    sc = reinterpret_cast<float*>(ring_ptr);
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) issue();
  }

  __device__ __forceinline__ uint8_t* tail() const { return ring_ptr + GST * STAGE; }

  static __device__ __forceinline__ uint32_t a_off(int r, int ch) {
    return static_cast<uint32_t>(r * 128 + ((ch ^ ((r & 3) << 1)) << 4));
  }

  // step kt of the tile at row0 into stage `st`: 16 threads on a row's 256
  // bytes, 16 rows a pass; rows past N and elements past D zero-filled
  __device__ __forceinline__ void load(int row0, int kt, int st) {
    const int tid = threadIdx.x, r = tid >> 4, cc = tid & 15;
    const int k = kt * 64 + cc * 4;
    const bool kin = k < D;
    const uint32_t dst = ring + st * STAGE + (cc >> 3) * HALF + a_off(r, cc & 7);
#pragma unroll
    for (int i = 0; i < TN / 16; ++i) {
      const int row = row0 + r + 16 * i;
      const bool in = kin && row < N;
      cp_async16(dst + i * 16 * 128, in ? index + (long long)row * D + k : index, in);
    }
    load_query_terms<TQ>(qt, B, D, q0, kt * 64 + (tid & 7) * 8, ring + st * STAGE + A_BYTES + swz_off(tid >> 3, tid & 7));
  }

  // the next step's copies in flight, if there is one; always one commit group
  __device__ __forceinline__ void issue() {
    int row0, kt, st;
    if (walk.next_load(row0, kt, st)) load(row0, kt, st);
    cp_async_commit();
  }

  // two f32 values -> three bf16 pairs with x = x0 + x1 + x2 exactly (the low
  // column in each word's low half, as the A fragment takes them)
  static __device__ __forceinline__ void split3(float2 v, uint32_t& w0, uint32_t& w1, uint32_t& w2) {
    w0 = pack_bf16(v.x, v.y);
    const float rx = v.x - __uint_as_float(w0 << 16), ry = v.y - __uint_as_float(w0 & 0xffff0000u);
    w1 = pack_bf16(rx, ry);
    w2 = pack_bf16(rx - __uint_as_float(w1 << 16), ry - __uint_as_float(w1 & 0xffff0000u));
  }

  // The tensor cores add a product group into the f32 accumulator with a
  // truncation at its magnitude. So each step's products go into a fresh
  // accumulator, the five small ones first (at ~2^-8 of the step's partial
  // sum they lose nothing that shows), x0 q0 last, and the step's sum is added
  // into `sum` by an f32 add that rounds to nearest: 4 truncated additions a
  // step, not 24 in a row into the whole score (which moved K4's scores by
  // up to ~1e-6 and swapped a near tie in 80 ranks). The scores of the tile (the
  // next one in the walk) go into sum, in the accumulator layout of hopper.cuh;
  // returns the stage its last step read.
  __device__ __forceinline__ int products(float (&sum)[TQ / 2]) {
    const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
    float acc[TQ / 2];
#pragma unroll
    for (int i = 0; i < TQ / 2; ++i) sum[i] = 0.f;
    // this thread's fragment rows R and R + 8 (1024 bytes on, the same chunk
    // places); off[p][h]: the 8 bytes of columns 16 kk + 8 h + 2 (l % 4) for
    // kk % 2 == p, within the half kk / 2
    const int R = wg * 64 + warp * 16 + (lane >> 2), t = lane & 3;
    uint32_t off[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) off[p][h] = a_off(R, 4 * p + 2 * h + (t >> 1)) + (t & 1) * 8;
    constexpr uint32_t TERM = TQ * 128;  // bytes from one query term's tile to the next
    int last = 0;
    for (int kt = 0; kt < walk.KT; ++kt) {
      cp_async_wait<AHEAD - 1>();  // this thread's copies of this step have landed
      fence_async_shared();
      // everyone's have; every warp is done with the last step's products and
      // (kt == 0) with the last tile's scores
      __syncthreads();
      issue();  // into the stage those products read
      const int stage = walk.next_stage();
      const uint8_t* a = ring_ptr + stage * STAGE;
      const uint32_t sb = ring + stage * STAGE + A_BYTES;
      const int nk = min(4, (D - kt * 64) / 16);  // 16-deep steps holding data (D % 16 == 0)
      uint32_t x[4][3][4];  // [kk][term][register]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < nk) {
          const uint8_t* h = a + (kk >> 1) * HALF;
          const float2 v[4] = {*reinterpret_cast<const float2*>(h + off[kk & 1][0]),
                               *reinterpret_cast<const float2*>(h + off[kk & 1][0] + 1024),
                               *reinterpret_cast<const float2*>(h + off[kk & 1][1]),
                               *reinterpret_cast<const float2*>(h + off[kk & 1][1] + 1024)};
#pragma unroll
          for (int i = 0; i < 4; ++i) split3(v[i], x[kk][0][i], x[kk][1][i], x[kk][2][i]);
          wgmma_fence();  // this step's fragments are written
          const uint32_t b = sb + kk * 32;
          wgmma_bf16_rs<TQ>(acc, x[kk][0], wgmma_desc(b + TERM), kk > 0);  // x0 q1
          wgmma_bf16_rs<TQ>(acc, x[kk][1], wgmma_desc(b), 1);              // x1 q0
          wgmma_bf16_rs<TQ>(acc, x[kk][0], wgmma_desc(b + 2 * TERM), 1);   // x0 q2
          wgmma_bf16_rs<TQ>(acc, x[kk][1], wgmma_desc(b + TERM), 1);       // x1 q1
          wgmma_bf16_rs<TQ>(acc, x[kk][2], wgmma_desc(b), 1);              // x2 q0
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) wgmma_bf16_rs<TQ>(acc, x[kk][0], wgmma_desc(sb + kk * 32), 1);  // x0 q0
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) sum[i] += acc[i];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int term = 0; term < 3; ++term) fence_regs(x[kk][term]);
      last = stage;
    }
    return last;
  }

  // the tile at row0 (the next one in the walk) into sc
  __device__ __forceinline__ void score(int row0, int n_valid) {
    float sum[TQ / 2];
    sc = reinterpret_cast<float*>(ring_ptr + products(sum) * STAGE);
    __syncthreads();  // both warpgroups' products have read that stage
    store_scores<TQ, SC_STRIDE>(sum, sc, row0, n_valid);
    __syncthreads();
  }
};

// int4 index: four packed bytes -> four sign-extended int8 nibbles. The low
// nibbles: shifted to the top of each byte, whose sign bit a byte permute
// (selector 8 + i: byte i's sign replicated) spreads over the byte, and a bit
// select keeps the nibble below it; the high nibbles likewise from the word as
// it is, shifted down for the value. Exactly `unpack_int4`'s arithmetic
// shifts of each byte.
__device__ __forceinline__ uint32_t prmt_sign(uint32_t w) {  // prmt.b32 w, 0, 0xBA98
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(w), "r"(0u), "r"(0xBA98u));
  return d;
}
__device__ __forceinline__ uint32_t unpack_lo(uint32_t w) {
  const uint32_t sign = prmt_sign(w << 4);
  return (w & 0x0F0F0F0Fu) | (sign & 0xF0F0F0F0u);
}
__device__ __forceinline__ uint32_t unpack_hi(uint32_t w) {
  const uint32_t sign = prmt_sign(w);
  return ((w >> 4) & 0x0F0F0F0Fu) | (sign & 0xF0F0F0F0u);
}

// packed int4 index (N, D/2), q8 (B, D) int8. A stage: 128 rows x 64 packed
// bytes (the 16-byte chunk c of row r at place c ^ (r / 2 % 4): a warp's
// 4-byte fragment reads fall in 32 different banks), then TQ query rows of 128
// bytes, 128-byte-swizzled: q8[b, j..j+64) and q8[b, D/2+j..D/2+j+64).
template <int TQ>
struct I4Tile {
  static_assert(TQ == 8 || TQ == 16 || TQ == 32 || TQ == 64 || TQ == 128, "the wgmma forms of hopper.cuh");
  // two blocks an SM at every query tile: on the H100 one block of 128 queries
  // with six stages, a step's products left running across the next step's
  // barrier, took 0.86 ms at B 256 against 0.64 for two blocks of four stages
  static constexpr int GST = 4;
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr int AHEAD = GST - 1;
  static constexpr int A_BYTES = TN * 64;
  static constexpr int STAGE = A_BYTES + TQ * 128;
  static constexpr int SMEM = 1024 + GST * STAGE;

  const int8_t* packed;
  const int8_t* q8;
  int N, Dh, B, q0;
  uint32_t ring;
  uint8_t* ring_ptr;
  RingWalk<GST> walk;

  __device__ __forceinline__ I4Tile(uint8_t* smem, const int8_t* packed_, int N_, int D, const int8_t* q8_, int B_,
                                    int q0_, int t_first, int t_end)
      : packed(packed_), q8(q8_), N(N_), Dh(D / 2), B(B_), q0(q0_), walk((D / 2 + 63) / 64, t_first, t_end) {
    const uint32_t raw = smem_u32(smem);
    ring = (raw + 1023u) & ~1023u;
    ring_ptr = smem + (ring - raw);
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) issue();
  }

  __device__ __forceinline__ uint8_t* tail() const { return ring_ptr + GST * STAGE; }

  static __device__ __forceinline__ uint32_t a_off(int r, int ch) {
    return static_cast<uint32_t>(r * 64 + ((ch ^ ((r >> 1) & 3)) << 4));
  }

  // step kt (64 packed bytes) of the tile at row0 into stage `st`: 4 threads on
  // a packed row, 64 rows a pass; 8 threads on a query row, 32 rows a pass
  __device__ __forceinline__ void load(int row0, int kt, int st) {
    const int tid = threadIdx.x, r = tid >> 2, ch = tid & 3;
    const int j = kt * 64 + ch * 16;
    const bool jin = j < Dh;
    const uint32_t dst = ring + st * STAGE;
#pragma unroll
    for (int i = 0; i < TN / 64; ++i) {
      const int row = row0 + r + 64 * i;
      const bool in = jin && row < N;
      cp_async16(dst + a_off(r + 64 * i, ch), in ? packed + (long long)row * Dh + j : packed, in);
    }
    const int qr = tid >> 3, qc = tid & 7;
    const int jq = kt * 64 + (qc & 3) * 16;  // chunks 0-3 the low half's elements, 4-7 the high half's
    const long long col = (qc < 4 ? 0 : Dh) + jq;
#pragma unroll
    for (int i = 0; i < (TQ + 31) / 32; ++i) {
      const int R = qr + 32 * i;
      if (R < TQ) {
        const int b = q0 + R;
        const bool in = jq < Dh && b < B;
        cp_async16(dst + A_BYTES + swz_off(R, qc), in ? q8 + (long long)b * 2 * Dh + col : q8, in);
      }
    }
  }

  __device__ __forceinline__ void issue() {
    int row0, kt, st;
    if (walk.next_load(row0, kt, st)) load(row0, kt, st);
    cp_async_commit();
  }

  // the int32 dots of the tile (the next one in the walk) into acc, in the
  // accumulator layout of hopper.cuh
  __device__ __forceinline__ void products(int (&acc)[TQ / 2]) {
    const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
    // fragment rows R and R + 8 (512 bytes on, the same chunk places); off[p][h]:
    // the 4 bytes of packed columns 32 p + 16 h + 4 (l % 4)
    const int R = wg * 64 + warp * 16 + (lane >> 2), t = lane & 3;
    uint32_t off[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) off[p][h] = a_off(R, 2 * p + h) + 4 * t;
    for (int kt = 0; kt < walk.KT; ++kt) {
      cp_async_wait<AHEAD - 1>();
      fence_async_shared();
      __syncthreads();
      issue();
      const int stage = walk.next_stage();
      const uint8_t* a = ring_ptr + stage * STAGE;
      const uint32_t sb = ring + stage * STAGE + A_BYTES;
      uint32_t lo[2][4], hi[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (kt * 64 + p * 32 < Dh) {  // steps past D/2 hold zeros
          const uint32_t w[4] = {*reinterpret_cast<const uint32_t*>(a + off[p][0]),
                                 *reinterpret_cast<const uint32_t*>(a + off[p][0] + 512),
                                 *reinterpret_cast<const uint32_t*>(a + off[p][1]),
                                 *reinterpret_cast<const uint32_t*>(a + off[p][1] + 512)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[p][i] = unpack_lo(w[i]);
            hi[p][i] = unpack_hi(w[i]);
          }
          wgmma_fence();
          wgmma_s8_rs<TQ>(acc, lo[p], wgmma_desc(sb + p * 32), kt + p > 0);  // the tile's first starts acc
          wgmma_s8_rs<TQ>(acc, hi[p], wgmma_desc(sb + 64 + p * 32), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        fence_regs(lo[p]);
        fence_regs(hi[p]);
      }
    }
  }
};

// int8 index (N, D), q8 (B, D) int8 (K11). A stage: 128 index rows x 128 bytes
// of D, then TQ query rows x 128 bytes, both swizzled as the bf16 tiles' (the
// 16-byte chunk c of row r at c ^ (r % 8)), so a warpgroup's 64 rows and the
// queries are read by wgmma_desc, 32 bytes on for each s8 sub-step.
template <int TQ>
struct I8Tile {
  static_assert(TQ == 8 || TQ == 16 || TQ == 32 || TQ == 64 || TQ == 128, "the wgmma forms of hopper.cuh");
  // two blocks an SM, as I4Tile; a stage of 64 or 128 queries (24, 32 KB) takes
  // three stages for two blocks to fit
  static constexpr int GST = TQ >= 64 ? 3 : 4;
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr int AHEAD = GST - 1;
  static constexpr int A_BYTES = TN * 128;
  static constexpr int STAGE = A_BYTES + TQ * 128;
  static constexpr int SMEM = 1024 + GST * STAGE;

  const int8_t* index;
  const int8_t* q8;
  int N, D, B, q0;
  uint32_t ring;
  uint8_t* ring_ptr;
  RingWalk<GST> walk;

  __device__ __forceinline__ I8Tile(uint8_t* smem, const int8_t* index_, int N_, int D_, const int8_t* q8_, int B_,
                                    int q0_, int t_first, int t_end)
      : index(index_), q8(q8_), N(N_), D(D_), B(B_), q0(q0_), walk((D_ + 127) / 128, t_first, t_end) {
    const uint32_t raw = smem_u32(smem);
    ring = (raw + 1023u) & ~1023u;
    ring_ptr = smem + (ring - raw);
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) issue();
  }

  __device__ __forceinline__ uint8_t* tail() const { return ring_ptr + GST * STAGE; }

  // step kt (128 bytes of D) of the tile at row0 into stage `st`: 8 threads on
  // a 128-byte row, rows 32 apart for each thread (so its chunk's swizzled
  // place is the same in each); rows past N or B and bytes past D zero-filled
  __device__ __forceinline__ void load(int row0, int kt, int st) {
    const int tid = threadIdx.x, r = tid >> 3, ch = tid & 7;
    const int k = kt * 128 + ch * 16;
    const bool kin = k < D;
    const uint32_t dst = ring + st * STAGE + swz_off(r, ch);
#pragma unroll
    for (int i = 0; i < TN / 32; ++i) {
      const int row = row0 + r + 32 * i;
      const bool in = kin && row < N;
      cp_async16(dst + i * 32 * 128, in ? index + (long long)row * D + k : index, in);
    }
#pragma unroll
    for (int i = 0; i < (TQ + 31) / 32; ++i) {
      const int R = r + 32 * i;
      if (R < TQ) {
        const int b = q0 + R;
        const bool in = kin && b < B;
        cp_async16(dst + A_BYTES + i * 32 * 128, in ? q8 + (long long)b * D + k : q8, in);
      }
    }
  }

  __device__ __forceinline__ void issue() {
    int row0, kt, st;
    if (walk.next_load(row0, kt, st)) load(row0, kt, st);
    cp_async_commit();
  }

  // the int32 dots of the tile (the next one in the walk) into acc, in the
  // accumulator layout of hopper.cuh
  __device__ __forceinline__ void products(int (&acc)[TQ / 2]) {
    const int wg = threadIdx.x >> 7;
    for (int kt = 0; kt < walk.KT; ++kt) {
      cp_async_wait<AHEAD - 1>();  // this thread's copies of this step have landed
      fence_async_shared();
      // everyone's have; every warp is done with the last step's products
      __syncthreads();
      issue();  // into the stage those products read
      const uint32_t st = ring + walk.next_stage() * STAGE;
      const uint32_t sa = st + wg * (64 * 128), sb = st + A_BYTES;
      wgmma_fence();  // the accumulators were last written outside wgmma (the epilogue, or zeros)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kt * 128 + kk * 32 < D)  // sub-steps past D hold zeros; the tile's first starts acc
          wgmma_s8_ss<TQ>(acc, wgmma_desc(sa + kk * 32), wgmma_desc(sb + kk * 32), kt + kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
  }
};

}  // namespace topk
