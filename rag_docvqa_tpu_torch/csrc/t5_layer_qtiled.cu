// K13's attention: the online softmax of the query-tiled T5 layer on the
// tensor cores, for a bias-free bf16 row (Pix2Struct's tower: the 2048-patch
// page budget, and the 128- and 1024-patch rows of K1 without a bias). With
// K1's RMSNorm and GEMMs (t5_layer.cu) it makes the whole layer
// (ops/fused_encoder.py::fused_t5_layer_qtiled, fused_t5_layer_parts(bias=None)):
//
//   per head and tile of 64 queries, over key chunks of 64:
//     s = q k^T (f32), masked keys at -1e9
//     m' = max(m, rowmax(s)); alpha = exp(m - m'); p = exp(s - m')
//     l = l alpha + rowsum(p); acc = acc alpha + cast(p) v (f32); m = m'
//   out = cast(acc / max(l, 1e-30))
//
// Replaces the attention loop of the TPU kernel `_t5_layer_kernel_qtiled` of
// rag_docvqa_tpu/ops/fused_encoder.py (called from `_t5_layer_call_qtiled`),
// with its order: no scale, no bias, p cast to the compute dtype before p.v,
// the division after the last chunk, m starting at -1e30, so a row with no
// valid key attends uniformly. Chunk sizes (64 here, 512 there) change only
// the order of f32 sums.
//
// What bounds it on the H100: at B 8, H 12, T 2048, dk 64 the attention is
// 103 GFLOP against 50 MB of q, k, v and o: arithmetic, by three orders. Both
// products run on WMMA (mma.sync, bf16 in, f32 accumulate); K2's bf16 rows
// (flash_fwd.cu) run on wgmma with the softmax in registers, and
// chip_smoke.py times both kernels on the bias-free rows. One block is 4 warps of 16 query rows; a warp keeps its
// q fragments and its f32 accumulator fragments in registers, writes its
// 16 x 64 scores to shared memory, where two lanes per row do the softmax
// step, and multiplies the bf16 probabilities with the v tile into the
// accumulator. WMMA does not say which lane holds which element, so the
// accumulator is scaled by a row's alpha through a 16 x 16 tile whose every
// column is alpha, loaded as an accumulator fragment and multiplied element
// by element: two fragments of one type share one layout. The score rows
// are 68 words apart (WMMA wants a multiple of 4), so rows r and r + 8 start
// in one bank: a lane takes, of every four columns, the two that `lane_col`
// gives it, and the 32 lanes of a step hit 32 banks. The K and V tiles are
// loaded by all four warps with 16-byte loads; nothing is pipelined here.
// f32 rows keep K2's SIMT kernel (the tensor cores have no exact f32 product).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int QB = 64;  // queries per block: 4 warps x 16 rows
constexpr int KB = 64;  // keys per chunk
constexpr int NT = 128;
constexpr float MASKED = -1e9f;

template <int DH>
struct Layout {  // strides in elements; every array starts 32-byte aligned
  static constexpr int LD = DH + 8;   // bf16 rows of q, k, v
  static constexpr int PLD = KB + 8;  // bf16 rows of p
  static constexpr int SLD = KB + 4;  // f32 rows of s
  static constexpr int OLD = DH + 4;  // f32 rows of the output staging
  static constexpr int ALD = 16;      // f32 rows of a warp's alpha tile
  static constexpr int k_off = 0;     // the K and V tiles; at the end the f32 output staging
  static constexpr int v_off = k_off + KB * LD * 2;
  static constexpr int p_off = v_off + KB * LD * 2;  // p; before the loop the q tile
  static constexpr int p_bytes = QB * (LD > PLD ? LD : PLD) * 2;
  static constexpr int s_off = p_off + p_bytes;
  static constexpr int a_off = s_off + QB * SLD * 4;
  static constexpr int flag_off = a_off + QB * ALD * 4;
  static constexpr int bytes = flag_off + KB * 4;
  static_assert(QB * OLD * 4 <= 2 * KB * LD * 2, "the output staging must fit over the K and V tiles");
};

// The column a lane visits at step c of a row it shares with its neighbour
// lane: rows are 4 words apart modulo the 32 banks, so the four lanes whose
// rows start in one bank (two rows, two lanes each) take the four residues
// modulo 4, and swap pairs on odd steps; over 2n steps a lane covers half of
// 4n columns, its neighbour the other half.
__device__ __forceinline__ int lane_col(int c, int base) { return 4 * (c >> 1) + ((base + 2 * (c & 1)) & 3); }

// rows [r0, r0 + 64) of a (B, T, heads, dh) operand -> a bf16 tile, zeros past T
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long long st,
                                          int r0, int T) {
  constexpr int LD = Layout<DH>::LD;
  for (int i = threadIdx.x; i < 64 * (DH / 8); i += NT) {
    const int row = i / (DH / 8), ch = i % (DH / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + row < T) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + row) * st + ch * 8);
    *reinterpret_cast<uint4*>(dst + row * LD + ch * 8) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(NT, DH <= 64 ? 4 : 2) qtiled_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int H, int T, long long q_sb, long long q_st, long long k_sb,
    long long k_st, long long v_sb, long long v_st) {
  using L = Layout<DH>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* As = reinterpret_cast<float*>(smem + L::a_off);
  int* flag = reinterpret_cast<int*>(smem + L::flag_off);  // per key of the chunk: 1 valid, 0 masked, -1 past T

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1);  // this lane's query row in the tile
  const int base = 2 * ((lane >> 4) & 1) + (lane & 1);  // see lane_col
  float* arow = As + row * L::ALD + (lane & 1) * 8;  // this lane's half of its row of the alpha tile

  // every column of a row of the warp's alpha tile = x, as an accumulator fragment
  auto row_factors = [&](float x, Acc& f) {
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) arow[c] = x;
    __syncwarp();
    wmma::load_matrix_sync(f, As + warp * 16 * L::ALD, L::ALD, wmma::mem_row_major);
  };

  load_tile<DH>(Ps, q + b * q_sb + (long long)h * DH, q_st, q0, T);  // the q tile, where p will live
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wmma::load_matrix_sync(fq[kk], Ps + warp * 16 * L::LD + kk * 16, L::LD);
  Acc fo[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(fo[j], 0.f);

  float m = -1e30f, l = 0.f;
  const __nv_bfloat16* kb = k + b * k_sb + (long long)h * DH;
  const __nv_bfloat16* vb = v + b * v_sb + (long long)h * DH;
  const uint8_t* mb = mask + (long long)b * T;

  for (int k0 = 0; k0 < T; k0 += KB) {
    __syncthreads();  // every warp is done with the previous K and V tiles (and, at first, with the q tile)
    load_tile<DH>(Ks, kb, k_st, k0, T);
    load_tile<DH>(Vs, vb, v_st, k0, T);
    if (threadIdx.x < KB) flag[threadIdx.x] = k0 + threadIdx.x < T ? (mb[k0 + threadIdx.x] != 0 ? 1 : 0) : -1;
    __syncthreads();

    // s = q k^T for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < KB / 16; ++j) {
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, Ks + j * 16 * L::LD + kk * 16, L::LD);  // k rows are s columns
        wmma::mma_sync(acc, fq[kk], fk, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * L::SLD + j * 16, acc, L::SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // the online softmax step: two lanes per row, 32 columns each
    const float* srow = Ss + row * L::SLD;
    float tmax = -3.402823466e38f;
#pragma unroll
    for (int c = 0; c < KB / 2; ++c) {
      const int col = lane_col(c, base);
      if (flag[col] >= 0) tmax = fmaxf(tmax, flag[col] > 0 ? srow[col] : MASKED);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = __expf(m - m_new);
    float psum = 0.f;
    __nv_bfloat16* prow = Ps + row * L::PLD;
#pragma unroll
    for (int c = 0; c < KB / 2; ++c) {
      const int col = lane_col(c, base);
      // the fast exponential: p is rounded to bf16 next, and its f32 sum needs no more than 2 ulp
      const float p = flag[col] >= 0 ? __expf((flag[col] > 0 ? srow[col] : MASKED) - m_new) : 0.f;
      psum += p;
      prow[col] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;

    // acc = acc alpha + p v for this warp's 16 rows
    Acc fa;
    row_factors(alpha, fa);  // its __syncwarp also publishes the row's p
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
#pragma unroll
      for (int i = 0; i < fo[j].num_elements; ++i) fo[j].x[i] *= fa.x[i];
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, Ps + warp * 16 * L::PLD + kk * 16, L::PLD);
        wmma::load_matrix_sync(fv, Vs + kk * 16 * L::LD + j * 16, L::LD);
        wmma::mma_sync(fo[j], fp, fv, fo[j]);
      }
    }
  }

  // out = cast(acc / max(l, 1e-30)), staged through shared memory over the K and V tiles
  Acc fa;
  row_factors(1.f / fmaxf(l, 1e-30f), fa);
  __syncthreads();  // every warp is done with the last K and V tiles
  float* Os = reinterpret_cast<float*>(smem + L::k_off);
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
#pragma unroll
    for (int i = 0; i < fo[j].num_elements; ++i) fo[j].x[i] *= fa.x[i];
    wmma::store_matrix_sync(Os + warp * 16 * L::OLD + j * 16, fo[j], L::OLD, wmma::mem_row_major);
  }
  __syncwarp();
  if (q0 + row < T) {
    const float* orow = Os + row * L::OLD;
    __nv_bfloat16* dst = out + (((long long)b * T + q0 + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < DH / 2; ++c) dst[lane_col(c, base)] = __float2bfloat16(orow[lane_col(c, base)]);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H,
                   int T, long long q_sb, long long q_st, long long k_sb, long long k_st, long long v_sb,
                   long long v_st, cudaStream_t s) {
  auto kern = qtiled_attention_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<DH>::bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3((T + QB - 1) / QB, H, B), NT, Layout<DH>::bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), H, T, q_sb, q_st, k_sb, k_st, v_sb, v_st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, T, H, dh) bf16 given by their batch and token strides in
// elements (heads and dh contiguous, 16-byte aligned rows); mask (B, T) uint8;
// out (B, T, H, dh) bf16 contiguous; dh 16, 32, 64 or 128.
extern "C" int t5_qtiled_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                                   int B, int H, int T, int dh, long long q_sb, long long q_st,
                                   long long k_sb, long long k_st, long long v_sb, long long v_st,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, mask, out, B, H, T, q_sb, q_st, k_sb, k_st, v_sb, v_st, s
  if (dh == 16) return (int)launch<16>(ARGS);
  if (dh == 32) return (int)launch<32>(ARGS);
  if (dh == 64) return (int)launch<64>(ARGS);
  if (dh == 128) return (int)launch<128>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
