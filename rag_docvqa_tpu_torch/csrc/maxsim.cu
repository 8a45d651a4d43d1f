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
// reaches device memory: one block per (patch set, batch row, 64 query
// tokens) walks its (64, Tp) strip in 64 x 64 tiles, keeps each query token's
// running maximum in registers and reduces the masked maxima to one number;
// with more than 64 query tokens a second kernel adds the strips' numbers.
//
// What bounds it on the H100: arithmetic. A patch set is 2*Tq*Tp*D FLOPs
// (25 MFLOP at Tq = Tp = 128, D = 768) against Tp*D*4 bytes (0.4 MB) of its
// own, 64 FLOP/byte in f32 against a ridge of 20, and the products must stay
// f32: the engine ranks chunks by differences of 1e-3 in these sums. The tile
// loop is the SIMT GEMM's (gemm_fwd.cuh), 4 x 4 outputs per thread. Cutting
// the query tokens over the grid doubles the blocks at Tq 128 (256 blocks of
// 8 warps for B 8 x 16 sets: two a SM, where one leaves the SM waiting on
// its loads). The per-token maxima and the strips are summed in a fixed
// order, so a score does not depend on timing.
#include "common.cuh"

namespace {

constexpr int TM = 64, TN = 64, TK = 16;
constexpr float MASKED = -1e30f;

__global__ void __launch_bounds__(256) maxsim_kernel(
    const float* __restrict__ q, const float* __restrict__ p, const float* __restrict__ qw,
    const uint8_t* __restrict__ pmask, float* __restrict__ out, int N, int Tq, int Tp, int D) {
  __shared__ float Qs[TK][TM + 4];
  __shared__ float Ps[TK][TN + 4];
  __shared__ float terms[TM];
  const int n = blockIdx.x, b = blockIdx.y, m0 = blockIdx.z * TM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qb = q + (long long)b * Tq * D;
  const float* pb = p + ((long long)b * N + n) * Tp * D;
  const float* wb = qw != nullptr ? qw + (long long)b * Tq : nullptr;
  const uint8_t* mb = pmask != nullptr ? pmask + ((long long)b * N + n) * Tp : nullptr;
  float best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) best[i] = MASKED;
  for (int n0 = 0; n0 < Tp; n0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += TK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * 256, row = e / TK, c = e % TK, gk = k0 + c;
        Qs[c][row] = (m0 + row < Tq && gk < D) ? qb[(long long)(m0 + row) * D + gk] : 0.f;
        Ps[c][row] = (n0 + row < Tp && gk < D) ? pb[(long long)(n0 + row) * D + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Ps[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * w[j];
      }
      __syncthreads();
    }
    // this tile's masked maxima per query row
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gp = n0 + tx * 4 + j;
      const bool ok = gp < Tp && (mb == nullptr || mb[gp] != 0);
#pragma unroll
      for (int i = 0; i < 4; ++i) best[i] = fmaxf(best[i], ok ? acc[i][j] : MASKED);
    }
  }
  // a query row's 16 threads (tx) are 16 neighbouring lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = best[i];
    for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int gq = m0 + ty * 4 + i;
    if (tx == 0) {
      const float w = gq < Tq ? (wb != nullptr ? wb[gq] : 1.f) : 0.f;
      terms[ty * 4 + i] = (gq < Tq && v > -1e29f) ? v * w : 0.f;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < TM; ++i) total += terms[i];
    out[((long long)b * N + n) * gridDim.z + blockIdx.z] = total;
  }
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

// q (B, Tq, D) and p (B, N, Tp, D) f32 contiguous, rows already normalised;
// qw (B, Tq) f32 weights of the query tokens (its mask) or null for ones;
// pmask (B, N, Tp) uint8 or null for all valid; out (B, N) f32; part
// (B, N, ceil(Tq / 64)) f32 scratch, unused (may be null) when Tq <= 64.
extern "C" int maxsim(const void* q, const void* p, const void* qw, const void* pmask, void* out,
                      void* part, int B, int N, int Tq, int Tp, int D, void* stream) {
  const int Z = (Tq + TM - 1) / TM;
  if (B <= 0 || N <= 0 || Tq <= 0 || B > 65535 || Z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  maxsim_kernel<<<dim3(N, B, Z), 256, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), static_cast<const float*>(qw),
      static_cast<const uint8_t*>(pmask), static_cast<float*>(Z == 1 ? out : part), N, Tq, Tp, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || Z == 1) return (int)err;
  strip_sum_kernel<<<(B * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                      static_cast<float*>(out), B * N, Z);
  return (int)cudaGetLastError();
}
