// K3: single-query cross-attention over a packed decode cache, for one
// greedy-decode step: qs = f32(q) * k_scale, s = qs . K with -1e9 on masked
// keys, p = softmax(s), out = cast((p . V) * v_scale), all math in f32.
//
// Replaces the TPU kernel `_kernel` of rag_docvqa_tpu/ops/decode_attention.py
// (called from `fused_cross_attention`) in its `exact=True` mode. The layouts
// are `pack_decode_kv`'s: K2 (B, H*dk, Te) and V2 (B, Te, H*dk), stored int8,
// bf16 or f32. Where JAX folds the channel scales outside its kernel (the
// k-scale into the query, the v-scale into the output) and casts after it,
// this kernel does all three itself: a layer's cross-attention is one launch,
// or two when the cache is split, and no element-wise launch around them.
//
// What bounds it on the H100: memory. Each step reads the whole cross cache,
// 2*B*H*dk*Te elements per layer (t5-base B 32, Te 512: 50 MB in bf16, 25 MB
// in int8), for 4 operations per cached element pair, far below the ridge
// point of the tensor cores (bound: bytes over 3.35 TB/s, 0.0076 ms for that
// int8 cache); so it stays on SIMT FMA in f32 and spends its design on
// having the whole cache in flight at once:
//
// - Split over the cache (flash-decoding). Block (split, h, b) takes S keys,
//   128, 256 or 512 bytes of each K2 row (the wrapper picks S so that
//   B*H*splits fills the card: 512 bytes at B 32 Te 512 int8, one split),
//   and writes its max m_s, its sum l_s and its unnormalised o_s = sum
//   exp(s - m_s) v. `combine_kernel` merges the splits of each (b, h) in split
//   order: m = max m_s, l = sum l_s e^(m_s - m), o = sum o_s e^(m_s - m) / l.
//   No float atomics, so a launch repeats bit for bit. With one split the
//   block normalises and writes the output itself.
// - The cache in flight through 16-byte cp.async copies into shared memory,
//   no registers held: a block issues its whole K segment (dk rows of S
//   keys), and its S rows of V (the head's dk channels) once K has landed, so
//   the scores are taken while V is in flight (issued together, V shared the
//   memory queues with K and held every block's scores back to the end). A
//   score thread owns 16 bytes of keys (16 int8, 8 bf16, 4 f32) and walks its
//   share of the dk rows with the query broadcast from shared memory; a p@V
//   thread owns 16 bytes of a head's channels and walks its share of the
//   keys. Values widen to f32 in registers (int8 through a byte permute, not
//   the quarter-rate I2F).
// - Any alignment. Row d of K2 starts at element d*Te and a head's slice of a
//   V2 row at h*dk: for Te 709 or 77, or dk 40 in int8, those starts are not
//   16-byte aligned. The launch then takes the kernel's unaligned form: it
//   copies the 16-byte chunks from the boundary below each start (one more a
//   row), reads two and funnel-shifts them into place; a chunk that would
//   leave the tensor is copied byte by byte. Padded keys past Te score -inf,
//   so a row with no valid key averages its Te keys uniformly, as softmax
//   under -1e9 does.
// - Shared memory is set by S and dk (66 KB at 512 bytes and dk 64, three
//   blocks an SM; 144 KB at most): its limit is raised once per
//   instantiation, not per launch.
#include "hopper.cuh"

namespace {

constexpr int NT = 128;  // threads a block
constexpr float MASKED = -1e9f;

// The 16 bytes at p + shift of a shared-memory segment (p 16-byte aligned),
// widened to 16 / sizeof(T) f32 values: one 16-byte read, or two and a
// funnel shift where the global row the segment was copied from did not start
// on a 16-byte boundary.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void read16(const unsigned char* p, int shift, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  if (ALIGNED || shift == 0) {
    unpack16<T>(a, out);
    return;
  }
  const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
  uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  if (shift & 8) {
#pragma unroll
    for (int i = 0; i < 6; ++i) w[i] = w[i + 2];
  }
  if (shift & 4) {
#pragma unroll
    for (int i = 0; i < 5; ++i) w[i] = w[i + 1];
  }
  const int r = (shift & 3) * 8;
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(w[i], w[i + 1], r);
  unpack16(v, out, T());
}

// 16 bytes of global memory from the 16-byte boundary `src` into shared
// memory: a cp.async where they lie inside [lo, hi), else byte by byte, zero
// outside it (the first and last chunks of a tensor whose rows are not aligned)
__device__ __forceinline__ void copy16(unsigned char* dst, uintptr_t src, uintptr_t lo, uintptr_t hi) {
  if (src >= lo && src + 16 <= hi) {
    cp_async16(smem_u32(dst), reinterpret_cast<const void*>(src), true);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dst[i] = src + i >= lo && src + i < hi ? *reinterpret_cast<const unsigned char*>(src + i) : 0;
  }
}

__device__ __forceinline__ float load_f(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, long long i, float v, bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<float*>(p)[i] = v;
}

// Shared memory of a block: the K tile (dk rows of KROW bytes; reused for the
// partial sums once the scores are taken), the V tile (S keys of VROW bytes),
// then the scores (by key; then the second-level partial outputs), the query
// and the reduction scratch.
template <typename T, int S, bool ALIGNED>
struct Smem {
  static constexpr int IT = sizeof(T), PAD = ALIGNED ? 0 : 16;
  static constexpr int KROW = S * IT + PAD;
  __host__ __device__ static int vrow(int dk) { return (dk * IT + 15) / 16 * 16 + PAD; }
  __host__ __device__ static int region0(int dk) {
    const int part = NT * (16 / IT) * 4;  // G * S partial scores, then KG * dk partial outputs
    return dk * KROW > part ? dk * KROW : part;
  }
  static constexpr int SC = S > NT ? S : NT;  // scores, then the second-level partial outputs
  __host__ __device__ static int bytes(int dk) { return region0(dk) + S * vrow(dk) + (SC + 128 + 32) * 4; }
};

// Block (split, h, b) over keys t0 .. t0 + S of one (b, h). The score
// threads leave key (idx % TR) * VW + idx / TR in slot idx of `part`, so the
// reduction over their groups walks consecutive slots.
template <typename T, int S, bool ALIGNED>
__global__ void __launch_bounds__(NT) decode_attn_split_kernel(
    const void* __restrict__ q, const float* __restrict__ k_scale, const T* __restrict__ k2,
    const T* __restrict__ v2, const uint8_t* __restrict__ mask, const float* __restrict__ v_scale,
    void* __restrict__ out, float* __restrict__ ws_o, float* __restrict__ ws_ml, int H, int dk, int Te,
    long long kv_elems, bool q_bf16, bool out_bf16) {
  using Sm = Smem<T, S, ALIGNED>;
  constexpr int IT = sizeof(T), VW = 16 / IT;
  constexpr int TR = S / VW;   // score threads across one K2 row's S keys
  constexpr int G = NT / TR;   // score thread groups over the dk rows
  constexpr int KPT = (S + NT - 1) / NT;
  constexpr int KCH = Sm::KROW / 16;  // 16-byte chunks of a K2 row segment
  extern __shared__ __align__(16) unsigned char smem[];
  const int VROW = Sm::vrow(dk), VCH = VROW / 16;
  unsigned char* ktile = smem;
  unsigned char* vtile = smem + Sm::region0(dk);
  float* sc = reinterpret_cast<float*>(vtile + S * VROW);  // scores, then exp(s - m_s), by key
  float* qs = sc + Sm::SC;
  float* scratch = qs + 128;
  float* part = reinterpret_cast<float*>(ktile);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ns = gridDim.x, hd = H * dk, t0 = split * S;
  const int n_keys = min(S, Te - t0);
  const long long bh = (long long)b * H + h;
  const uintptr_t k_lo = reinterpret_cast<uintptr_t>(k2), k_hi = reinterpret_cast<uintptr_t>(k2 + kv_elems);
  const uintptr_t v_lo = reinterpret_cast<uintptr_t>(v2), v_hi = reinterpret_cast<uintptr_t>(v2 + kv_elems);
  auto key_of = [](int idx) { return (idx % TR) * VW + idx / TR; };
  auto k_addr = [&](int d) { return reinterpret_cast<uintptr_t>(k2 + (bh * dk + d) * Te + t0); };
  auto v_addr = [&](int j) {
    return reinterpret_cast<uintptr_t>(v2 + ((long long)b * Te + t0 + j) * hd + (long long)h * dk);
  };

  // ---- the K segments in flight; the V rows once they have landed (below)
  if constexpr (ALIGNED) {  // whole chunks inside their rows: no bounds to check; KCH divides NT
    const int j = tid % KCH;
    if (16 * j < n_keys * IT) {  // holds a key of the split
      const unsigned char* src = reinterpret_cast<const unsigned char*>(k_addr(tid / KCH)) + 16 * j;
      for (int d = tid / KCH; d < dk; d += NT / KCH, src += (long long)(NT / KCH) * Te * IT)
        cp_async16(smem_u32(ktile + d * Sm::KROW + 16 * j), src, true);
    }
  } else {
    for (int i = tid; i < dk * KCH; i += NT) {
      const int d = i / KCH, j = i % KCH;
      const uintptr_t a = k_addr(d);
      if (16 * j < static_cast<int>(a & 15) + n_keys * IT)  // holds a key of the split
        copy16(ktile + d * Sm::KROW + 16 * j, (a & ~uintptr_t(15)) + 16 * j, k_lo, k_hi);
    }
  }
  cp_async_commit();
  if (tid < dk) qs[tid] = load_f(q, bh * dk + tid, q_bf16) * (k_scale ? k_scale[bh * dk + tid] : 1.f);
  const uint8_t* mrow = mask + (long long)b * Te + t0;
  bool valid[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int idx = tid + k * NT;
    valid[k] = idx < S && key_of(idx) < n_keys && mrow[key_of(idx)];
  }
  cp_async_wait<0>();
  __syncthreads();
  // V in flight while the scores are taken
  if (ALIGNED && NT % VCH == 0) {
    const int c = tid % VCH;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(v_addr(tid / VCH)) + 16 * c;
    for (int j = tid / VCH; j < n_keys; j += NT / VCH, src += (long long)(NT / VCH) * hd * IT)
      cp_async16(smem_u32(vtile + j * VROW + 16 * c), src, true);
  } else {
    for (int i = tid; i < n_keys * VCH; i += NT) {
      const int j = i / VCH, c = i % VCH;
      copy16(vtile + j * VROW + 16 * c, (v_addr(j) & ~uintptr_t(15)) + 16 * c, v_lo, v_hi);
    }
  }
  cp_async_commit();

  // ---- scores: thread (g, tr) owns keys tr*VW .. +VW and rows d = g, g + G, ...
  {
    const int g = tid / TR, tr = tid % TR;
    float acc[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[i] = 0.f;
    if (tr * VW < n_keys) {
      for (int d = g; d < dk; d += G) {
        float kv[VW];
        read16<T, ALIGNED>(ktile + d * Sm::KROW + 16 * tr, ALIGNED ? 0 : static_cast<int>(k_addr(d) & 15), kv);
        const float qv = qs[d];
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = fmaf(qv, kv[i], acc[i]);
      }
    }
    __syncthreads();  // the K tile becomes `part`
#pragma unroll
    for (int i = 0; i < VW; ++i) part[g * S + i * TR + tr] = acc[i];
  }
  __syncthreads();

  float lmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int idx = tid + k * NT;
    if (idx < S) {
      float s = 0.f;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) s += part[gg * S + idx];
      s = key_of(idx) >= n_keys ? -INFINITY : (valid[k] ? s : MASKED);  // keys past Te take no share
      sc[key_of(idx)] = s;
      lmax = fmaxf(lmax, s);
    }
  }
  const float m = block_reduce<true>(lmax, scratch);
  float lsum = 0.f;
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int idx = tid + k * NT;
    if (idx < S) {
      const float e = expf(sc[key_of(idx)] - m);
      sc[key_of(idx)] = e;
      lsum += e;
    }
  }
  cp_async_wait<0>();
  const float l = block_reduce<false>(lsum, scratch);  // its barriers publish sc and the V tile, and free part

  // ---- p@V: thread (kg, c) owns channels c*VW .. +VW and slots kg, kg + KG, ...
  const int NC = (dk + VW - 1) / VW, KG = NT / NC;
  const int kg = tid / NC, c = tid % NC;
  if (kg < KG) {
    float o[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) o[i] = 0.f;
    for (int j = kg; j < n_keys; j += KG) {
      float vv[VW];
      read16<T, ALIGNED>(vtile + j * VROW + 16 * c, ALIGNED ? 0 : static_cast<int>(v_addr(j) & 15), vv);
      const float p = sc[j];
#pragma unroll
      for (int i = 0; i < VW; ++i) o[i] = fmaf(p, vv[i], o[i]);
    }
#pragma unroll
    for (int i = 0; i < VW; ++i)
      if (c * VW + i < dk) part[kg * dk + c * VW + i] = o[i];
  }
  __syncthreads();
  // the KG partial outputs of each channel, summed in a fixed order by R threads, then by one
  const int R = NT / dk;
  float* part2 = sc;  // free again: R * dk <= NT floats
  if (tid < R * dk) {
    float acc = 0.f;
    for (int gg = tid / dk; gg < KG; gg += R) acc += part[gg * dk + tid % dk];
    part2[tid] = acc;
  }
  __syncthreads();
  if (tid < dk) {
    float acc = 0.f;
    for (int r = 0; r < R; ++r) acc += part2[r * dk + tid];
    if (ns == 1) {
      const float vs = v_scale ? v_scale[bh * dk + tid] : 1.f;
      store_f(out, bh * dk + tid, acc / l * vs, out_bf16);
    } else {
      ws_o[(bh * ns + split) * dk + tid] = acc;
      if (tid == 0) {
        ws_ml[(bh * ns + split) * 2] = m;
        ws_ml[(bh * ns + split) * 2 + 1] = l;
      }
    }
  }
}

// one block per (b, h): merges its splits in split order
__global__ void __launch_bounds__(NT) combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                                                     const float* __restrict__ v_scale, void* __restrict__ out,
                                                     int ns, int dk, bool out_bf16) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= dk) return;
  const float* ml = ws_ml + bh * ns * 2;
  float m = -INFINITY;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float e = expf(ml[2 * s] - m);
    l += ml[2 * s + 1] * e;
    o += ws_o[(bh * ns + s) * dk + d] * e;
  }
  const float vs = v_scale ? v_scale[bh * dk + d] : 1.f;
  store_f(out, bh * dk + d, o / l * vs, out_bf16);
}

template <typename T, int S, bool ALIGNED>
cudaError_t launch_split_kernel(dim3 grid, const void* q, const float* ks, const void* k2, const void* v2,
                                const uint8_t* mask, const float* vs, void* out, float* ws_o, float* ws_ml, int H,
                                int dk, int Te, bool q_bf16, bool out_bf16, cudaStream_t stream) {
  auto kern = decode_attn_split_kernel<T, S, ALIGNED>;
  static cudaError_t raised = cudaFuncSetAttribute(  // once per instantiation: enough for dk 128
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T, S, ALIGNED>::bytes(128));
  if (raised != cudaSuccess) return raised;
  kern<<<grid, NT, Smem<T, S, ALIGNED>::bytes(dk), stream>>>(
      q, ks, static_cast<const T*>(k2), static_cast<const T*>(v2), mask, vs, out, ws_o, ws_ml, H, dk, Te,
      (long long)grid.z * H * dk * Te, q_bf16, out_bf16);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch(const void* q, const float* ks, const void* k2, const void* v2, const uint8_t* mask,
                   const float* vs, void* out, float* ws, int B, int H, int dk, int Te, bool q_bf16,
                   bool out_bf16, cudaStream_t stream) {
  const int ns = (Te + S - 1) / S;
  float* ws_o = ws;
  float* ws_ml = ws + (long long)B * H * ns * dk;
  const size_t it = sizeof(T);
  // every K2 row and every head's slice of a V2 row starts on a 16-byte boundary and holds whole vectors
  const bool aligned = ((reinterpret_cast<uintptr_t>(k2) | reinterpret_cast<uintptr_t>(v2)) & 15) == 0 &&
                       (Te * it) % 16 == 0 && (dk * it) % 16 == 0;
  const dim3 grid(ns, H, B);
  cudaError_t err = aligned ? launch_split_kernel<T, S, true>(grid, q, ks, k2, v2, mask, vs, out, ws_o, ws_ml, H, dk,
                                                              Te, q_bf16, out_bf16, stream)
                            : launch_split_kernel<T, S, false>(grid, q, ks, k2, v2, mask, vs, out, ws_o, ws_ml, H,
                                                               dk, Te, q_bf16, out_bf16, stream);
  if (err != cudaSuccess) return err;
  if (ns > 1) combine_kernel<<<B * H, NT, 0, stream>>>(ws_o, ws_ml, vs, out, ns, dk, out_bf16);
  return cudaGetLastError();
}

// split_len keys a block: 128, 256 or 512 bytes of each K2 row
template <typename T>
cudaError_t launch_split(int split_len, const void* q, const float* ks, const void* k2, const void* v2,
                         const uint8_t* mask, const float* vs, void* out, float* ws, int B, int H, int dk, int Te,
                         bool q_bf16, bool out_bf16, cudaStream_t s) {
  constexpr int k128 = 128 / sizeof(T);
  if (split_len == k128) return launch<T, k128>(q, ks, k2, v2, mask, vs, out, ws, B, H, dk, Te, q_bf16, out_bf16, s);
  if (split_len == 2 * k128)
    return launch<T, 2 * k128>(q, ks, k2, v2, mask, vs, out, ws, B, H, dk, Te, q_bf16, out_bf16, s);
  if (split_len == 4 * k128)
    return launch<T, 4 * k128>(q, ks, k2, v2, mask, vs, out, ws, B, H, dk, Te, q_bf16, out_bf16, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, dk) in `q_dtype` (f32 or bf16); k_scale, v_scale (B, H, dk) f32 or
// null; k2 (B, H*dk, Te), v2 (B, Te, H*dk) in `kv_dtype`; mask (B, Te) uint8;
// out (B, H*dk) in `out_dtype` (f32 or bf16); ws f32 scratch of
// B*H*splits*(dk + 2) values, splits = ceil(Te / split_len) (unused, may be
// null, with one split); split_len keys a block, 128 or 256 bytes of a K2 row
// (int8 128 or 256, bf16 64 or 128, f32 32 or 64).
extern "C" int decode_cross_attention(const void* q, const void* k_scale, const void* k2, const void* v2,
                                      const void* mask, const void* v_scale, void* out, void* ws, int B, int H,
                                      int dk, int Te, int kv_dtype, int q_dtype, int out_dtype, int split_len,
                                      void* stream) {
  if (dk <= 0 || dk > 128 || Te <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((q_dtype != DT_F32 && q_dtype != DT_BF16) || (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  if (Te > split_len && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* w = static_cast<float*>(ws);
  const bool qb = q_dtype == DT_BF16, ob = out_dtype == DT_BF16;
  if (kv_dtype == DT_F32) return (int)launch_split<float>(split_len, q, ks, k2, v2, m, vs, out, w, B, H, dk, Te, qb, ob, s);
  if (kv_dtype == DT_BF16)
    return (int)launch_split<__nv_bfloat16>(split_len, q, ks, k2, v2, m, vs, out, w, B, H, dk, Te, qb, ob, s);
  if (kv_dtype == DT_I8) return (int)launch_split<int8_t>(split_len, q, ks, k2, v2, m, vs, out, w, B, H, dk, Te, qb, ob, s);
  return (int)cudaErrorInvalidValue;
}
