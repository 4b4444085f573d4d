// Paged decode and paged verify attention for Hopper (sm_90a), over plain
// or quantized KV pools, with an optional fp8 QK^T.
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/decode_attention/kernel.py
//     paged_decode_attention_fwd          (:424, pallas_call :468)
//     paged_verify_attention_fwd          (:275, pallas_call :317)
//     paged_decode_attention_dequant_fwd  (:376, pallas_call :416)
//     paged_verify_attention_dequant_fwd  (:325, pallas_call :367)
//   and, inside the first two, src/repro/kernels/common.py:31 qk_dot_fp8
//   (their fp8=True variants).
//
// Every variant reads a shared pool of fixed-size KV blocks, k_pool/v_pool
// (NB, bs, KV, D), through a per-slot block table (S, MB) int32 (-1 =
// unmapped).  Logical position i of slot s lives at offset i % bs of
// physical block table[s, i / bs], so validity is positional: a key at
// position p is attended by a query at position qp iff the block is
// mapped, p <= qp and, with a window w > 0, qp - p < w.  Decode has one
// query token per slot, verify T.
//
// Pools.  The pool's element type is a template parameter of its own,
// apart from q's (f32 or bf16): f32, bf16, or a quantized 1-byte payload
// (int8, __nv_fp8_e4m3, __nv_fp8_e5m2) with (NB, bs, KV) f32 per-token-
// per-head scales.  A quantized row is dequantized on load (payload times
// its (token, head) scale, in f32).  Every loaded value is then rounded
// through q's type, as the JAX package casts its pool to q's dtype before
// attending, and staged in shared memory as f32; the rest of the kernel
// does not know which pool it read.
//
// fp8 QK^T (FP8_QK, plain pools only, as in the reference: a quantized
// pool keeps the f32 contraction).  qk_dot_fp8's numerics with the
// narrow_dot=False contraction the reference's interpreter runs: once per
// CTA each Q row is quantized over D to e4m3 with its own amax scale
// (scale = max(amax, 1e-12) / 448, clip to +-448, then a round-to-nearest-
// even cast), and per K tile each key row the same way; the score is the
// f32 dot of the upcast codes times q_scale times k_scale times 1/sqrt(D).
// The codes are staged as f32 (no tensor cores: wgmma e4m3 is later speed
// work).
//
// What bounds it: bytes.  Each live key and value row is read once and
// used for G (decode) or T*G (verify) dot products of length D; at T*G <=
// a few tens of rows that is far below the card's ratio of operations to
// bytes, so the least time is the live K/V bytes (payload plus scales)
// over 3.35 TB/s.  A 1-byte pool moves about a quarter of an f32 pool's
// bytes.
//
// Design: one CTA per (slot, KV head).  The TPU kernel's sequential grid
// axis over blocks, which carried (m, l, acc) in VMEM, becomes a loop
// inside the CTA over the slot's logical blocks; blocks run from the
// first one the window can reach to the one holding the slot's last
// query position, so blocks past the query (and unmapped ones) are never
// loaded.  Per block the CTA stages the K and V tile in shared memory
// (threads on consecutive head-dim elements: coalesced loads, a 1-byte
// row of D = 128 is 128 consecutive bytes, and no bank conflicts), then
// one warp per (query row, key) computes a dot product with shuffles, one
// warp per row folds the tile into the running f32 max / sum (online
// softmax), and one thread per (row, d) rescales and accumulates P.V.  All
// T*G query rows of a slot share each tile loaded once.  Masked lanes
// contribute exactly zero (not exp(0) as with the finite -1e30 of the TPU
// kernel), so a row with no attendable key comes out as zeros; those rows
// (inactive slots, padding tokens) are garbage the caller ignores in both
// implementations.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// q_dtype 0 = float32, 1 = bfloat16 (q and the output); pool_dtype 0 =
// float32, 1 = bfloat16, 2 = int8, 3 = fp8_e4m3, 4 = fp8_e5m2; k_scale /
// v_scale are null for plain pools and required for quantized ones; fp8 =
// 1 asks for the fp8 QK^T (plain pools only).  Each entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;
constexpr float kFp8Max = 448.f;       // float8_e4m3fn saturation
constexpr float kScaleEps = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A quantized payload carries per-(token, head) scales.
template <typename T> struct Quantized : std::false_type {};
template <> struct Quantized<int8_t> : std::true_type {};
template <> struct Quantized<__nv_fp8_e4m3> : std::true_type {};
template <> struct Quantized<__nv_fp8_e5m2> : std::true_type {};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory floats for R query rows, head dim D, block size bs.
__host__ __device__ inline size_t smem_floats(int R, int D, int bs) {
  return 2 * static_cast<size_t>(R) * D      // q rows, accumulators
         + 2 * static_cast<size_t>(bs) * D   // K tile, V tile
         + static_cast<size_t>(R) * bs       // scores / probabilities
         + 3 * static_cast<size_t>(R)        // m, l, alpha
         + static_cast<size_t>(R) + bs;      // fp8 row scales of q, K
}

// Replace each of the n rows (length D) of x by the f32 values of its
// fp8_e4m3 codes under the row's own amax scale, written to sc[row]: one
// warp per row.  qk_dot_fp8's order: scale, true division, clip, RNE cast.
__device__ void fp8_rows(float* x, int n, int D, float* sc, int warp,
                         int lane) {
  for (int r = warp; r < n; r += kWarps) {
    float* row = x + static_cast<size_t>(r) * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(row[d]));
    const float s = fmaxf(warp_max(amax), kScaleEps) / kFp8Max;
    for (int d = lane; d < D; d += 32) {
      const float y = fminf(fmaxf(row[d] / s, -kFp8Max), kFp8Max);
      row[d] = static_cast<float>(__nv_fp8_e4m3(y));
    }
    if (lane == 0) sc[r] = s;
  }
}

// One CTA: slot s, KV head h, query rows r = t*G + g for t < T.  Query
// token t sits at position start + t and is live iff start >= 0 and
// t < n_tok.  q/out rows are at (((s*T + t)*KV + h)*G + g)*D.
template <typename TQ, typename TP, bool FP8_QK>
__device__ void paged_attention_cta(const TQ* __restrict__ q,
                                    const TP* __restrict__ k_pool,
                                    const TP* __restrict__ v_pool,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale,
                                    const int* __restrict__ table,
                                    TQ* __restrict__ out, int s, int h,
                                    int start, int n_tok, int Tq, int KV,
                                    int G, int D, int NB, int bs, int MB,
                                    int window, float scale) {
  extern __shared__ float smem[];
  const int R = Tq * G;
  float* qs = smem;
  float* acc = qs + R * D;
  float* ks = acc + R * D;
  float* vs = ks + bs * D;
  float* ps = vs + bs * D;
  float* m = ps + R * bs;
  float* l = m + R;
  float* alpha = l + R;
  float* q_sc = alpha + R;
  float* k_sc = q_sc + R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int t = r / G, g = r - t * G;
    qs[i] = to_f32(q[((((size_t)s * Tq + t) * KV + h) * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = -1e30f;
    l[r] = 0.f;
  }
  __syncthreads();
  if constexpr (FP8_QK) {
    fp8_rows(qs, R, D, q_sc, warp, lane);
    __syncthreads();
  }

  const int live = (start >= 0) ? min(n_tok, Tq) : 0;
  const int last = start + live - 1;                    // last query position
  const int lo = window > 0 ? max(start - window + 1, 0) / bs : 0;
  const int hi = live > 0 ? min(MB - 1, last / bs) : -1;
  for (int ib = lo; ib <= hi; ++ib) {
    const int blk = table[(size_t)s * MB + ib];
    if (blk < 0 || blk >= NB) continue;                 // unmapped: all masked
    for (int i = tid; i < bs * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const size_t row = ((size_t)blk * bs + j) * KV + h;
      float kx = to_f32(k_pool[row * D + d]);
      float vx = to_f32(v_pool[row * D + d]);
      if constexpr (Quantized<TP>::value) {             // dequant on load
        kx *= k_scale[row];
        vx *= v_scale[row];
      }
      ks[i] = to_f32(from_f32<TQ>(kx));                 // in q's type
      vs[i] = to_f32(from_f32<TQ>(vx));
    }
    __syncthreads();
    if constexpr (FP8_QK) {
      fp8_rows(ks, bs, D, k_sc, warp, lane);
      __syncthreads();
    }

    // scores: one warp per (row, key lane)
    for (int e = warp; e < R * bs; e += kWarps) {
      const int r = e / bs, j = e - r * bs;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qs[r * D + d] * ks[j * D + d];
      dot = warp_sum(dot);
      if (lane == 0) {
        if constexpr (FP8_QK) dot = dot * q_sc[r] * k_sc[j];
        const int t = r / G;
        const int qp = start + t;
        const int kp = ib * bs + j;
        const bool ok = t < live && kp <= qp && (window <= 0 || qp - kp < window);
        ps[e] = ok ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < R; r += kWarps) {
      float mx = -1e30f;
      for (int j = lane; j < bs; j += 32) mx = fmaxf(mx, ps[r * bs + j]);
      mx = warp_max(mx);
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < bs; j += 32) {
        const float sv = ps[r * bs + j];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        ps[r * bs + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one thread per (row, d)
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float a = acc[i] * alpha[r];
      for (int j = 0; j < bs; ++j) a += ps[r * bs + j] * vs[j * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int t = r / G, g = r - t * G;
    out[((((size_t)s * Tq + t) * KV + h) * G + g) * D + d] =
        from_f32<TQ>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename TQ, typename TP, bool FP8_QK>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* q, const TP* k_pool, const TP* v_pool,
                    const float* k_scale, const float* v_scale,
                    const int* table, const int* q_pos, TQ* out, int KV,
                    int G, int D, int NB, int bs, int MB, int window,
                    float scale) {
  const int s = blockIdx.x / KV, h = blockIdx.x - s * KV;
  const int start = q_pos[s];
  paged_attention_cta<TQ, TP, FP8_QK>(q, k_pool, v_pool, k_scale, v_scale,
                                      table, out, s, h, start,
                                      start >= 0 ? 1 : 0, 1, KV, G, D, NB,
                                      bs, MB, window, scale);
}

template <typename TQ, typename TP, bool FP8_QK>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const TQ* q, const TP* k_pool, const TP* v_pool,
                    const float* k_scale, const float* v_scale,
                    const int* table, const int* start_pos,
                    const int* n_tokens, TQ* out, int Tq, int KV, int G,
                    int D, int NB, int bs, int MB, int window, float scale) {
  const int s = blockIdx.x / KV, h = blockIdx.x - s * KV;
  paged_attention_cta<TQ, TP, FP8_QK>(q, k_pool, v_pool, k_scale, v_scale,
                                      table, out, s, h, start_pos[s],
                                      n_tokens[s], Tq, KV, G, D, NB, bs, MB,
                                      window, scale);
}

// Opts a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

// The operands of one launch, untyped; Tq = 1 and n_tokens = null for
// decode, where start holds q_pos.
struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *table, *start, *n_tokens;
  void* out;
  int S, Tq, KV, G, D, NB, bs, MB, window;
  cudaStream_t st;
};

template <typename TQ, typename TP, bool FP8_QK>
int launch(const Args& a) {
  const size_t smem = smem_floats(a.Tq * a.G, a.D, a.bs) * sizeof(float);
  const float scale = 1.0f / sqrtf(static_cast<float>(a.D));
  const auto* q = static_cast<const TQ*>(a.q);
  const auto* kp = static_cast<const TP*>(a.k_pool);
  const auto* vp = static_cast<const TP*>(a.v_pool);
  auto* out = static_cast<TQ*>(a.out);
  cudaError_t err;
  if (a.n_tokens == nullptr) {
    err = prepare(paged_decode_kernel<TQ, TP, FP8_QK>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_decode_kernel<TQ, TP, FP8_QK><<<a.S * a.KV, kThreads, smem, a.st>>>(
        q, kp, vp, a.k_scale, a.v_scale, a.table, a.start, out, a.KV, a.G,
        a.D, a.NB, a.bs, a.MB, a.window, scale);
  } else {
    err = prepare(paged_verify_kernel<TQ, TP, FP8_QK>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_verify_kernel<TQ, TP, FP8_QK><<<a.S * a.KV, kThreads, smem, a.st>>>(
        q, kp, vp, a.k_scale, a.v_scale, a.table, a.start, a.n_tokens, out,
        a.Tq, a.KV, a.G, a.D, a.NB, a.bs, a.MB, a.window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_pool(int pool_dtype, int fp8, const Args& a) {
  const bool scaled = a.k_scale != nullptr && a.v_scale != nullptr;
  if (pool_dtype <= 1) {                                 // plain pools
    if (a.k_scale != nullptr || a.v_scale != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (pool_dtype == 0)
      return fp8 ? launch<TQ, float, true>(a) : launch<TQ, float, false>(a);
    return fp8 ? launch<TQ, __nv_bfloat16, true>(a)
               : launch<TQ, __nv_bfloat16, false>(a);
  }
  if (fp8 || !scaled) return static_cast<int>(cudaErrorInvalidValue);
  if (pool_dtype == 2) return launch<TQ, int8_t, false>(a);
  if (pool_dtype == 3) return launch<TQ, __nv_fp8_e4m3, false>(a);
  if (pool_dtype == 4) return launch<TQ, __nv_fp8_e5m2, false>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_any(int q_dtype, int pool_dtype, int fp8, const Args& a) {
  if (q_dtype == 0) return launch_pool<float>(pool_dtype, fp8, a);
  if (q_dtype == 1) return launch_pool<__nv_bfloat16>(pool_dtype, fp8, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_paged_decode(int q_dtype, int pool_dtype, int fp8, const void* q,
                       const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale,
                       const void* table, const void* q_pos, void* out, int S,
                       int KV, int G, int D, int NB, int bs, int MB,
                       int window, void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table),
               static_cast<const int*>(q_pos), nullptr, out, S, 1, KV, G, D,
               NB, bs, MB, window, static_cast<cudaStream_t>(stream)};
  return launch_any(q_dtype, pool_dtype, fp8, a);
}

int repro_paged_verify(int q_dtype, int pool_dtype, int fp8, const void* q,
                       const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale,
                       const void* table, const void* start_pos,
                       const void* n_tokens, void* out, int S, int Tq, int KV,
                       int G, int D, int NB, int bs, int MB, int window,
                       void* stream) {
  if (n_tokens == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table),
               static_cast<const int*>(start_pos),
               static_cast<const int*>(n_tokens), out, S, Tq, KV, G, D, NB,
               bs, MB, window, static_cast<cudaStream_t>(stream)};
  return launch_any(q_dtype, pool_dtype, fp8, a);
}

}  // extern "C"
