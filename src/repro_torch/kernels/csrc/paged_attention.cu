// Paged decode and paged verify attention for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/decode_attention/kernel.py
//     paged_decode_attention_fwd  (:424, pallas_call :468)  one query per slot
//     paged_verify_attention_fwd  (:275, pallas_call :317)  T queries per slot
//
// Both read a shared pool of fixed-size KV blocks, k_pool/v_pool
// (NB, bs, KV, D), through a per-slot block table (S, MB) int32 (-1 =
// unmapped).  Logical position i of slot s lives at offset i % bs of
// physical block table[s, i / bs], so validity is positional: a key at
// position p is attended by a query at position qp iff the block is
// mapped, p <= qp and, with a window w > 0, qp - p < w.
//
// What bounds it: bytes.  Each live key and value row is read once and
// used for G (decode) or T*G (verify) dot products of length D; at T*G <=
// a few tens of rows that is far below the card's ratio of operations to
// bytes, so the least time is the live K/V bytes over 3.35 TB/s.
//
// Design: one CTA per (slot, KV head).  The TPU kernel's sequential grid
// axis over blocks, which carried (m, l, acc) in VMEM, becomes a loop
// inside the CTA over the slot's logical blocks; blocks run from the
// first one the window can reach to the one holding the slot's last
// query position, so blocks past the query (and unmapped ones) are never
// loaded.  Per block the CTA stages the K and V tile in shared memory
// (threads on consecutive head-dim elements: coalesced loads, no bank
// conflicts), then one warp per (query row, key) computes a dot product
// with shuffles, one warp per row folds the tile into the running f32
// max / sum (online softmax), and one thread per (row, d) rescales and
// accumulates P.V.  All T*G query rows of a slot share each tile loaded
// once.  Masked lanes contribute exactly zero (not exp(0) as with the
// finite -1e30 of the TPU kernel), so a row with no attendable key comes
// out as zeros; those rows (inactive slots, padding tokens) are garbage
// the caller ignores in both implementations.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int;
// dtype 0 = float32, 1 = bfloat16 for q / pools / output.  Each entry
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
         + 3 * static_cast<size_t>(R);       // m, l, alpha
}

// One CTA: slot s, KV head h, query rows r = t*G + g for t < T.  Query
// token t sits at position start + t and is live iff start >= 0 and
// t < n_tok.  q/out rows are at (((s*T + t)*KV + h)*G + g)*D.
template <typename T>
__device__ void paged_attention_cta(const T* __restrict__ q,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ table,
                                    T* __restrict__ out, int s, int h,
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

  const int live = (start >= 0) ? min(n_tok, Tq) : 0;
  const int last = start + live - 1;                    // last query position
  const int lo = window > 0 ? max(start - window + 1, 0) / bs : 0;
  const int hi = live > 0 ? min(MB - 1, last / bs) : -1;
  for (int ib = lo; ib <= hi; ++ib) {
    const int blk = table[(size_t)s * MB + ib];
    if (blk < 0 || blk >= NB) continue;                 // unmapped: all masked
    for (int i = tid; i < bs * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const size_t off = (((size_t)blk * bs + j) * KV + h) * D + d;
      ks[i] = to_f32(k_pool[off]);
      vs[i] = to_f32(v_pool[off]);
    }
    __syncthreads();

    // scores: one warp per (row, key lane)
    for (int e = warp; e < R * bs; e += kWarps) {
      const int r = e / bs, j = e - r * bs;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qs[r * D + d] * ks[j * D + d];
      dot = warp_sum(dot);
      if (lane == 0) {
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
        from_f32<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* q, const T* k_pool, const T* v_pool,
                    const int* table, const int* q_pos, T* out, int KV,
                    int G, int D, int NB, int bs, int MB, int window,
                    float scale) {
  const int s = blockIdx.x / KV, h = blockIdx.x - s * KV;
  const int start = q_pos[s];
  paged_attention_cta<T>(q, k_pool, v_pool, table, out, s, h, start,
                         start >= 0 ? 1 : 0, 1, KV, G, D, NB, bs, MB,
                         window, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* q, const T* k_pool, const T* v_pool,
                    const int* table, const int* start_pos,
                    const int* n_tokens, T* out, int Tq, int KV, int G,
                    int D, int NB, int bs, int MB, int window, float scale) {
  const int s = blockIdx.x / KV, h = blockIdx.x - s * KV;
  paged_attention_cta<T>(q, k_pool, v_pool, table, out, s, h, start_pos[s],
                         n_tokens[s], Tq, KV, G, D, NB, bs, MB, window,
                         scale);
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

template <typename T>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const int* table, const int* q_pos, void* out, int S,
                  int KV, int G, int D, int NB, int bs, int MB, int window,
                  cudaStream_t st) {
  const size_t smem = smem_floats(G, D, bs) * sizeof(float);
  cudaError_t err = prepare(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T><<<S * KV, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, q_pos, static_cast<T*>(out), KV,
      G, D, NB, bs, MB, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_verify(const void* q, const void* k_pool, const void* v_pool,
                  const int* table, const int* start_pos, const int* n_tokens,
                  void* out, int S, int Tq, int KV, int G, int D, int NB,
                  int bs, int MB, int window, cudaStream_t st) {
  const size_t smem = smem_floats(Tq * G, D, bs) * sizeof(float);
  cudaError_t err = prepare(paged_verify_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_verify_kernel<T><<<S * KV, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, start_pos, n_tokens,
      static_cast<T*>(out), Tq, KV, G, D, NB, bs, MB, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_paged_decode(int dtype, const void* q, const void* k_pool,
                       const void* v_pool, const void* table,
                       const void* q_pos, void* out, int S, int KV, int G,
                       int D, int NB, int bs, int MB, int window,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* qp = static_cast<const int*>(q_pos);
  if (dtype == 0)
    return launch_decode<float>(q, k_pool, v_pool, tab, qp, out, S, KV, G, D,
                                NB, bs, MB, window, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k_pool, v_pool, tab, qp, out, S,
                                        KV, G, D, NB, bs, MB, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int repro_paged_verify(int dtype, const void* q, const void* k_pool,
                       const void* v_pool, const void* table,
                       const void* start_pos, const void* n_tokens, void* out,
                       int S, int Tq, int KV, int G, int D, int NB, int bs,
                       int MB, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* sp = static_cast<const int*>(start_pos);
  const int* nt = static_cast<const int*>(n_tokens);
  if (dtype == 0)
    return launch_verify<float>(q, k_pool, v_pool, tab, sp, nt, out, S, Tq,
                                KV, G, D, NB, bs, MB, window, st);
  if (dtype == 1)
    return launch_verify<__nv_bfloat16>(q, k_pool, v_pool, tab, sp, nt, out,
                                        S, Tq, KV, G, D, NB, bs, MB, window,
                                        st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
