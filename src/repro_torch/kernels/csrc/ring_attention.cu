// Single-token decode attention over a ring-buffer KV cache, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/decode_attention/kernel.py
//     decode_attention_fwd  (:476, pallas_call :489)
//
// One query token per batch row, grouped query heads: q (B, KV, G, D);
// the cache k / v (B, KV, S, D) in q's type (f32 or bf16), with a per-slot
// position array pos (B, S) int32 (-1 = empty slot) and the query's
// position q_pos (B,) int32.  Slot j of row b is live iff pos >= 0,
// pos <= q_pos and, with a window w > 0, q_pos - pos < w: the causal gate
// and the window gate of the static serving path's mask.  Which slot holds
// which position does not matter (the ring wraps), only pos does.  Output
// (B, KV, G, D) in q's type.
//
// What bounds it: bytes.  Each live key and value row is read once and
// used for G dot products of length D, far below the card's ratio of
// operations to bytes; the least time is the live K/V rows (plus q, the
// output and pos) over 3.35 TB/s.
//
// Design: one CTA per (batch row, KV head), the TPU kernel's sequential
// grid axis over key blocks becoming a loop inside the CTA over tiles of
// 32 slots.  Per tile the CTA stages the slots' positions, decides which
// are live, and loads only the live K and V rows into shared memory (a
// tile with no live slot is skipped whole); then one warp per (query head,
// slot) takes a dot product with shuffles, one warp per query head folds
// the tile into the running f32 max / sum (online softmax), and one thread
// per (head, d) rescales and accumulates P.V.  The G query heads of a KV
// head share each tile loaded once.  Dead slots contribute exactly zero
// (the TPU kernel's finite -1e30 mask gives exp(0) to every slot of a row
// with nothing live), so a row with no live key (a query at position -1,
// a left-pad token of the static prefill) comes out as zeros; that row is
// garbage the caller never reads, in both implementations.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int;
// dtype 0 = float32, 1 = bfloat16 (q, k, v and the output).  Returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                    // slots per tile
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

// Shared-memory floats for G query heads of head dim D (plus kTile ints).
__host__ __device__ inline size_t smem_floats(int G, int D) {
  return 2 * static_cast<size_t>(G) * D        // q rows, accumulators
         + 2 * static_cast<size_t>(kTile) * D  // K tile, V tile
         + static_cast<size_t>(G) * kTile      // scores / probabilities
         + 3 * static_cast<size_t>(G)          // m, l, alpha
         + kTile;                              // live flags
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos,
                   const int* __restrict__ q_pos, T* __restrict__ out, int KV,
                   int G, int S, int D, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV, h = blockIdx.x - b * KV;
  float* qs = smem;
  float* acc = qs + G * D;
  float* ks = acc + G * D;
  float* vs = ks + kTile * D;
  float* ps = vs + kTile * D;
  float* m = ps + G * kTile;
  float* l = m + G;
  float* alpha = l + G;
  int* live = reinterpret_cast<int*>(alpha + G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qp = q_pos[b];
  const size_t row0 = (static_cast<size_t>(b) * KV + h);   // (b, h) of q/out

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f32(q[row0 * G * D + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < G; r += kThreads) {
    m[r] = -1e30f;
    l[r] = 0.f;
  }
  const T* kb = k + row0 * S * D;
  const T* vb = v + row0 * S * D;
  const int* pb = pos + static_cast<size_t>(b) * S;

  for (int j0 = 0; j0 < S; j0 += kTile) {
    const int nt = min(kTile, S - j0);
    int mine = 0;
    if (tid < kTile) {
      const int p = tid < nt ? pb[j0 + tid] : -1;
      mine = p >= 0 && p <= qp && (window <= 0 || qp - p < window);
      live[tid] = mine;
    }
    if (!__syncthreads_or(mine)) continue;   // no live slot in this tile
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D;
      const bool in = live[j] != 0;
      ks[i] = in ? to_f32(kb[static_cast<size_t>(j0) * D + i]) : 0.f;
      vs[i] = in ? to_f32(vb[static_cast<size_t>(j0) * D + i]) : 0.f;
    }
    __syncthreads();

    // scores: one warp per (query head, slot)
    for (int e = warp; e < G * kTile; e += kWarps) {
      const int r = e / kTile, j = e - r * kTile;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qs[r * D + d] * ks[j * D + d];
      dot = warp_sum(dot);
      if (lane == 0) ps[e] = live[j] ? dot * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int r = warp; r < G; r += kWarps) {
      const float sv = ps[r * kTile + lane];            // kTile == 32
      const float mx = warp_max(sv);
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
      ps[r * kTile + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one thread per (head, d)
    for (int i = tid; i < G * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float a = acc[i] * alpha[r];
      for (int j = 0; j < kTile; ++j) a += ps[r * kTile + j] * vs[j * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int r = i / D;
    out[row0 * G * D + i] = from_f32<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const int* q_pos, void* out, int B, int KV, int G, int S, int D,
           int window, cudaStream_t st) {
  const size_t smem = smem_floats(G, D) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  ring_decode_kernel<T><<<B * KV, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      q_pos, static_cast<T*>(out), KV, G, S, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_ring_decode(int dtype, const void* q, const void* k, const void* v,
                      const void* pos, const void* q_pos, void* out, int B,
                      int KV, int G, int S, int D, int window, void* stream) {
  if (B < 1 || KV < 1 || G < 1 || S < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const int*>(pos);
  const auto* qp = static_cast<const int*>(q_pos);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, p, qp, out, B, KV, G, S, D, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, p, qp, out, B, KV, G, S, D, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
