// Causal flash attention, forward and backward, for Hopper (sm_90a).
//
// The forward replaces the JAX package's Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py  flash_attention_fwd
//   (:98, pallas_call :127)
// and also returns the row log-sum-exp.  Its fp8=True variant (QK^T on
// per-row fp8_e4m3 codes, src/repro/kernels/common.py:31 qk_dot_fp8 in the
// kernel body :69-70) is the FP8_QK instantiation, repro_flash_fwd_fp8.  The backward has no TPU
// counterpart: the Pallas kernel has no VJP, and the JAX package's
// gradient of this function is jax.grad of its jnp reference
// (kernels/flash_attention/ref.py reference_attention).
//
// Function: q (B, S, H, D), k/v (B, S, KV, D) with H % KV == 0 (query head
// h reads KV head h / G, G = H / KV), scores (q . k) / sqrt(D) in f32,
// causal (key <= query) unless causal == 0, and with window > 0 only keys
// with query - key < window.  o (B, S, H, D) in q's dtype; lse (B, H, S)
// f32.  The layout is the one the model's projections give, so no
// transpose is needed on either side.  S need not be a multiple of a tile:
// rows and keys past S are masked.
//
// What bounds it: operations.  At the training shape (B 4, H 10, S 1024,
// D 128) the forward does 4*B*H*S^2*D / 2 FLOPs on 4*B*S*H*D*4 bytes, far
// above the card's f32 ratio of operations to bytes; the backward does
// 2.5x the forward's FLOPs.  TF32 stays off in the port, so the f32 rate
// without tensor cores (67 TFLOP/s) is the roof.
//
// Design (simple and right first; not tuned).  A CTA of 256 threads owns
// a 64-row tile.  Tiles of the other operand (64 rows) are staged in
// shared memory as f32, rows padded to D + 1 floats so that 16 threads
// reading 16 different rows at one column hit 16 banks.  Thread t owns
// rows 4*(t/16) .. +3 of its tile and columns t%16 + 16*j of the other,
// so each score micro-tile is 4 x 4 and the 16 threads of a row share a
// half-warp (row max and sum by shuffles).  Tiles that the causal mask or
// the window rules out entirely are never loaded.  Masked scores get
// probability 0 exactly (the TPU kernel's finite -1e30 gives the same 0
// in f32); a row's running max starts at -inf and exp() is never taken
// of -inf - -inf, so no NaN arises even where a tile masks a whole row.
//
// * forward: one CTA per (q tile, head, batch); online softmax over the
//   KV tiles (running max m, sum l, f32 accumulator in registers), P
//   through shared memory into P.V; o = acc / l, lse = m + log l.
//   With FP8_QK, every row of the staged Q tile (once) and of each K tile
//   (after its load) is replaced in shared memory by the f32 values of its
//   e4m3 codes under the row's own scale max(amax, 1e-12) / 448 (true
//   division, clip to +-448, round to nearest even), one warp per row;
//   the code dot is then multiplied by q_scale * k_scale and by 1/sqrt(D),
//   in that order, as qk_dot_fp8 does.  P.V stays f32.  A row's scale
//   sits in the row's padding float (column D), so both variants use the
//   same shared memory and fit two CTAs per SM.
// * backward, FA2's split:
//   - delta = rowsum(dO * O), one warp per row;
//   - dK/dV: one CTA per (KV tile, KV head, batch), looping over the G
//     query heads of the group and the query tiles that can see the
//     keys; P = exp(s - lse) is recomputed, dV += P^T dO,
//     dS = P * (dO V^T - delta), dK += dS^T Q * scale.  The group sum
//     happens in registers: no atomics, the same result on every run;
//   - dQ: one CTA per (q tile, head, batch) over the KV tiles,
//     dQ += dS K * scale.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int;
// dtype 0 = float32, 1 = bfloat16 for q/k/v/o/do/dq/dk/dv (lse and delta
// are f32).  Supported head dims: 16, 32, 64, 128.  Each entry returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of every tile (queries and keys)
constexpr int kP = kTile + 1;      // padded row of a 64 x 64 score tile
constexpr int kWarps = kThreads / 32;
constexpr float kFp8Max = 448.f;   // float8_e4m3fn saturation
constexpr float kScaleEps = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Reduce over the 16 lanes of a half-warp (the 16 threads of one row).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Replace each of the 64 rows (length D, stride D + 1) of a staged tile by
// the f32 values of its fp8_e4m3 codes under the row's own amax scale,
// written to the row's padding float x[row][D]: one warp per row.
// qk_dot_fp8's order: scale, true division, clip, RNE cast.
// (paged_attention.cu fp8_rows, at this kernel's padded stride.)
template <int D>
__device__ void fp8_rows(float* x) {
  constexpr int DP = D + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTile; r += kWarps) {
    float* row = x + r * DP;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(row[d]));
    const float s = fmaxf(warp_max(amax), kScaleEps) / kFp8Max;
    for (int d = lane; d < D; d += 32) {
      const float y = fminf(fmaxf(row[d] / s, -kFp8Max), kFp8Max);
      row[d] = static_cast<float>(__nv_fp8_e4m3(y));
    }
    if (lane == 0) row[D] = s;
  }
}

__device__ __forceinline__ bool visible(int qi, int ki, int S, int causal,
                                        int window) {
  return qi < S && ki < S && (!causal || ki <= qi) &&
         (window <= 0 || qi - ki < window);
}

// Rows r0 .. r0+63 of a (B, S, NH, D) tensor at head h into smem (f32,
// row stride D + 1); rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int r0, int h, int S, int NH) {
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D, ri = r0 + r;
    dst[r * DP + c] = ri < S
        ? to_f32(src[((static_cast<size_t>(b) * S + ri) * NH + h) * D + c])
        : 0.f;
  }
}

// Key tiles a query tile [q0, q0 + 64) can see: [lo, hi).
__device__ __forceinline__ void key_tiles(int q0, int S, int causal,
                                          int window, int* lo, int* hi) {
  const int k_hi = causal ? min(S, q0 + kTile) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  *lo = k_lo / kTile;
  *hi = (k_hi + kTile - 1) / kTile;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int D, bool FP8_QK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KV, float scale,
                 int causal, int window) {
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* Ps = Vs + kTile * DP;       // kTile x kP
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, D>(Qs, q, b, q0, h, S, H);
  if constexpr (FP8_QK) {
    __syncthreads();
    fp8_rows<D>(Qs);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int kt_lo, kt_hi;
  key_tiles(q0, S, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D>(Ks, k, b, k0, kvh, S, KV);
    load_tile<T, D>(Vs, v, b, k0, kvh, S, KV);
    __syncthreads();
    if constexpr (FP8_QK) {
      fp8_rows<D>(Ks);
      __syncthreads();
    }
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * DP + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qi, k0 + tx + 16 * j, S, causal, window);
        if constexpr (FP8_QK)   // the row scales, in the padding column
          s[i][j] = s[i][j] * Qs[(ty * 4 + i) * DP + D] * Ks[(tx + 16 * j) * DP + D];
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * kP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float inv = 1.f / l[i];
    T* orow = o + ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (tx == 0) lse[(static_cast<size_t>(b) * H + h) * S + qi] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]; one warp per row.
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, int rows,
                                       int S, int H, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;           // whole warps leave together
  const size_t base = static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc += to_f32(dout[base + c]) * to_f32(o[base + c]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int b = row / (S * H), rem = row % (S * H);
    const int s = rem / H, h = rem % H;
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int KV, float scale,
                      int causal, int window) {
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * DP;
  float* Qs = Vs + kTile * DP;
  float* dOs = Qs + kTile * DP;
  float* Ps = dOs + kTile * DP;      // [key][query], kTile x kP
  float* dSs = Ps + kTile * kP;
  float* Ls = dSs + kTile * kP;      // lse of the query tile's rows
  float* Ds = Ls + kTile;            // delta of the query tile's rows
  const int k0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tk = threadIdx.x / 16, tc = threadIdx.x % 16;
  load_tile<T, D>(Ks, k, b, k0, kvh, S, KV);
  load_tile<T, D>(Vs, v, b, k0, kvh, S, KV);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // query tiles that can see a key of [k0, k0 + 64)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + kTile - 1 + window) : S;
  const int qt_lo = q_lo / kTile, qt_hi = (q_hi + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* drow = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<T, D>(Qs, q, b, q0, h, S, H);
      load_tile<T, D>(dOs, dout, b, q0, h, S, H);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        Ls[r] = q0 + r < S ? lrow[q0 + r] : 0.f;
        Ds[r] = q0 + r < S ? drow[q0 + r] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int dd = 0; dd < D; ++dd) {
        float ak[4], av[4], bq[4], bo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i] = Ks[(tk * 4 + i) * DP + dd];
          av[i] = Vs[(tk * 4 + i) * DP + dd];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bq[j] = Qs[(tc + 16 * j) * DP + dd];
          bo[j] = dOs[(tc + 16 * j) * DP + dd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += ak[i] * bq[j];
            dpt[i][j] += av[i] * bo[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ki = k0 + tk * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qq = tc + 16 * j;
          const bool ok = visible(q0 + qq, ki, S, causal, window);
          const float p = ok ? expf(st[i][j] * scale - Ls[qq]) : 0.f;
          Ps[(tk * 4 + i) * kP + qq] = p;
          dSs[(tk * 4 + i) * kP + qq] = p * (dpt[i][j] - Ds[qq]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[(tk * 4 + i) * kP + qq];
          ds[i] = dSs[(tk * 4 + i) * kP + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float od = dOs[qq * DP + tc + 16 * c];
          const float qv = Qs[qq * DP + tc + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] += p[i] * od;
            dk_acc[i][c] += ds[i] * qv;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + tk * 4 + i;
    if (ki >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + ki) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tc + 16 * c] = from_f32<T>(dk_acc[i][c] * scale);
      dv[off + tc + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KV, float scale, int causal,
                    int window) {
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * DP;
  float* Ks = dOs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* dSs = Vs + kTile * DP;      // [query][key], kTile x kP
  float* Ls = dSs + kTile * kP;
  float* Ds = Ls + kTile;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, D>(Qs, q, b, q0, h, S, H);
  load_tile<T, D>(dOs, dout, b, q0, h, S, H);
  const float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* drow = delta + (static_cast<size_t>(b) * H + h) * S;
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    Ls[r] = q0 + r < S ? lrow[q0 + r] : 0.f;
    Ds[r] = q0 + r < S ? drow[q0 + r] : 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  int kt_lo, kt_hi;
  key_tiles(q0, S, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, k, b, k0, kvh, S, KV);
    load_tile<T, D>(Vs, v, b, k0, kvh, S, KV);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; ++dd) {
      float aq[4], ao[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aq[i] = Qs[(ty * 4 + i) * DP + dd];
        ao[i] = dOs[(ty * 4 + i) * DP + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[(tx + 16 * j) * DP + dd];
        bv[j] = Vs[(tx + 16 * j) * DP + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += aq[i] * bk[j];
          dp[i][j] += ao[i] * bv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(q0 + r, k0 + tx + 16 * j, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        dSs[r * kP + tx + 16 * j] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * kP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Ks[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += ds[i] * kv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    T* row = dq + ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
  }
}

// Shared-memory bytes of each kernel for head dim D.
constexpr size_t fwd_smem(int D) {
  return (3 * static_cast<size_t>(kTile) * (D + 1) + kTile * kP) * sizeof(float);
}
constexpr size_t dkdv_smem(int D) {
  return (4 * static_cast<size_t>(kTile) * (D + 1) + 2 * kTile * kP + 2 * kTile)
         * sizeof(float);
}
constexpr size_t dq_smem(int D) {
  return (4 * static_cast<size_t>(kTile) * (D + 1) + kTile * kP + 2 * kTile)
         * sizeof(float);
}

template <typename T, int D, bool FP8_QK>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int KV, float scale,
                int causal, int window, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D, FP8_QK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(fwd_smem(D)));
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, fwd_smem(D), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, KV, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int S, int H, int KV, float scale,
                int causal, int window, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * S * H;
  flash_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(o), dot, delta, rows, S, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kdkdv = flash_bwd_dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_smem(D)));
  if (err != cudaSuccess) return err;
  dim3 grid_kv((S + kTile - 1) / kTile, KV, B);
  kdkdv<<<grid_kv, kThreads, dkdv_smem(D), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, KV, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kdq = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem(D)));
  if (err != cudaSuccess) return err;
  dim3 grid_q((S + kTile - 1) / kTile, H, B);
  kdq<<<grid_q, kThreads, dq_smem(D), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, H, KV, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T, bool FP8_QK>
cudaError_t fwd_d(int D, const void* q, const void* k, const void* v,
                  void* o, float* lse, int B, int S, int H, int KV,
                  float scale, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 16: return fwd<T, 16, FP8_QK>(q, k, v, o, lse, B, S, H, KV, scale, causal, window, st);
    case 32: return fwd<T, 32, FP8_QK>(q, k, v, o, lse, B, S, H, KV, scale, causal, window, st);
    case 64: return fwd<T, 64, FP8_QK>(q, k, v, o, lse, B, S, H, KV, scale, causal, window, st);
    case 128: return fwd<T, 128, FP8_QK>(q, k, v, o, lse, B, S, H, KV, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_d(int D, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv, int B, int S,
                  int H, int KV, float scale, int causal, int window,
                  cudaStream_t st) {
  switch (D) {
    case 16: return bwd<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, scale, causal, window, st);
    case 32: return bwd<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, scale, causal, window, st);
    case 64: return bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, scale, causal, window, st);
    case 128: return bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FP8_QK>
int fwd_any(int dtype, const void* q, const void* k, const void* v, void* o,
            void* lse, int B, int S, int H, int KV, int D, float scale,
            int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = fwd_d<float, FP8_QK>(D, q, k, v, o, l, B, S, H, KV, scale, causal,
                               window, st);
  else if (dtype == 1)
    err = fwd_d<__nv_bfloat16, FP8_QK>(D, q, k, v, o, l, B, S, H, KV, scale,
                                       causal, window, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                    void* o, void* lse, int B, int S, int H, int KV, int D,
                    float scale, int causal, int window, void* stream) {
  return fwd_any<false>(dtype, q, k, v, o, lse, B, S, H, KV, D, scale, causal,
                        window, stream);
}

// The forward with QK^T on per-row fp8_e4m3 codes (same arguments).
int repro_flash_fwd_fp8(int dtype, const void* q, const void* k,
                        const void* v, void* o, void* lse, int B, int S, int H,
                        int KV, int D, float scale, int causal, int window,
                        void* stream) {
  return fwd_any<true>(dtype, q, k, v, o, lse, B, S, H, KV, D, scale, causal,
                       window, stream);
}

// delta is (B, H, S) f32 scratch.
int repro_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B, int S,
                    int H, int KV, int D, float scale, int causal, int window,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = bwd_d<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV,
                       scale, causal, window, st);
  else if (dtype == 1)
    err = bwd_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, S,
                               H, KV, scale, causal, window, st);
  return static_cast<int>(err);
}

}  // extern "C"
