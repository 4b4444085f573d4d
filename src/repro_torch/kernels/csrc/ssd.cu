// The Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/ssd/kernel.py  ssd_fwd  (:79, pallas_call :89)
//
// Inputs x (B, S, H, P) in f32 or bf16; dt (B, S, H) >= 0, A (H,) < 0,
// Bm / Cm (B, S, N) (one group) and D (H,), all f32.  Outputs y (B, S, H,
// P) in x's type and the final state h (B, H, N, P) f32.  Everything is
// computed in f32.  The sequence is cut into chunks of Q <= 128 tokens;
// per chunk, with cum the inclusive cumsum of dt*A over the chunk:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//         + exp(cum_i) C_i . h                                      (inter)
//         + D x_i                                                   (skip)
//   h    <- exp(cum_last) h + sum_j B_j (x) exp(cum_last - cum_j) dt_j x_j
// which is the math of the reference's ssd_chunked.  Rows at or past S
// are the wrapper's padding rule (dt = 0, x = B = C = 0): loaded as
// zeros, never written, so they leave the recurrence unchanged.
//
// What bounds it: operations.  Per chunk and batch row the (Q x Q) C.B^T
// product (2 Q(Q+1)/2 N, causal half), and per head the inter term and
// the state update (2 Q N P each) and the intra product (2 Q(Q+1)/2 P):
// at mamba2-1.3b's shapes about 70 FLOPs per byte the function must move,
// far above the card's f32 ratio (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design.  The TPU kernel keeps the whole state (H, N, P), 2 MiB at
// mamba2-1.3b's width, in VMEM and sweeps the chunks with a sequential
// grid.  That does not fit in an SM, so here one CTA owns one (batch row,
// head): its (N, P) f32 state (32 KB at N 128, P 64) stays in shared
// memory while a loop inside the CTA walks the chunks in order (CTAs of
// different heads run in parallel; nothing crosses CTAs).  Per chunk the
// CTA stages x (Q x P) and dt, takes the cumsum in the plain version's
// order (blocks of 16, so the decays equal the plain version's to the
// bit), then sweeps N in tiles of 32 rows of C and B (rows padded to 33
// floats: no bank conflicts): each tile adds its part of C.B^T (only
// j <= i), of the inter term (from the state before the chunk) and then
// updates its 32 rows of the state.  Last the (Q x Q) decay matrix is
// formed in place, evaluating exp(cum_i - cum_j) only for j <= i (the
// other half overflows, and inf * 0 would be NaN), and the intra term,
// the inter term and the skip are summed and stored.  C.B^T is shared by
// all heads and recomputed by each head's CTA in this first version; no
// tensor cores (TF32 would break the port's f32 numerics).
//
// C interface (ctypes): pointers and the stream as void*, sizes as int;
// x_dtype 0 = float32, 1 = bfloat16 (x and y).  Returns cudaGetLastError()
// after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNT = 32;                // state rows (N) per tile
constexpr int kRow = kNT + 1;          // padded tile row, in floats
constexpr int kMaxQ = 128;
constexpr int kCumBlock = 16;          // the cumsum's block (ssd/ref.py)
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared-memory floats for chunk Q, state N x P.
__host__ __device__ inline size_t smem_floats(int Q, int N, int P) {
  return static_cast<size_t>(N) * P            // state h
         + 2 * static_cast<size_t>(Q) * P      // x chunk, inter sums
         + static_cast<size_t>(Q) * Q          // C.B^T, then the decay matrix
         + 2 * static_cast<size_t>(Q) * kRow   // C tile, B tile
         + 4 * static_cast<size_t>(Q);         // dt, cum, exp(cum), weights
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ D,
           T* __restrict__ y, float* __restrict__ h_out, int S, int H, int P,
           int N, int Q) {
  extern __shared__ float smem[];
  __shared__ float blk_pre[kMaxQ / kCumBlock];
  const int b = blockIdx.x / H, hd = blockIdx.x - b * H;
  float* hs = smem;                    // (N, P)
  float* xs = hs + N * P;              // (Q, P)
  float* ys = xs + Q * P;              // (Q, P): sum_n C[i][n] h[n][p]
  float* cb = ys + Q * P;              // (Q, Q)
  float* ct = cb + Q * Q;              // (Q, kRow)
  float* bt = ct + Q * kRow;           // (Q, kRow)
  float* dts = bt + Q * kRow;          // (Q,)
  float* cum = dts + Q;                // (Q,)
  float* ecum = cum + Q;               // exp(cum_i)
  float* w = ecum + Q;                 // dt_j exp(cum_last - cum_j)
  const int tid = threadIdx.x;
  const float a = A[hd];
  const float dskip = D[hd];

  for (int e = tid; e < N * P; e += kThreads) hs[e] = 0.f;
  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    for (int i = tid; i < Q; i += kThreads) {
      const int s = s0 + i;
      dts[i] = s < S ? dt[(static_cast<size_t>(b) * S + s) * H + hd] : 0.f;
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, p = e - i * P;
      const int s = s0 + i;
      xs[e] = s < S ? to_f32(x[((static_cast<size_t>(b) * S + s) * H + hd) * P + p])
                    : 0.f;
      ys[e] = 0.f;
    }
    for (int e = tid; e < Q * Q; e += kThreads) cb[e] = 0.f;
    // inclusive cumsum of dt*A in the plain version's order, to the bit:
    // sequential inside blocks of kCumBlock, then each block's exclusive
    // prefix of block totals added (no FMA contraction anywhere)
    for (int i = tid; i < Q; i += kThreads) cum[i] = __fmul_rn(dts[i], a);
    __syncthreads();
    const int nb = (Q + kCumBlock - 1) / kCumBlock;
    if (tid < nb) {
      const int i1 = min((tid + 1) * kCumBlock, Q);
      float run = cum[tid * kCumBlock];
      for (int i = tid * kCumBlock + 1; i < i1; ++i) {
        run = __fadd_rn(run, cum[i]);
        cum[i] = run;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float pre = 0.f;
      blk_pre[0] = 0.f;
      for (int bi = 1; bi < nb; ++bi) {
        pre = __fadd_rn(pre, cum[bi * kCumBlock - 1]);
        blk_pre[bi] = pre;
      }
    }
    __syncthreads();
    for (int i = kCumBlock + tid; i < Q; i += kThreads)
      cum[i] = __fadd_rn(cum[i], blk_pre[i / kCumBlock]);
    __syncthreads();
    const float last = cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      ecum[i] = expf(cum[i]);
      w[i] = dts[i] * expf(last - cum[i]);
    }
    const float decay = expf(last);

    for (int n0 = 0; n0 < N; n0 += kNT) {
      const int nt = min(kNT, N - n0);
      for (int e = tid; e < Q * kNT; e += kThreads) {
        const int i = e / kNT, n = e - i * kNT;
        const int s = s0 + i;
        const bool in = s < S && n < nt;
        const size_t g = (static_cast<size_t>(b) * S + s) * N + n0 + n;
        ct[i * kRow + n] = in ? Cm[g] : 0.f;
        bt[i * kRow + n] = in ? Bm[g] : 0.f;
      }
      __syncthreads();                 // also publishes ecum and w
      // C.B^T over this tile, j <= i only (each thread owns its entries)
      for (int e = tid; e < Q * Q; e += kThreads) {
        const int i = e / Q, j = e - i * Q;
        if (j > i) continue;
        float acc = 0.f;
        for (int n = 0; n < nt; ++n) acc += ct[i * kRow + n] * bt[j * kRow + n];
        cb[e] += acc;
      }
      // inter term from the state before this chunk, rows n0..n0+nt
      for (int e = tid; e < Q * P; e += kThreads) {
        const int i = e / P, p = e - i * P;
        float acc = 0.f;
        for (int n = 0; n < nt; ++n) acc += ct[i * kRow + n] * hs[(n0 + n) * P + p];
        ys[e] += acc;
      }
      __syncthreads();                 // every read of these state rows done
      for (int e = tid; e < nt * P; e += kThreads) {
        const int n = e / P, p = e - n * P;
        float acc = 0.f;
        for (int j = 0; j < Q; ++j) acc += bt[j * kRow + n] * w[j] * xs[j * P + p];
        float* hv = hs + (n0 + n) * P + p;
        *hv = decay * *hv + acc;
      }
      __syncthreads();                 // the tile buffers are reloaded next
    }

    // the decay matrix, in place: exp(cum_i - cum_j) only where j <= i
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e - i * Q;
      if (j <= i) cb[e] *= expf(cum[i] - cum[j]) * dts[j];
    }
    __syncthreads();
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, p = e - i * P;
      const int s = s0 + i;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += cb[i * Q + j] * xs[j * P + p];
      const float v = acc + ys[e] * ecum[i] + xs[e] * dskip;
      if (s < S) y[((static_cast<size_t>(b) * S + s) * H + hd) * P + p] = from_f32<T>(v);
    }
    __syncthreads();                   // x, sums and cb are rewritten next
  }
  float* hb = h_out + (static_cast<size_t>(b) * H + hd) * N * P;
  for (int e = tid; e < N * P; e += kThreads) hb[e] = hs[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* D, void* y, float* h, int Bsz, int S,
           int H, int P, int N, int Q, cudaStream_t st) {
  const size_t smem = smem_floats(Q, N, P) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_kernel<T><<<Bsz * H, kThreads, smem, st>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, D, static_cast<T*>(y), h, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_ssd(int x_dtype, const void* x, const void* dt, const void* A,
              const void* Bm, const void* Cm, const void* D, void* y, void* h,
              int Bsz, int S, int H, int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > kMaxQ || S < 1 || H < 1 || P < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(Bm);
  const auto* Cf = static_cast<const float*>(Cm);
  const auto* Df = static_cast<const float*>(D);
  auto* hf = static_cast<float*>(h);
  auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch<float>(x, dtf, Af, Bf, Cf, Df, y, hf, Bsz, S, H, P, N, Q, st);
  if (x_dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Bf, Cf, Df, y, hf, Bsz, S, H, P, N, Q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
