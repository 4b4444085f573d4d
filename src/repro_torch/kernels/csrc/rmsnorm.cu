// RMSNorm and fused residual-add + RMSNorm for Hopper (sm_90a), forward
// and backward.
//
// The forward kernels replace the JAX package's Pallas kernels
//   src/repro/kernels/rmsnorm/kernel.py  rmsnorm_fwd           (pallas_call :41)
//   src/repro/kernels/rmsnorm/kernel.py  rmsnorm_residual_fwd  (pallas_call :58)
// The backward kernel has no TPU counterpart: the JAX package
// differentiates its norms through jnp (jax.grad); here training runs the
// forward kernels, so their gradient is a kernel too (see the backward
// section below).
//
// What bounds it: bytes.  A row of d elements is read once (x, plus the
// residual) and written once (the normed row, plus the new residual); the
// arithmetic is ~4 operations per element, far below the card's ratio of
// operations to bytes, so the least time is the traffic over 3.35 TB/s.
//
// Design: one CTA per row (the TPU kernel's row tile becomes a CTA; rows
// are independent, so nothing carries between CTAs).  Each thread strides
// the row, accumulating its share of sum(x^2) in f32; a warp-shuffle then
// shared-memory reduction gives the row total; a second strided pass
// writes x * rsqrt(mean + eps) * scale.  The second pass re-reads the row,
// which the first pass left in L1/L2, so device memory sees one read.  The
// residual variant computes s = x + residual in f32, writes s (rounded to
// the row's type) as the new residual and normalises the unrounded f32 s,
// exactly as the Pallas kernel does.
//
// C interface (ctypes): pointers and the stream as void*, ints and the
// eps as plain values; dtype 0 = float32, 1 = bfloat16 for x / residual /
// outputs, scale is always float32.  Each entry returns cudaGetLastError()
// after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum of v over the CTA; every thread gets the total.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  return warp_sums[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(x[row + i]);
    ss += v * v;
  }
  const float inv = rsqrtf(block_sum(ss) / d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    out[row + i] = from_f32<T>(to_f32(x[row + i]) * inv * scale[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_residual_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                        const float* __restrict__ scale, T* __restrict__ out,
                        T* __restrict__ new_residual, int d, float eps) {
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float s = to_f32(x[row + i]) + to_f32(residual[row + i]);
    new_residual[row + i] = from_f32<T>(s);
    ss += s * s;
  }
  const float inv = rsqrtf(block_sum(ss) / d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float s = to_f32(x[row + i]) + to_f32(residual[row + i]);
    out[row + i] = from_f32<T>(s * inv * scale[i]);
  }
}

// ---------------------------------------------------------------------------
// Backward.  With s = x (+ residual) in f32, r = rsqrt(mean(s^2) + eps),
// y = s * r * scale and g = dy * scale:
//   ds     = r * g - s * r^3 * mean(g * s)   (+ dh, the gradient arriving
//                                             at the new residual output)
//   dscale = sum over rows of dy * s * r
// For the residual variant ds is both d(x) and d(residual): one tensor is
// written and the wrapper returns it for both.
//
// What bounds it: bytes (x, residual, dy, dh read once, ds written once;
// ~10 operations per element).  Design: each CTA walks a contiguous chunk
// of rows; per row a block reduction gives sum(s^2) and sum(g*s), then a
// strided pass writes ds and adds dy*s*r into the CTA's own f32 dscale
// partial in shared memory (each thread owns the columns i == tid mod
// blockDim, so no two threads touch one column).  The CTA writes its
// partial row; a second kernel sums the partials over CTAs, per column, in
// CTA order.  No atomics: the result is the same on every run.

// Sums of a and b over the CTA; every thread gets both totals.
__device__ float2 block_sum2(float a, float b) {
  __shared__ float2 sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                  // earlier readers of sums[0] are done
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) sums[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < kThreads / 32 ? sums[lane] : make_float2(0.f, 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
      t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
    }
    if (lane == 0) sums[0] = t;
  }
  __syncthreads();
  return sums[0];
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                   const float* __restrict__ scale, const T* __restrict__ dy,
                   const T* __restrict__ dh, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int d,
                   int rows_per_cta, float eps) {
  extern __shared__ float acc[];    // d floats: this CTA's dscale partial
  for (int i = threadIdx.x; i < d; i += kThreads) acc[i] = 0.f;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  for (int r = r0; r < r1; ++r) {
    const size_t row = static_cast<size_t>(r) * d;
    float ss = 0.f, gs = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float s = to_f32(x[row + i]);
      if (kResidual) s += to_f32(residual[row + i]);
      const float g = to_f32(dy[row + i]) * scale[i];
      ss += s * s;
      gs += g * s;
    }
    const float2 tot = block_sum2(ss, gs);
    const float inv = rsqrtf(tot.x / d + eps);
    const float c = inv * inv * inv * (tot.y / d);
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float s = to_f32(x[row + i]);
      if (kResidual) s += to_f32(residual[row + i]);
      const float gy = to_f32(dy[row + i]);
      float v = inv * (gy * scale[i]) - c * s;
      if (kResidual) v += to_f32(dh[row + i]);
      dx[row + i] = from_f32<T>(v);
      acc[i] += gy * s * inv;
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) out[i] = acc[i];
}

// dscale[i] = sum over the n partial rows, in row order.
__global__ void column_sum_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  float s = 0.f;
  for (int b = 0; b < n; ++b) s += partial[static_cast<size_t>(b) * d + i];
  out[i] = s;
}

template <typename T>
cudaError_t launch_bwd(int residual, const void* x, const void* res,
                       const float* scale, const void* dy, const void* dh,
                       void* dx, float* partial, float* dscale, int rows,
                       int d, int rows_per_cta, float eps, cudaStream_t st) {
  const int ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const T* dyt = static_cast<const T*>(dy);
  const T* dht = static_cast<const T*>(dh);
  T* dxt = static_cast<T*>(dx);
  if (residual) {
    rmsnorm_bwd_kernel<T, true><<<ctas, kThreads, smem, st>>>(
        xt, rt, scale, dyt, dht, dxt, partial, rows, d, rows_per_cta, eps);
  } else {
    rmsnorm_bwd_kernel<T, false><<<ctas, kThreads, smem, st>>>(
        xt, rt, scale, dyt, dht, dxt, partial, rows, d, rows_per_cta, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_sum_kernel<<<(d + 255) / 256, 256, 0, st>>>(partial, dscale, ctas, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_rmsnorm(int dtype, const void* x, const void* scale, void* out,
                  int rows, int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), s, static_cast<float*>(out), d, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), s,
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_rmsnorm_residual(int dtype, const void* x, const void* residual,
                           const void* scale, void* out, void* new_residual,
                           int rows, int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  if (dtype == 0) {
    rmsnorm_residual_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(residual), s,
        static_cast<float*>(out), static_cast<float*>(new_residual), d, eps);
  } else if (dtype == 1) {
    rmsnorm_residual_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(residual), s,
        static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(new_residual), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// residual = 0: rmsnorm backward (res, dh unused); 1: rmsnorm_residual
// backward.  partial is (ceil(rows / rows_per_cta), d) f32 scratch.
int repro_rmsnorm_bwd(int dtype, int residual, const void* x, const void* res,
                      const void* scale, const void* dy, const void* dh,
                      void* dx, void* partial, void* dscale, int rows, int d,
                      int rows_per_cta, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_bwd<float>(residual, x, res, s, dy, dh, dx, pt, ds, rows, d,
                            rows_per_cta, eps, st);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(residual, x, res, s, dy, dh, dx, pt, ds,
                                    rows, d, rows_per_cta, eps, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
