// RMSNorm and fused residual-add + RMSNorm for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/rmsnorm/kernel.py  rmsnorm_fwd           (pallas_call :41)
//   src/repro/kernels/rmsnorm/kernel.py  rmsnorm_residual_fwd  (pallas_call :58)
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

}  // extern "C"
