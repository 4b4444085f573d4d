// Fused AdamW update for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/fused_adamw/kernel.py  fused_adamw_fwd
//   (:45, pallas_call :61)
//
// One elementwise pass per leaf:
//   m' = b1 m + (1-b1) g
//   v' = b2 v + (1-b2) g^2
//   u  = -lr (m'/bc1 / (sqrt(v'/bc2) + eps) + wd p)
// p and g in float32 or bfloat16, m and v float32; u, m' and v' float32.
// lr, bc1 and bc2 are read from a 3-float device array (the step's
// schedule value and bias corrections), so they are run-time values, not
// compile-time constants; b1, 1-b1, b2, 1-b2, eps and wd are per-run
// constants passed by value (1-b1 and 1-b2 computed by the caller, as the
// reference rounds them).
//
// Every product, sum, quotient and the square root is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): no FMA contraction, so
// the kernel performs the plain version's operations in the same order
// with the same roundings and agrees with it bit for bit on the card.
//
// What bounds it: bytes.  p, g, m, v read once and u, m', v' written once
// is 28 bytes per element in float32, against ~12 operations; the least
// time is the traffic over 3.35 TB/s.  Design: a grid-stride loop over the
// flat leaf, one element per thread per iteration, neighbouring threads on
// neighbouring elements (coalesced); any length, no padding.
//
// C interface (ctypes): pointers and the stream as void*; n as a 64-bit
// int; p_dtype / g_dtype 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const TP* __restrict__ p, const TG* __restrict__ g,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const float* __restrict__ scal, float* __restrict__ u,
                   float* __restrict__ new_m, float* __restrict__ new_v,
                   long long n, float b1, float omb1, float b2, float omb2,
                   float eps, float wd) {
  const float neg_lr = -scal[0], bc1 = scal[1], bc2 = scal[2];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gg = to_f32(g[i]);
    const float mm = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, gg));
    const float vv = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(omb2, __fmul_rn(gg, gg)));
    const float mhat = __fdiv_rn(mm, bc1);
    const float vhat = __fdiv_rn(vv, bc2);
    const float step = __fadd_rn(
        __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)),
        __fmul_rn(wd, to_f32(p[i])));
    u[i] = __fmul_rn(neg_lr, step);
    new_m[i] = mm;
    new_v[i] = vv;
  }
}

template <typename TP, typename TG>
cudaError_t launch(const void* p, const void* g, const void* m, const void* v,
                   const void* scal, void* u, void* nm, void* nv, long long n,
                   float b1, float omb1, float b2, float omb2, float eps,
                   float wd, cudaStream_t st) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_adamw_kernel<TP, TG><<<static_cast<int>(blocks), kThreads, 0, st>>>(
      static_cast<const TP*>(p), static_cast<const TG*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const float*>(scal), static_cast<float*>(u),
      static_cast<float*>(nm), static_cast<float*>(nv), n, b1, omb1, b2, omb2,
      eps, wd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_fused_adamw(int p_dtype, int g_dtype, const void* p, const void* g,
                      const void* m, const void* v, const void* scal, void* u,
                      void* new_m, void* new_v, long long n, float b1,
                      float omb1, float b2, float omb2, float eps, float wd,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (p_dtype == 0 && g_dtype == 0)
    err = launch<float, float>(p, g, m, v, scal, u, new_m, new_v, n, b1, omb1,
                               b2, omb2, eps, wd, st);
  else if (p_dtype == 0 && g_dtype == 1)
    err = launch<float, __nv_bfloat16>(p, g, m, v, scal, u, new_m, new_v, n,
                                       b1, omb1, b2, omb2, eps, wd, st);
  else if (p_dtype == 1 && g_dtype == 0)
    err = launch<__nv_bfloat16, float>(p, g, m, v, scal, u, new_m, new_v, n,
                                       b1, omb1, b2, omb2, eps, wd, st);
  else if (p_dtype == 1 && g_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, scal, u, new_m,
                                               new_v, n, b1, omb1, b2, omb2,
                                               eps, wd, st);
  return static_cast<int>(err);
}

}  // extern "C"
