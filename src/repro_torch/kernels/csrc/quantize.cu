// Fused quantize + error-feedback residual, and dequantize, for Hopper
// (sm_90a): the wire codecs of the outer sync.
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/quantize/kernel.py  quantize_ef_fwd (:78, pallas_call :95)
//   src/repro/kernels/quantize/kernel.py  dequantize_fwd  (:110, pallas_call :126)
//
// quantize_ef, on a (K, M) f32 delta x and an optional f32 residual r:
//   e      = x + r                          (x alone when r is null)
//   scale  = max(amax |e|, 1e-12) / QMAX    per row (tile = 0) or per
//                                           (row, tile) column block
//   q      = cast(clip(round?(e / scale), -QMAX, QMAX))
//   r'     = e - q * scale
// with QMAX 127 (int8, rounded half to even), 448 (e4m3) or 57344 (e5m2).
// dequantize: out = q * scale, per row or per tile.
//
// Bit for bit with the plain PyTorch versions (kernels/quantize/ref.py):
// every sum, product and quotient is rounded on its own (__fadd_rn,
// __fmul_rn, __fdiv_rn), so nvcc cannot contract r' = e - q*s into an FMA;
// int8 rounds with rintf (half to even, as torch.round); the clip comes
// before the narrow cast, and the fp8 cast is round-to-nearest-even with
// saturation (__nv_cvt_float_to_fp8, __NV_SATFINITE).  A NaN propagates as
// in torch's amax, clamp and clip: into the row's amax and scale, so every
// residual and decoded value of that row is NaN (fmaxf / fminf would drop
// it and ship a valid-looking code).
//
// Design.  On the TPU one grid program holds a whole (1, M) row in VMEM, so
// the per-row amax needs no second pass.  A row here is a whole stacked
// leaf of one worker (nanochat-d20's layers/mlp/w_up: 20 x 1280 x 5120 =
// 131,072,000 elements under ONE scale), far beyond one block, so the
// per-row mode takes two launches: (1) each block grid-strides over its
// row segment, reduces max |e| in registers, then across the block, and
// combines blocks with atomicMax on the f32 bit pattern (an order-preserving
// int compare for non-negative floats) into a per-row slot zeroed by
// cudaMemsetAsync; (2) a grid-stride pass computes the row's scale and
// writes q and r'.  The per-tile mode is one block per (row, tile): the
// block reduces its tile's amax in shared memory, then quantizes the tile.
// A ragged last tile counts its missing columns as zeros, exactly as the
// reference's zero padding does.  dequantize is one grid-stride pass.
//
// Shards.  Under tensor parallelism a rank holds a slice of each split
// leaf, but the wire's scale is the whole leaf's (one per tensor per
// worker).  So the per-row mode's two passes are two C entries:
// repro_quantize_amax runs pass (1) into the caller's amax slots, the
// caller may reduce them (MAX over the model group), and
// repro_quantize_from_amax runs pass (2) against that amax.
// repro_quantize_ef is the per-tile mode.
//
// What bounds it: bytes.  quantize_ef needs x and r read once and q and r'
// written once, 13 bytes per element with a residual; this first kernel
// reads x and r twice (21 bytes).  dequantize reads 1 byte and writes 4.
// Loads are one float per thread per iteration, neighbouring threads on
// neighbouring elements (coalesced); 16-byte vector loads and a one-pass
// cluster reduction are later work.
//
// C interface (ctypes): pointers and the stream as void*; sizes as 64-bit
// ints; qdtype 0 = int8, 1 = float8_e4m3fn, 2 = float8_e5m2.  Each entry
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerRow = 1024;
constexpr float kScaleEps = 1e-12f;

template <int QT> struct Target;

template <> struct Target<0> {
  using T = int8_t;
  static constexpr float kQmax = 127.0f;
  __device__ static float prepare(float y) { return rintf(y); }
  __device__ static T encode(float y) {
    return static_cast<int8_t>(__float2int_rn(y));   // y is integral here
  }
  __device__ static float decode(T v) { return static_cast<float>(v); }
};

template <__nv_fp8_interpretation_t KIND>
struct Fp8Target {
  using T = __nv_fp8_storage_t;
  __device__ static float prepare(float y) { return y; }
  __device__ static T encode(float y) {
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, KIND);
  }
  __device__ static float decode(T v) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, KIND)));
  }
};

template <> struct Target<1> : Fp8Target<__NV_E4M3> {
  static constexpr float kQmax = 448.0f;
};
template <> struct Target<2> : Fp8Target<__NV_E5M2> {
  static constexpr float kQmax = 57344.0f;
};

// max that propagates NaN, as torch.amax / torch.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// max(amax, 1e-12) / QMAX, a NaN amax giving a NaN scale
template <int QT>
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(amax != amax ? amax : fmaxf(amax, kScaleEps),
                   Target<QT>::kQmax);
}

__device__ __forceinline__ float load_e(const float* __restrict__ x,
                                        const float* __restrict__ r,
                                        long long i) {
  return r ? __fadd_rn(x[i], r[i]) : x[i];
}

// max over the block of each thread's v; every thread gets the result
__device__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? warp_max[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();               // warp_max may be reused by the caller
  return v;
}

template <int QT>
__device__ __forceinline__ void quantize_one(
    float e, float scale, typename Target<QT>::T* __restrict__ q,
    float* __restrict__ nr, long long i) {
  using Tg = Target<QT>;
  float y = Tg::prepare(__fdiv_rn(e, scale));
  if (y == y) y = fminf(fmaxf(y, -Tg::kQmax), Tg::kQmax);  // NaN stays
  const typename Tg::T code = Tg::encode(y);
  q[i] = code;
  nr[i] = __fsub_rn(e, __fmul_rn(Tg::decode(code), scale));
}

// pass 1 of the per-row mode: amax[row] = max |e| over the row
__global__ void __launch_bounds__(kThreads)
row_amax_kernel(const float* __restrict__ x, const float* __restrict__ r,
                float* __restrict__ amax, long long m) {
  const long long base = static_cast<long long>(blockIdx.y) * m;
  const float* xr = x + base;
  const float* rr = r ? r + base : nullptr;
  float a = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x; i < m; i += stride)
    a = nan_max(a, fabsf(load_e(xr, rr, i)));
  a = block_max(a);
  // a >= 0 or a NaN with the sign bit clear (fabsf): as ints, the order
  // of the floats, with NaN above +inf, so a NaN wins the row
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<int*>(amax) + blockIdx.y, __float_as_int(a));
}

// pass 2 of the per-row mode: the row's scale, q and r'
template <int QT>
__global__ void __launch_bounds__(kThreads)
row_quantize_kernel(const float* __restrict__ x, const float* __restrict__ r,
                    typename Target<QT>::T* __restrict__ q,
                    float* __restrict__ nr, float* __restrict__ s,
                    const float* __restrict__ amax, long long m) {
  const long long base = static_cast<long long>(blockIdx.y) * m;
  const float scale = row_scale<QT>(amax[blockIdx.y]);
  if (blockIdx.x == 0 && threadIdx.x == 0) s[blockIdx.y] = scale;
  const float* xr = x + base;
  const float* rr = r ? r + base : nullptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x; i < m; i += stride)
    quantize_one<QT>(load_e(xr, rr, i), scale, q + base, nr + base, i);
}

// per-tile mode: one block per (row, tile) column block of width `tile`
template <int QT>
__global__ void __launch_bounds__(kThreads)
tile_quantize_kernel(const float* __restrict__ x, const float* __restrict__ r,
                     typename Target<QT>::T* __restrict__ q,
                     float* __restrict__ nr, float* __restrict__ s,
                     long long m, int tile) {
  const long long base = static_cast<long long>(blockIdx.y) * m;
  const long long lo = static_cast<long long>(blockIdx.x) * tile;
  const long long hi = lo + tile < m ? lo + tile : m;
  const float* xr = x + base;
  const float* rr = r ? r + base : nullptr;
  float a = 0.0f;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    a = nan_max(a, fabsf(load_e(xr, rr, i)));
  const float scale = row_scale<QT>(block_max(a));
  if (threadIdx.x == 0)
    s[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = scale;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    quantize_one<QT>(load_e(xr, rr, i), scale, q + base, nr + base, i);
}

// out = q * scale; scale per row (tile == 0) or per (row, tile)
template <int QT>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const typename Target<QT>::T* __restrict__ q,
                  const float* __restrict__ s, float* __restrict__ out,
                  long long m, long long tile, long long nt) {
  const long long base = static_cast<long long>(blockIdx.y) * m;
  const float* srow = s + static_cast<long long>(blockIdx.y) * (tile ? nt : 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x; i < m; i += stride) {
    const float sc = tile ? srow[i / tile] : srow[0];
    out[base + i] = __fmul_rn(Target<QT>::decode(q[base + i]), sc);
  }
}

int row_blocks(long long m) {
  long long b = (m + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocksPerRow ? (b > 0 ? b : 1)
                                               : kMaxBlocksPerRow);
}

// pass (1) of the per-row mode: amax[row] = max |e| over the row
cudaError_t row_amax(const float* x, const float* r, float* amax,
                     long long k, long long m, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(amax, 0, k * sizeof(float), st);
  if (err != cudaSuccess) return err;
  dim3 grid(row_blocks(m), static_cast<unsigned>(k));
  row_amax_kernel<<<grid, kThreads, 0, st>>>(x, r, amax, m);
  return cudaGetLastError();
}

// pass (2): scale, q and r' of each row against amax[row]
template <int QT>
cudaError_t quantize_from_amax(const float* x, const float* r, void* q,
                               float* nr, float* s, const float* amax,
                               long long k, long long m, cudaStream_t st) {
  dim3 grid(row_blocks(m), static_cast<unsigned>(k));
  row_quantize_kernel<QT><<<grid, kThreads, 0, st>>>(
      x, r, static_cast<typename Target<QT>::T*>(q), nr, s, amax, m);
  return cudaGetLastError();
}

template <int QT>
cudaError_t quantize_tiles(const float* x, const float* r, void* q,
                           float* nr, float* s, long long k, long long m,
                           long long tile, cudaStream_t st) {
  if (tile <= 0) return cudaErrorInvalidValue;
  const long long nt = (m + tile - 1) / tile;
  dim3 grid(static_cast<unsigned>(nt), static_cast<unsigned>(k));
  tile_quantize_kernel<QT><<<grid, kThreads, 0, st>>>(
      x, r, static_cast<typename Target<QT>::T*>(q), nr, s, m,
      static_cast<int>(tile));
  return cudaGetLastError();
}

template <int QT>
cudaError_t dequantize(const void* q, const float* s, float* out,
                       long long k, long long m, long long tile,
                       cudaStream_t st) {
  const long long nt = tile > 0 ? (m + tile - 1) / tile : 1;
  dim3 grid(row_blocks(m), static_cast<unsigned>(k));
  dequantize_kernel<QT><<<grid, kThreads, 0, st>>>(
      static_cast<const typename Target<QT>::T*>(q), s, out, m, tile, nt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The per-tile mode.  x, r: (k, m) f32 (r may be null: no residual); q:
// (k, m) narrow; nr: (k, m) f32; s: (k, ceil(m / tile)); tile > 0.
int repro_quantize_ef(int qdtype, const void* x, const void* r, void* q,
                      void* nr, void* s, long long k, long long m,
                      long long tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(r);
  float* nrf = static_cast<float*>(nr);
  float* sf = static_cast<float*>(s);
  cudaError_t err = cudaErrorInvalidValue;
  if (qdtype == 0)
    err = quantize_tiles<0>(xf, rf, q, nrf, sf, k, m, tile, st);
  else if (qdtype == 1)
    err = quantize_tiles<1>(xf, rf, q, nrf, sf, k, m, tile, st);
  else if (qdtype == 2)
    err = quantize_tiles<2>(xf, rf, q, nrf, sf, k, m, tile, st);
  return static_cast<int>(err);
}

// The per-row mode, pass (1): amax (k floats) = each row's max |x + r| (r
// may be null).
int repro_quantize_amax(const void* x, const void* r, void* amax,
                        long long k, long long m, void* stream) {
  return static_cast<int>(row_amax(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<float*>(amax), k, m, static_cast<cudaStream_t>(stream)));
}

// Pass (2), against the caller's amax (k floats): q (k, m) narrow, nr
// (k, m) f32 and s (k,), each row coded against its amax.
int repro_quantize_from_amax(int qdtype, const void* x, const void* r,
                             void* q, void* nr, void* s, const void* amax,
                             long long k, long long m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(r);
  float* nrf = static_cast<float*>(nr);
  float* sf = static_cast<float*>(s);
  const float* af = static_cast<const float*>(amax);
  cudaError_t err = cudaErrorInvalidValue;
  if (qdtype == 0)
    err = quantize_from_amax<0>(xf, rf, q, nrf, sf, af, k, m, st);
  else if (qdtype == 1)
    err = quantize_from_amax<1>(xf, rf, q, nrf, sf, af, k, m, st);
  else if (qdtype == 2)
    err = quantize_from_amax<2>(xf, rf, q, nrf, sf, af, k, m, st);
  return static_cast<int>(err);
}

// q: (k, m) narrow; s as for repro_quantize_ef; out: (k, m) f32.
int repro_dequantize(int qdtype, const void* q, const void* s, void* out,
                     long long k, long long m, long long tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  float* of = static_cast<float*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  if (qdtype == 0)
    err = dequantize<0>(q, sf, of, k, m, tile, st);
  else if (qdtype == 1)
    err = dequantize<1>(q, sf, of, k, m, tile, st);
  else if (qdtype == 2)
    err = dequantize<2>(q, sf, of, k, m, tile, st);
  return static_cast<int>(err);
}

}  // extern "C"
