// RMSNorm and fused residual-add + RMSNorm for Hopper (sm_90a), forward
// and backward.
//
// The forward replaces the JAX package's Pallas kernels
//   src/repro/kernels/rmsnorm/kernel.py  rmsnorm_fwd           (pallas_call :41)
//   src/repro/kernels/rmsnorm/kernel.py  rmsnorm_residual_fwd  (pallas_call :58)
// with one body whose residual add is a template flag.  The backward has no
// TPU counterpart: the JAX package differentiates its norms through jnp
// (jax.grad); here training runs the forward kernels, so their gradient is
// a kernel too (see the backward section below).
//
// What bounds them: bytes.  The forward reads a row once (x, plus the
// residual; the scale once per launch) and writes it once (the normed row,
// plus the new residual); ~4 operations per element, far below the card's
// ratio of operations to bytes, so the least time is the traffic over
// 3.35 TB/s.  At a decode step's 8 rows that traffic takes tens of
// nanoseconds, and what is left is latency: a round trip to HBM and the
// reduction's steps.
//
// Design: a row lives in registers.  Its elements are cut into 16-byte
// vectors (4 f32 or 8 bf16); the G threads of the row's CTA take the
// vectors j = v * G + t, v < TILE (a compile-time count, masked past the
// row's end), and the row's loads (x, the residual, the scale) are issued
// before its first reduction, so a cold row costs one round of HBM
// latency, not the two of a load pass and a second pass.  s = x
// (+ residual) is computed once in f32 and kept; the new residual (s
// rounded to the row's type) and the normed row are written from the same
// registers, nothing is read twice.  One CTA per row, over every SM the
// rows can fill:
//   - rows of d <= 2048 (nanochat-d20's 1280, mamba2-1.3b's 2048) belong to
//     one warp (G = 32): the sum of squares is a shuffle butterfly, with no
//     barrier;
//   - wider rows (to 12288) spread over kCtaThreads threads: the warps'
//     partials meet once in shared memory, and every thread adds them in
//     warp order.
// G and TILE come from d and the dtype alone (ops.py ``layout``; the TILES_*
// lists below are the tiles instantiated, ops.py ``TILES`` the same).
//
// Bits: each thread sums its elements in a fixed order (each vector
// component over v, then the components pairwise), the butterfly gives
// every lane of a warp the same total, and the warps' partials are added
// in warp order.  So a row's result is a function of its data, d and the
// dtype only, never of the number of rows in the launch, the grid or the
// CTA the row lands in: a 40-row verify step normalises a row to the same
// bits as an 8-row decode step or a 1-row launch.  Statistics are f32;
// the residual variant normalises the unrounded f32 sum, as the Pallas
// kernel does; bf16 outputs are rounded once from the f32 result.
//
// C interface (ctypes): pointers and the stream as void*, ints and the
// eps as plain values; dtype 0 = float32, 1 = bfloat16 for x / residual /
// outputs, scale is always float32; every pointer 16-byte aligned and d a
// multiple of 8 (the wrapper checks).  Each entry returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue for a
// layout it was not built for.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kCtaThreads = 256;   // threads of one row above d 2048
constexpr int kBwdThreads = 256;   // threads per CTA of the backward
constexpr int kColRows = 32;       // partial rows a column-sum thread walks
constexpr int kDhFirstMaxTile = 12;  // backward: dh in the first load pass

// tiles (16-byte vectors per thread) instantiated, by G and dtype
#define TILES_WARP_F32(X) X(1) X(2) X(4) X(6) X(8) X(10) X(12) X(14) X(16)
#define TILES_WARP_BF16(X) X(1) X(2) X(4) X(6) X(8)
#define TILES_CTA_F32(X) X(4) X(6) X(8) X(10) X(12)
#define TILES_CTA_BF16(X) X(2) X(4) X(6)

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}
__device__ __forceinline__ void st16(void* p, uint4 v) {
  *static_cast<uint4*>(p) = v;
}

// 16 bytes of T -> N f32 values, and back (bf16 rounded to nearest even)
template <typename T> __device__ void unpack(uint4 r, float* f);
template <> __device__ __forceinline__ void unpack<float>(uint4 r, float* f) {
  f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t u) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = u;
  return __bfloat1622float2(h);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 r,
                                                                 float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = bf16x2_to_f32(w[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
template <typename T> __device__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t f32_to_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(
    const float* f) {
  return make_uint4(f32_to_bf16x2(f[0], f[1]), f32_to_bf16x2(f[2], f[3]),
                    f32_to_bf16x2(f[4], f[5]), f32_to_bf16x2(f[6], f[7]));
}

// a[0] + ... + a[N-1] pairwise: (a0 + a1) + (a2 + a3), ...
template <int N> __device__ __forceinline__ float tree(float* a) {
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) a[i] += a[i + w];
  }
  return a[0];
}

// Sum over a warp by an xor butterfly: every lane gets the same bits (at
// each step the two lanes of a pair add the same two values).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}

// Sum over the G threads of a row group (V: float, or float2 for two
// sums).  G = 32: the butterfly alone.  Otherwise each warp's total goes
// to red[warp], one barrier, and every thread adds red[0..G/32) in warp
// order.  A caller that reuses red for the next row passes the other half
// of a double buffer.
template <int G, typename V>
__device__ __forceinline__ V group_sum(V v, V* red) {
  v = warp_sum(v);
  if constexpr (G == 32) {
    return v;
  } else {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    V t = red[0];
#pragma unroll
    for (int w = 1; w < G / 32; ++w) add(t, red[w]);
    return t;
  }
}

// N floats of shared memory (16-byte aligned) to registers and back.
template <int N> __device__ __forceinline__ void load4(const float* p,
                                                      float* f) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 q = reinterpret_cast<const float4*>(p)[k];
    f[4 * k] = q.x; f[4 * k + 1] = q.y; f[4 * k + 2] = q.z; f[4 * k + 3] = q.w;
  }
}
template <int N> __device__ __forceinline__ void store4(float* p,
                                                       const float* f) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    reinterpret_cast<float4*>(p)[k] =
        make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
}

// The scale's part of a thread's columns (vectors j = v * G + t < nvec,
// N floats each) copied to the same columns of sc_s by cp.async: in
// flight beside the row's loads without holding registers.  The thread
// reads back only what it copied, after cp_wait(): no barrier.
template <int N, int TILE, int G>
__device__ __forceinline__ void stage_scale(const float* __restrict__ scale,
                                            float* sc_s, int nvec, int t) {
#pragma unroll
  for (int v = 0; v < TILE; ++v) {
    const int j = v * G + t;
    if (j < nvec) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const uint32_t dst = static_cast<uint32_t>(
            __cvta_generic_to_shared(sc_s + j * N + 4 * k));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(dst), "l"(scale + j * N + 4 * k));
      }
    }
  }
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One row of d elements, thread t of its group of G.
template <typename T, bool kRes, int TILE, int G>
__device__ __forceinline__ void norm_row(
    const T* __restrict__ x, const T* __restrict__ res,
    const float* __restrict__ scale, T* __restrict__ out,
    T* __restrict__ new_res, int d, float eps, int t, float* red) {
  constexpr int N = Vec<T>::N;
  const int nvec = d / N;
  uint4 xr[TILE], rr[TILE], sc[TILE][N / 4];
  // every load of the row before any arithmetic
#pragma unroll
  for (int v = 0; v < TILE; ++v) {
    const int j = v * G + t;
    xr[v] = rr[v] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < N / 4; ++k) sc[v][k] = make_uint4(0u, 0u, 0u, 0u);
    if (j < nvec) {
      xr[v] = ld16(x + static_cast<size_t>(j) * N);
      if constexpr (kRes) rr[v] = ld16(res + static_cast<size_t>(j) * N);
#pragma unroll
      for (int k = 0; k < N / 4; ++k) sc[v][k] = ld16(scale + j * N + 4 * k);
    }
  }
  float s[TILE][N];
  float p[N];
#pragma unroll
  for (int e = 0; e < N; ++e) p[e] = 0.f;
#pragma unroll
  for (int v = 0; v < TILE; ++v) {
    unpack<T>(xr[v], s[v]);
    if constexpr (kRes) {
      float r[N];
      unpack<T>(rr[v], r);
#pragma unroll
      for (int e = 0; e < N; ++e) s[v][e] += r[e];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = fmaf(s[v][e], s[v][e], p[e]);
  }
  const float ss = group_sum<G>(tree<N>(p), red);
  const float inv = rsqrtf(ss / d + eps);
#pragma unroll
  for (int v = 0; v < TILE; ++v) {
    const int j = v * G + t;
    if (j < nvec) {
      float scf[N], o[N];
#pragma unroll
      for (int k = 0; k < N / 4; ++k) unpack<float>(sc[v][k], scf + 4 * k);
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = s[v][e] * inv * scf[e];
      st16(out + static_cast<size_t>(j) * N, pack<T>(o));
      if constexpr (kRes)
        st16(new_res + static_cast<size_t>(j) * N, pack<T>(s[v]));
    }
  }
}

// One CTA of G threads per row: a warp (no barrier) or kCtaThreads.
template <typename T, bool kRes, int TILE, int G>
__global__ void __launch_bounds__(G)
norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
            const float* __restrict__ scale, T* __restrict__ out,
            T* __restrict__ new_res, int d, float eps) {
  __shared__ float red[G / 32];
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  norm_row<T, kRes, TILE, G>(x + off, kRes ? res + off : nullptr, scale,
                             out + off, kRes ? new_res + off : nullptr, d,
                             eps, threadIdx.x, red);
}

// Calls f.template run<TILE>() for the instantiated tile of (G, T), or
// returns cudaErrorInvalidValue.
#define TILE_CASE(n) case n: return f.template run<n>();
template <typename T, int G, typename F>
cudaError_t with_tile(int tile, const F& f) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if constexpr (G == 32 && kF32) {
    switch (tile) { TILES_WARP_F32(TILE_CASE) }
  } else if constexpr (G == 32) {
    switch (tile) { TILES_WARP_BF16(TILE_CASE) }
  } else if constexpr (kF32) {
    switch (tile) { TILES_CTA_F32(TILE_CASE) }
  } else {
    switch (tile) { TILES_CTA_BF16(TILE_CASE) }
  }
  return cudaErrorInvalidValue;
}

// Calls with_tile<T, G> for dtype 0 / 1 and G 32 / kCtaThreads; checks
// that the layout covers the row.
template <template <typename, int> class Launch, typename... Args>
cudaError_t dispatch(int dtype, int group, int tile, int d, Args... args) {
  if (d <= 0 || d % 8 != 0 || tile <= 0) return cudaErrorInvalidValue;
  const int n = dtype == 0 ? 4 : 8;
  if (static_cast<long long>(tile) * group * n < d)
    return cudaErrorInvalidValue;
  if (dtype == 0 && group == 32)
    return with_tile<float, 32>(tile, Launch<float, 32>{d, args...});
  if (dtype == 0 && group == kCtaThreads)
    return with_tile<float, kCtaThreads>(
        tile, Launch<float, kCtaThreads>{d, args...});
  if (dtype == 1 && group == 32)
    return with_tile<__nv_bfloat16, 32>(
        tile, Launch<__nv_bfloat16, 32>{d, args...});
  if (dtype == 1 && group == kCtaThreads)
    return with_tile<__nv_bfloat16, kCtaThreads>(
        tile, Launch<__nv_bfloat16, kCtaThreads>{d, args...});
  return cudaErrorInvalidValue;
}

template <typename T, int G> struct NormLaunch {
  int d;
  int residual, rows;
  const void *x, *res, *scale;
  void *out, *new_res;
  float eps;
  cudaStream_t st;
  template <int TILE, bool kRes> cudaError_t go() const {
    norm_kernel<T, kRes, TILE, G><<<rows, G, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<const float*>(scale), static_cast<T*>(out),
        static_cast<T*>(new_res), d, eps);
    return cudaGetLastError();
  }
  template <int TILE> cudaError_t run() const {
    return residual ? go<TILE, true>() : go<TILE, false>();
  }
};

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
// ~11 operations per element).  Design: persistent CTAs of kBwdThreads
// threads, as many as the card's SMs hold at once (occupancy times the SM
// count, at most max_ctas), each walking rows: a row group (a warp for
// d <= 2048, the whole CTA above) takes row r, then r plus the grid's
// groups, ...  Per row, the forward's layout: one vectorised load pass
// brings x (+ residual), dy and, while four raw tiles fit in registers
// (TILE <= kDhFirstMaxTile), dh into registers; sum(s^2) and sum(g*s)
// come from shuffles (plus one barrier for a CTA-wide row), and ds is
// written from registers.  Rows' bits follow the forward's rule: from the
// row's data, d and the dtype alone.
//
// Each group keeps, in shared memory, its own copy of the scale (copied
// by cp.async while its first row loads) and its own f32 dscale partial
// of d floats; each thread reads and adds to only the columns it owns
// (its vectors j), so neither needs a barrier per row (in registers the
// partial would sit beside four tiles of the row: 320 registers at d 2048
// f32).  dscale is deterministic, with no atomics: at the end the CTA
// adds its groups' partials in group order and writes one row, and
// column_sum_kernel adds the CTAs' rows in a fixed order.  The same inputs
// on the same card give the same bits on every call.

template <typename T, bool kRes, int TILE, int G>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ scale, const T* __restrict__ dy,
                   const T* __restrict__ dh, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int kGroups = kBwdThreads / G;     // rows in flight per CTA
  // dh joins the first load pass while four raw tiles fit in registers
  constexpr bool kDhFirst = TILE <= kDhFirstMaxTile;
  extern __shared__ float4 smem4[];
  __shared__ float2 red[2][kBwdThreads / 32];
  const int grp = threadIdx.x / G, t = threadIdx.x % G;
  // per group: its copy of the scale, then its dscale partial (d floats
  // each); a thread touches only its own columns of both
  float* sc_g = reinterpret_cast<float*>(smem4) + grp * 2 * d;
  float* acc = sc_g + d;
  const int nvec = d / N;
  stage_scale<N, TILE, G>(scale, sc_g, nvec, t);
#pragma unroll
  for (int v = 0; v < TILE; ++v) {
    const int j = v * G + t;
    if (j < nvec) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k)
        reinterpret_cast<float4*>(acc + j * N)[k] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  int half = 0;
  for (int row = blockIdx.x * kGroups + grp; row < rows;
       row += gridDim.x * kGroups) {
    const size_t off = static_cast<size_t>(row) * d;
    uint4 xr[TILE], rr[TILE], gr[TILE], hr[TILE];
#pragma unroll
    for (int v = 0; v < TILE; ++v) {
      const int j = v * G + t;
      xr[v] = rr[v] = gr[v] = hr[v] = make_uint4(0u, 0u, 0u, 0u);
      if (j < nvec) {
        const size_t o = off + static_cast<size_t>(j) * N;
        xr[v] = ld16(x + o);
        if constexpr (kRes) {
          rr[v] = ld16(res + o);
          if constexpr (kDhFirst) hr[v] = ld16(dh + o);
        }
        gr[v] = ld16(dy + o);
      }
    }
    cp_wait();          // the scale, copied while the first row loaded
    float s[TILE][N];
    float pss[N], pgs[N];
#pragma unroll
    for (int e = 0; e < N; ++e) pss[e] = pgs[e] = 0.f;
#pragma unroll
    for (int v = 0; v < TILE; ++v) {
      const int j = v * G + t;
      float scv[N], gy[N];
      if (j < nvec) {
        load4<N>(sc_g + j * N, scv);
      } else {            // a masked vector: zeros, and another's columns
#pragma unroll
        for (int e = 0; e < N; ++e) scv[e] = 0.f;
      }
      unpack<T>(xr[v], s[v]);
      if constexpr (kRes) {
        float r[N];
        unpack<T>(rr[v], r);
#pragma unroll
        for (int e = 0; e < N; ++e) s[v][e] += r[e];
      }
      unpack<T>(gr[v], gy);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float g = gy[e] * scv[e];
        pss[e] = fmaf(s[v][e], s[v][e], pss[e]);
        pgs[e] = fmaf(g, s[v][e], pgs[e]);
      }
    }
    const float2 tot = group_sum<G>(make_float2(tree<N>(pss), tree<N>(pgs)),
                                    red[half]);
    half ^= 1;
    const float inv = rsqrtf(tot.x / d + eps);
    const float c = inv * inv * inv * (tot.y / d);
#pragma unroll
    for (int v = 0; v < TILE; ++v) {
      const int j = v * G + t;
      if (j < nvec) {
        const size_t o = off + static_cast<size_t>(j) * N;
        if constexpr (kRes && !kDhFirst) hr[v] = ld16(dh + o);
        float scv[N], av[N], gy[N], hv[N], out[N];
        load4<N>(sc_g + j * N, scv);
        load4<N>(acc + j * N, av);
        unpack<T>(gr[v], gy);
        if constexpr (kRes) unpack<T>(hr[v], hv);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          float val = inv * (gy[e] * scv[e]) - c * s[v][e];
          if constexpr (kRes) val += hv[e];
          out[e] = val;
          av[e] += gy[e] * s[v][e] * inv;
        }
        store4<N>(acc + j * N, av);
        st16(dx + o, pack<T>(out));
      }
    }
  }
  cp_wait();            // a group without rows
  __syncthreads();
  const float* acc0 = reinterpret_cast<const float*>(smem4) + d;
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kBwdThreads) {
    float a = acc0[i];
#pragma unroll
    for (int k = 1; k < kGroups; ++k) a += acc0[2 * k * d + i];
    out[i] = a;
  }
}

// dscale[i] = sum over the n partial rows: thread (c, y) of a 32 x
// kColRows block adds rows y, y + kColRows, ... of column c, then the
// kColRows sums are added in y order.  A fixed order for a given n: the
// same bits on every call.
__global__ void __launch_bounds__(32 * kColRows)
column_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int n, int d) {
  __shared__ float part[kColRows][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = threadIdx.y; b < n; b += kColRows)
      s += partial[static_cast<size_t>(b) * d + c];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < kColRows; ++y) t += part[y][threadIdx.x];
    out[c] = t;
  }
}

template <typename T, int G> struct BwdLaunch {
  int d;
  int residual, rows, max_ctas;
  const void *x, *res, *scale, *dy, *dh;
  void *dx, *partial, *dscale;
  float eps;
  cudaStream_t st;
  template <int TILE, bool kRes> cudaError_t go() const {
    auto kernel = rmsnorm_bwd_kernel<T, kRes, TILE, G>;
    const size_t smem =
        static_cast<size_t>(2 * (kBwdThreads / G)) * d * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBwdThreads, smem);
    if (err != cudaSuccess) return err;
    const int ctas = per_sm * sms < max_ctas ? per_sm * sms : max_ctas;
    if (ctas <= 0) return cudaErrorInvalidConfiguration;
    kernel<<<ctas, kBwdThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<const float*>(scale), static_cast<const T*>(dy),
        static_cast<const T*>(dh), static_cast<T*>(dx),
        static_cast<float*>(partial), rows, d, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    column_sum_kernel<<<(d + 31) / 32, dim3(32, kColRows), 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(dscale),
        ctas, d);
    return cudaGetLastError();
  }
  template <int TILE> cudaError_t run() const {
    return residual ? go<TILE, true>() : go<TILE, false>();
  }
};

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// group: threads per row (32 or 256), tile: 16-byte vectors per thread;
// both from ops.py ``layout(d, dtype)``.
int repro_rmsnorm(int dtype, const void* x, const void* scale, void* out,
                  int rows, int d, int group, int tile, float eps,
                  void* stream) {
  return static_cast<int>(dispatch<NormLaunch>(
      dtype, group, tile, d, 0, rows, x, static_cast<const void*>(nullptr),
      scale, out, static_cast<void*>(nullptr), eps,
      static_cast<cudaStream_t>(stream)));
}

int repro_rmsnorm_residual(int dtype, const void* x, const void* residual,
                           const void* scale, void* out, void* new_residual,
                           int rows, int d, int group, int tile, float eps,
                           void* stream) {
  return static_cast<int>(dispatch<NormLaunch>(
      dtype, group, tile, d, 1, rows, x, residual, scale, out, new_residual,
      eps, static_cast<cudaStream_t>(stream)));
}

// residual = 0: rmsnorm backward (res, dh unused); 1: rmsnorm_residual
// backward.  partial is (max_ctas, d) f32 scratch; the kernel runs
// min(max_ctas, resident CTAs on the card) CTAs.
int repro_rmsnorm_bwd(int dtype, int residual, const void* x, const void* res,
                      const void* scale, const void* dy, const void* dh,
                      void* dx, void* partial, void* dscale, int rows, int d,
                      int group, int tile, int max_ctas, float eps,
                      void* stream) {
  return static_cast<int>(dispatch<BwdLaunch>(
      dtype, group, tile, d, residual, rows, max_ctas, x, res, scale, dy, dh,
      dx, partial, dscale, eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
