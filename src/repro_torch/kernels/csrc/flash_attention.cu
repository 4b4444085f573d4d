// Causal flash attention, forward and backward, for Hopper (sm_90a), on
// the tensor cores.
//
// The forward replaces the JAX package's Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py  flash_attention_fwd
//   (:98, pallas_call :127)
// and also returns the row log-sum-exp.  Its fp8=True variant (QK^T on
// per-row fp8_e4m3 codes, src/repro/kernels/common.py:31 qk_dot_fp8 in the
// kernel body :69-70) is the FP8_QK instantiation, repro_flash_fwd_fp8.
// The backward has no TPU counterpart: the Pallas kernel has no VJP, and
// the JAX package's gradient of this function is jax.grad of its jnp
// reference (kernels/flash_attention/ref.py reference_attention).
//
// Function: q (B, S, H, D), k/v (B, S, KV, D) with H % KV == 0 (query head
// h reads KV head h / G, G = H / KV), scores (q . k) / sqrt(D) in f32,
// causal (key <= query) unless causal == 0, and with window > 0 only keys
// with query - key < window.  o (B, S, H, D) in q's dtype; lse (B, H, S)
// f32.  The layout is the one the model's projections give, so no
// transpose is needed on either side.  S need not be a multiple of a tile:
// rows and keys past S are masked.
//
// What bounds it.  At the training shape (B 4, H 10, S 1024, D 128) the
// forward does 4*B*H*S^2*D / 2 FLOPs on 4*B*S*H*D*4 bytes, 128 FLOPs a
// byte: far above the card's ratio at the f32 rate without tensor cores
// (20), just under it at the TF32 rate (148); the backward (delta, then
// dK/dV, then dQ) does 7 S x S x D products where the forward does 2.  The
// products run on the tensor cores (mma.sync m16n8k8, TF32 in, f32
// accumulate) at about f32 accuracy by splitting: every f32 operand x
// becomes hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is
// exact in f32), and a.b = hi_a.lo_b + lo_a.hi_b + hi_a.hi_b, small terms
// first (CUTLASS's OpMultiplyAddFastF32, "3xTF32").  A term is dropped
// where an operand is exact in TF32: bf16 values and e4m3 codes are, so
// with bf16 data QK^T and dO.V^T take one product, P.V, P^T.dO, dS^T.Q and
// dS.K two (P and dS are f32); the FP8_QK forward takes one product on the
// codes.
// The card's bound is the function's FLOPs at 495 TFLOP/s dense TF32 (the
// FP8_QK forward's QK^T at the e4m3 rate); the split's own ceiling is a
// third of that, ~165 TFLOP/s, where the f32 rate without tensor cores
// (67 TFLOP/s) was.  TF32 as such (one product on rounded f32) is never
// used.  mma.sync does not reach the 495 (that needs wgmma);
// tools/flash_sweep.py measures the rate a loop of m16n8k8 TF32 products
// reaches on the card, the ceiling of these kernels.
//
// Design.  A CTA is 4 warps; each warp owns 16 rows of the CTA's 64-row
// tile (queries in the forward and dQ, keys in dK/dV) and computes every
// product of its rows with m16n8k8 mma.sync from shared memory.
// * Tiles are staged raw (f32 or bf16; bf16 is widened when a fragment is
//   built) by 16-byte cp.async copies into a two-stage ring: tile t + 1
//   lands while tile t is multiplied.  The forward streams K/V tiles of 32
//   keys (f32 D 128: Q 32 KB + 4 x 16 KB, two CTAs an SM), dQ of 64 keys
//   (Q and dO 64 KB + 4 x 32 KB, one CTA), dK/dV Q/dO tiles of 16 queries
//   with their lse and delta (K and V 64 KB + 4 x 8 KB, two CTAs): the
//   sizes tools/flash_sweep.py measured fastest at the training shape.
//   Tiles that the causal mask or the window rules out are never loaded;
//   a warp skips a block that none of its rows can see, and applies no
//   mask where all of them see all of it.  Each 16-byte chunk of a row is
//   placed at a swizzled chunk (swz), so that both fragment patterns read
//   a tile without bank conflicts: a 16-byte load of 4 values along D
//   (the row operand of QK^T-like products: the reduction index is
//   permuted so that a thread's k and k + 4 sit side by side) and an
//   8-byte load of 2 values along D from 4 rows (the column operand of
//   P.V-like products).
// * Softmax stays in registers on the mma accumulator layout (exp(x) as
//   exp2(x log2 e)): row max and sum by quad shuffles, and P (or dS) goes
//   from the accumulators into the A fragments of the next product
//   directly (key 2t and 2t + 1 of an 8-key block map to k = t and
//   t + 4).  A masked score is probability 0 exactly; a row's running max
//   starts at -inf and exp() is never taken of -inf - -inf, so no NaN
//   arises where a tile masks a whole row; rows past S are never written.
// * forward: one CTA per (q tile, head, batch), the last q tile (the most
//   keys under the causal mask) launched first; online softmax over the
//   KV tiles; o = acc / l, lse = m + log l.  With FP8_QK, every row of the
//   staged Q tile (once) and of each K tile (after it lands) is replaced
//   in place by the values of its e4m3 codes under the row's own scale
//   max(amax, 1e-12) / 448 (true division, clip to +-448, round to nearest
//   even), one warp per row, the scales in a small array beside the
//   tiles; the code dot is then multiplied by q_scale * k_scale and by
//   1/sqrt(D), in that order, as qk_dot_fp8 does.  P.V stays f32.
// * backward, FA2's split, no atomics, the same bits on every run:
//   - delta = rowsum(dO * O), one warp per row;
//   - dK/dV: one CTA per (KV tile, KV head, batch), k0 = 0 first; it loops
//     over the G query heads of the group and the query tiles that can see
//     the keys, and does S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T * scale
//     - lse), dV += P^T dO, dS^T = P^T * (dP^T - delta), dK += dS^T Q;
//     the group sums in registers; dK is scaled once at the end;
//   - dQ: one CTA per (q tile, head, batch), last tile first, over the KV
//     tiles: S, dP = dO V^T, dS, dQ += dS K, scaled once at the end.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int;
// dtype 0 = float32, 1 = bfloat16 for q/k/v/o/do/dq/dk/dv (lse and delta
// are f32).  Supported head dims: 16, 32, 64, 128.  The q/k/v/o/do/dq/dk/dv
// pointers must be 16-byte aligned (the wrapper checks; an entry returns
// cudaErrorMisalignedAddress otherwise).
// Each entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // the CTA's own tile: 16 rows a warp
// streamed tiles: keys for the forward and dQ, queries for dK/dV
constexpr int kFwdBN = 32;
constexpr int kDqBN = 64;
constexpr int kDkdvBQ = 16;
constexpr int kJU = 2;               // unroll of mma_rows' D loop
constexpr float kFp8Max = 448.f;     // float8_e4m3fn saturation
constexpr float kScaleEps = 1e-12f;
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = exp2(x log2 e)
static_assert(kFwdBN % 8 == 0 && kDqBN % 8 == 0 && kDkdvBQ % 8 == 0,
              "streamed tiles are whole 8-row mma blocks");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reductions over the 4 lanes of a quad (the lanes that share an mma row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Split-TF32 products
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32 to the bit for every non-NaN x (round to nearest, ties
// away from zero, on the low 13 bits: half a TF32 ulp added to the
// magnitude bits, then the low bits cleared), in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Tf {
  uint32_t hi, lo;
};

// An operand as (hi, lo) TF32 parts; EXACT: x is a TF32 value (bf16, an
// e4m3 code), so hi = x and lo is never used.
template <bool EXACT>
__device__ __forceinline__ Tf split(float x) {
  Tf t;
  if constexpr (EXACT) {
    t.hi = __float_as_uint(x);
    t.lo = 0u;
  } else {
    t.hi = tf32_rna(x);
    t.lo = tf32_rna(x - __uint_as_float(t.hi));
  }
  return t;
}

__device__ __forceinline__ void mma_tf32(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b (a 16 x 8, b 8 x 8, mma fragment order) by the split: the
// cross terms first, the hi.hi term last; a term whose small operand is an
// exact part (AE / BE) is 0 and dropped.
template <bool AE, bool BE>
__device__ __forceinline__ void mma_split(float c[4], const Tf a[4],
                                          const Tf b[2]) {
  if constexpr (!BE)
    mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  if constexpr (!AE)
    mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// ---------------------------------------------------------------------------
// Staged tiles: raw rows of D elements, 16-byte chunks swizzled
// ---------------------------------------------------------------------------

template <typename T> struct Chunk { static constexpr int kElems = 16 / sizeof(T); };

// Chunk c of row r sits at chunk swz(r, c) of that row.  f32 (4 values a
// chunk): a 16-byte load of rows r, r + 1 (r even) at chunks 4j .. 4j + 3
// must fill all 32 banks, so rows r and r + 1 differ in bit 2; an 8-byte
// load of rows 2i + x (i = 0..3) at chunks 4n, 4n + 1 must too, so bits
// 1-2 differ across i.  bf16 (8 a chunk): an 8-byte load of rows 0..3 at
// 2 chunks, and a 4-byte load of rows 2i + x at 2 chunks.  Rows of fewer
// chunks than a pattern needs keep a 2-way conflict (D 16; bf16 D 32).
template <typename T, int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kCpr = D / Chunk<T>::kElems;
  if constexpr (sizeof(T) == 4) {
    if constexpr (kCpr >= 8)
      return c ^ ((((r ^ (r >> 2)) & 1) << 2) | (r & 2));
    else
      return c ^ (r & 2);
  } else {
    return c ^ ((2 * ((r ^ (r >> 1)) & 3)) & (kCpr - 1));
  }
}

// Element offset of (row r, column d) in a staged tile.
template <typename T, int D>
__device__ __forceinline__ int at(int r, int d) {
  constexpr int E = Chunk<T>::kElems;
  return r * D + swz<T, D>(r, d / E) * E + d % E;
}

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Four values (r, d .. d + 3), d % 4 == 0, as f32.
__device__ __forceinline__ void ld4(const float* t, int o, float x[4]) {
  const float4 v = *reinterpret_cast<const float4*>(t + o);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* t, int o, float x[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(t + o);
  x[0] = bf_lo(v.x); x[1] = bf_hi(v.x); x[2] = bf_lo(v.y); x[3] = bf_hi(v.y);
}
// Two values (r, d), (r, d + 1), d % 2 == 0, as f32.
__device__ __forceinline__ void ld2(const float* t, int o, float x[2]) {
  const float2 v = *reinterpret_cast<const float2*>(t + o);
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* t, int o, float x[2]) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(t + o);
  x[0] = bf_lo(v); x[1] = bf_hi(v);
}

// Four consecutive output values of one row.
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b, float c,
                                    float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one group (the tile in flight) is pending.
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows r0 .. r0 + ROWS - 1 of a (B, S, NH, D) tensor at head h into a
// staged tile by cp.async; rows past S are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int b,
                                      int r0, int h, int S, int NH) {
  constexpr int E = Chunk<T>::kElems, kCpr = D / E;
  for (int e = threadIdx.x; e < ROWS * kCpr; e += kThreads) {
    const int r = e / kCpr, c = e % kCpr, ri = r0 + r;
    const T* g = src + ((static_cast<size_t>(b) * S + (ri < S ? ri : 0)) * NH + h) * D
                 + c * E;
    cp16(dst + r * D + swz<T, D>(r, c) * E, g, ri < S);
  }
}

// row[r0 .. r0 + ROWS) of a length-S f32 row (lse, delta); past S zero.
template <int ROWS>
__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ row,
                                          int r0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const int ri = r0 + r;
    cp4(dst + r, row + (ri < S ? ri : 0), ri < S);
  }
}

// Replace each row of a staged tile by the values of its fp8_e4m3 codes
// under the row's own amax scale (written to scale[r]): one warp per row.
// qk_dot_fp8's order: scale, true division, clip, RNE cast.  The codes are
// exact in bf16, so a bf16 tile holds them too.
template <typename T, int D, int ROWS>
__device__ void fp8_rows(T* x, float* scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += kWarps) {
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f32(x[at<T, D>(r, d)])));
    const float s = fmaxf(warp_max(amax), kScaleEps) / kFp8Max;
    for (int d = lane; d < D; d += 32) {
      T& e = x[at<T, D>(r, d)];
      const float y = fminf(fmaxf(to_f32(e) / s, -kFp8Max), kFp8Max);
      e = from_f32<T>(static_cast<float>(__nv_fp8_e4m3(y)));
    }
    if (lane == 0) scale[r] = s;
  }
}

__device__ __forceinline__ bool visible(int qi, int ki, int S, int causal,
                                        int window) {
  return qi < S && ki < S && (!causal || ki <= qi) &&
         (window <= 0 || qi - ki < window);
}

// Every (query, key) of queries [qa, qa + nq) and keys [ka, ka + nk) is
// visible: the block needs no mask.
__device__ __forceinline__ bool all_visible(int qa, int nq, int ka, int nk,
                                            int S, int causal, int window) {
  const int qz = qa + nq - 1, kz = ka + nk - 1;
  return qz < S && kz < S && (!causal || kz <= qa) &&
         (window <= 0 || qz - ka < window);
}

// No (query, key) of those blocks is visible: a warp skips the block, which
// leaves its state exactly as a block of masked scores would.
__device__ __forceinline__ bool none_visible(int qa, int nq, int ka, int nk,
                                             int S, int causal, int window) {
  return qa >= S || ka >= S || (causal && ka > qa + nq - 1) ||
         (window > 0 && qa - (ka + nk - 1) >= window);
}

template <bool B> struct Flag { static constexpr bool value = B; };

// Key tiles of BN keys that the query rows [q0, q0 + kRows) can see: [lo, hi).
template <int BN>
__device__ __forceinline__ void key_tiles(int q0, int S, int causal,
                                          int window, int* lo, int* hi) {
  const int k_hi = causal ? min(S, q0 + kRows) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  *lo = k_lo / BN;
  *hi = (k_hi + BN - 1) / BN;
}

// ---------------------------------------------------------------------------
// Warp products.  A warp's rows are r0 + g and r0 + g + 8 of its A tile
// (g = lane / 4, t = lane % 4).  The reduction index of a 16-column slice
// j of D is permuted so that one 16-byte load serves two k-steps: k-step
// 2j + s takes k = t at column 16j + 4t + 2s and k = t + 4 at 16j + 4t +
// 2s + 1, in A and B alike.
// ---------------------------------------------------------------------------

// c[nb] (16 x 8 block nb of 16 x NB*8) += A_rows . Bt_rows^T over D: A rows
// r0 + g (+8) of At, B rows 8nb + g of Bt, both (rows, D) staged tiles.
template <typename T, int D, int NB, bool EXACT>
__device__ __forceinline__ void mma_rows(float c[][4], const T* At, int r0,
                                         const T* Bt, int g, int t) {
#pragma unroll kJU
  for (int j = 0; j < D / 16; ++j) {
    float xa[4], xb[4];
    ld4(At, at<T, D>(r0 + g, 16 * j + 4 * t), xa);
    ld4(At, at<T, D>(r0 + g + 8, 16 * j + 4 * t), xb);
    Tf a[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      a[s][0] = split<EXACT>(xa[2 * s]);
      a[s][1] = split<EXACT>(xb[2 * s]);
      a[s][2] = split<EXACT>(xa[2 * s + 1]);
      a[s][3] = split<EXACT>(xb[2 * s + 1]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float xk[4];
      ld4(Bt, at<T, D>(8 * nb + g, 16 * j + 4 * t), xk);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const Tf b[2] = {split<EXACT>(xk[2 * s]), split<EXACT>(xk[2 * s + 1])};
        mma_split<EXACT, EXACT>(c[nb], a[s], b);
      }
    }
  }
}

// acc (16 x D, block n = 2m + e holding columns 16m + 4t + 2i + e at
// accumulator slots i (row g) and 2 + i (row g + 8)) += P . Vt over NB*8
// rows of Vt, P given as the accumulators p[NB][4] of a 16 x NB*8 product.
// Row 8j + 2t of Vt is k = t of k-step j and row 8j + 2t + 1 is k = t + 4,
// which is where P's accumulator columns already sit.
template <typename T, int D, int NB, bool VE>
__device__ __forceinline__ void mma_pv(float acc[][4], const float p[][4],
                                       const T* Vt, int g, int t) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const Tf a[4] = {split<false>(p[j][0]), split<false>(p[j][2]),
                     split<false>(p[j][1]), split<false>(p[j][3])};
    const int key = 8 * j + 2 * t;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      float x0[2], x1[2];
      ld2(Vt, at<T, D>(key, 16 * m + 2 * g), x0);
      ld2(Vt, at<T, D>(key + 1, 16 * m + 2 * g), x1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const Tf b[2] = {split<VE>(x0[e]), split<VE>(x1[e])};
        mma_split<false, VE>(acc[2 * m + e], a, b);
      }
    }
  }
}

// Row hr (0: g, 1: g + 8) of a 16 x D accumulator (mma_pv's layout), times
// mul, into the D-vector out (columns 16m + 4t .. + 3).
template <typename T, int D>
__device__ __forceinline__ void store_row(T* out, const float acc[][4], int hr,
                                          int t, float mul) {
#pragma unroll
  for (int m = 0; m < D / 16; ++m)
    st4(out + 16 * m + 4 * t, acc[2 * m][2 * hr] * mul,
        acc[2 * m + 1][2 * hr] * mul, acc[2 * m][2 * hr + 1] * mul,
        acc[2 * m + 1][2 * hr + 1] * mul);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int D, int BN, bool FP8_QK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KV, float scale,
                 int causal, int window) {
  constexpr bool QK_EXACT = FP8_QK || sizeof(T) == 2;
  constexpr bool V_EXACT = sizeof(T) == 2;
  constexpr int NB = BN / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kRows * D;            // two stages of BN x D
  T* Vs = Ks + 2 * BN * D;
  float* Qsc = reinterpret_cast<float*>(Vs + 2 * BN * D);   // FP8_QK scales
  float* Ksc = Qsc + kRows;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // longest rows first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  int kt_lo, kt_hi;
  key_tiles<BN>(q0, S, causal, window, &kt_lo, &kt_hi);
  stage<T, D, kRows>(Qs, q, b, q0, h, S, H);
  stage<T, D, BN>(Ks, k, b, kt_lo * BN, kvh, S, KV);
  stage<T, D, BN>(Vs, v, b, kt_lo * BN, kvh, S, KV);
  cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1, k0 = kt * BN;
    T* Kt = Ks + st * BN * D;
    T* Vt = Vs + st * BN * D;
    if (kt + 1 < kt_hi) {
      stage<T, D, BN>(Ks + (st ^ 1) * BN * D, k, b, k0 + BN, kvh, S, KV);
      stage<T, D, BN>(Vs + (st ^ 1) * BN * D, v, b, k0 + BN, kvh, S, KV);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    if constexpr (FP8_QK) {
      if (kt == kt_lo) fp8_rows<T, D, kRows>(Qs, Qsc);
      fp8_rows<T, D, BN>(Kt, Ksc + st * BN);
      __syncthreads();
    }
    if (!none_visible(q0 + r0, 16, k0, BN, S, causal, window)) {
      float s[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      mma_rows<T, D, NB, QK_EXACT>(s, Qs, r0, Kt, g, t);

      float mx[2] = {-INFINITY, -INFINITY};
      auto scores = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1, kc = 8 * nb + 2 * t + (e & 1);
            float x = s[nb][e];
            if constexpr (FP8_QK)   // the row scales of the codes
              x = x * Qsc[r0 + g + 8 * hr] * Ksc[st * BN + kc];
            x *= scale;
            if constexpr (decltype(masked)::value)
              if (!visible(q0 + r0 + g + 8 * hr, k0 + kc, S, causal, window))
                x = -INFINITY;
            s[nb][e] = x;
            mx[hr] = fmaxf(mx[hr], x);
          }
      };
      if (all_visible(q0 + r0, 16, k0, BN, S, causal, window))
        scores(Flag<false>());
      else
        scores(Flag<true>());
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float m_new = fmaxf(m[hr], quad_max(mx[hr]));
        alpha[hr] = m_new == -INFINITY ? 1.f : exp2f((m[hr] - m_new) * kLog2e);
        m[hr] = m_new;
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const float p = s[nb][e] == -INFINITY ? 0.f
                                             : exp2f((s[nb][e] - m[hr]) * kLog2e);
          s[nb][e] = p;
          ps[hr] += p;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + quad_sum(ps[hr]);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        acc[c][0] *= alpha[0];
        acc[c][1] *= alpha[0];
        acc[c][2] *= alpha[1];
        acc[c][3] *= alpha[1];
      }
      mma_pv<T, D, NB, V_EXACT>(acc, s, Vt, g, t);
    }
    __syncthreads();                 // the stage is refilled next iteration
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    if (qi >= S) continue;
    store_row<T, D>(o + ((static_cast<size_t>(b) * S + qi) * H + h) * D, acc,
                    hr, t, 1.f / l[hr]);
    if (t == 0) lse[(static_cast<size_t>(b) * H + h) * S + qi] = m[hr] + logf(l[hr]);
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

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int KV, float scale,
                      int causal, int window) {
  constexpr bool E = sizeof(T) == 2;          // inputs exact in TF32
  constexpr int NB = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kRows * D;
  T* Qs = Vs + kRows * D;            // two stages of BQ x D
  T* dOs = Qs + 2 * BQ * D;
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * D);   // 2 x BQ lse
  float* Ds = Ls + 2 * BQ;                                    // 2 x BQ delta
  const int k0 = blockIdx.z * kRows;  // k0 = 0 sees the most queries
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  // query tiles that can see a key of [k0, k0 + kRows), for each head
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + kRows - 1 + window) : S;
  const int qt_lo = q_lo / BQ, nq = (q_hi + BQ - 1) / BQ - qt_lo;
  const int total = G * nq;
  auto stage_tile = [&](int it, int st) {
    const int h = kvh * G + it / nq, q0 = (qt_lo + it % nq) * BQ;
    const size_t row = (static_cast<size_t>(b) * H + h) * S;
    stage<T, D, BQ>(Qs + st * BQ * D, q, b, q0, h, S, H);
    stage<T, D, BQ>(dOs + st * BQ * D, dout, b, q0, h, S, H);
    stage_row<BQ>(Ls + st * BQ, lse + row, q0, S);
    stage_row<BQ>(Ds + st * BQ, delta + row, q0, S);
  };
  stage<T, D, kRows>(Ks, k, b, k0, kvh, S, KV);
  stage<T, D, kRows>(Vs, v, b, k0, kvh, S, KV);
  stage_tile(0, 0);
  cp_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;
  for (int it = 0; it < total; ++it) {
    const int st = it & 1, q0 = (qt_lo + it % nq) * BQ;
    const T* Qt = Qs + st * BQ * D;
    const T* dOt = dOs + st * BQ * D;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;
    if (it + 1 < total) stage_tile(it + 1, st ^ 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys
    if (!none_visible(q0, BQ, k0 + r0, 16, S, causal, window)) {
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      mma_rows<T, D, NB, E>(s, Ks, r0, Qt, g, t);
      mma_rows<T, D, NB, E>(dp, Vs, r0, dOt, g, t);
      auto grads = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ki = k0 + r0 + g + 8 * (e >> 1), qc = 8 * nb + 2 * t + (e & 1);
            float p = exp2f((s[nb][e] * scale - Lt[qc]) * kLog2e);
            if constexpr (decltype(masked)::value)
              if (!visible(q0 + qc, ki, S, causal, window)) p = 0.f;
            s[nb][e] = p;
            dp[nb][e] = p * (dp[nb][e] - Dt[qc]);
          }
      };
      if (all_visible(q0, BQ, k0 + r0, 16, S, causal, window))
        grads(Flag<false>());
      else
        grads(Flag<true>());
      mma_pv<T, D, NB, E>(dv_acc, s, dOt, g, t);     // dV += P^T dO
      mma_pv<T, D, NB, E>(dk_acc, dp, Qt, g, t);     // dK += dS^T Q
    }
    __syncthreads();
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ki = k0 + r0 + g + 8 * hr;
    if (ki >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + ki) * KV + kvh) * D;
    store_row<T, D>(dk + off, dk_acc, hr, t, scale);
    store_row<T, D>(dv + off, dv_acc, hr, t, 1.f);
  }
}

template <typename T, int D, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KV, float scale, int causal,
                    int window) {
  constexpr bool E = sizeof(T) == 2;
  constexpr int NB = BN / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kRows * D;
  T* Ks = dOs + kRows * D;           // two stages of BN x D
  T* Vs = Ks + 2 * BN * D;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // longest rows first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  int kt_lo, kt_hi;
  key_tiles<BN>(q0, S, causal, window, &kt_lo, &kt_hi);
  stage<T, D, kRows>(Qs, q, b, q0, h, S, H);
  stage<T, D, kRows>(dOs, dout, b, q0, h, S, H);
  stage<T, D, BN>(Ks, k, b, kt_lo * BN, kvh, S, KV);
  stage<T, D, BN>(Vs, v, b, kt_lo * BN, kvh, S, KV);
  cp_commit();
  float L[2], Dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    const size_t i = (static_cast<size_t>(b) * H + h) * S + qi;
    L[hr] = qi < S ? lse[i] : 0.f;
    Dl[hr] = qi < S ? delta[i] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1, k0 = kt * BN;
    const T* Kt = Ks + st * BN * D;
    const T* Vt = Vs + st * BN * D;
    if (kt + 1 < kt_hi) {
      stage<T, D, BN>(Ks + (st ^ 1) * BN * D, k, b, k0 + BN, kvh, S, KV);
      stage<T, D, BN>(Vs + (st ^ 1) * BN * D, v, b, k0 + BN, kvh, S, KV);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    if (!none_visible(q0 + r0, 16, k0, BN, S, causal, window)) {
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      mma_rows<T, D, NB, E>(s, Qs, r0, Kt, g, t);
      mma_rows<T, D, NB, E>(dp, dOs, r0, Vt, g, t);
      auto grads = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1, kc = 8 * nb + 2 * t + (e & 1);
            float p = exp2f((s[nb][e] * scale - L[hr]) * kLog2e);
            if constexpr (decltype(masked)::value)
              if (!visible(q0 + r0 + g + 8 * hr, k0 + kc, S, causal, window))
                p = 0.f;
            s[nb][e] = p * (dp[nb][e] - Dl[hr]);    // dS
          }
      };
      if (all_visible(q0 + r0, 16, k0, BN, S, causal, window))
        grads(Flag<false>());
      else
        grads(Flag<true>());
      mma_pv<T, D, NB, E>(acc, s, Kt, g, t);        // dQ += dS K
    }
    __syncthreads();
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    if (qi >= S) continue;
    store_row<T, D>(dq + ((static_cast<size_t>(b) * S + qi) * H + h) * D, acc,
                    hr, t, scale);
  }
}

// Shared-memory bytes of each kernel.
template <typename T>
constexpr size_t fwd_smem(int D, int BN, bool fp8) {
  return (static_cast<size_t>(kRows) + 4 * BN) * D * sizeof(T)
         + (fp8 ? (kRows + 2 * BN) * sizeof(float) : 0);
}
template <typename T>
constexpr size_t dkdv_smem(int D, int BQ) {
  return (2 * static_cast<size_t>(kRows) + 4 * BQ) * D * sizeof(T)
         + 4 * BQ * sizeof(float);
}
template <typename T>
constexpr size_t dq_smem(int D, int BN) {
  return (2 * static_cast<size_t>(kRows) + 4 * BN) * D * sizeof(T);
}

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
static_assert(fwd_smem<float>(128, kFwdBN, true) <= kMaxSmem &&
                  dkdv_smem<float>(128, kDkdvBQ) <= kMaxSmem &&
                  dq_smem<float>(128, kDqBN) <= kMaxSmem,
              "the tiles of D 128 f32 must fit in shared memory");

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int tiles(int S) { return (S + kRows - 1) / kRows; }

template <typename T, int D, bool FP8_QK>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int KV, float scale,
                int causal, int window, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D, kFwdBN, FP8_QK>;
  const size_t smem = fwd_smem<T>(D, kFwdBN, FP8_QK);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, tiles(S));
  kern<<<grid, kThreads, smem, st>>>(
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
  auto kdkdv = flash_bwd_dkdv_kernel<T, D, kDkdvBQ>;
  const size_t s_kv = dkdv_smem<T>(D, kDkdvBQ);
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_kv));
  if (err != cudaSuccess) return err;
  kdkdv<<<dim3(KV, B, tiles(S)), kThreads, s_kv, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, KV, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kdq = flash_bwd_dq_kernel<T, D, kDqBN>;
  const size_t s_q = dq_smem<T>(D, kDqBN);
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_q));
  if (err != cudaSuccess) return err;
  kdq<<<dim3(H, B, tiles(S)), kThreads, s_q, st>>>(
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
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorMisalignedAddress);
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
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return static_cast<int>(cudaErrorMisalignedAddress);
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
